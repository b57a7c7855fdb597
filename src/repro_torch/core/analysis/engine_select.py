"""The single resolver for the analysis engine knobs.

Every exact-analysis entry point (`apsp.apsp_dense`,
`paths.shortest_path_multiplicity`, `metrics.AnalysisEngine`) accepts the
same knob set — ``use_kernel``, ``method``, ``mesh``, ``tile_rows``,
``packed`` (plus the tiled engine's ``sources``/``source_ids``) — and used
to police combinations with ad-hoc per-callsite raises. This module is now
the one place that maps knobs to an engine, so ``mesh=`` + ``tile_rows=``
COMPOSES (the sharding-x-streaming engine) instead of conflicting, and only
genuinely impossible combinations are rejected.

The matrix (kernel path, ``method`` wavefront or default)::

    mesh    tile_rows/sources/ids    packed    -> engine
    ----    ---------------------    ------    ---------
    None    None                     False     wavefront   (device-resident)
    None    None                     True      wavefront   (packed cells)
    set     None                     False     sharded     (replicated adj)
    None    set                      any       tiled       (out-of-core)
    set     set                      any       composed    (sharded adj x
                                                            streamed tiles)
    set     None                     True      composed    (the sharded
                                               engine is f32-only; packed
                                               rides the streaming family)

``block=`` (explicit kernel block edge) is a grid knob INSIDE the
tiled/composed family, not a selection knob: it rides through to whichever
streaming engine the matrix picks and never changes the choice (the
extreme sweep sizes it per family via
``distributed.widest_divisor_block``).

Rejected, with the reason in the error:

    * ``method="squaring"`` with any of mesh / tile_rows / sources /
      source_ids / packed — tropical squaring is a dense N x N engine with
      no sharded, streamed, or packed form.
    * ``use_kernel=False`` with any of the above — the plain oracle exists
      to check the kernels, not to scale.

The PyTorch port executes the single-device engines: ``wavefront`` (fp32
or packed cells), ``tiled`` (fp32 or packed, resident or streamed) and
``squaring``. :func:`require_ported` raises NotImplementedError for a plan
that needs a mesh (``sharded``, ``composed``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["EnginePlan", "resolve_engine", "require_ported"]

#: knobs that imply the streaming (tiled/composed) engine family
_STREAMING_KNOBS = ("tile_rows", "sources", "source_ids")


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """A resolved engine choice: dispatch on ``engine``, pass the rest."""

    engine: str                      # wavefront|sharded|tiled|composed|squaring
    use_kernel: bool = True
    mesh: object = None              # a device mesh, or None
    tile_rows: Optional[int] = None
    packed: bool = False


def _mesh_shards(mesh) -> int:
    return int(mesh.size) if mesh is not None else 1


def resolve_engine(*, use_kernel: bool = True, method: Optional[str] = None,
                   mesh=None, tile_rows: Optional[int] = None,
                   packed: bool = False, sources=None,
                   source_ids=None) -> EnginePlan:
    """Map the knob set to one engine (see the module docstring matrix).

    Raises ValueError for genuinely incompatible combinations; everything
    else composes. A mesh with a single device degrades to ``mesh=None``
    (the single-device engines are the P=1 special case of the sharded
    ones, bit-equal).
    """
    if method not in (None, "wavefront", "squaring"):
        raise ValueError(f"unknown APSP method {method!r}")
    if _mesh_shards(mesh) <= 1:
        mesh = None
    streaming = {k: v for k, v in (("tile_rows", tile_rows),
                                   ("sources", sources),
                                   ("source_ids", source_ids))
                 if v is not None}
    scale_knobs = dict(streaming)
    if mesh is not None:
        scale_knobs["mesh"] = mesh
    if packed:
        scale_knobs["packed"] = True

    if method is None:
        method = "wavefront" if use_kernel else "squaring"
    if method == "squaring" and scale_knobs:
        raise ValueError(
            f"method='squaring' is the dense tropical-squaring engine — it "
            f"has no sharded, streamed, or packed form and cannot honor "
            f"{sorted(scale_knobs)}; use the wavefront engine "
            f"(method=None/'wavefront') for extreme-scale knobs")
    if not use_kernel and scale_knobs:
        raise ValueError(
            f"use_kernel=False runs the plain oracle, which has no sharded, "
            f"streamed, or packed form and cannot honor "
            f"{sorted(scale_knobs)}; drop the knobs or keep the kernel "
            f"path")

    if method == "squaring":
        return EnginePlan("squaring", use_kernel=use_kernel)
    if streaming and mesh is not None:
        return EnginePlan("composed", mesh=mesh, tile_rows=tile_rows,
                          packed=packed)
    if streaming:
        return EnginePlan("tiled", tile_rows=tile_rows, packed=packed)
    if mesh is not None:
        if packed:
            # the replicated-adjacency sharded engine is f32-only; packed +
            # mesh means the composed engine (sharded adjacency), which
            # also strictly dominates it on memory
            return EnginePlan("composed", mesh=mesh, packed=True)
        return EnginePlan("sharded", mesh=mesh)
    return EnginePlan("wavefront", packed=packed)


def require_ported(plan: EnginePlan) -> EnginePlan:
    """``plan`` unchanged when the port runs its engine; NotImplementedError
    naming the ROADMAP item that ports it otherwise."""
    if plan.engine in ("sharded", "composed"):
        raise NotImplementedError(
            f"the {plan.engine} engine is not ported to repro_torch yet "
            f"(ROADMAP Queue 1 item 6, second half: the sharded engines on "
            f"torch.distributed); use the single-device engines (mesh=None)")
    return plan

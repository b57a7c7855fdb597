"""The kernel library's public ops — the port of ``repro.kernels.ops``.

Every op casts its operands as the JAX op does (fp32 for the fp32 ops;
for the packed ops the frontier to the int32 device cell, the adjacency to
uint8, the distances to int16), makes them contiguous and calls its
kernel's wrapper, which dispatches on the tensors' device: the
hand-written CUDA kernel for CUDA tensors (or it raises), the plain
version for CPU tensors. ``use_kernel=False`` is the escape hatch to the
plain version on any device; the ``*_ref`` aliases name the plain
versions directly (`kernels.ref`).

Outputs have the JAX ops' dtypes, except the packed steps, which return
the port's int32 multiplicity cell (`kernels.semiring` documents why)
where the JAX package returns uint32. Where the JAX ops take block shapes
(``bm``/``bn``/``bk``/``sub_k``) from the autotuner's table, the three
min-plus ops here take the host's tile pick (``tile="large"|"small"``,
``split=1..8``; the count product ``split`` only) from the port's
autotuner (`kernels.autotune`): explicit keywords win, then the tuned
table, then the rule. The counting ops pick their tile on the card from
the operand and take no such keyword. Ragged shapes need no padding: the
kernels mask their edges.

The extension point is here too: :class:`Semiring`, the four shipped specs
and :func:`semiring_matmul` / :func:`semiring_matmul_batched` (from
`kernels.semiring`), the product over any algebra, which on a CUDA tensor
launches a kernel generated from the spec's device code. ``__all__`` stays
the JAX ops' list; those names stand beside it, as they stand in the JAX
package's ``kernels.semiring`` and not in its ``ops``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from . import seghist as H
from . import semiring as S
from .semiring import (BOOLEAN, COUNTING, TROPICAL, TROPICAL_COUNT,  # noqa: F401
                       Semiring, semiring_matmul, semiring_matmul_batched)

__all__ = ["minplus_matmul", "reachability_step", "value_histogram",
           "count_matmul", "minplus_count_matmul", "frontier_step",
           "frontier_step_packed", "batched_minplus_matmul",
           "batched_count_matmul", "batched_frontier_step",
           "batched_frontier_step_packed"]


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _packed(f, a, d):
    """The packed step's cells: int32 frontier, uint8 adjacency, int16
    distances (DIST_UNREACHED = unreached)."""
    return (f.to(S.MULT_DTYPE).contiguous(), a.to(torch.uint8).contiguous(),
            d.to(S.DIST_DTYPE).contiguous())


def _stacked(name: str, *xs: torch.Tensor) -> None:
    if any(x.ndim != 3 for x in xs):
        raise ValueError(f"{name} takes (B, ..) stacks: "
                         f"{[tuple(x.shape) for x in xs]}")


def minplus_matmul(a: torch.Tensor, b: torch.Tensor,
                   use_kernel: bool = True, tile: Optional[str] = None,
                   split: Optional[int] = None) -> torch.Tensor:
    """Tropical (min, +) product of (m, k) x (k, n); ragged edges act as
    +inf. ``tile`` / ``split``: the launch's pick (`kernels.autotune`)."""
    return S.minplus_matmul(_f32(a), _f32(b), use_kernel=use_kernel,
                            tile=tile, split=split)


def reachability_step(a: torch.Tensor, b: torch.Tensor,
                      use_kernel: bool = True) -> torch.Tensor:
    """Boolean-semiring product of {0,1} masks, 2D or stacked, as fp32."""
    return S.reachability_step(_f32(a), _f32(b), use_kernel=use_kernel)


def count_matmul(a: torch.Tensor, b: torch.Tensor,
                 use_kernel: bool = True) -> torch.Tensor:
    """Counting semiring (+, x) product of f32 counts; exact while counts
    stay below 2**24."""
    return S.count_matmul(_f32(a), _f32(b), use_kernel=use_kernel)


def minplus_count_matmul(da: torch.Tensor, ca: torch.Tensor,
                         db: torch.Tensor, cb: torch.Tensor,
                         use_kernel: bool = True,
                         split: Optional[int] = None):
    """Fused tropical-with-count product over (dist, count) pairs; ragged
    edges act as (+inf, 0). Returns (dist, count). ``split``: the launch's
    split of K (`kernels.autotune`)."""
    return S.minplus_count_matmul(_f32(da), _f32(ca), _f32(db), _f32(cb),
                                  use_kernel=use_kernel, split=split)


def frontier_step(f: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                  use_kernel: bool = True) -> torch.Tensor:
    """Fused BFS wavefront step: ``where((F@A > 0) & (D == inf), F@A, 0)``."""
    return S.frontier_step(_f32(f), _f32(a), _f32(d), use_kernel=use_kernel)


def frontier_step_packed(f: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                         use_kernel: bool = True) -> torch.Tensor:
    """Packed-cell fused wavefront step: int32 frontier x uint8 adjacency
    with int16 distances; newly reached counts saturate at MULT_SAT (never
    wrap). Returns int32 counts."""
    return S.frontier_step_packed(*_packed(f, a, d), use_kernel=use_kernel)


def batched_minplus_matmul(a: torch.Tensor, b: torch.Tensor,
                           use_kernel: bool = True,
                           compare: Optional[torch.Tensor] = None,
                           tile: Optional[str] = None,
                           split: Optional[int] = None):
    """Tropical product over a stacked leading axis: (B, M, K) x (B, K, N),
    one kernel launch for the whole stack. With ``compare``, a (B, M, N)
    stack, returns ``(out, changed)``: one int32 flag for the whole stack,
    nonzero iff ``out`` differs from ``compare`` (the sweep's squaring
    loop reads it once per squaring). ``tile`` / ``split``: the launch's
    pick (`kernels.autotune`)."""
    _stacked("batched_minplus_matmul", a, b)
    return S.batched_minplus_matmul(
        _f32(a), _f32(b), use_kernel=use_kernel,
        compare=None if compare is None else _f32(compare), tile=tile,
        split=split)


def batched_count_matmul(a: torch.Tensor, b: torch.Tensor,
                         use_kernel: bool = True) -> torch.Tensor:
    """Counting product over a stacked leading axis."""
    _stacked("batched_count_matmul", a, b)
    return S.count_matmul(_f32(a), _f32(b), use_kernel=use_kernel)


def batched_frontier_step(f: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                          use_kernel: bool = True) -> torch.Tensor:
    """Stacked fused wavefront step over a leading batch axis."""
    _stacked("batched_frontier_step", f, a, d)
    return S.frontier_step(_f32(f), _f32(a), _f32(d), use_kernel=use_kernel)


def batched_frontier_step_packed(f: torch.Tensor, a: torch.Tensor,
                                 d: torch.Tensor,
                                 use_kernel: bool = True) -> torch.Tensor:
    """Stacked packed wavefront step over a leading batch axis."""
    _stacked("batched_frontier_step_packed", f, a, d)
    return S.frontier_step_packed(*_packed(f, a, d), use_kernel=use_kernel)


def value_histogram(x: torch.Tensor, num_bins: int,
                    use_kernel: bool = True) -> torch.Tensor:
    """int32 histogram of floor(x) over [0, num_bins), any shape;
    non-finite, negative and out-of-range values are dropped."""
    return H.value_histogram(_f32(x), num_bins, use_kernel=use_kernel)


# plain-version aliases so callers can ask for the reference implementation
minplus_matmul_ref = ref.minplus_matmul_ref
reachability_step_ref = ref.reachability_step_ref
value_histogram_ref = ref.value_histogram_ref
count_matmul_ref = ref.count_matmul_ref
minplus_count_matmul_ref = ref.minplus_count_matmul_ref
frontier_step_ref = ref.frontier_step_ref
frontier_step_packed_ref = ref.frontier_step_packed_ref
batched_minplus_matmul_ref = ref.batched_minplus_matmul_ref
batched_count_matmul_ref = ref.batched_count_matmul_ref
semiring_matmul_ref = ref.semiring_matmul_ref
semiring_matmul_batched_ref = ref.semiring_matmul_batched_ref

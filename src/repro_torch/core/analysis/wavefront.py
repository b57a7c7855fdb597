"""Device wavefront engine — the analysis stack's level loops on torch.

Level-synchronous BFS with Brandes' frontier identity gives hop distances
AND exact shortest-path multiplicities from one counting product per level
(``x_k = F_k @ A``; pairs first reached at level k+1 carry sigma = x). The
product and the first-reach mask run as one fused kernel
(`kernels.semiring.frontier_step`); the dist/mult updates stay on the
device. :func:`ecmp_loads_device` is the O(diameter) Brandes dependency
accumulation behind the exact ECMP saturation-throughput bound, with two
counting products per level (`kernels.semiring.count_matmul`).

Each level loop is a Python loop over device tensors. The BFS reads its
convergence flag once per level — one host sync per level; the telemetry
(levels run, per-level newly reached pair counts) stays on the device until
the caller reads it.

``use_kernel=False`` runs the same loops with the kernels' plain versions
on the tensors' device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ... import obs
from ...kernels import semiring as S

__all__ = ["wavefront_dist_mult", "dist_mult_device", "ecmp_loads_device",
           "pad_block", "pad_operand", "telemetry_attrs", "resolve_device"]

_INF = float("inf")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and there is
    no card (the engines never move to the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: pass device='cpu' to "
                           "run the plain versions on the host")
    return dev


def pad_block(n: int) -> int:
    """Padded size for an n-router problem: the next multiple of 128 (min
    128), the JAX engine's f32 tile, so padded shapes match it. The CUDA
    kernels take any size; the padding only keeps the two packages'
    shapes equal."""
    return max(128, n + ((-n) % 128))


def pad_operand(x: np.ndarray, p: int, fill: float,
                dtype=np.float32) -> np.ndarray:
    """Pad the trailing two dims of ``x`` to (p, p) — phantom routers
    (fills: adjacency/multiplicity 0, distance +inf)."""
    x = np.asarray(x, dtype)
    n = x.shape[-1]
    if n == p:
        return x
    w = [(0, 0)] * (x.ndim - 2) + [(0, p - n)] * 2
    return np.pad(x, w, constant_values=np.asarray(fill, dtype))


def dist_mult_device(adj: torch.Tensor, telemetry: bool = False,
                     use_kernel: bool = True):
    """Hop distances + shortest-path multiplicities on ``adj``'s device.

    ``adj`` is a (p, p) or stacked (B, p, p) {0,1} fp32 adjacency; padding
    rows/cols must be zero (isolated phantom routers). Returns (dist, mult):
    dist fp32 with +inf for unreachable (phantom diagonals at 0), mult fp32
    with 1 on the diagonal.

    The loop runs until a level reaches no new pair (the stack's largest
    diameter + 1 levels), capped at p. ``telemetry=True`` returns
    ``(dist, mult, (levels, sizes))``: ``levels`` the level iterations run
    and ``sizes`` an int32 (p+1,) (or (p+1, B) stacked) device tensor of
    newly reached pair counts per level.
    """
    adj = adj.contiguous()
    p = adj.shape[-1]
    dev = adj.device
    eye = torch.eye(p, dtype=torch.float32, device=dev).expand(adj.shape)
    dist = torch.where(eye > 0, 0.0, _INF).contiguous()
    mult = eye.contiguous()
    frontier = mult.clone()
    sizes = (torch.zeros((p + 1, adj.shape[0]) if adj.ndim == 3 else (p + 1,),
                         dtype=torch.int32, device=dev) if telemetry else None)
    level, more = 1, True
    while more and level <= p:
        x = S.frontier_step(frontier, adj, dist, use_kernel=use_kernel)
        new = x > 0
        # in place: dist and mult are the loop's two (B, p, p) states, and
        # updating them saves a fresh buffer of each per level; newly
        # reached pairs carried 0 in mult, so += is the masked set
        dist.masked_fill_(new, float(level))
        mult.add_(x)
        if telemetry:
            sizes[level] = new.sum(dim=(-2, -1), dtype=torch.int32)
        more = bool(new.any())  # the level's one host sync
        frontier = x
        level += 1
    if telemetry:
        return dist, mult, (level - 1, sizes)
    return dist, mult


def telemetry_attrs(aux) -> Dict[str, object]:
    """Span attributes from a wavefront telemetry aux pair.

    ``levels`` counts executed level iterations (diameter + 1 confirmation
    sweep on connected graphs), ``converged_level`` the last level that
    reached a new pair (= max hop distance), ``frontier_sizes`` the
    newly-reached pair count per level 1..converged_level (summed over the
    stack when batched; ``frontier_sizes_per_graph`` keeps the per-graph
    split).
    """
    level, sizes = aux
    sizes = sizes.cpu().numpy()
    levels = int(level)
    per_graph = sizes if sizes.ndim == 1 else sizes.sum(axis=1)
    nz = np.flatnonzero(per_graph)
    last = int(nz.max()) if len(nz) else 0
    attrs = {
        "levels": levels,
        "converged_level": last,
        "frontier_sizes": per_graph[1:last + 1].tolist(),
    }
    if sizes.ndim == 2:
        attrs["frontier_sizes_per_graph"] = sizes[1:last + 1].T.tolist()
        attrs["levels_per_graph"] = [
            int(np.flatnonzero(col).max()) if col.any() else 0
            for col in sizes.T]
    return attrs


def _warn_if_inexact(mult: np.ndarray) -> None:
    """Warn when a count passed 2**24, where f32 stops holding integers."""
    limit = float(2 ** 24)
    if mult.size and mult.max() > limit:
        import warnings

        warnings.warn(
            f"shortest-path multiplicities exceed the accumulator's exact "
            f"integer range ({limit:.0f}); counts are rounded",
            RuntimeWarning, stacklevel=3)


def wavefront_dist_mult(adj: np.ndarray, device="cuda",
                        use_kernel: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Host convenience wrapper: pad -> device engine -> sliced np arrays.

    Warns (RuntimeWarning) when a multiplicity exceeds f32's exact-integer
    range — the engine's counts are f32 on the device. Under an enabled
    `repro_torch.obs` tracer the call is spanned and the device telemetry
    (levels, frontier sizes) lands in the span's attributes.
    """
    dev = resolve_device(device)
    adj = np.asarray(adj)
    n = adj.shape[-1]
    p = pad_block(n)
    tel = obs.enabled()
    with obs.span("wavefront.dist_mult", routers=n, padded=p,
                  batched=adj.ndim == 3) as sp:
        padded = pad_operand(adj, p, 0.0)
        obs.record_h2d(padded.nbytes, "adjacency")
        out = dist_mult_device(torch.from_numpy(padded).to(dev),
                               telemetry=tel, use_kernel=use_kernel)
        if tel:
            sp.set(**telemetry_attrs(out[2]))
        sl = (Ellipsis, slice(None, n), slice(None, n))
        dist = out[0][sl].cpu().numpy()
        mult = out[1][sl].cpu().numpy()
    _warn_if_inexact(mult)
    return dist, mult


def ecmp_loads_device(dist: torch.Tensor, mult: torch.Tensor,
                      adj: torch.Tensor, use_kernel: bool = True
                      ) -> torch.Tensor:
    """Directed ECMP loads under uniform all-pairs demand, on the device.

    The O(diameter) Brandes backward accumulation: every reachable pair
    carries 1.0, and each level runs two counting products — the first on
    the transposed level mask, read through its strides. Operands share a
    (.., p, p) shape (phantom padding: dist +inf, mult/adj 0). Runs
    ``diameter`` levels (largest finite dist over the whole stack). Returns
    the (.., p, p) directed loads.
    """
    finite = torch.isfinite(dist)
    diam = int(torch.where(finite, dist, 0.0).max())
    sigma_inv = torch.where(finite & (mult > 0),
                            1.0 / torch.where(mult > 0, mult, 1.0), 0.0)
    del finite
    delta = torch.zeros_like(dist)
    acc = torch.zeros_like(dist)
    for a in range(diam - 1, -1, -1):
        z = torch.where(dist == a + 1.0, (1.0 + delta) * sigma_inv, 0.0)
        on_a = dist == a
        f_a = torch.where(on_a, mult, 0.0)
        # in place: acc is the loop's running sum; += saves a buffer a level
        acc.add_(S.count_matmul(f_a.transpose(-1, -2), z,
                                use_kernel=use_kernel))
        delta = torch.where(on_a, mult * S.count_matmul(z, adj,
                                                        use_kernel=use_kernel),
                            delta)
    return adj * acc

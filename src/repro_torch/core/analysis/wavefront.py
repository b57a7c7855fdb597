"""Device wavefront engine — the analysis stack's level loops on torch.

Level-synchronous BFS with Brandes' frontier identity gives hop distances
AND exact shortest-path multiplicities from one counting product per level
(``x_k = F_k @ A``; pairs first reached at level k+1 carry sigma = x). The
product and the first-reach mask run as one fused kernel
(`kernels.semiring.frontier_step`, or `frontier_step_packed` over
int16/int32/uint8 cells with ``packed=True``); the dist/mult updates stay
on the device. :func:`ecmp_loads_device` is the O(diameter) Brandes dependency
accumulation behind the exact ECMP saturation-throughput bound and the
demand-weighted ECMP loads, with two counting products per level
(`kernels.semiring.count_matmul`).
:func:`squaring_apsp_device` is the weighted-APSP engine: min-plus squaring
(`kernels.semiring.minplus_matmul`) to convergence.

Each loop is a Python loop over device tensors. The BFS reads its
convergence flag once per level and the squaring once per squaring — one
host sync each; the telemetry (levels run, per-level newly reached pair
counts) stays on the device until the caller reads it.

``use_kernel=False`` runs the same loops with the kernels' plain versions
on the tensors' device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ... import obs
from ...kernels import semiring as S

__all__ = ["wavefront_dist_mult", "wavefront_dist_mult_device",
           "dist_mult_device", "ecmp_loads_device", "squaring_apsp_device",
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
                     use_kernel: bool = True, packed: bool = False):
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

    ``packed=True`` runs the narrow-cell engine (`kernels.semiring.
    frontier_step_packed`): ``adj`` is a uint8 {0,1} adjacency, dist comes
    back int16 (DIST_UNREACHED = unreached), mult int32 saturating at
    MULT_SAT, and a one-element bool device tensor ``sat`` (some count was
    clamped) is appended: ``(dist, mult, sat)`` or ``(dist, mult, sat,
    aux)`` with telemetry. The level cap is min(p, 32766), the int16 cell's
    largest level. Equal, as integers, to the fp32 engine while counts stay
    below MULT_SAT.
    """
    adj = adj.contiguous()
    p = adj.shape[-1]
    dev = adj.device
    eye = torch.eye(p, dtype=torch.bool, device=dev).expand(adj.shape)
    if packed:
        dist = torch.where(eye, 0, S.DIST_UNREACHED).to(S.DIST_DTYPE)
        mult = eye.to(S.MULT_DTYPE).contiguous()
        step = S.frontier_step_packed
        cap = min(p, S.DIST_UNREACHED - 1)
        sat = torch.zeros(1, dtype=torch.bool, device=dev)
    else:
        dist = torch.where(eye, 0.0, _INF)
        mult = eye.to(torch.float32).contiguous()
        step = S.frontier_step
        cap = p
    frontier = mult.clone()
    sizes = (torch.zeros((p + 1, adj.shape[0]) if adj.ndim == 3 else (p + 1,),
                         dtype=torch.int32, device=dev) if telemetry else None)
    level, more = 1, True
    while more and level <= cap:
        x = step(frontier, adj, dist, use_kernel=use_kernel)
        new = x > 0
        # in place: dist and mult are the loop's two (B, p, p) states, and
        # updating them saves a fresh buffer of each per level; newly
        # reached pairs carried 0 in mult, so += is the masked set
        dist.masked_fill_(new, level)
        mult.add_(x)
        if packed:
            sat |= (x == S.MULT_SAT).any()
        if telemetry:
            sizes[level] = new.sum(dim=(-2, -1), dtype=torch.int32)
        more = bool(new.any())  # the level's one host sync
        frontier = x
        level += 1
    out = (dist, mult, sat) if packed else (dist, mult)
    if telemetry:
        return (*out, (level - 1, sizes))
    return out


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


def _warn_if_inexact(mult, limit: float = float(2 ** 24)) -> None:
    """Warn when a count (numpy array or tensor) passed ``limit``, where the
    accumulator stops holding integers (2**24 for f32)."""
    size = mult.numel() if torch.is_tensor(mult) else mult.size
    if size and float(mult.max()) > limit:
        import warnings

        warnings.warn(
            f"shortest-path multiplicities exceed the accumulator's exact "
            f"integer range ({limit:.0f}); counts are rounded",
            RuntimeWarning, stacklevel=3)


def wavefront_dist_mult_device(adj: np.ndarray, device="cuda",
                               use_kernel: bool = True, packed: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad -> device engine -> the (.., n, n) dist and mult device tensors.

    Warns (RuntimeWarning) when a multiplicity exceeds f32's exact-integer
    range — the engine's counts are f32 on the device. Under an enabled
    `repro_torch.obs` tracer the call is spanned and the device telemetry
    (levels, frontier sizes) lands in the span's attributes.

    ``packed=True`` runs the narrow-cell engine on a uint8 adjacency (a
    quarter of the f32 upload) and returns (int16 dist, int32 mult) tensors
    (see `kernels.semiring`), with a RuntimeWarning when a count clamps at
    MULT_SAT.

    ``adj`` may also be a tensor already on its device (the resilience
    engines upload their mask stacks as uint8): it is cast there and runs
    unpadded, since the kernels take any size; ``device`` is then unused.
    """
    resident = torch.is_tensor(adj)
    dev = adj.device if resident else resolve_device(device)
    if not resident:
        adj = np.asarray(adj)
    n = adj.shape[-1]
    p = n if resident else pad_block(n)
    tel = obs.enabled()
    with obs.span("wavefront.dist_mult", routers=n, padded=p,
                  batched=adj.ndim == 3, packed=packed) as sp:
        if resident:
            adj_d = adj.to(torch.uint8 if packed else torch.float32)
        else:
            padded = pad_operand(adj, p, 0,
                                 np.uint8 if packed else np.float32)
            obs.record_h2d(padded.nbytes, "adjacency")
            adj_d = torch.from_numpy(padded).to(dev)
        out = dist_mult_device(adj_d, telemetry=tel, use_kernel=use_kernel,
                               packed=packed)
        if tel:
            sp.set(**telemetry_attrs(out[-1]))
        sl = (Ellipsis, slice(None, n), slice(None, n))
        dist = out[0][sl].contiguous()
        mult = out[1][sl].contiguous()
    if not packed:
        _warn_if_inexact(mult)
    elif bool(out[2]):
        import warnings

        warnings.warn(
            "packed wavefront: a shortest-path multiplicity reached "
            "MULT_SAT (2**24) and was clamped — saturated counts are "
            "lower bounds, not exact", RuntimeWarning, stacklevel=3)
    return dist, mult


def wavefront_dist_mult(adj: np.ndarray, device="cuda",
                        use_kernel: bool = True, packed: bool = False
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Host convenience wrapper over :func:`wavefront_dist_mult_device`:
    the same (dist, mult), as sliced numpy arrays. ``packed=True`` returns
    ``(dist int16, mult uint32)``, as the JAX package does."""
    dist, mult = wavefront_dist_mult_device(adj, device=device,
                                            use_kernel=use_kernel,
                                            packed=packed)
    mult = mult.cpu().numpy()
    return dist.cpu().numpy(), (mult.astype(S.HOST_MULT_DTYPE) if packed
                                else mult)


def ecmp_loads_device(dist: torch.Tensor, mult: torch.Tensor,
                      adj: torch.Tensor, demand: Optional[torch.Tensor] = None,
                      use_kernel: bool = True) -> torch.Tensor:
    """Directed ECMP loads on the device: uniform or weighted demand.

    The O(diameter) Brandes backward accumulation: each level runs two
    counting products — the first on the transposed level mask, read
    through its strides. With ``demand=None`` every reachable pair carries
    1.0 (the all-pairs case); a (.., p, p) ``demand`` tensor seeds the
    recurrence with that pair's volume instead (``Z_a = (demand + delta) /
    sigma`` on the level set), which is the whole weighted engine
    (`routing.assign.ecmp_demand_loads`): diagonal and unreachable demand
    never enters a level set, so it is dropped, not routed. Both run the
    same products in the same order, so a demand of ones gives the
    uniform loads bit for bit. Operands share a (.., p, p) shape (phantom
    padding: dist +inf, mult/adj/demand 0). Runs ``diameter`` levels
    (largest finite dist over the whole stack). Returns the (.., p, p)
    directed loads.
    """
    finite = torch.isfinite(dist)
    diam = int(torch.where(finite, dist, 0.0).max())
    sigma_inv = torch.where(finite & (mult > 0),
                            1.0 / torch.where(mult > 0, mult, 1.0), 0.0)
    del finite
    w = 1.0 if demand is None else demand
    delta = torch.zeros_like(dist)
    acc = torch.zeros_like(dist)
    for a in range(diam - 1, -1, -1):
        z = torch.where(dist == a + 1.0, (w + delta) * sigma_inv, 0.0)
        on_a = dist == a
        f_a = torch.where(on_a, mult, 0.0)
        # in place: acc is the loop's running sum; += saves a buffer a level
        acc.add_(S.count_matmul(f_a.transpose(-1, -2), z,
                                use_kernel=use_kernel))
        delta = torch.where(on_a, mult * S.count_matmul(z, adj,
                                                        use_kernel=use_kernel),
                            delta)
    return adj * acc


def squaring_apsp_device(d: torch.Tensor, max_squarings: Optional[int] = None,
                         telemetry: bool = False, use_kernel: bool = True):
    """Min-plus squaring to convergence on ``d``'s device.

    For *weighted* length matrices (hop-distance problems should use
    :func:`dist_mult_device`: squaring costs O(log diam) tropical products
    of p^3 adds and mins each). ``d`` is a (p, p) padded seed (+inf
    off-graph, 0 on the whole diagonal including padding). Each squaring is
    one `minplus_matmul` whose kernel also writes a "changed" flag (the
    product against its input, which is both operands); the loop reads that
    flag once per squaring, its one host sync, and stops at the first
    squaring that changes nothing.

    ``max_squarings`` defaults to ceil(log2(p)), always enough to converge.
    ``telemetry=True`` returns ``(dist, squarings)`` with the executed
    squaring count. ``use_kernel=False`` runs the same loop on the plain
    product.
    """
    p = d.shape[-1]
    if max_squarings is None:
        max_squarings = max(1, int(np.ceil(np.log2(max(2, p)))))
    d = d.contiguous()
    squarings = 0
    while squarings < max_squarings:
        d, changed = S.minplus_matmul(d, d, use_kernel=use_kernel, compare=d)
        squarings += 1
        if not bool(changed):  # the squaring's one host sync
            break
    return (d, squarings) if telemetry else d

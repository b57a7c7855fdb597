"""Exact path-multiplicity engine — the paper's path-diversity tables.

EvalNet's headline analysis is fine-grained path diversity between *every*
router pair: the number of shortest paths (multiplicity), the number of
non-minimal simple paths at +1 and +2 length slack, and how much the
shortest-path sets of different demands interfere on links. All of it
reduces to semiring matmuls (`repro_torch.kernels.semiring`):

* multiplicity: Brandes' frontier identity
  ``sigma(i,j) = sum_{u in N(j), d(i,u)=d(i,j)-1} sigma(i,u)`` — by default
  through the wavefront engine (`analysis.wavefront`), or as one masked
  counting matmul per BFS level when a distance matrix is already
  available. The fused tropical-count relaxation
  (:func:`tropical_count_relaxation`) stays as the kernel-path oracle.
* slack counts: walks of length d+1 are always simple paths (a revisit
  would shorten the walk below d); walks of length d+2 are simple paths
  plus exactly the "shortest path with one bounce v->x->v inserted" walks.
  Those bounce walks are counted by T_L = sum_{l<=L} A^l D A^(L-l)
  (D = diag(degree)), double-counting one walk per path edge, hence

      simple_paths(d+2) = A^(d+2) - T_d + d * multiplicity        (per pair)

  evaluated with counting matmuls via T_L = A T_(L-1) + D A^L.

The matrix engines run on torch tensors on the chosen device and return
tensors there; the sampled and brute-force helpers are host numpy. Counts
on the kernel path are f32 and exact while every intermediate walk count
stays below 2**24 (``use_kernel=False`` accumulates in f64, exact to
2**53); `path_counts_with_slack` reports an ``exact`` flag and clamps the
plus2 subtraction at zero, since cancellation of two rounded large counts
is not merely saturating.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..graph import Graph
from .wavefront import resolve_device

__all__ = [
    "shortest_path_multiplicity", "tropical_count_relaxation",
    "path_counts_with_slack",
    "pair_edge_loads", "edge_interference", "brute_force_path_counts",
]

_INF = float("inf")


def pair_edge_loads(g: Graph, dist: np.ndarray, mult: np.ndarray,
                    s, t) -> np.ndarray:
    """Shortest-path count through each link for (s, t) demands.

    Link {u, v} (in `g.edges` order) carries ``mult[s,u] * mult[v,t]``
    shortest s->t paths in the u->v orientation iff
    ``dist(s,u) + 1 + dist(v,t) == dist(s,t)``, plus the symmetric v->u
    term (dist/mult are symmetric: the graph is undirected). Zero
    everywhere when s and t are disconnected.

    ``s``/``t`` may be ints (returns (E,)) or equal-length index arrays
    (returns (len(s), E), one row per demand).
    """
    u, v = g.edges[:, 0], g.edges[:, 1]
    scalar = np.ndim(s) == 0 and np.ndim(t) == 0
    s_arr, t_arr = np.atleast_1d(np.asarray(s)), np.atleast_1d(np.asarray(t))
    if s_arr.shape != t_arr.shape:
        raise ValueError(f"s and t must have matching shapes, "
                         f"got {s_arr.shape} vs {t_arr.shape}")
    d_st = dist[s_arr, t_arr][:, None]
    on_uv = dist[s_arr[:, None], u] + 1 + dist[t_arr[:, None], v] == d_st
    on_vu = dist[s_arr[:, None], v] + 1 + dist[t_arr[:, None], u] == d_st
    out = (np.where(on_uv, mult[s_arr[:, None], u] * mult[t_arr[:, None], v], 0.0)
           + np.where(on_vu, mult[s_arr[:, None], v] * mult[t_arr[:, None], u], 0.0))
    return out[0] if scalar else out



def _count_product(use_kernel: bool):
    # one canonical kernel/oracle dispatch, shared with the assignment engine
    from ..routing.assign import count_product

    return count_product(use_kernel)


def _limit(use_kernel: bool) -> float:
    return float(2 ** 24 if use_kernel else 2 ** 53)


def _warn_if_inexact(mult: torch.Tensor, use_kernel: bool) -> None:
    from .wavefront import _warn_if_inexact as warn

    warn(mult, _limit(use_kernel))


def _on(x, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (a tensor, or a numpy array, copied) as ``dtype`` on ``dev``."""
    x = x if torch.is_tensor(x) else torch.tensor(np.asarray(x))
    return x.to(device=dev, dtype=dtype)


def _diameter(dist: torch.Tensor) -> int:
    """Largest finite distance, 0 when there is none (one host sync)."""
    if dist.numel() == 0:
        return 0
    return int(torch.where(torch.isfinite(dist), dist, 0.0).max())


def shortest_path_multiplicity(
        g: Graph, dist=None, use_kernel: bool = True,
        mesh=None, tile_rows: Optional[int] = None, packed: bool = False,
        device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (dist, multiplicity) matrices for all router pairs, as tensors
    on ``device`` (or on ``dist``'s device when it is a tensor).

    With ``dist`` given (the shared APSP result), runs one masked counting
    matmul per BFS level. Without it, the kernel path runs the wavefront
    engine (`wavefront.wavefront_dist_mult_device`), producing both
    matrices from one level loop. ``use_kernel=False`` without ``dist``
    computes distances by all-sources BFS and takes the masked branch in
    f64.

    ``tile_rows`` runs the out-of-core tiled engine
    (`distributed.tiled_dist_mult`) and ``packed=True`` the packed-cell
    engines (uint8 adjacency, int16 dist, counts saturating at 2**24), as
    `engine_select.resolve_engine` picks them; these return host numpy
    arrays, as the JAX package does: (f32, f32) tiled, and (int16, uint32)
    packed, with the DIST_UNREACHED sentinel instead of +inf. ``mesh``
    selects the sharded engines, which are not ported: it raises
    NotImplementedError (`engine_select.require_ported`).

    Every count the kernel path keeps is a sum of nonnegative terms equal
    to some sigma(i, j), so results are exact iff the largest multiplicity
    fits f32's integer range; past that a RuntimeWarning is emitted.
    """
    dev = dist.device if torch.is_tensor(dist) else resolve_device(device)
    if dist is None:
        from .engine_select import require_ported, resolve_engine

        plan = require_ported(resolve_engine(
            use_kernel=use_kernel, mesh=mesh, tile_rows=tile_rows,
            packed=packed))
        if plan.engine == "tiled":
            from .distributed import tiled_dist_mult

            return tiled_dist_mult(g, tile_rows=plan.tile_rows or 512,
                                   packed=plan.packed, device=dev)
        if plan.packed:
            from .wavefront import wavefront_dist_mult

            return wavefront_dist_mult(g.adjacency_dense(np.float32),
                                       device=dev, packed=True)
        if plan.engine == "wavefront":
            from .wavefront import wavefront_dist_mult_device

            return wavefront_dist_mult_device(g.adjacency_dense(np.float32),
                                              device=dev)
        from .apsp import bfs_distances

        d = bfs_distances(g, np.arange(g.n)).astype(np.float32)
        dist = np.where(d < 0, np.float32(np.inf), d)
    dist = _on(dist, dev)
    product = _count_product(use_kernel)
    dtype = torch.float32 if use_kernel else torch.float64
    a = _on(g.adjacency_dense(np.float32), dev, dtype)
    mult = (dist == 0).to(dtype)
    for level in range(1, _diameter(dist) + 1):
        frontier = torch.where(dist == level - 1, mult, 0.0)
        mult = torch.where(dist == level, product(frontier, a), mult)
    _warn_if_inexact(mult, use_kernel)
    return dist, mult


def tropical_count_relaxation(g: Graph, use_kernel: bool = True,
                              device="cuda"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused tropical-with-count relaxation — the wavefront engine's oracle.

    ``X <- X (x) B`` over (dist, count) pairs through the fused
    tropical-count kernel (`kernels.semiring.minplus_count_matmul`),
    diagonal re-pinned to (0, 1) each step; after k steps the pair matrix
    is exact for all pairs at distance <= k, so ``diameter`` steps
    converge. The re-pin and the convergence test run on the device; the
    test is one host read per step. ``use_kernel=False`` runs the same loop
    on the plain product. Returns (dist, count) tensors on ``device``.
    """
    from ...kernels.semiring import minplus_count_matmul

    dev = resolve_device(device)
    n = g.n
    # B: the edge-relaxation operand — (1, 1) on edges, (inf, 0) elsewhere
    # including the diagonal. Squaring with a (0, 1) diagonal would double
    # count settled pairs (stay-at-end vs last-edge decompositions); pure
    # edge relaxation with the diagonal re-pinned each step is exact.
    bd = _on(g.distance_seed(), dev)
    bd.fill_diagonal_(_INF)
    bc = torch.isfinite(bd).float()
    d = _on(g.distance_seed(), dev)
    c = (d <= 1).float()

    for _ in range(max(1, n - 1)):
        nd, nc = minplus_count_matmul(d, c, bd, bc, use_kernel=use_kernel)
        nd.fill_diagonal_(0.0)
        nc.fill_diagonal_(1.0)
        done = torch.equal(nd, d)  # the step's one host sync
        d, c = nd, nc
        if done:
            break
    # both step functions (kernel and plain version) accumulate counts in
    # f32, so the exact-integer limit is 2**24 on either path
    _warn_if_inexact(c, use_kernel=True)
    return d, c


def path_counts_with_slack(
        g: Graph, dist, use_kernel: bool = True, device="cuda",
) -> Dict[str, object]:
    """Per-pair counts of simple paths at length d, d+1, d+2 (d = distance).

    Returns ``{"multiplicity": M, "plus1": P1, "plus2": P2, "exact": bool}``
    — the paper's path-diversity-with-slack matrices, as tensors on
    ``dist``'s device (``device`` when ``dist`` is a numpy array). Diagonal
    and unreachable pairs are 0 (multiplicity diagonal is 1: the trivial
    path). ``exact`` is False when any intermediate walk count exceeded the
    accumulator's exact-integer range (2**24 for the f32 kernel path, 2**53
    for the f64 path): plus2 is a difference of large counts, so past that
    point it is clamped at zero but can still be off by the rounding. The
    level loop keeps the largest count seen as a device scalar and reads it
    once, after the loop.
    """
    dev = dist.device if torch.is_tensor(dist) else resolve_device(device)
    dist = _on(dist, dev)
    product = _count_product(use_kernel)
    dtype = torch.float32 if use_kernel else torch.float64
    n = g.n
    a = _on(g.adjacency_dense(np.float32), dev, dtype)
    deg = _on(g.degrees().astype(np.float32), dev, dtype)
    finite = torch.isfinite(dist)
    diam = _diameter(dist)

    walks = torch.eye(n, dtype=dtype, device=dev)       # A^L
    bounce = torch.diag(deg)                            # T_L
    mult = (dist == 0).to(dtype)
    plus1 = torch.zeros((n, n), dtype=dtype, device=dev)
    plus2 = torch.zeros((n, n), dtype=dtype, device=dev)
    correction = torch.where(dist == 0, bounce, 0.0)   # T_d at d = 0
    peak = torch.zeros((), dtype=dtype, device=dev)

    for level in range(1, diam + 3):
        walks = product(walks, a)
        # T_L = T_(L-1) A + A^L D; the second term is a column scale, no matmul
        bounce = product(bounce, a) + walks * deg[None, :]
        peak = torch.maximum(peak, torch.maximum(walks.max(), bounce.max()))
        mult = torch.where(dist == level, walks, mult)
        plus1 = torch.where(dist == level - 1, walks, plus1)
        plus2 = torch.where(dist == level - 2, walks, plus2)
        correction = torch.where(dist == level, bounce, correction)

    d0 = torch.where(finite, dist, 0.0)
    # difference of large counts: clamp the rounding's negative excursions
    plus2 = torch.clamp_min(plus2 - correction + d0 * mult, 0.0)
    # unreachable pairs carry no paths at any slack
    mult = torch.where(finite, mult, 0.0)
    plus1 = torch.where(finite, plus1, 0.0)
    plus2 = torch.where(finite & (dist > 0), plus2, 0.0)
    exact = bool(peak <= _limit(use_kernel))
    return {"multiplicity": mult, "plus1": plus1, "plus2": plus2,
            "exact": exact}


def edge_interference(
        g: Graph, dist: np.ndarray, mult: np.ndarray,
        pairs: int = 64, seed: int = 0,
) -> Dict[str, float]:
    """Sampled interference between the shortest-path edge sets of demands.

    For each sampled (s, t), the *support* is the set of links lying on at
    least one shortest s->t path — link (u, v) qualifies iff
    ``d(s,u) + 1 + d(v,t) == d(s,t)`` in either orientation. Interference
    between two demands is the Jaccard overlap of their supports: the
    quantity adaptive-routing studies use to predict how demands collide.

    Returns mean/max Jaccard over sampled demand pairs plus the mean support
    size (links usable by at least one shortest path).
    """
    rng = np.random.default_rng(seed)
    n = g.n
    pairs -= pairs % 2  # interference is over demand *pairs*
    if pairs < 2:
        raise ValueError("need at least 2 sampled demands")
    # unordered demands (s < t), no repeats: supports are symmetric, so
    # comparing a demand against itself or its mirror would trivially
    # report Jaccard 1.0. Rejection-sample first (graphs are typically
    # connected, so O(pairs) draws suffice); enumerate the reachable pairs
    # — O(n^2) — only when rejections show reachability is actually sparse.
    seen = set()
    for _ in range(64 * pairs + 256):
        if len(seen) >= pairs:
            break
        s, t = int(rng.integers(n)), int(rng.integers(n))
        if s > t:
            s, t = t, s
        if s == t or (s, t) in seen or not np.isfinite(dist[s, t]):
            continue
        seen.add((s, t))
    else:
        reachable = np.isfinite(dist) & np.triu(np.ones((n, n), bool), k=1)
        candidates = np.argwhere(reachable)
        if len(candidates) < 2:  # fewer than two distinct demands exist
            return {"edge_interference_mean": 0.0,
                    "edge_interference_max": 0.0, "support_links_mean": 0.0}
        take = min(pairs, len(candidates) - len(candidates) % 2)
        seen = set(map(tuple, candidates[
            rng.choice(len(candidates), size=take, replace=False)]))
    picks = np.array(sorted(seen))[:len(seen) - len(seen) % 2]
    supports = pair_edge_loads(g, dist, mult, picks[:, 0], picks[:, 1]) > 0
    idx = rng.permutation(len(supports))
    a, b = supports[idx[0::2]], supports[idx[1::2]]
    inter = (a & b).sum(axis=1)
    union = (a | b).sum(axis=1)
    jac = inter / np.maximum(union, 1)
    return {
        "edge_interference_mean": float(jac.mean()),
        "edge_interference_max": float(jac.max()),
        "support_links_mean": float(supports.sum(axis=1).mean()),
    }


def brute_force_path_counts(g: Graph, max_slack: int = 2) -> Dict[str, np.ndarray]:
    """Oracle: DFS-enumerate simple paths of length d..d+max_slack per pair.

    Exponential — test-sized graphs only. Returns the same dict layout as
    :func:`path_counts_with_slack`.
    """
    from .apsp import bfs_distances

    n = g.n
    indptr, indices = g.csr()
    dist = bfs_distances(g, np.arange(n)).astype(np.float32)
    dist = np.where(dist < 0, np.inf, dist)
    counts = np.zeros((max_slack + 1, n, n), np.float32)
    for s in range(n):
        limit_row = dist[s]
        # budget: longest useful path from s is max over t of d(s,t)+slack
        finite = limit_row[np.isfinite(limit_row)]
        budget = int(finite.max()) + max_slack if finite.size else 0
        visited = np.zeros(n, bool)
        visited[s] = True

        def dfs(u: int, length: int):
            if length > 0 and np.isfinite(limit_row[u]):
                slack = length - int(limit_row[u])
                if 0 <= slack <= max_slack:
                    counts[slack, s, u] += 1
            if length == budget:
                return
            for w in indices[indptr[u]:indptr[u + 1]]:
                if not visited[w]:
                    visited[w] = True
                    dfs(int(w), length + 1)
                    visited[w] = False

        dfs(s, 0)
    mult = counts[0] + np.eye(n, dtype=np.float32)  # trivial path on diagonal
    out = {"multiplicity": mult}
    if max_slack >= 1:
        out["plus1"] = counts[1]
    if max_slack >= 2:
        out["plus2"] = counts[2]
    return out

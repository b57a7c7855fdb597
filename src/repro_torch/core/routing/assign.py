"""Vectorized flow assignment on torch: traffic matrix -> exact expected link
loads.

The middle layer of the routing subsystem: a :class:`~.models` routing
model describes *where* flows may go (per-pair next-hop probabilities);
this module pushes a whole (n, n) demand matrix through that description
with dense counting products (`kernels.semiring.count_matmul`) — no
per-flow Python loops anywhere.

The workhorse identity: under uniform-over-all-shortest-paths (exact ECMP)
routing, the expected flow of demand (s, t) across directed edge (u, v) is

    demand[s,t] * sigma(s,u) * sigma(v,t) / sigma(s,t)
        iff  d(s,u) + 1 + d(v,t) == d(s,t)

(sigma = shortest-path multiplicity from `analysis.paths`). Splitting by the
position ``a = d(s,u)`` of u on the path and the pair distance ``L``, the
whole (n, n) directed load matrix is a sum of bilinear forms

    load = A  *  sum_L sum_{a=0}^{L-1}  F_a^T @ W_L @ F_{L-1-a}

with ``F_a[s,u] = sigma(s,u) [d(s,u)=a]`` the level-a multiplicity frontier
and ``W_L = (demand / sigma) [dist=L]`` the normalized per-level demand —
O(diameter^2) dense products in all. The same engine with ``F_a = A^a``
(walk counts instead of shortest-path frontiers) yields loads for
slack-limited non-minimal routing (`models.SlackRouting`). The Brandes
engines (:func:`ecmp_all_pairs_loads`, :func:`ecmp_demand_loads`) get the
ECMP loads in 2 products per BFS level instead.

Devices: operands are tensors, which keep their device, or numpy arrays,
which are moved to ``device`` (``"cuda"`` by default; without a card that
raises, through `analysis.wavefront.resolve_device`). Directed loads come
back as tensors on that device; the (E,) undirected loads and the load
statistics come back as host numpy float64. ``use_kernel=False`` is the
float64 oracle on the same device.

Link-load reporting convention (the one place it is defined)
------------------------------------------------------------
Loads are reported *per undirected link* in ``g.edges`` order, summing both
orientations (full-duplex links, one shared counter). Summary statistics
(``link_load_stats``) are computed over the *used support* — links with
strictly positive load — so ``load_imbalance = max / mean`` compares the
most-loaded link against the average over links that carry any traffic.
Both the sampled and the expected reports in `workload.evaluate_workload`
use this helper, so their ``*_imbalance`` ratios are directly comparable.
"""
from __future__ import annotations

from typing import (Callable, Dict, List, Optional, Sequence, Tuple)

import numpy as np
import torch

from ...kernels import semiring as S
from ..analysis.paths import _diameter
from ..analysis.wavefront import resolve_device
from ..graph import Graph

__all__ = ["demand_matrix", "ecmp_link_loads", "ecmp_all_pairs_loads",
           "ecmp_demand_loads", "walk_slack_link_loads",
           "directed_to_link_loads", "link_load_stats", "count_product",
           "padded_neighbors", "sample_columns", "mask_unreachable_demand"]

_F64 = torch.float64


def count_product(use_kernel: bool) -> Callable[[torch.Tensor, torch.Tensor],
                                                torch.Tensor]:
    """(+, x) matmul over tensors: the fp32 counting kernel (its plain
    version for CPU tensors), or the f64 oracle, exact to 2**53."""
    if use_kernel:
        return lambda a, b: S.count_matmul(a.float(), b.float().contiguous())
    return lambda a, b: a.double() @ b.double()


def _device_of(*xs, device="cuda") -> torch.device:
    """The first tensor operand's device, else ``device`` (resolved)."""
    for x in xs:
        if torch.is_tensor(x):
            return x.device
    return resolve_device(device)


def _on(x, dev: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (a tensor, or a numpy array) on ``dev``, cast to ``dtype``."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
        # a read-only array (a broadcast view) is copied; torch cannot
        # share it
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device=dev, dtype=dtype)


def _adjacency(g: Graph, dev: torch.device) -> torch.Tensor:
    """``g``'s float64 adjacency on ``dev``, uploaded as uint8 (an eighth
    of the float64 bytes; the cast runs on the device)."""
    return torch.from_numpy(g.adjacency_dense(np.uint8)).to(dev).to(_F64)


def _nonempty(ws: Sequence[torch.Tensor]) -> List[bool]:
    """Which of ``ws`` hold a nonzero entry: one host read for the list."""
    if not ws:
        return []
    return torch.stack([w.ne(0).any() for w in ws]).tolist()


def padded_neighbors(g: Graph, with_edge_ids: bool = False):
    """CSR neighbour lists padded to (n, maxdeg) + validity mask.

    The shared representation behind every vectorized per-hop step (the
    workload sampler, the throughput successor chase): a hop's working set
    is (rows, maxdeg) gathers instead of dense (rows, n) rows.

    With ``with_edge_ids`` a third (n, maxdeg) array maps each slot to its
    *directed* edge index (0..2E-1: id < E is the u->v orientation of
    ``g.edges[id]``, id >= E the reverse of ``g.edges[id - E]``), so per-hop
    load accumulation can scatter into an O(E) vector instead of an (n, n)
    matrix.
    """
    indptr, indices = g.csr()
    deg = np.diff(indptr)
    maxdeg = int(deg.max(initial=1))
    valid = np.arange(maxdeg)[None, :] < deg[:, None]
    nbrs = np.zeros((g.n, maxdeg), np.int64)
    nbrs[valid] = indices
    if not with_edge_ids:
        return nbrs, valid
    # csr() sorts concat(u, v) stably: CSR slot p holds directed edge
    # order[p] of the concat([u->v], [v->u]) list — the same ordering the
    # throughput engine's capacity vectors use
    order = np.argsort(np.concatenate([g.edges[:, 0], g.edges[:, 1]]),
                       kind="stable")
    eids = np.zeros((g.n, maxdeg), np.int64)
    eids[valid] = order
    return nbrs, valid, eids


def sample_columns(weights: np.ndarray, mask: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
    """Per row, draw one column index with probability ∝ ``weights``.

    ``mask`` marks the admissible columns (weights must be 0 outside it and
    every row must have at least one admissible column). Cumulative-sum
    inverse sampling; rows where float rounding pushes the draw to the
    total are repaired onto the first admissible column.
    """
    cums = np.cumsum(weights, axis=1)
    draw = rng.random(len(weights))[:, None] * cums[:, -1:]
    slot = (cums > draw).argmax(axis=1)
    bad = ~mask[np.arange(len(slot)), slot]
    if bad.any():
        slot[bad] = mask[bad].argmax(axis=1)
    return slot


def mask_unreachable_demand(demand, dist, renormalize: bool = False,
                            device="cuda") -> Tuple[torch.Tensor, float]:
    """The partitioned-graph demand helper (contract: `traffic.spec`).

    Zeroes demand on diagonal and unreachable (``dist == inf``) pairs —
    what every engine in this module does implicitly — and returns the
    masked float64 tensor together with the dropped *volume* fraction, so
    callers report disconnection instead of silently under-routing. With
    ``renormalize=True`` the surviving entries are rescaled to preserve
    the original total volume ("demand renormalized over reachable
    pairs"). Accepts leading batch axes as long as demand/dist broadcast
    together.
    """
    dev = _device_of(demand, dist, device=device)
    demand = _on(demand, dev, _F64)
    dist = _on(dist, dev)
    n = demand.shape[-1]
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    total = float(torch.where(off, demand, 0.0).sum())
    ok = off & torch.isfinite(dist)
    masked = torch.where(ok, demand, 0.0)
    kept = float(masked.sum())
    dropped_frac = 0.0 if total <= 0 else 1.0 - kept / total
    if renormalize and kept > 0:
        masked = masked * (total / kept)
    return masked, dropped_frac


def demand_matrix(g: Graph, pairs: np.ndarray,
                  volume: float = 1.0) -> np.ndarray:
    """(n, n) f64 demand from (F, 2) flow pairs: volume per flow, summed.

    .. deprecated::
        Thin shim over `core.traffic.spec.pairs_to_matrix` (the one
        pairs -> matrix primitive of the unified `TrafficSpec` path).
    """
    import warnings

    from ..traffic.spec import pairs_to_matrix

    warnings.warn("routing.assign.demand_matrix is deprecated; use "
                  "core.traffic.TrafficSpec (or traffic.spec."
                  "pairs_to_matrix) instead", DeprecationWarning,
                  stacklevel=2)
    return pairs_to_matrix(g.n, pairs, volume)


def _bilinear_edge_loads(
        adj: torch.Tensor,
        terms: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
        product: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """``adj * sum_i  Fa_i^T @ W_i @ Fb_i`` — the shared assignment core.

    Callers drop the terms whose ``W`` is all zero before they call (with
    one host read, :func:`_nonempty`), so each term is exactly two
    products; ``Fa^T`` is a transposed view, which the kernel reads
    through its strides.
    """
    acc: Optional[torch.Tensor] = None
    for fa, w, fb in terms:
        term = product(product(fa.transpose(-1, -2), w), fb)
        acc = term if acc is None else acc + term
    if acc is None:
        return torch.zeros_like(adj, dtype=_F64)
    return adj * acc


def ecmp_link_loads(g: Graph, dist, mult, demand, use_kernel: bool = True,
                    directed: bool = False, device="cuda"):
    """Exact expected loads under uniform-over-all-shortest-paths routing.

    Returns (E,) undirected link loads in ``g.edges`` order, host numpy
    float64 (or the (n, n) directed load tensor on the operands' device
    with ``directed=True``). Demand on unreachable or diagonal pairs is
    ignored. The f32 kernel path is exact while every intermediate stays
    below 2**24; ``use_kernel=False`` accumulates in f64. Levels whose
    demand is all zero are skipped (one host read decides which).
    """
    dev = _device_of(dist, mult, demand, device=device)
    dist = _on(dist, dev)
    mult = _on(mult, dev, _F64)
    demand = _on(demand, dev, _F64)
    finite = torch.isfinite(dist)
    off = finite & (dist > 0) & (mult > 0)
    w_all = torch.where(off, demand / torch.where(off, mult, 1.0), 0.0)
    diam = _diameter(dist)
    adj = _adjacency(g, dev)
    product = count_product(use_kernel)

    # level frontiers F_a; built once, reused across (L, a) terms
    frontiers = [torch.where(dist == a, mult, 0.0) for a in range(diam)]
    w_levels = [torch.where(dist == level, w_all, 0.0)
                for level in range(1, diam + 1)]
    terms = [(frontiers[a], w_l, frontiers[level - 1 - a])
             for level, (w_l, keep) in enumerate(
                 zip(w_levels, _nonempty(w_levels)), start=1) if keep
             for a in range(level)]
    loads = _bilinear_edge_loads(adj, terms, product)
    return loads if directed else directed_to_link_loads(g, loads)


def ecmp_all_pairs_loads(dist, mult, adj,
                         product: Optional[Callable] = None,
                         use_kernel: bool = True,
                         mesh=None, device="cuda") -> torch.Tensor:
    """Directed ECMP link loads under *uniform all-pairs* demand, O(diameter).

    Partitioned graphs are first-class: "uniform all-pairs" means 1.0 on
    every *reachable* ordered pair — unreachable pairs (and dead routers'
    rows/columns) contribute nothing to any load, never inf/NaN, because
    every level mask below is gated on finite distance.

    Brandes-style backward dependency accumulation: with
    ``Z_a[s,w] = (1 + delta[s,w]) / sigma(s,w)`` on the level set
    ``d(s,w) = a`` (delta = the summed pair dependencies of w as an
    intermediate), the level recurrences

        delta_a = F_a * (Z_{a+1} @ A)        F_a[s,v] = sigma(s,v)[d(s,v)=a]
        load   += F_a^T @ Z_{a+1}

    cost 2 counting products per BFS level. ``dist``, ``mult`` and ``adj``
    are tensors with optional leading batch dimensions, or numpy arrays,
    which go to ``device``. The kernel-path default (``product=None,
    use_kernel=True``) runs `analysis.wavefront.ecmp_loads_device` in fp32
    on the operands' device; an explicit ``product`` (or
    ``use_kernel=False``, the f64 oracle) takes the reference loop in the
    operands' dtypes. Returns the directed (.., n, n) load tensor;
    ``1 / loads.max()`` is the exact ECMP lower bound on per-pair
    saturation throughput (capacity 1 per link direction).

    ``mesh`` (the sharded accumulation) is not ported yet: any mesh raises
    NotImplementedError.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded ECMP accumulation is not ported to repro_torch yet "
            "(ROADMAP Queue 1 item 6, extreme scale)")
    dev = _device_of(dist, mult, adj, device=device)
    dist, mult, adj = (_on(x, dev) for x in (dist, mult, adj))
    if product is None and use_kernel:
        from ..analysis.wavefront import ecmp_loads_device

        return ecmp_loads_device(dist.float(), mult.float(),
                                 adj.float().contiguous())
    return _brandes(dist, mult, adj, 1.0,
                    product or count_product(use_kernel))


def ecmp_demand_loads(dist, mult, adj, demand,
                      product: Optional[Callable] = None,
                      use_kernel: bool = True, device="cuda") -> torch.Tensor:
    """Directed ECMP link loads of *arbitrary* (stacked) demand, O(diameter).

    The demand-weighted generalization of :func:`ecmp_all_pairs_loads`:
    seeding the Brandes backward recurrence with the pair's demand instead
    of 1.0 (``Z_a[s,w] = (demand[s,w] + delta[s,w]) / sigma(s,w)`` on the
    level set ``d(s,w) = a``) yields the exact expected loads of
    :func:`ecmp_link_loads` in 2 counting products per BFS level instead
    of O(diameter^2) bilinear terms.

    Demand on the diagonal and on unreachable pairs is dropped, never
    routed (contract: `core.traffic.spec`); the level masks are gated on
    finite distance, so partitioned graphs are first-class. All four
    operands accept a leading batch axis and broadcast against each other
    — one graph against an (S, n, n) demand stack, or per-sample graphs
    against per-sample demand; a broadcast operand is materialized, since
    the kernel reads a contiguous right operand. The kernel default runs
    the weighted `analysis.wavefront.ecmp_loads_device` in fp32;
    ``use_kernel=False`` (or an explicit ``product``) is the f64 oracle,
    on the operands' device (one shared graph against a demand stack takes
    the fused :func:`_ecmp_demand_host_shared`). Returns the directed
    ``(.., n, n)`` load tensor.
    """
    dev = _device_of(dist, mult, adj, demand, device=device)
    dist, mult, adj = (_on(x, dev) for x in (dist, mult, adj))
    demand = _on(demand, dev, _F64)
    if max(dist.ndim, demand.ndim) == 3:
        shape = torch.broadcast_shapes(dist.shape, mult.shape, adj.shape,
                                       demand.shape)
        if product is None and not use_kernel and dist.ndim == 2 \
                and mult.ndim == 2 and adj.ndim == 2:
            # one shared graph, stacked demand — fuse each level's S small
            # products into single (n, S*n) / (S*n, n) GEMMs
            return _ecmp_demand_host_shared(dist, mult, adj,
                                            demand.expand(shape))
        dist, mult, adj, demand = (x.expand(shape).contiguous()
                                   for x in (dist, mult, adj, demand))
    if product is None and use_kernel:
        from ..analysis.wavefront import ecmp_loads_device

        return ecmp_loads_device(dist.float(), mult.float(),
                                 adj.float().contiguous(),
                                 demand=demand.float())
    return _brandes(dist, mult, adj, demand,
                    product or count_product(use_kernel))


def _brandes(dist, mult, adj, w, product) -> torch.Tensor:
    """The Brandes backward accumulation with an explicit ``product`` (the
    reference loop of both engines): ``w`` seeds each pair, 1.0 for
    uniform all-pairs demand or a demand tensor."""
    finite = torch.isfinite(dist)
    diam = _diameter(dist)
    sigma_inv = torch.where(finite & (mult > 0),
                            1.0 / torch.where(mult > 0, mult, 1.0), 0.0)
    delta = torch.zeros_like(sigma_inv)
    acc = torch.zeros_like(sigma_inv)
    for a in range(diam - 1, -1, -1):
        z = torch.where(dist == a + 1, (w + delta) * sigma_inv, 0.0)
        f_a = torch.where(dist == a, mult, 0.0)
        acc = acc + product(f_a.transpose(-1, -2), z)
        delta = torch.where(dist == a, mult * product(z, adj), delta)
    return adj * acc


def _ecmp_demand_host_shared(dist: torch.Tensor, mult: torch.Tensor,
                             adj: torch.Tensor, demand: torch.Tensor
                             ) -> torch.Tensor:
    """Shared-graph f64 Brandes over an (S, n, n) demand stack.

    The JAX package's f64 host path of the same name, on the operands'
    device. Same recurrence as the generic loop, but with the graph
    operands kept 2-D: the level's ``F_a^T @ Z_s`` products collapse into
    one ``(n, S*n)`` GEMM (samples stacked along columns) and ``Z_s @ A``
    into one ``(S*n, n)`` GEMM, so two large multiplies run per BFS level
    instead of 2S small ones and no (S, n, n) graph copies are made.
    """
    s, n, _ = demand.shape
    dev = demand.device
    dist = dist.to(_F64)
    mult = mult.to(_F64)
    adj = adj.to(_F64)
    finite = torch.isfinite(dist)
    diam = _diameter(dist)
    sigma_inv = torch.where(finite & (mult > 0),
                            1.0 / torch.where(mult > 0, mult, 1.0), 0.0)
    # per-level 2-D masks hoisted out of the stack loop; ``sig`` both
    # applies 1/sigma and selects the level's cells, so no (S, n, n)
    # ``where`` is ever materialized
    sig = [torch.where(dist == a + 1, sigma_inv, 0.0) for a in range(diam)]
    dmul = [torch.where(dist == a, mult, 0.0) for a in range(diam)]
    out = torch.empty((s, n, n), dtype=_F64, device=dev)
    # chunk the stack to bound its temporaries: a few MiB on the host (so
    # they stay cache-resident, as the JAX package chunks), 512 MiB on a
    # card
    budget = (1 << 29) if dev.type == "cuda" else (1 << 21)
    chunk = max(1, min(s, budget // (n * n * 8)))
    for lo in range(0, s, chunk):
        dem = demand[lo:lo + chunk]
        c = dem.shape[0]
        acc = torch.zeros((c, n, n), dtype=_F64, device=dev)
        delta = torch.zeros((c, n, n), dtype=_F64, device=dev)
        for a in range(diam - 1, -1, -1):
            # delta is only read on cells at distance a+1 (sig[a] masks the
            # rest), so overwriting it each level is safe
            z = (dem + delta) * sig[a]
            z_cols = z.transpose(0, 1).reshape(n, c * n)
            acc += (dmul[a].T @ z_cols).reshape(n, c, n).transpose(0, 1)
            if a:
                delta = dmul[a] * (z.reshape(c * n, n) @ adj).reshape(c, n, n)
        torch.mul(adj, acc, out=out[lo:lo + chunk])
    return out


def walk_slack_link_loads(g: Graph, dist, demand, slack: int,
                          class_weights: Sequence, use_kernel: bool = True,
                          directed: bool = False, device="cuda"):
    """Expected loads when demand spreads uniformly over length-(d+j) walks.

    ``class_weights[j][s, t]`` is the probability mass pair (s, t) routes in
    slack class j (rows need not be normalized globally; each entry is the
    per-pair probability of class j, summing to 1 over j on routed pairs).
    Within class j the flow spreads uniformly over all walks of length
    ``d(s,t)+j``; for j <= 1 every such walk is a simple path (a revisit
    would shorten the walk below d), so classes 0 and 1 are exactly uniform
    over the paper's slack-path sets. Class 2 walks include one-bounce
    detours (see `analysis.paths`) — documented walk-model relaxation.

    Runs ``diameter + slack`` products for the walk powers, then two per
    (class, level, position) term whose weights are not all zero (one host
    read decides which). Returns host (E,) float64 loads, or the directed
    tensor with ``directed=True``. The f32 kernel path rounds walk counts
    past 2**24, as the JAX kernel path does.
    """
    dev = _device_of(dist, demand, *class_weights, device=device)
    dist = _on(dist, dev)
    demand = _on(demand, dev, _F64)
    adj_f = _adjacency(g, dev)
    product = count_product(use_kernel)
    diam = _diameter(dist)
    max_len = diam + slack
    # walk-count powers A^0 .. A^(max_len - 1), plus totals up to max_len
    powers = [torch.eye(g.n, dtype=_F64, device=dev)]
    for _ in range(max_len):
        powers.append(product(powers[-1], adj_f))

    weighted: List[Tuple[int, torch.Tensor]] = []
    for j in range(slack + 1):
        cw = _on(class_weights[j], dev, _F64)
        for level in range(1 if j == 0 else 0, diam + 1):
            m = level + j
            if m == 0:
                continue
            total = powers[m]
            sel = (dist == level) & (total > 0) & (cw > 0)
            weighted.append((m, torch.where(
                sel, demand * cw / torch.where(sel, total, 1.0), 0.0)))
    keep = _nonempty([w for _, w in weighted])
    terms = [(powers[a], w_lj, powers[m - 1 - a])
             for (m, w_lj), k in zip(weighted, keep) if k
             for a in range(m)]
    loads = _bilinear_edge_loads(adj_f, terms, product)
    return loads if directed else directed_to_link_loads(g, loads)


def directed_to_link_loads(g: Graph, directed) -> np.ndarray:
    """Fold an (n, n) directed load matrix onto (E,) undirected link loads.

    A numpy matrix folds in its own dtype; a tensor folds in float64 on
    its device and comes back as host numpy.
    """
    u, v = g.edges[:, 0], g.edges[:, 1]
    if torch.is_tensor(directed):
        u, v = (torch.from_numpy(np.asarray(x, np.int64)).to(directed.device)
                for x in (u, v))
        d = directed.to(_F64)
        return (d[u, v] + d[v, u]).cpu().numpy()
    return directed[u, v] + directed[v, u]


def link_load_stats(loads, total_links: int,
                    prefix: str = "") -> Dict[str, float]:
    """Summary stats over the used support (loads > 0); see module docstring.

    ``loads`` is host numpy (or a tensor, copied to the host). Keys:
    ``{prefix}max_link_load``, ``{prefix}mean_link_load``,
    ``{prefix}p99_link_load``, ``{prefix}load_imbalance``,
    ``{prefix}links_used`` (+ ``links_total`` when prefix is empty).
    """
    if torch.is_tensor(loads):
        loads = loads.cpu().numpy()
    used = loads[loads > 0]
    out: Dict[str, float] = {}
    if not prefix:
        out["links_total"] = int(total_links)
    if used.size == 0:
        out.update({f"{prefix}max_link_load": 0.0,
                    f"{prefix}mean_link_load": 0.0,
                    f"{prefix}p99_link_load": 0.0,
                    f"{prefix}load_imbalance": 0.0,
                    f"{prefix}links_used": 0})
        return out
    out.update({
        f"{prefix}max_link_load": float(used.max()),
        f"{prefix}mean_link_load": float(used.mean()),
        f"{prefix}p99_link_load": float(np.percentile(used, 99)),
        f"{prefix}load_imbalance": float(used.max() / used.mean()),
        f"{prefix}links_used": int(used.size),
    })
    return out

"""Per-pair max-concurrent-flow throughput via multiplicative weights.

EvalNet's throughput question: what common fraction ``lambda`` of every
demand can the network carry simultaneously without overloading any link?
That is the *max concurrent flow* LP. `max_concurrent_flow` solves it with
the Garg–Könemann / multiplicative-weights recipe:

1. every directed edge carries a length ``l_e = w_e / c_e`` (weights start
   uniform);
2. the inner oracle — weighted shortest paths for *all* commodities at once
   — is one dense min-plus APSP through the tropical CUDA kernel, run on
   the device (`_device_apsp_solver`: the round's edge lengths are the only
   upload, scattered into a reused padded seed on the device, and the
   squaring loop reads one convergence flag per squaring); a round costs
   O(log n) semiring matmuls regardless of the commodity count;
3. every commodity routes its full demand along a current shortest path
   (vectorized greedy successor chase, randomized tie-breaking — no
   per-flow Python loops), edge weights grow as
   ``w_e *= 1 + eps * congestion_e / max_congestion``;
4. the *averaged* flow over rounds gives a feasible lower bound
   ``lambda >= 1 / max_e(load_e / c_e)``, and LP duality certifies an upper
   bound from any round's lengths:
   ``lambda <= sum_e c_e l_e / sum_i d_i dist_l(s_i, t_i)``.

The loop stops as soon as the certified gap falls below ``1 + eps`` (or
``max_rounds`` hits); the report always carries both bounds, so the result
is self-certifying — tests compare against brute-force LP oracles, but the
returned ``upper_bound / throughput`` gap is a proof in itself.

Capacity convention: full-duplex links, capacity 1.0 per direction (scale
demands, or pass ``capacity``, for other units).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

import torch

from ... import obs
from ..graph import Graph

__all__ = ["max_concurrent_flow", "route_greedy_shortest",
           "concurrent_flow_demand"]


def concurrent_flow_demand(g: Graph, dist: np.ndarray,
                           pattern: str = "all-pairs", seed: int = 0
                           ) -> np.ndarray:
    """Canonical demand matrices for the throughput stage.

    ``all-pairs``: 1.0 between every ordered reachable pair (the paper's
    per-pair saturation throughput). ``permutation``: 1.0 along a random
    derangement-ish permutation — n commodities, the scalable large-n proxy.
    """
    n = g.n
    reach = np.isfinite(dist) & ~np.eye(n, dtype=bool)
    if pattern == "all-pairs":
        return reach.astype(np.float64)
    if pattern == "permutation":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        fixed = perm == np.arange(n)
        if fixed.any():  # rotate fixed points away (or swap a lone one)
            idx = np.flatnonzero(fixed)
            if len(idx) > 1:
                perm[idx] = np.roll(perm[idx], 1)
            else:
                j = (idx[0] + 1) % n
                perm[[idx[0], j]] = perm[[j, idx[0]]]
        d = np.zeros((n, n))
        d[np.arange(n), perm] = 1.0
        return d * reach
    raise ValueError(f"unknown throughput demand pattern {pattern!r}")


def _directed_edge_index(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """Directed edge endpoints: first E rows u->v, next E rows v->u."""
    u, v = g.edges[:, 0], g.edges[:, 1]
    return np.concatenate([u, v]), np.concatenate([v, u])


def _length_matrix(g: Graph, lengths: np.ndarray) -> np.ndarray:
    """(n, n) min-plus seed from per-directed-edge lengths (2E,)."""
    n = g.n
    lm = np.full((n, n), np.float32(np.inf), np.float32)
    np.fill_diagonal(lm, 0.0)
    src, dst = _directed_edge_index(g)
    lm[src, dst] = lengths.astype(np.float32)
    return lm


def _device_apsp_solver(g: Graph, max_squarings: int, device):
    """Per-round weighted-APSP oracle with everything but the greedy chase
    on the device: uploads only the (2E,) length vector each round,
    scatters it (``index_put_``) into a reused padded min-plus seed on the
    device, and runs the squaring loop
    (`analysis.wavefront.squaring_apsp_device`). Returns
    ``lengths -> (n, n) np.float32 distances``.
    """
    from ..analysis.wavefront import pad_block, squaring_apsp_device

    n = g.n
    p = pad_block(n)
    src, dst = _directed_edge_index(g)
    # the seed is reused: every round overwrites the same edge cells, and
    # the off-edge +inf and the 0 diagonal (padding included: phantoms
    # never shortcut) never change
    seed = torch.full((p, p), float("inf"), dtype=torch.float32,
                      device=device)
    seed.fill_diagonal_(0.0)
    cells = (torch.from_numpy(src).to(device), torch.from_numpy(dst).to(device))

    def solve(lengths: np.ndarray) -> np.ndarray:
        # the per-round upload is this (2E,) f32 vector; the byte tap
        # shows it stays small
        obs.record_h2d(lengths.size * 4, "mwu_lengths")
        seed.index_put_(cells, torch.from_numpy(
            lengths.astype(np.float32)).to(device))
        if obs.enabled():
            dist, squarings = squaring_apsp_device(
                seed, max_squarings=max_squarings, telemetry=True)
            obs.current().set(squarings=squarings)
        else:
            dist = squaring_apsp_device(seed, max_squarings=max_squarings)
        return dist[:n, :n].cpu().numpy()

    return solve


def route_greedy_shortest(g: Graph, length_mat: np.ndarray, dist: np.ndarray,
                          pairs: np.ndarray, amounts: np.ndarray,
                          rng: np.random.Generator,
                          chunk: int = 16384) -> np.ndarray:
    """Route each commodity fully along one current shortest path.

    Vectorized successor chase: at node u toward t the next hop minimizes
    ``l(u, v) + dist_l(v, t)`` (Bellman), with uniform random tie-breaking
    so symmetric ties don't collapse onto one edge. Returns the (n, n)
    directed load matrix. The per-hop working set is (commodities,
    max_degree) via padded CSR neighbour lists; O(hops) numpy steps per
    chunk — never a per-flow Python loop.
    """
    from .assign import padded_neighbors, sample_columns

    n = g.n
    loads = np.zeros((n, n), np.float64)
    nbrs, valid = padded_neighbors(g)
    # per-slot out-edge lengths; padding slots never win the min
    plen = np.full(nbrs.shape, np.inf)
    rows = np.broadcast_to(np.arange(n)[:, None], nbrs.shape)
    plen[valid] = np.asarray(length_mat, np.float64)[rows[valid],
                                                     nbrs[valid]]
    dist = np.asarray(dist, np.float64)
    for lo in range(0, len(pairs), chunk):
        cur = pairs[lo:lo + chunk, 0].copy()
        dst = pairs[lo:lo + chunk, 1].copy()
        amt = amounts[lo:lo + chunk]
        idx = np.flatnonzero(cur != dst)
        guard = 0
        while len(idx):
            c, t, a = cur[idx], dst[idx], amt[idx]
            nb = nbrs[c]                                   # (k, maxdeg)
            scores = plen[c] + dist[nb, t[:, None]]
            best = scores.min(axis=1, keepdims=True)
            tol = np.maximum(np.abs(best) * 1e-6, 1e-12)
            tie = scores <= best + tol
            # uniform pick among tied minimizers
            slot = sample_columns(tie.astype(np.float64), tie, rng)
            nxt = nb[np.arange(len(c)), slot]
            np.add.at(loads, (c, nxt), a)
            cur[idx] = nxt
            idx = idx[nxt != t]
            guard += 1
            if guard > n + 1:
                raise RuntimeError(
                    "greedy routing failed to reach destinations; "
                    "length/distance matrices inconsistent")
    return loads


def max_concurrent_flow(
        g: Graph, demand, eps: float = 0.1,
        max_rounds: int = 200, capacity: float = 1.0,
        use_kernel: bool = True, seed: int = 0,
        chunk: int = 16384, device="cuda") -> Dict[str, object]:
    """Max concurrent flow of ``demand`` under unit-per-direction capacities.

    ``demand`` accepts an ``(n, n)`` matrix, a `core.traffic.TrafficSpec`,
    or a spec string (``"hotspot:zipf_a=1.4"``) — specs materialize their
    sample-0 matrix via the unified demand path. The weighted-APSP oracle
    runs on ``device`` (the tropical kernel; its plain version on the CPU,
    or with ``use_kernel=False``); the greedy chase and the bounds are host
    numpy.

    Returns a dict with the certified bounds:
      throughput          feasible lower bound on lambda (averaged flow)
      upper_bound         LP-dual upper bound (best round's lengths)
      gap                 upper_bound / throughput (>= 1; <= 1+eps when
                          ``converged``)
      aggregate_throughput  lambda * total demand (bisection-style number)
      rounds, converged, commodities, dropped_unreachable
      disconnected_fraction  dropped / requested commodities — the
                          partitioned-graph contract: demand on pairs the
                          first round's APSP proves unreachable is masked
                          out and the bounds certify the REACHABLE
                          remainder only
      link_loads          (E,) undirected loads of the scaled averaged flow
                          at lambda = throughput

    Partitioned graphs are first-class: on a demand matrix whose pairs are
    ALL unreachable the solver returns a defined zero result (throughput /
    upper_bound / aggregate 0.0, commodities 0, disconnected_fraction 1.0,
    zero link loads, converged True) instead of raising — only an empty
    demand matrix (no off-diagonal entries at all) is a caller error.
    """
    from ..analysis.wavefront import resolve_device

    if eps <= 0:
        raise ValueError("eps must be positive")
    n = g.n
    if isinstance(demand, str) or not hasattr(demand, "__array__") \
            and not isinstance(demand, (list, tuple)):
        from ..traffic.spec import as_spec

        demand = as_spec(demand).matrix(g)
    dev = resolve_device(device)
    demand = np.asarray(demand, np.float64)
    if demand.shape != (n, n):
        raise ValueError(f"demand must be (n, n) = {(n, n)}, "
                         f"got {demand.shape}")
    src_e, dst_e = _directed_edge_index(g)
    m = len(src_e)
    if m == 0:
        raise ValueError("graph has no links")

    hop_dist = None  # reachability check uses the first round's APSP
    mask = (demand > 0) & ~np.eye(n, dtype=bool)
    pairs = np.argwhere(mask)
    amounts = demand[mask]
    if len(pairs) == 0:
        raise ValueError("demand matrix has no off-diagonal entries")
    requested = len(pairs)

    rng = np.random.default_rng(seed)
    caps = np.full(m, float(capacity))
    weights = np.ones(m)
    sum_loads = np.zeros((n, n))
    best_ub = np.inf
    best_lb = 0.0
    rounds = 0
    dropped = 0
    converged = False

    max_squarings = max(1, int(np.ceil(np.log2(max(2, n)))))
    # kernel path: one device solver for all rounds — per round it uploads
    # only the (2E,) length vector, scatters into a reused padded seed on
    # the device, and runs the squaring loop there (one flag read per
    # squaring, no per-round (n, n) re-upload)
    solver = (_device_apsp_solver(g, max_squarings, dev) if use_kernel
              else None)

    with obs.span("mwu", cat="throughput", routers=n,
                  commodities=len(pairs), eps=eps,
                  max_rounds=max_rounds) as mwu_sp:
        for rounds in range(1, max_rounds + 1):
            lengths = weights / caps
            lengths = np.maximum(lengths, lengths.max() * 1e-12)
            lm = _length_matrix(g, lengths)
            if solver is not None:
                dist_l = solver(lengths)
            else:
                from ..analysis.apsp import apsp_from_lengths

                dist_l = apsp_from_lengths(lm, use_kernel=False,
                                           device=dev).cpu().numpy()

            if hop_dist is None:  # first round: drop unreachable pairs
                hop_dist = dist_l
                reach = np.isfinite(dist_l[pairs[:, 0], pairs[:, 1]])
                dropped = int((~reach).sum())
                pairs, amounts = pairs[reach], amounts[reach]
                if len(pairs) == 0:
                    # fully partitioned demand: nothing to route, nothing
                    # to certify — the defined zero result, not an error
                    mwu_sp.set(rounds=0, converged=True, throughput=0.0,
                               disconnected=1.0)
                    return {
                        "throughput": 0.0,
                        "upper_bound": 0.0,
                        "gap": np.inf,
                        "aggregate_throughput": 0.0,
                        "rounds": 0,
                        "converged": True,
                        "commodities": 0,
                        "dropped_unreachable": int(dropped),
                        "disconnected_fraction": 1.0,
                        "link_loads": np.zeros(len(g.edges)),
                    }

            # LP-dual certificate for these lengths
            sp = dist_l[pairs[:, 0], pairs[:, 1]].astype(np.float64)
            best_ub = min(best_ub, float((caps * lengths).sum()
                                         / (amounts * sp).sum()))

            loads_dir = route_greedy_shortest(g, lm, dist_l, pairs,
                                              amounts, rng, chunk=chunk)
            sum_loads += loads_dir
            cong_round = loads_dir[src_e, dst_e] / caps
            cong_avg = sum_loads[src_e, dst_e] / (rounds * caps)
            # both the round's flow and the running average route the full
            # demand; whichever is less congested certifies the better
            # lambda
            for lb, flow in ((1.0 / cong_round.max(), loads_dir),
                             (1.0 / cong_avg.max(), sum_loads / rounds)):
                if lb > best_lb:
                    best_lb, best_flow = lb, flow.copy()
            obs.instant("mwu.round", cat="throughput", round=rounds,
                        lb=best_lb, ub=best_ub,
                        gap=best_ub / best_lb if best_lb > 0 else None)
            if best_ub <= (1.0 + eps) * best_lb:
                converged = True
                break
            step = cong_round / cong_round.max()
            weights *= 1.0 + eps * step
            weights /= weights.max()
        mwu_sp.set(rounds=rounds, converged=converged,
                   throughput=best_lb, upper_bound=best_ub)

    from .assign import directed_to_link_loads

    link_loads = directed_to_link_loads(g, best_flow) * best_lb
    total_demand = float(amounts.sum())
    return {
        "throughput": float(best_lb),
        "upper_bound": float(best_ub),
        "gap": float(best_ub / best_lb) if best_lb > 0 else np.inf,
        "aggregate_throughput": float(best_lb * total_demand),
        "rounds": int(rounds),
        "converged": bool(converged),
        "commodities": int(len(pairs)),
        "dropped_unreachable": int(dropped),
        "disconnected_fraction": float(dropped / requested),
        "link_loads": link_loads,
    }

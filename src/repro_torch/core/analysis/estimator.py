"""Sampled-sources estimator: exact rows for k sources, CIs for the rest.

The exact engines hold every source row; at 100k routers even the tiled
pump pays O(N) levels x O(N^2 / panel) streamed bytes per tile, and an
all-sources pass stops being a CI-sized job. This estimator keeps the
EXACT per-source analysis — each sampled source row comes out of the
tiled/composed engine bit-equal to the full run — but only for ``k``
uniformly sampled sources, and reports sweep aggregates (average
shortest-path length, multiplicity/diversity, an ECMP saturation-
throughput estimate) as point estimates with bootstrap 95% confidence
intervals over the source sample.

What is and is not estimated:

* per-source row statistics (mean distance, eccentricity, multiplicity
  mean, multipath fraction) are EXACT for the sampled sources;
* population aggregates are sample means over sources — for
  vertex-transitive families every row has the same statistics and the CI
  collapses to a point; for irregular families the CI is real;
* ``diameter_lb`` is the max sampled eccentricity — a LOWER bound, never
  an estimate with a CI;
* throughput is reported as ``ecmp_saturation_throughput_lb``, also a
  bound, NOT a CI-covered estimate: scaling the sampled ECMP link loads
  by n/k is unbiased per link, but the peak-over-links of unbiased
  estimates is biased HIGH (each sampled source's lumpy load on its own
  incident links gets multiplied by n/k), so 1/peak is biased LOW — a
  conservative throughput bound that tightens to the exact value as
  k -> n. The attached ci95 is the bootstrap spread of the bound itself.

Held equal to the JAX package's estimator in ``tests/test_torch_extreme.py``
(same sampled ids, same rows, same bootstrap draws).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["sampled_sources_summary", "bootstrap_ci"]

#: bootstrap resamples for the 95% intervals — cheap (k-length vectors)
B_DEFAULT = 1000

#: per-batch ECMP load vectors kept for the throughput bootstrap; the
#: batched bootstrap bounds memory at O(batches x 2E) instead of O(k x 2E)
LOAD_BATCHES = 8


def bootstrap_ci(values: np.ndarray, b: int = B_DEFAULT, seed: int = 0,
                 stat=np.mean) -> Tuple[float, float, float]:
    """(point, lo95, hi95) percentile bootstrap of ``stat`` over values."""
    values = np.asarray(values, np.float64)
    point = float(stat(values))
    if values.size < 2:
        return point, point, point
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, values.size, size=(b, values.size))
    reps = stat(values[idx], axis=1)
    lo, hi = np.percentile(reps, [2.5, 97.5])
    return point, float(lo), float(hi)


def _ecmp_loads_sampled(g, ids: np.ndarray, dist_rows: np.ndarray,
                        sigma_rows: np.ndarray) -> np.ndarray:
    """Per-batch ECMP link loads from the sampled sources, via host CSR
    Brandes dependency accumulation (O(E) per source — no dense adjacency).

    Returns (batches, 2E) directed-edge loads; edge e = CSR slot e. Each
    unit src->dst demand splits over all shortest paths, so the load a
    source s puts on edge (u, v) is sigma_s[u]/sigma_s[v] x (fraction of
    s->* flow through v's subtree) — the standard Brandes recurrence with
    delta seeded at 1 per reached target.
    """
    indptr, indices = g.csr()
    n = g.n
    tail = np.repeat(np.arange(n), np.diff(indptr))     # CSR slot -> tail u
    # reverse-slot map: slot (u -> v) to slot (v -> u). Sorting the edge
    # list by (src, dst) and by (dst, src) pairs each edge with its
    # reverse at the same rank (the CSR is symmetric).
    rev = np.empty(len(indices), np.int64)
    rev[np.lexsort((indices, tail))] = np.lexsort((tail, indices))
    nbatch = min(LOAD_BATCHES, len(ids))
    loads = np.zeros((nbatch, len(indices)), np.float32)
    for j in range(len(ids)):
        d = dist_rows[j]
        sig = sigma_rows[j].astype(np.float64)
        delta = np.zeros(n, np.float64)
        d_edge_tail = d[tail]
        d_edge_head = d[indices]
        finite = d[np.isfinite(d)]
        for lvl in range(int(finite.max()) if finite.size else 0, 0, -1):
            # edges v -> u with d[v] = lvl, d[u] = lvl - 1: u precedes v,
            # and the unit flow through v (1 + delta[v]) splits over the
            # predecessors proportionally to sigma[u] (Brandes)
            e = np.nonzero((d_edge_tail == lvl)
                           & (d_edge_head == lvl - 1))[0]
            v = tail[e]
            u = indices[e]
            contrib = sig[u] * (1.0 + delta[v]) / sig[v]
            np.add.at(delta, u, contrib)
            # the flow rides the directed u -> v slot = reverse of e
            np.add.at(loads[j % nbatch], rev[e], contrib)
    return loads


def sampled_sources_summary(
        source, k: int = 64, seed: int = 0, mesh=None,
        tile_rows: Optional[int] = None, packed: bool = True,
        adjacency_budget: Optional[int] = None, block: Optional[int] = None,
        throughput: bool = False, b: int = B_DEFAULT,
        graph=None, device="cuda") -> Dict[str, object]:
    """Sweep aggregates from ``k`` exact sampled source rows + 95% CIs.

    ``source`` feeds the tiled engine (a Graph, or a dense array);
    ``mesh``/``tile_rows``/``packed``/``block``/``device`` go to
    `distributed.tiled_dist_mult_tiles` as they are — the sampled ids ride
    the ``source_ids=`` path, so each row is bit-equal to the full exact
    run.
    ``throughput=True`` adds the host-CSR Brandes ECMP estimate (needs a
    Graph; O(E) per source).

    Returns a dict with ``estimates`` mapping each aggregate to
    ``{"value": ..., "ci95": [lo, hi]}`` plus exact-by-construction
    fields (``diameter_lb``, ``sampled_sources``, ``seed``, timings).
    """
    import time

    from ... import obs
    from ...kernels.semiring import DIST_UNREACHED, MULT_SAT
    from .distributed import _router_count, tiled_dist_mult_tiles

    g = graph if graph is not None else source
    n = _router_count(source)
    k = min(k, n)
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(n, size=k, replace=False))
    kw = dict(source_ids=ids, packed=packed, mesh=mesh, device=device)
    if tile_rows is not None:
        kw["tile_rows"] = tile_rows
    if adjacency_budget is not None:
        kw["adjacency_budget"] = adjacency_budget
    if block is not None:
        kw["block"] = block

    t0 = time.perf_counter()
    avg_spl = np.zeros(k)
    ecc = np.zeros(k)
    mult_mean = np.zeros(k)
    frac_multi = np.zeros(k)
    reached = np.zeros(k)
    saturated = False
    dist_rows = np.empty((k, n), np.float32) if throughput else None
    sigma_rows = np.empty((k, n), np.float32) if throughput else None
    with obs.span("estimator.sample", cat="estimator", routers=n, k=k,
                  packed=packed) as sp:
        for r0, r1, d, m in tiled_dist_mult_tiles(source, **kw):
            d = d.astype(np.float32)
            m = m.astype(np.float32)
            if packed:
                saturated = saturated or bool((m >= MULT_SAT).any())
                d = np.where(d == DIST_UNREACHED, np.inf, d)
            for j in range(r1 - r0):
                i = r0 + j
                off = np.isfinite(d[j]) & (d[j] > 0)
                reached[i] = off.sum()
                if reached[i]:
                    avg_spl[i] = d[j][off].mean()
                    ecc[i] = d[j][off].max()
                    mult_mean[i] = m[j][off].mean()
                    frac_multi[i] = (m[j][off] > 1).mean()
                if throughput:
                    dist_rows[i] = d[j]
                    sigma_rows[i] = m[j]
        sp.set(diameter_lb=int(ecc.max()) if k else 0)

    estimates = {}
    for name, vals, s_off in (("avg_spl", avg_spl, 1),
                              ("mult_mean", mult_mean, 2),
                              ("frac_multipath", frac_multi, 3),
                              ("reached_frac", reached / max(n - 1, 1), 4)):
        point, lo, hi = bootstrap_ci(vals, b=b, seed=seed + s_off)
        estimates[name] = {"value": point, "ci95": [lo, hi]}

    if throughput:
        loads = _ecmp_loads_sampled(g, ids, dist_rows, sigma_rows)
        scale = n / k                      # unbiased per-link load scale-up
        total = loads.sum(axis=0)
        peak = float(total.max()) * scale
        tput = 1.0 / peak if peak > 0 else 1.0
        # batched bootstrap over the per-batch load vectors: resample
        # batches, rescale to the full source population, re-take the peak
        rng_b = np.random.default_rng(seed + 5)
        nb = loads.shape[0]
        reps = np.empty(min(b, 200))
        for r in range(reps.size):
            pick = rng_b.integers(0, nb, size=nb)
            rp = float(loads[pick].sum(axis=0).max()) * scale
            reps[r] = 1.0 / rp if rp > 0 else 1.0
        lo, hi = np.percentile(reps, [2.5, 97.5])
        estimates["ecmp_saturation_throughput_lb"] = {
            "value": tput, "ci95": [float(lo), float(hi)]}

    return {
        "routers": n,
        "sampled_sources": k,
        "seed": seed,
        "packed": packed,
        "saturated": saturated,
        "diameter_lb": int(ecc.max()) if k else 0,
        "estimates": estimates,
        "elapsed_s": round(time.perf_counter() - t0, 2),
        "peak_rss_mb": round(obs.peak_rss_mb(), 1),
    }

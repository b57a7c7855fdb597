"""Synthetic traffic workloads for topology evaluation, on torch.

Demand specification lives in `core.traffic` (the unified
:class:`~repro_torch.core.traffic.TrafficSpec` language); this module keeps
the flow-pairs :class:`Workload` container plus the sampled-path
evaluator, and :func:`make_traffic` survives as a deprecation shim over the
spec registry. `evaluate_workload` is a thin wrapper over the `routing`
subsystem: sampled flows are routed with one vectorized batched path chase
in host numpy (no per-flow Python loop; the same seeded draws as the JAX
package), expected loads come from `routing.assign.ecmp_link_loads` in
float64 on the device, and both reports share the single link-load
convention documented in `routing.assign` (undirected links in
``g.edges`` order; statistics over the used support).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from .graph import Graph
from .analysis.apsp import apsp_dense
from .routing import assign as _assign

__all__ = ["Workload", "make_traffic", "evaluate_workload",
           "expected_link_loads", "sample_flow_link_loads"]

#: make_traffic's historical pattern names -> TrafficSpec registry names
_LEGACY_PATTERNS = {"permutation": "permutation", "uniform": "uniform",
                    "skewed": "hotspot"}


@dataclasses.dataclass
class Workload:
    """pairs: (F, 2) router indices (src, dst); volume: bytes per flow."""

    pairs: np.ndarray
    volume: float = 1.0
    name: str = "workload"

    def demand_matrix(self, g: Graph) -> np.ndarray:
        """(n, n) demand matrix for the routing subsystem.

        Thin delegate to `core.traffic.spec.pairs_to_matrix` (the one
        pairs -> matrix primitive).
        """
        from .traffic.spec import pairs_to_matrix

        return pairs_to_matrix(g.n, self.pairs, self.volume)


def make_traffic(g: Graph, pattern: str = "permutation", flows: int = 4096,
                 seed: int = 0, zipf_a: float = 1.3) -> Workload:
    """Sample a flow-pairs workload from a named pattern.

    .. deprecated::
        Shim over `core.traffic.TrafficSpec` (``"skewed"`` maps to the
        registry's ``hotspot``). The returned workload holds *exactly*
        ``flows`` pairs — pairs are drawn from the pattern's demand
        distribution, whose diagonal is zero.
    """
    warnings.warn("workload.make_traffic is deprecated; use "
                  "core.traffic.TrafficSpec (e.g. TrafficSpec.parse("
                  f"'{pattern}:flows={flows}')) instead",
                  DeprecationWarning, stacklevel=2)
    from .traffic.spec import TrafficSpec

    if pattern not in _LEGACY_PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r}")
    name = _LEGACY_PATTERNS[pattern]
    params = {"zipf_a": zipf_a} if name == "hotspot" else {}
    spec = TrafficSpec(pattern=name, flows=int(flows), seed=int(seed),
                       params=params)
    return Workload(pairs=spec.pairs(g), name=f"{pattern}(flows={flows})")


def _host32(x) -> np.ndarray:
    """A tensor or array as host float32 numpy (the sampler's input)."""
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x, np.float32)


def sample_flow_link_loads(
        g: Graph, dist, pairs: np.ndarray,
        rng: np.random.Generator, mult=None,
        chunk: int = 65536):
    """Sample one shortest path per flow, batched over all flows at once.

    Per hop, every active flow draws a next hop among the neighbours on the
    shortest-path frontier (``d(v, t) = d(u, t) - 1``) — weighted by the
    downstream multiplicity ``sigma(v, t)`` when ``mult`` is given, so the
    sampled path is uniform over *all* shortest paths and the loads are an
    unbiased estimate of `routing.assign.ecmp_link_loads`; unweighted
    (uniform next hop) otherwise.

    ``dist`` and ``mult`` (tensors or arrays) are read as host float32
    numpy, as the JAX package reads them, so the same ``rng`` draws the
    same paths. Returns ``(loads, hops)``: (E,) undirected link loads in
    ``g.edges`` order and the total hop count. The per-hop working set is
    (flows, max_degree) — padded CSR neighbour lists, not dense rows — so a
    hop costs k * maxdeg gathers regardless of n. O(diameter) numpy steps
    per chunk.
    """
    n = g.n
    dist = _host32(dist)
    if mult is not None:
        mult = _host32(mult)
    nbrs, valid, eids = _assign.padded_neighbors(g, with_edge_ids=True)
    dloads = np.zeros(2 * g.num_edges, np.float64)  # per directed edge
    hops = 0
    for lo in range(0, len(pairs), chunk):
        cur = np.asarray(pairs[lo:lo + chunk, 0], np.int64).copy()
        dst = np.asarray(pairs[lo:lo + chunk, 1], np.int64)
        ok = (cur != dst) & np.isfinite(dist[cur, dst])
        cur, dst = cur[ok], dst[ok]
        idx = np.arange(len(cur))
        guard = 0
        while len(idx):
            c, t = cur[idx], dst[idx]
            nb = nbrs[c]                                     # (k, maxdeg)
            front = valid[c] & (dist[nb, t[:, None]] ==
                                dist[c, t][:, None] - 1)
            w = np.where(front, mult[nb, t[:, None]], np.float32(0)) \
                if mult is not None else front.astype(np.float32)
            slot = _assign.sample_columns(w, front, rng)
            rows = np.arange(len(c))
            nxt = nb[rows, slot]
            np.add.at(dloads, eids[c, slot], 1.0)
            hops += len(c)
            cur[idx] = nxt
            idx = idx[nxt != t]
            guard += 1
            if guard > n + 1:
                raise RuntimeError(
                    "routing loop; distance matrix inconsistent")
    e = g.num_edges
    return dloads[:e] + dloads[e:], hops


def expected_link_loads(g: Graph, wl: Workload, dist, mult,
                        device="cuda") -> np.ndarray:
    """Exact expected per-link load under uniform-over-all-shortest-paths
    (ECMP) routing — delegates to `routing.assign.ecmp_link_loads` (the
    vectorized level-decomposition engine; f64 path for exactness, on the
    operands' device, ``device`` for numpy operands)."""
    return _assign.ecmp_link_loads(g, dist, mult, wl.demand_matrix(g),
                                   use_kernel=False, device=device)


def _as_workload(g: Graph, wl) -> "Workload":
    """Normalize Workload | TrafficSpec | spec-string to a Workload.

    A spec without ``flows`` gets the module default (4096) so the
    sampled-path estimator has flows to chase; the exact expected-load
    side of the report still uses the workload's demand matrix.
    """
    if isinstance(wl, Workload):
        return wl
    from .traffic.spec import TrafficSpec

    spec = TrafficSpec.parse(wl)
    if spec.flows is None:
        spec = spec.with_(flows=4096)
    return Workload(pairs=spec.pairs(g), volume=spec.volume,
                    name=spec.describe())


def evaluate_workload(g: Graph, wl, dist=None, seed: int = 0, mult=None,
                      model=None, device="cuda") -> Dict:
    """Route every flow on a sampled shortest path; report link loads.

    ``wl`` accepts a :class:`Workload`, a `core.traffic.TrafficSpec`, or
    a spec string (``"hotspot:zipf_a=1.4,flows=8192"``) — specs are
    materialized to flow pairs via the unified demand path.

    max_link_load (flows across the most loaded link, normalized by the mean)
    approximates the inverse saturation throughput of the pattern. When the
    shortest-path multiplicity matrix ``mult`` is supplied (from
    `analysis.paths`), the sampler weights next hops by downstream
    multiplicity — i.e. it samples uniform-over-all-shortest-paths — and the
    report also carries the exact expected loads of that same routing model
    (``expected_*`` keys), so sampled is estimator and expected is estimand.
    Without ``mult`` the sampler falls back to uniform next hops (biased
    toward low-branching paths; no expected report).

    ``dist`` and ``mult`` are tensors or numpy arrays. Without ``dist`` the
    APSP runs on ``device`` (`analysis.apsp_dense`); the expected side runs
    in float64 on the operands' device (``device`` for numpy operands).
    Both reports use the one link-load convention from `routing.assign`:
    undirected links, statistics over the used support. Passing a
    `routing.RoutingModel` as ``model`` swaps the expected-load side for
    that model (e.g. Valiant or slack routing).
    """
    wl = _as_workload(g, wl)
    if dist is None:
        dist = apsp_dense(g, device=device)
    rng = np.random.default_rng(seed)
    pairs = wl.pairs
    if len(pairs) == 0:
        return {"flows": 0}
    loads, hop_total = sample_flow_link_loads(g, dist, pairs, rng, mult=mult)
    loads = loads * wl.volume  # same units as the expected (demand) side
    rep: Dict = {
        "workload": wl.name,
        "topology": g.name,
        "flows": int(len(pairs)),
        "avg_hops": hop_total / len(pairs),
    }
    rep.update(_assign.link_load_stats(loads, g.num_edges))
    if model is not None or mult is not None:
        demand = wl.demand_matrix(g)
        if model is not None:
            exp = model.link_loads(demand)
        else:
            exp = _assign.ecmp_link_loads(g, dist, mult, demand,
                                          use_kernel=False, device=device)
        rep.update(_assign.link_load_stats(exp, g.num_edges,
                                           prefix="expected_"))
        # legacy key: max_expected_link_load == expected_max_link_load
        rep["max_expected_link_load"] = rep["expected_max_link_load"]
    return rep

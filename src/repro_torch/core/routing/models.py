"""Routing models on torch: per-pair next-hop distributions over the shared
APSP.

A :class:`RoutingModel` is built from the matrices the
`analysis.AnalysisEngine` already computed — the (n, n) hop-distance matrix
and the exact shortest-path multiplicity matrix, as tensors on the
engine's device — and answers two questions, both fully vectorized (no
per-flow Python loops):

* ``link_loads(demand)``: exact expected per-link load when the whole
  (n, n) traffic matrix is pushed through the model (via `assign`, on the
  model's device); host numpy (E,) float64.
* ``next_hop_tensor(dests)``: the per-destination next-hop probability
  matrices ``P[t][u, v]`` — row-stochastic on every reachable (u, t) pair —
  for models with a Markovian per-hop description (host numpy).

Shipped models (the FatPaths/multipathing comparison set):

* :class:`UniformShortest` — exact ECMP: flows spread uniformly over *all*
  shortest paths. Next hops weight neighbours by downstream multiplicity
  (``P_t[u, v] = sigma(v, t) / sigma(u, t)`` on the frontier), which is
  precisely the Markov chain whose path law is uniform over shortest paths.
* :class:`ValiantVLB` — Valiant load balancing: route via a uniformly
  random intermediate router in two minimal stages. Reduces to ECMP on two
  derived demand matrices, so it reuses the same assignment engine.
* :class:`SlackRouting` — slack-limited non-minimal routing: spread each
  flow over the path classes at 0..k extra hops, class-weighted by the
  exact simple-path counts from `analysis.paths.path_counts_with_slack`.

Partitioned-graph contract (shared by every model): demand on pairs with
no path (``dist == inf``) is *dropped* — it contributes zero load and zero
routed volume, never inf/NaN. :meth:`RoutingModel.disconnected_fraction`
reports how much of a demand matrix falls in that bucket so callers can
renormalize or flag it; `ValiantVLB` additionally restricts its random
intermediates to the source's (equivalently, destination's) connected
component, so on a partitioned graph reachable demand is still fully
routed instead of silently leaking onto unreachable intermediates.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..graph import Graph
from .assign import (_device_of, _on, directed_to_link_loads,
                     ecmp_link_loads, walk_slack_link_loads)

__all__ = ["RoutingModel", "UniformShortest", "ValiantVLB", "SlackRouting",
           "MODELS", "make_model"]

_F64 = torch.float64


class RoutingModel:
    """Common interface: (g, dist, mult) -> loads / next-hop tensors.

    ``dist`` and ``mult`` are tensors, which keep their device, or numpy
    arrays, which go to ``device`` (``"cuda"`` by default). Demand
    matrices may be numpy or tensors; they are taken to the model's
    device.
    """

    name = "abstract"

    def __init__(self, g: Graph, dist, mult, use_kernel: bool = True,
                 device="cuda"):
        self.g = g
        self.device = _device_of(dist, mult, device=device)
        self.dist = _on(dist, self.device)
        self.mult = _on(mult, self.device)
        self.use_kernel = use_kernel

    @classmethod
    def from_engine(cls, engine, **kwargs) -> "RoutingModel":
        """Build from an `AnalysisEngine`, sharing its device tensors."""
        kwargs.setdefault("use_kernel", engine.use_kernel)
        kwargs.setdefault("device", engine.device)
        dist, paths = _engine_tensors(engine)
        return cls(engine.g, dist, paths["multiplicity"], **kwargs)

    def _demand(self, demand) -> torch.Tensor:
        """``demand`` on the model's device, in its own float dtype (as
        numpy keeps it; other dtypes become float64)."""
        demand = _on(demand, self.device)
        return demand if demand.is_floating_point() else demand.to(_F64)

    # -- required API ------------------------------------------------------

    def directed_link_loads(self, demand) -> torch.Tensor:
        """(n, n) expected directed edge loads for the demand matrix."""
        raise NotImplementedError

    def link_loads(self, demand) -> np.ndarray:
        """(E,) expected undirected link loads (both orientations summed)."""
        return directed_to_link_loads(self.g,
                                      self.directed_link_loads(demand))

    def average_hops(self, demand) -> float:
        """Expected hops per unit of routed demand (total load / demand)."""
        routed = self._routed_demand(demand)
        if routed <= 0:
            return 0.0
        return float(self.directed_link_loads(demand).to(_F64).sum()
                     / routed)

    def _routed_demand(self, demand) -> float:
        ok = torch.isfinite(self.dist) & (self.dist > 0)
        return float(torch.where(ok, self._demand(demand), 0.0).sum())

    def disconnected_fraction(self, demand=None) -> float:
        """Fraction of demand volume on pairs with no path.

        That demand carries zero load in every model (the documented
        partitioned-graph contract). With ``demand=None`` the fraction is
        over all ordered off-diagonal pairs — the topology's disconnected-
        pair fraction rather than a traffic-weighted one.
        """
        off = ~torch.eye(len(self.dist), dtype=torch.bool,
                         device=self.device)
        demand = (torch.ones_like(self.dist) if demand is None
                  else self._demand(demand))
        vol = float(torch.where(off, demand, 0.0).sum())
        if vol <= 0:
            return 0.0
        dead = off & ~torch.isfinite(self.dist)
        return float(torch.where(dead, demand, 0.0).sum() / vol)

    # -- optional API ------------------------------------------------------

    def next_hop_tensor(self, dests: Optional[Sequence[int]] = None
                        ) -> np.ndarray:
        """(T, n, n) next-hop probabilities; not every model is Markovian."""
        raise NotImplementedError(f"{self.name} has no per-hop description")


def _engine_tensors(engine):
    """(dist, path counts) device tensors of an exact-mode engine."""
    if not engine.exact:
        raise ValueError("routing models need the dense APSP result")
    return engine._dist(), engine._paths()


class UniformShortest(RoutingModel):
    """Exact ECMP: uniform over all shortest paths (multiplicity-weighted)."""

    name = "uniform_shortest"

    def directed_link_loads(self, demand) -> torch.Tensor:
        return ecmp_link_loads(self.g, self.dist, self.mult, demand,
                               use_kernel=self.use_kernel, directed=True)

    def next_hop_tensor(self, dests: Optional[Sequence[int]] = None
                        ) -> np.ndarray:
        """P[t][u, v] = A[u,v] * [d(v,t) = d(u,t) - 1] * sigma(v,t)/sigma(u,t).

        Row-stochastic on every (u, t) with 0 < d(u, t) < inf (Brandes'
        identity: frontier multiplicities sum to sigma(u, t)); zero rows at
        u = t and on unreachable pairs. Host numpy, from host copies of
        the model's matrices.
        """
        n = self.g.n
        dests = np.arange(n) if dests is None else np.asarray(dests)
        adj = self.g.adjacency_dense(np.float64)
        d, m = self.dist.cpu().numpy(), self.mult.cpu().numpy()
        # (T, n, n): frontier mask per destination, multiplicity weighted
        dcol = d[:, dests].T          # (T, n); dcol[t, u] = d(u, t)
        mcol = m[:, dests].T          # (T, n)
        frontier = (dcol[:, None, :] == dcol[:, :, None] - 1) & (adj > 0)[None]
        weights = np.where(frontier, mcol[:, None, :], 0.0)
        denom = np.where(mcol > 0, mcol, 1.0)[:, :, None]
        return weights / denom


class ValiantVLB(RoutingModel):
    """Valiant load balancing: two minimal stages via a random intermediate.

    Each unit of (s, t) demand is split uniformly over all intermediate
    routers w *in the source's connected component* and shipped
    s -> w -> t, each leg on uniform-shortest-path (ECMP) routing. Legs
    with w = s or w = t are the degenerate zero-length leg plus one minimal
    leg, matching the classic VLB description. Expected loads are therefore
    ECMP loads of two derived demand matrices:
    ``T1[s, w] = rowsum(T)[s] * reach[s, w] / |C(s)|`` and
    ``T2[w, t] = colsum(T)[t] * reach[w, t] / |C(t)|`` (reach = finite
    distance, |C(v)| = v's component size incl. itself). On a connected
    graph this is exactly the classic ``rowsum / n`` spread; on a
    partitioned one it keeps reachable demand fully routed — a uniform
    intermediate over ALL n routers would silently drop the share of every
    flow whose random waypoint landed in another component.
    """

    name = "valiant"

    def __init__(self, g: Graph, dist, mult, use_kernel: bool = True,
                 device="cuda"):
        super().__init__(g, dist, mult, use_kernel, device)
        self.minimal = UniformShortest(g, self.dist, self.mult, use_kernel)

    def _legs(self, demand):
        ok = torch.isfinite(self.dist) & (self.dist > 0)
        dem = torch.where(ok, self._demand(demand), 0.0)
        # component-aware uniform intermediates: reach[v, w] selects w in
        # C(v), comp[v] = |C(v)|; connected graphs reduce to reach=1,
        # comp=n — the classic all-routers spread, bit-for-bit
        reach = torch.isfinite(self.dist)
        comp = reach.sum(dim=1, keepdim=True).to(_F64)
        leg1 = dem.sum(dim=1, keepdim=True) * reach / comp
        leg2 = (dem.sum(dim=0, keepdim=True).T * reach / comp).T
        return leg1, leg2

    def directed_link_loads(self, demand) -> torch.Tensor:
        leg1, leg2 = self._legs(demand)
        return (self.minimal.directed_link_loads(leg1)
                + self.minimal.directed_link_loads(leg2))

    def next_hop_tensor(self, dests: Optional[Sequence[int]] = None
                        ) -> np.ndarray:
        """Per-leg next hops: each VLB stage is minimal toward its target."""
        return self.minimal.next_hop_tensor(dests)


class SlackRouting(RoutingModel):
    """Non-minimal routing over path classes with <= ``slack`` extra hops.

    Each (s, t) flow picks slack class j (0 <= j <= slack) with probability
    proportional to the *exact* simple-path count of that class
    (`analysis.paths.path_counts_with_slack`), then spreads uniformly over
    the class. Classes 0 and 1 are exact (length-d and length-d+1 walks are
    precisely the simple paths); class 2 spreads over length-d+2 walks,
    which include one-bounce detours — the documented walk relaxation.
    """

    name = "slack"

    def __init__(self, g: Graph, dist, mult, use_kernel: bool = True,
                 slack: int = 1,
                 path_counts: Optional[Dict[str, object]] = None,
                 device="cuda"):
        super().__init__(g, dist, mult, use_kernel, device)
        if not 0 <= slack <= 2:
            raise ValueError(f"slack must be 0..2, got {slack}")
        self.slack = slack
        if path_counts is None:
            from ..analysis.paths import path_counts_with_slack

            path_counts = path_counts_with_slack(g, self.dist,
                                                 use_kernel=use_kernel)
        self.path_counts = path_counts

    @classmethod
    def from_engine(cls, engine, **kwargs) -> "SlackRouting":
        kwargs.setdefault("path_counts", _engine_tensors(engine)[1])
        return super().from_engine(engine, **kwargs)

    def class_probabilities(self) -> torch.Tensor:
        """(slack+1, n, n) per-pair class probabilities (sum to 1), float64
        on the model's device."""
        keys = ["multiplicity", "plus1", "plus2"][: self.slack + 1]
        counts = torch.stack([_on(self.path_counts[k], self.device, _F64)
                              for k in keys])
        off = torch.isfinite(self.dist) & (self.dist > 0)
        counts = counts * off[None]
        total = counts.sum(dim=0)
        return torch.where(total > 0,
                           counts / torch.where(total > 0, total, 1.0), 0.0)

    def directed_link_loads(self, demand) -> torch.Tensor:
        probs = self.class_probabilities()
        return walk_slack_link_loads(self.g, self.dist, demand, self.slack,
                                     list(probs), use_kernel=self.use_kernel,
                                     directed=True)


MODELS: Dict[str, type] = {
    UniformShortest.name: UniformShortest,
    ValiantVLB.name: ValiantVLB,
    SlackRouting.name: SlackRouting,
}


def make_model(name: str, engine, **kwargs) -> RoutingModel:
    """Instantiate a registered model from an `AnalysisEngine`."""
    if name not in MODELS:
        raise KeyError(f"unknown routing model {name!r}; known: "
                       f"{sorted(MODELS)}")
    return MODELS[name].from_engine(engine, **kwargs)

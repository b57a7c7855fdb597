"""Three-stage k-ary fat tree (Al-Fares et al. / Clos), diameter 4.

k-port switches; k pods, each with k/2 edge and k/2 aggregation switches;
(k/2)^2 core switches; k^3/4 servers (k/2 per edge switch). Router graph:

  core[c]            c in [0, (k/2)^2)
  agg[pod, a]        a in [0, k/2)
  edge[pod, e2]      e2 in [0, k/2)

  edge(pod, e2) ~ agg(pod, a)        for all a          (intra-pod bipartite)
  agg(pod, a)   ~ core[a*(k/2) + j]  for j in [0, k/2)

Oversubscription is modelled by raising the edge-switch concentration above
k/2 (the sizing helper supports e.g. the 5x-oversubscribed configurations
used in large-scale evaluations).
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph
from .base import register
from .spec import ELECTRICAL_LENGTH_M, LinkClass, TopologySpec, optical_length


def spec_fattree(k: int, oversubscription: float = 1.0) -> TopologySpec:
    """Closed form: 5k^2/4 switches; k^3/4 intra-pod (electrical) edge<->agg
    links and k^3/4 pod-to-spine (optical) agg<->core links; servers hang
    off the k^2/2 edge switches only."""
    if k % 2:
        raise ValueError("fat tree requires even k")
    half = k // 2
    n_core, n_agg, n_edge = half * half, k * half, k * half
    n = n_core + n_agg + n_edge
    conc = int(round(half * oversubscription))
    return TopologySpec(
        family="fattree", params={"k": k},
        n_routers=n, n_servers=n_edge * conc, concentration=0,
        network_radix=k, expected_diameter=4,
        link_classes=(
            LinkClass("edge-agg", k * half * half, ELECTRICAL_LENGTH_M,
                      "electrical"),
            LinkClass("agg-core", k * half * half, optical_length(n),
                      "optical"),
        ),
        radix_counts=((k, n_core), (k, n_agg), (half + conc, n_edge)),
    )


@register("fattree", spec=spec_fattree, ladder=lambda i: {"k": 2 * (i + 2)})
def make_fattree(k: int, oversubscription: float = 1.0) -> Graph:
    if k % 2:
        raise ValueError("fat tree requires even k")
    half = k // 2
    n_core = half * half
    n_agg = k * half
    n_edge = k * half

    def core(c):
        return c

    def agg(pod, a):
        return n_core + pod * half + a

    def edge(pod, e2):
        return n_core + n_agg + pod * half + e2

    edges = []
    pods = np.arange(k, dtype=np.int64)
    h = np.arange(half, dtype=np.int64)
    # edge <-> agg: complete bipartite per pod
    for pod in range(k):
        ee, aa = np.meshgrid(h, h, indexing="ij")
        edges.append(np.stack([edge(pod, ee).ravel(), agg(pod, aa).ravel()], axis=1))
    # agg <-> core
    for pod in range(k):
        for a in range(half):
            cs = a * half + h
            edges.append(np.stack([np.full(half, agg(pod, a)), core(cs)], axis=1))
    e = np.concatenate(edges, axis=0)
    conc = int(round(half * oversubscription))
    g = Graph(
        n=n_core + n_agg + n_edge, edges=e, concentration=0,
        name=f"fattree(k={k})",
        meta={"k": k, "diameter": 4, "edge_concentration": conc,
              "n_core": n_core, "n_agg": n_agg, "n_edge": n_edge,
              "oversubscription": oversubscription},
    )
    # servers only on edge switches: store as meta; num_servers override
    g.meta["num_servers"] = n_edge * conc
    return g

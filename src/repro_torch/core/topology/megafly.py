"""Megafly / Dragonfly+ (Shpiner et al., HOTI'17; Flajslik et al.).

Two-level groups: each group is a complete bipartite graph K_{m,m} between
m leaf routers (hosting servers) and m spine routers (hosting global
links). Balanced sizing: every spine drives h = m global links, giving
g = m*h + 1 groups with exactly one global cable between every group pair
(same absolute/consecutive arrangement as the Dragonfly generator), and
every leaf hosts p = m servers.

Router-graph distances: leaf->leaf across groups is always <= 3 (leaf,
owning spine, remote spine, leaf) — the quoted Dragonfly+ "diameter 3",
which counts server traffic injected at leaves only. The *full* router
graph's diameter is set by spine->spine worst cases (up to 5 when the
direct group-pair cable lives on other spines) and depends on which
coincidences the global arrangement produces, so the spec declares no
closed-form router diameter; ``meta["leaf_diameter"] = 3`` carries the
closed-form claim that is actually invariant.
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph
from .base import register
from .dragonfly import _global_channels
from .spec import ELECTRICAL_LENGTH_M, LinkClass, TopologySpec, optical_length

__all__ = ["make_megafly", "spec_megafly"]


def _mf_params(m: int, h: int | None, g: int | None,
               concentration: int | None):
    h = h if h is not None else m
    g = g if g is not None else m * h + 1
    p = concentration if concentration is not None else m
    return m, h, g, p


def spec_megafly(m: int = 4, h: int | None = None, g: int | None = None,
                 concentration: int | None = None) -> TopologySpec:
    m, h, g, p = _mf_params(m, h, g, concentration)
    n = 2 * m * g
    _, _, _, keep = _global_channels(m, g, h)  # m spines own m*h channels
    return TopologySpec(
        family="megafly", params={"m": m, "h": h, "g": g},
        n_routers=n, n_servers=g * m * p, concentration=0,
        network_radix=m + h, expected_diameter=None,
        link_classes=(
            LinkClass("intra", g * m * m, ELECTRICAL_LENGTH_M, "electrical"),
            LinkClass("global", int(keep.sum()), optical_length(n), "optical"),
        ),
        radix_counts=((m + p, g * m), (m + h, g * m)),
    )


@register("megafly", spec=spec_megafly, ladder=lambda i: {"m": i + 2})
def make_megafly(m: int = 4, h: int | None = None, g: int | None = None,
                 concentration: int | None = None) -> Graph:
    m, h, g, p = _mf_params(m, h, g, concentration)
    n = 2 * m * g
    # group grp occupies [grp*2m, (grp+1)*2m): leaves first, spines second
    edges = []
    leaf = np.arange(m, dtype=np.int64)
    spine = m + np.arange(m, dtype=np.int64)
    ll, ss = np.meshgrid(leaf, spine, indexing="ij")
    for grp in range(g):
        base = grp * 2 * m
        edges.append(np.stack([base + ll.ravel(), base + ss.ravel()], axis=1))
    # global links: spines own channels; same absolute arrangement as the
    # dragonfly generator, one cable per group pair when balanced
    s, t, d, keep = _global_channels(m, g, h)
    t_back = (s - d - 1) % g
    r_src = np.broadcast_to(s * 2 * m + m + t // h, keep.shape)[keep]
    r_dst = (d * 2 * m + m + t_back // h)[keep]
    edges.append(np.stack([r_src, r_dst], axis=1))
    e = np.concatenate(edges, axis=0)
    return Graph(
        n=n, edges=e, concentration=0,
        name=f"megafly(m={m})",
        meta={"m": m, "h": h, "g": g, "leaf_diameter": 3 if g > 1 else 2,
              "leaf_concentration": p, "num_servers": g * m * p},
    )

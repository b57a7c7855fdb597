"""Canonical balanced Dragonfly (Kim et al., ISCA'08).

Groups of ``a`` routers, fully connected inside a group; each router has
``h`` global links; balanced sizing a = 2h, g = a*h + 1 groups, concentration
p = h. Global link arrangement: absolute/consecutive — global port j of
router r in group s connects toward group index (s + r*h + j + 1) mod g,
paired with the reciprocal port.
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph
from .base import register
from .spec import ELECTRICAL_LENGTH_M, LinkClass, TopologySpec, optical_length


def _df_params(h: int, a: int | None, g: int | None,
               concentration: int | None):
    a = a if a is not None else 2 * h
    g = g if g is not None else a * h + 1
    p = concentration if concentration is not None else h
    return h, a, g, p


def _global_channels(a: int, g: int, h: int):
    """Vectorized channel enumeration: (src_group, channel) grids + masks.

    Channel t in [0, a*h) of group s goes to group (s + t + 1) mod g; each
    global cable is emitted once from its lower-indexed group (the
    reciprocal channel covers the other direction).
    """
    s = np.arange(g, dtype=np.int64)[:, None]
    t = np.arange(a * h, dtype=np.int64)[None, :]
    d = (s + t + 1) % g
    keep = s < d
    return s, t, d, keep


def spec_dragonfly(h: int = 4, a: int | None = None, g: int | None = None,
                   concentration: int | None = None) -> TopologySpec:
    h, a, g, p = _df_params(h, a, g, concentration)
    n = a * g
    _, _, _, keep = _global_channels(a, g, h)
    return TopologySpec(
        family="dragonfly", params={"h": h, "a": a, "g": g},
        n_routers=n, n_servers=n * p, concentration=p,
        network_radix=a - 1 + h, expected_diameter=3,
        link_classes=(
            LinkClass("intra", g * a * (a - 1) // 2, ELECTRICAL_LENGTH_M,
                      "electrical"),
            LinkClass("global", int(keep.sum()), optical_length(n), "optical"),
        ),
    )


@register("dragonfly", spec=spec_dragonfly, ladder=lambda i: {"h": i + 2})
def make_dragonfly(h: int = 4, a: int | None = None, g: int | None = None,
                   concentration: int | None = None) -> Graph:
    h, a, g, p = _df_params(h, a, g, concentration)
    n = a * g
    edges = []
    # intra-group: complete graph K_a per group
    iu, iv = np.triu_indices(a, k=1)
    for grp in range(g):
        base = grp * a
        edges.append(np.stack([base + iu, base + iv], axis=1))
    # global links, each cable once, fully vectorized over (group, channel).
    # Router owning channel t is t // h; the reciprocal channel index in the
    # destination group d that points back to s is (s - d - 1) mod g (< a*h
    # when balanced a*h = g-1).
    s, t, d, keep = _global_channels(a, g, h)
    t_back = (s - d - 1) % g
    r_src = np.broadcast_to(s * a + t // h, keep.shape)[keep]
    r_dst = (d * a + t_back // h)[keep]
    edges.append(np.stack([r_src, r_dst], axis=1))
    e = np.concatenate(edges, axis=0)
    return Graph(
        n=n, edges=e, concentration=p,
        name=f"dragonfly(h={h})",
        meta={"h": h, "a": a, "g": g, "diameter": 3},
    )

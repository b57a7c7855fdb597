"""Two-level Orthogonal Fat Tree (OFT) from projective-plane incidence.

The 2-level OFT (Valerio et al.; the variant EvalNet instantiates) is the
point-line incidence graph of PG(2, q): N1 = q^2 + q + 1 leaf switches
(points) and N1 spine switches (lines); leaf P connects to spine L iff
P lies on L (P . L = 0 mod q). Every point is on q + 1 lines and every
line carries q + 1 points, so the graph is (q+1)-regular and bipartite
with girth 6 — any two leaves share exactly one spine, giving every
leaf pair a 2-hop path and the router graph diameter 3.

Servers attach to leaves only (like the fat tree's edge layer), q + 1 per
leaf at full bandwidth, so a 2-level OFT serves (q^2+q+1)(q+1) servers
with leaf radix 2(q+1).

Prime q only (shared prime table).
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph
from .base import _PRIMES, register
from .polarfly import projective_points
from .spec import LinkClass, TopologySpec, optical_length

__all__ = ["make_oft", "spec_oft"]


def spec_oft(q: int, concentration: int | None = None) -> TopologySpec:
    """Closed form: 2(q^2+q+1) switches, (q^2+q+1)(q+1) leaf-spine links,
    all spanning the floor (optical); servers on the leaf side only."""
    n1 = q * q + q + 1
    p = concentration if concentration is not None else q + 1
    return TopologySpec(
        family="oft", params={"q": q},
        n_routers=2 * n1, n_servers=n1 * p, concentration=0,
        network_radix=q + 1, expected_diameter=3,
        link_classes=(
            LinkClass("leaf-spine", n1 * (q + 1), optical_length(2 * n1),
                      "optical"),),
        radix_counts=((q + 1 + p, n1), (q + 1, n1)),
    )


@register("oft", spec=spec_oft, ladder=lambda i: {"q": _PRIMES[i]})
def make_oft(q: int, concentration: int | None = None,
             chunk: int = 2048) -> Graph:
    if q not in _PRIMES:
        raise ValueError(f"oft requires a prime q from the table, got {q}")
    pts = projective_points(q)  # doubles as the line coordinates
    n1 = len(pts)
    p = concentration if concentration is not None else q + 1
    edges = []
    for lo in range(0, n1, chunk):
        hi = min(n1, lo + chunk)
        dots = (pts[lo:hi] @ pts.T) % q  # incidence: point block x all lines
        u, v = np.nonzero(dots == 0)
        edges.append(np.stack([u + lo, v + n1], axis=1))
    e = np.concatenate(edges, axis=0)
    g = Graph(
        n=2 * n1, edges=e, concentration=0,
        name=f"oft(q={q})",
        meta={"q": q, "diameter": 3, "leaf_concentration": p,
              "n_leaves": n1, "n_spines": n1, "num_servers": n1 * p},
    )
    return g

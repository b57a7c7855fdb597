"""Xpander (Valadarsky et al., HotNets'15): expander via repeated 2-lifts.

Start from the complete graph K_{r+1} (the best r-regular expander) and apply
random 2-lifts: each lift doubles the vertex count; every edge (u, v) is
replaced, uniformly at random, by either the parallel pair ((u,0),(v,0)),
((u,1),(v,1)) or the crossed pair ((u,0),(v,1)), ((u,1),(v,0)). Degree is
preserved; spectral expansion degrades only slightly per lift (Bilu-Linial).
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph
from .base import register
from .spec import LinkClass, TopologySpec, optical_length


def spec_xpander(r: int, lifts: int, concentration: int = 1,
                 seed: int = 0) -> TopologySpec:
    """Closed form: 2-lifts preserve degree, so (r+1)*2^lifts routers at
    network radix r with n*r/2 links; lifted wiring has no locality, so
    cables are priced as optical floor runs."""
    n = (r + 1) << lifts
    return TopologySpec(
        family="xpander",
        params={"r": r, "lifts": lifts, "concentration": concentration,
                "seed": seed},
        n_routers=n, n_servers=n * concentration, concentration=concentration,
        network_radix=r, expected_diameter=None,
        link_classes=(
            LinkClass("lifted", n * r // 2, optical_length(n), "optical"),),
    )


def _xp_ladder(i: int) -> dict:
    # even radix ladder; lifts chosen so the router count tracks the
    # jellyfish/slimfly cost point n ~ 8r^2/9 (quantized by powers of two)
    r = 6 + 2 * i
    target = max(r + 1, round(8 * r * r / 9))
    lifts = max(0, round(np.log2(target / (r + 1))))
    return {"r": r, "lifts": int(lifts), "concentration": max(1, r // 2)}


@register("xpander", spec=spec_xpander, ladder=_xp_ladder)
def make_xpander(r: int, lifts: int, concentration: int = 1, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    n = r + 1
    iu, iv = np.triu_indices(n, k=1)
    e = np.stack([iu, iv], axis=1).astype(np.int64)
    for _ in range(lifts):
        cross = rng.integers(0, 2, size=len(e)).astype(np.int64)
        u, v = e[:, 0], e[:, 1]
        # copy 0 edge: (u, v + cross*n) ; copy 1 edge: (u + n, v + (1-cross)*n)
        e0 = np.stack([u, v + cross * n], axis=1)
        e1 = np.stack([u + n, v + (1 - cross) * n], axis=1)
        e = np.concatenate([e0, e1], axis=0)
        n *= 2
    return Graph(
        n=n, edges=e, concentration=concentration,
        name=f"xpander(r={r},lifts={lifts})",
        meta={"r": r, "lifts": lifts, "seed": seed},
    )

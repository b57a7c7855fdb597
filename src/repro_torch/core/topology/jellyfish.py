"""Jellyfish: random r-regular graph (Singla et al., NSDI'12).

Stub-matching with a repair pass: after random pairing, invalid pairs (self
loops / duplicates) are fixed by edge swaps. For the sizes used here the
repair converges in a handful of sweeps.
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph
from .base import register
from .spec import LinkClass, TopologySpec, optical_length


def spec_jellyfish(n: int, r: int, concentration: int = 1,
                   seed: int = 0) -> TopologySpec:
    """Closed form: r-regular on n routers (n*r/2 links). Random wiring has
    no rack locality, so every cable is priced as an optical floor run."""
    if n * r % 2 != 0:
        n += 1  # generator applies the same even-stub-count fix
    return TopologySpec(
        family="jellyfish",
        params={"n": n, "r": r, "concentration": concentration, "seed": seed},
        n_routers=n, n_servers=n * concentration, concentration=concentration,
        network_radix=r, expected_diameter=None,
        link_classes=(
            LinkClass("random", n * r // 2, optical_length(n), "optical"),),
    )


def _jf_ladder(i: int) -> dict:
    # mirror the slim fly cost point: network radix r ~ 3q/2 with
    # n = 2q^2 = 8r^2/9 routers, half the ports to servers
    r = 4 + i
    n = max(r + 1, round(8 * r * r / 9))
    return {"n": n, "r": r, "concentration": max(1, r // 2)}


@register("jellyfish", spec=spec_jellyfish, ladder=_jf_ladder)
def make_jellyfish(n: int, r: int, concentration: int = 1, seed: int = 0) -> Graph:
    if n * r % 2 != 0:
        n += 1  # need even stub count
    if r >= n:
        raise ValueError(f"need r < n, got r={r} n={n}")
    rng = np.random.default_rng(seed)

    for attempt in range(16):
        stubs = np.repeat(np.arange(n, dtype=np.int64), r)
        rng.shuffle(stubs)
        e = stubs.reshape(-1, 2)
        # repair pass: resolve self loops and duplicate edges by swapping
        for _ in range(64):
            lo = np.minimum(e[:, 0], e[:, 1])
            hi = np.maximum(e[:, 0], e[:, 1])
            key = lo * n + hi
            order = np.argsort(key)
            sorted_key = key[order]
            dup = np.zeros(len(e), dtype=bool)
            dup[order[1:]] = sorted_key[1:] == sorted_key[:-1]
            bad = dup | (e[:, 0] == e[:, 1])
            nbad = int(bad.sum())
            if nbad == 0:
                break
            bad_idx = np.nonzero(bad)[0]
            partners = rng.choice(len(e), size=nbad, replace=False)
            # swap second endpoints between bad edges and random partners
            e[bad_idx, 1], e[partners, 1] = (
                e[partners, 1].copy(), e[bad_idx, 1].copy(),
            )
        else:
            continue  # repair did not converge; reshuffle
        g = Graph(n=n, edges=e, concentration=concentration,
                  name=f"jellyfish(n={n},r={r})",
                  meta={"r": r, "seed": seed, "attempt": attempt})
        if g.num_edges == n * r // 2 and g.is_connected():
            return g
    raise RuntimeError(f"jellyfish(n={n}, r={r}) generation failed")

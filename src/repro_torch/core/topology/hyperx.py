"""HyperX (Hamming graph): complete graph in each of k dimensions.

Vertices are tuples in S_1 x ... x S_k; two vertices are adjacent iff they
differ in exactly one coordinate. Generalizes hypercube (S_i = 2) and
flattened butterfly. Diameter = number of dimensions.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..graph import Graph
from .base import register
from .spec import ELECTRICAL_LENGTH_M, LinkClass, TopologySpec, optical_length


def spec_hyperx(dims: Sequence[int] = (8, 8),
                concentration: int = 4) -> TopologySpec:
    """Closed form: per dimension i, n*(S_i - 1)/2 links — dimension 0 is
    the rack-local (electrical) one, higher dimensions span the floor."""
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    classes = []
    for axis, size in enumerate(dims):
        if size < 2:
            continue
        medium = "electrical" if axis == 0 else "optical"
        length = ELECTRICAL_LENGTH_M if axis == 0 else optical_length(n)
        classes.append(LinkClass(f"dim{axis}", n * (size - 1) // 2,
                                 length, medium))
    return TopologySpec(
        family="hyperx", params={"dims": dims, "concentration": concentration},
        n_routers=n, n_servers=n * concentration, concentration=concentration,
        network_radix=sum(d - 1 for d in dims),
        expected_diameter=len([d for d in dims if d > 1]),
        link_classes=tuple(classes),
    )


def _hyperx_ladder(i: int) -> dict:
    side = i + 2
    return {"dims": (side, side), "concentration": max(1, side // 2)}


@register("hyperx", spec=spec_hyperx, ladder=_hyperx_ladder)
def make_hyperx(dims: Sequence[int] = (8, 8), concentration: int = 4) -> Graph:
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    coords = np.indices(dims).reshape(len(dims), -1).T
    strides = np.array([int(np.prod(dims[i + 1:])) for i in range(len(dims))])
    ids = coords @ strides
    edges = []
    for axis, size in enumerate(dims):
        for delta in range(1, size):
            nxt = coords.copy()
            nxt[:, axis] = nxt[:, axis] + delta
            keep = nxt[:, axis] < size  # each unordered pair once
            u = ids[keep]
            v = nxt[keep] @ strides
            edges.append(np.stack([u, v], axis=1))
    e = np.concatenate(edges, axis=0)
    return Graph(
        n=n, edges=e, concentration=concentration,
        name=f"hyperx{dims}",
        meta={"dims": dims, "diameter": len([d for d in dims if d > 1])},
    )

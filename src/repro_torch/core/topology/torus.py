"""k-ary n-cube torus — the TPU ICI fabric model.

A v5e pod is a 16x16 2D torus of chips; v4/v5p pods are 3D tori. In this
framework the torus generator doubles as (a) an EvalNet topology family and
(b) the physical model behind the collective cost model (`core.collectives`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..graph import Graph
from .base import register
from .spec import ELECTRICAL_LENGTH_M, LinkClass, TopologySpec, optical_length


def _torus_axis_links(n: int, size: int, wrap: bool) -> int:
    if size < 2:
        return 0
    if wrap:
        return n // 2 if size == 2 else n  # length-2 rings collapse
    return n * (size - 1) // size


def spec_torus(dims: Sequence[int] = (16, 16), concentration: int = 1,
               wrap: bool = True) -> TopologySpec:
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    count = sum(_torus_axis_links(n, s, wrap) for s in dims)
    radix = sum((1 if s == 2 else 2) for s in dims if s >= 2)
    return TopologySpec(
        family="torus",
        params={"dims": dims, "concentration": concentration, "wrap": wrap},
        n_routers=n, n_servers=n * concentration, concentration=concentration,
        network_radix=radix,
        expected_diameter=sum((d // 2 if wrap else d - 1) for d in dims),
        link_classes=(
            LinkClass("neighbor", count, ELECTRICAL_LENGTH_M, "electrical"),),
    )


@register("torus", spec=spec_torus,
          ladder=lambda i: {"dims": (i + 2, i + 2), "concentration": 1})
def make_torus(dims: Sequence[int] = (16, 16), concentration: int = 1,
               wrap: bool = True) -> Graph:
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    coords = np.indices(dims).reshape(len(dims), -1).T  # (n, ndim)
    strides = np.array([int(np.prod(dims[i + 1:])) for i in range(len(dims))])
    edges = []
    for axis, size in enumerate(dims):
        if size < 2:
            continue
        nxt = coords.copy()
        nxt[:, axis] = (nxt[:, axis] + 1) % size
        u = coords @ strides
        v = nxt @ strides
        if not wrap:
            keep = coords[:, axis] + 1 < size
            u, v = u[keep], v[keep]
        elif size == 2:
            # avoid double edge on rings of length 2
            keep = coords[:, axis] == 0
            u, v = u[keep], v[keep]
        edges.append(np.stack([u, v], axis=1))
    e = np.concatenate(edges, axis=0) if edges else np.zeros((0, 2), np.int64)
    diam = sum((d // 2 if wrap else d - 1) for d in dims)
    return Graph(
        n=n, edges=e, concentration=concentration,
        name=f"torus{dims}", meta={"dims": dims, "wrap": wrap, "diameter": diam},
    )


def spec_hypercube(dim: int, concentration: int = 1) -> TopologySpec:
    """Closed form: n/2 links per bit dimension; the three lowest bit
    dimensions stay inside a rack (electrical), higher bits cross the
    floor (optical)."""
    n = 1 << dim
    elec_bits = min(dim, 3)
    classes = [LinkClass("low-bits", (n // 2) * elec_bits,
                         ELECTRICAL_LENGTH_M, "electrical")]
    if dim > elec_bits:
        classes.append(LinkClass("high-bits", (n // 2) * (dim - elec_bits),
                                 optical_length(n), "optical"))
    return TopologySpec(
        family="hypercube", params={"dim": dim, "concentration": concentration},
        n_routers=n, n_servers=n * concentration, concentration=concentration,
        network_radix=dim, expected_diameter=dim,
        link_classes=tuple(classes),
    )


@register("hypercube", spec=spec_hypercube,
          ladder=lambda i: {"dim": i + 1, "concentration": 1})
def make_hypercube(dim: int, concentration: int = 1) -> Graph:
    n = 1 << dim
    ids = np.arange(n, dtype=np.int64)
    edges = [np.stack([ids, ids ^ (1 << b)], axis=1) for b in range(dim)]
    e = np.concatenate(edges, axis=0)
    return Graph(
        n=n, edges=e, concentration=concentration,
        name=f"hypercube({dim})", meta={"dim": dim, "diameter": dim},
    )

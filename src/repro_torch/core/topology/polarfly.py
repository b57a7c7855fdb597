"""PolarFly: diameter-2 network from the Erdős–Rényi polarity graph ER_q.

Vertices are the q^2 + q + 1 points of the projective plane PG(2, q);
points u and v are adjacent iff they are orthogonal, u . v = 0 (mod q).
The polarity pairs each point with a line; self-orthogonal (quadric) points
u . u = 0 would be self-loops and are dropped, so the q + 1 quadric points
have degree q while all others have degree q + 1. ER_q meets the Moore
bound for diameter 2 asymptotically (~ (q+1)^2 routers at radix q+1, vs.
Slim Fly's ~ 0.88 of the bound), which is why the paper exercises it as
the densest diameter-2 family.

Prime q only (the shared prime table); prime powers would need GF(p^m)
arithmetic this framework does not carry.

Concentration follows the balanced rule p = ceil((q + 1) / 2).
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph
from .base import _PRIMES, register
from .spec import LinkClass, TopologySpec, optical_length

__all__ = ["make_polarfly", "spec_polarfly", "projective_points"]


def projective_points(q: int) -> np.ndarray:
    """Canonical representatives of PG(2, q): (N, 3) int64, N = q^2 + q + 1.

    First nonzero coordinate normalized to 1: (1, y, z), (0, 1, z), (0, 0, 1).
    """
    ys, zs = np.meshgrid(np.arange(q), np.arange(q), indexing="ij")
    a = np.stack([np.ones(q * q, np.int64), ys.ravel(), zs.ravel()], axis=1)
    b = np.stack([np.zeros(q, np.int64), np.ones(q, np.int64),
                  np.arange(q)], axis=1)
    c = np.array([[0, 0, 1]], dtype=np.int64)
    return np.concatenate([a, b, c], axis=0)


def spec_polarfly(q: int, concentration: int | None = None) -> TopologySpec:
    """Closed form: N = q^2+q+1 routers, q(q+1)^2/2 links; q+1 quadric
    routers sit at radix q, the rest at q+1. Polarity wiring has no rack
    locality, so all cables are priced as optical floor runs."""
    n = q * q + q + 1
    k = q + 1
    p = concentration if concentration is not None else int(np.ceil(k / 2))
    return TopologySpec(
        family="polarfly", params={"q": q},
        n_routers=n, n_servers=n * p, concentration=p,
        network_radix=k, expected_diameter=2,
        link_classes=(
            LinkClass("polarity", q * (q + 1) ** 2 // 2, optical_length(n),
                      "optical"),),
        radix_counts=((k + p, n - (q + 1)), (q + p, q + 1)),
    )


@register("polarfly", spec=spec_polarfly,
          ladder=lambda i: {"q": _PRIMES[i]})
def make_polarfly(q: int, concentration: int | None = None,
                  chunk: int = 2048) -> Graph:
    if q not in _PRIMES:
        raise ValueError(f"polarfly requires a prime q from the table, got {q}")
    pts = projective_points(q)
    n = len(pts)
    k = q + 1
    p = concentration if concentration is not None else int(np.ceil(k / 2))
    # orthogonality via blocked (N, 3) x (3, N) products mod q: never
    # materialize the full N x N matrix for million-server instances
    edges = []
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        dots = (pts[lo:hi] @ pts.T) % q  # (chunk, N)
        u, v = np.nonzero(dots == 0)
        u = u + lo
        keep = u < v  # canonical upper triangle; drops quadric self-loops
        edges.append(np.stack([u[keep], v[keep]], axis=1))
    e = np.concatenate(edges, axis=0)
    return Graph(
        n=n, edges=e, concentration=p,
        name=f"polarfly(q={q})",
        meta={"q": q, "network_radix": k, "diameter": 2},
    )

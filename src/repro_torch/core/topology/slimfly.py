"""Slim Fly (MMS) diameter-2 topology.

McKay-Miller-Siran construction over GF(q), q prime with q = 4w + delta,
delta in {-1, 0, 1}:

  * vertices: two halves of q^2 routers each, (0, x, y) and (1, m, c)
  * intra edges half 0: (0, x, y) ~ (0, x, y')  iff  y - y' in X
  * intra edges half 1: (1, m, c) ~ (1, m, c')  iff  c - c' in X'
  * cross edges: (0, x, y) ~ (1, m, c)          iff  y = m*x + c  (mod q)

X is the set of quadratic residues (even powers of a primitive element xi),
X' the non-residues (odd powers); |X| = |X'| = (q - 1)/2, so network radix
k = (3q - 1)/2 and N_r = 2 q^2 with diameter 2.

We support prime q with q ≡ 1 (mod 4) (delta = +1): there -1 is a quadratic
residue, hence X = -X and X' = -X' and both Cayley graphs are undirected.
The delta = -1 / delta = 0 MMS variants need GF(2^k)/asymmetric fixes and are
not needed for any size this framework instantiates (prime table in `base`
covers multi-million-server networks).

Concentration follows the Slim Fly paper's balanced rule  p = ceil(k / 2)
unless overridden.
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph
from .base import _PRIMES_1MOD4, register
from .spec import ELECTRICAL_LENGTH_M, LinkClass, TopologySpec, optical_length

__all__ = ["make_slimfly", "spec_slimfly"]


def _delta_for(q: int) -> int:
    if q % 4 != 1:
        raise ValueError(f"slimfly requires prime q ≡ 1 (mod 4); got q={q}")
    return 1


def _primitive_root(q: int) -> int:
    """Smallest primitive root mod prime q (q is small; brute force)."""
    if q == 2:
        return 1
    factors = set()
    phi = q - 1
    m = phi
    d = 2
    while d * d <= m:
        while m % d == 0:
            factors.add(d)
            m //= d
        d += 1
    if m > 1:
        factors.add(m)
    for g in range(2, q):
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root for {q}")


def _generator_sets(q: int, delta: int):
    """Return (X, X') generator sets per MMS: QRs and non-residues mod q."""
    del delta  # always +1 here
    xi = _primitive_root(q)
    X = {pow(xi, 2 * i, q) for i in range((q - 1) // 2)}       # residues
    Xp = {pow(xi, 2 * i + 1, q) for i in range((q - 1) // 2)}  # non-residues
    assert all((q - d) % q in X for d in X), "X must be symmetric (q=4w+1)"
    assert all((q - d) % q in Xp for d in Xp), "X' must be symmetric"
    return X, Xp


def spec_slimfly(q: int, concentration: int | None = None) -> TopologySpec:
    """Closed form: 2q^2 routers of network radix (3q-1)/2; the two Cayley
    halves contribute q^2(q-1)/2 rack-local (electrical) links, the
    cross-product matching contributes q^3 machine-room (optical) links."""
    delta = _delta_for(q)
    k = (3 * q - delta) // 2
    p = concentration if concentration is not None else int(np.ceil(k / 2))
    n = 2 * q * q
    return TopologySpec(
        family="slimfly", params={"q": q}, n_routers=n, n_servers=n * p,
        concentration=p, network_radix=k, expected_diameter=2,
        link_classes=(
            LinkClass("intra", q * q * (q - 1) // 2, ELECTRICAL_LENGTH_M,
                      "electrical"),
            LinkClass("cross", q ** 3, optical_length(n), "optical"),
        ),
    )


@register(
    "slimfly", spec=spec_slimfly,
    # ladder: successive primes q ≡ 1 (mod 4) from the shared table
    ladder=lambda i: {"q": _PRIMES_1MOD4[i]},
)
def make_slimfly(q: int, concentration: int | None = None) -> Graph:
    delta = _delta_for(q)
    X, Xp = _generator_sets(q, delta)
    n = 2 * q * q

    def vid(half: int, a: int, b: int) -> int:
        return half * q * q + a * q + b

    edges = []
    # intra-half edges: Cayley graphs on Z_q with connection sets X / X'
    diffs0 = np.array(sorted(X), dtype=np.int64)
    diffs1 = np.array(sorted(Xp), dtype=np.int64)
    ys = np.arange(q, dtype=np.int64)
    for x in range(q):
        for half, diffs in ((0, diffs0), (1, diffs1)):
            base = half * q * q + x * q
            for d in diffs:
                u = base + ys
                v = base + (ys + d) % q
                edges.append(np.stack([u, v], axis=1))
    # cross edges: y = m*x + c  => for each (x, m): c = y - m*x
    xs = np.arange(q, dtype=np.int64)
    for m in range(q):
        for x in range(q):
            c = (ys - m * x) % q
            u = np.full(q, 0, np.int64) + 0 * q * q + x * q + ys
            v = q * q + m * q + c
            edges.append(np.stack([u, v], axis=1))
    e = np.concatenate(edges, axis=0)
    k = (3 * q - delta) // 2
    p = concentration if concentration is not None else int(np.ceil(k / 2))
    return Graph(
        n=n, edges=e, concentration=p,
        name=f"slimfly(q={q})",
        meta={"q": q, "delta": delta, "network_radix": k, "diameter": 2},
    )

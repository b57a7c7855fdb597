"""The registered demand-pattern suite: seeded stacked (S, n, n) generators.

A copy of ``repro.core.traffic.patterns`` for ``repro_torch`` (host numpy;
the same seed gives the same batch in both packages).

Every generator obeys one contract, pinned by the invariant tests:

* output is ``(samples, n, n)`` float64 with a zero diagonal;
* every *live* row sums to exactly ``rate`` (the per-router injection
  rate); ``bursty`` rows are ``rate`` in an on-phase and 0 in an
  off-phase, so its time-average injection is ``duty * rate``;
* generators draw only from the passed ``rng`` — same seed, same batch.

The suite is the SpiNNaker network_tester scenario set (synchronized
bursts, hot-spot discovery) plus the classic adversarial k-ary-n-cube
patterns (tornado, shift, bit-complement) the congestion literature
evaluates:

``uniform``       rate/(n-1) to every other router — the benign baseline.
``permutation``   one random derangement per sample; all of a router's
                  traffic targets a single partner (load-balancing stress).
``tornado``       dst = (i + n//2) mod n — the worst case for rings/tori:
                  on an n-ring every column of flows concentrates on the
                  half-way links (closed form: max directed load
                  ``rate * n / 4`` on even rings, ECMP splitting both ways).
``shift``         dst = (i + shift) mod n (param ``shift``, default 1):
                  closed form max directed load ``rate * shift`` on a ring
                  while ``shift <= n/2``.
``bitcomp``       bit-complement dst = ~i when n is a power of two (every
                  flow crosses the bisection), mirror dst = n-1-i
                  otherwise; a center self-pair row (odd n) stays zero.
``hotspot``       zipf destination popularity (param ``zipf_a`` > 1,
                  default 1.3): destination ranks are a per-sample random
                  permutation, weight ∝ rank^-zipf_a, rows renormalized to
                  ``rate`` excluding the diagonal. Skew is monotone in
                  ``zipf_a``.
``bursty``        on/off phases as the stacked time axis (params ``duty``
                  in (0, 1], default 0.3; ``sync`` 0/1, default 1):
                  ``sync=1`` gates all routers with one draw per phase
                  (the network_tester synchronized burst), ``sync=0``
                  gates each router independently; on-rows inject
                  ``uniform`` at ``rate``.
"""
from __future__ import annotations

import numpy as np

from .spec import register

__all__: list = []


def _uniform_rows(n: int, rate: float) -> np.ndarray:
    """(n, n) uniform demand: rate/(n-1) off-diagonal."""
    if n < 2:
        return np.zeros((n, n), np.float64)
    m = np.full((n, n), rate / (n - 1), np.float64)
    np.fill_diagonal(m, 0.0)
    return m


def _tile(matrix: np.ndarray, samples: int) -> np.ndarray:
    """Deterministic pattern -> identical stacked copies (writable)."""
    return np.ascontiguousarray(
        np.broadcast_to(matrix, (samples,) + matrix.shape))


def _shift_matrix(n: int, k: int, rate: float) -> np.ndarray:
    m = np.zeros((n, n), np.float64)
    if n < 2:
        return m
    src = np.arange(n)
    dst = (src + k) % n
    live = src != dst
    m[src[live], dst[live]] = rate
    return m


@register("uniform")
def uniform(n: int, rate: float, rng: np.random.Generator,
            samples: int) -> np.ndarray:
    return _tile(_uniform_rows(n, rate), samples)


@register("permutation")
def permutation(n: int, rate: float, rng: np.random.Generator,
                samples: int) -> np.ndarray:
    out = np.zeros((samples, n, n), np.float64)
    if n < 2:
        return out
    src = np.arange(n)
    perms = np.argsort(rng.random((samples, n)), axis=1)
    for s in range(samples):
        perm = perms[s]
        fixed = np.flatnonzero(perm == src)
        if len(fixed) > 1:          # rotate fixed points among themselves
            perm[fixed] = np.roll(perm[fixed], 1)
        elif len(fixed) == 1:       # swap the lone fixed point with a peer
            j = (fixed[0] + 1) % n
            perm[[fixed[0], j]] = perm[[j, fixed[0]]]
        out[s, src, perm] = rate
    return out


@register("tornado")
def tornado(n: int, rate: float, rng: np.random.Generator,
            samples: int) -> np.ndarray:
    return _tile(_shift_matrix(n, n // 2, rate), samples)


@register("shift")
def shift(n: int, rate: float, rng: np.random.Generator, samples: int,
          shift: float = 1.0) -> np.ndarray:
    k = int(shift) % max(n, 1)
    if n >= 2 and k == 0:
        raise ValueError(f"shift={int(shift)} is 0 mod n={n}: every flow "
                         f"would be a self-pair")
    return _tile(_shift_matrix(n, k, rate), samples)


@register("bitcomp")
def bitcomp(n: int, rate: float, rng: np.random.Generator,
            samples: int) -> np.ndarray:
    src = np.arange(n)
    if n >= 2 and (n & (n - 1)) == 0:
        dst = (n - 1) ^ src          # true bit-complement
    else:
        dst = (n - 1) - src          # mirror: the bisection stress pattern
    m = np.zeros((n, n), np.float64)
    live = src != dst                # odd-n mirror center stays silent
    m[src[live], dst[live]] = rate
    return _tile(m, samples)


@register("hotspot")
def hotspot(n: int, rate: float, rng: np.random.Generator, samples: int,
            zipf_a: float = 1.3) -> np.ndarray:
    if n < 2:
        return np.zeros((samples, n, n), np.float64)
    if zipf_a <= 0:
        raise ValueError("zipf_a must be positive")
    ranks = np.argsort(rng.random((samples, n)), axis=1)  # dest popularity
    w = np.power(np.arange(1, n + 1, dtype=np.float64), -float(zipf_a))
    pop = np.empty((samples, n), np.float64)
    rows = np.arange(samples)[:, None]
    pop[rows, ranks] = w[None, :]
    # row i spreads `rate` over destinations j != i ∝ popularity
    denom = pop.sum(axis=1)[:, None] - pop                # (S, n) per source
    out = np.broadcast_to(pop[:, None, :],
                          (samples, n, n)) / denom[:, :, None]
    out = out * rate
    idx = np.arange(n)
    out = np.ascontiguousarray(out)
    out[:, idx, idx] = 0.0
    return out


@register("bursty")
def bursty(n: int, rate: float, rng: np.random.Generator, samples: int,
           duty: float = 0.3, sync: float = 1.0) -> np.ndarray:
    if not 0.0 < duty <= 1.0:
        raise ValueError("duty must be in (0, 1]")
    base = _uniform_rows(n, rate)
    if sync:
        on = np.broadcast_to(rng.random((samples, 1)) < duty, (samples, n))
    else:
        on = rng.random((samples, n)) < duty
    return np.where(on[:, :, None], base[None], 0.0)

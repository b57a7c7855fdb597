"""TrafficSpec — the one demand language every engine speaks.

A copy of ``repro.core.traffic.spec`` for ``repro_torch``: host numpy,
seeded, so its matrices and pairs are bit-equal to the JAX package's. A
:class:`TrafficSpec` is one spec -> pairs / matrix / stacked-batch path:

* ``spec.batch(g, samples=S)``  -> ``(S, n, n)`` stacked demand matrices,
  the input of the weighted Brandes engine
  (`routing.assign.ecmp_demand_loads`);
* ``spec.matrix(g)``            -> one ``(n, n)`` matrix (sample 0);
* ``spec.pairs(g)``             -> ``(flows, 2)`` sampled flow pairs for
  the per-flow samplers — *exactly* ``flows`` pairs, never fewer: pairs
  are drawn from the pattern's demand distribution, whose diagonal is
  zero by construction, so no self-pair filter can shrink the sample.

Patterns are registered like topology families (`topology.base`): a
generator ``fn(n, rate, rng, samples, **params) -> (S, n, n) float64``
under a name; see `traffic.patterns` for the shipped suite. Specs parse
from and print to the shared CLI flag grammar::

    permutation
    hotspot:zipf_a=1.4,samples=8
    permutation:flows=4096,seed=0

``name[:key=value,...]`` — ``rate``/``seed``/``samples``/``flows``/
``volume`` bind to the spec fields, every other key is passed to the
generator. ``TrafficSpec.parse(spec.describe())`` round-trips.

Unreachable-demand contract (the one place it is defined)
---------------------------------------------------------
Every load/throughput engine treats demand on the diagonal and on
unreachable pairs (``dist == inf``) as *dropped*, never routed and never
an error — partitioned graphs are first-class. The engines mask
implicitly (their level decompositions are gated on finite distance);
callers that need the dropped volume use
`routing.assign.mask_unreachable_demand`, which also owns the optional
``renormalize=True`` mode (rescale surviving entries to preserve total
volume — "uniform demand over the reachable pairs"). Entry points report
the dropped fraction rather than silently under-routing:
``disconnected_fraction`` in `routing.throughput` and in the routing
models.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

__all__ = ["TrafficSpec", "as_spec", "register", "patterns", "generate",
           "pairs_to_matrix", "sample_pairs_from_matrix"]

#: generator signature: (n, rate, rng, samples, **params) -> (S, n, n) f64
PatternFn = Callable[..., np.ndarray]

_REGISTRY: Dict[str, PatternFn] = {}

#: spec fields the flag grammar binds directly (everything else is a
#: generator parameter)
_INT_FIELDS = ("seed", "samples", "flows")
_FLOAT_FIELDS = ("rate", "volume")


def register(name: str):
    """Register a demand-pattern generator under ``name`` (decorator)."""

    def deco(fn: PatternFn) -> PatternFn:
        _REGISTRY[name] = fn
        return fn

    return deco


def patterns() -> List[str]:
    """Registered pattern names (sorted)."""
    return sorted(_REGISTRY)


def _pattern(name: str) -> PatternFn:
    if name not in _REGISTRY:
        raise KeyError(f"unknown traffic pattern {name!r}; "
                       f"known: {patterns()}")
    return _REGISTRY[name]


def generate(name: str, n: int, rate: float = 1.0, seed: int = 0,
             samples: int = 1, **params) -> np.ndarray:
    """Run the registered generator: ``(samples, n, n)`` float64 demand."""
    if n < 1:
        raise ValueError("traffic needs at least one router")
    if samples < 1:
        raise ValueError("samples must be >= 1")
    rng = np.random.default_rng([int(seed), _stable_tag(name)])
    out = _pattern(name)(int(n), float(rate), rng, int(samples), **params)
    out = np.asarray(out, np.float64)
    if out.shape != (samples, n, n):
        raise RuntimeError(f"pattern {name!r} returned {out.shape}, "
                           f"wanted {(samples, n, n)}")
    return out


def _stable_tag(name: str) -> int:
    """Deterministic per-pattern seed component (hash() is salted)."""
    return int.from_bytes(name.encode()[:8].ljust(8, b"\0"), "big") % (1 << 31)


# -- pairs <-> matrix ---------------------------------------------------------

def pairs_to_matrix(n: int, pairs: np.ndarray,
                    volume: float = 1.0) -> np.ndarray:
    """(n, n) f64 demand from (F, 2) flow pairs: volume per flow, summed.

    The one pairs -> matrix primitive (``routing.assign.demand_matrix`` is
    its deprecated Graph-taking shim). Self-pairs are zeroed: self-demand
    never crosses a link.
    """
    pairs = np.asarray(pairs, np.int64)
    d = np.zeros((n, n), dtype=np.float64)
    if len(pairs):
        np.add.at(d, (pairs[:, 0], pairs[:, 1]), float(volume))
    np.fill_diagonal(d, 0.0)
    return d


def sample_pairs_from_matrix(matrix: np.ndarray, flows: int,
                             rng: np.random.Generator) -> np.ndarray:
    """Draw exactly ``flows`` (src, dst) pairs ∝ the demand matrix.

    The matrix diagonal is zero for every registered pattern, so no
    self-pair can be drawn and the returned array always has ``flows``
    rows — the contract ``make_traffic`` historically broke by filtering
    self-pairs after independent src/dst draws.
    """
    m = np.asarray(matrix, np.float64).copy()
    n = m.shape[0]
    np.fill_diagonal(m, 0.0)
    total = m.sum()
    if total <= 0:
        raise ValueError("cannot sample flows from an all-zero demand "
                         "matrix (e.g. a bursty off-phase)")
    idx = rng.choice(n * n, size=int(flows), p=(m / total).ravel())
    return np.stack([idx // n, idx % n], axis=1).astype(np.int64)


# -- the spec -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """One demand scenario: pattern + rate/seed/samples (+ flow sampling).

    ``rate`` is the per-router injection rate: every registered pattern
    emits matrices whose live row sums equal ``rate`` (bursty rows are
    ``rate`` in an on-phase and 0 in an off-phase). ``samples`` is the
    stacked-batch depth — independent draws for stochastic patterns, the
    time axis for ``bursty``, identical copies for deterministic ones.

    With ``flows`` set the spec is in *flow-sampled* mode: ``pairs()``
    draws exactly that many flows from the pattern's demand distribution
    and ``matrix()``/``batch()`` return the sampled (volume-weighted)
    matrices instead of the closed-form ones.

    ``params`` holds generator-specific knobs (``zipf_a``, ``shift``,
    ``duty``, ...) as a sorted tuple of (name, float) so specs stay
    hashable; construct with a dict, read via :attr:`extras`.
    """

    pattern: str
    rate: float = 1.0
    seed: int = 0
    samples: int = 1
    flows: Optional[int] = None
    volume: float = 1.0
    params: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        p = self.params
        if isinstance(p, Mapping):
            p = tuple(sorted((str(k), float(v)) for k, v in p.items()))
        else:
            p = tuple(sorted((str(k), float(v)) for k, v in p))
        object.__setattr__(self, "params", p)
        for name, _ in p:
            if name in _INT_FIELDS or name in _FLOAT_FIELDS or \
                    name == "pattern":
                raise ValueError(f"{name!r} is a spec field, not a "
                                 f"generator parameter")

    # -- construction ------------------------------------------------------
    @classmethod
    def parse(cls, text: Union[str, "TrafficSpec"]) -> "TrafficSpec":
        """Parse the shared flag grammar, e.g. ``hotspot:zipf_a=1.4``."""
        if isinstance(text, cls):
            return text
        text = str(text).strip()
        name, _, rest = text.partition(":")
        if not name:
            raise ValueError(f"empty traffic spec {text!r}")
        fields: Dict[str, object] = {}
        extras: Dict[str, float] = {}
        if rest:
            for item in rest.split(","):
                if not item:
                    continue
                key, eq, val = item.partition("=")
                key = key.strip()
                if not eq:
                    raise ValueError(f"traffic spec item {item!r} is not "
                                     f"key=value")
                if key in _INT_FIELDS:
                    fields[key] = int(val)
                elif key in _FLOAT_FIELDS:
                    fields[key] = float(val)
                else:
                    extras[key] = float(val)
        spec = cls(pattern=name, params=extras, **fields)
        _pattern(name)  # fail fast on unknown patterns
        return spec

    def describe(self) -> str:
        """Canonical flag-grammar form; ``parse(describe())`` round-trips."""
        items: List[Tuple[str, str]] = []
        default = TrafficSpec(pattern=self.pattern)
        for f in _FLOAT_FIELDS:
            v = getattr(self, f)
            if v != getattr(default, f):
                items.append((f, f"{v:g}"))
        for f in _INT_FIELDS:
            v = getattr(self, f)
            if v != getattr(default, f) and v is not None:
                items.append((f, str(int(v))))
        items.extend((k, f"{v:g}") for k, v in self.params)
        if not items:
            return self.pattern
        body = ",".join(f"{k}={v}" for k, v in sorted(items))
        return f"{self.pattern}:{body}"

    def __str__(self) -> str:  # pragma: no cover - convenience
        return self.describe()

    @property
    def extras(self) -> Dict[str, float]:
        return dict(self.params)

    def with_(self, **changes) -> "TrafficSpec":
        """`dataclasses.replace` that accepts a params dict."""
        return dataclasses.replace(self, **changes)

    def scaled(self, factor: float) -> "TrafficSpec":
        """Same scenario at ``factor`` x the injection rate (the knob the
        saturation search bisects on)."""
        return self.with_(rate=self.rate * float(factor))

    # -- materialization ---------------------------------------------------
    def batch(self, g, samples: Optional[int] = None) -> np.ndarray:
        """``(S, n, n)`` stacked demand matrices over graph/int ``g``."""
        n = g if isinstance(g, (int, np.integer)) else g.n
        s = int(samples) if samples is not None else self.samples
        base = generate(self.pattern, n, rate=self.rate, seed=self.seed,
                        samples=s, **self.extras)
        if self.flows is None:
            return base
        rng = np.random.default_rng([int(self.seed), 0x70AD])
        out = np.zeros_like(base)
        for i in range(s):
            p = sample_pairs_from_matrix(base[i], self.flows, rng)
            out[i] = pairs_to_matrix(n, p, self.volume)
        return out

    def matrix(self, g) -> np.ndarray:
        """One ``(n, n)`` demand matrix (stacked sample 0)."""
        return self.batch(g, samples=1)[0]

    def pairs(self, g) -> np.ndarray:
        """``(flows, 2)`` sampled flow pairs — flow-sampled mode only."""
        if self.flows is None:
            raise ValueError(f"{self.describe()}: pairs() needs flows=N")
        n = g if isinstance(g, (int, np.integer)) else g.n
        base = generate(self.pattern, n, rate=self.rate, seed=self.seed,
                        samples=1, **self.extras)
        rng = np.random.default_rng([int(self.seed), 0x70AD])
        return sample_pairs_from_matrix(base[0], self.flows, rng)


def as_spec(demand: Union[str, TrafficSpec]) -> TrafficSpec:
    """str | TrafficSpec -> TrafficSpec (the CLI normalization hook)."""
    return TrafficSpec.parse(demand)

"""Topology registry + uniform spec-driven sizers.

Every family registers three callables under one name:

* ``build(**params) -> Graph`` — the generator itself;
* ``spec(**params) -> TopologySpec`` — the closed-form description (router
  and server counts, radix histogram, expected diameter, link inventory by
  cable class) computed without building any edge array;
* ``ladder(i) -> params`` — the family's parameter ladder: a monotone (in
  size) sequence of sensible configurations indexed by ``i >= 0``, e.g.
  successive primes for Slim Fly / PolarFly, successive even ``k`` for the
  fat tree.

The three sizers then solve for parameters *uniformly across families* by
searching the ladder against closed-form spec metrics:

* :func:`by_servers` — closest configuration to a server-count target (how
  the 10k / 100k / 1M scalability benchmarks instantiate families);
* :func:`by_cost` — largest configuration whose construction cost (from
  `core.costmodel`) fits a budget: the paper's equal-cost comparisons;
* :func:`by_radix` — largest configuration whose full router radix fits a
  port budget: equal-radix comparisons.

Because specs are closed form, a ladder search costs microseconds per
candidate; searches gallop to an upper bound and then scan linearly, which
also tolerates the mildly non-monotone ladders of the lift/quantized
families (Xpander).
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Optional

from ..graph import Graph
from .spec import TopologySpec

__all__ = ["register", "families", "make", "spec", "ladder_params",
           "by_servers", "by_cost", "by_radix", "solve",
           "pick_prime", "primes_near"]


@dataclasses.dataclass
class Family:
    name: str
    build: Callable[..., Graph]
    spec: Optional[Callable[..., TopologySpec]] = None
    ladder: Optional[Callable[[int], dict]] = None


_REGISTRY: Dict[str, Family] = {}


def register(name: str, spec: Callable[..., TopologySpec] | None = None,
             ladder: Callable[[int], dict] | None = None):
    def deco(fn: Callable[..., Graph]):
        _REGISTRY[name] = Family(name=name, build=fn, spec=spec, ladder=ladder)
        return fn

    return deco


def families() -> List[str]:
    return sorted(_REGISTRY)


def _family(name: str) -> Family:
    if name not in _REGISTRY:
        raise KeyError(f"unknown topology family {name!r}; known: {families()}")
    return _REGISTRY[name]


def make(name: str, **params) -> Graph:
    """Build ``name`` and attach its :class:`TopologySpec` to ``meta``."""
    fam = _family(name)
    g = fam.build(**params)
    if fam.spec is not None and "spec" not in g.meta:
        # drop build-only kwargs (e.g. polarfly's blocked-product `chunk`)
        # that don't shape the topology; genuine typos still fail in build()
        accepted = inspect.signature(fam.spec).parameters
        s = fam.spec(**{k: v for k, v in params.items() if k in accepted})
        if s.n_routers != g.n:
            raise RuntimeError(
                f"{name}: spec says {s.n_routers} routers, generator built "
                f"{g.n} — closed-form spec drifted from the generator")
        g.meta["spec"] = s
    return g


def spec(name: str, **params) -> TopologySpec:
    """Closed-form spec of ``name`` at ``params`` — no graph is built."""
    fam = _family(name)
    if fam.spec is None:
        raise KeyError(f"family {name!r} registers no spec function")
    return fam.spec(**params)


def ladder_params(name: str, i: int) -> dict:
    """The family's i-th parameter-ladder configuration."""
    fam = _family(name)
    if fam.ladder is None:
        raise KeyError(f"family {name!r} registers no parameter ladder")
    return fam.ladder(i)


# -- uniform ladder search ----------------------------------------------------

#: hard cap on ladder indices a search will visit (torus at 1M servers sits
#: near i=1000; anything past this is a sizer bug, not a big machine)
LADDER_LIMIT = 4096
#: consecutive out-of-range candidates tolerated before a scan stops —
#: absorbs the non-monotone steps of quantized ladders (Xpander's 2-lifts)
OVERSHOOT_PATIENCE = 8


def solve(name: str, metric: Callable[[TopologySpec], float], target: float,
          mode: str = "closest",
          feasible: Callable[[TopologySpec], bool] | None = None) -> dict:
    """Search the family's ladder for the configuration matching ``target``.

    ``mode="closest"`` minimizes ``|metric(spec) - target|``;
    ``mode="max_under"`` maximizes ``metric`` subject to ``metric <= target``.
    ``feasible`` adds an extra admissibility predicate (e.g. a router-count
    cap for equal-cost sweeps). Raises ValueError when no ladder point
    qualifies.
    """
    fam = _family(name)
    if fam.ladder is None or fam.spec is None:
        raise KeyError(f"family {name!r} has no sizer (needs ladder + spec)")
    best_params: Optional[dict] = None
    best_key: Optional[float] = None
    overshoots = 0
    reached = False  # some candidate met/passed the target
    for i in range(LADDER_LIMIT):
        try:
            params = fam.ladder(i)
            s = fam.spec(**params)
        except (IndexError, ValueError):
            # ladder exhausted (e.g. prime table). A "closest" target the
            # ladder never reached means the table simply ran out — error
            # like the old per-family sizers did, rather than silently
            # returning a wildly undersized configuration.
            if mode == "closest" and not reached:
                raise ValueError(
                    f"{name}: parameter ladder exhausted below target "
                    f"{target} (largest candidate is "
                    f"{'-' if best_key is None else target - best_key})")
            break
        v = metric(s)
        reached = reached or v >= target
        ok = feasible is None or feasible(s)
        if mode == "closest":
            if ok and (best_key is None or abs(v - target) < best_key):
                best_key, best_params = abs(v - target), params
            overshoots = overshoots + 1 if v > target else 0
        elif mode == "max_under":
            if ok and v <= target and (best_key is None or v > best_key):
                best_key, best_params = v, params
            overshoots = overshoots + 1 if v > target else 0
        else:
            raise ValueError(f"unknown solve mode {mode!r}")
        if overshoots >= OVERSHOOT_PATIENCE:
            break
    if best_params is None:
        raise ValueError(
            f"{name}: no ladder configuration satisfies "
            f"{mode}(metric, {target})")
    return best_params


def by_servers(name: str, n_servers: int, **overrides) -> Graph:
    """Instantiate ``name`` sized to approximately ``n_servers`` servers."""
    params = solve(name, lambda s: s.n_servers, n_servers, mode="closest")
    params.update(overrides)
    return make(name, **params)


def by_cost(name: str, budget: float, max_routers: Optional[int] = None,
            params_only: bool = False, **overrides):
    """Largest configuration whose construction cost fits ``budget``.

    Cost comes from `core.costmodel.cost_report` over the closed-form spec.
    ``max_routers`` additionally caps the router count (equal-cost sweeps
    use it to keep every instance inside the dense-analysis regime).
    ``params_only=True`` returns the solved params without building.
    """
    from ..costmodel import cost_report

    feasible = (None if max_routers is None
                else (lambda s: s.n_routers <= max_routers))
    params = solve(name, lambda s: cost_report(s)["cost_total"], budget,
                   mode="max_under", feasible=feasible)
    params.update(overrides)
    if params_only:
        return params
    return make(name, **params)


def by_radix(name: str, radix: int, max_servers: int = 10_000_000,
             params_only: bool = False, **overrides):
    """Largest configuration whose full router radix fits ``radix``.

    For families whose radix grows with scale (Slim Fly, PolarFly, fat
    tree, ...) the port budget pins the size; for radix-flat families
    (torus) ``max_servers`` bounds the search instead.
    """
    params = solve(name, lambda s: s.n_servers, max_servers,
                   mode="max_under",
                   feasible=lambda s: s.router_radix <= radix)
    params.update(overrides)
    if params_only:
        return params
    return make(name, **params)


# -- shared helpers ---------------------------------------------------------

_PRIMES = [
    5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71, 73,
    79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
    157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229,
    # the 100k-router regime: PolarFly PF(q) = q^2 + q + 1 needs q ~ 317,
    # SlimFly MMS needs q ~ 229 — keep the ladder going past both
    233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311,
    313, 317, 331, 337, 347, 349, 353, 359, 367, 373, 379, 383, 389, 397,
]

_PRIMES_1MOD4 = [p for p in _PRIMES if p % 4 == 1]


def primes_near(lo: int) -> List[int]:
    return [p for p in _PRIMES if p >= lo]


def pick_prime(target: int) -> int:
    """Smallest known prime >= target (for Slim Fly / MMS parameters)."""
    for p in _PRIMES:
        if p >= target:
            return p
    raise ValueError(f"no prime table entry >= {target}")

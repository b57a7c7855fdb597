"""TopologySpec — the closed-form contract every generator emits.

The spec-driven construction pipeline separates *describing* a topology from
*building* it: each family registers a ``spec(**params)`` function returning
a :class:`TopologySpec` computed entirely in closed form (router/server
counts, radix histogram, expected diameter, and the link inventory broken
down by cable class). Sizers (`base.by_servers` / `by_cost` / `by_radix`)
and the cost/power models (`core.costmodel`) consume specs without ever
materializing an edge array, which is what makes equal-cost parameter
solving cheap: a ladder search evaluates hundreds of candidate
configurations in microseconds each.

``make()`` attaches the spec to ``Graph.meta["spec"]`` and cross-checks the
closed-form router count against the built graph, so spec drift is caught at
construction time; the invariant test suite additionally checks link-class
counts and radix histograms against the realized edge arrays.

Cable lengths follow a deterministic machine-room layout model: electrical
cables serve rack-local links (`ELECTRICAL_LENGTH_M`), optical cables serve
everything longer, with the average run estimated from a square floor grid
of racks (`optical_length`). The EvalNet cost model prices both classes per
meter (`core.costmodel.models`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

__all__ = ["LinkClass", "TopologySpec", "ELECTRICAL_LENGTH_M",
           "optical_length"]

#: routers per rack and rack pitch for the floor-layout length model
RACK_ROUTERS = 24
RACK_PITCH_M = 1.2
#: rack-local (electrical) cable run, including slack
ELECTRICAL_LENGTH_M = 2.0
#: fixed overhead on every optical run (rack ingress/egress, slack)
OPTICAL_OVERHEAD_M = 4.0


def optical_length(n_routers: int) -> float:
    """Average optical cable run for a system of ``n_routers`` routers.

    Racks are laid out on a square floor grid; the expected Manhattan
    distance between two uniform random racks on an s x s grid is 2s/3
    rack pitches, plus a fixed per-cable overhead.
    """
    racks = max(1, math.ceil(n_routers / RACK_ROUTERS))
    side = math.sqrt(racks)
    return (2.0 / 3.0) * side * RACK_PITCH_M + OPTICAL_OVERHEAD_M


@dataclasses.dataclass(frozen=True)
class LinkClass:
    """One cable class of a topology's link inventory.

    ``count`` full-duplex inter-router cables of ``length_m`` meters each,
    realized as ``medium`` ("electrical" or "optical").
    """

    name: str
    count: int
    length_m: float
    medium: str

    def __post_init__(self):
        if self.medium not in ("electrical", "optical"):
            raise ValueError(f"unknown cable medium {self.medium!r}")
        if self.count < 0:
            raise ValueError("negative link count")


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Closed-form description of one topology instance.

    Attributes:
      family: registry name of the generator.
      params: the exact kwargs that build this instance via ``make``.
      n_routers / n_servers: router count and attached-server count.
      concentration: servers per server-hosting router (0 for families with
        heterogeneous hosting, e.g. fat tree — ``n_servers`` is authoritative).
      network_radix: max inter-router ports on any router.
      expected_diameter: the family's closed-form diameter claim (validated
        against BFS by the invariant tests), or None if the family has no
        closed form (random graphs).
      link_classes: the full link inventory by cable class; counts sum to
        the built graph's edge count.
      radix_counts: histogram of *full* router radix (network + server
        ports) as (radix, router_count) pairs summing to n_routers —
        heterogeneous families (fat tree, OFT, Megafly, HammingMesh) price
        each router tier separately in the cost model.
    """

    family: str
    params: Dict
    n_routers: int
    n_servers: int
    concentration: int
    network_radix: int
    expected_diameter: Optional[int]
    link_classes: Tuple[LinkClass, ...]
    radix_counts: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        if not self.radix_counts:
            object.__setattr__(
                self, "radix_counts",
                ((self.network_radix + self.concentration, self.n_routers),))
        total = sum(c for _, c in self.radix_counts)
        if total != self.n_routers:
            raise ValueError(
                f"{self.family}: radix_counts cover {total} routers, "
                f"spec says {self.n_routers}")

    # -- derived facts -----------------------------------------------------
    @property
    def router_radix(self) -> int:
        """Max full radix (network + server ports) over all router tiers."""
        return max(r for r, _ in self.radix_counts)

    @property
    def n_links(self) -> int:
        return sum(lc.count for lc in self.link_classes)

    def links_by_medium(self) -> Dict[str, int]:
        out = {"electrical": 0, "optical": 0}
        for lc in self.link_classes:
            out[lc.medium] += lc.count
        return out

    def describe(self) -> str:
        p = ",".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        return f"{self.family}({p})"

"""EvalNet construction-cost and power models.

The paper's comparison tables price every topology with explicit models so
that "equal cost" is a solvable constraint, not a hand-wave. This module
implements those models over a :class:`~..topology.spec.TopologySpec` link
inventory; no graph is ever built to price a configuration.

Model shape (constants in :class:`CostParams`, following the linear fits
popularized by the Slim Fly cost study [Besta & Hoefler, SC'14] that EvalNet
adopts; absolute numbers are in arbitrary currency units — the models exist
for *relative* comparison, and every constant is a single dataclass field an
operator can refit):

* cable cost is linear in length, per Gbit/s of link bandwidth, with
  separate (slope, intercept) fits per medium. Electrical copper is cheap
  per meter but has no reach; optical pays a large fixed transceiver cost
  with a shallow per-meter slope. At data-center lengths (< ~20 m) an
  optical cable is strictly more expensive than an electrical one of the
  same length — the crossover beyond which optical wins sits at
  ``(opt_base - elec_base) / (elec_per_m - opt_per_m)`` meters.
* router cost is a per-port linear term plus a small quadratic crossbar
  term in the full radix.
* power is linear in radix for routers (SerDes per port + idle floor) and
  constant per server NIC.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..topology.spec import ELECTRICAL_LENGTH_M, TopologySpec

__all__ = ["CostParams", "DEFAULT_PARAMS", "cable_cost", "router_cost",
           "router_power", "cost_report"]


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Fit constants for the construction-cost and power models."""

    #: link bandwidth the cable fits are scaled by (Gbit/s)
    link_gbps: float = 100.0
    #: electrical cable: cost = (per_m * length + base) * link_gbps
    elec_per_m: float = 0.4079
    elec_base: float = 0.5771
    #: optical cable: cost = (per_m * length + base) * link_gbps
    opt_per_m: float = 0.0919
    opt_base: float = 7.2745
    #: router cost = base + per_port * k + crossbar * k^2   (k = full radix)
    router_base: float = 500.0
    router_per_port: float = 350.4
    router_crossbar: float = 1.5
    #: router power (W) = idle + per_port * k
    router_idle_w: float = 25.0
    router_port_w: float = 3.4
    #: per-server endpoint: NIC power (W), NIC cost, and the rack-local
    #: electrical cable from server to router
    nic_w: float = 10.0
    nic_cost: float = 50.0
    endpoint_cable_m: float = ELECTRICAL_LENGTH_M


DEFAULT_PARAMS = CostParams()


def cable_cost(length_m: float, medium: str,
               params: CostParams = DEFAULT_PARAMS) -> float:
    """Cost of one full-duplex cable of ``length_m`` meters."""
    if medium == "electrical":
        return (params.elec_per_m * length_m + params.elec_base) * params.link_gbps
    if medium == "optical":
        return (params.opt_per_m * length_m + params.opt_base) * params.link_gbps
    raise ValueError(f"unknown cable medium {medium!r}")


def router_cost(radix: int, params: CostParams = DEFAULT_PARAMS) -> float:
    """Cost of one router of full radix ``radix`` (network + server ports)."""
    return (params.router_base + params.router_per_port * radix
            + params.router_crossbar * radix * radix)


def router_power(radix: int, params: CostParams = DEFAULT_PARAMS) -> float:
    """Power draw (W) of one router of full radix ``radix``."""
    return params.router_idle_w + params.router_port_w * radix


def cost_report(spec: TopologySpec,
                params: CostParams = DEFAULT_PARAMS) -> Dict[str, float]:
    """Construction cost and power of one topology instance.

    Returns a flat dict: ``cost_total`` and its breakdown (``cost_routers``,
    ``cost_cables_electrical``, ``cost_cables_optical``,
    ``cost_endpoints``), ``power_total_w`` and its breakdown
    (``power_routers_w``, ``power_nics_w``), plus the cable counts per
    medium. Endpoint (server <-> router) cables and NICs are priced per
    server so equal-cost comparisons charge concentration honestly.
    """
    c_routers = sum(router_cost(r, params) * cnt
                    for r, cnt in spec.radix_counts)
    c_elec = c_opt = 0.0
    n_elec = n_opt = 0
    for lc in spec.link_classes:
        c = cable_cost(lc.length_m, lc.medium, params) * lc.count
        if lc.medium == "electrical":
            c_elec += c
            n_elec += lc.count
        else:
            c_opt += c
            n_opt += lc.count
    c_endpoints = spec.n_servers * (
        params.nic_cost
        + cable_cost(params.endpoint_cable_m, "electrical", params))
    p_routers = sum(router_power(r, params) * cnt
                    for r, cnt in spec.radix_counts)
    p_nics = spec.n_servers * params.nic_w
    return {
        "cost_total": c_routers + c_elec + c_opt + c_endpoints,
        "cost_routers": c_routers,
        "cost_cables_electrical": c_elec,
        "cost_cables_optical": c_opt,
        "cost_endpoints": c_endpoints,
        "cables_electrical": n_elec,
        "cables_optical": n_opt,
        "power_total_w": p_routers + p_nics,
        "power_routers_w": p_routers,
        "power_nics_w": p_nics,
    }

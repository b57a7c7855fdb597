"""Construction-cost and power models over TopologySpec link inventories."""
from .models import (CostParams, DEFAULT_PARAMS, cable_cost, cost_report,
                     router_cost, router_power)  # noqa: F401

__all__ = ["CostParams", "DEFAULT_PARAMS", "cable_cost", "cost_report",
           "router_cost", "router_power"]

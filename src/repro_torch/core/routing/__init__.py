"""Routing & throughput on torch: the flow-assignment pieces the analysis
needs (`assign`) and max concurrent flow by multiplicative weights with a
tropical-kernel shortest-path oracle (`throughput`).

The routing models (``repro.core.routing.models``) and the general demand
engines of ``assign`` are not ported yet.
"""
from .assign import directed_to_link_loads  # noqa: F401
from .throughput import (  # noqa: F401
    concurrent_flow_demand, max_concurrent_flow, route_greedy_shortest,
)

__all__ = [
    "directed_to_link_loads",
    "concurrent_flow_demand", "max_concurrent_flow", "route_greedy_shortest",
]

"""Routing & throughput on torch: models -> flow assignment -> throughput.

Three layers (the paper's "exact bandwidth/throughput between every router
pair" capability):

* `models` — :class:`RoutingModel` implementations (exact-ECMP
  :class:`UniformShortest`, :class:`ValiantVLB`, :class:`SlackRouting`)
  built from the shared `analysis.AnalysisEngine` distance and
  multiplicity tensors on its device.
* `assign` — pushes whole traffic matrices through a model with counting
  products (`kernels.semiring.count_matmul`), yielding exact expected
  per-link loads: the O(diameter^2) bilinear engine, the O(diameter)
  Brandes engines (uniform all-pairs and demand-weighted), the slack walk
  engine; also owns the one link-load reporting convention.
* `throughput` — max-concurrent-flow via Garg–Könemann multiplicative
  weights with a tropical-kernel shortest-path oracle and an LP-dual
  self-certificate.
"""
from .assign import (  # noqa: F401
    demand_matrix, directed_to_link_loads, ecmp_link_loads, link_load_stats,
    walk_slack_link_loads,
)
from .models import (  # noqa: F401
    MODELS, RoutingModel, SlackRouting, UniformShortest, ValiantVLB,
    make_model,
)
from .throughput import (  # noqa: F401
    concurrent_flow_demand, max_concurrent_flow, route_greedy_shortest,
)

__all__ = [
    "demand_matrix", "directed_to_link_loads", "ecmp_link_loads",
    "link_load_stats", "walk_slack_link_loads",
    "MODELS", "RoutingModel", "SlackRouting", "UniformShortest",
    "ValiantVLB", "make_model",
    "concurrent_flow_demand", "max_concurrent_flow", "route_greedy_shortest",
]

"""Traffic scenarios on torch: the unified demand language and batched
engines.

`traffic.spec` defines :class:`TrafficSpec` — the one demand
specification every engine speaks (pattern registry, flag grammar,
spec -> pairs / matrix / stacked-batch) and the single home of the
unreachable-demand contract. `traffic.patterns` registers the scenario
suite (uniform, permutation, tornado, shift, bitcomp, hotspot, bursty).
Both are host numpy, copied from the JAX package and seeded the same, so
their demand is bit-equal to it. `traffic.scenarios` evaluates whole
demand batches as one stacked pass on the card and bisects saturation
rates; `traffic.grid` crosses scenarios with `core.resilience` failure
severities into the traffic x failure grid
(``python -m repro_torch.core.traffic``).
"""
from . import patterns  # noqa: F401  (registers the pattern suite)
from .grid import (check_grid, format_grid_table, main,  # noqa: F401
                   traffic_failure_grid)
from .scenarios import (TRAFFIC_METRICS, demand_batch,  # noqa: F401
                        evaluate_traffic_batch,
                        evaluate_traffic_failure_batch, saturation_search)
from .spec import (TrafficSpec, as_spec, generate,  # noqa: F401
                   pairs_to_matrix, register, sample_pairs_from_matrix)
from .spec import patterns as pattern_names  # noqa: F401

__all__ = ["TrafficSpec", "as_spec", "register", "generate",
           "pattern_names", "pairs_to_matrix", "sample_pairs_from_matrix",
           "TRAFFIC_METRICS", "demand_batch", "evaluate_traffic_batch",
           "evaluate_traffic_failure_batch", "saturation_search",
           "traffic_failure_grid", "format_grid_table", "check_grid",
           "main"]

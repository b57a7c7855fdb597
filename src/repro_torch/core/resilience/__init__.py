"""Fault injection, degradation curves, and crash-safe long runs, on torch.

The resilience subsystem answers the paper's "what happens when things
break" question on top of the batched device engines:

* `faults` — severity-nested failure plans (link / router / correlated
  cable-bundle) materialized as stacked ``(S, n, n)`` adjacency batches
  (host numpy, bit-equal to the JAX package's).
* `degradation` — batched device passes per severity level (masks up as
  uint8, the wavefront, Brandes and slack products on the card) ->
  throughput / reachability / path-diversity degradation curves with
  bootstrap CIs across the equal-cost family sweep, plus the CI gate.
* `checkpoint` — atomic per-tile checkpoint/resume for the tiled
  out-of-core engine (`analysis.distributed.tiled_summary`).

CLI: ``python -m repro_torch.core.resilience --help``.
"""
from .checkpoint import TileCheckpoint, source_fingerprint
from .degradation import (check_degradation, degradation_curves,
                          evaluate_failure_batch, format_degradation_table)
from .faults import (FailureBatch, FailurePlan, edge_class_labels,
                     failure_batch, failure_plan, rate_to_k)

__all__ = [
    "FailurePlan", "FailureBatch", "failure_plan", "failure_batch",
    "edge_class_labels", "rate_to_k",
    "evaluate_failure_batch", "degradation_curves",
    "format_degradation_table", "check_degradation",
    "TileCheckpoint", "source_fingerprint",
]

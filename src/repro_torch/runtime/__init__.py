"""Fault-tolerant runtime: restart loops, straggler detection, elastic mesh."""
from .fault_tolerance import (  # noqa: F401
    ElasticPolicy, HealthTracker, StepEvent, TrainLoopRunner,
)

"""Topology-aware collective cost models + mesh mapping (EvalNet → runtime).

A copy of the JAX package's `core.collectives`: the cost model and the
mapping search are plain Python and numpy, kept bit-equal, with the TPU
constants of `HardwareModel` as they are; `pod_traffic_report` runs the
torus through the port's analysis engine and routing models on a torch
device.
"""
from .cost_model import (  # noqa: F401
    AxisLink, COLLECTIVE_KINDS, HardwareModel, collective_time,
    hierarchical_all_reduce_time,
)
from .mapping import (  # noqa: F401
    MappingPlan, PhysicalFabric, plan_mesh_mapping, pod_traffic_report,
)

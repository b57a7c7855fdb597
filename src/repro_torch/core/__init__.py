"""EvalNet core: topology generators, cost model, and the equal-cost sweep.

Submodules are imported on use (`topology`, `costmodel`, `analysis`,
`sweep`); importing this package loads only the graph type and
`collectives` (the topology-aware collective cost models and mesh mapping,
plain Python and numpy), as the JAX package exports it.
"""
from . import collectives  # noqa: F401
from .graph import Graph, graph_from_arrays  # noqa: F401

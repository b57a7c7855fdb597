"""EvalNet core: topology generators, cost model, and the equal-cost sweep.

Submodules are imported on use (`topology`, `costmodel`, `analysis`,
`sweep`); importing this package loads only the graph type.
"""
from .graph import Graph, graph_from_arrays  # noqa: F401

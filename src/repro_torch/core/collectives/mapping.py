"""Mesh-axis → physical-topology mapping, scored by the EvalNet analysis.

`plan_mesh_mapping` answers: for a logical mesh (e.g. data=16, model=16) on a
physical 16x16 ICI torus (+ optional DCN pod axis), which assignment of mesh
axes to torus dimensions minimizes the cost of the workload's collective mix?

The score of a mapping is the predicted time of a normalized collective
bundle (bytes per kind per axis), evaluated through `cost_model`. The search
space at these sizes is tiny (permutations of torus dims × optional axis
folding), so exhaustive scoring is exact.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph import Graph
from ..topology import make
from .cost_model import AxisLink, HardwareModel, collective_time

__all__ = ["PhysicalFabric", "plan_mesh_mapping", "MappingPlan",
           "pod_traffic_report"]


@dataclasses.dataclass(frozen=True)
class PhysicalFabric:
    """One pod's ICI torus + the DCN between pods."""

    torus_dims: Tuple[int, ...] = (16, 16)
    n_pods: int = 1

    def pod_graph(self) -> Graph:
        return make("torus", dims=self.torus_dims)

    @property
    def chips_per_pod(self) -> int:
        return math.prod(self.torus_dims)


@dataclasses.dataclass
class MappingPlan:
    axis_links: Dict[str, AxisLink]
    assignment: Dict[str, Tuple[int, ...]]  # mesh axis -> torus dims used
    score_seconds: float
    alternatives: List[Tuple[Dict[str, Tuple[int, ...]], float]]

    def link_for(self, axis_name: str) -> AxisLink:
        return self.axis_links[axis_name]


def pod_traffic_report(fabric: PhysicalFabric, demand,
                       model: str = "uniform_shortest",
                       use_kernel: bool = True,
                       device="cuda") -> Dict[str, float]:
    """Physical link loads when a traffic matrix rides the pod torus.

    Complements the analytic `cost_model` score: pushes an (n, n)
    chip-level demand matrix (n = chips per pod) through the routing
    subsystem's assignment engine on the actual torus graph and returns
    the standard link-load statistics (`routing.assign.link_load_stats`),
    so a planned mapping's collective mix can be sanity-checked against
    exact expected per-link congestion under a chosen routing model.

    The torus runs through `analysis.AnalysisEngine` and the routing model
    on ``device`` (``"cuda"`` by default, which raises without a card;
    ``"cpu"`` runs the kernels' plain versions); ``use_kernel=False`` is
    the float64 path. Inside a process group of more than one rank the
    engine's distances run row-sharded (``mesh="auto"``).
    """
    from ..analysis import AnalysisEngine
    from ..routing import link_load_stats, make_model

    g = fabric.pod_graph()
    engine = AnalysisEngine(g, use_kernel=use_kernel, device=device)
    loads = make_model(model, engine).link_loads(
        np.asarray(demand, dtype=float))
    rep = link_load_stats(loads, g.num_edges)
    rep["routing_model"] = model
    return rep


def _axis_factorizations(mesh_axis: int, torus_dims: Sequence[int]):
    """Ways to realise a mesh axis of size `mesh_axis` on subsets of torus
    dims whose product equals the axis size (single dim or folded pair)."""
    dims = list(range(len(torus_dims)))
    for r in (1, 2):
        for combo in itertools.permutations(dims, r):
            if math.prod(torus_dims[i] for i in combo) == mesh_axis:
                yield combo


def plan_mesh_mapping(
    mesh_axes: Dict[str, int],
    fabric: PhysicalFabric = PhysicalFabric(),
    traffic: Optional[Dict[str, Dict[str, float]]] = None,
    hw: Optional[HardwareModel] = None,
) -> MappingPlan:
    """Pick torus dims per mesh axis; 'pod' (if present) rides the DCN.

    traffic: {axis_name: {collective_kind: bytes_per_step}} — defaults to an
    all-reduce-heavy mix on the first (data) axis and an all-gather-heavy mix
    on the others, the usual DP+TP signature.
    """
    hw = hw or HardwareModel()
    torus = fabric.torus_dims
    ici_axes = {k: v for k, v in mesh_axes.items() if k != "pod"}
    if "pod" in mesh_axes and mesh_axes["pod"] != fabric.n_pods:
        raise ValueError(
            f"mesh pod axis {mesh_axes['pod']} != fabric pods {fabric.n_pods}"
        )
    if math.prod(ici_axes.values()) != fabric.chips_per_pod:
        raise ValueError(
            f"mesh {ici_axes} does not fill the pod torus {torus}"
        )

    axis_names = list(ici_axes)
    if traffic is None:
        traffic = {}
        for i, name in enumerate(axis_names):
            if i == 0:
                traffic[name] = {"all-reduce": 1.0}
            else:
                traffic[name] = {"all-gather": 1.0, "reduce-scatter": 1.0}
        if "pod" in mesh_axes:
            traffic["pod"] = {"all-reduce": 1.0}

    def score(assign: Dict[str, Tuple[int, ...]]) -> float:
        t = 0.0
        for name, dims_used in assign.items():
            n = ici_axes[name]
            # folded axes ride the slower (single-ring) path per segment;
            # model as a ring over the full folded length.
            link = AxisLink(name, n, "ici_ring")
            for kind, byts in traffic.get(name, {}).items():
                t += collective_time(kind, byts, link, hw)
        return t

    # enumerate disjoint assignments of torus dims to axes
    best: Tuple[Optional[Dict], float] = (None, float("inf"))
    alts: List[Tuple[Dict, float]] = []

    def rec(i: int, used: frozenset, assign: Dict[str, Tuple[int, ...]]):
        nonlocal best
        if i == len(axis_names):
            s = score(assign)
            alts.append((dict(assign), s))
            if s < best[1]:
                best = (dict(assign), s)
            return
        name = axis_names[i]
        for combo in _axis_factorizations(ici_axes[name], torus):
            if used & frozenset(combo):
                continue
            assign[name] = combo
            rec(i + 1, used | frozenset(combo), assign)
            del assign[name]

    rec(0, frozenset(), {})
    if best[0] is None:
        raise ValueError(
            f"no assignment of mesh {ici_axes} onto torus {torus} found"
        )

    axis_links = {
        name: AxisLink(name, ici_axes[name], "ici_ring") for name in axis_names
    }
    if "pod" in mesh_axes:
        axis_links["pod"] = AxisLink("pod", mesh_axes["pod"], "dcn")
    return MappingPlan(
        axis_links=axis_links,
        assignment=best[0],
        score_seconds=best[1],
        alternatives=sorted(alts, key=lambda kv: kv[1])[:8],
    )

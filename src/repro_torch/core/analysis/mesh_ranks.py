"""Rank bodies for the mesh parity checks, run by `distributed.launch_mesh`.

A spawned rank imports the module that defines its target, so the bodies
live here and not in a test module (which imports the JAX package). Each
body runs one case list on every rank of a mesh — the sharded and composed
engines and the callers that take ``mesh=`` — and rank 0 writes every
case's arrays to one ``.npz``: ``<case>/<what>`` keys, strings (error
messages, telemetry as JSON) as 0-d arrays. The case tables below are
what the checks build on both sides: the JAX package's reference makes
the same graphs from them (:func:`build_graph`).

Run with ``launch_mesh(engine_cases, P, out_path, device="cpu")`` (or
``"cuda"`` on a card).
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import topology as T
from ..graph import Graph
from . import distributed as D
from . import wavefront as WF
from .metrics import AnalysisEngine

__all__ = ["GRAPHS", "STACK", "STACK_SIZE", "SWEEP_FAMILIES",
           "SWEEP_SERVERS", "SAMPLED", "SAMPLED_IDS", "COMPOSED_TILE_ROWS",
           "ENGINE_KNOBS", "build_graph", "build_stack", "sweep_graphs",
           "engine_cases", "analysis_cases", "report_cases"]

#: graphs of the parity cases: name -> (family, params) of a registry graph,
#: or (n, edge list) of a hand-built one
GRAPHS = {
    "slimfly": ("slimfly", {"q": 5}),
    "indivisible": ("jellyfish", {"n": 137, "r": 5, "seed": 3}),
    "loads": ("jellyfish", {"n": 96, "r": 6, "seed": 1}),
    "composed": ("jellyfish", {"n": 100, "r": 5, "seed": 0}),
    "auto": ("jellyfish", {"n": 200, "r": 6, "seed": 0}),
    "disconnected": (6, [(0, 1), (1, 2), (3, 4), (4, 5)]),
    "edgeless": (4, []),
}
#: the stacked case: three graphs zero-padded into one (3, 128, 128) stack
STACK = (("slimfly", {"q": 5}), ("torus", {"dims": (4, 5)}),
         ("hypercube", {"dim": 5}))
STACK_SIZE = 128
#: the sweep's family set: six families sized to 300 servers
SWEEP_FAMILIES = ("slimfly", "polarfly", "oft", "jellyfish", "xpander",
                  "hyperx")
SWEEP_SERVERS = 300
#: the composed engine's source tiles, and its sampled-rows case
COMPOSED_TILE_ROWS = 48
SAMPLED = ("slimfly", {"q": 13})
SAMPLED_IDS = (1, 9, 33, 34, 80)
#: the knob sets `AnalysisEngine` takes with a mesh (tiled: composed;
#: packed: composed; neither: sharded)
ENGINE_KNOBS = {"tiled": {"tile_rows": 64}, "packed": {"packed": True},
                "mesh": {}}


def build_graph(spec, make: Callable = T.make, graph_cls=Graph):
    """The graph of a :data:`GRAPHS` entry through ``make`` / ``graph_cls``
    (the port's by default; the JAX package's for its reference)."""
    if isinstance(spec[0], str):
        return make(spec[0], **spec[1])
    n, edges = spec
    return graph_cls(n=n, edges=np.array(edges, np.int64).reshape(-1, 2))


def build_stack(make: Callable = T.make) -> np.ndarray:
    """:data:`STACK`'s adjacencies zero-padded into one (3, 128, 128)
    float32 stack."""
    stack = np.zeros((len(STACK), STACK_SIZE, STACK_SIZE), np.float32)
    for i, (fam, params) in enumerate(STACK):
        g = make(fam, **params)
        stack[i, :g.n, :g.n] = g.adjacency_dense(np.float32)
    return stack


def sweep_graphs(by_servers: Callable = T.by_servers):
    """The sweep's family set at :data:`SWEEP_SERVERS` servers."""
    return [by_servers(f, SWEEP_SERVERS) for f in SWEEP_FAMILIES]


def _assemble(tiles, k: int, n: int):
    """(dist, mult, tile bounds) from a tile pump's yields."""
    tiles = list(tiles)
    d = np.concatenate([t[2] for t in tiles])
    m = np.concatenate([t[3] for t in tiles])
    if not d.shape == m.shape == (k, n):
        raise ValueError(f"tiles cover {d.shape}, not {(k, n)}")
    return d, m, np.array([(r0, r1) for r0, r1, _, _ in tiles], np.int64)


def _write(mesh, out_path: str, out: Dict[str, np.ndarray]) -> None:
    if mesh is None or mesh.rank == 0:
        np.savez(out_path, **out)


def engine_cases(mesh, out_path: str) -> None:
    """The sharded and composed engines and their ``mesh=`` callers on one
    rank of ``mesh``; rank 0 writes ``out_path``."""
    from ..routing.assign import ecmp_all_pairs_loads
    from ..sweep import sweep
    from .apsp import apsp_dense
    from .paths import shortest_path_multiplicity

    dev = mesh.device
    out: Dict[str, np.ndarray] = {}
    try:
        D.device_mesh(mesh.size + 1, device=dev)
    except ValueError as exc:
        out["mesh/too_many"] = np.array(str(exc))

    # the sharded wavefront through its host wrapper, and its telemetry
    for name in ("slimfly", "indivisible", "disconnected", "edgeless"):
        adj = build_graph(GRAPHS[name]).adjacency_dense(np.float32)
        out[f"dist_mult/{name}/dist"], out[f"dist_mult/{name}/mult"] = \
            D.sharded_dist_mult(adj, mesh)
    stack = build_stack()
    sd, sm = D.sharded_dist_mult(stack, mesh)
    out["dist_mult/stack/dist"], out["dist_mult/stack/mult"] = sd, sm
    for name, adj in (("indivisible", build_graph(
            GRAPHS["indivisible"]).adjacency_dense(np.float32)),
                      ("stack", stack)):
        p = D.pad_block_sharded(adj.shape[-1], mesh.size,
                                batched=adj.ndim == 3)[0]
        x = torch.from_numpy(WF.pad_operand(adj, p, 0.0)).to(dev)
        *_, aux = D.dist_mult_sharded(x, mesh, telemetry=True)
        out[f"telemetry/{name}"] = np.array(
            json.dumps(WF.telemetry_attrs(aux)))

    # the sharded Brandes loads, 2D and stacked
    g = build_graph(GRAPHS["loads"])
    d, m = WF.wavefront_dist_mult(g.adjacency_dense(np.float32), device=dev)
    out["loads/loads"] = ecmp_all_pairs_loads(
        d, m, g.adjacency_dense(np.float64), mesh=mesh).cpu().numpy()
    out["loads/stack"] = ecmp_all_pairs_loads(
        sd, sm, stack, mesh=mesh).cpu().numpy()

    # the composed engine: f32 and packed, sampled rows, the budget
    g = build_graph(GRAPHS["indivisible"])
    for packed in (False, True):
        key = "packed" if packed else "f32"
        (out[f"composed/{key}/dist"], out[f"composed/{key}/mult"],
         out[f"composed/{key}/bounds"]) = _assemble(
            D.composed_dist_mult_tiles(g, mesh, tile_rows=COMPOSED_TILE_ROWS,
                                       packed=packed), g.n, g.n)
    gs = T.make(SAMPLED[0], **SAMPLED[1])
    (out["composed/sampled/dist"], out["composed/sampled/mult"],
     out["composed/sampled/bounds"]) = _assemble(
        D.composed_dist_mult_tiles(gs, mesh, tile_rows=3,
                                   source_ids=list(SAMPLED_IDS)),
        len(SAMPLED_IDS), gs.n)
    g = build_graph(GRAPHS["slimfly"])
    try:
        next(D.composed_dist_mult_tiles(g, mesh, adjacency_budget=1))
    except ValueError as exc:
        out["composed/budget/error"] = np.array(str(exc))
    p = D._pad128(g.n)
    p += (-p) % (mesh.size * 128)
    (out["composed/budget/dist"], out["composed/budget/mult"], _) = \
        _assemble(D.composed_dist_mult_tiles(
            g, mesh, adjacency_budget=p * p // mesh.size, packed=True),
            g.n, g.n)

    # the callers: apsp / multiplicity composed, the sweep, the engine
    g = build_graph(GRAPHS["composed"])
    out["apsp/composed"] = apsp_dense(g, mesh=mesh, tile_rows=32,
                                      device=dev).cpu().numpy()
    out["paths/composed/dist"], out["paths/composed/mult"] = \
        shortest_path_multiplicity(g, mesh=mesh, tile_rows=32, device=dev)
    graphs = sweep_graphs()
    for key, m_ in (("mesh", mesh), ("auto", "auto"), ("none", None)):
        rows = sweep(graphs=graphs, budget=0.0, device=dev, mesh=m_)["rows"]
        for col in ("routers", "diameter", "avg_spl", "mult_mean",
                    "mult_min", "tput_lb", "reachable_frac"):
            out[f"sweep/{key}/{col}"] = np.array([r[col] for r in rows])
    g = build_graph(GRAPHS["auto"])
    auto = D.default_mesh(g.n, device=dev)
    out["engine/auto/shards"] = np.array(1 if auto is None else auto.size)
    for key, m_ in (("auto", "auto"), ("none", None)):
        e = AnalysisEngine(g, device=dev, mesh=m_)
        out[f"engine/{key}/dist"] = e.distances()
        out[f"engine/{key}/mult"] = e.shortest_path_mult()
    _write(mesh, out_path, out)


def analysis_cases(mesh, out_path: str, graph: Graph) -> None:
    """`AnalysisEngine(graph, mesh=mesh, **knobs)` distances and
    multiplicities for each of :data:`ENGINE_KNOBS`; rank 0 writes
    ``out_path``."""
    out: Dict[str, np.ndarray] = {}
    for key, kw in ENGINE_KNOBS.items():
        e = AnalysisEngine(graph, device=mesh.device, mesh=mesh, **kw)
        out[f"{key}/dist"] = e.distances()
        out[f"{key}/mult"] = e.shortest_path_mult()
    _write(mesh, out_path, out)


def report_cases(mesh, out_path: str, demand: np.ndarray,
                 models=("uniform_shortest",),
                 device: Optional[str] = None) -> None:
    """`collectives.pod_traffic_report` on the default fabric under
    ``demand`` for each routing model, on one rank of ``mesh`` (its
    engine picks the mesh up through ``mesh="auto"``); rank 0 writes
    ``out_path``: each report as JSON, and the shards the engine used."""
    from ..collectives import PhysicalFabric, pod_traffic_report

    dev = mesh.device if device is None else device
    fabric = PhysicalFabric()
    auto = D.default_mesh(fabric.chips_per_pod, device=dev)
    out = {"shards": np.array(1 if auto is None else auto.size)}
    for model in models:
        out[f"report/{model}"] = np.array(json.dumps(
            pod_traffic_report(fabric, demand, model=model, device=dev)))
    _write(mesh, out_path, out)

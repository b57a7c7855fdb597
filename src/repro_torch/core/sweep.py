"""Equal-cost topology comparison driver — the paper's headline table.

Instantiates many families at *matched construction cost* (``by_cost``
ladder solving over closed-form specs) and pushes the whole set through the
analysis stack **batched**: every topology's adjacency is padded to one
shared size and stacked along a leading axis, so each kernel launch serves
the entire sweep. Stages:

1. level-synchronous Brandes frontier expansion — ONE stacked fused
   frontier step per BFS level yields hop distances AND exact shortest-path
   multiplicities together (`analysis.wavefront.dist_mult_device`);
2. stacked Brandes accumulation (`analysis.wavefront.ecmp_loads_device`,
   2 counting products per level) -> exact expected ECMP link loads under
   uniform all-pairs demand, whose max gives the per-pair
   saturation-throughput lower bound ``lambda >= 1 / max_load`` (capacity 1
   per link direction);
3. `core.costmodel` over each spec -> construction cost and power columns;
4. with ``traffic=``, one scenario's demand batch per family through the
   weighted Brandes engine (`traffic.scenarios.evaluate_traffic_batch`) on
   the family's own dist/mult slices, still on the device.

The padded stack is uploaded once, both level loops run on the device
through the hand-written CUDA kernels (`kernels.semiring`), and only the
final dist/mult/loads matrices come back to the host. ``use_kernel=False``
runs the same loops with the kernels' plain versions on the same device.
Inside a process group of more than one rank (``mesh="auto"``, or an
explicit `analysis.distributed.RowMesh`) both loops run row-sharded: each
rank owns a row block of every stacked problem, and only the convergence
flag, the Brandes partials and the final rows cross between ranks.

:func:`batched_apsp` and :func:`batched_dist_mult` are the stacked stages
on their own: hop distances (and multiplicities) for a whole stack of
topologies, through the wavefront or, as the oracle, the stacked min-plus
squaring (`kernels.ops.batched_minplus_matmul`, one launch per squaring
for the whole stack) and the host-looped level sweep.

:func:`sweep_extreme` is the extreme-scale mode: every family sized to a
ROUTER target (100k in the paper's table) and analyzed through the
sampled-sources estimator on the tiled engine, or with ``mesh=`` the
composed engine over the mesh's ranks
(`analysis.estimator.sampled_sources_summary`).

CLI::

  python -m repro_torch.core.sweep [--families a,b,... ] [--ref-servers N]
                                   [--budget C] [--max-routers N] [--out DIR]
                                   [--device cuda|cpu] [--no-kernel]
                                   [--traffic SPEC]
  python -m repro_torch.core.sweep --extreme 100000 [--sample-sources K]
                                   [--seed S] [--no-packed] [--tile-rows T]
                                   [--adjacency-budget BYTES] [--throughput]
                                   [--shards P] [--device cuda|cpu]
  python -m repro_torch.core.sweep --check    # CI gate: sizers + connectivity
"""
from __future__ import annotations

import functools
import json
import pathlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..kernels import ops
from . import costmodel
from . import topology as topo
from .analysis import distributed as DX
from .analysis import wavefront as WF
from .graph import Graph

__all__ = ["equal_cost_graphs", "batched_apsp", "batched_dist_mult",
           "sweep", "format_table", "check_families",
           "sweep_extreme", "format_extreme_table"]

_INF = np.float32(np.inf)


# -- batched products ---------------------------------------------------------

def _batched_minplus(use_kernel: bool):
    """The stacked (min, +) product of the squaring loop, on its operands'
    device: ``f(a, b, compare=None)``, `kernels.ops.batched_minplus_matmul`
    (the kernel on the card; ``use_kernel=False``: its plain version)."""
    return functools.partial(ops.batched_minplus_matmul, use_kernel=use_kernel)


def _batched_count(use_kernel: bool, device="cuda"):
    """The stacked counting product of the host-looped level sweep, numpy
    in and out: `kernels.ops.batched_count_matmul` on ``device``, or, with
    ``use_kernel=False``, the float64 host product (the oracle)."""
    if not use_kernel:
        return lambda a, b: np.asarray(a, np.float64) @ np.asarray(b,
                                                                   np.float64)
    dev = WF.resolve_device(device)
    return lambda a, b: ops.batched_count_matmul(
        torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    ).cpu().numpy()


# -- equal-cost instantiation -------------------------------------------------

def equal_cost_graphs(
        families: Optional[Sequence[str]] = None,
        budget: Optional[float] = None,
        ref: Tuple[str, int] = ("slimfly", 2000),
        max_routers: int = 1024,
) -> Tuple[List[Graph], float]:
    """Build one graph per family at matched construction cost.

    ``budget`` defaults to the cost of ``ref`` = (family, n_servers) sized
    by :func:`topology.by_servers`. ``max_routers`` additionally caps every
    instance (keeps the sweep inside the dense-analysis regime; the cost
    column then reports what each family actually spends). Families whose
    smallest configuration exceeds the budget are skipped with a notice.
    """
    families = list(families) if families else topo.families()
    if budget is None:
        params = topo.solve(ref[0], lambda s: s.n_servers, ref[1], "closest")
        budget = costmodel.cost_report(topo.spec(ref[0], **params))["cost_total"]
    graphs: List[Graph] = []
    for fam in families:
        try:
            g = topo.by_cost(fam, budget, max_routers=max_routers)
        except ValueError as exc:
            obs.log("sweep.skip", family=fam, reason=str(exc))
            continue
        g.validate()
        graphs.append(g)
    return graphs, float(budget)


# -- batched analysis stages --------------------------------------------------

def _stack_adjacency(graphs: Sequence[Graph]) -> np.ndarray:
    """Stack adjacencies padded to the max router count; padding rows are
    isolated phantom routers (all-zero), inert under every product."""
    p = max(g.n for g in graphs)
    adj = np.zeros((len(graphs), p, p), np.float32)
    for i, g in enumerate(graphs):
        adj[i, :g.n, :g.n] = g.adjacency_dense(np.float32)
    return adj


def _stack_seeds(graphs: Sequence[Graph]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack distance seeds and adjacencies, padded to the max router count.

    Padding rows/cols are +inf (no edges) with a 0 diagonal — isolated
    phantom routers that can never shorten a real path, so one stacked
    squaring loop serves every topology at once.
    """
    adj = _stack_adjacency(graphs)
    nb, p, _ = adj.shape
    dist = np.full((nb, p, p), _INF, np.float32)
    for i, g in enumerate(graphs):
        dist[i, :g.n, :g.n] = g.distance_seed()
    idx = np.arange(p)
    dist[:, idx, idx] = 0.0
    return dist, adj


def batched_apsp(graphs: Sequence[Graph], use_kernel: bool = True,
                 device="cuda") -> np.ndarray:
    """All-pairs hop distances for a whole stack of topologies at once.

    Kernel path: the wavefront engine (one fused frontier step per level
    for the whole stack). Oracle path (``use_kernel=False``): stacked
    min-plus squaring (`_apsp_from_stack`) through the plain product. Both
    run on ``device``; ``"cuda"`` raises without a card.
    """
    if use_kernel:
        dist, _ = WF.wavefront_dist_mult(_stack_adjacency(graphs),
                                         device=device)
        return dist
    dev = WF.resolve_device(device)
    dist, _ = _stack_seeds(graphs)
    return _apsp_from_stack(torch.from_numpy(dist).to(dev),
                            _batched_minplus(use_kernel)).cpu().numpy()


def _apsp_from_stack(dist: torch.Tensor, minplus) -> torch.Tensor:
    """Stacked min-plus squaring of the (B, p, p) seed ``dist`` to
    convergence, on its device. Each squaring is one
    ``minplus(d, d, compare=d)``, whose fused flag is the loop's one host
    read; the loop stops at the first squaring that changes nothing, or
    after ceil(log2 p) squarings."""
    max_squarings = max(1, int(np.ceil(np.log2(max(2, dist.shape[1])))))
    dist = dist.contiguous()
    for _ in range(max_squarings):
        nxt, changed = minplus(dist, dist, compare=dist)
        if not bool(changed):
            return nxt
        dist = nxt
    return dist


def batched_dist_mult(adj: np.ndarray, count=None,
                      max_levels: Optional[int] = None, device="cuda"):
    """Hop distances AND shortest-path multiplicities from one stacked
    counting product per BFS level (Brandes' frontier identity).

    ``x_k = F_k @ A`` extends the level-k multiplicity frontier by one hop;
    any pair first reached at level k+1 has ``sigma = x_k`` there. Stops as
    soon as a sweep makes no new pair reachable (= max diameter over the
    stack, +1 to confirm). Padding rows are isolated phantoms: their
    frontier never grows.

    With ``count=None`` the whole loop runs on ``device``
    (`analysis.wavefront.wavefront_dist_mult`). Passing an explicit
    ``count`` product (numpy in and out, e.g. :func:`_batched_count`) or a
    ``max_levels`` cap (which the device engine does not expose; the
    product is then the kernel on ``device``) runs the host-looped
    reference sweep below. Returns (dist f32, mult f64) numpy stacks.
    """
    if count is None:
        if max_levels is None:
            dist, mult = WF.wavefront_dist_mult(adj, device=device)
            return dist, mult.astype(np.float64)
        count = _batched_count(True, device)  # capped: host loop, kernel
    nb, p, _ = adj.shape
    if max_levels is None:
        max_levels = p
    dist = np.full((nb, p, p), _INF, np.float32)
    idx = np.arange(p)
    dist[:, idx, idx] = 0.0
    mult = np.where(dist == 0, 1.0, 0.0).astype(np.float64)
    frontier = mult.astype(adj.dtype)
    for level in range(1, max_levels + 1):
        x = np.asarray(count(frontier, adj))
        new = (x > 0) & ~np.isfinite(dist)
        if not new.any():
            break
        dist[new] = level
        mult = np.where(new, x, mult)
        frontier = np.where(new, x, 0.0).astype(adj.dtype)
    return dist, mult


# -- the driver ---------------------------------------------------------------

def sweep(families: Optional[Sequence[str]] = None,
          budget: Optional[float] = None,
          ref: Tuple[str, int] = ("slimfly", 2000),
          max_routers: int = 1024,
          use_kernel: bool = True,
          throughput: bool = True,
          graphs: Optional[Sequence[Graph]] = None,
          device="cuda", traffic=None, mesh="auto") -> Dict:
    """Run the equal-cost comparison; returns ``{"rows": [...], ...}``.

    Pass ``graphs`` to analyze a pre-built list. ``device`` is where the
    level loops run: ``"cuda"`` (the default) raises without a card, it
    never moves to the CPU on its own. ``use_kernel=False`` runs the
    kernels' plain versions on that device (and the traffic loads on the
    float64 oracle).

    ``mesh="auto"`` row-shards both level loops over the ranks of the
    process group when it has more than one (`distributed.default_mesh`,
    on ``device``); an explicit `distributed.RowMesh` pins the layout (on
    ``mesh.device``); None forces the single-device engines. Every rank
    returns the same rows, bit-equal in dist and mult to the single-device
    run, loads within f32 round-off.

    ``traffic`` (a `core.traffic.TrafficSpec` or spec string, ``--traffic``
    on the CLI) additionally pushes that scenario's demand batch through
    each family, reusing the sweep's own dist/mult slices on the device —
    adds ``traffic`` / ``traffic_max_load`` / ``traffic_tput_lb`` columns.
    """
    t0 = time.time()
    dev = WF.resolve_device(device)
    traffic_spec = None
    if traffic is not None:
        from .traffic.spec import as_spec

        traffic_spec = as_spec(traffic)
    with obs.span("sweep", cat="sweep", use_kernel=use_kernel,
                  device=str(dev)) as root:
        if graphs is None:
            with obs.span("sweep.build", cat="sweep"):
                graphs, budget = equal_cost_graphs(families, budget, ref,
                                                   max_routers)
        if not graphs:
            raise ValueError("sweep has no topologies to compare")
        root.set(families=len(graphs), routers=max(g.n for g in graphs))

        with obs.span("sweep.stack", cat="sweep"):
            adj = _stack_adjacency(graphs)
        k = adj.shape[-1]
        if mesh == "auto":
            mesh = DX.default_mesh(k, device=dev)
        sharded = mesh is not None and mesh.size > 1
        if sharded:
            dev = mesh.device
        tel = obs.enabled()
        wf_levels = None
        with obs.span("sweep.dist_mult", cat="sweep", stacked=len(graphs),
                      padded=k, sharded=sharded) as sp:
            p = (DX.pad_block_sharded(k, mesh.size, batched=True)[0]
                 if sharded else WF.pad_block(k))
            padded = WF.pad_operand(adj, p, 0.0)
            adj_d = torch.from_numpy(padded).to(dev)
            obs.record_h2d(padded.nbytes, "sweep_stack")
            if sharded:
                out = DX.dist_mult_sharded(adj_d, mesh, telemetry=tel,
                                           use_kernel=use_kernel)
            else:
                out = WF.dist_mult_device(adj_d, telemetry=tel,
                                          use_kernel=use_kernel)
            dist_d, mult_d = out[0], out[1]
            if tel:
                attrs = WF.telemetry_attrs(out[2])
                wf_levels = attrs.get("levels_per_graph")
                sp.set(**attrs)
        with obs.span("sweep.ecmp_loads", cat="sweep"):
            if not throughput:
                loads_d = None
            elif sharded:
                loads_d = DX.ecmp_loads_sharded(dist_d, mult_d, adj_d, mesh,
                                                use_kernel=use_kernel)
            else:
                loads_d = WF.ecmp_loads_device(dist_d, mult_d, adj_d,
                                               use_kernel=use_kernel)
            if sharded:
                # every rank gets the whole stack: one broadcast a block
                dist_d = DX.gather_rows(dist_d, mesh)
                mult_d = DX.gather_rows(mult_d, mesh)
            if tel and dev.type == "cuda":
                # the loop only enqueues its launches: with tracing on, wait
                # for them so this span, not sweep.download, holds their time
                torch.cuda.synchronize(dev)
        with obs.span("sweep.download", cat="sweep"):
            dist = dist_d[:, :k, :k].cpu().numpy()
            mult = mult_d[:, :k, :k].cpu().numpy().astype(np.float64)
            loads = (loads_d[:, :k, :k].cpu().numpy() if throughput
                     else None)
        WF._warn_if_inexact(mult)  # device counts are f32

        with obs.span("sweep.rows", cat="sweep"):
            rows = []
            for i, g in enumerate(graphs):
                n = g.n
                d = dist[i, :n, :n]
                m = mult[i, :n, :n]
                off = np.isfinite(d) & (d > 0)
                spec = g.meta.get("spec")
                cost = costmodel.cost_report(spec) if spec is not None else {}
                row = {
                    "family": g.meta["spec"].family if spec else g.name,
                    "params": spec.describe() if spec else g.name,
                    "routers": n,
                    "servers": g.num_servers,
                    "radix": spec.router_radix if spec else g.radix,
                    # partitioned-graph contract: every stat below covers
                    # the reachable pairs; this column says how many that is
                    "reachable_frac": (float(off.sum() / max(1, n * (n - 1)))
                                       if n > 1 else 1.0),
                    "diameter": int(d[off].max()) if off.any() else 0,
                    "avg_spl": float(d[off].mean()) if off.any() else 0.0,
                    "mult_mean": float(m[off].mean()) if off.any() else 0.0,
                    "mult_min": float(m[off].min()) if off.any() else 0.0,
                    "cost": cost.get("cost_total"),
                    "power_kw": (cost.get("power_total_w", 0.0) / 1e3
                                 if cost else None),
                    "cables_electrical": cost.get("cables_electrical"),
                    "cables_optical": cost.get("cables_optical"),
                }
                if loads is not None:
                    peak = float(loads[i, :n, :n].max())
                    row["tput_lb"] = 1.0 / peak if peak > 0 else 1.0
                if wf_levels is not None:
                    # device telemetry: BFS levels this family's wavefront
                    # actually ran (= its diameter on connected graphs)
                    row["wavefront_levels"] = int(wf_levels[i])
                if traffic_spec is not None:
                    from .traffic.scenarios import evaluate_traffic_batch

                    tv = evaluate_traffic_batch(
                        g, traffic_spec, dist=dist_d[i, :n, :n],
                        mult=mult_d[i, :n, :n], use_kernel=use_kernel)
                    row["traffic"] = traffic_spec.describe()
                    row["traffic_max_load"] = float(
                        tv["max_link_load"].mean())
                    row["traffic_tput_lb"] = float(tv["tput_lb"].mean())
                rows.append(row)
    return {
        "rows": rows,
        "budget": budget,
        "batched": True,
        "use_kernel": use_kernel,
        "device": str(dev),
        "traffic": traffic_spec.describe() if traffic_spec else None,
        "elapsed_s": round(time.time() - t0, 2),
    }


_COLS = [
    ("family", "<12s", "family"),
    ("routers", ">8d", "routers"),
    ("servers", ">9d", "servers"),
    ("radix", ">6d", "radix"),
    ("diam", ">5d", "diameter"),
    ("avg-spl", ">8.2f", "avg_spl"),
    ("mult", ">10.2f", "mult_mean"),
    ("tput-lb", ">8.4f", "tput_lb"),
    ("cost", ">11.3e", "cost"),
    ("power-kW", ">9.1f", "power_kw"),
]


#: extra columns when the sweep ran with a --traffic scenario
_TRAFFIC_COLS = [
    ("tr-load", ">9.3f", "traffic_max_load"),
    ("tr-tput", ">9.4f", "traffic_tput_lb"),
]


def format_table(result: Dict) -> str:
    """Paper-style fixed-width comparison table."""
    budget = result.get("budget")
    budget_s = f"budget={budget:.3e} " if budget else ""
    traffic = result.get("traffic")
    traffic_s = f" traffic={traffic}" if traffic else ""
    cols = _COLS + (_TRAFFIC_COLS if traffic else [])
    lines = [f"equal-cost sweep: {budget_s}"
             f"({len(result['rows'])} families, "
             f"{result['elapsed_s']}s batched analysis{traffic_s})"]
    hdr = "".join(f"{name:>{_w(fmt)}s}" for name, fmt, _ in cols)
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for row in sorted(result["rows"], key=lambda r: r["family"]):
        cells = []
        for _, fmt, key in cols:
            v = row.get(key)
            cells.append(" " * _w(fmt) if v is None else f"{v:{fmt}}")
        lines.append("".join(cells))
    return "\n".join(lines)


def _w(fmt: str) -> int:
    digits = ""
    for ch in fmt[1:]:
        if ch.isdigit():
            digits += ch
        else:
            break
    return int(digits) if digits else 10


def sweep_extreme(families: Optional[Sequence[str]] = None,
                  target_routers: int = 100_000, k_sources: int = 32,
                  seed: int = 0, packed: bool = True, mesh=None,
                  tile_rows: Optional[int] = None,
                  adjacency_budget: Optional[int] = None,
                  block_cap: Optional[int] = 16384,
                  throughput: bool = False, device="cuda") -> Dict:
    """Extreme-scale sweep: every family sized to ``target_routers``
    ROUTERS (not servers — at 100k the router count is the analysis cost),
    analyzed through the sampled-sources estimator.

    Each family runs `analysis.estimator.sampled_sources_summary`:
    ``k_sources`` exact source rows through the tiled engine
    (``packed=True`` by default — int16/int32 cells, uint8 adjacency, 4x
    less resident or streamed than f32) and bootstrap 95% CIs on the
    aggregates. A family whose parameter ladder cannot reach the target
    records an ``error`` row instead of aborting the sweep — the table
    shows the gap. Returns ``{"rows": [...], ...}`` for
    :func:`format_extreme_table`.

    ``block_cap`` reproduces the JAX package's per-family kernel block
    (the widest 128-multiple divisor of the padded extent under the cap),
    which the span records; the CUDA kernels take any shape and ignore it.
    ``device`` is where the levels run (``"cuda"`` by default, which raises
    without a card). ``mesh`` (a `analysis.distributed.RowMesh` of more
    than one rank) runs every family's sampled rows through the composed
    engine on ``mesh.device``: adjacency rows sharded over the ranks, one
    all-reduce a level; every rank returns the same rows.
    """
    from .analysis.distributed import _pad128, widest_divisor_block
    from .analysis.estimator import sampled_sources_summary

    families = list(families) if families else topo.families()
    t0 = time.time()
    rows: List[Dict] = []
    with obs.span("sweep.extreme", cat="sweep", target=target_routers,
                  k=k_sources, packed=packed) as root:
        for fam in families:
            try:
                params = topo.solve(fam, lambda s: s.n_routers,
                                    target_routers, "closest")
                with obs.span("sweep.extreme.build", cat="sweep",
                              family=fam):
                    g = topo.make(fam, **params)
            except (ValueError, KeyError) as exc:
                obs.log("sweep.extreme.skip", family=fam, error=str(exc))
                rows.append({"family": fam, "error": str(exc)})
                continue
            block = (widest_divisor_block(_pad128(g.n), block_cap)
                     if block_cap else None)
            with obs.span("sweep.extreme.family", cat="sweep", family=fam,
                          routers=g.n, block=block):
                s = sampled_sources_summary(
                    g, k=k_sources, seed=seed, mesh=mesh,
                    tile_rows=tile_rows, packed=packed,
                    adjacency_budget=adjacency_budget, block=block,
                    throughput=throughput, device=device)
            spec = g.meta.get("spec")
            est = s["estimates"]
            row = {
                "family": g.name,
                "routers": g.n,
                "servers": spec.n_servers if spec is not None else None,
                "sampled_sources": s["sampled_sources"],
                "diameter_lb": s["diameter_lb"],
                "avg_spl": est["avg_spl"]["value"],
                "avg_spl_ci95": est["avg_spl"]["ci95"],
                "mult_mean": est["mult_mean"]["value"],
                "mult_mean_ci95": est["mult_mean"]["ci95"],
                "frac_multipath": est["frac_multipath"]["value"],
                "reached_frac": est["reached_frac"]["value"],
                "saturated": s["saturated"],
                "elapsed_s": s["elapsed_s"],
                "peak_rss_mb": s["peak_rss_mb"],
            }
            if "ecmp_saturation_throughput_lb" in est:
                row["ecmp_saturation_throughput_lb"] = (
                    est["ecmp_saturation_throughput_lb"]["value"])
                row["ecmp_saturation_throughput_lb_ci95"] = (
                    est["ecmp_saturation_throughput_lb"]["ci95"])
            rows.append(row)
        root.set(families=len(rows),
                 errors=sum("error" in r for r in rows))
    return {
        "target_routers": target_routers,
        "k_sources": k_sources,
        "seed": seed,
        "packed": packed,
        "rows": rows,
        "elapsed_s": round(time.time() - t0, 1),
        "peak_rss_mb": round(obs.peak_rss_mb(), 1),
    }


_XCOLS = (
    ("family", "<26s", "family"),
    ("routers", ">9d", "routers"),
    ("servers", ">10d", "servers"),
    ("k", ">5d", "sampled_sources"),
    ("diam>=", ">7d", "diameter_lb"),
    ("avg_spl", ">9.3f", "avg_spl"),
    ("+-ci", ">7.3f", "_spl_hw"),
    ("mult", ">13.2f", "mult_mean"),
    ("+-ci", ">10.2f", "_mult_hw"),
    ("multipath", ">10.3f", "frac_multipath"),
    ("sat", ">4s", "_sat"),
    ("s", ">8.1f", "elapsed_s"),
)


def format_extreme_table(result: Dict) -> str:
    """Fixed-width table for the sampled-sources extreme sweep (CIs shown
    as +- half-widths next to their estimates)."""
    lines = [f"extreme-scale sampled sweep: target={result['target_routers']}"
             f" routers, k={result['k_sources']} sources, "
             f"packed={result['packed']} "
             f"({result['elapsed_s']}s, peak rss "
             f"{result.get('peak_rss_mb', 0.0)} MB)"]
    hdr = "".join(f"{name:>{_w(fmt)}s}" if ">" in fmt else
                  f"{name:<{_w(fmt)}s}" for name, fmt, _ in _XCOLS)
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for row in sorted(result["rows"], key=lambda r: r["family"]):
        if "error" in row:
            lines.append(f"{row['family']:<26s} SKIP: {row['error']}")
            continue
        r = dict(row)
        r["_spl_hw"] = (row["avg_spl_ci95"][1] - row["avg_spl_ci95"][0]) / 2
        r["_mult_hw"] = (row["mult_mean_ci95"][1]
                         - row["mult_mean_ci95"][0]) / 2
        r["_sat"] = "SAT" if row.get("saturated") else ""
        cells = []
        for _, fmt, key in _XCOLS:
            v = r.get(key)
            cells.append(" " * _w(fmt) if v is None else f"{v:{fmt}}")
        lines.append("".join(cells))
    return "\n".join(lines)


def check_families(n_servers: int = 300) -> List[str]:
    """CI gate: every registered family must have a working sizer (spec +
    ladder) and produce a connected graph. Returns failure messages."""
    failures = []
    for fam in topo.families():
        try:
            g = topo.by_servers(fam, n_servers)
            g.validate()
            if "spec" not in g.meta:
                failures.append(f"{fam}: generator attaches no TopologySpec")
        except Exception as exc:  # noqa: BLE001 - gate reports everything
            failures.append(f"{fam}: {type(exc).__name__}: {exc}")
    return failures


def _extreme_on_mesh(mesh, families, kw, trace=None) -> Dict:
    """:func:`sweep_extreme` on one rank of ``--shards`` (``mesh=None``:
    alone); with ``trace``, the rank traces and rank 0 writes the file."""
    if trace:
        obs.enable()
    result = sweep_extreme(families, mesh=mesh, **kw)
    if trace and (mesh is None or mesh.rank == 0):
        obs.export(trace)
        obs.log("sweep.trace", path=trace)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", default=None,
                    help="comma-separated (default: all registered)")
    ap.add_argument("--budget", type=float, default=None)
    ap.add_argument("--ref-family", default="slimfly")
    ap.add_argument("--ref-servers", type=int, default=2000)
    ap.add_argument("--max-routers", type=int, default=512)
    ap.add_argument("--traffic", default=None,
                    help="TrafficSpec flag grammar (e.g. "
                         "'hotspot:zipf_a=1.4,samples=8'): add per-family "
                         "scenario load/throughput columns")
    ap.add_argument("--no-kernel", action="store_true",
                    help="plain torch versions instead of the CUDA kernels")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the level loops (default cuda; "
                         "'cpu' runs the plain versions on the host)")
    ap.add_argument("--out", default=None,
                    help="directory for comparison.{txt,json}")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable tracing and write a Chrome trace-event "
                         "file (load in https://ui.perfetto.dev or feed to "
                         "python -m repro_torch.obs.report)")
    ap.add_argument("--check", action="store_true",
                    help="CI gate: verify sizers + connectivity, no sweep")
    ap.add_argument("--extreme", type=int, default=None, metavar="ROUTERS",
                    help="extreme-scale mode: size every family to this "
                         "many ROUTERS and run the sampled-sources "
                         "estimator instead of the equal-cost sweep")
    ap.add_argument("--sample-sources", type=int, default=32, metavar="K",
                    help="extreme mode: exact source rows to sample")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-packed", action="store_true",
                    help="extreme mode: f32 cells instead of int16/int32")
    ap.add_argument("--shards", type=int, default=None,
                    help="extreme mode: row-shard over this many ranks "
                         "(the composed engine; started here, gloo when "
                         "they share a card, or torchrun's group)")
    ap.add_argument("--tile-rows", type=int, default=None)
    ap.add_argument("--adjacency-budget", type=int, default=None,
                    help="device bytes before adjacency panels stream")
    ap.add_argument("--block-cap", type=int, default=16384,
                    help="extreme mode: the JAX package's per-family block "
                         "cap, recorded in the trace (0: none)")
    ap.add_argument("--throughput", action="store_true",
                    help="extreme mode: add the sampled ECMP saturation-"
                         "throughput estimate (host Brandes, O(E)/source)")
    args = ap.parse_args(argv)

    if args.trace:
        obs.enable()

    if args.extreme:
        fams = args.families.split(",") if args.families else None
        kw = dict(target_routers=args.extreme,
                  k_sources=args.sample_sources, seed=args.seed,
                  packed=not args.no_packed, tile_rows=args.tile_rows,
                  adjacency_budget=args.adjacency_budget,
                  block_cap=args.block_cap or None,
                  throughput=args.throughput, device=args.device)
        result = DX.launch_mesh(_extreme_on_mesh, args.shards or 1, fams, kw,
                                args.trace, device=args.device)
        if DX._world_size() > 1 and torch.distributed.get_rank() != 0:
            return 0  # under torchrun every rank has the table; rank 0 prints
        table = format_extreme_table(result)
        print(table)
        if args.out:
            out = pathlib.Path(args.out)
            out.mkdir(parents=True, exist_ok=True)
            (out / "extreme.txt").write_text(table + "\n")
            (out / "extreme.json").write_text(
                json.dumps(result, indent=1, default=str))
            obs.log("sweep.wrote", txt=str(out / "extreme.txt"),
                    json=str(out / "extreme.json"))
        return 0

    if args.check:
        failures = check_families()
        for msg in failures:
            print(f"[sweep --check] FAIL {msg}")
        if not failures:
            print(f"[sweep --check] {len(topo.families())} families OK "
                  f"(sizer + spec + connected)")
        return 1 if failures else 0

    fams = args.families.split(",") if args.families else None
    result = sweep(fams, budget=args.budget,
                   ref=(args.ref_family, args.ref_servers),
                   max_routers=args.max_routers,
                   use_kernel=not args.no_kernel, device=args.device,
                   traffic=args.traffic)
    table = format_table(result)
    print(table)
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "comparison.txt").write_text(table + "\n")
        (out / "comparison.json").write_text(
            json.dumps(result, indent=1, default=str))
        obs.log("sweep.wrote", txt=str(out / "comparison.txt"),
                json=str(out / "comparison.json"))
    if args.trace:
        obs.export(args.trace)
        obs.log("sweep.trace", path=args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

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
3. `core.costmodel` over each spec -> construction cost and power columns.

The padded stack is uploaded once, both level loops run on the device
through the hand-written CUDA kernels (`kernels.semiring`), and only the
final dist/mult/loads matrices come back to the host. ``use_kernel=False``
runs the same loops with the kernels' plain versions on the same device.

CLI::

  python -m repro_torch.core.sweep [--families a,b,... ] [--ref-servers N]
                                   [--budget C] [--max-routers N] [--out DIR]
                                   [--device cuda|cpu] [--no-kernel]
  python -m repro_torch.core.sweep --check    # CI gate: sizers + connectivity
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from . import costmodel
from . import topology as topo
from .analysis import wavefront as WF
from .graph import Graph

__all__ = ["equal_cost_graphs", "sweep", "format_table", "check_families"]


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


def _stack_adjacency(graphs: Sequence[Graph]) -> np.ndarray:
    """Stack adjacencies padded to the max router count; padding rows are
    isolated phantom routers (all-zero), inert under every product."""
    p = max(g.n for g in graphs)
    adj = np.zeros((len(graphs), p, p), np.float32)
    for i, g in enumerate(graphs):
        adj[i, :g.n, :g.n] = g.adjacency_dense(np.float32)
    return adj


# -- the driver ---------------------------------------------------------------

def sweep(families: Optional[Sequence[str]] = None,
          budget: Optional[float] = None,
          ref: Tuple[str, int] = ("slimfly", 2000),
          max_routers: int = 1024,
          use_kernel: bool = True,
          throughput: bool = True,
          graphs: Optional[Sequence[Graph]] = None,
          device="cuda") -> Dict:
    """Run the equal-cost comparison; returns ``{"rows": [...], ...}``.

    Pass ``graphs`` to analyze a pre-built list. ``device`` is where the
    level loops run: ``"cuda"`` (the default) raises without a card, it
    never moves to the CPU on its own. ``use_kernel=False`` runs the
    kernels' plain versions on that device.
    """
    t0 = time.time()
    dev = WF.resolve_device(device)
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
        tel = obs.enabled()
        wf_levels = None
        with obs.span("sweep.dist_mult", cat="sweep", stacked=len(graphs),
                      padded=k) as sp:
            p = WF.pad_block(k)
            padded = WF.pad_operand(adj, p, 0.0)
            adj_d = torch.from_numpy(padded).to(dev)
            obs.record_h2d(padded.nbytes, "sweep_stack")
            out = WF.dist_mult_device(adj_d, telemetry=tel,
                                      use_kernel=use_kernel)
            dist_d, mult_d = out[0], out[1]
            if tel:
                attrs = WF.telemetry_attrs(out[2])
                wf_levels = attrs.get("levels_per_graph")
                sp.set(**attrs)
        with obs.span("sweep.ecmp_loads", cat="sweep"):
            loads_d = (WF.ecmp_loads_device(dist_d, mult_d, adj_d,
                                            use_kernel=use_kernel)
                       if throughput else None)
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
                rows.append(row)
    return {
        "rows": rows,
        "budget": budget,
        "batched": True,
        "use_kernel": use_kernel,
        "device": str(dev),
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


def format_table(result: Dict) -> str:
    """Paper-style fixed-width comparison table."""
    budget = result.get("budget")
    budget_s = f"budget={budget:.3e} " if budget else ""
    lines = [f"equal-cost sweep: {budget_s}"
             f"({len(result['rows'])} families, "
             f"{result['elapsed_s']}s batched analysis)"]
    hdr = "".join(f"{name:>{_w(fmt)}s}" for name, fmt, _ in _COLS)
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for row in sorted(result["rows"], key=lambda r: r["family"]):
        cells = []
        for _, fmt, key in _COLS:
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", default=None,
                    help="comma-separated (default: all registered)")
    ap.add_argument("--budget", type=float, default=None)
    ap.add_argument("--ref-family", default="slimfly")
    ap.add_argument("--ref-servers", type=int, default=2000)
    ap.add_argument("--max-routers", type=int, default=512)
    ap.add_argument("--no-kernel", action="store_true",
                    help="plain torch versions instead of the CUDA kernels")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the level loops (default cuda; "
                         "'cpu' runs the plain versions on the host)")
    ap.add_argument("--out", default=None,
                    help="directory for comparison.{txt,json}")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable tracing and write a Chrome trace-event "
                         "file (load in https://ui.perfetto.dev)")
    ap.add_argument("--check", action="store_true",
                    help="CI gate: verify sizers + connectivity, no sweep")
    args = ap.parse_args(argv)

    if args.trace:
        obs.enable()

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
                   use_kernel=not args.no_kernel, device=args.device)
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

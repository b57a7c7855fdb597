"""The traffic x failure grid on torch: scenario rows x failure-severity
columns.

:func:`traffic_failure_grid` crosses a set of traffic scenarios
(`traffic.spec` flag grammar) with the severity-nested failure plans of
`resilience.faults` over the equal-cost family set
(`core.sweep.equal_cost_graphs`): each (scenario, rate) cell evaluates as
ONE batched pass (`traffic.scenarios.evaluate_traffic_failure_batch`,
failure mask ``i`` paired with demand sample ``i``), the batched
wavefront dist/mult of each severity computed once and shared by every
scenario row. Each severity's mask batch (host numpy, seeded, bit-equal
to the JAX package's) goes up once as uint8 and its dist/mult stay on the
card for every row. The rate-0 column is evaluated by the *same
single-matrix call* as the unfailed baseline, so it is bit-equal to it by construction
— :func:`check_grid` asserts that, plus the schema and the monotonicity
every cell owes the severity nesting (dropped demand non-decreasing,
throughput non-increasing within tolerance).

CLI::

  python -m repro_torch.core.traffic
      [--traffic "uniform;tornado;hotspot:zipf_a=1.4"]
      [--families a,b,...] [--rates 0,0.02,...] [--samples N]
      [--kind link|router|cable] [--max-routers N] [--out DIR] [--check]
      [--trace OUT.json] [--device cuda|cpu] [--no-kernel]
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ... import obs
from ..graph import Graph
from .spec import TrafficSpec, as_spec
from .scenarios import (TRAFFIC_METRICS, evaluate_traffic_batch,
                        evaluate_traffic_failure_batch)

__all__ = ["traffic_failure_grid", "format_grid_table", "check_grid",
           "main"]

#: default scenario rows for the CLI / artifact
DEFAULT_SCENARIOS = ("uniform", "permutation", "tornado",
                     "hotspot:zipf_a=1.4")

#: metrics every grid cell must carry (the --check schema)
GRID_METRICS = TRAFFIC_METRICS + ("reachable_frac",)


def _point(metrics: Dict[str, np.ndarray], b: int, seed: int) -> Dict:
    from ..analysis.estimator import bootstrap_ci

    out = {}
    for i, (name, vals) in enumerate(sorted(metrics.items())):
        point, lo, hi = bootstrap_ci(vals, b=b, seed=seed + i)
        out[name] = {"value": point, "ci95": [lo, hi]}
    return out


def traffic_failure_grid(
        families: Optional[Sequence[str]] = None,
        budget: Optional[float] = None,
        ref: Tuple[str, int] = ("slimfly", 2000),
        max_routers: int = 256,
        scenarios: Sequence[Union[str, TrafficSpec]] = DEFAULT_SCENARIOS,
        rates: Sequence[float] = (0.0, 0.02, 0.05),
        samples: int = 200, kind: str = "link", bundle_size: int = 8,
        seed: int = 0, use_kernel: bool = True,
        mask_chunk: Optional[int] = None, bootstrap: int = 1000,
        graphs: Optional[Sequence[Graph]] = None,
        device="cuda") -> Dict:
    """Evaluate the scenario x severity grid across the equal-cost set.

    For each family (matched cost like `core.sweep.sweep`; pass ``graphs``
    to reuse pre-built instances) draws ONE severity-nested failure plan,
    then walks severities in the outer loop so each masked batch's
    wavefront dist/mult is computed once and shared by all scenario rows
    of that column. Every scenario's demand batch is drawn once per
    family (sample ``i`` rides failure mask ``i`` in every column, so
    columns differ only by the failure severity). Families without a link
    inventory are skipped for ``kind="cable"``. Everything runs on
    ``device`` (``"cuda"`` by default, which raises without a card).
    """
    from ..analysis.wavefront import resolve_device
    from ..resilience.degradation import _upload_masks
    from ..resilience.faults import failure_batch, failure_plan, rate_to_k
    from ..sweep import equal_cost_graphs
    from .scenarios import _dist_mult

    dev = resolve_device(device)
    t0 = time.time()
    rates = sorted(float(r) for r in rates)
    specs = [as_spec(sc) for sc in scenarios]
    if not specs:
        raise ValueError("traffic grid needs at least one scenario")
    with obs.span("traffic.grid", cat="traffic", scenarios=len(specs),
                  rates=len(rates), samples=samples, kind=kind) as root:
        if graphs is None:
            graphs, budget = equal_cost_graphs(families, budget, ref,
                                               max_routers)
        if not graphs:
            raise ValueError("traffic grid has no topologies")
        root.set(families=len(graphs))
        fam_rows = []
        for g in graphs:
            fam = g.meta["spec"].family if g.meta.get("spec") else g.name
            try:
                plan = failure_plan(g, kind=kind, samples=samples,
                                    seed=seed, bundle_size=bundle_size)
            except KeyError:
                obs.log("traffic.skip", family=fam,
                        reason="no link inventory for cable-class faults")
                continue
            with obs.span("traffic.family", cat="traffic", family=fam,
                          routers=g.n, units=plan.n_units):
                dist0, mult0 = _dist_mult(g.adjacency_dense(), use_kernel,
                                          device=dev)
                demands = {sp.describe(): sp.batch(g, samples=samples)
                           for sp in specs}
                # the unfailed baseline: ONE matrix (sample 0) through the
                # unfailed engine — the rate-0 cell reuses this exact call
                # result, so bit-equality holds by construction
                baseline = {}
                cells: Dict[str, List[Dict]] = {d: [] for d in demands}
                reach0 = int((torch.isfinite(dist0) & (dist0 > 0)).sum())
                for desc, batch in demands.items():
                    vals = evaluate_traffic_batch(
                        g, batch[:1], dist=dist0, mult=mult0,
                        use_kernel=use_kernel, mask_chunk=mask_chunk,
                        device=dev)
                    vals["reachable_frac"] = np.array(
                        [reach0 / max(g.n * (g.n - 1), 1)])
                    baseline[desc] = {k: float(v[0])
                                      for k, v in sorted(vals.items())}
                    if rates and rates[0] == 0.0:
                        cells[desc].append({
                            "rate": 0.0, "k": 0, "samples": 1,
                            "metrics": _point(vals, bootstrap, seed),
                        })
                for rate in rates:
                    if rate == 0.0:
                        continue
                    k = rate_to_k(plan, rate)
                    with obs.span("resilience.masks", cat="resilience", k=k):
                        batch = failure_batch(plan, k)
                    adjk = _upload_masks(batch.adjacency, dev)
                    del batch
                    distk, multk = _dist_mult(adjk, use_kernel)
                    for desc, dem in demands.items():
                        vals = evaluate_traffic_failure_batch(
                            g, dem, adjk, dist=distk, mult=multk,
                            use_kernel=use_kernel, mask_chunk=mask_chunk)
                        cells[desc].append({
                            "rate": rate, "k": k, "samples": samples,
                            "metrics": _point(vals, bootstrap, seed),
                        })
                    del adjk, distk, multk
                fam_rows.append({
                    "family": fam,
                    "routers": g.n,
                    "edges": int(len(g.edges)),
                    "units": plan.n_units,
                    "baseline": baseline,
                    "scenarios": [
                        {"scenario": desc, "cells": cells[desc]}
                        for desc in demands
                    ],
                })
    return {
        "scenarios": [sp.describe() for sp in specs],
        "kind": kind,
        "rates": list(rates),
        "samples": samples,
        "bundle_size": bundle_size if kind == "cable" else None,
        "seed": seed,
        "budget": budget,
        "use_kernel": use_kernel,
        "bootstrap": bootstrap,
        "families": fam_rows,
        "elapsed_s": round(time.time() - t0, 2),
    }


_GCOLS = (
    ("family", "<14s"), ("scenario", "<22s"), ("rate", ">6.2f"),
    ("k", ">6d"), ("max-load", ">10.4f"), ("tput-lb", ">9.4f"),
    ("+-ci", ">8.4f"), ("p99-load", ">10.4f"), ("dropped", ">9.4f"),
    ("hops", ">6.2f"),
)


def format_grid_table(result: Dict) -> str:
    """Fixed-width grid table: one row per (family, scenario, rate)."""
    from ..sweep import _w

    lines = [f"traffic x failure grid: kind={result['kind']} "
             f"samples={result['samples']} seed={result['seed']} "
             f"({len(result['families'])} families x "
             f"{len(result['scenarios'])} scenarios, "
             f"{result['elapsed_s']}s batched passes)"]
    hdr = "".join(f"{name:>{_w(fmt)}s}" if ">" in fmt else
                  f"{name:<{_w(fmt)}s}" for name, fmt in _GCOLS)
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for fam in sorted(result["families"], key=lambda f: f["family"]):
        for row in fam["scenarios"]:
            for pt in row["cells"]:
                m = pt["metrics"]
                tci = m["tput_lb"]["ci95"]
                cells = {
                    "family": fam["family"], "scenario": row["scenario"],
                    "rate": pt["rate"], "k": pt["k"],
                    "max-load": m["max_link_load"]["value"],
                    "tput-lb": m["tput_lb"]["value"],
                    "+-ci": (tci[1] - tci[0]) / 2,
                    "p99-load": m["p99_link_load"]["value"],
                    "dropped": m["dropped_demand_frac"]["value"],
                    "hops": m["avg_hops"]["value"],
                }
                lines.append("".join(f"{cells[name]:{fmt}}"
                                     for name, fmt in _GCOLS))
    return "\n".join(lines)


def check_grid(result: Dict, tput_tolerance: float = 0.15) -> List[str]:
    """CI gate over a grid artifact. Returns failure messages.

    Checks: schema (every family covers every scenario x rate cell with
    every GRID_METRICS entry finite and inside its ci95), bounds
    (loads/fractions non-negative, fractions within [0, 1]), the rate-0
    cell bit-equal to the unfailed single-matrix baseline, and per
    scenario row: mean ``dropped_demand_frac`` non-decreasing (a theorem
    under the severity-nested plans: per sample the failed set only
    grows) and mean ``tput_lb`` non-increasing within ``tput_tolerance``
    relative slack. Throughput monotonicity is NOT a theorem for fixed
    adversarial demand — removing a link both drops its disconnected
    pairs' demand and can break the pattern's symmetry so ECMP spreads
    the rest (Braess-style) — so the tolerance is loose and the check
    only guards against gross inversions.
    """
    fails: List[str] = []
    for key in ("scenarios", "kind", "rates", "samples", "seed",
                "families"):
        if key not in result:
            fails.append(f"schema: missing top-level key {key!r}")
    if fails:
        return fails
    rates = list(result["rates"])
    if rates != sorted(rates):
        fails.append("schema: rates not ascending")
    scen = list(result["scenarios"])
    for fam in result["families"]:
        name = fam.get("family", "?")
        rows = {r["scenario"]: r["cells"] for r in fam.get("scenarios", [])}
        if sorted(rows) != sorted(scen):
            fails.append(f"{name}: scenarios {sorted(rows)} != {sorted(scen)}")
            continue
        for desc, cells in rows.items():
            tag = f"{name}/{desc}"
            if [c.get("rate") for c in cells] != rates:
                fails.append(f"{tag}: cells do not cover rates {rates}")
                continue
            for c in cells:
                missing = set(GRID_METRICS) - set(c["metrics"])
                if missing:
                    fails.append(f"{tag} rate={c['rate']}: missing metrics "
                                 f"{sorted(missing)}")
                    continue
                for mname, m in c["metrics"].items():
                    v, ci = m.get("value"), m.get("ci95", [None, None])
                    if v is None or not np.isfinite(v):
                        fails.append(f"{tag} rate={c['rate']}: {mname} "
                                     f"value {v!r} not finite")
                    elif not (ci[0] <= v <= ci[1] or ci[0] == ci[1]):
                        fails.append(f"{tag} rate={c['rate']}: {mname} "
                                     f"value {v} outside ci95 {ci}")
                    elif v < 0:
                        fails.append(f"{tag} rate={c['rate']}: negative "
                                     f"{mname}")
                for frac in ("dropped_demand_frac", "links_used_frac",
                             "reachable_frac"):
                    v = c["metrics"][frac]["value"]
                    if not 0.0 <= v <= 1.0:
                        fails.append(f"{tag} rate={c['rate']}: {frac} {v} "
                                     f"outside [0, 1]")
            if rates and rates[0] == 0.0:
                for mname, bval in fam.get("baseline", {}).get(desc,
                                                               {}).items():
                    got = cells[0]["metrics"][mname]["value"]
                    if got != bval:
                        fails.append(f"{tag}: rate-0 {mname} {got} != "
                                     f"unfailed baseline {bval}")
            drop = [c["metrics"]["dropped_demand_frac"]["value"]
                    for c in cells]
            if any(b < a - 1e-12 for a, b in zip(drop, drop[1:])):
                fails.append(f"{tag}: dropped_demand_frac not "
                             f"non-decreasing {drop}")
            tput = [c["metrics"]["tput_lb"]["value"] for c in cells]
            if any(b > a * (1 + tput_tolerance) + 1e-12
                   for a, b in zip(tput, tput[1:])):
                fails.append(f"{tag}: tput_lb rises beyond tolerance {tput}")
    return fails


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traffic", default=";".join(DEFAULT_SCENARIOS),
                    help="semicolon-separated TrafficSpec flag grammar, "
                         "e.g. 'uniform;hotspot:zipf_a=1.4'")
    ap.add_argument("--families", default=None,
                    help="comma-separated (default: all registered)")
    ap.add_argument("--budget", type=float, default=None)
    ap.add_argument("--ref-family", default="slimfly")
    ap.add_argument("--ref-servers", type=int, default=2000)
    ap.add_argument("--max-routers", type=int, default=256)
    ap.add_argument("--rates", default="0,0.02,0.05",
                    help="comma-separated failure rates (unit fractions)")
    ap.add_argument("--samples", type=int, default=200,
                    help="failure masks / demand samples per cell")
    ap.add_argument("--kind", choices=("link", "router", "cable"),
                    default="link")
    ap.add_argument("--bundle-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-kernel", action="store_true",
                    help="the float64 oracle instead of the CUDA kernels")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the batched passes (default "
                         "cuda; 'cpu' runs the plain versions on the host)")
    ap.add_argument("--mask-chunk", type=int, default=None)
    ap.add_argument("--bootstrap", type=int, default=1000)
    ap.add_argument("--out", default=None,
                    help="directory for grid.{txt,json}")
    ap.add_argument("--check", action="store_true",
                    help="CI gate: schema + baseline bit-equality + "
                         "monotonicity, exit 1 on failure")
    ap.add_argument("--trace", default=None, metavar="OUT.json")
    args = ap.parse_args(argv)

    if args.trace:
        obs.enable()
    fams = args.families.split(",") if args.families else None
    rates = [float(r) for r in args.rates.split(",") if r != ""]
    scen = [s for s in args.traffic.split(";") if s.strip()]
    result = traffic_failure_grid(
        fams, budget=args.budget,
        ref=(args.ref_family, args.ref_servers),
        max_routers=args.max_routers, scenarios=scen, rates=rates,
        samples=args.samples, kind=args.kind,
        bundle_size=args.bundle_size, seed=args.seed,
        use_kernel=not args.no_kernel, mask_chunk=args.mask_chunk,
        bootstrap=args.bootstrap, device=args.device)
    table = format_grid_table(result)
    print(table)
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "grid.txt").write_text(table + "\n")
        (out / "grid.json").write_text(
            json.dumps(result, indent=1, default=str))
        obs.log("traffic.wrote", txt=str(out / "grid.txt"),
                json=str(out / "grid.json"))
    if args.trace:
        obs.export(args.trace)
        obs.log("traffic.trace", path=args.trace)
    if args.check:
        failures = check_grid(result)
        for msg in failures:
            print(f"[traffic --check] FAIL {msg}")
        if not failures:
            print(f"[traffic --check] {len(result['families'])} families x "
                  f"{len(result['scenarios'])} scenarios OK "
                  f"(schema + baseline + monotonicity)")
        return 1 if failures else 0
    return 0

"""EvalNet end-to-end on the PyTorch port (the twin of
``topology_analysis.py``): generate -> analyze -> route traffic -> pick
mesh map. Every option is the original's, plus ``--device cuda|cpu``
(default ``cuda``: the card, which it needs; ``cpu`` runs the kernels'
plain versions on the host).

Default walkthrough: compares the assigned low-diameter families at a
matched ~10k-server cost point (the Fig-1-style comparison) — including the
paper's path-diversity columns (exact shortest-path multiplicity,
non-minimal counts at +1/+2 slack) and the routing subsystem's view: exact
expected max link load under three routing models (ECMP over all shortest
paths, Valiant, slack-1 non-minimal), per-pair saturation throughput for
two families, and the collective-planner view of the production TPU fabric.

  PYTHONPATH=src python examples/topology_analysis_torch.py

``--sweep`` instead runs the spec-driven *equal-cost* comparison: every
registered family (PolarFly, OFT, Megafly, HammingMesh included) sized to
one construction-cost budget via `topology.by_cost`, batched through the
stacked semiring kernels by `core.sweep`, printed as the paper-style table
(diameter, avg shortest-path length, multiplicity, ECMP saturation-
throughput lower bound, cost, power) — then a timing section comparing the
batched sweep against looping ``analyze()`` per topology at ~1024 routers.

  PYTHONPATH=src python examples/topology_analysis_torch.py --sweep

``--trace out.json`` (either mode) records the run through `repro_torch.obs` and
writes a Chrome trace-event file — load it in https://ui.perfetto.dev or
summarize with ``python -m repro_torch.obs.report out.json``.
"""
import sys

FAMILIES = ["slimfly", "jellyfish", "xpander", "hyperx", "dragonfly", "fattree"]


def main_sweep(argv):
    import argparse
    import time

    from repro_torch.core import sweep as S, topology as T
    from repro_torch.core.analysis import analyze

    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ref-servers", type=int, default=2000,
                    help="budget = cost of slimfly at this server count")
    ap.add_argument("--max-routers", type=int, default=512)
    ap.add_argument("--no-kernel", action="store_true")
    ap.add_argument("--skip-bench", action="store_true",
                    help="table only; skip the 1024-router timing section")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome trace-event file of the run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    use_kernel = not args.no_kernel
    if args.trace:
        from repro_torch import obs

        obs.enable()

    result = S.sweep(ref=("slimfly", args.ref_servers),
                     max_routers=args.max_routers, use_kernel=use_kernel,
                     device=dev)
    print(S.format_table(result))

    if args.skip_bench:
        if args.trace:
            _export_trace(args.trace)
        return
    # -- batched sweep vs looping analyze() at ~1024 routers --------------
    bench = [T.make("polarfly", q=31),           # 993 routers, diameter 2
             T.make("jellyfish", n=1024, r=16, concentration=8)]
    print(f"\nBatched sweep vs per-topology analyze() loop at ~1k routers "
          f"({', '.join(g.name for g in bench)}):")
    t0 = time.time()
    swept = S.sweep(graphs=bench, use_kernel=use_kernel, budget=0.0,
                    device=dev)
    t_batch = time.time() - t0
    t0 = time.time()
    for g in bench:
        analyze(g, use_kernel=use_kernel, device=dev)
    t_loop = time.time() - t0
    print(f"  batched sweep: {t_batch:6.1f}s   "
          f"analyze() loop: {t_loop:6.1f}s   "
          f"speedup: {t_loop / t_batch:.2f}x (target >= 2x)")
    for row in swept["rows"]:
        print(f"  {row['params']:<24} diam={row['diameter']} "
              f"mult={row['mult_mean']:.2f} tput_lb={row['tput_lb']:.4f}")
    if args.trace:
        _export_trace(args.trace)


def _export_trace(path):
    from repro_torch import obs

    obs.export(path)
    obs.log("example.trace", path=path)


if "--sweep" in sys.argv:
    main_sweep(sys.argv[1:])
    sys.exit(0)

# default walkthrough: module-level code below; --trace is handled by hand
_TRACE_OUT = None
_DEVICE = (sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv
           else "cuda")
if "--trace" in sys.argv:
    from repro_torch import obs

    _TRACE_OUT = sys.argv[sys.argv.index("--trace") + 1]
    obs.enable()

from repro_torch.core import routing as R, topology as T, workload as W
from repro_torch.core.analysis import AnalysisEngine
from repro_torch.core.traffic import TrafficSpec
from repro_torch.core.collectives import (
    PhysicalFabric, plan_mesh_mapping, pod_traffic_report,
)

# samp-max: flows over the most loaded link, one sampled uniform-over-all-
# shortest-paths route per flow. ecmp/vlb/slack1-max: the *exact expected*
# max link load when the same demand is pushed through each routing model
# (routing.assign) — sampled estimates ecmp; Valiant trades hops for spread.
print(f"{'family':<11}{'routers':>8}{'diam':>6}{'avg':>7}"
      f"{'mult':>7}{'+1':>8}{'interf':>8}"
      f"{'samp-max':>9}{'ecmp-max':>9}{'vlb-max':>9}{'slack1-max':>11}")
for fam in FAMILIES:
    g = T.by_servers(fam, 10_000)
    eng = AnalysisEngine(g, device=_DEVICE)
    rep = eng.report()  # all stages share the engine's one APSP result
    mult = eng.multiplicities()["multiplicity"]
    # demand comes from the unified spec language; the Workload container
    # carries the sampled flow pairs through the path-sampling evaluator
    spec = TrafficSpec.parse("permutation:flows=2048")
    wl = W.Workload(pairs=spec.pairs(g), name=spec.describe())
    tr = W.evaluate_workload(g, wl, dist=eng.distances(), mult=mult,
                             device=_DEVICE)
    demand = wl.demand_matrix(g)
    # f64 BLAS path for the model columns: the walkthrough favours turnaround;
    # the counting-kernel path is timed by chip_smoke.py phase 10
    vlb = R.ValiantVLB.from_engine(eng, use_kernel=False)
    slack1 = R.SlackRouting.from_engine(eng, slack=1, use_kernel=False)
    print(f"{fam:<11}{g.n:>8}{rep['diameter']:>6}"
          f"{rep['avg_path_length']:>7.2f}"
          f"{rep['path_multiplicity_mean']:>7.2f}"
          f"{rep['nonminimal_plus1_mean']:>8.1f}"
          f"{rep['edge_interference_mean']:>8.3f}"
          f"{tr['max_link_load']:>9.1f}"
          f"{tr['max_expected_link_load']:>9.1f}"
          f"{vlb.link_loads(demand).max():>9.1f}"
          f"{slack1.link_loads(demand).max():>11.1f}")

# Per-pair saturation throughput (max concurrent flow, self-certifying
# bounds): the common fraction lambda of every pairwise demand the fabric
# carries simultaneously — the paper's "exact throughput between every
# router pair" number, at a matched ~2k-server cost point.
print("\nPer-pair saturation throughput (all-to-all demand, eps=0.5):")
for fam in ("slimfly", "fattree"):
    g = T.by_servers(fam, 2_000)
    eng = AnalysisEngine(g, throughput_demand="all-pairs",
                         throughput_eps=0.5, throughput_rounds=32,
                         device=_DEVICE)
    tp = eng.throughput()
    print(f"  {fam:<9} n={g.n:<5} lambda in [{tp['throughput']:.5f}, "
          f"{tp['upper_bound']:.5f}]  rounds={tp['rounds']} "
          f"converged={tp['converged']} "
          f"aggregate={tp['aggregate_throughput']:.0f}")

print("\nProduction fabric planning (v5e pod = 16x16 ICI torus):")
for axes, pods in [({"data": 16, "model": 16}, 1),
                   ({"pod": 2, "data": 16, "model": 16}, 2)]:
    plan = plan_mesh_mapping(axes, PhysicalFabric((16, 16), pods))
    print(f"  mesh {axes} -> {plan.assignment}  "
          f"bundle={plan.score_seconds*1e3:.3f} ms  "
          f"links={[f'{k}:{v.kind}' for k, v in plan.axis_links.items()]}")

# congestion sanity-check of the planned pod: all-to-all chip demand routed
# on the physical torus through the same assignment engine
import numpy as np  # noqa: E402

fab = PhysicalFabric((8, 8), 1)
n = fab.chips_per_pod
rep = pod_traffic_report(fab, np.ones((n, n)) - np.eye(n), device=_DEVICE)
print(f"\nPod torus {fab.torus_dims} all-to-all congestion: "
      f"max={rep['max_link_load']:.1f} imbalance={rep['load_imbalance']:.2f} "
      f"({rep['routing_model']})")

if _TRACE_OUT:
    _export_trace(_TRACE_OUT)

"""Batched degradation curves on torch: metric-vs-failure-rate with
bootstrap CIs.

One severity level = stacked device passes: :func:`evaluate_failure_batch`
uploads each chunk of the ``(S, n, n)`` mask batch from `resilience.faults`
once, as uint8 (a quarter of the float32 bytes; the cast runs on the card),
runs the batched wavefront (`analysis.wavefront.wavefront_dist_mult_device`
— dist AND multiplicity from one fused frontier step per level) and the
batched Brandes ECMP accumulation (`routing.assign.ecmp_all_pairs_loads`)
on it, and reduces every per-sample metric with masked reductions on the
card, in float64. Only the per-sample ``(S,)`` vectors come back to the
host, for the bootstrap. There is no per-mask Python loop: ``mask_chunk``
only splits oversized batches into several stacked passes to bound device
memory.

Per-sample metrics (all defined on partitioned graphs):

* ``reachable_frac``   reachable ordered pairs / n(n-1) — routers killed by
  router failures stay as isolated vertices, so their pairs count as
  unreachable and the metric is monotone under the severity-nested plans.
* ``tput_lb``          exact ECMP saturation-throughput lower bound
  ``1 / max_link_load`` under uniform demand over the *reachable* pairs.
  Defined as 0.0 when no pair is reachable.
* ``diameter`` / ``avg_spl`` over reachable pairs (0.0 when none).
* ``mult_mean`` / ``mult_p10`` / ``mult_p50`` / ``mult_p90`` /
  ``frac_multipath``  shortest-path multiplicity stats over reachable
  pairs (nearest-rank percentiles).
* ``plus1_mean`` / ``plus1_p50`` / ``plus2_mean``  simple-path counts at
  +1/+2 slack (batched form of `analysis.paths.path_counts_with_slack`,
  ``slack=True``), through the stacked counting product.

``use_kernel=False`` runs the same passes on the float64 oracle on the same
device (`routing.assign.count_product(False)`): the BFS, the Brandes loads
and the slack products in float64.

:func:`degradation_curves` sweeps severities over the equal-cost family
set (`core.sweep.equal_cost_graphs`) and reports each metric as a mean
with a bootstrap 95% CI over the mask samples
(`analysis.estimator.bootstrap_ci`); :func:`check_degradation` is the CI
gate (schema + monotonicity + 0-failure == unfailed baseline).

CLI::

  python -m repro_torch.core.resilience [--families a,b,...]
      [--rates 0,0.02,...] [--samples N] [--kind link|router|cable]
      [--max-routers N] [--traffic SPEC] [--out DIR] [--check]
      [--trace OUT.json] [--device cuda|cpu] [--no-kernel]
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import obs
from ..analysis.wavefront import pad_block, resolve_device
from ..graph import Graph
from .faults import failure_batch, failure_plan, rate_to_k

__all__ = ["evaluate_failure_batch", "degradation_curves",
           "format_degradation_table", "check_degradation", "main"]

#: metrics every degradation point must carry (the --check schema)
METRICS = ("reachable_frac", "tput_lb", "diameter", "avg_spl", "mult_mean",
           "mult_p10", "mult_p50", "mult_p90", "frac_multipath")
SLACK_METRICS = ("plus1_mean", "plus1_p50", "plus2_mean")

#: default device-memory budget for one stacked pass; a chunk holds
#: ~8 live (chunk, p, p) f32 buffers through the wavefront + ECMP chain
_CHUNK_BUDGET = 1 << 30

_F64 = torch.float64


def _auto_chunk(n: int, samples: int, budget: int = _CHUNK_BUDGET) -> int:
    p = pad_block(n)
    return max(1, min(samples, budget // (8 * p * p * 4)))


def _upload_masks(adj: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A {0,1} adjacency (stack) on ``dev`` as float32, sent as uint8."""
    masks = np.ascontiguousarray(adj, np.uint8)
    obs.record_h2d(masks.nbytes, "failure_masks")
    return torch.from_numpy(masks).to(dev).float()


def _div(num, den) -> torch.Tensor:
    """``num / den`` in float64, one correctly rounded division a cell as
    numpy divides: on the card a Python-scalar divisor runs as a product by
    its reciprocal, so a scalar operand becomes a full tensor first."""
    like = num if torch.is_tensor(num) else den
    num, den = (x.to(_F64) if torch.is_tensor(x) else
                torch.full(like.shape, x, dtype=_F64, device=like.device)
                for x in (num, den))
    return num / den


def _masked_percentiles(vals: torch.Tensor, off: torch.Tensor,
                        qs: Sequence[float]) -> torch.Tensor:
    """(len(qs), S) nearest-rank percentiles of ``vals`` over mask ``off``,
    per leading-axis sample, in float64; 0.0 where the mask is empty."""
    s = vals.shape[0]
    cnt = off.reshape(s, -1).sum(1)
    flat = torch.where(off, vals.to(_F64), float("inf")).reshape(s, -1)
    flat = torch.sort(flat, dim=1).values
    hi = (cnt - 1).clamp(min=0)
    out = []
    for q in qs:
        # the rank q * hi in float64, rounded half to even: torch.round
        # rounds as np.round does, so the index is the JAX package's
        idx = torch.minimum(torch.round(hi.to(_F64) * q).long(), hi)
        out.append(torch.where(cnt > 0, flat.gather(1, idx[:, None])[:, 0],
                               0.0))
    return torch.stack(out)


def _masked_mean(vals: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    s = vals.shape[0]
    cnt = off.reshape(s, -1).sum(1)
    tot = torch.where(off, vals.to(_F64), 0.0).reshape(s, -1).sum(1)
    return torch.where(cnt > 0, _div(tot, cnt.clamp(min=1)), 0.0)


def _batched_slack_means(adj: torch.Tensor, dist: torch.Tensor,
                         mult: torch.Tensor, off: torch.Tensor,
                         use_kernel: bool) -> Dict[str, torch.Tensor]:
    """Batched +1/+2-slack simple-path counts -> per-sample aggregates.

    The `analysis.paths.path_counts_with_slack` recurrence with a leading
    sample axis: ``walks_L = walks_{L-1} @ A`` and
    ``T_L = T_{L-1} @ A + walks_L * deg`` per sample (deg varies with the
    failure mask), evaluated with the stacked counting product on the
    device — 2 products per level, diameter + 2 levels. Same walk
    semantics: +1 counts are exact simple paths, +2 counts subtract the
    one-bounce correction and clamp at zero. Counts are stored in float32
    on both paths, as the JAX package stores them (the f64 oracle rounds
    each product to float32), so past 2**24 they round.
    """
    from ..routing.assign import count_product

    product = count_product(use_kernel)
    s, n, _ = adj.shape
    deg = adj.sum(dim=-1)[:, None, :]                        # (S, 1, n)
    finite = torch.isfinite(dist)
    diam = int(torch.where(finite, dist, 0.0).max())
    eye = torch.eye(n, dtype=torch.float32, device=adj.device)
    walks = eye.expand(adj.shape).contiguous()               # A^L, L = 0
    bounce = eye * deg                                       # T_0 = D
    plus1 = torch.zeros_like(walks)
    plus2 = torch.zeros_like(walks)
    correction = torch.where(dist == 0, bounce, 0.0)
    for level in range(1, diam + 3):
        walks = product(walks, adj).float()
        bounce = product(bounce, adj).float() + walks * deg
        plus1 = torch.where(dist == level - 1, walks, plus1)
        plus2 = torch.where(dist == level - 2, walks, plus2)
        correction = torch.where(dist == level, bounce, correction)
    del walks, bounce
    d0 = torch.where(finite, dist, 0.0).float()
    plus2 = (plus2 - correction + d0 * mult.float()).clamp(min=0.0)
    plus1 = torch.where(off, plus1, 0.0)
    plus2 = torch.where(off, plus2, 0.0)
    return {
        "plus1_mean": _masked_mean(plus1, off),
        "plus1_p50": _masked_percentiles(plus1, off, (0.5,))[0],
        "plus2_mean": _masked_mean(plus2, off),
    }


def _routed_total(demand: np.ndarray, off: torch.Tensor
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample offered and routed demand volume, (S,) each.

    Summed on the host by numpy from the host demand, in the JAX package's
    order, so both are bit-equal to it (and routed == total exactly where
    every pair is reachable). ``demand`` and ``off`` are ``(1|S, n, n)``; a
    single demand matrix is summed once per mask, never broadcast to the
    stack.
    """
    off_h = off.cpu().numpy()
    s = max(len(demand), len(off_h))
    total = demand.reshape(len(demand), -1).sum(1)
    if len(demand) == 1 and s > 1:
        routed = np.array([np.where(o, demand[0], 0.0).ravel().sum()
                           for o in off_h])
        return np.repeat(total, s), routed
    return total, np.where(off_h, demand, 0.0).reshape(s, -1).sum(1)


def _eval_stack(adj: torch.Tensor, use_kernel: bool, slack: bool,
                demand: Optional[np.ndarray] = None
                ) -> Dict[str, torch.Tensor]:
    """One stacked device pass over a (C, n, n) float32 mask stack.

    ``demand=None`` is the legacy convention: uniform demand over the
    reachable pairs. A host ``(1|C, n, n)`` demand stack instead routes
    that volume (mask ``i`` pairs with demand sample ``i``; a single
    matrix broadcasts on the card) via `routing.assign.ecmp_demand_loads`
    and adds the ``dropped_demand_frac`` metric per the
    `core.traffic.spec` contract. Returns (C,) float64 device tensors.
    """
    from ..routing.assign import _on, ecmp_all_pairs_loads, ecmp_demand_loads
    from ..traffic.scenarios import _dist_mult

    dist, mult = _dist_mult(adj, use_kernel)
    s, n = adj.shape[0], adj.shape[-1]
    off = torch.isfinite(dist) & (dist > 0)
    cnt = off.reshape(s, -1).sum(1)
    reach_frac = _div(cnt, max(n * (n - 1), 1))
    if demand is None:
        loads = ecmp_all_pairs_loads(dist, mult, adj, use_kernel=use_kernel)
        peak = loads.reshape(s, -1).amax(1).to(_F64)
        tput = torch.where((cnt > 0) & (peak > 0),
                           _div(1.0, peak.clamp(min=1e-300)), 0.0)
        dropped = None
    else:
        dem = _on(demand, adj.device)
        loads = ecmp_demand_loads(dist, mult, adj, dem,
                                  use_kernel=use_kernel)
        del dem
        total, routed = _routed_total(demand, off)
        dropped = np.where(total > 0,
                           1.0 - routed / np.maximum(total, 1e-300), 0.0)
        routed = torch.from_numpy(routed).to(adj.device)
        peak = loads.reshape(s, -1).amax(1).to(_F64)
        tput = torch.where((routed > 0) & (peak > 0),
                           _div(1.0, peak.clamp(min=1e-300)), 0.0)
    del loads
    diam = torch.where(off, dist, -torch.inf).reshape(s, -1).amax(1)
    p10, p50, p90 = _masked_percentiles(mult, off, (0.1, 0.5, 0.9))
    out = {
        "reachable_frac": reach_frac,
        "tput_lb": tput,
        "diameter": torch.where(cnt > 0, diam.to(_F64), 0.0),
        "avg_spl": _masked_mean(dist, off),
        "mult_mean": _masked_mean(mult, off),
        "mult_p10": p10,
        "mult_p50": p50,
        "mult_p90": p90,
        "frac_multipath": _masked_mean((mult > 1).to(_F64), off),
    }
    if dropped is not None:
        out["dropped_demand_frac"] = torch.from_numpy(dropped).to(adj.device)
    if slack:
        out.update(_batched_slack_means(adj, dist, mult, off, use_kernel))
    return out


def _to_host(parts: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """Concatenate per-chunk (C,) float64 device metrics; one copy to the
    host for all of them."""
    keys = list(parts[0])
    stacked = torch.stack([torch.cat([p[k] for p in parts]) for k in keys])
    return dict(zip(keys, stacked.cpu().numpy()))


def evaluate_failure_batch(g: Graph, batch, use_kernel: bool = True,
                           slack: bool = False,
                           mask_chunk: Optional[int] = None,
                           demand=None, device="cuda"
                           ) -> Dict[str, np.ndarray]:
    """Per-sample degradation metrics for one severity's failure batch.

    Returns ``{metric: (S,) float64 array}`` for the module's METRICS
    (plus SLACK_METRICS with ``slack=True``). The whole batch runs in
    stacked device passes of at most ``mask_chunk`` masks (auto-sized from
    a 1 GiB working-set budget when None) — the only Python loop is over
    chunks, never over masks. ``device`` is where the passes run
    (``"cuda"`` by default, which raises without a card).

    ``demand`` (default None = uniform over the reachable pairs) accepts
    a `core.traffic.TrafficSpec`, a spec string, one ``(n, n)`` matrix
    (broadcast across every mask on the card — the clean monotonicity
    convention), or an ``(S, n, n)`` stack pairing demand sample ``i``
    with failure mask ``i``; adds the ``dropped_demand_frac`` metric.
    """
    dev = resolve_device(device)
    s = batch.samples
    n = g.n
    dem = None
    if demand is not None:
        from ..traffic.scenarios import demand_batch

        dem, _ = demand_batch(g, demand)
        if len(dem) not in (1, s):
            raise ValueError(f"{len(dem)} demand samples cannot pair with "
                             f"{s} failure masks")
    if mask_chunk is None:
        mask_chunk = _auto_chunk(n, s)
    parts: List[Dict[str, torch.Tensor]] = []
    with obs.span("resilience.severity", cat="resilience", kind=batch.kind,
                  k=batch.k, samples=s, routers=n,
                  mask_chunk=mask_chunk) as sp:
        for lo in range(0, s, mask_chunk):
            d = None if dem is None else (
                dem if len(dem) == 1 else dem[lo:lo + mask_chunk])
            adj = _upload_masks(batch.adjacency[lo:lo + mask_chunk], dev)
            parts.append(_eval_stack(adj, use_kernel, slack, demand=d))
            del adj
        out = _to_host(parts)
        disc = float(1.0 - out["reachable_frac"].mean())
        sp.set(disconnected_frac=disc, passes=len(parts))
        obs.gauge("resilience.disconnected_frac").set(disc)
    return out


def _point(metrics: Dict[str, np.ndarray], b: int, seed: int
           ) -> Dict[str, Dict[str, object]]:
    from ..analysis.estimator import bootstrap_ci

    out = {}
    for i, (name, vals) in enumerate(sorted(metrics.items())):
        point, lo, hi = bootstrap_ci(vals, b=b, seed=seed + i)
        out[name] = {"value": point, "ci95": [lo, hi]}
    return out


def degradation_curves(
        families: Optional[Sequence[str]] = None,
        budget: Optional[float] = None,
        ref: Tuple[str, int] = ("slimfly", 2000),
        max_routers: int = 256,
        rates: Sequence[float] = (0.0, 0.01, 0.02, 0.05, 0.1),
        samples: int = 1000, kind: str = "link", bundle_size: int = 8,
        seed: int = 0, use_kernel: bool = True, slack: bool = True,
        mask_chunk: Optional[int] = None, bootstrap: int = 1000,
        graphs: Optional[Sequence[Graph]] = None, demand=None,
        device="cuda") -> Dict:
    """Degradation curves across the equal-cost family set.

    For each family (instantiated at matched cost like `core.sweep.sweep`;
    pass ``graphs`` to reuse pre-built instances) draws ONE severity-nested
    failure plan of ``samples`` scenarios, then evaluates every rate as one
    batched severity pass on ``device``. ``rates`` are fractions of
    failable units (links / routers / cable bundles by ``kind``); rate 0.0
    is evaluated as a single-mask batch and doubles as the bit-equality
    anchor against the unfailed baseline. Families without a TopologySpec
    are skipped for ``kind="cable"`` (no link inventory to attribute).

    ``demand`` (default None = uniform over the reachable pairs) accepts a
    `core.traffic.TrafficSpec` or spec string (``--traffic`` on the CLI):
    the spec's sample-0 matrix is materialized per family and broadcast
    across every failure mask, so the curves answer "how does THIS traffic
    degrade" under one fixed scenario.

    The host builds each severity's masks (`resilience.faults`, seeded
    numpy), spanned as ``resilience.masks``.
    """
    from ..sweep import equal_cost_graphs

    resolve_device(device)
    t0 = time.time()
    rates = sorted(float(r) for r in rates)
    traffic_label = None
    if demand is not None and not isinstance(demand, np.ndarray):
        from ..traffic.spec import as_spec

        demand = as_spec(demand)
        traffic_label = demand.describe()
    with obs.span("resilience.curves", cat="resilience", kind=kind,
                  samples=samples, rates=len(rates)) as root:
        if graphs is None:
            graphs, budget = equal_cost_graphs(families, budget, ref,
                                               max_routers)
        if not graphs:
            raise ValueError("degradation sweep has no topologies")
        root.set(families=len(graphs))
        fam_rows = []
        for g in graphs:
            fam = g.meta["spec"].family if g.meta.get("spec") else g.name
            try:
                plan = failure_plan(g, kind=kind, samples=samples,
                                    seed=seed, bundle_size=bundle_size)
            except KeyError:
                obs.log("resilience.skip", family=fam,
                        reason="no link inventory for cable-class faults")
                continue
            with obs.span("resilience.family", cat="resilience", family=fam,
                          routers=g.n, units=plan.n_units):
                dem_g = demand if demand is None or \
                    isinstance(demand, np.ndarray) else demand.matrix(g)
                # k=0 masks are all identical: evaluate ONE, so the rate-0
                # point is bit-equal to the unfailed baseline by
                # construction (a mean over S identical floats is not)
                with obs.span("resilience.masks", cat="resilience", k=0):
                    b0 = failure_batch(plan, 0)
                b0 = dataclasses.replace(
                    b0, adjacency=b0.adjacency[:1], alive=b0.alive[:1],
                    edge_failed=b0.edge_failed[:1])
                base = evaluate_failure_batch(
                    g, b0, use_kernel=use_kernel, slack=slack,
                    mask_chunk=mask_chunk, demand=dem_g, device=device)
                baseline = {k: float(v[0]) for k, v in sorted(base.items())}
                points = []
                for rate in rates:
                    k = rate_to_k(plan, rate)
                    if rate == 0.0:
                        vals = base
                    else:
                        with obs.span("resilience.masks", cat="resilience",
                                      k=k):
                            batch = failure_batch(plan, k)
                        vals = evaluate_failure_batch(
                            g, batch, use_kernel=use_kernel, slack=slack,
                            mask_chunk=mask_chunk, demand=dem_g,
                            device=device)
                        del batch
                    points.append({
                        "rate": rate,
                        "k": k,
                        "samples": int(len(vals["reachable_frac"])),
                        "metrics": _point(vals, bootstrap, seed),
                    })
                fam_rows.append({
                    "family": fam,
                    "routers": g.n,
                    "edges": int(len(g.edges)),
                    "units": plan.n_units,
                    "baseline": baseline,
                    "points": points,
                })
    return {
        "kind": kind,
        "rates": list(rates),
        "samples": samples,
        "bundle_size": bundle_size if kind == "cable" else None,
        "traffic": traffic_label,
        "seed": seed,
        "budget": budget,
        "use_kernel": use_kernel,
        "slack": slack,
        "bootstrap": bootstrap,
        "families": fam_rows,
        "elapsed_s": round(time.time() - t0, 2),
    }


_TCOLS = (
    ("family", "<14s"), ("rate", ">6.2f"), ("k", ">6d"),
    ("tput-lb", ">9.4f"), ("+-ci", ">8.4f"), ("reach", ">7.3f"),
    ("diam", ">6.1f"), ("avg-spl", ">8.2f"), ("mult-p50", ">9.1f"),
    ("plus1-p50", ">10.1f"),
)


def format_degradation_table(result: Dict) -> str:
    """Fixed-width per-family degradation table (one row per severity)."""
    from ..sweep import _w

    lines = [f"degradation sweep: kind={result['kind']} "
             f"samples={result['samples']} seed={result['seed']} "
             f"({len(result['families'])} families, "
             f"{result['elapsed_s']}s batched passes)"]
    hdr = "".join(f"{name:>{_w(fmt)}s}" if ">" in fmt else
                  f"{name:<{_w(fmt)}s}" for name, fmt in _TCOLS)
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for fam in sorted(result["families"], key=lambda f: f["family"]):
        for pt in fam["points"]:
            m = pt["metrics"]
            tci = m["tput_lb"]["ci95"]
            cells = {
                "family": fam["family"], "rate": pt["rate"], "k": pt["k"],
                "tput-lb": m["tput_lb"]["value"],
                "+-ci": (tci[1] - tci[0]) / 2,
                "reach": m["reachable_frac"]["value"],
                "diam": m["diameter"]["value"],
                "avg-spl": m["avg_spl"]["value"],
                "mult-p50": m["mult_p50"]["value"],
                "plus1-p50": (m["plus1_p50"]["value"]
                              if "plus1_p50" in m else None),
            }
            row = []
            for name, fmt in _TCOLS:
                v = cells[name]
                row.append(" " * _w(fmt) if v is None else f"{v:{fmt}}")
            lines.append("".join(row))
    return "\n".join(lines)


def check_degradation(result: Dict, tput_tolerance: float = 0.05
                      ) -> List[str]:
    """CI gate over a degradation artifact. Returns failure messages.

    Checks: schema (every family has one point per rate, every point every
    METRICS entry with finite value + ordered ci95), bounds
    (``reachable_frac`` in [0, 1], ``tput_lb`` >= 0), the 0-failure point
    bit-equal to the unfailed baseline, mean ``reachable_frac`` strictly
    non-increasing in rate (guaranteed per-sample by the severity-nested
    plans), and mean ``tput_lb`` non-increasing within ``tput_tolerance``
    relative slack — removing a link also removes its disconnected pairs'
    demand, so throughput monotonicity holds in aggregate but is not a
    per-sample theorem.
    """
    fails: List[str] = []
    for key in ("kind", "rates", "samples", "seed", "families"):
        if key not in result:
            fails.append(f"schema: missing top-level key {key!r}")
    if fails:
        return fails
    rates = list(result["rates"])
    if rates != sorted(rates):
        fails.append("schema: rates not ascending")
    want = set(METRICS) | (set(SLACK_METRICS) if result.get("slack") else
                           set())
    for fam in result["families"]:
        name = fam.get("family", "?")
        pts = fam.get("points", [])
        if [p.get("rate") for p in pts] != rates:
            fails.append(f"{name}: points do not cover rates {rates}")
            continue
        for pt in pts:
            missing = want - set(pt["metrics"])
            if missing:
                fails.append(f"{name} rate={pt['rate']}: missing metrics "
                             f"{sorted(missing)}")
                continue
            for mname, m in pt["metrics"].items():
                v, ci = m.get("value"), m.get("ci95", [None, None])
                if v is None or not np.isfinite(v):
                    fails.append(f"{name} rate={pt['rate']}: {mname} "
                                 f"value {v!r} not finite")
                elif not (ci[0] <= v <= ci[1] or ci[0] == ci[1]):
                    fails.append(f"{name} rate={pt['rate']}: {mname} "
                                 f"value {v} outside ci95 {ci}")
            rf = pt["metrics"]["reachable_frac"]["value"]
            if not 0.0 <= rf <= 1.0:
                fails.append(f"{name} rate={pt['rate']}: reachable_frac "
                             f"{rf} outside [0, 1]")
            if pt["metrics"]["tput_lb"]["value"] < 0:
                fails.append(f"{name} rate={pt['rate']}: negative tput_lb")
        if rates and rates[0] == 0.0:
            for mname, bval in fam.get("baseline", {}).items():
                got = pts[0]["metrics"][mname]["value"]
                if got != bval:
                    fails.append(f"{name}: 0-failure {mname} {got} != "
                                 f"unfailed baseline {bval}")
        reach = [p["metrics"]["reachable_frac"]["value"] for p in pts]
        if any(b > a + 1e-12 for a, b in zip(reach, reach[1:])):
            fails.append(f"{name}: reachable_frac not non-increasing "
                         f"{reach}")
        tput = [p["metrics"]["tput_lb"]["value"] for p in pts]
        if any(b > a * (1 + tput_tolerance) + 1e-12
               for a, b in zip(tput, tput[1:])):
            fails.append(f"{name}: tput_lb rises beyond tolerance {tput}")
    return fails


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", default=None,
                    help="comma-separated (default: all registered)")
    ap.add_argument("--budget", type=float, default=None)
    ap.add_argument("--ref-family", default="slimfly")
    ap.add_argument("--ref-servers", type=int, default=2000)
    ap.add_argument("--max-routers", type=int, default=256)
    ap.add_argument("--rates", default="0,0.01,0.02,0.05,0.1",
                    help="comma-separated failure rates (unit fractions)")
    ap.add_argument("--samples", type=int, default=1000,
                    help="failure masks per severity level")
    ap.add_argument("--kind", choices=("link", "router", "cable"),
                    default="link")
    ap.add_argument("--bundle-size", type=int, default=8,
                    help="cable kind: correlated edges per bundle")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--traffic", default=None,
                    help="TrafficSpec flag grammar (e.g. "
                         "'hotspot:zipf_a=1.4'): degrade THIS demand "
                         "instead of uniform-over-reachable-pairs")
    ap.add_argument("--no-kernel", action="store_true",
                    help="the float64 oracle instead of the CUDA kernels")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the batched passes (default "
                         "cuda; 'cpu' runs the plain versions on the host)")
    ap.add_argument("--no-slack", action="store_true",
                    help="skip the +1/+2-slack path counts")
    ap.add_argument("--mask-chunk", type=int, default=None,
                    help="masks per stacked device pass (auto from a "
                         "1 GiB working-set budget)")
    ap.add_argument("--bootstrap", type=int, default=1000)
    ap.add_argument("--out", default=None,
                    help="directory for degradation.{txt,json}")
    ap.add_argument("--check", action="store_true",
                    help="CI gate: validate schema + monotonicity of the "
                         "produced curves, exit 1 on failure")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable tracing and write a Chrome trace-event "
                         "file")
    args = ap.parse_args(argv)

    if args.trace:
        obs.enable()
    fams = args.families.split(",") if args.families else None
    rates = [float(r) for r in args.rates.split(",") if r != ""]
    result = degradation_curves(
        fams, budget=args.budget,
        ref=(args.ref_family, args.ref_servers),
        max_routers=args.max_routers, rates=rates, samples=args.samples,
        kind=args.kind, bundle_size=args.bundle_size, seed=args.seed,
        use_kernel=not args.no_kernel, slack=not args.no_slack,
        mask_chunk=args.mask_chunk, bootstrap=args.bootstrap,
        demand=args.traffic, device=args.device)
    table = format_degradation_table(result)
    print(table)
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "degradation.txt").write_text(table + "\n")
        (out / "degradation.json").write_text(
            json.dumps(result, indent=1, default=str))
        obs.log("resilience.wrote", txt=str(out / "degradation.txt"),
                json=str(out / "degradation.json"))
    if args.trace:
        obs.export(args.trace)
        obs.log("resilience.trace", path=args.trace)
    if args.check:
        failures = check_degradation(result)
        for msg in failures:
            print(f"[resilience --check] FAIL {msg}")
        if not failures:
            print(f"[resilience --check] {len(result['families'])} "
                  f"families OK (schema + monotonicity + baseline)")
        return 1 if failures else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

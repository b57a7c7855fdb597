"""Headline topology metrics behind one staged engine.

`AnalysisEngine` runs the toolchain's stages — distances -> multiplicities
-> diversity -> spectral -> histograms -> throughput — with every stage
reading the one shared APSP result instead of recomputing it. `analyze()`
stays the one-call entry point and assembles the stage outputs into the
familiar report dict.

The distance, multiplicity and path-count matrices stay torch tensors on
the engine's device between stages; each is copied to the host once, for
the host-only stages (path diversity, edge interference, the summaries).

All exact metrics run on the dense APSP output when the router count permits
(every assigned benchmark size does); otherwise sampled BFS estimates are
used and flagged in the report.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ... import obs
from ..graph import Graph
from .apsp import apsp_dense, sampled_distances
from .histograms import path_length_histogram
from .paths import edge_interference, path_counts_with_slack
from .wavefront import resolve_device

__all__ = ["AnalysisEngine", "analyze", "path_diversity"]

DENSE_LIMIT = 8192  # routers; above this, sample


class AnalysisEngine:
    """Staged EvalNet analysis over one shared APSP result.

    Stages (`STAGES`) are lazy and cached: ``distances`` is computed once
    and every later stage reads it. ``report(stages=...)`` runs the
    requested stages and merges their dicts; per-stage accessors
    (:meth:`distances`, :meth:`multiplicities`, ...) expose the raw arrays
    as numpy (host copies of the device tensors, made once).

    ``device`` is where the matrices live and the kernels run (``"cuda"``
    by default; ``"cpu"`` runs the kernels' plain versions). The port runs
    on one device, so ``mesh="auto"`` resolves to no mesh and an explicit
    mesh raises NotImplementedError. ``tile_rows`` streams source tiles
    out-of-core and ``packed`` runs the int16/int32 packed-cell engine;
    their results are unpacked to the f32/inf convention before caching,
    so every stage downstream is dtype-agnostic.
    """

    STAGES = ("distances", "multiplicities", "diversity", "spectral",
              "histograms", "throughput", "comparison")
    #: `report(stages=None)` runs these; throughput is opt-in (it runs an
    #: iterative max-concurrent-flow solve, not a closed-form metric)
    DEFAULT_STAGES = ("distances", "multiplicities", "diversity", "spectral",
                      "histograms")

    #: all-pairs throughput demand above this router count would mean n^2
    #: commodities; larger instances fall back to a permutation demand
    ALL_PAIRS_LIMIT = 256

    def __init__(self, g: Graph, dense_limit: int = DENSE_LIMIT,
                 n_sources: int = 64, use_kernel: bool = True,
                 interference_pairs: int = 64, seed: int = 0,
                 throughput_eps: float = 0.25, throughput_rounds: int = 64,
                 throughput_demand: str = "auto", mesh="auto",
                 tile_rows=None, packed: bool = False, device="cuda"):
        self.g = g
        self.dense_limit = dense_limit
        self.n_sources = n_sources
        self.use_kernel = use_kernel
        self.interference_pairs = interference_pairs
        self.seed = seed
        self.throughput_eps = throughput_eps
        self.throughput_rounds = throughput_rounds
        self.throughput_demand = throughput_demand
        self.mesh = mesh
        self.tile_rows = tile_rows
        self.packed = packed
        self.device = resolve_device(device)
        self._cache: Dict[str, object] = {}

    def _resolved_mesh(self):
        # one device: "auto" means no mesh
        return None if self.mesh == "auto" else self.mesh

    @property
    def exact(self) -> bool:
        return self.g.n <= self.dense_limit

    def _host(self, key: str) -> np.ndarray:
        """The host copy of cached device tensor ``key``, made once."""
        hkey = f"{key}.host"
        if hkey not in self._cache:
            self._cache[hkey] = self._cache[key].cpu().numpy()
        return self._cache[hkey]

    # -- device matrices ---------------------------------------------------

    def _dist(self) -> torch.Tensor:
        """(n, n) float32 hop distances on the device (exact mode).

        The kernel path runs the wavefront engine once, which yields
        shortest-path multiplicities together with the distances — both
        land in the cache, so the comparison stage never recomputes them.
        """
        if "dist" not in self._cache:
            if self.use_kernel:
                from .engine_select import require_ported, resolve_engine
                from .wavefront import wavefront_dist_mult_device

                plan = require_ported(resolve_engine(
                    use_kernel=True, mesh=self._resolved_mesh(),
                    tile_rows=self.tile_rows, packed=self.packed))
                if plan.engine == "tiled" or plan.packed:
                    from ...kernels.semiring import DIST_UNREACHED
                    from .paths import shortest_path_multiplicity

                    dist, mult = shortest_path_multiplicity(
                        self.g, use_kernel=True, tile_rows=plan.tile_rows,
                        packed=plan.packed, device=self.device)
                    if plan.packed:
                        dist = np.where(dist == DIST_UNREACHED, np.inf,
                                        dist).astype(np.float32)
                        mult = mult.astype(np.float32)
                    dist, mult = (torch.from_numpy(x).to(self.device)
                                  for x in (dist, mult))
                else:
                    dist, mult = wavefront_dist_mult_device(
                        self.g.adjacency_dense(np.float32),
                        device=self.device)
                self._cache["dist"], self._cache["mult"] = dist, mult
            else:
                self._cache["dist"] = apsp_dense(self.g, use_kernel=False,
                                                 device=self.device)
        return self._cache["dist"]

    def _mult(self) -> torch.Tensor:
        if "mult" not in self._cache:
            from .paths import shortest_path_multiplicity

            _, mult = shortest_path_multiplicity(
                self.g, self._dist(), use_kernel=self.use_kernel)
            self._cache["mult"] = mult
        return self._cache["mult"]

    def _paths(self) -> Dict[str, object]:
        if "paths" not in self._cache:
            self._cache["paths"] = path_counts_with_slack(
                self.g, self._dist(), use_kernel=self.use_kernel)
        return self._cache["paths"]

    # -- stage accessors (raw arrays) -------------------------------------

    def distances(self) -> np.ndarray:
        """(n, n) float32 hop distances (exact mode) or sampled BFS rows."""
        if not self.exact:
            if "sampled" not in self._cache:
                self._cache["sampled"] = sampled_distances(
                    self.g, n_sources=self.n_sources, seed=self.seed)
            return self._cache["sampled"]
        self._dist()
        return self._host("dist")

    def shortest_path_mult(self) -> np.ndarray:
        """(n, n) exact shortest-path multiplicities over the shared APSP."""
        if not self.exact:
            raise ValueError("multiplicity needs the dense APSP result")
        self._mult()
        return self._host("mult")

    def multiplicities(self) -> Dict[str, np.ndarray]:
        """Exact per-pair simple-path counts at slack 0 / +1 / +2."""
        if not self.exact:
            raise ValueError("multiplicity stage needs the dense APSP result")
        if "paths.host" not in self._cache:
            paths = self._paths()
            self._cache["paths.host"] = {
                k: v.cpu().numpy() if torch.is_tensor(v) else v
                for k, v in paths.items()}
        return self._cache["paths.host"]

    def throughput(self) -> Dict[str, object]:
        """Per-pair saturation throughput (max concurrent flow) report.

        Uniform all-to-all demand for n <= ALL_PAIRS_LIMIT routers (the
        paper's per-pair saturation throughput); a random permutation
        demand above that (scalable proxy; flagged in the report). The
        result carries both the feasible lower bound and the LP-dual upper
        bound — see `routing.throughput.max_concurrent_flow`.
        """
        if not self.exact:
            raise ValueError("throughput stage needs the dense APSP result")
        if "throughput" not in self._cache:
            from ..routing import concurrent_flow_demand, max_concurrent_flow

            pattern = self.throughput_demand
            if pattern == "auto":
                pattern = ("all-pairs" if self.g.n <= self.ALL_PAIRS_LIMIT
                           else "permutation")
            demand = concurrent_flow_demand(self.g, self.distances(), pattern,
                                            seed=self.seed)
            res = max_concurrent_flow(
                self.g, demand, eps=self.throughput_eps,
                max_rounds=self.throughput_rounds,
                use_kernel=self.use_kernel, seed=self.seed,
                device=self.device)
            res["demand_pattern"] = pattern
            self._cache["throughput"] = res
        return self._cache["throughput"]

    def comparison(self) -> Dict[str, object]:
        """The equal-cost comparison row for this one topology.

        The per-graph counterpart of the batched `core.sweep` table: the
        same columns (exact shortest-path multiplicity, ECMP
        saturation-throughput lower bound via O(diameter) Brandes
        accumulation on the device, construction cost and power from the
        attached TopologySpec), sharing this engine's APSP result. Graphs
        built outside the registry carry no spec; their cost/power cells
        are None.
        """
        if not self.exact:
            raise ValueError("comparison stage needs the dense APSP result")
        if "comparison" not in self._cache:
            from ..costmodel import cost_report
            from ..routing.assign import ecmp_all_pairs_loads

            adj = torch.from_numpy(self.g.adjacency_dense(np.float64)).to(
                self.device)
            loads = ecmp_all_pairs_loads(self._dist(), self._mult(), adj,
                                         use_kernel=self.use_kernel,
                                         mesh=self._resolved_mesh())
            peak = float(loads.max()) if loads.numel() else 0.0
            dist, mult = self.distances(), self.shortest_path_mult()
            off = np.isfinite(dist) & (dist > 0)
            spec = self.g.meta.get("spec")
            cost = cost_report(spec) if spec is not None else {}
            self._cache["comparison"] = {
                "ecmp_saturation_throughput": 1.0 / peak if peak > 0 else 1.0,
                "path_multiplicity_mean": (float(mult[off].mean())
                                           if off.any() else 0.0),
                "construction_cost": cost.get("cost_total"),
                "power_w": cost.get("power_total_w"),
            }
        return self._cache["comparison"]

    # -- stage reports (summary dicts) -------------------------------------

    def _report_distances(self) -> Dict:
        # the partitioned-graph contract: diameter / avg_path_length cover
        # the reachable pairs, and disconnected_pair_fraction reports what
        # they exclude (0.0 on connected graphs; exact over all ordered
        # pairs in exact mode, the sampled-rows estimate otherwise)
        rep: Dict = {}
        if self.exact:
            dist = self.distances()
            finite = dist[np.isfinite(dist)]
            rep["diameter"] = int(finite.max())
            n = self.g.n
            rep["avg_path_length"] = float(finite.sum() / max(1, n * (n - 1)))
            off = max(1, n * (n - 1))
            reached = int((np.isfinite(dist).sum()) - n)   # minus diagonal
            rep["disconnected_pair_fraction"] = 1.0 - reached / off
            rep["exact"] = True
        else:
            d = self.distances()
            reachable = d[d >= 0]
            rep["diameter"] = int(reachable.max())  # lower bound from sample
            rep["avg_path_length"] = float(reachable[reachable > 0].mean())
            rep["disconnected_pair_fraction"] = float((d < 0).mean())
            rep["exact"] = False
        return rep

    def _report_multiplicities(self) -> Dict:
        if not self.exact:
            return {}
        paths = self.multiplicities()
        dist = self.distances()
        off = np.isfinite(dist) & (dist > 0)
        if not off.any():  # no reachable pair (edgeless / single router)
            return {}
        mult, p1, p2 = paths["multiplicity"], paths["plus1"], paths["plus2"]
        return {
            "path_multiplicity_mean": float(mult[off].mean()),
            "path_multiplicity_min": int(mult[off].min()),
            "path_multiplicity_max": int(mult[off].max()),
            "nonminimal_plus1_mean": float(p1[off].mean()),
            "nonminimal_plus2_mean": float(p2[off].mean()),
            "path_counts_exact": bool(paths["exact"]),
        }

    def _report_diversity(self, with_interference: bool = True) -> Dict:
        if not self.exact:
            return {}
        dist = self.distances()
        rep = {"path_diversity_mean": float(
            path_diversity(self.g, dist, seed=self.seed).mean())}
        if with_interference:  # interference rides on the mult stage
            rep.update(edge_interference(
                self.g, dist, self.multiplicities()["multiplicity"],
                pairs=self.interference_pairs, seed=self.seed))
        return rep

    def _report_spectral(self) -> Dict:
        if self.g.n > 4 * self.dense_limit:
            return {}
        from .spectral import spectral_bounds

        return spectral_bounds(self.g, device=self.device)

    def _report_histograms(self) -> Dict:
        if self.exact:
            hist = path_length_histogram(self._dist())
        else:
            d = self.distances()
            reachable = d[d > 0]
            hist = np.bincount(reachable).tolist()
        return {"path_histogram": hist}

    def _report_comparison(self) -> Dict:
        return dict(self.comparison())

    def _report_throughput(self) -> Dict:
        # throughput is never in DEFAULT_STAGES, so reaching this stage
        # means the caller asked for it explicitly: let the accessor raise
        # on sampled mode rather than silently answering with nothing
        res = self.throughput()
        return {
            "saturation_throughput": res["throughput"],
            "throughput_upper_bound": res["upper_bound"],
            "throughput_gap": res["gap"],
            "aggregate_throughput": res["aggregate_throughput"],
            "throughput_rounds": res["rounds"],
            "throughput_converged": res["converged"],
            "throughput_demand": res["demand_pattern"],
        }

    def report(self, stages: Optional[Sequence[str]] = None) -> Dict:
        """Run the requested stages (default: DEFAULT_STAGES) and merge
        their summaries."""
        stages = self.DEFAULT_STAGES if stages is None else tuple(stages)
        unknown = set(stages) - set(self.STAGES)
        if unknown:
            raise ValueError(f"unknown stages {sorted(unknown)}")
        rep = dict(self.g.summary())
        with obs.span("analysis.report", cat="analysis",
                      family=self.g.name, routers=self.g.n,
                      stages=",".join(stages), exact=self.exact):
            for stage in self.STAGES:  # canonical order, not input order
                if stage not in stages:
                    continue
                with obs.span(f"analysis.{stage}", cat="analysis",
                              family=self.g.name, routers=self.g.n):
                    if stage == "diversity":
                        # interference needs multiplicities; only pay for
                        # it when that stage was requested, so output
                        # depends solely on the requested stage set
                        # (never on engine cache history)
                        rep.update(self._report_diversity(
                            with_interference="multiplicities" in stages))
                    else:
                        rep.update(getattr(self, f"_report_{stage}")())
        return rep


def analyze(g: Graph, dense_limit: int = DENSE_LIMIT, n_sources: int = 64,
            spectral: bool = True, use_kernel: bool = True,
            multiplicities: bool = True, throughput: bool = False,
            throughput_eps: float = 0.25, device="cuda") -> Dict:
    """One-call EvalNet analysis: the toolchain's main entry point.

    ``throughput=True`` additionally runs the max-concurrent-flow stage
    (exact mode only) — the ``saturation_throughput`` /
    ``throughput_upper_bound`` keys; see `routing.throughput`. ``device``
    is where the matrices live and the kernels run.
    """
    engine = AnalysisEngine(g, dense_limit=dense_limit, n_sources=n_sources,
                            use_kernel=use_kernel,
                            throughput_eps=throughput_eps, device=device)
    stages = ["distances", "histograms"]
    if engine.exact:
        stages.append("diversity")
        if multiplicities:
            stages.append("multiplicities")
        if throughput:
            stages.append("throughput")
    if spectral:
        stages.append("spectral")
    return engine.report(stages)


def path_diversity(g: Graph, dist: Optional[np.ndarray] = None,
                   pairs: int = 512, seed: int = 0,
                   device="cuda") -> np.ndarray:
    """Shortest-path diversity for sampled (s, t): number of neighbours w of s
    with dist(w, t) = dist(s, t) - 1, i.e. distinct first hops on shortest
    paths. This is the metric adaptive-routing studies care about.

    ``dist`` is a host array; without it the APSP runs on ``device``. The
    exact all-pairs generalization is `paths.path_counts_with_slack` /
    `paths.shortest_path_multiplicity`; this sampled first-hop variant
    stays for huge instances and as the historical metric.
    """
    if dist is None:
        dist = apsp_dense(g, device=device).cpu().numpy()
    rng = np.random.default_rng(seed)
    indptr, indices = g.csr()
    out = np.zeros(pairs, dtype=np.int32)
    n = g.n
    for i in range(pairs):
        s = int(rng.integers(n))
        t = int(rng.integers(n))
        while t == s:
            t = int(rng.integers(n))
        nbrs = indices[indptr[s]:indptr[s + 1]]
        if not np.isfinite(dist[s, t]):
            out[i] = 0
            continue
        out[i] = int((dist[nbrs, t] == dist[s, t] - 1).sum())
    return out

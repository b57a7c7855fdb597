"""Batched traffic-scenario evaluation on torch: one stacked pass per
scenario.

:func:`evaluate_traffic_batch` pushes a whole ``(S, n, n)`` demand batch
(a :class:`~repro_torch.core.traffic.spec.TrafficSpec`, a flag-grammar
string, or raw matrices) through ONE demand-weighted Brandes accumulation
on the card (`routing.assign.ecmp_demand_loads`, the stacked device engine
behind `resilience.degradation`) and reduces per-matrix congestion metrics
with masked reductions on the card — no per-matrix Python loop anywhere on
the device path (``mask_chunk`` only splits oversized batches to bound
device memory, reusing the resilience chunk budget). Demand stays host
numpy (seeded, bit-equal to the JAX package's) and goes up once per chunk;
the offered and routed volumes are summed on the host in numpy's order,
so ``demand_total`` and ``dropped_demand_frac`` are bit-equal to the JAX
package's.

Per-matrix metrics (all defined on partitioned graphs; the
unreachable-demand contract lives in `traffic.spec`):

* ``max_link_load``        peak directed link load under exact ECMP.
* ``tput_lb``              saturation-throughput lower bound: the largest
  factor the whole matrix can be scaled by before the peak link hits
  ``capacity`` (``capacity / max_link_load``); 0.0 when nothing routes.
* ``mean_link_load`` / ``p50`` / ``p90`` / ``p99_link_load``  hot-link
  statistics over the *used* (positive-load) directed links.
* ``links_used_frac``      used directed links / 2|E|.
* ``avg_hops``             demand-weighted mean shortest-path length of
  the routed volume.
* ``demand_total`` / ``dropped_demand_frac``  offered volume and the
  fraction dropped (diagonal + unreachable pairs).

:func:`evaluate_traffic_failure_batch` is the traffic x failure engine:
the same metrics over a stacked *masked* adjacency batch
(`resilience.faults`), mask ``i`` paired with demand sample ``i`` (adds
``reachable_frac``). :func:`saturation_search` bisects the injection rate
until the peak load crosses capacity, evaluating each refinement round as
one batched pass across the whole rate grid x sample stack, built on the
card from the uploaded unit batch.

``use_kernel=False`` is the float64 oracle on the same device. Every entry
point takes ``device`` (``"cuda"`` by default, which raises without a
card); tensor operands keep their device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ... import obs
from ..graph import Graph
from .spec import TrafficSpec, as_spec

__all__ = ["TRAFFIC_METRICS", "demand_batch", "evaluate_traffic_batch",
           "evaluate_traffic_failure_batch", "saturation_search"]

#: metrics every scenario evaluation returns (the --check schema)
TRAFFIC_METRICS = ("max_link_load", "tput_lb", "mean_link_load",
                   "p50_link_load", "p90_link_load", "p99_link_load",
                   "links_used_frac", "avg_hops", "demand_total",
                   "dropped_demand_frac")

DemandLike = Union[str, TrafficSpec, np.ndarray]

_F64 = torch.float64


def demand_batch(g: Graph, demand: DemandLike,
                 samples: Optional[int] = None) -> Tuple[np.ndarray, str]:
    """Normalize any demand form to ``((S, n, n) float64, label)``, host
    numpy.

    Accepts a :class:`TrafficSpec`, a flag-grammar string, one ``(n, n)``
    matrix, or an already-stacked ``(S, n, n)`` batch — the normalization
    hook every engine entry point shares.
    """
    if isinstance(demand, (str, TrafficSpec)):
        spec = as_spec(demand)
        return spec.batch(g, samples=samples), spec.describe()
    d = np.asarray(demand, np.float64)
    if d.ndim == 2:
        d = d[None]
    if d.ndim != 3 or d.shape[-2:] != (g.n, g.n):
        raise ValueError(f"demand shape {d.shape} does not match "
                         f"(S, {g.n}, {g.n})")
    if samples is not None and len(d) not in (1, int(samples)):
        raise ValueError(f"demand batch has {len(d)} samples, wanted "
                         f"{samples}")
    return d, f"matrix[{len(d)}]"


def _dist_mult(adj, use_kernel: bool, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Batched) dist (float32) + multiplicity (float64) device tensors.

    ``adj`` is a {0,1} adjacency (stack): a tensor on its device, or host
    numpy, uploaded to ``device`` as uint8. The kernel path runs the
    wavefront (`analysis.wavefront.wavefront_dist_mult_device`); the
    oracle is the JAX package's level sweep with float64 products (the
    frontier kept in float32, as it keeps it) on the same device.
    """
    from ..analysis.wavefront import (resolve_device,
                                      wavefront_dist_mult_device)
    from ..resilience.degradation import _upload_masks

    if not torch.is_tensor(adj):
        adj = _upload_masks(adj, resolve_device(device))
    adj = adj.float()
    if use_kernel:
        dist, mult = wavefront_dist_mult_device(adj)
        return dist, mult.to(_F64)
    batched = adj.ndim == 3
    a = adj if batched else adj[None]
    a64 = a.to(_F64)
    p = a.shape[-1]
    eye = torch.eye(p, dtype=torch.bool, device=a.device).expand(a.shape)
    dist = torch.where(eye, 0.0, float("inf")).float()
    mult = eye.to(_F64)
    frontier = eye.float()
    for level in range(1, p + 1):
        x = frontier.to(_F64) @ a64
        new = (x > 0) & ~torch.isfinite(dist)
        if not bool(new.any()):
            break
        dist.masked_fill_(new, level)
        mult = torch.where(new, x, mult)
        frontier = torch.where(new, x, 0.0).float()
    return (dist, mult) if batched else (dist[0], mult[0])


def _traffic_metrics(loads: torch.Tensor, dist: torch.Tensor,
                     demand: torch.Tensor, demand_host: np.ndarray,
                     n_links: int, capacity: float
                     ) -> Dict[str, torch.Tensor]:
    """Per-sample congestion metrics from (C, n, n) loads and (1|C, n, n)
    dist and demand (``demand`` on the card, ``demand_host`` its host
    copy). Returns (C,) float64 device tensors."""
    from ..resilience.degradation import (_div, _masked_mean,
                                          _masked_percentiles, _routed_total)

    s, n, _ = loads.shape
    dev = loads.device
    idx = np.arange(n)
    offered = demand_host
    if offered[:, idx, idx].any():                 # self-demand never routes
        offered = offered.copy()
        offered[:, idx, idx] = 0.0
    off = torch.isfinite(dist) & (dist > 0)
    total, routed_sum = _routed_total(offered, off)
    dropped = np.where(total > 0,
                       1.0 - routed_sum / np.maximum(total, 1e-300), 0.0)
    total, routed_sum, dropped = (torch.from_numpy(x).to(dev)
                                  for x in (total, routed_sum, dropped))
    peak = loads.reshape(s, -1).amax(1).to(_F64)
    tput = torch.where((routed_sum > 0) & (peak > 0),
                       _div(capacity, peak.clamp(min=1e-300)), 0.0)
    pos = loads > 0
    p50, p90, p99 = _masked_percentiles(loads, pos, (0.5, 0.9, 0.99))
    # off excludes the diagonal, so the offered demand's zeroed diagonal
    # never enters the routed hops
    hops = torch.where(off, demand.to(_F64) * dist.to(_F64),
                       0.0).expand(s, n, n).reshape(s, -1).sum(1)
    return {
        "max_link_load": peak,
        "tput_lb": tput,
        "mean_link_load": _masked_mean(loads, pos),
        "p50_link_load": p50,
        "p90_link_load": p90,
        "p99_link_load": p99,
        "links_used_frac": _div(pos.reshape(s, -1).sum(1), max(n_links, 1)),
        "avg_hops": torch.where(routed_sum > 0,
                                _div(hops, routed_sum.clamp(min=1e-300)),
                                0.0),
        "demand_total": total,
        "dropped_demand_frac": dropped,
    }


def evaluate_traffic_batch(g: Graph, demand: DemandLike,
                           dist=None, mult=None, use_kernel: bool = True,
                           mask_chunk: Optional[int] = None,
                           capacity: float = 1.0,
                           device="cuda") -> Dict[str, np.ndarray]:
    """Per-matrix congestion metrics over the *unfailed* graph.

    Returns ``{metric: (S,) float64 array}`` for TRAFFIC_METRICS. The
    whole batch runs in stacked passes of at most ``mask_chunk`` matrices
    (auto-sized from the resilience working-set budget when None); the
    routing state (``dist``/``mult``) is computed once — pass precomputed
    ``(n, n)`` arrays or tensors (e.g. a sweep's device slices, which keep
    their device) to skip even that.
    """
    from ..resilience.degradation import _auto_chunk, _to_host
    from ..routing.assign import (_adjacency, _device_of, _on,
                                  ecmp_demand_loads)

    batch, label = demand_batch(g, demand)
    s, n = len(batch), g.n
    dev = _device_of(dist, mult, device=device)
    adj = _adjacency(g, dev)
    if dist is None or mult is None:
        dist, mult = _dist_mult(adj, use_kernel)
    else:
        dist, mult = _on(dist, dev), _on(mult, dev, _F64)
    if mask_chunk is None:
        mask_chunk = _auto_chunk(n, s)
    parts = []
    with obs.span("traffic.scenario", cat="traffic", demand=label,
                  samples=s, routers=n, mask_chunk=mask_chunk) as sp:
        for lo in range(0, s, mask_chunk):
            d_h = batch[lo:lo + mask_chunk]
            d = _on(d_h, dev)
            loads = ecmp_demand_loads(dist, mult, adj, d,
                                      use_kernel=use_kernel)
            parts.append(_traffic_metrics(loads, dist[None], d, d_h,
                                          2 * len(g.edges), capacity))
            del loads, d
        out = _to_host(parts)
        sp.set(passes=len(parts),
               max_link_load=float(out["max_link_load"].max()),
               dropped=float(out["dropped_demand_frac"].mean()))
    return out


def evaluate_traffic_failure_batch(
        g: Graph, demand: DemandLike, adjacency, dist=None, mult=None,
        use_kernel: bool = True, mask_chunk: Optional[int] = None,
        capacity: float = 1.0, device="cuda") -> Dict[str, np.ndarray]:
    """Traffic metrics over a stacked *masked* adjacency batch.

    The traffic x failure grid cell engine: ``adjacency`` is a
    ``(S, n, n)`` failure-masked stack (`resilience.faults.FailureBatch
    .adjacency`, uploaded per chunk as uint8, or a tensor already on its
    device), demand sample ``i`` rides failure mask ``i`` (a single matrix
    broadcasts on the card). Per chunk, the batched wavefront recomputes
    dist/mult on the masked graphs (unless ``dist``/``mult`` stacks are
    given), then one demand-weighted Brandes pass produces the loads. Adds
    ``reachable_frac`` to TRAFFIC_METRICS.
    """
    from ..resilience.degradation import _auto_chunk, _to_host, _upload_masks
    from ..routing.assign import _device_of, _on

    dev = _device_of(adjacency, dist, mult, device=device)
    s, n = len(adjacency), g.n
    batch, label = demand_batch(g, demand)
    if len(batch) not in (1, s):
        raise ValueError(f"{len(batch)} demand samples cannot pair with "
                         f"{s} failure masks")
    if mask_chunk is None:
        mask_chunk = _auto_chunk(n, s)
    parts = []
    with obs.span("traffic.cell", cat="traffic", demand=label, samples=s,
                  routers=n, mask_chunk=mask_chunk) as sp:
        for lo in range(0, s, mask_chunk):
            a = adjacency[lo:lo + mask_chunk]
            a = (a.to(dev).float() if torch.is_tensor(a)
                 else _upload_masks(a, dev))
            d = batch if len(batch) == 1 else batch[lo:lo + mask_chunk]
            if dist is None or mult is None:
                cd, cm = _dist_mult(a, use_kernel)
            else:
                cd = _on(dist[lo:lo + mask_chunk], dev)
                cm = _on(mult[lo:lo + mask_chunk], dev, _F64)
            parts.append(_chunk_cell(g, a, d, cd, cm, use_kernel, capacity))
            del a, cd, cm
        out = _to_host(parts)
        sp.set(passes=len(parts),
               dropped=float(out["dropped_demand_frac"].mean()))
    return out


def _chunk_cell(g: Graph, adj: torch.Tensor, demand: np.ndarray,
                dist: torch.Tensor, mult: torch.Tensor, use_kernel: bool,
                capacity: float) -> Dict[str, torch.Tensor]:
    from ..resilience.degradation import _div
    from ..routing.assign import _on, ecmp_demand_loads

    d = _on(demand, adj.device)
    loads = ecmp_demand_loads(dist, mult, adj, d, use_kernel=use_kernel)
    out = _traffic_metrics(loads, dist, d, demand, 2 * len(g.edges),
                           capacity)
    c, n = len(adj), g.n
    off = torch.isfinite(dist) & (dist > 0)
    out["reachable_frac"] = _div(off.reshape(c, -1).sum(1),
                                 max(n * (n - 1), 1))
    return out


def saturation_search(g: Graph, spec: Union[str, TrafficSpec],
                      capacity: float = 1.0, hi: Optional[float] = None,
                      rounds: int = 5, grid: int = 9,
                      samples: Optional[int] = None, use_kernel: bool = True,
                      mask_chunk: Optional[int] = None,
                      device="cuda") -> Dict:
    """Max sustainable injection rate before the peak link saturates.

    Bisection on the per-router injection rate, batched across the rate
    grid: every refinement round stacks ``grid`` candidate rates x all
    demand samples into ONE batched load pass and contracts the bracket
    around the largest rate whose worst-sample peak load stays within
    ``capacity`` (the network_tester "max sustainable injection" sweep).
    The unit batch goes up once; each round's ``rates x unit`` stack is
    built on the card (one correctly rounded float64 product per element,
    as on the host).

    Returns ``{"sat_rate", "ci95", "per_sample", "rounds", "probe_rate",
    "peak_at_probe"}`` — ``sat_rate`` is the bisected worst-sample rate;
    ``per_sample`` the exact per-sample crossings ``probe_rate * capacity
    / peak`` (load is homogeneous in rate for every registered pattern)
    with a bootstrap 95% CI. Demand that routes nothing anywhere raises.
    """
    from ..analysis.estimator import bootstrap_ci
    from ..analysis.wavefront import resolve_device
    from ..resilience.degradation import _auto_chunk
    from ..routing.assign import _adjacency, _on, ecmp_demand_loads

    dev = resolve_device(device)
    spec = as_spec(spec)
    base, label = demand_batch(g, spec)
    s, n = len(base), g.n
    adj = _adjacency(g, dev)
    dist, mult = _dist_mult(adj, use_kernel)
    if mask_chunk is None:
        mask_chunk = _auto_chunk(n, s * max(int(grid), 2))

    def peaks_for(stack: torch.Tensor) -> np.ndarray:
        out = []
        for lo in range(0, len(stack), mask_chunk):
            loads = ecmp_demand_loads(dist, mult, adj,
                                      stack[lo:lo + mask_chunk],
                                      use_kernel=use_kernel)
            out.append(loads.reshape(len(loads), -1).amax(1).to(_F64))
            del loads
        return torch.cat(out).cpu().numpy()

    with obs.span("traffic.saturation", cat="traffic", demand=label,
                  samples=s, routers=n, rounds=rounds, grid=grid) as sp:
        base_d = _on(base, dev)
        probe = float(spec.rate) if spec.rate > 0 else 1.0
        peak0 = peaks_for(base_d * (probe / spec.rate if spec.rate > 0
                                    else 1.0))
        if not (peak0 > 0).any():
            raise ValueError(f"{label}: no demand routes on {g.name}; "
                             f"cannot saturate")
        per_sample = np.where(peak0 > 0,
                              probe * capacity / np.maximum(peak0, 1e-300),
                              np.inf)
        finite = per_sample[np.isfinite(per_sample)]
        lo_r, hi_r = 0.0, float(hi) if hi else 2.0 * float(finite.max())
        history = []
        # the unit batch divides on the host, as numpy divides (a scalar
        # divisor on the card is a product by its reciprocal)
        unit = _on(base / probe, dev) if spec.rate > 0 else base_d
        del base_d
        for _ in range(int(rounds)):
            rates = np.linspace(lo_r, hi_r, int(grid))
            stack = (torch.from_numpy(rates).to(dev)[:, None, None, None]
                     * unit[None]).reshape(-1, n, n)
            peaks = peaks_for(stack).reshape(len(rates), s)
            del stack
            worst = peaks.max(axis=1)
            ok = worst <= capacity + 1e-12
            history.append({"lo": lo_r, "hi": hi_r,
                            "feasible": int(ok.sum())})
            if ok.all():
                lo_r = float(rates[-1])
                hi_r *= 2.0
                continue
            last = int(np.flatnonzero(ok)[-1]) if ok.any() else 0
            lo_r = float(rates[last])
            hi_r = float(rates[min(last + 1, len(rates) - 1)])
        point, ci_lo, ci_hi = bootstrap_ci(finite, seed=spec.seed)
        sp.set(sat_rate=lo_r)
        return {
            "demand": label,
            "capacity": float(capacity),
            "sat_rate": lo_r,
            "per_sample_mean": float(point),
            "ci95": [float(ci_lo), float(ci_hi)],
            "per_sample": [float(v) for v in per_sample],
            "probe_rate": probe,
            "peak_at_probe": [float(v) for v in peak0],
            "rounds": history,
        }

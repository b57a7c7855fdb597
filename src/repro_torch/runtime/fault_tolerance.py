"""Fault-tolerant training runtime: restart, stragglers, elastic re-mesh.

A copy of the JAX package's ``runtime/fault_tolerance.py`` (pure Python and
numpy, no JAX).

Design for 1000+ nodes (DESIGN.md §6):

* **Checkpoint/restart** — synchronous sharded checkpoint every
  `ckpt_every` steps (atomic commit via `checkpoint.manager`); on any crash
  the driver restarts, restores the latest committed step, and the
  counter-based data pipeline seeks to the exact stream position (no replay
  buffer needed).
* **Straggler mitigation** — a per-step heartbeat records step latencies;
  hosts slower than `straggler_factor` x the trailing median for
  `straggler_patience` consecutive steps are reported to the elastic policy
  (on real fleets this feeds the scheduler; here the hook is exercised by
  fault-injection tests).
* **Elastic re-mesh** — when the healthy-host set shrinks (e.g. a pod is
  lost), `ElasticPolicy.remesh` picks the largest feasible mesh from the
  survivor count, and the runtime restores the latest checkpoint under the
  new mesh's shardings (the checkpoint format is mesh-agnostic).

The control logic is deliberately pure-Python and unit-testable: hardware
events enter through `HealthTracker.observe`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["HealthTracker", "ElasticPolicy", "TrainLoopRunner", "StepEvent"]


@dataclasses.dataclass
class StepEvent:
    step: int
    host: int
    seconds: float
    ok: bool = True


class HealthTracker:
    """Ingests per-host step latencies; flags stragglers and failures."""

    def __init__(self, n_hosts: int, straggler_factor: float = 2.0,
                 patience: int = 3, window: int = 32):
        self.n_hosts = n_hosts
        self.factor = straggler_factor
        self.patience = patience
        self.window = window
        self._lat: Dict[int, List[float]] = {h: [] for h in range(n_hosts)}
        self._slow_streak: Dict[int, int] = {h: 0 for h in range(n_hosts)}
        self.failed: set = set()

    def observe(self, ev: StepEvent):
        if not ev.ok:
            self.failed.add(ev.host)
            return
        lat = self._lat[ev.host]
        lat.append(ev.seconds)
        if len(lat) > self.window:
            lat.pop(0)

    def stragglers(self) -> List[int]:
        all_lat = [hist[-1] for hist in self._lat.values() if hist]
        if len(all_lat) < max(2, self.n_hosts // 2):
            return []
        med = float(np.median(all_lat))
        out = []
        for h, hist in self._lat.items():
            if h in self.failed or not hist:
                continue
            if hist[-1] > self.factor * med:
                self._slow_streak[h] += 1
            else:
                self._slow_streak[h] = 0
            if self._slow_streak[h] >= self.patience:
                out.append(h)
        return out

    def healthy_hosts(self) -> int:
        return self.n_hosts - len(self.failed)


@dataclasses.dataclass
class ElasticPolicy:
    """Choose a mesh for the current healthy-host count.

    feasible_meshes: ordered largest-first [(n_hosts_required, mesh_kwargs)].
    The default ladder degrades 2 pods -> 1 pod (and lets tests use tiny
    meshes).
    """

    feasible_meshes: Sequence[Tuple[int, Dict]] = (
        (512, {"multi_pod": True}),
        (256, {"multi_pod": False}),
    )

    def remesh(self, healthy: int) -> Optional[Dict]:
        for need, kwargs in self.feasible_meshes:
            if healthy >= need:
                return dict(kwargs)
        return None


class TrainLoopRunner:
    """Restartable training driver.

    Collaborators are injected so the loop is testable without hardware:
      build(mesh_kwargs)   -> (state, step_fn, data_iter_factory)
      save_fn(step, state) / restore_fn(mesh_kwargs) -> (state, step) | None
    Fault injection: `fault_hook(step)` may raise or return StepEvents.
    """

    def __init__(self, build: Callable, save_fn: Callable,
                 restore_fn: Callable, ckpt_every: int = 50,
                 policy: Optional[ElasticPolicy] = None,
                 tracker: Optional[HealthTracker] = None,
                 max_restarts: int = 8):
        self.build = build
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.ckpt_every = ckpt_every
        self.policy = policy or ElasticPolicy()
        self.tracker = tracker or HealthTracker(n_hosts=1)
        self.max_restarts = max_restarts
        self.restarts = 0
        self.remesh_events: List[Dict] = []

    def run(self, total_steps: int, fault_hook: Optional[Callable] = None,
            mesh_kwargs: Optional[Dict] = None) -> Dict:
        mesh_kwargs = mesh_kwargs or {}
        while True:
            try:
                return self._run_once(total_steps, fault_hook, mesh_kwargs)
            except RuntimeError as e:  # simulated hardware failure
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                healthy = self.tracker.healthy_hosts()
                new_mesh = self.policy.remesh(healthy)
                if new_mesh is None:
                    raise RuntimeError(
                        f"not enough healthy hosts ({healthy}) for any mesh"
                    ) from e
                if new_mesh != mesh_kwargs:
                    self.remesh_events.append(
                        {"healthy": healthy, "mesh": dict(new_mesh)})
                mesh_kwargs = new_mesh

    def _run_once(self, total_steps, fault_hook, mesh_kwargs) -> Dict:
        restored = self.restore_fn(mesh_kwargs)
        state, step_fn, data_at = self.build(mesh_kwargs)
        start = 0
        if restored is not None:
            state, start = restored
        metrics = {}
        for step in range(start, total_steps):
            t0 = time.time()
            if fault_hook is not None:
                fault_hook(step, self.tracker)
            batch = data_at(step)
            state, metrics = step_fn(state, batch)
            self.tracker.observe(StepEvent(step, host=0, seconds=time.time() - t0))
            if (step + 1) % self.ckpt_every == 0 or step + 1 == total_steps:
                self.save_fn(step + 1, state)
        return {"state": state, "metrics": metrics, "steps": total_steps,
                "restarts": self.restarts, "remesh_events": self.remesh_events}

"""Vectorized fault injection: severity-nested failure plans -> mask batches.

A copy of ``repro.core.resilience.faults`` for ``repro_torch``: host numpy,
seeded the same way, so every plan and batch is bit-equal to the JAX
package's. The engines (`resilience.degradation`, `traffic.grid`) upload
each batch to the card as uint8.

The resilience engine never loops over failure scenarios in Python. A
:class:`FailurePlan` draws, per sample, one *permutation* of the failable
units (links, routers, or correlated cable bundles); severity ``k`` of
sample ``s`` fails exactly the first ``k`` units of ``plan.order[s]``.
Because higher severities are supersets of lower ones *within each
sample*, per-sample degradation metrics are well-defined monotone
functions of ``k`` — the property the invariant tests pin down — while
across samples the prefixes are independent uniform draws, so severity-k
batches are still uniform k-subsets.

:func:`failure_batch` materializes one severity level as a stacked
``(S, n, n)`` adjacency batch plus per-sample alive/edge masks; the whole
stack then goes through the batched wavefront/ECMP engines in ONE device
pass per severity (`resilience.degradation`).

Failure kinds
-------------
``link``      units are the E undirected cables (both directions die).
``router``    units are the n routers (every incident cable dies; the
              router stays a vertex, so its pairs count as disconnected).
``cable``     correlated failures: units are *bundles* of cables sharing a
              cable class (conduit/tray model). The PR 3 link inventory is
              aggregate — edge canonicalization does not preserve per-edge
              attribution — so bundles use the documented deterministic
              attribution of :func:`edge_class_labels`: canonical edge
              order is partitioned into the spec's classes by their
              inventory counts, then each class is cut into bundles of
              ``bundle_size`` consecutive edges. One failed unit kills its
              whole bundle.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..graph import Graph

__all__ = ["FailurePlan", "FailureBatch", "failure_plan", "failure_batch",
           "edge_class_labels", "rate_to_k"]

KINDS = ("link", "router", "cable")


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    """S severity-nested failure scenarios for one base topology.

    ``order[s]`` is a uniform random permutation of the ``n_units``
    failable unit ids; severity ``k`` fails ``order[s, :k]``. ``unit_edges``
    maps unit id -> member edge ids (identity for ``link``, incident edges
    for ``router``, bundle members for ``cable``) as a CSR-style
    (indptr, edge_ids) pair so batch construction stays fully vectorized.
    """

    kind: str
    graph: Graph
    order: np.ndarray                  # (S, n_units) int64
    unit_indptr: np.ndarray            # (n_units + 1,) int64
    unit_edge_ids: np.ndarray          # (sum of unit sizes,) int64
    seed: int

    @property
    def samples(self) -> int:
        return self.order.shape[0]

    @property
    def n_units(self) -> int:
        return self.order.shape[1]


@dataclasses.dataclass(frozen=True)
class FailureBatch:
    """One severity level materialized: S failure masks over one topology.

    ``adjacency`` is the stacked ``(S, n, n)`` float32 batch (base
    adjacency with both orientations of every failed edge zeroed) ready
    for the batched device engines; ``alive`` marks surviving routers
    (all-true except under ``router`` failures); ``edge_failed`` marks the
    failed undirected edges in ``graph.edges`` order.
    """

    kind: str
    k: int
    adjacency: np.ndarray              # (S, n, n) float32
    alive: np.ndarray                  # (S, n) bool
    edge_failed: np.ndarray            # (S, E) bool
    seed: int

    @property
    def samples(self) -> int:
        return self.adjacency.shape[0]


def edge_class_labels(g: Graph) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Deterministic cable-class attribution: (E,) labels + class names.

    The spec's link inventory (`topology.spec.LinkClass`) is aggregate —
    counts per class summing to E — because edge arrays are canonicalized
    (sorted, deduplicated) at construction, so per-edge attribution cannot
    survive. The resilience engine therefore *defines* the attribution:
    edges in canonical order are assigned to classes in inventory order,
    ``counts[0]`` edges to class 0, the next ``counts[1]`` to class 1, and
    so on. This is deterministic, reproducible, and respects the class
    cardinalities; it is a model of shared-conduit locality, not a claim
    about which physical cable each canonical edge is.

    Raises KeyError when the graph carries no TopologySpec.
    """
    classes = g.link_classes()           # raises KeyError without a spec
    counts = np.array([lc.count for lc in classes], np.int64)
    if counts.sum() != len(g.edges):
        raise ValueError(
            f"{g.name}: link inventory covers {int(counts.sum())} cables, "
            f"graph has {len(g.edges)} edges")
    labels = np.repeat(np.arange(len(classes)), counts)
    return labels, tuple(lc.name for lc in classes)


def _unit_map(g: Graph, kind: str, bundle_size: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr, edge_ids) CSR of unit -> member undirected edge ids."""
    e = len(g.edges)
    if kind == "link":
        indptr = np.arange(e + 1, dtype=np.int64)
        return indptr, np.arange(e, dtype=np.int64)
    if kind == "router":
        # incident edges per router: each undirected edge appears under
        # both endpoints
        owners = np.concatenate([g.edges[:, 0], g.edges[:, 1]])
        eids = np.tile(np.arange(e, dtype=np.int64), 2)
        order = np.argsort(owners, kind="stable")
        counts = np.bincount(owners, minlength=g.n)
        indptr = np.zeros(g.n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, eids[order]
    if kind == "cable":
        labels, _ = edge_class_labels(g)
        if bundle_size < 1:
            raise ValueError("bundle_size must be >= 1")
        # consecutive edges of one class share a bundle; classes never mix
        order = np.argsort(labels, kind="stable")   # canonical order kept
        sorted_labels = labels[order]
        # rank within class
        starts = np.flatnonzero(np.r_[True, np.diff(sorted_labels) != 0])
        rank = np.arange(e) - np.repeat(
            starts, np.diff(np.r_[starts, e]))
        # bundle id = (class, rank // bundle_size) densified
        keys = sorted_labels * (e + 1) + rank // bundle_size
        _, bundle = np.unique(keys, return_inverse=True)
        n_units = int(bundle.max()) + 1 if e else 0
        counts = np.bincount(bundle, minlength=n_units)
        indptr = np.zeros(n_units + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        by_bundle = np.argsort(bundle, kind="stable")
        return indptr, order[by_bundle].astype(np.int64)
    raise ValueError(f"unknown failure kind {kind!r}; known: {KINDS}")


def failure_plan(g: Graph, kind: str = "link", samples: int = 100,
                 seed: int = 0, bundle_size: int = 8) -> FailurePlan:
    """Draw ``samples`` severity-nested failure scenarios.

    One vectorized call: all S unit permutations come out of a single
    ``rng.permuted`` over an (S, n_units) index tile — no per-sample
    Python loop. ``bundle_size`` only applies to ``kind="cable"``.
    """
    if samples < 1:
        raise ValueError("samples must be >= 1")
    indptr, eids = _unit_map(g, kind, bundle_size)
    n_units = len(indptr) - 1
    if n_units == 0:
        raise ValueError(f"{g.name}: no failable units for kind {kind!r}")
    rng = np.random.default_rng(seed)
    base = np.broadcast_to(np.arange(n_units, dtype=np.int64),
                           (samples, n_units))
    order = rng.permuted(base, axis=1)
    return FailurePlan(kind=kind, graph=g, order=order, unit_indptr=indptr,
                       unit_edge_ids=eids, seed=seed)


def rate_to_k(plan: FailurePlan, rate: float) -> int:
    """Failure rate (fraction of units) -> unit count, clamped to [0, U]."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"failure rate must be in [0, 1], got {rate}")
    return min(plan.n_units, int(round(rate * plan.n_units)))


def failure_batch(plan: FailurePlan, k: int) -> FailureBatch:
    """Materialize severity ``k``: the stacked (S, n, n) adjacency batch.

    Fully vectorized: the failed-unit prefix ``order[:, :k]`` scatters
    into an (S, U) unit mask, expands through the unit->edge CSR to the
    (S, E) edge mask, and both orientations of every failed edge are
    zeroed with one fancy-indexed store each. Symmetry of each sample's
    adjacency is preserved by construction.
    """
    g = plan.graph
    s, u = plan.order.shape
    if not 0 <= k <= u:
        raise ValueError(f"severity k={k} outside [0, {u}]")
    base = g.adjacency_dense(np.float32)
    adj = np.broadcast_to(base, (s,) + base.shape).copy()
    alive = np.ones((s, g.n), bool)
    edge_failed = np.zeros((s, len(g.edges)), bool)
    if k:
        failed_units = plan.order[:, :k]                       # (S, k)
        rows = np.repeat(np.arange(s), k)
        if plan.kind == "router":
            alive[rows, failed_units.ravel()] = False
        unit_mask = np.zeros((s, u), bool)
        unit_mask[rows, failed_units.ravel()] = True
        # CSR expansion: edge e of unit j fails in sample s iff
        # unit_mask[s, j]; one gather per member slot
        sizes = np.diff(plan.unit_indptr)
        owner = np.repeat(np.arange(u), sizes)                 # slot -> unit
        member_failed = unit_mask[:, owner]                    # (S, slots)
        sr, slot = np.nonzero(member_failed)
        eids = plan.unit_edge_ids[slot]
        uu, vv = g.edges[eids, 0], g.edges[eids, 1]
        edge_failed[sr, eids] = True
        adj[sr, uu, vv] = 0.0
        adj[sr, vv, uu] = 0.0
    return FailureBatch(kind=plan.kind, k=int(k), adjacency=adj,
                        alive=alive, edge_failed=edge_failed,
                        seed=plan.seed)

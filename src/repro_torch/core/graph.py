"""Router-level interconnect graph.

The EvalNet modelling convention: a vertex is a *router* (L2 switch or L3
router), an edge is a full-duplex inter-router link, and *servers are implicit*
— each router hosts ``concentration`` servers. This is what makes
million-server analysis cheap: a 1M-server Slim Fly is ~6k routers.

Generation is numpy (cheap, sequential); analysis lifts blocks into torch
tensors on the card.

:func:`graph_from_arrays` rebuilds a graph, spec included, from plain
arrays and a dict, so one instance can be handed between packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["Graph", "graph_from_arrays"]


@dataclasses.dataclass
class Graph:
    """An undirected multigraph-free interconnect graph.

    Attributes:
      n: number of routers.
      edges: (E, 2) int64 array of undirected edges, canonicalized u < v,
        deduplicated, no self loops.
      concentration: servers attached per router (implicit endpoints).
      name: human-readable identifier, e.g. ``slimfly(q=17)``.
      meta: free-form generator metadata (parameters, expected diameter, ...).
    """

    n: int
    edges: np.ndarray
    concentration: int = 0
    name: str = "graph"
    meta: Dict = dataclasses.field(default_factory=dict)

    # -- caches (not part of equality) ------------------------------------
    _csr: Optional[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __post_init__(self):
        e = np.asarray(self.edges, dtype=np.int64)
        if e.size == 0:
            e = e.reshape(0, 2)
        if e.ndim != 2 or e.shape[1] != 2:
            raise ValueError(f"edges must be (E, 2), got {e.shape}")
        if (e < 0).any() or (e >= self.n).any():
            raise ValueError("edge endpoint out of range")
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        keep = lo != hi  # drop self loops
        e = np.stack([lo[keep], hi[keep]], axis=1)
        e = np.unique(e, axis=0)
        self.edges = e

    # -- basic facts -------------------------------------------------------
    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def num_servers(self) -> int:
        if "num_servers" in self.meta:  # non-uniform concentration (fat tree)
            return int(self.meta["num_servers"])
        return self.n * self.concentration

    def degrees(self) -> np.ndarray:
        d = np.zeros(self.n, dtype=np.int64)
        np.add.at(d, self.edges[:, 0], 1)
        np.add.at(d, self.edges[:, 1], 1)
        return d

    @property
    def network_radix(self) -> int:
        """Max inter-router ports used on any router."""
        return int(self.degrees().max(initial=0))

    @property
    def radix(self) -> int:
        """Full router radix: network ports + server ports."""
        return self.network_radix + self.concentration

    # -- spec / link inventory --------------------------------------------
    @property
    def spec(self):
        """The generator's TopologySpec (``meta["spec"]``), or None for
        graphs built outside the registry."""
        return self.meta.get("spec")

    def link_classes(self):
        """Link inventory by cable class (from the attached spec).

        Edge arrays are canonicalized (sorted/deduplicated) at construction,
        so per-edge attributes cannot survive; the inventory is therefore
        aggregate — (name, count, length_m, medium) per class, counts
        summing to ``num_edges`` — which is all the cost/power models need.
        Raises KeyError when no spec is attached.
        """
        s = self.spec
        if s is None:
            raise KeyError(f"{self.name}: no TopologySpec in meta")
        return s.link_classes

    # -- representations ---------------------------------------------------
    def csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """Symmetric CSR (indptr, indices) over both edge directions."""
        if self._csr is None:
            src = np.concatenate([self.edges[:, 0], self.edges[:, 1]])
            dst = np.concatenate([self.edges[:, 1], self.edges[:, 0]])
            order = np.argsort(src, kind="stable")
            src, dst = src[order], dst[order]
            indptr = np.zeros(self.n + 1, dtype=np.int64)
            np.add.at(indptr, src + 1, 1)
            indptr = np.cumsum(indptr)
            self._csr = (indptr, dst)
        return self._csr

    def adjacency_dense(self, dtype=np.float32) -> np.ndarray:
        """Dense symmetric adjacency. Only sensible for n ≲ 50k routers."""
        a = np.zeros((self.n, self.n), dtype=dtype)
        a[self.edges[:, 0], self.edges[:, 1]] = 1
        a[self.edges[:, 1], self.edges[:, 0]] = 1
        return a

    def distance_seed(self, inf=np.float32(np.inf)) -> np.ndarray:
        """Initial min-plus distance matrix: 0 diag, 1 on edges, inf else."""
        d = np.full((self.n, self.n), inf, dtype=np.float32)
        np.fill_diagonal(d, 0.0)
        d[self.edges[:, 0], self.edges[:, 1]] = 1.0
        d[self.edges[:, 1], self.edges[:, 0]] = 1.0
        return d

    def is_connected(self) -> bool:
        if self.n == 0:
            return True
        indptr, indices = self.csr()
        seen = np.zeros(self.n, dtype=bool)
        frontier = np.array([0], dtype=np.int64)
        seen[0] = True
        while frontier.size:
            nxt = np.concatenate(
                [indices[indptr[u]:indptr[u + 1]] for u in frontier]
            ) if frontier.size < 1024 else indices[
                np.concatenate([np.arange(indptr[u], indptr[u + 1]) for u in frontier])
            ]
            nxt = np.unique(nxt)
            nxt = nxt[~seen[nxt]]
            seen[nxt] = True
            frontier = nxt
        return bool(seen.all())

    def validate(self) -> "Graph":
        """Raise on structural problems; return self for chaining."""
        if self.n <= 0:
            raise ValueError("empty graph")
        d = self.degrees()
        if self.num_edges and d.max() == 0:
            raise ValueError("degree bookkeeping broken")
        if not self.is_connected():
            raise ValueError(f"{self.name}: graph is not connected")
        return self

    def summary(self) -> Dict:
        d = self.degrees()
        return {
            "name": self.name,
            "routers": self.n,
            "edges": self.num_edges,
            "servers": self.num_servers,
            "concentration": self.concentration,
            "min_degree": int(d.min()) if self.n else 0,
            "max_degree": int(d.max()) if self.n else 0,
            "avg_degree": float(d.mean()) if self.n else 0.0,
        }


def graph_from_arrays(n: int, edges, concentration: int, name: str,
                      spec_fields: Optional[Dict] = None) -> Graph:
    """Build a :class:`Graph` from plain arrays and a dict of spec fields.

    ``spec_fields`` holds the :class:`~.topology.spec.TopologySpec` fields
    as plain values (``link_classes`` as a list of dicts of the
    :class:`~.topology.spec.LinkClass` fields, ``radix_counts`` as pairs);
    the rebuilt spec lands in ``meta["spec"]``. Families whose servers do not
    hang off every router uniformly keep their count in
    ``meta["num_servers"]``, as their generators do.
    """
    g = Graph(n=int(n), edges=np.asarray(edges, np.int64),
              concentration=int(concentration), name=str(name))
    if spec_fields is not None:
        from .topology.spec import LinkClass, TopologySpec

        f = dict(spec_fields)
        f["params"] = dict(f["params"])
        f["link_classes"] = tuple(LinkClass(**lc) for lc in f["link_classes"])
        f["radix_counts"] = tuple(
            (int(r), int(c)) for r, c in f.get("radix_counts", ()))
        spec = TopologySpec(**f)
        g.meta["spec"] = spec
        if spec.n_servers != g.n * g.concentration:
            g.meta["num_servers"] = spec.n_servers
    return g

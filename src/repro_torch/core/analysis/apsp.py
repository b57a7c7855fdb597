"""All-pairs shortest paths and batched BFS.

Two regimes:

* dense device-resident analysis for router counts that fit a dense matrix —
  hop-distance APSP runs the wavefront engine
  (`wavefront.wavefront_dist_mult_device`: one fused counting product per
  BFS level); min-plus squaring (D_{2l} = D_l (x) D_l) stays as the
  weighted-APSP path (`apsp_from_lengths`) and as the tropical oracle for
  the wavefront.
* frontier BFS over CSR (numpy, batched multi-source) from sampled sources
  for very large graphs — the classic toolchain path, used as oracle and
  for n > dense_limit.

The dense functions return torch tensors on the chosen device; the BFS
functions are numpy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph import Graph
from .wavefront import resolve_device, squaring_apsp_device

__all__ = ["apsp_dense", "apsp_from_lengths", "bfs_distances",
           "sampled_distances"]

#: cap on the flattened CSR-span transient in the batched BFS (entries per
#: chunk; one chunk is never smaller than one full adjacency, 2E)
_SPAN_BUDGET = 1 << 22


def apsp_dense(g: Graph, use_kernel: bool = True, max_squarings: int = 8,
               method: Optional[str] = None, mesh=None,
               tile_rows: Optional[int] = None,
               device="cuda") -> torch.Tensor:
    """Dense APSP. Returns (n, n) float32 hop distances, inf = unreachable,
    on ``device``.

    ``method="wavefront"`` (the kernel-path default) runs the level loop —
    O(diameter) fused counting products. ``method="squaring"`` is the
    tropical min-plus squaring oracle (ceil(log2(diameter)) products); it
    is also the ``use_kernel=False`` default, running the plain product.

    ``tile_rows`` runs the out-of-core tiled engine
    (`distributed.tiled_dist_mult`: source tiles stream through the
    kernels, the adjacency is built from CSR) and copies its host result to
    ``device``. ``mesh`` (a `distributed.RowMesh`) runs the wavefront
    row-sharded over the mesh's ranks, and with ``tile_rows`` the composed
    engine (sharded adjacency rows x streamed tiles), as
    `engine_select.resolve_engine` picks them; every rank gets the whole
    result, bit-equal.
    """
    from .engine_select import resolve_engine

    dev = resolve_device(device)
    plan = resolve_engine(use_kernel=use_kernel, method=method, mesh=mesh,
                          tile_rows=tile_rows)
    if plan.engine in ("tiled", "composed"):
        from .distributed import tiled_dist_mult

        dist, _ = tiled_dist_mult(g, tile_rows=plan.tile_rows or 512,
                                  mesh=plan.mesh, device=dev)
        return torch.from_numpy(dist).to(dev)
    if plan.engine == "sharded":
        from .distributed import sharded_dist_mult

        dist, _ = sharded_dist_mult(g.adjacency_dense(np.float32),
                                    mesh=plan.mesh)
        return torch.from_numpy(dist).to(dev)
    if plan.engine == "wavefront":
        from .wavefront import wavefront_dist_mult_device

        dist, _ = wavefront_dist_mult_device(g.adjacency_dense(np.float32),
                                             device=dev)
        return dist
    # the tropical oracle; the kernels take any shape, so no padding
    return squaring_apsp_device(torch.from_numpy(g.distance_seed()).to(dev),
                                max_squarings=max_squarings,
                                use_kernel=use_kernel)


def apsp_from_lengths(lengths, use_kernel: bool = True,
                      max_squarings: Optional[int] = None,
                      device="cuda") -> torch.Tensor:
    """APSP over an arbitrary nonnegative (n, n) edge-length matrix.

    ``lengths`` (numpy or tensor) follows the `Graph.distance_seed`
    convention: 0 on the diagonal, the directed edge length at [u, v], +inf
    where there is no edge. Min-plus squaring through the tropical kernel
    (`wavefront.squaring_apsp_device`), or through its plain product with
    ``use_kernel=False``. ``max_squarings`` defaults to ceil(log2(n)),
    always enough; the loop stops at convergence. This is the weighted
    shortest-path oracle of the throughput engine.
    """
    d = torch.as_tensor(lengths, dtype=torch.float32).to(
        resolve_device(device))
    return squaring_apsp_device(d, max_squarings=max_squarings,
                                use_kernel=use_kernel)


def bfs_distances(g: Graph, sources: np.ndarray) -> np.ndarray:
    """Exact hop distances from each source via batched CSR frontier BFS.

    Returns (len(sources), n) int32 with -1 for unreachable. All sources
    sweep together: each level gathers every frontier vertex's CSR span
    with one `np.repeat`-flattened index expression and scatters the
    newly-visited mask — no per-source or per-vertex Python loops. This is
    the oracle for every invariant test and the > dense-limit path.
    """
    indptr, indices = g.csr()
    sources = np.asarray(sources, np.int64)
    ns, n = len(sources), g.n
    dist = np.full((ns, n), -1, dtype=np.int32)
    frontier = np.zeros((ns, n), dtype=bool)
    dist[np.arange(ns), sources] = 0
    frontier[np.arange(ns), sources] = True
    # bound the flattened-span transient (3 int64 arrays of this length) so
    # a wide multi-source frontier never costs sources x 2E peak memory
    span_budget = max(int(2 * g.num_edges), _SPAN_BUDGET)
    level = 0
    while frontier.any():
        level += 1
        rows, verts = np.nonzero(frontier)
        counts_all = indptr[verts + 1] - indptr[verts]
        bounds = np.searchsorted(np.cumsum(counts_all),
                                 np.arange(span_budget, counts_all.sum(),
                                           span_budget))
        new = np.zeros((ns, n), dtype=bool)
        for lo, hi in zip(np.concatenate(([0], bounds)),
                          np.concatenate((bounds, [len(verts)]))):
            if lo >= hi:
                continue
            starts, counts = indptr[verts[lo:hi]], counts_all[lo:hi]
            # flatten the chunk's CSR spans: starts[i] .. starts[i]+counts[i]
            flat = np.repeat(
                starts - np.concatenate(([0], np.cumsum(counts)[:-1])),
                counts) + np.arange(counts.sum())
            new[np.repeat(rows[lo:hi], counts), indices[flat]] = True
        new &= dist < 0
        dist[new] = level
        frontier = new
    return dist


def sampled_distances(g: Graph, n_sources: int = 64,
                      seed: int = 0) -> np.ndarray:
    """Distances from a uniform sample of sources (for huge graphs)."""
    rng = np.random.default_rng(seed)
    k = min(n_sources, g.n)
    sources = rng.choice(g.n, size=k, replace=False)
    return bfs_distances(g, sources)

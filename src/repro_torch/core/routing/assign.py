"""Flow assignment: the parts the analysis and throughput stages run.

The counting product both engines share (:func:`count_product`), the padded
CSR neighbour lists and the column sampler behind the throughput engine's
greedy successor chase, the O(diameter) Brandes accumulation of exact ECMP
loads under uniform all-pairs demand (:func:`ecmp_all_pairs_loads`) and
the directed-to-undirected load fold.

Link-load reporting convention: loads are reported *per undirected link*
in ``g.edges`` order, summing both orientations (full-duplex links, one
shared counter).

The routing models, the general demand engines and the load statistics
(the rest of ``repro.core.routing.assign`` and ``models``) are not ported
yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ...kernels import semiring as S
from ..graph import Graph

__all__ = ["count_product", "padded_neighbors", "sample_columns",
           "ecmp_all_pairs_loads", "directed_to_link_loads"]


def count_product(use_kernel: bool) -> Callable[[torch.Tensor, torch.Tensor],
                                                torch.Tensor]:
    """(+, x) matmul over tensors: the fp32 counting kernel (its plain
    version for CPU tensors), or the f64 oracle, exact to 2**53."""
    if use_kernel:
        return lambda a, b: S.count_matmul(a.float(), b.float().contiguous())
    return lambda a, b: a.double() @ b.double()


def padded_neighbors(g: Graph, with_edge_ids: bool = False):
    """CSR neighbour lists padded to (n, maxdeg) + validity mask.

    The shared representation behind every vectorized per-hop step (the
    throughput successor chase): a hop's working set is (rows, maxdeg)
    gathers instead of dense (rows, n) rows.

    With ``with_edge_ids`` a third (n, maxdeg) array maps each slot to its
    *directed* edge index (0..2E-1: id < E is the u->v orientation of
    ``g.edges[id]``, id >= E the reverse of ``g.edges[id - E]``), so per-hop
    load accumulation can scatter into an O(E) vector instead of an (n, n)
    matrix.
    """
    indptr, indices = g.csr()
    deg = np.diff(indptr)
    maxdeg = int(deg.max(initial=1))
    valid = np.arange(maxdeg)[None, :] < deg[:, None]
    nbrs = np.zeros((g.n, maxdeg), np.int64)
    nbrs[valid] = indices
    if not with_edge_ids:
        return nbrs, valid
    # csr() sorts concat(u, v) stably: CSR slot p holds directed edge
    # order[p] of the concat([u->v], [v->u]) list — the same ordering the
    # throughput engine's capacity vectors use
    order = np.argsort(np.concatenate([g.edges[:, 0], g.edges[:, 1]]),
                       kind="stable")
    eids = np.zeros((g.n, maxdeg), np.int64)
    eids[valid] = order
    return nbrs, valid, eids


def sample_columns(weights: np.ndarray, mask: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
    """Per row, draw one column index with probability ∝ ``weights``.

    ``mask`` marks the admissible columns (weights must be 0 outside it and
    every row must have at least one admissible column). Cumulative-sum
    inverse sampling; rows where float rounding pushes the draw to the
    total are repaired onto the first admissible column.
    """
    cums = np.cumsum(weights, axis=1)
    draw = rng.random(len(weights))[:, None] * cums[:, -1:]
    slot = (cums > draw).argmax(axis=1)
    bad = ~mask[np.arange(len(slot)), slot]
    if bad.any():
        slot[bad] = mask[bad].argmax(axis=1)
    return slot


def ecmp_all_pairs_loads(dist, mult, adj,
                         product: Optional[Callable] = None,
                         use_kernel: bool = True,
                         mesh=None) -> torch.Tensor:
    """Directed ECMP link loads under *uniform all-pairs* demand, O(diameter).

    Partitioned graphs are first-class: "uniform all-pairs" means 1.0 on
    every *reachable* ordered pair — unreachable pairs (and dead routers'
    rows/columns) contribute nothing to any load, never inf/NaN, because
    every level mask below is gated on finite distance.

    Brandes-style backward dependency accumulation: with
    ``Z_a[s,w] = (1 + delta[s,w]) / sigma(s,w)`` on the level set
    ``d(s,w) = a`` (delta = the summed pair dependencies of w as an
    intermediate), the level recurrences

        delta_a = F_a * (Z_{a+1} @ A)        F_a[s,v] = sigma(s,v)[d(s,v)=a]
        load   += F_a^T @ Z_{a+1}

    cost 2 counting products per BFS level. ``dist``, ``mult`` and ``adj``
    are tensors (or numpy arrays, taken to the CPU) with optional leading
    batch dimensions. The kernel-path default (``product=None,
    use_kernel=True``) runs `analysis.wavefront.ecmp_loads_device` in fp32
    on the operands' device; an explicit ``product`` (or
    ``use_kernel=False``, the f64 oracle) takes the reference loop in the
    operands' dtypes. Returns the directed (.., n, n) load tensor;
    ``1 / loads.max()`` is the exact ECMP lower bound on per-pair
    saturation throughput (capacity 1 per link direction).

    ``mesh`` (the sharded accumulation) is not ported yet: any mesh raises
    NotImplementedError.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded ECMP accumulation is not ported to repro_torch yet "
            "(ROADMAP Queue 1 item 6, extreme scale)")
    dist, mult, adj = (torch.as_tensor(x) for x in (dist, mult, adj))
    if product is None and use_kernel:
        from ..analysis.wavefront import ecmp_loads_device

        return ecmp_loads_device(dist.float(), mult.float(),
                                 adj.float().contiguous())
    if product is None:
        product = count_product(use_kernel)
    finite = torch.isfinite(dist)
    diam = int(torch.where(finite, dist, 0.0).max()) if dist.numel() else 0
    sigma_inv = torch.where(finite & (mult > 0),
                            1.0 / torch.where(mult > 0, mult, 1.0), 0.0)
    delta = torch.zeros_like(sigma_inv)
    acc = torch.zeros_like(sigma_inv)
    for a in range(diam - 1, -1, -1):
        z = torch.where(dist == a + 1, (1.0 + delta) * sigma_inv, 0.0)
        f_a = torch.where(dist == a, mult, 0.0)
        acc = acc + product(f_a.transpose(-1, -2), z)
        delta = torch.where(dist == a, mult * product(z, adj), delta)
    return adj * acc


def directed_to_link_loads(g: Graph, directed: np.ndarray) -> np.ndarray:
    """Fold an (n, n) directed load matrix onto (E,) undirected link loads."""
    u, v = g.edges[:, 0], g.edges[:, 1]
    return directed[u, v] + directed[v, u]

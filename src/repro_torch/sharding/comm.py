"""The ``shard_map`` collectives on ``torch.distributed`` subgroups.

Each collective of the JAX package's ``shard_map`` bodies runs here on the
subgroup of the named axes (``launch.mesh.Mesh.group``), with the members'
blocks in their linear order over the axes:

=====================  ==================================================
JAX                    here (autograd: the exact adjoint)
=====================  ==================================================
``psum``               `psum`: ``all_reduce(SUM)``; backward `psum`
``pmean``              `pmean`: `psum`, then ``/ n`` (as ``lax.pmean``)
``pmax``               `pmax`: ``all_reduce(MAX)``; no gradient
``all_gather(tiled)``  `all_gather`; backward the reduce-scatter (gloo
                       has none: an ``all_to_all_single`` of the chunks,
                       then this rank's sum)
``psum_scatter``       `psum_scatter`: that reduce-scatter; backward
                       `all_gather`
``all_to_all(tiled)``  `all_to_all`; backward the reverse exchange
``ppermute``           `ppermute`: ``isend`` / ``irecv``; backward the
                       inverse permutation
=====================  ==================================================

Gradients follow the partial convention: a rank's cotangents are its share
of the whole program's, which sum over the ranks to the true one. A loss
that every rank holds whole is backpropagated as ``loss / mesh.size``, and
`reduce_grads` sums each parameter's gradient over the axes its block is
replicated on. Under that convention the exact adjoints above give the
gradient of the global program, as ``jax.grad`` of a ``shard_map``
(``check_rep=False``) does.

On gloo a CUDA tensor goes through a host copy and back
(``core.analysis.distributed._collective``). Every call adds its bytes (this
rank's input) to the ``mesh.<kind>_bytes`` counter of ``obs`` (kinds
``all_reduce``, ``reduce_scatter``, ``all_gather``, ``all_to_all``,
``ppermute``), and its wall microseconds, host staging and the wait for
the peers included, to ``mesh.<kind>_us``. Inside `record_collectives`
each call also appends one ``launch.roofline.CollectiveOp`` (the dry
run's collective list; ``launch.dryrun``).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from .. import obs
from ..launch.mesh import Axes, Mesh, axes_tuple, spec_axes

__all__ = ["psum", "pmean", "pmax", "all_gather", "psum_scatter",
           "all_to_all", "ppermute", "reduce_grads", "record_collectives",
           "HLO_KINDS"]

#: the counters' kinds under the HLO names ``launch.roofline`` uses
HLO_KINDS = {"all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
             "all_gather": "all-gather", "all_to_all": "all-to-all",
             "ppermute": "collective-permute"}

_RECORDERS: list = []


class record_collectives:
    """``with record_collectives() as rec:`` appends one
    ``launch.roofline.CollectiveOp`` to ``rec.ops`` for every collective
    this rank issues inside the block: its HLO kind, this rank's result
    bytes, the group's size and mesh axes (in the mesh's order) and the
    modelled wire bytes (``roofline._wire_factor``); ``rec.operand_bytes``
    holds each call's input bytes, what ``mesh.<kind>_bytes`` adds. A
    ``ppermute`` is one entry a send, a group of two."""

    def __init__(self):
        self.ops = []
        self.operand_bytes = []

    def __enter__(self):
        _RECORDERS.append(self)
        return self

    def __exit__(self, *exc):
        _RECORDERS.remove(self)

    def by_kind(self):
        """{counter kind: summed input bytes}, the counters' own sums."""
        names = {v: k for k, v in HLO_KINDS.items()}
        out = {k: 0 for k in HLO_KINDS}
        for op, b in zip(self.ops, self.operand_bytes):
            out[names[op.kind]] += b
        return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count(kind: str, x: torch.Tensor) -> None:
    obs.counter(f"mesh.{kind}_bytes").add(_nbytes(x))


def _record(kind: str, x: torch.Tensor, result_bytes: int, mesh: Mesh,
            axes: Axes, group_size: int = 0) -> None:
    """One entry in every active `record_collectives`."""
    if not _RECORDERS:
        return
    from ..launch.roofline import CollectiveOp, _wire_factor

    names = axes_tuple(axes)
    names = tuple(a for a in mesh.axis_names if a in names)
    n = group_size or mesh.axis_size(names)
    hlo = HLO_KINDS[kind]
    op = CollectiveOp(hlo, int(result_bytes), n, names,
                      _wire_factor(hlo, n) * result_bytes)
    for rec in _RECORDERS:
        rec.ops.append(op)
        rec.operand_bytes.append(_nbytes(x))


class _timed:
    """Adds the wall microseconds of a collective (host staging and the
    wait for the peers included) to ``mesh.<kind>_us``."""

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        obs.counter(f"mesh.{self.kind}_us").add(
            int(1e6 * (time.perf_counter() - self.t0)))


def _host(x: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, bool]:
    """(the tensor a collective runs on, whether it went through the host):
    gloo has no CUDA all_gather, all_to_all, send or recv."""
    if x.device.type == "cuda" and mesh.backend == "gloo":
        return x.detach().cpu(), True
    return x.detach().contiguous(), False


def _all_reduce(x: torch.Tensor, mesh: Mesh, axes: Axes,
                op=tdist.ReduceOp.SUM) -> torch.Tensor:
    group, _ = mesh.group(axes)
    if group is None:
        return x.clone()
    _count("all_reduce", x)
    with _timed("all_reduce"):
        t, staged = _host(x, mesh)
        if not staged:
            t = t.clone()
        tdist.all_reduce(t, op=op, group=group)
        _record("all_reduce", x, _nbytes(x), mesh, axes)
        return t.to(x.device) if staged else t


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, axes: Axes,
                    dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of every member's ``x``:
    gloo has no reduce-scatter, so chunk j goes to member j
    (``all_to_all_single``) and each rank sums what it receives, in the
    members' order (the bytes of an all-reduce's first half). The chunks
    travel in ``x``'s dtype; a bf16 sum is taken in float32 and rounded
    once, as XLA's CPU reduce-scatter promotes it (its reduction
    computation ``region_0.0_promoted``), where a bf16 sum would round at
    every add."""
    group, members = mesh.group(axes)
    if group is None:
        return x.clone()
    n = len(members)
    _count("reduce_scatter", x)
    with _timed("reduce_scatter"):
        t, staged = _host(x, mesh)
        order = tdist.get_process_group_ranks(group)
        pos = {r: i for i, r in enumerate(members)}
        chunks = t.chunk(n, dim=dim)
        send = torch.stack([chunks[pos[r]] for r in order]).contiguous()
        recv = torch.empty_like(send)
        tdist.all_to_all_single(recv, send, group=group)
        by_rank = dict(zip(order, recv.unbind(0)))
        acc = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        out = by_rank[members[0]].to(acc, copy=True)
        for r in members[1:]:
            out += by_rank[r]
        out = out.to(t.dtype)
        _record("reduce_scatter", x, _nbytes(out), mesh, axes)
        return out.to(x.device) if staged else out


def _gather_list(x: torch.Tensor, mesh: Mesh, axes: Axes):
    """Every member's ``x`` in linear order over ``axes``."""
    group, members = mesh.group(axes)
    if group is None:
        return [x]
    _count("all_gather", x)
    with _timed("all_gather"):
        t, staged = _host(x, mesh)
        bufs = [torch.empty_like(t) for _ in members]
        tdist.all_gather(bufs, t, group=group)
        order = tdist.get_process_group_ranks(group)
        by_rank = dict(zip(order, bufs))
        out = [by_rank[r] for r in members]
        _record("all_gather", x, sum(map(_nbytes, out)), mesh, axes)
        return [b.to(x.device) for b in out] if staged else out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return torch.cat(_gather_list(x, mesh, axes), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim),
                None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _reduce_scatter(x.contiguous(), mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (torch.cat(_gather_list(g.contiguous(), ctx.mesh, ctx.axes),
                          dim=ctx.dim), None, None, None)


def _exchange(x: torch.Tensor, mesh: Mesh, axis: str, split: int,
              concat: int) -> torch.Tensor:
    group, members = mesh.group(axis)
    if group is None:
        return x.clone()
    n = len(members)
    _count("all_to_all", x)
    with _timed("all_to_all"):
        t, staged = _host(x, mesh)
        order = tdist.get_process_group_ranks(group)
        pos = {r: i for i, r in enumerate(members)}
        # chunk j (linear order) goes to member j: stacked in the group's
        # order on a new leading dim for all_to_all_single
        chunks = t.chunk(n, dim=split)
        send = torch.stack([chunks[pos[r]] for r in order]).contiguous()
        recv = torch.empty_like(send)
        tdist.all_to_all_single(recv, send, group=group)
        by_rank = dict(zip(order, recv.unbind(0)))
        out = torch.cat([by_rank[r] for r in members], dim=concat)
        _record("all_to_all", x, _nbytes(out), mesh, axis)
        return out.to(x.device) if staged else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.args = (mesh, axis, split, concat)
        return _exchange(x, mesh, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split, concat = ctx.args
        return (_exchange(g.contiguous(), mesh, axis, concat, split),
                None, None, None, None)


def _permute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``x`` sent from index s to index d of ``axis`` for each (s, d) of
    ``perm``; an index that receives nothing gets zeros."""
    _, members = mesh.group(axis)
    me = mesh.axis_index(axis)
    t, staged = _host(x, mesh)
    out = torch.zeros_like(t)
    reqs = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(t)
        elif s == me:
            _count("ppermute", x)
            _record("ppermute", x, _nbytes(x), mesh, axis, group_size=2)
            reqs.append(tdist.isend(t, members[d]))
        elif d == me:
            reqs.append(tdist.irecv(out, members[s]))
    for r in reqs:
        r.wait()
    return out.to(x.device) if staged else out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        inverse = [(d, s) for s, d in perm]
        return _permute(g.contiguous(), mesh, axis, inverse), None, None, None


def psum(x: torch.Tensor, mesh: Mesh, axes: Optional[Axes]) -> torch.Tensor:
    """``jax.lax.psum(x, axes)``: the sum over the subgroup (``x`` itself
    when the axes have one rank)."""
    if mesh.axis_size(axes) <= 1:
        return x
    return _PSum.apply(x, mesh, axes_tuple(axes))


def pmean(x: torch.Tensor, mesh: Mesh, axes: Optional[Axes]) -> torch.Tensor:
    """``jax.lax.pmean``: `psum`, then divided by the ranks (a product by
    the reciprocal, as XLA folds a constant divisor)."""
    n = mesh.axis_size(axes)
    if n <= 1:
        return x
    return psum(x, mesh, axes) * (1.0 / n)


def pmax(x: torch.Tensor, mesh: Mesh, axes: Optional[Axes]) -> torch.Tensor:
    """``jax.lax.pmax`` (no gradient)."""
    if mesh.axis_size(axes) <= 1:
        return x
    return _all_reduce(x.detach(), mesh, axes_tuple(axes),
                       op=tdist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Optional[Axes],
               dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axes, axis=dim, tiled=True)``: the members'
    blocks concatenated along ``dim`` in linear order; backward the
    reduce-scatter (`psum_scatter`)."""
    if mesh.axis_size(axes) <= 1:
        return x
    return _AllGather.apply(x, mesh, axes_tuple(axes), dim % x.ndim)


def psum_scatter(x: torch.Tensor, mesh: Mesh, axes: Optional[Axes],
                 dim: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axes, scatter_dimension=dim,
    tiled=True)``: this rank's slice along ``dim`` of the sum of every
    member's ``x`` (the members' linear order); backward `all_gather`. A
    bf16 ``x`` is summed in float32 and rounded once, as XLA's CPU
    reduce-scatter promotes it."""
    if mesh.axis_size(axes) <= 1:
        return x
    return _ReduceScatter.apply(x, mesh, axes_tuple(axes), dim % x.ndim)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)``: chunk j of ``split_axis`` goes to member j, and the
    chunks received are concatenated along ``concat_axis`` in the senders'
    order."""
    if mesh.axis_size(axis) <= 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_axis % x.ndim,
                           concat_axis % x.ndim)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute(x, axis, perm)``: pairs of (source, destination)
    indices along ``axis``; a rank that receives nothing gets zeros."""
    return _PPermute.apply(x, mesh, axis, tuple(map(tuple, perm)))


def reduce_grads(grads, specs, mesh: Mesh, outer=()):
    """Each gradient leaf summed over the mesh axes its spec (a `P` tree
    beside ``grads``) does not name, but those in ``outer``: the ranks that
    hold the same block computed shares of its gradient (the partial
    convention)."""
    from ..models.common import sorted_leaves, unflatten

    spec_of = dict(sorted_leaves(specs))
    out = {}
    for path, g in sorted_leaves(grads):
        named = spec_axes(spec_of[path])
        rest = tuple(a for a in mesh.axis_names
                     if a not in named and a not in outer)
        out[path] = psum(g, mesh, rest) if rest else g
    return unflatten(out)

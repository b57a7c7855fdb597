"""Sharded and out-of-core wavefront analysis on torch — the extreme-scale
engines.

:func:`tiled_dist_mult_tiles` runs the BFS level loop one source tile at a
time, so no N x N matrix of dist or mult ever exists: the device holds a
(tile, N) dist, mult and frontier, plus either the whole adjacency or one
adjacency panel at a time.

* **Resident**: when the padded adjacency fits ``adjacency_budget`` bytes,
  it is scattered from the graph's CSR straight into one (N, N) device
  matrix, and each level is one fused frontier-step launch
  (`kernels.semiring.frontier_step`, or `frontier_step_packed`).
* **Streamed**: past the budget, each level streams ``(panel_rows, N)``
  adjacency panels, filled on the host from CSR, through pinned staging
  buffers used in turn, into the counting product
  (`kernels.semiring.count_matmul`) accumulated over the panels; the
  first-reach mask is applied to the accumulated (tile, N) product.

``packed=True`` shrinks the cells: int16 distances (``DIST_UNREACHED``
plays +inf), multiplicities saturating at ``MULT_SAT`` = 2**24 (clamped,
never wrapped), uint8 {0,1} adjacency. Results are bit-equal to the fp32
engine wherever values fit, and to the JAX package's tiled engine
throughout: distances are small integers and counts integer sums, exact in
fp32 below 2**24, so neither the tile split nor the panel split changes a
bit.

**Row-sharded** (:func:`dist_mult_sharded`, :func:`ecmp_loads_sharded`,
:func:`sharded_dist_mult`) and **composed** (:func:`composed_dist_mult_tiles`,
or ``mesh=`` on the tiled entry points) engines run over a
:class:`RowMesh`: P ranks of a `torch.distributed` process group, one
device each, every rank running the shard's body (SPMD). The JAX
package's one controller over a ``(rows,)`` mesh maps onto it as
``psum`` -> ``all_reduce(SUM)``, ``pmax`` -> ``all_reduce(MAX)``,
``axis_index`` -> the rank. :func:`launch_mesh` starts the ranks (or uses
the group ``torchrun`` made); gloo carries CUDA tensors through the host,
so two ranks can share one card.

* **Row-sharded**: rank r owns rows [r p/P, (r+1) p/P) of dist / mult /
  frontier against the replicated (.., p, p) adjacency; each level is one
  frontier step on the rank's block and one all-reduced flag. The Brandes
  loads sum the ranks' partials in one all-reduce at the end.
* **Composed**: rank r holds only adjacency rows [r p/P, (r+1) p/P),
  scattered from the graph's CSR straight into its device; a source tile's
  dist / mult / frontier are replicated. Each level every rank multiplies
  the frontier's K-slab of its own rows against them, and one all-reduce
  sums the (tile, p) partials: O(tile x p) bytes a level, where the JAX
  package's ``ppermute`` ring moves the p^2/P panels round the mesh.

Bit-equality with the single-device engines holds by the same argument as
for the tiles and panels: every partial is an integer-valued f32, exact
below 2**24, so neither the row split nor the K split (nor the order the
all-reduce sums in) changes a bit. ECMP loads divide by sigma and match to
f32 round-off.

CLI::

  python -m repro_torch.core.analysis.distributed [--family F] [--routers N]
      [--tile-rows T] [--sources K] [--packed] [--adjacency-budget BYTES]
      [--check C] [--checkpoint FILE] [--shards P] [--device cuda|cpu]
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from ... import obs
from ...kernels import semiring as S
from .engine_select import _mesh_shards
from .wavefront import pad_block, pad_operand, resolve_device

__all__ = ["ROW_AXIS", "RowMesh", "device_mesh", "default_mesh",
           "best_shard_count", "launch_mesh", "start_mesh", "MeshRun",
           "gather_rows",
           "pad_block_sharded", "dist_mult_sharded", "sharded_dist_mult",
           "ecmp_loads_sharded", "composed_dist_mult_tiles",
           "tiled_dist_mult", "tiled_dist_mult_tiles", "tiled_summary",
           "bfs_dist_sigma", "oracle_rows", "widest_divisor_block"]

#: the one mesh axis every sharded engine uses (1-D row mesh)
ROW_AXIS = "rows"

#: f32 row/col tile width every padded size is a multiple of
_TILE = 128

#: dense adjacency larger than this (bytes) makes the tiled engine stream
#: CSR-built panels instead of keeping the full matrix device-resident
_ADJ_BUDGET = 1 << 28

#: pinned staging buffers the streamed pump fills in turn
_STAGING = 2


def _pad128(n: int) -> int:
    """Router count padded up to the f32 lane tile (the one padding rule
    shared by the shard sizer, the tile pump and the CLI probe)."""
    return max(_TILE, n + ((-n) % _TILE))


# -- the mesh --------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowMesh:
    """This rank's view of a 1-D ``(rows,)`` mesh: the port's counterpart of
    the JAX package's ``Mesh(devices, ("rows",))``.

    ``size`` and ``shape[ROW_AXIS]`` read as they do on a jax Mesh; ``rank``
    is this process's place on the axis (``axis_index``), ``device`` where
    its shard lives, ``backend`` the process group's (``"gloo"`` or
    ``"nccl"``), ``group`` the group (None for the default group)."""

    size: int
    rank: int
    device: torch.device
    backend: str
    group: object = None

    @property
    def shape(self) -> Dict[str, int]:
        return {ROW_AXIS: self.size}

    def rows(self, p: int) -> Tuple[int, int]:
        """The rows [r0, r1) of a p-row operand that this rank owns."""
        rows = p // self.size
        return self.rank * rows, (self.rank + 1) * rows


#: groups of the default group's first k ranks, keyed by (default group, k):
#: a new group is a collective call, made once
_SUBGROUPS: Dict[Tuple[int, int], object] = {}


def _world_size() -> int:
    """Ranks of the default process group (1 without one): the port's
    "visible devices"."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def device_mesh(num_shards: Optional[int] = None,
                device="cuda") -> Optional[RowMesh]:
    """A 1-D ``(rows,)`` mesh over the first ``num_shards`` ranks of the
    default process group (all of them by default), this rank's shard on
    ``device`` (``"cuda"``: the current card).

    Returns None when the mesh would be a single rank — callers treat that
    as "use the unsharded engine" — and on a rank past the first
    ``num_shards``, which then runs the unsharded engine on its own. Raises
    ValueError when the group has fewer ranks. A mesh smaller than the
    group is a group of its own, so every rank makes the call."""
    world = _world_size()
    if num_shards is None:
        num_shards = world
    if num_shards <= 1:
        return None
    if num_shards > world:
        raise ValueError(f"mesh wants {num_shards} ranks, the process group "
                         f"has {world} (start them with launch_mesh or "
                         f"torchrun)")
    group = None
    if num_shards < world:
        key = (id(tdist.group.WORLD), num_shards)
        if key not in _SUBGROUPS:
            _SUBGROUPS[key] = tdist.new_group(list(range(num_shards)))
        group = _SUBGROUPS[key]
    rank = tdist.get_rank()
    if rank >= num_shards:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return RowMesh(num_shards, rank, dev, tdist.get_backend(group), group)


def best_shard_count(n: int, max_shards: Optional[int] = None) -> int:
    """Largest useful shard count for an n-router problem.

    Each shard must own at least one full (128, N) row tile of the padded
    problem, so P is capped at ``pad128(n) / 128`` (and at the process
    group's size).
    """
    if max_shards is None:
        max_shards = _world_size()
    return max(1, min(int(max_shards), _pad128(n) // _TILE))


def default_mesh(n: Optional[int] = None, device="cuda") -> Optional[RowMesh]:
    """The mesh `AnalysisEngine` / `sweep` pick up with ``mesh="auto"``: the
    process group's ranks when it has more than one (capped so every shard
    keeps a whole row tile), else None — one process is the single-device
    path."""
    if _world_size() <= 1:
        return None
    return device_mesh(best_shard_count(n) if n is not None
                       else _world_size(), device=device)


def pad_block_sharded(n: int, num_shards: int, block: Optional[int] = None,
                      batched: bool = False) -> Tuple[int, int, int]:
    """(padded size, row block, col block) for an n-router problem split
    row-wise over ``num_shards`` ranks.

    The padded size is a multiple of ``num_shards * 128`` so every shard
    owns whole row tiles; extra padding rows are inert phantom routers
    exactly like the unsharded engine's. The blocks are the JAX package's
    Pallas grid (``block`` defaults to the 128 tile here; ``batched`` is
    accepted for its signature): the CUDA kernels take any shape, so they
    only size what the spans report.
    """
    p = pad_block(n)
    block = _TILE if block is None else min(block, p)
    p += (-p) % block
    p += (-p) % (num_shards * _TILE)
    col = block if p % block == 0 else _TILE
    rows = p // num_shards
    row = col if rows % col == 0 else _TILE
    return p, row, col


def _check_padded(p: int, num_shards: int) -> None:
    """Raise unless a padded size p splits into whole row tiles over
    ``num_shards`` (the engines never re-pad their operands)."""
    if p % (num_shards * _TILE):
        raise ValueError(f"operand size {p} is not a multiple of "
                         f"{num_shards} shards x {_TILE} — pad with "
                         f"pad_block_sharded() first")


# -- collectives -----------------------------------------------------------------

def _collective(x: torch.Tensor, mesh: RowMesh, op) -> torch.Tensor:
    """Run the in-place collective ``op`` on the contiguous ``x`` and return
    it: the tensor itself on NCCL or on the CPU; on gloo a CUDA tensor goes
    through a host copy and back (gloo stages CUDA tensors through the host
    anyway, and has no CUDA send, recv or all_gather)."""
    if x.device.type == "cpu" or mesh.backend != "gloo":
        op(x)
        return x
    host = x.cpu()
    op(host)
    return x.copy_(host)


def _all_reduce(x: torch.Tensor, mesh: RowMesh,
                op=tdist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the mesh in place (``psum``; ``pmax`` with
    ``op=MAX``)."""
    obs.counter("mesh.all_reduce_bytes").add(x.numel() * x.element_size())
    return _collective(x, mesh,
                       lambda t: tdist.all_reduce(t, op=op, group=mesh.group))


def gather_rows(x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The full row-stacked tensor from every rank's (.., rows, n) block, on
    every rank: one broadcast from each owner (the counterpart of
    ``np.asarray`` on a row-sharded jax.Array). The mesh's ranks are the
    group's first ones, so a rank of the group is its rank on the mesh."""
    rows = x.shape[-2]
    out = torch.empty((*x.shape[:-2], rows * mesh.size, x.shape[-1]),
                      dtype=x.dtype, device=x.device)
    for r in range(mesh.size):
        buf = (x.contiguous() if r == mesh.rank
               else torch.empty(x.shape, dtype=x.dtype, device=x.device))
        obs.counter("mesh.broadcast_bytes").add(buf.numel()
                                                * buf.element_size())
        _collective(buf, mesh,
                    lambda t: tdist.broadcast(t, r, group=mesh.group))
        out[..., r * rows:(r + 1) * rows, :] = buf
    return out


# -- the ranks -------------------------------------------------------------------

def launch_mesh(fn: Callable, num_shards, *args, device="cuda",
                timeout_s: float = 900.0, axes=None):
    """``fn(mesh, *args)`` on ``num_shards`` ranks; returns rank 0's result.

    ``num_shards`` is a rank count (``fn`` gets this rank's
    :class:`RowMesh`) or a tuple, the shape of a named-axis mesh over
    ``axes`` (``launch.mesh.MESH_AXES`` by default): ``fn`` then gets this
    rank's ``launch.mesh.Mesh`` (``make_debug_mesh(shape, axes)``).

    In a process group that exists already, or the one ``torchrun``
    describes in the environment (joined here, :func:`_join_torchrun`),
    ``fn`` runs here on this rank's :func:`device_mesh` and returns its own
    result. Otherwise the ranks are spawned (``torch.multiprocessing``, ``spawn``)
    and meet through a file in a new temporary directory. Rank r runs on
    card r mod the card count, which it sees as ``cuda:0`` (the kernels
    launch on device 0), or on the CPU, on one thread, only when
    ``device="cpu"``. The backend is NCCL when every rank has a card of its
    own, gloo otherwise (ranks sharing a card; the CPU). ``fn`` must be a
    module-level function and its result picklable. A rank that raises
    ends the others and its traceback is raised here; so does a run past
    ``timeout_s``, which also bounds each collective. One shard runs
    ``fn(None, *args)`` here.
    """
    dev = resolve_device(device)
    size, named = _shards(num_shards, axes)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
            "MASTER_ADDR" in os.environ and not tdist.is_initialized():
        _join_torchrun(dev, timeout_s)
    if tdist.is_available() and tdist.is_initialized():
        return fn(_rank_mesh(size, named, dev), *args)
    if size <= 1:
        return fn(_rank_mesh(size, named, dev) if named else None, *args)
    return start_mesh(fn, num_shards, *args, device=device,
                      timeout_s=timeout_s, axes=axes).result()


def _shards(num_shards, axes):
    """(the rank count, (shape, axes) of a named-axis mesh or None)."""
    if isinstance(num_shards, (tuple, list)):
        from ...launch.mesh import MESH_AXES

        named = (tuple(num_shards), tuple(axes or MESH_AXES))
        return int(np.prod(named[0])), named
    return num_shards, None


class MeshRun:
    """Ranks spawned by `start_mesh`: `result` lets them run ``fn`` and
    returns rank 0's result. Ranks never let run are killed at exit."""

    def __init__(self, procs, tmp, go, timeout_s):
        import atexit

        self.procs, self.tmp, self.go = procs, tmp, go
        self.timeout_s = timeout_s
        self.t_go = None
        atexit.register(self._kill)

    def _kill(self):
        import shutil

        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def result(self):
        """Rank 0's result; a rank that raises or a run past ``timeout_s``
        (from this call) raises here."""
        import atexit

        tmp = self.tmp
        try:
            self.t_go = time.time()
            self.go.set()
            failed = _join(self.procs, time.monotonic() + self.timeout_s)
            if failed is not None:
                # the first traceback written is the cause: a rank whose
                # peer left mid-handshake may exit before the peer that
                # raised
                errs = sorted((os.path.getmtime(os.path.join(tmp, f)), f)
                              for f in os.listdir(tmp) if f.endswith(".err"))
                if errs:
                    failed = int(errs[0][1][4:-4])
                err = os.path.join(tmp, f"rank{failed}.err")
                why = (open(err).read() if os.path.exists(err) else
                       f"exit code {self.procs[failed].exitcode}")
                raise RuntimeError(f"rank {failed} of {len(self.procs)} "
                                   f"failed:\n{why}")
            if any(proc.exitcode != 0 for proc in self.procs):
                raise TimeoutError(f"a mesh of {len(self.procs)} ranks ran "
                                   f"past {self.timeout_s} s; its ranks were "
                                   f"killed")
            with open(os.path.join(tmp, "result.pkl"), "rb") as fh:
                return pickle.load(fh)  # written by rank 0 of this call
        finally:
            self._kill()
            atexit.unregister(self._kill)


def start_mesh(fn: Callable, num_shards, *args, device="cuda",
               timeout_s: float = 900.0, axes=None) -> MeshRun:
    """Spawn `launch_mesh`'s ranks (``num_shards`` of them, each on the
    card or the CPU as there) and return at once. Each rank joins the
    group, makes its mesh (its CUDA context included) and waits until
    `MeshRun.result` is called before it runs ``fn``: a caller starts the
    ranks (their ``import torch`` takes seconds each) beside other work."""
    dev = resolve_device(device)
    num_shards, named = _shards(num_shards, axes)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = "nccl" if 0 < num_shards <= cards else "gloo"
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = (visible.split(",") if visible else
           [str(i) for i in range(cards)])
    ctx = torch.multiprocessing.get_context("spawn")
    go = ctx.Event()
    tmp = tempfile.mkdtemp(prefix="repro_mesh_")
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, num_shards, backend, dev.type, tmp,
                               timeout_s, fn, args, go, named))
             for rank in range(num_shards)]
    try:
        for rank, proc in enumerate(procs):
            if cards:
                # the rank inherits the environment it starts with
                os.environ["CUDA_VISIBLE_DEVICES"] = ids[rank % cards]
            proc.start()
    finally:
        if visible is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = visible
    return MeshRun(procs, tmp, go, timeout_s)


def _join_torchrun(dev: torch.device, timeout_s: float) -> None:
    """Join the process group ``torchrun`` describes in the environment.
    Each rank runs on the card it sees as ``cuda:0`` (the kernels launch on
    device 0): the ranks share one card, or each sees its own through
    ``CUDA_VISIBLE_DEVICES``; either way the backend is gloo (only
    :func:`launch_mesh`'s own ranks know their cards apart, for NCCL)."""
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise ValueError("under torchrun each rank must see its own card as "
                         "cuda:0 (CUDA_VISIBLE_DEVICES=$LOCAL_RANK): the "
                         "kernels launch on device 0")
    tdist.init_process_group("gloo", init_method="env://",
                             timeout=datetime.timedelta(seconds=timeout_s))


def _join(procs, deadline: float) -> Optional[int]:
    """Wait for the ranks until they all exit, one fails, or ``deadline``;
    kill any still running. Returns the first failed rank, or None."""
    from multiprocessing.connection import wait

    pending = list(procs)
    failed = None
    try:
        while pending and failed is None:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            wait([p.sentinel for p in pending], timeout=left)
            for proc in [p for p in pending if p.exitcode is not None]:
                pending.remove(proc)
                if proc.exitcode != 0 and failed is None:
                    failed = procs.index(proc)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
    return failed


def _rank_mesh(size: int, named, device):
    """This rank's mesh: its :func:`device_mesh` row, or, for ``named`` =
    (shape, axes), its view of that named-axis mesh."""
    if named is None:
        return device_mesh(size, device=device)
    from ...launch.mesh import make_debug_mesh

    return make_debug_mesh(named[0], named[1], device=device)


def _wait_for(go) -> None:
    """Wait for the event ``go``; leave if the spawning process has gone."""
    import multiprocessing

    parent = multiprocessing.parent_process()
    while not go.wait(5.0):
        if parent is not None and not parent.is_alive():
            raise RuntimeError("the caller left before it let the ranks run")


def _rank_main(rank: int, size: int, backend: str, device: str, tmp: str,
               timeout_s: float, fn: Callable, args: tuple, go,
               named=None) -> None:
    """One spawned rank: join the group, make its mesh, wait for the event
    ``go``, run ``fn`` on the mesh, and (rank 0) leave
    its result beside the rendezvous file; a failure leaves its traceback
    there, before the group is torn down (which fails the peers)."""
    err = os.path.join(tmp, f"rank{rank}.err")

    def leave_traceback():
        if not os.path.exists(err):
            with open(err, "w") as fh:
                fh.write(traceback.format_exc())

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        tdist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
            world_size=size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = _rank_mesh(size, named, device)
            _wait_for(go)
            out = fn(mesh, *args)
            if rank == 0:
                path = os.path.join(tmp, "result.pkl")
                with open(path + ".part", "wb") as fh:
                    pickle.dump(out, fh)
                os.replace(path + ".part", path)
        except BaseException:
            leave_traceback()
            raise
        finally:
            tdist.destroy_process_group()
    except BaseException:
        leave_traceback()
        raise


# -- sharded wavefront: dist + mult ----------------------------------------------

def dist_mult_sharded(adj: torch.Tensor, mesh: RowMesh,
                      telemetry: bool = False, use_kernel: bool = True):
    """Row-sharded hop distances + multiplicities: this rank's rows.

    ``adj`` is the replicated (p, p) or stacked (B, p, p) {0,1} fp32
    adjacency on the rank's device, p a multiple of ``mesh.size * 128``
    (see :func:`pad_block_sharded`; padding rows/cols zero). Returns the
    rank's (.., p/P, p) blocks (dist, mult), bit-equal to those rows of
    `wavefront.dist_mult_device` on the same operand (:func:`gather_rows`
    joins them). Each level is one frontier step on the block and one
    all-reduced int — did any rank reach a new pair? — read on the host.

    ``telemetry=True`` additionally returns the replicated ``(levels,
    sizes)`` pair, newly reached pairs per level summed over the ranks (per
    graph when stacked), as `wavefront.dist_mult_device` does: the
    all-reduced flag widens to those counts. (The JAX package's ``bm``,
    ``block`` and ``interpret`` size its Pallas grid; the CUDA kernels take
    any shape.)
    """
    p = adj.shape[-1]
    batched = adj.ndim == 3
    _check_padded(p, mesh.size)
    r0, r1 = mesh.rows(p)
    dev = adj.device
    adj = adj.contiguous()
    eye = torch.zeros((r1 - r0, p), dtype=torch.bool, device=dev)
    eye[torch.arange(r1 - r0, device=dev),
        torch.arange(r0, r1, device=dev)] = True
    eye = eye.expand((*adj.shape[:-2], r1 - r0, p))
    dist = torch.where(eye, 0.0, float("inf"))
    mult = eye.to(torch.float32).contiguous()
    frontier = mult.clone()
    sizes = (torch.zeros((p + 1, adj.shape[0]) if batched else (p + 1,),
                         dtype=torch.int32, device=dev) if telemetry else None)
    level, more = 1, True
    while more and level <= p:
        x = S.frontier_step(frontier, adj, dist, use_kernel=use_kernel)
        new = x > 0
        dist.masked_fill_(new, level)
        mult.add_(x)
        if telemetry:
            cnt = _all_reduce(new.sum(dim=(-2, -1), dtype=torch.int32)
                              .reshape(-1), mesh)
            sizes[level] = cnt if batched else cnt[0]
            more = bool(cnt.sum() > 0)
        else:
            # the level's one collective: did any rank reach a new pair?
            more = bool(_all_reduce(new.any().to(torch.int32).reshape(1),
                                    mesh)[0] > 0)
        frontier = x
        level += 1
    if telemetry:
        return dist, mult, (level - 1, sizes)
    return dist, mult


def sharded_dist_mult(adj: np.ndarray, mesh: Optional[RowMesh] = None,
                      block: Optional[int] = None, device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Host convenience wrapper: pad -> sharded engine -> gathered, sliced
    numpy arrays on every rank.

    The sharded mirror of `wavefront.wavefront_dist_mult`: with
    ``mesh=None`` (or a mesh of one rank) it delegates there, on
    ``device``, so a one-rank mesh is the unsharded path by construction;
    with a mesh the shard runs on ``mesh.device``. Under an enabled
    `repro_torch.obs` tracer the call is spanned and the mesh-wide telemetry
    (levels, frontier sizes) lands in the span's attributes.
    """
    from .wavefront import (_warn_if_inexact, telemetry_attrs,
                            wavefront_dist_mult)

    if _mesh_shards(mesh) <= 1:
        return wavefront_dist_mult(adj, device=device)
    adj = np.asarray(adj, np.float32)
    n = adj.shape[-1]
    batched = adj.ndim == 3
    p, _, block = pad_block_sharded(n, mesh.size, block, batched=batched)
    tel = obs.enabled()
    with obs.span("wavefront.dist_mult_sharded", routers=n, padded=p,
                  block=block, shards=mesh.size, batched=batched) as sp:
        padded = pad_operand(adj, p, 0.0)
        obs.record_h2d(padded.nbytes, "adjacency")
        out = dist_mult_sharded(torch.from_numpy(padded).to(mesh.device),
                                mesh, telemetry=tel)
        if tel:
            sp.set(**telemetry_attrs(out[2]))
        sl = (Ellipsis, slice(None, n), slice(None, n))
        dist = gather_rows(out[0], mesh)[sl].cpu().numpy()
        mult = gather_rows(out[1], mesh)[sl].cpu().numpy()
    _warn_if_inexact(mult)
    return dist, mult


# -- sharded Brandes ECMP loads --------------------------------------------------

def ecmp_loads_sharded(dist: torch.Tensor, mult: torch.Tensor,
                       adj: torch.Tensor, mesh: RowMesh,
                       use_kernel: bool = True) -> torch.Tensor:
    """Directed ECMP loads under uniform all-pairs demand: shard-local
    Brandes accumulation + one all-reduce.

    ``dist``/``mult`` are this rank's (.., p/P, p) source rows (the blocks
    :func:`dist_mult_sharded` returns; the full (.., p, p) matrices are
    cut to them), ``adj`` the replicated padded adjacency, all on the
    rank's device. The diameter is all-reduced (MAX); each level runs two
    counting products over the rank's rows, ``(p, rows) @ (rows, p)`` and
    ``(rows, p) @ (p, p)``; the (.., p, p) partials are summed over the
    ranks once at the end. Returns the replicated (.., p, p) loads; they
    match `wavefront.ecmp_loads_device` to f32 round-off (the per-source
    partials are summed in another order).
    """
    p = adj.shape[-1]
    _check_padded(p, mesh.size)
    if dist.shape[-2] == p:
        r0, r1 = mesh.rows(p)
        dist, mult = dist[..., r0:r1, :], mult[..., r0:r1, :]
    finite = torch.isfinite(dist)
    diam = int(_all_reduce(
        torch.where(finite, dist, 0.0).max().to(torch.int32).reshape(1),
        mesh, tdist.ReduceOp.MAX)[0])
    sigma_inv = torch.where(finite & (mult > 0),
                            1.0 / torch.where(mult > 0, mult, 1.0), 0.0)
    del finite
    adj = adj.contiguous()
    delta = torch.zeros_like(dist)
    acc = torch.zeros(adj.shape, dtype=torch.float32, device=adj.device)
    for a in range(diam - 1, -1, -1):
        z = torch.where(dist == a + 1.0, (1.0 + delta) * sigma_inv, 0.0)
        on_a = dist == a
        f_a = torch.where(on_a, mult, 0.0)
        # (p, rows) @ (rows, p): contracts this rank's source rows
        acc.add_(S.count_matmul(f_a.transpose(-1, -2), z,
                                use_kernel=use_kernel))
        delta = torch.where(on_a, mult * S.count_matmul(
            z, adj, use_kernel=use_kernel), delta)
    return adj * _all_reduce(acc, mesh)


# -- adjacency sources -----------------------------------------------------------

def _csr_panel(indptr: np.ndarray, indices: np.ndarray, n: int, k0: int,
               k1: int, out: np.ndarray) -> np.ndarray:
    """Fill ``out[:k1-k0, :n]`` with dense adjacency rows k0..k1 from CSR.

    ``out`` is a staging buffer of the tile pump; rows past ``k1 - k0``
    (panel padding) and columns past ``n`` stay zero."""
    out[...] = 0
    span = indptr[k0:k1 + 1]
    counts = np.diff(span)
    out[np.repeat(np.arange(k1 - k0), counts),
        indices[span[0]:span[-1]]] = 1
    return out


def _adjacency_source(source) -> Tuple[Callable[[int, int, np.ndarray],
                                                np.ndarray], int]:
    """(panel filler, n) from a Graph (CSR rows, nothing dense ever built)
    or a dense (n, n) array (sliced views)."""
    if hasattr(source, "csr"):
        indptr, indices = source.csr()
        n = source.n

        def fill(k0: int, k1: int, out: np.ndarray) -> np.ndarray:
            return _csr_panel(indptr, indices, n, k0, k1, out)

        return fill, n
    dense = np.asarray(source, np.float32)
    n = dense.shape[-1]

    def fill(k0: int, k1: int, out: np.ndarray) -> np.ndarray:
        out[...] = 0
        out[:k1 - k0, :n] = dense[k0:k1]
        return out

    return fill, n


def _router_count(source) -> int:
    return source.n if hasattr(source, "csr") else np.asarray(source).shape[-1]


def _device_adjacency(source, n: int, pc: int, dtype: torch.dtype,
                      dev: torch.device,
                      rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Rows [r0, r1) of the (pc, pc) padded adjacency (all of them by
    default) as an (r1 - r0, pc) matrix on ``dev``: a Graph's CSR rows are
    scattered straight into a device zero matrix (only the flat edge
    indices cross to the card), a dense array's rows are uploaded as they
    are. Bit-identical to assembling the panels on the host."""
    r0, r1 = (0, pc) if rows is None else rows
    hi = max(r0, min(r1, n))
    adj = torch.zeros((r1 - r0, pc), dtype=dtype, device=dev)
    if hi == r0:
        return adj
    if hasattr(source, "csr"):
        indptr, indices = source.csr()
        span = indptr[r0:hi + 1]
        local = np.repeat(np.arange(hi - r0, dtype=np.int64), np.diff(span))
        flat = torch.from_numpy(
            local * pc + indices[span[0]:span[-1]].astype(np.int64))
        obs.record_h2d(flat.numel() * flat.element_size(), "adjacency")
        adj.view(-1)[flat.to(dev)] = 1
    else:
        dense = torch.from_numpy(
            np.asarray(source, np.float32)[r0:hi]).to(dtype)
        obs.record_h2d(dense.numel() * dense.element_size(), "adjacency")
        adj[:hi - r0, :n] = dense.to(dev)
    return adj


def widest_divisor_block(size: int, cap: int) -> int:
    """Largest multiple of ``_TILE`` <= cap dividing ``size`` — ANY
    multiplier, not just powers of two. ``size`` must be a multiple of
    ``_TILE`` (padded extents always are). The JAX package sizes its
    kernel blocks with it; the CUDA kernels take any shape, so here it only
    fills the ``block`` the extreme sweep reports."""
    q = size // _TILE
    qcap = max(1, cap // _TILE)
    best = 1
    d = 1
    while d * d <= q:
        if q % d == 0:
            if d <= qcap:
                best = max(best, d)
            if q // d <= qcap:
                best = max(best, q // d)
        d += 1
    return best * _TILE


def _record_panel(nbytes: int, dtype) -> None:
    """Pump accounting: bytes streamed through the staging buffers plus a
    per-dtype panel-size gauge."""
    obs.record_h2d(nbytes, "panel")
    obs.counter("pump.bytes_streamed").add(nbytes)
    obs.gauge(f"pump.panel_mb.{np.dtype(dtype).name}").set(
        round(nbytes / 2**20, 3))


# -- one level -------------------------------------------------------------------

def _tile_level(frontier: torch.Tensor, adj: torch.Tensor, dist: torch.Tensor,
                mult: torch.Tensor, level: int, packed: bool):
    """One resident level: the fused step, then dist/mult in place.
    Returns (next frontier, any-new device flag)."""
    step = S.frontier_step_packed if packed else S.frontier_step
    x = step(frontier, adj, dist)
    new = x > 0
    dist.masked_fill_(new, level)
    mult.add_(x)
    return x, new.any()


def _mask_update(x: torch.Tensor, dist: torch.Tensor, mult: torch.Tensor,
                 level: int, packed: bool):
    """The first-reach mask over the panel-accumulated fp32 product ``x``;
    packed counts clamp at MULT_SAT on the way into the int32 cell —
    saturate, never wrap. Returns (next frontier, any-new device flag)."""
    if packed:
        new = (x > 0) & (dist == S.DIST_UNREACHED)
        x = torch.where(new, x.clamp(max=float(S.MULT_SAT)),
                        0.0).to(S.MULT_DTYPE)
    else:
        new = (x > 0) & torch.isinf(dist)
        x = torch.where(new, x, 0.0)
    dist.masked_fill_(new, level)
    mult.add_(x)
    return x, new.any()


# -- source tiles ----------------------------------------------------------------

def _resolve_source_ids(n: int, sources, source_ids
                        ) -> Tuple[np.ndarray, Optional[int]]:
    """(ids array, base) for the tile pump: ``base`` is the router id of
    the first row when the ids are a contiguous range (yields stay absolute
    row indices) and None for an arbitrary id list (yields index the ids
    list)."""
    if source_ids is not None:
        if sources is not None:
            raise ValueError("pass sources=(lo, hi) or source_ids=, "
                             "not both")
        ids = np.asarray(source_ids, np.int64).ravel()
        if len(ids) == 0 or ids.min() < 0 or ids.max() >= n:
            raise ValueError(f"source_ids must be non-empty router ids "
                             f"in [0, {n})")
        return ids, None
    lo, hi = (0, n) if sources is None else sources
    if not (0 <= lo < hi <= n):
        raise ValueError(f"sources {sources!r} outside [0, {n})")
    return np.arange(lo, hi, dtype=np.int64), lo


def _seed_tile(ids: np.ndarray, tp: int, pc: int, packed: bool):
    """(frontier/mult seed, dist seed) host arrays for one source tile:
    rows 0..len(ids) seed router columns ``ids``; padding rows are inert
    phantom sources (frontier 0 everywhere, dist all-unreached)."""
    t = len(ids)
    if packed:
        eye = np.zeros((tp, pc), np.int32)
        seed = np.full((tp, pc), S.DIST_UNREACHED, np.int16)
    else:
        eye = np.zeros((tp, pc), np.float32)
        seed = np.full((tp, pc), np.inf, np.float32)
    eye[np.arange(t), ids] = 1
    seed[np.arange(t), ids] = 0
    return eye, seed


def _tile_shape(t: int, cap: int = 512) -> int:
    """Padded tile rows for a t-row source tile (the JAX package's
    shapes: a multiple of 8 up to ``cap``, of 128 above)."""
    return t + ((-t) % 8) if t <= cap else _pad128(t)


def tiled_dist_mult_tiles(
        source, tile_rows: int = 512, panel_rows: Optional[int] = None,
        sources: Optional[Tuple[int, int]] = None,
        source_ids=None,
        adjacency_budget: int = _ADJ_BUDGET,
        block: Optional[int] = None, interpret: Optional[bool] = None,
        packed: bool = False, mesh=None, device="cuda",
) -> Iterator[Tuple[int, int, np.ndarray, np.ndarray]]:
    """Out-of-core exact dist+mult, one source tile at a time.

    Yields ``(r0, r1, dist_tile, mult_tile)`` with (r1 - r0, n) numpy tiles
    for source rows [r0, r1) — bit-equal to the corresponding rows of
    `wavefront.wavefront_dist_mult`.

    ``source`` is a Graph (adjacency built from its CSR; the dense N x N
    host matrix never exists) or a dense (n, n) array. When the padded
    adjacency fits ``adjacency_budget`` bytes it lives on the device and
    each level is one fused frontier-step launch; past the budget each
    level streams ``(panel_rows, n)`` panels through pinned staging
    buffers into the counting product and masks the accumulated (tile, n)
    product.

    ``sources=(lo, hi)`` restricts to a row range; ``source_ids=`` takes an
    arbitrary id array instead (the sampled-sources estimator's path) —
    tiles then cover ``ids[r0:r1]`` and the yielded (r0, r1) index the ids
    list, not router rows. ``packed=True`` shrinks every cell (uint8
    adjacency, int16 dist, counts saturating at MULT_SAT) and yields
    (int16, uint32) tiles. ``device`` is where the levels run: ``"cuda"``
    by default, which raises without a card; ``"cpu"`` runs the kernels'
    plain versions.

    ``block=`` and ``interpret=`` are accepted and ignored: they size the
    JAX package's Pallas grid, and the CUDA kernels take any shape.
    ``mesh=`` composes with a row mesh of more than one rank: the pump
    delegates to :func:`composed_dist_mult_tiles`, which shards the
    adjacency rows over the mesh's ranks (on ``mesh.device``).
    """
    if _mesh_shards(mesh) > 1:
        yield from composed_dist_mult_tiles(
            source, mesh, tile_rows=tile_rows, sources=sources,
            source_ids=source_ids, adjacency_budget=adjacency_budget,
            packed=packed)
        return
    dev = resolve_device(device)
    fill, n = _adjacency_source(source)
    pc = _pad128(n)                                # padded column count
    ids_all, base = _resolve_source_ids(n, sources, source_ids)
    tile_rows = max(1, min(tile_rows, len(ids_all)))

    adtype = np.uint8 if packed else np.float32
    adtype_t = torch.uint8 if packed else torch.float32
    abytes = np.dtype(adtype).itemsize
    stream = pc * pc * abytes > adjacency_budget
    if panel_rows is None:
        panel_rows = min(pc, max(_TILE,
                                 adjacency_budget // (8 * pc * abytes)))
    # panels tile the padded width exactly: round down to the largest
    # 128-multiple that divides pc
    panel_rows = max(_TILE, min(pc, panel_rows) - (min(pc, panel_rows) % _TILE))
    while pc % panel_rows:
        panel_rows -= _TILE
    adj_dev = staging = None
    if stream:
        # pinned host buffers, filled in turn: the host refills one only
        # after the event of its last upload, so a panel in flight is
        # never overwritten
        pinned = dev.type == "cuda"
        staging = [torch.zeros((panel_rows, pc), dtype=adtype_t,
                               pin_memory=pinned) for _ in range(_STAGING)]
        uploaded = [None] * _STAGING
    else:
        adj_dev = _device_adjacency(source, n, pc, adtype_t, dev)
    # panels fully inside the column padding are all-zero: skipped
    panels = [(k0, min(n, k0 + panel_rows))
              for k0 in range(0, pc, panel_rows) if k0 < n]
    max_level = min(n, S.DIST_UNREACHED - 1) if packed else n

    for c0 in range(0, len(ids_all), tile_rows):
        ids = ids_all[c0:c0 + tile_rows]
        t = len(ids)
        r0 = c0 if base is None else base + c0
        r1 = r0 + t
        tp = _tile_shape(t)
        with obs.span("tiled.tile", cat="tiled", r0=r0, r1=r1,
                      streamed=stream, packed=packed) as sp:
            eye, seed = _seed_tile(ids, tp, pc, packed)
            obs.record_h2d(eye.nbytes + seed.nbytes, "tile_seed")
            dist = torch.from_numpy(seed).to(dev)
            mult = torch.from_numpy(eye).to(dev)
            frontier = mult.clone()

            pumped = 0
            level = 1
            while level <= max_level:
                if stream:
                    x = torch.zeros((tp, pc), dtype=torch.float32, device=dev)
                    for k0, k1 in panels:
                        j = pumped % _STAGING
                        if uploaded[j] is not None:
                            uploaded[j].synchronize()
                        fill(k0, k1, staging[j].numpy())
                        panel = staging[j].to(dev, non_blocking=True)
                        if dev.type == "cuda":
                            uploaded[j] = torch.cuda.Event()
                            uploaded[j].record()
                        _record_panel(panel_rows * pc * abytes, adtype)
                        x.add_(S.count_matmul(
                            frontier[:, k0:k0 + panel_rows], panel))
                        pumped += 1
                    frontier, more = _mask_update(x, dist, mult, level,
                                                  packed)
                else:
                    frontier, more = _tile_level(frontier, adj_dev, dist,
                                                 mult, level, packed)
                if not bool(more):  # the level's one host sync
                    break
                level += 1
            sp.set(levels=level, panels_pumped=pumped)
            d = dist[:t, :n].cpu().numpy()
            m = mult[:t, :n].cpu().numpy()
            yield r0, r1, d, (m.astype(S.HOST_MULT_DTYPE) if packed else m)


def tiled_dist_mult(source, tile_rows: int = 512,
                    panel_rows: Optional[int] = None,
                    out: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                    **kw) -> Tuple[np.ndarray, np.ndarray]:
    """Assembled (n, n) dist+mult through the tiled engine.

    This materializes two full N x N host matrices — the point of the tiled
    engine is that the *device* never does; pass ``out=(dist, mult)``
    (e.g. an np.memmap pair) to keep the host side out-of-core as well, or
    use :func:`tiled_dist_mult_tiles` / :func:`tiled_summary` to avoid the
    N x N buffers entirely.
    """
    from .wavefront import _warn_if_inexact

    n = _router_count(source)
    packed = bool(kw.get("packed"))
    if out is None:
        if packed:
            out = (np.empty((n, n), np.int16),
                   np.empty((n, n), S.HOST_MULT_DTYPE))
        else:
            out = (np.empty((n, n), np.float32),
                   np.empty((n, n), np.float32))
    dist, mult = out
    for r0, r1, d, m in tiled_dist_mult_tiles(source, tile_rows, panel_rows,
                                              **kw):
        dist[r0:r1] = d
        mult[r0:r1] = m
    if not packed:
        # packed counts saturate at MULT_SAT instead of losing f32 integer
        # precision, so the 2**24 exactness check is an f32-engine concern
        _warn_if_inexact(mult)
    return dist, mult


def tiled_summary(source, tile_rows: int = 512,
                  panel_rows: Optional[int] = None,
                  sources: Optional[Tuple[int, int]] = None,
                  on_tile=None, checkpoint=None, **kw) -> Dict[str, object]:
    """Streaming aggregate of the tiled engine — no N x N buffer anywhere.

    Folds each (tile, n) dist/mult tile into diameter, reached-pair count,
    average shortest-path length and multiplicity stats, and reports the
    peak RSS next to what the single-buffer engine would need (6 padded
    N^2 f32 buffers), through the `repro_torch.obs` meters
    (``tiled.peak_rss_mb`` gauge, ``tiled.tiles`` counter).

    ``on_tile(r0, r1, dist, mult)``, when given, sees every tile before it
    is folded — callers spot-check rows without paying a second pass.

    ``checkpoint=`` (a path) makes long runs crash-safe: after every
    folded tile the partial aggregates are persisted atomically
    (`resilience.checkpoint.TileCheckpoint`), and a rerun with the same
    arguments resumes from the last completed tile — tiles are
    independent and the fold order is preserved, so a killed-and-resumed
    run returns aggregates bit-identical to an uninterrupted one. A
    mismatched checkpoint raises; a completed run removes its file. On
    resume ``on_tile`` only sees the recomputed tiles. In a process group
    (a mesh's ranks fold the same tiles) only rank 0 writes the file.
    """
    import time

    n = _router_count(source)
    packed = bool(kw.get("packed"))
    t0 = time.perf_counter()
    diam = 0
    pairs = 0
    dist_sum = 0.0
    mult_sum = 0.0
    mult_min = np.inf
    mult_max = 0.0
    rows_done = 0
    tiles = 0

    source_ids = kw.pop("source_ids", None)
    ids_all, base = _resolve_source_ids(n, sources, source_ids)
    eff_tile = max(1, min(tile_rows, len(ids_all)))
    ckpt = fp = None
    writer = not (tdist.is_available() and tdist.is_initialized()) or \
        tdist.get_rank() == 0
    if checkpoint is not None:
        from ..resilience.checkpoint import (TileCheckpoint,
                                             source_fingerprint)

        ckpt = TileCheckpoint(checkpoint)
        fp = source_fingerprint(source, tile_rows, packed, sources=sources,
                                source_ids=source_ids)
        state = ckpt.load(fp)
        if state is not None:
            diam = state["diameter"]
            pairs = state["reached_pairs"]
            dist_sum = state["dist_sum"]
            mult_sum = state["mult_sum"]
            mult_min = np.inf if state["mult_min"] is None else state["mult_min"]
            mult_max = state["mult_max"]
            rows_done = state["rows_done"]
            tiles = state["tiles"]
            obs.log("tiled.resume", checkpoint=str(checkpoint),
                    rows_done=rows_done, tiles=tiles)
    # the pump restarts at the first incomplete tile; rows_done is always
    # a whole number of tiles, so the remaining tile boundaries — and with
    # them every yielded tile — are identical to the uninterrupted run's
    if rows_done and base is not None:
        kw_sel = dict(sources=(base + rows_done, base + len(ids_all)))
    elif rows_done:
        kw_sel = dict(source_ids=ids_all[rows_done:])
    elif source_ids is not None:
        kw_sel = dict(source_ids=source_ids)
    else:
        kw_sel = dict(sources=sources)
    remaining = len(ids_all) - rows_done

    with obs.span("tiled.summary", cat="tiled", routers=n,
                  tile_rows=tile_rows, resumed_rows=rows_done) as sp:
        tile_iter = (tiled_dist_mult_tiles(source, eff_tile, panel_rows,
                                           **kw_sel, **kw)
                     if remaining > 0 else ())
        for r0, r1, d, m in tile_iter:
            if on_tile is not None:
                on_tile(r0, r1, d, m)
            # packed tiles carry the int16 DIST_UNREACHED sentinel instead
            # of +inf (int16 is always "finite")
            if packed:
                off = (d > 0) & (d != S.DIST_UNREACHED)
            else:
                off = np.isfinite(d) & (d > 0)
            if off.any():
                diam = max(diam, int(d[off].max()))
                pairs += int(off.sum())
                dist_sum += float(d[off].sum())
                mult_sum += float(m[off].sum())
                mult_min = min(mult_min, float(m[off].min()))
                mult_max = max(mult_max, float(m[off].max()))
            rows_done += r1 - r0
            tiles += 1
            obs.counter("tiled.tiles").add()
            obs.sample_process("tiled")
            if ckpt is not None and writer:
                ckpt.save(fp, {
                    "diameter": diam, "reached_pairs": pairs,
                    "dist_sum": dist_sum, "mult_sum": mult_sum,
                    "mult_min": None if mult_min == np.inf else mult_min,
                    "mult_max": mult_max, "rows_done": rows_done,
                    "tiles": tiles,
                })
        sp.set(tiles=tiles, diameter=diam)
    if ckpt is not None and writer:
        ckpt.remove()
    pc = _pad128(n)
    obs.gauge("tiled.peak_rss_mb").set(round(obs.peak_rss_mb(), 1))
    return {
        "routers": n,
        "rows_analyzed": rows_done,
        "tiles": tiles,
        "tile_rows": tile_rows,
        "diameter": diam,
        "reached_pairs": pairs,
        "avg_spl": dist_sum / pairs if pairs else 0.0,
        "mult_mean": mult_sum / pairs if pairs else 0.0,
        "mult_min": 0.0 if pairs == 0 else mult_min,
        "mult_max": mult_max,
        "elapsed_s": round(time.perf_counter() - t0, 2),
        "peak_rss_mb": round(obs.peak_rss_mb(), 1),
        "single_buffer_mb": round(6 * pc * pc * 4 / 2**20, 1),
        "packed": packed,
        "saturated": bool(packed and mult_max >= S.MULT_SAT),
    }


# -- composed engine: sharding x streaming ---------------------------------------

def composed_dist_mult_tiles(
        source, mesh: Optional[RowMesh], tile_rows: int = 512,
        sources: Optional[Tuple[int, int]] = None,
        source_ids=None,
        adjacency_budget: int = _ADJ_BUDGET,
        packed: bool = False, device="cuda",
) -> Iterator[Tuple[int, int, np.ndarray, np.ndarray]]:
    """Sharding x streaming composed dist+mult, one source tile at a time.

    The extreme-scale pump over a mesh: rank r holds only the adjacency
    rows [r p/P, (r+1) p/P), scattered from the graph's CSR straight into
    its device (f32, or uint8 when ``packed``), so neither the dense N x N
    matrix nor a replicated copy ever exists. Source tiles stream through
    the mesh with their (tile, p) dist / mult / frontier replicated on
    every rank. Each level every rank multiplies the frontier's K-slab of
    its own rows against them (`kernels.semiring.count_matmul`: the fp32
    kernel, or the int32 x uint8 narrow product when packed) and one
    all-reduce sums the (tile, p) partials, so every rank applies the same
    first-reach mask and stops at the same level. The JAX package rotates
    the adjacency panels round a ``ppermute`` ring instead, p^2/P bytes a
    level; this moves tile x p.

    The partials are integer-valued f32, exact below 2**24, so the sum is
    the same in any order; packed counts clamp at MULT_SAT after the sum,
    and since every partial is >= 0 a sum at or past 2**24 clamps to
    MULT_SAT however it was rounded. Yields the same ``(r0, r1, dist_tile,
    mult_tile)`` contract as :func:`tiled_dist_mult_tiles` on every rank,
    bit-equal to it and to the single-device wavefront; warns when a count
    saturated on any rank (the flag is all-reduced).

    ``adjacency_budget`` bounds each rank's resident rows (N^2/P x cell
    bytes); past it the call raises with the knobs that fit. ``mesh=None``
    or a mesh of one rank is the single-device tiled engine on ``device``.
    (No panels stream here, so the JAX package's ``panel_rows``, and its
    grid's ``block`` and ``interpret``, have no counterpart.)
    """
    if _mesh_shards(mesh) <= 1:
        yield from tiled_dist_mult_tiles(
            source, tile_rows=tile_rows, sources=sources,
            source_ids=source_ids, adjacency_budget=adjacency_budget,
            packed=packed, device=device)
        return
    n = _router_count(source)
    p = _pad128(n)
    p += (-p) % (mesh.size * _TILE)
    g0, g1 = mesh.rows(p)
    adtype_t = torch.uint8 if packed else torch.float32
    need = (g1 - g0) * p * (1 if packed else 4)
    if need > adjacency_budget:
        raise ValueError(
            f"composed engine: per-device adjacency panel needs {need} "
            f"bytes ({need / 2**20:.0f} MiB) > adjacency_budget "
            f"{adjacency_budget} — use more shards, packed=True (uint8 "
            f"panels), a larger budget, or the single-device streaming "
            f"engine (mesh=None)")
    dev = mesh.device
    ids_all, base = _resolve_source_ids(n, sources, source_ids)
    tile_rows = max(1, min(tile_rows, len(ids_all)))
    with obs.span("composed.build", cat="composed", routers=n, padded=p,
                  shards=mesh.size, packed=packed):
        adj = _device_adjacency(source, n, p, adtype_t, dev, rows=(g0, g1))
    obs.gauge("composed.shard_panel_mb").set(
        round(adj.numel() * adj.element_size() / 2**20, 1))
    max_level = min(n, S.DIST_UNREACHED - 1) if packed else n

    for c0 in range(0, len(ids_all), tile_rows):
        ids = ids_all[c0:c0 + tile_rows]
        t = len(ids)
        r0 = c0 if base is None else base + c0
        r1 = r0 + t
        tp = _tile_shape(t)
        with obs.span("composed.tile", cat="composed", r0=r0, r1=r1,
                      packed=packed) as sp:
            eye, seed = _seed_tile(ids, tp, p, packed)
            obs.record_h2d(eye.nbytes + seed.nbytes, "tile_seed")
            dist = torch.from_numpy(seed).to(dev)
            mult = torch.from_numpy(eye).to(dev)
            frontier = mult.clone()
            sat = torch.zeros(1, dtype=torch.int32, device=dev)
            level = 1
            while level <= max_level:
                # this rank's K-slab against its rows, summed over the mesh
                x = _all_reduce(S.count_matmul(frontier[:, g0:g1], adj), mesh)
                frontier, more = _mask_update(x, dist, mult, level, packed)
                if packed:
                    sat |= (frontier == S.MULT_SAT).any()
                if not bool(more):  # the same on every rank: x is summed
                    break
                level += 1
            saturated = bool(_all_reduce(sat, mesh, tdist.ReduceOp.MAX)[0])
            sp.set(levels=level, saturated=saturated)
            if saturated:
                import warnings

                warnings.warn(
                    "composed engine: a multiplicity reached MULT_SAT "
                    "(2**24) and was clamped — saturated counts are lower "
                    "bounds", RuntimeWarning, stacklevel=2)
            d = dist[:t, :n].cpu().numpy()
            m = mult[:t, :n].cpu().numpy()
            yield r0, r1, d, (m.astype(S.HOST_MULT_DTYPE) if packed else m)


# -- host oracle -----------------------------------------------------------------

def bfs_dist_sigma(g, s: int) -> Tuple[np.ndarray, np.ndarray]:
    """Single-source hop distances + shortest-path counts over CSR (host
    Brandes forward pass) — the O(E) per-source oracle the tiled engine is
    spot-checked against at sizes where dense N^2 references are
    unaffordable. Returns (dist, sigma) length-n arrays, dist +inf where
    unreachable."""
    indptr, indices = g.csr()
    n = g.n
    dist = np.full(n, np.inf, np.float64)
    sigma = np.zeros(n, np.float64)
    dist[s] = 0.0
    sigma[s] = 1.0
    frontier = [s]
    level = 0
    while frontier:
        level += 1
        nxt: Dict[int, float] = {}
        for u in frontier:
            su = sigma[u]
            for v in indices[indptr[u]:indptr[u + 1]]:
                v = int(v)
                if dist[v] == np.inf or dist[v] == level:
                    dist[v] = level
                    nxt[v] = nxt.get(v, 0.0) + su
        for v, sv in nxt.items():
            sigma[v] += sv
        frontier = list(nxt)
    return dist, sigma


def oracle_rows(g, i: int, packed: bool) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`bfs_dist_sigma` for source ``i`` in the tiled engine's cells:
    (int16, uint32) with the sentinel and the clamp when ``packed``, f32
    otherwise."""
    od, osig = bfs_dist_sigma(g, i)
    if packed:
        od = np.where(np.isfinite(od), od, S.DIST_UNREACHED).astype(np.int16)
        osig = np.minimum(osig, S.MULT_SAT).astype(S.HOST_MULT_DTYPE)
        return od, osig
    return od.astype(np.float32), osig.astype(np.float32)


# -- CLI: the extreme-scale demo / memory-budget probe ---------------------------

def main(argv=None) -> int:
    """``python -m repro_torch.core.analysis.distributed`` — tiled demo.

    Runs the out-of-core engine on a generated topology, spot-checks a few
    sources against the CSR Brandes oracle, and prints the summary JSON
    (incl. measured peak RSS vs the single-buffer requirement).
    """
    import argparse
    import json

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--family", default="jellyfish")
    ap.add_argument("--routers", type=int, default=16384)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--tile-rows", type=int, default=256)
    ap.add_argument("--panel-rows", type=int, default=None)
    ap.add_argument("--sources", type=int, default=None,
                    help="analyze only the first K source rows "
                         "(tiles are independent; default: all)")
    ap.add_argument("--adjacency-budget", type=int, default=_ADJ_BUDGET,
                    help="device bytes before adjacency panels stream")
    ap.add_argument("--packed", action="store_true",
                    help="packed cells: uint8 adjacency, int16 dist, mult "
                         "saturating at 2**24 (4x less streamed/resident "
                         "memory; bit-exact where values fit)")
    ap.add_argument("--shards", type=int, default=None,
                    help="row-shard over this many ranks (the composed "
                         "engine; launch_mesh starts them, or torchrun's "
                         "group is used); default: single-device")
    ap.add_argument("--block", type=int, default=None,
                    help="accepted for the JAX package's command line; the "
                         "CUDA kernels take any shape")
    ap.add_argument("--check", type=int, default=2,
                    help="spot-check this many sources vs the CSR oracle")
    ap.add_argument("--checkpoint", default=None, metavar="FILE.json",
                    help="crash-safe mode: persist partial aggregates "
                         "after every tile (atomic write + rename) and "
                         "resume from the last completed tile on rerun")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions on the host)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable tracing and write a Chrome trace-event "
                         "file (load in https://ui.perfetto.dev)")
    args = ap.parse_args(argv)

    shards = args.shards or 1
    summary = launch_mesh(_summarize, shards, args, device=args.device)
    if not (tdist.is_available() and tdist.is_initialized()) or \
            tdist.get_rank() == 0:
        print(json.dumps(summary, indent=1))
    return 0


def _summarize(mesh: Optional[RowMesh], args) -> Dict[str, object]:
    """The CLI's run on one rank (or alone, ``mesh=None``): the summary
    with its oracle spot check; rank 0 writes the trace."""
    from .. import topology as topo

    if args.trace:
        obs.enable()
    if args.family == "jellyfish":
        g = topo.make("jellyfish", n=args.routers, r=args.degree, seed=0)
    else:
        g = topo.by_servers(args.family, args.routers)
    srcs = (0, min(args.sources, g.n)) if args.sources else None

    # the oracle spot-check rides the summary stream itself (on_tile sees
    # every tile before it is folded) — one pass, not two
    check_lo = srcs[0] if srcs else 0
    check_hi = min(check_lo + args.check, g.n) if args.check else check_lo
    checked = [0]

    def spot_check(r0, r1, d, m):
        for i in range(max(check_lo, r0), min(check_hi, r1)):
            od, osig = oracle_rows(g, i, args.packed)
            np.testing.assert_array_equal(d[i - r0], od)
            np.testing.assert_array_equal(m[i - r0], osig)
            checked[0] += 1

    summary = tiled_summary(g, tile_rows=args.tile_rows,
                            panel_rows=args.panel_rows, sources=srcs,
                            adjacency_budget=args.adjacency_budget,
                            packed=args.packed, block=args.block, mesh=mesh,
                            on_tile=spot_check if args.check else None,
                            checkpoint=args.checkpoint, device=args.device)
    if args.check and not args.checkpoint:
        # a checkpoint resume skips completed tiles, so the spot-check may
        # legitimately see fewer sources than requested
        if checked[0] != check_hi - check_lo:
            raise RuntimeError(f"spot-checked {checked[0]} sources, not "
                               f"{check_hi - check_lo}")
        obs.log("distributed.check", status="oracle spot-check OK",
                sources=checked[0])
    summary["family"] = g.name
    summary["shards"] = _mesh_shards(mesh)
    summary["adjacency_streamed"] = bool(
        mesh is None and _pad128(g.n) ** 2 * (1 if args.packed else 4)
        > args.adjacency_budget)
    if args.trace and (mesh is None or mesh.rank == 0):
        obs.export(args.trace)
        obs.log("distributed.trace", path=args.trace)
    return summary


if __name__ == "__main__":
    raise SystemExit(main())

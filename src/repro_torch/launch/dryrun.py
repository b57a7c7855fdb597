"""Multi-pod dry run: one rank's step at full width, traced on the ``meta``
device inside a fake process group of the production mesh's 256 or 512
ranks; memory, cost and collective evidence for every (architecture x
input shape) cell.

The port of the JAX package's ``launch/dryrun.py``. There, XLA lowers and
compiles each step for a mesh of 512 forced host devices and the record
reads its ``memory_analysis()``, ``cost_analysis()`` and HLO collectives.
No torch step lowers to HLO: the port's SPMD is its own code
(``sharding.comm``'s collectives on ``launch.mesh`` subgroups), so the
dry run runs that code. `lower_cell` makes a ``fake`` default process
group of ``prod(mesh shape)`` ranks on a ``FakeStore`` (collectives
complete at once and move nothing), builds the production mesh over it on
``meta`` and runs rank 0's step on meta tensors (shapes and dtypes, no
storage, no arithmetic) exactly as the port runs it under a plan:

* **train**: ``steps.make_train_step(cfg, plan=, accum_steps=,
  accum_dtype=)`` on the rank's blocks of the train state
  (``train_state_shardings``): for every config (dense, MoE, SSM,
  hybrid, prefix, encoder-decoder) the layers compute on the rank's
  ``model`` blocks with each residual stream its block of the sequence
  and the loss vocab-parallel; or ``make_compressed_train_step`` where
  ``grad_compression == "int8_pod"`` on the multi-pod mesh, on the same
  blocks with the float32 error tree in the params' blocks;
* **decode** and **prefill**: the steps on the rank's blocks of the
  weights (``partition.serving_shardings``: the JAX step's
  ``params_only_shardings``) and of the caches
  (``partition.serving_cache_shardings``: its kv heads or its slots of
  the sequence, an encoder-decoder's cross caches too, an SSM layer's
  state heads and its conv tail whole), the stream the rank's block of
  the batch (``activation_ctx(plan, True)``) where the batch divides its
  axes.

Where the port's form differs from the JAX step's, the record says so in
``port_notes``. A record holds:

* ``plan_notes``, ``status`` / ``reason``: as the JAX dry run's;
* ``roofline``: ``roofline_report`` of the analytic flops and bytes (the
  same ``analytic_cost`` and ``model_flops``) over the collectives this
  rank issued, as the JAX dry run calls it; ``traced_flops`` from
  ``torch.utils.flop_counter.FlopCounterMode`` over the rank's step in
  place of XLA's raw counts. Its seconds are the ported TPU
  ``HardwareModel``'s (``core.collectives``), never the H100's;
* ``memory``: ``argument_bytes`` / ``output_bytes`` the storage bytes of
  the rank's inputs and outputs (``argument_parts`` by part);
  ``temp_bytes`` the peak of the storage bytes the step holds beyond its
  arguments (`LiveBytes`); ``per_device_total_gb`` by the JAX formula;
* ``collectives``: each collective the rank issued
  (``sharding.comm.record_collectives``: ``roofline.CollectiveOp``s, HLO
  kinds, exact mesh axes) and ``collective_bytes``, their input bytes
  summed per ``mesh.<kind>_bytes`` counter.

The dry run never touches a card. Records land in
``experiments/dryrun/torch/<arch>__<shape>__<mesh><tag>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
import weakref
from contextlib import contextmanager
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as tdist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..configs import ARCHS, get_config, shape_for
from ..configs.base import ShapeSpec
from ..configs.specs import (
    abstract_params_tree, abstract_train_state, cell_is_applicable,
    input_specs, step_kind,
)
from ..models import steps as steps_mod
from ..models.common import sorted_leaves, tree_map
from ..optim.compression import init_error_state
from ..sharding import (
    activation_ctx, batch_shardings, decode_input_shardings, make_plan,
    shard_tree, train_state_shardings,
)
from ..sharding.partition import serving_cache_shardings, serving_shardings
from ..sharding.comm import record_collectives
from ..sharding.partition import batch_axis, block
from ..sharding.rules import P
from .analytic import analytic_cost
from .mesh import make_debug_mesh, make_production_mesh
from .roofline import model_flops, roofline_report

__all__ = ["lower_cell", "run_cell", "dry_run", "trace_rank", "fake_group",
           "LiveBytes", "SkipCell", "TRAIN_ACCUM", "OUT_DIR", "small_cell",
           "rank_collectives", "compare_to_reference", "ANALYTIC_FIELDS",
           "train_notes", "main"]

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun" / "torch")

# Production microbatching per arch for the train shape: (accum_steps,
# "bf16"|None accumulator). The 398B hybrid cannot hold a full 1M-token
# step's transients at d_model=8192 — exactly like real deployments, it
# trains with gradient accumulation; yi/qwen-34B use a smaller factor.
TRAIN_ACCUM = {
    "jamba-1.5-large-398b": (8, "bf16"),
    "yi-34b": (2, None),
    "qwen1.5-32b": (2, None),
}


class SkipCell(Exception):
    pass


@contextmanager
def fake_group(world: int):
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0 (``FakeStore``), when no group exists; on exit it is destroyed
    and ``launch.mesh``'s subgroups made on it are dropped (its cache is
    keyed on the default group's ``id``, which a later group may reuse).
    An existing group is used as it is."""
    if tdist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from . import mesh as mesh_mod

    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world)
    world_id = id(tdist.group.WORLD)
    try:
        yield
    finally:
        for key in [k for k in mesh_mod._MESH_GROUPS if k[0] == world_id]:
            del mesh_mod._MESH_GROUPS[key]
        tdist.destroy_process_group()


class LiveBytes(TorchDispatchMode):
    """The storage bytes that ops create while the mode is active: a new
    storage's ``nbytes`` is added when an op returns it (an output storage
    that is none of the op's inputs' and not yet counted) and taken off at
    its ``weakref.finalize``; ``peak`` is the most ever live. Views and
    in-place results share their input's storage and add nothing, so the
    step's arguments are never counted. ``read`` holds every storage an op
    took as an input (by ``_cdata``)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.read: set = set()
        self._sizes: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        given = {t.untyped_storage()._cdata
                 for t in _tensors((args, tuple(kwargs.values())), [])}
        self.read |= given
        out = func(*args, **kwargs)
        for t in _tensors((out,), []):
            st = t.untyped_storage()
            key = st._cdata
            if key in given or key in self._sizes:
                continue
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def _tensors(xs, out: list) -> list:
    """The tensors in ``xs`` and its nested tuples and lists, appended to
    ``out`` (an op's arguments and results; cheaper than a pytree walk,
    which `LiveBytes` would pay on every op)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            _tensors(x, out)
    return out


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tree_leaves(tensors):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _block_bytes(tree, specs, mesh) -> int:
    """Bytes of this rank's blocks of ``tree``'s leaves under ``specs``."""
    total = 0
    for (_, t), (_, spec) in zip(sorted_leaves(tree), sorted_leaves(specs)):
        n = t.numel() * t.element_size()
        for entry in spec:
            if entry is not None:
                n //= mesh.axis_size(entry)
        total += n
    return total


def _materialize(tree, device, gen: torch.Generator, vocab: int):
    """A meta tree as tensors on ``device``: integers drawn below
    ``vocab`` (token ids; the step counter too), floats small normals (a
    real step's inputs: the values change neither its collectives nor its
    memory)."""
    def one(t):
        if not t.is_floating_point():
            return torch.randint(0, vocab, t.shape, generator=gen,
                                 dtype=t.dtype).to(device)
        return (torch.randn(t.shape, generator=gen) * 0.02).to(
            device=device, dtype=t.dtype)

    return tree_map(one, tree)


def _jax_argument_bytes(cfg, kind: str, inputs: Dict, plan, mesh,
                        replicate_stream: bool, compressed: bool,
                        unread: Sequence[str] = ()) -> int:
    """The bytes of this rank's blocks of the JAX step's arguments, from
    the spec trees its ``jax.jit`` takes (the dry run's ``in_shardings``):
    train, the state under ``train_state_shardings`` (the compressed
    step's error tree beside it) and the batch under ``batch_shardings``;
    decode, the weights under ``params_only_shardings`` (the master
    tree, float32: the JAX dry run passes ``abstract_train_state``'s
    params to its serving steps, which cast them), the token (whole under
    ``replicate_decode_stream``), the caches under
    ``decode_input_shardings`` and the int32 ``cache_pos``; prefill, the
    weights and the batch. ``jax.jit`` drops the arguments a step never
    reads, so the weights at the paths ``unread`` (no op of the port's
    traced step read them: whisper's encoder and cross-attention k/v
    projections in its decode) are left out, and so is ``cache_pos`` for
    a stack with no attention layer (mamba2). XLA's
    ``argument_size_in_bytes`` is this sum (held by
    ``tests/test_torch_dryrun.py``)."""
    from ..sharding import params_only_shardings

    if kind == "train":
        st_sh = train_state_shardings(cfg, plan)
        total = _block_bytes(abstract_train_state(cfg), st_sh, mesh)
        if compressed:
            total += _block_bytes(
                tree_map(lambda p: p.float(),
                         abstract_train_state(cfg)["params"]),
                st_sh["params"], mesh)
        return total + _block_bytes(inputs, batch_shardings(cfg, plan,
                                                            inputs), mesh)
    master = dict(sorted_leaves(abstract_train_state(cfg)["params"]))
    specs = dict(sorted_leaves(params_only_shardings(cfg, plan)))
    read = [p for p in master if p not in set(unread)]
    total = _block_bytes({p: master[p] for p in read},
                         {p: specs[p] for p in read}, mesh)
    if kind == "prefill":
        return total + _block_bytes(inputs, batch_shardings(cfg, plan,
                                                            inputs), mesh)
    dec = decode_input_shardings(cfg, plan, inputs)
    if replicate_stream:
        dec["token"] = P(None, None)
    if not cfg.is_encdec and all(m != "attn" for m, _ in cfg.layer_kinds()):
        # no attention layer reads the position (an SSM-only stack)
        inputs = {k: v for k, v in inputs.items() if k != "cache_pos"}
        dec.pop("cache_pos")
    return total + _block_bytes(inputs, dec, mesh)


def _map_path(fn, tree, specs, path=()):
    if not isinstance(tree, dict):
        return fn(path, tree, specs)
    return {k: _map_path(fn, v, specs[k], path + (k,))
            for k, v in tree.items()}


def _decode_cache_specs(cfg, plan, caches, split: bool, notes: list):
    """The specs of the cache blocks the port's decode takes on this rank
    (``partition.serving_cache_shardings``), each difference from the JAX
    step's ``decode_input_shardings`` named in ``notes``: a whole batch
    where the stream is replicated."""
    want = decode_input_shardings(cfg, plan, {"caches": caches})["caches"]
    ours = serving_cache_shardings(cfg, plan, caches, split)
    changed: Dict = {}

    def note(path, leaf, spec):
        got = ours
        for k in path:
            got = got[k]
        if got != spec:
            changed.setdefault((str(spec), str(got)), []).append(
                "/".join(path))
        return got

    out = _map_path(note, caches, want)
    for (jax_spec, mine), paths in sorted(changed.items()):
        notes.append(f"decode caches {', '.join(paths)}: the port holds "
                     f"{mine} where the JAX step shards {jax_spec} (the "
                     f"stream is the whole batch)")
    return out


def train_notes(cfg, plan) -> list:
    """What the port's sharded train step on ``plan`` does otherwise than
    the JAX step, which XLA partitions by ``train_state_shardings`` (every
    config computes on its ``model`` blocks with the sequence-parallel
    streams and the vocab-parallel loss): attention run whole where its
    heads are replicated, and an encoder-decoder's encoder stream kept
    whole where its frames do not divide the sequence axis."""
    msize = plan.mesh.shape.get("model", 1)
    notes = []
    if (msize > 1 and plan.rules.get("heads") is None
            and any(m == "attn" for m, _ in cfg.layer_kinds())):
        notes.append(f"train: the heads replicated ({cfg.n_heads} q / "
                     f"{cfg.n_kv_heads} kv do not divide model={msize}): "
                     f"attention runs whole on every model rank from the "
                     f"gathered sequence, each rank keeping its block of "
                     f"the output (XLA partitions it itself)")
    n = plan.axis_size(plan.seq_axis)
    if cfg.is_encdec and n > 1 and cfg.enc_seq % n:
        notes.append(f"train: the encoder's {cfg.enc_seq} frames do not "
                     f"divide {plan.seq_axis}={n}: its stream stays whole "
                     f"between the layers, their partial sums all-reduced "
                     f"(XLA places it itself)")
    return notes


def trace_rank(cfg, kind: str, inputs: Dict, mesh, *, fsdp=True,
               replicate_stream: bool = False, accum=(1, None),
               compressed: bool = False, seed: int = 0) -> Dict:
    """This rank's step of ``kind`` on ``mesh`` (a ``launch.mesh.Mesh``)
    over the global ``inputs`` (``configs.specs.input_specs``' tree), run
    as the port runs it under ``make_plan(cfg, mesh, fsdp=)`` with its
    collectives recorded, its new storage counted (`LiveBytes`) and its
    flops counted. On a meta mesh nothing is computed; on a real one
    (gloo ranks on the CPU) the trees are drawn on its device from
    ``seed`` and the step runs for real, each rank calling this.

    Returns {"ops", "collective_bytes", "memory", "traced_flops",
    "port_notes", "plan"}."""
    from torch.utils.flop_counter import FlopCounterMode

    plan = make_plan(cfg, mesh, fsdp=fsdp)
    dev = mesh.device
    real = dev.type != "meta"
    gen = torch.Generator().manual_seed(seed + mesh.rank)

    def placed(tree):
        return _materialize(tree, dev, gen, cfg.vocab_size) if real else tree

    notes: list = []
    parts: Dict[str, int] = {}
    ptree = None
    if kind == "train":
        batch = placed(inputs)
        parts["batch"] = _block_bytes(
            batch, batch_shardings(cfg, plan, batch), mesh)
        st_sh = train_state_shardings(cfg, plan)
        state = shard_tree(placed(abstract_train_state(cfg)), st_sh, mesh)
        if compressed:
            err = init_error_state(state["params"])
            step = steps_mod.make_compressed_train_step(cfg, plan)
            args = (state, batch, err)
            parts["err"] = _storage_bytes(err)
        else:
            accum_steps, accum_dtype = accum
            step = steps_mod.make_train_step(
                cfg, plan=plan, accum_steps=accum_steps,
                accum_dtype=(torch.bfloat16 if accum_dtype
                             else torch.float32))
            args = (state, batch)
        notes.extend(train_notes(cfg, plan))
        parts["params"] = _storage_bytes(state["params"])
        parts["opt"] = _storage_bytes(state["opt"])
        ctx = activation_ctx(None)
    else:
        ptree = shard_tree(placed(abstract_params_tree(cfg)),
                           serving_shardings(cfg, plan), mesh)
        model = steps_mod.make_model(cfg, ptree, plan)
        parts["params"] = _storage_bytes(list(model.parameters())
                                         + list(model.buffers()))
        if kind == "decode":
            b = inputs["token"].shape[0]
            split = batch_axis(plan, b) is not None and not replicate_stream
            bax = plan.batch_axes if split else None
            token = block(placed(inputs["token"]), P(bax, None), mesh)
            specs = _decode_cache_specs(cfg, plan, inputs["caches"], split,
                                        notes)
            caches = _map_path(lambda p, t, s: block(t, s, mesh),
                               placed(inputs["caches"]), specs)
            parts["token"] = _storage_bytes(token)
            parts["caches"] = _storage_bytes(caches)
            notes.append("decode: cache_pos is a Python int (the JAX step's "
                         "int32 scalar argument is not among the port's)")
            if replicate_stream:
                notes.append("decode: replicate_decode_stream: the token "
                             "whole on every rank, the stream the whole "
                             "batch between the layers")
            step = steps_mod.make_decode_step(cfg)
            args = (model, token, caches, 0)
        else:
            b = next(iter(inputs.values())).shape[0]
            split = batch_axis(plan, b) is not None
            bsh = batch_shardings(cfg, plan, inputs)
            batch = _map_path(lambda p, t, s: block(t, s, mesh),
                              placed(inputs), bsh)
            parts["batch"] = _storage_bytes(batch)
            step = steps_mod.make_prefill_step(cfg)
            args = (model, batch)
        ctx = activation_ctx(plan, split)

    flops = FlopCounterMode(display=False)
    live = LiveBytes()
    with record_collectives() as rec, ctx, flops, live:
        out = step(*args)
    unread = [] if ptree is None else [
        path for path, t in sorted_leaves(ptree)
        if t.untyped_storage()._cdata not in live.read]
    jax_args = _jax_argument_bytes(cfg, kind, inputs, plan, mesh,
                                   replicate_stream, compressed, unread)
    memory = {"argument_bytes": sum(parts.values()),
              "output_bytes": _storage_bytes(out),
              "temp_bytes": live.peak,
              "argument_parts": parts,
              "jax_argument_bytes": jax_args,
              "unread_params": unread}
    del out, args
    return {"ops": rec.ops, "collective_bytes": rec.by_kind(),
            "memory": memory, "traced_flops": float(flops.get_total_flops()),
            "port_notes": notes, "plan": plan}


def _mesh_name(shape: Sequence[int]) -> str:
    return "x".join(map(str, shape))


def _overrides(cfg, overrides: Optional[dict]):
    extra = {}
    if overrides:
        overrides = dict(overrides)
        for key in ("replicate_decode_stream", "fsdp"):
            if key in overrides:
                extra[key] = overrides.pop(key)
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg, extra


def dry_run(cfg, shape: ShapeSpec, mesh_shape: Sequence[int],
            axes: Sequence[str], *, extra: Optional[dict] = None,
            accum=(1, None)) -> Dict:
    """One rank's step of ``cfg`` at ``shape`` (a ``ShapeSpec``: batch,
    length, kind) on a mesh of ``mesh_shape`` over ``axes``, traced on
    meta in a fake group of the mesh's ranks (`fake_group`); returns
    `trace_rank`'s dict with ``mesh_shape`` ({axis: size})."""
    extra = extra or {}
    mesh_shape = tuple(mesh_shape)
    inputs = input_specs(cfg, shape.name, shape=shape)
    with fake_group(math.prod(mesh_shape)):
        if mesh_shape in ((16, 16), (2, 16, 16)):
            mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3,
                                        device="meta")
        else:
            mesh = make_debug_mesh(mesh_shape, tuple(axes), device="meta")
        multi = "pod" in mesh.shape and mesh.shape["pod"] > 1
        tr = trace_rank(
            cfg, shape.kind, inputs, mesh, fsdp=extra.get("fsdp", True),
            replicate_stream=bool(extra.get("replicate_decode_stream")),
            accum=accum,
            compressed=(shape.kind == "train" and multi
                        and cfg.grad_compression == "int8_pod"))
        tr["mesh_shape"] = dict(mesh.shape)
    return tr


def small_cell(cell: Dict):
    """(cfg, ShapeSpec, extra overrides) of a cell given as a dict:
    ``arch``, ``kind``, ``batch``, ``seq`` (the decode cache's length),
    optional ``reduced`` (the arch's ``.reduced()`` config) and
    ``overrides`` (config fields, ``fsdp``, ``replicate_decode_stream``)."""
    cfg = get_config(cell["arch"])
    if cell.get("reduced"):
        cfg = cfg.reduced()
    cfg, extra = _overrides(cfg, cell.get("overrides"))
    shape = ShapeSpec(f"{cell['kind']}_{cell['batch']}x{cell['seq']}",
                      cell["seq"], cell["batch"], cell["kind"])
    return cfg, shape, extra


def rank_collectives(mesh, cells: Sequence[Dict], seed: int = 0):
    """Each cell (`small_cell`) run for real on this rank of ``mesh`` (gloo
    ranks: every rank calls this; `trace_rank` on the mesh's device):
    per cell {"counters": the ``mesh.<kind>_bytes`` counters' growth over
    the step, "recorded": the recorded list's input bytes per kind, "ops":
    the recorded list as dicts, "memory"}; in a process group of more than
    one rank, every rank's list (``all_gather_object``). What the dry run
    of the same cell on meta predicts for each rank."""
    from .. import obs
    from ..sharding.comm import HLO_KINDS

    out = []
    for cell in cells:
        cfg, shape, extra = small_cell(cell)
        inputs = input_specs(cfg, shape.name, shape=shape)
        before = {k: obs.counter(f"mesh.{k}_bytes").value for k in HLO_KINDS}
        tr = trace_rank(cfg, shape.kind, inputs, mesh,
                        fsdp=extra.get("fsdp", True),
                        replicate_stream=bool(
                            extra.get("replicate_decode_stream")),
                        seed=seed)
        out.append({
            "counters": {k: obs.counter(f"mesh.{k}_bytes").value - before[k]
                         for k in HLO_KINDS},
            "recorded": tr["collective_bytes"],
            "ops": [op.to_dict() for op in tr["ops"]],
            "memory": tr["memory"]})
    if tdist.is_initialized() and tdist.get_world_size() > 1:
        everyone = [None] * tdist.get_world_size()
        tdist.all_gather_object(everyone, out)
        return everyone
    return out


#: the roofline fields a port record shares bit for bit with the JAX dry
#: run's (the same analytic cost model on the same cell)
ANALYTIC_FIELDS = ("chips", "hlo_flops", "hlo_bytes", "model_flops",
                   "compute_s", "memory_s", "useful_flops_ratio",
                   "analytic_detail")


def compare_to_reference(rec: Dict, want: Dict) -> list:
    """Where the port's record ``rec`` differs from the JAX dry run's
    ``want`` (a cell of ``experiments/dryrun/reference.json``) in what the
    two share: status, skip reason, plan notes, the analytic roofline
    fields, and the argument bytes the JAX step's spec trees give the rank
    (``memory["jax_argument_bytes"]``) against XLA's. Empty when they
    agree."""
    bad = []
    if rec["status"] != want["status"]:
        return [f"status {rec['status']} != {want['status']}"]
    if rec["status"] == "skipped":
        return ([] if rec["reason"] == want["reason"] else
                [f"reason {rec['reason']!r} != {want['reason']!r}"])
    if rec["plan_notes"] != want["plan_notes"]:
        bad.append(f"plan notes {rec['plan_notes']} != {want['plan_notes']}")
    for k in ANALYTIC_FIELDS:
        got = json.loads(json.dumps(rec["roofline"][k]))
        if got != want["roofline"][k]:
            bad.append(f"roofline {k} {got} != {want['roofline'][k]}")
    got = rec["memory"]["jax_argument_bytes"]
    if got != want["memory"]["argument_bytes"]:
        bad.append(f"argument bytes of the JAX specs {got} != XLA's "
                   f"{want['memory']['argument_bytes']}")
    return bad


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: Optional[dict] = None):
    """Trace rank 0's step of one cell on the production mesh (see the
    module docstring): the counterpart of the JAX dry run's lower and
    compile. Returns (trace, mesh shape, cfg, shape, meta dict); raises
    `SkipCell` where the cell does not apply."""
    cfg, extra = _overrides(get_config(arch), overrides)
    ok, why = cell_is_applicable(cfg, shape_name)
    if not ok:
        raise SkipCell(why)
    sh = shape_for(shape_name)
    mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    tr = dry_run(cfg, sh, mesh_shape, axes, extra=extra,
                 accum=TRAIN_ACCUM.get(arch, (1, None)))
    meta = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": step_kind(shape_name), "plan_notes": list(tr["plan"].notes),
    }
    return tr, tr["mesh_shape"], cfg, sh, meta


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, overrides: Optional[dict] = None,
             tag: str = "") -> Dict:
    t0 = time.time()
    try:
        tr, mesh_shape, cfg, sh, meta = lower_cell(
            arch, shape_name, multi_pod, overrides)
    except SkipCell as e:
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "status": "skipped", "reason": str(e)}
        if save:
            _save(rec, tag)
        return rec
    return _finish(tr, mesh_shape, cfg, sh, meta, t0, save, tag)


def _finish(tr, mesh_shape, cfg, sh, meta, t0, save=False, tag=""):
    """The record of a trace: the roofline as the JAX dry run computes it
    (analytic flops and bytes, the collectives this rank issued)."""
    ops = tr["ops"]
    chips = math.prod(mesh_shape.values())
    acost = analytic_cost(cfg, sh, chips)
    mfl = model_flops(cfg, sh)
    roof = roofline_report(acost.flops, acost.hbm_bytes * chips, ops,
                           mesh_shape, mfl)
    roof["traced_flops"] = tr["traced_flops"]
    roof["analytic_detail"] = acost.detail
    mem = tr["memory"]
    rec = {
        **meta,
        "status": "ok",
        "trace_s": round(time.time() - t0, 1),
        "memory": {
            **mem,
            "per_device_total_gb": round(
                (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30, 3),
        },
        "roofline": roof,
        "collective_bytes": tr["collective_bytes"],
        "collectives": [op.to_dict() for op in ops[:200]],
        "port_notes": tr["port_notes"],
    }
    if save:
        _save(rec, tag)
    return rec


def _save(rec: Dict, tag: str = ""):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    (OUT_DIR / name).write_text(json.dumps(rec, indent=1, default=float))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    from ..configs.base import SHAPES

    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                label = f"{arch:24s} {shape_name:12s} {'2x16x16' if multi else '16x16':8s}"
                try:
                    rec = run_cell(arch, shape_name, multi)
                except Exception:
                    n_fail += 1
                    print(f"FAIL {label}")
                    traceback.print_exc()
                    continue
                if rec["status"] == "skipped":
                    n_skip += 1
                    print(f"SKIP {label} ({rec['reason'][:60]})")
                    continue
                n_ok += 1
                r = rec["roofline"]
                print(
                    f"OK   {label} mem={rec['memory']['per_device_total_gb']:7.2f}GB "
                    f"compute={r['compute_s']*1e3:8.2f}ms mem={r['memory_s']*1e3:8.2f}ms "
                    f"coll={r['collective_flat_s']*1e3:8.2f}ms dom={r['dominant']:10s} "
                    f"trace={rec['trace_s']:5.1f}s"
                )
    print(f"\ndone: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())

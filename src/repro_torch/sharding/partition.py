"""Partition-spec trees for the train / prefill / decode steps, and the
blocks they name.

The port of the JAX package's ``sharding/partition.py``. The activation
context lets model code find the plan without threading it through every
call: the steps set it (`activation_ctx`), `current_plan` reads it. The
context also says whether this rank's activations are its block of the
batch over ``plan.batch_axes`` (``split_batch``, set by the steps that
split it) or the whole batch, and whether the training forward keeps its
residual stream sequence-parallel (``seq``, set by the sharded train
step). ``with_sharding_constraint`` changes no
values, so the JAX ``maybe_constrain`` has no counterpart; the one
constraint that moves data, the sequence-parallel stream, is made by the
code that makes the stream: there the embedding and each layer's output
are this rank's block of the sequence over ``plan.seq_axis`` where the
sequence divides it (`seq_axis_for`, the JAX ``maybe_constrain`` rule),
the carry between the layers. The layers gather the sequence back (`seq_gather`) into attention
and the MLP and reduce their partial sums onto the block (`psum_rule`
with ``seq``: a ``psum_scatter``).

The spec builders return trees of `rules.P` where the JAX package returns
``NamedSharding``s of the same specs. `shard_tree` is the executable
counterpart of ``jax.device_put(tree, shardings)``: this rank's block of
each leaf (the one ``addressable_shards`` holds on the device at this
rank's mesh coordinates); `gather_tree` rebuilds the whole leaves from the
blocks (``all_gather`` over each dimension's axes; its gradient is the
reduce-scatter).

Serving under a plan (the port of the JAX package's serving steps run on
``params_only_shardings`` and ``decode_input_shardings``, which XLA
partitions) needs three more seams, used by the layer code:
`rule_of_block` (the mesh axes a leaf's dimension is a block along),
`psum_rule` (the sum of a partial product over them) and `gather_leaf`'s
``keep`` (the per-layer FSDP gather over the axes other than ``model``;
`tp_keep`). Training under a plan computes on the same blocks. Every
config is served and trained on blocks, the encoder-decoder too;
`serving_shardings` / `serving_cache_shardings` give the blocks a rank
holds.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import torch

from .rules import P, ShardingPlan, param_shardings
from ..models import steps as steps_mod
from ..models.common import tree_map

__all__ = [
    "activation_ctx", "current_plan", "split_batch",
    "batch_axis", "rebatch", "train_state_shardings", "batch_shardings",
    "decode_input_shardings", "params_only_shardings", "shard_tree",
    "gather_tree", "block", "gather_leaf", "holds_blocks", "rule_of_block",
    "psum_rule", "serving_shardings",
    "serving_cache_shardings", "cache_seq_sharded", "block_shape",
    "seq_axis_for", "seq_block", "seq_gather", "tp_keep",
]

_ACT: Tuple[Optional[ShardingPlan], bool, bool, bool] = (None, False, False,
                                                         False)


@contextmanager
def activation_ctx(plan: Optional[ShardingPlan], split_batch: bool = False,
                   blocks: bool = False, seq: bool = False):
    """Make ``plan`` the current one; ``split_batch``: this rank's
    activations are its block of the batch over ``plan.batch_axes``;
    ``blocks``: the model running holds this rank's blocks of its weights
    and caches (`serving_shardings`, `serving_cache_shardings`; set by a
    ``models.transformer.Transformer`` built on them); ``seq``: the
    training forward keeps its residual stream as this rank's block of the
    sequence over ``plan.seq_axis`` (`seq_axis_for`; set by the sharded
    train step, live through its backward, where the remat recomputes the
    layers)."""
    global _ACT
    prev = _ACT
    _ACT = (plan, bool(split_batch and plan is not None),
            bool(blocks and plan is not None), bool(seq and plan is not None))
    try:
        yield
    finally:
        _ACT = prev


def current_plan() -> Optional[ShardingPlan]:
    return _ACT[0]


def split_batch() -> bool:
    """Whether the activations under the current plan are this rank's block
    of the batch (over ``plan.batch_axes``)."""
    return _ACT[1]


def holds_blocks() -> bool:
    """Whether the running model holds this rank's blocks (under the
    current plan): a layer whose own weights are whole along ``model``
    (replicated heads) then still meets a sequence-sharded cache."""
    return _ACT[2]


def rule_of_block(rule: str, local: int, whole: int):
    """The mesh axes of ``plan.rules[rule]`` when a leaf's ``local``
    extent along that logical axis is a block of ``whole``, else None.
    Raises when a block meets no plan, or one that does not split the axis
    so: a rank never computes on a block as if it were the whole."""
    if local == whole:
        return None
    plan = current_plan()
    axes = None if plan is None else plan.rules.get(rule)
    if axes is None or local * plan.axis_size(axes) != whole:
        raise ValueError(
            f"a {rule} block of {local} of {whole} under "
            f"{'no plan' if plan is None else f'the rule {axes!r}'}: a "
            f"model built on blocks runs under the plan they came from "
            f"(partition.activation_ctx)")
    return axes


def psum_rule(x: torch.Tensor, axes, seq=None) -> torch.Tensor:
    """The sum over the mesh ``axes`` (a rule's entry, from
    `rule_of_block`; None gives ``x``) of this rank's partial ``x``, a
    product over its block of a contracted axis. A bf16 partial is summed
    in float32 and rounded once: XLA's CPU all-reduce promotes a bf16 sum
    so (``add.clone_promoted``), where gloo would add in bf16.

    ``seq`` (the stream's sequence axis, `seq_axis_for`; ``x`` a
    ``(B, S, D)`` product over the whole sequence): this rank's sequence
    block of that sum, where the sequence-parallel stream goes on. Over the
    same axis that is ``comm.psum_scatter`` along dim 1 (a bf16 partial
    again summed in float32 and rounded once, as XLA's CPU reduce-scatter
    promotes it); a whole ``x`` (``axes`` None: the heads or the MLP not
    split) is the same on every rank, and the rank keeps its block."""
    if seq is not None:
        from ..launch.mesh import axes_tuple

        if axes is not None and axes_tuple(axes) == axes_tuple(seq):
            from .comm import psum_scatter

            return psum_scatter(x, current_plan().mesh, seq, 1)
        return seq_block(psum_rule(x, axes), seq)
    if axes is None:
        return x
    from .comm import psum

    mesh = current_plan().mesh
    if x.dtype == torch.bfloat16:
        return psum(x.float(), mesh, axes).to(torch.bfloat16)
    return psum(x, mesh, axes)


def seq_axis_for(s: int):
    """The mesh axis the training forward's residual stream of ``s``
    positions shards its sequence over: ``plan.seq_axis`` under a context
    with ``seq`` set where ``s`` divides it (the JAX ``maybe_constrain``
    rule), else None (the stream whole)."""
    plan = current_plan()
    if not _ACT[3] or plan is None or plan.seq_axis is None:
        return None
    n = plan.axis_size(plan.seq_axis)
    return plan.seq_axis if n > 1 and s % n == 0 else None


def seq_block(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's block of a whole ``(B, S, ...)`` ``x`` along dim 1 over
    ``axis`` (a copy: the whole is freed once its last user is done)."""
    mesh = current_plan().mesh
    s = x.shape[1] // mesh.axis_size(axis)
    return x.narrow(1, mesh.axis_index(axis) * s, s).clone(
        memory_format=torch.contiguous_format)


def seq_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """The whole sequence from this rank's block (``all_gather`` over
    ``axis`` along dim 1); its backward, the reduce-scatter of the
    cotangent, sums a bf16 one in float32 (``comm.psum_scatter``)."""
    from .comm import all_gather

    return all_gather(x, current_plan().mesh, axis, 1)


def batch_axis(plan: ShardingPlan, b: int):
    """The batch axes a global batch of ``b`` shards over (None when it
    does not divide them or is smaller), the rule of every builder here."""
    bsz = plan.axis_size(plan.batch_axes) if plan.batch_axes else 1
    return plan.batch_axes if (plan.batch_axes and b % bsz == 0
                               and b >= bsz) else None


def rebatch(x: torch.Tensor, plan: ShardingPlan, have: bool,
            want: bool) -> torch.Tensor:
    """``x`` (batch on dim 0) from this rank's block of the batch over
    ``plan.batch_axes`` (``have``) or the whole batch to the block
    (``want``) or the whole: an ``all_gather`` (its gradient the
    reduce-scatter) or this rank's slice."""
    from .comm import all_gather

    if have == want:
        return x
    mesh, axes = plan.mesh, plan.batch_axes
    if have:
        return all_gather(x, mesh, axes, 0)
    b = x.shape[0] // mesh.axis_size(axes)
    i = mesh.axis_index(axes)
    return x[i * b:(i + 1) * b]


def train_state_shardings(cfg, plan: ShardingPlan) -> Dict:
    p_sh = param_shardings(steps_mod.model_param_specs(cfg), plan)
    return {"params": p_sh, "opt": {"m": p_sh, "v": p_sh, "step": P()}}


def params_only_shardings(cfg, plan: ShardingPlan) -> Any:
    return param_shardings(steps_mod.model_param_specs(cfg), plan)


def batch_shardings(cfg, plan: ShardingPlan, batch_tree: Any) -> Any:
    """Specs for a train/prefill input batch tree (by array rank)."""
    def one(leaf):
        nd = len(leaf.shape)
        first = batch_axis(plan, leaf.shape[0]) if nd else None
        return P(first, *([None] * (nd - 1)))

    return tree_map(one, batch_tree)


def _map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    if not isinstance(tree, dict):
        return fn(path, tree)
    return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}


def decode_input_shardings(cfg, plan: ShardingPlan, inputs: Any) -> Any:
    """Specs for {token, caches, cache_pos} (path-aware).

    Attention KV caches (path ends .../k or .../v; (L, B, S, KV, hd)) shard
    batch + either the KV-head dim (head TP) or the sequence dim (SP
    fallback / long_500k). SSM states (.../ssm: (L, B, H, P, N)) shard batch
    + heads; conv tails (.../conv) shard batch only.
    """
    bsz = plan.axis_size(plan.batch_axes) if plan.batch_axes else 1

    def one(path, leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        last = path[-1] if path else ""
        if last in ("k", "v", "k_scale", "v_scale"):  # (L, B, S, KV, hd|1)
            _, b, s, kv, _ = leaf.shape
            bax = batch_axis(plan, b)
            kvr = plan.rules.get("kv_heads")
            if kvr and kv % plan.axis_size(kvr) == 0:
                return P(None, bax, None, kvr, None)
            cax = plan.cache_seq_axis
            if cax and s % plan.axis_size(cax) == 0:
                if bax is None and s % (bsz * plan.axis_size(cax)) == 0:
                    # long_500k: batch=1 — spread the cache over everything
                    allax = (plan.batch_axes or ()) + (cax,)
                    return P(None, None, allax, None, None)
                return P(None, bax, cax, None, None)
            return P(None, bax, None, None, None)
        if last == "ssm":                          # (L, B, H, P, N)
            _, b, h = leaf.shape[:3]
            bax = batch_axis(plan, b)
            hax = plan.rules.get("ssm_heads")
            if hax and h % plan.axis_size(hax) == 0:
                return P(None, bax, hax, None, None)
            return P(None, bax, None, None, None)
        if last == "conv":                         # (L, B, K-1, C)
            return P(None, batch_axis(plan, leaf.shape[1]), None, None)
        if last == "token":                        # (B, 1)
            return P(batch_axis(plan, leaf.shape[0]), None)
        return P(*([None] * nd))

    return _map_with_path(one, inputs)


# -- blocks --------------------------------------------------------------------

def block(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a copy that owns its
    storage)."""
    out = x
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = mesh.axis_size(entry)
        size = x.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(entry) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def block_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of this rank's block of a leaf of ``shape`` under
    ``spec``."""
    return tuple(n if e is None else n // mesh.axis_size(e)
                 for n, e in zip(shape, spec))


def gather_leaf(x: torch.Tensor, spec: P, mesh, keep=()) -> torch.Tensor:
    """The whole leaf from this rank's block: one ``all_gather`` per
    sharded dimension over its axes (differentiable). A dimension whose
    entry names an axis in ``keep`` stays this rank's block (``keep=
    ("model",)``: the per-layer FSDP gather of a tensor-parallel layer)."""
    from ..launch.mesh import axes_tuple
    from .comm import all_gather

    for dim, entry in enumerate(spec):
        if entry is not None and not set(axes_tuple(entry)) & set(keep):
            x = all_gather(x, mesh, entry, dim)
    return x


def _zip_map(fn, tree: Any, specs: Any) -> Any:
    if not isinstance(tree, dict):
        return fn(tree, specs)
    return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}


def shard_tree(tree: Any, spec_tree: Any, mesh) -> Any:
    """``jax.device_put(tree, NamedSharding(mesh, spec))`` seen from this
    rank: its block of each leaf."""
    return _zip_map(lambda x, s: block(x, s, mesh), tree, spec_tree)


def gather_tree(tree: Any, spec_tree: Any, mesh, keep=()) -> Any:
    """Every leaf whole again from the ranks' blocks (`gather_leaf`; but
    along the axes in ``keep``)."""
    return _zip_map(lambda x, s: gather_leaf(x, s, mesh, keep), tree,
                    spec_tree)


# -- serving on blocks ---------------------------------------------------------

def tp_keep(name: str, key: str, layer_spec: Dict) -> Tuple[str, ...]:
    """``gather_leaf``'s ``keep`` for leaf ``key`` of part ``name`` of a
    tensor-parallel layer (``layer_spec``: the layer's per-layer specs by
    part): its ``model`` block stays the rank's (an SSM's ``ssm_inner``
    and ``ssm_heads`` leaves; ``wB``, ``wC`` and the conv have none and
    arrive whole), but an MoE layer's router and, where ``model`` does not
    split the experts, its experts, which the JAX ``shard_map`` takes
    whole (``in_specs`` ``P(None, None)``, ``P(None, None, None)``)."""
    if name == "moe" and (key == "router"
                          or layer_spec["moe"]["wi"][0] != "model"):
        return ()
    return ("model",)


def serving_shardings(cfg, plan: ShardingPlan) -> Any:
    """The specs of the weights a rank serves ``cfg`` on: the JAX serving
    steps' `params_only_shardings`."""
    return params_only_shardings(cfg, plan)


def cache_seq_sharded(cfg, plan: ShardingPlan) -> bool:
    """Whether the attention caches shard their sequence over
    ``plan.cache_seq_axis`` (the heads stay whole: the kv heads do not
    divide ``model``)."""
    kvr = plan.rules.get("kv_heads")
    heads = bool(kvr) and cfg.n_kv_heads % plan.axis_size(kvr) == 0
    return plan.cache_seq_axis is not None and not heads


def serving_cache_shardings(cfg, plan: ShardingPlan, caches: Any,
                            split: bool) -> Any:
    """The specs of the cache blocks a rank's decode takes (``caches``:
    the global tree) when its stream is its block of the batch
    (``split``) or the whole batch: `decode_input_shardings`' (kv heads
    over ``model``, or the sequence over ``plan.cache_seq_axis`` where it
    divides it, else whole: an encoder-decoder's cross caches too; an SSM
    layer's state its heads over ``ssm_heads``, its conv tail whole over
    ``model``), with the batch entry dropped where the stream is whole;
    but the seq-sharded flash-decode's (``decode_attention="sharded"``),
    which takes `decode_input_shardings`' whole."""
    want = decode_input_shardings(cfg, plan, {"caches": caches})["caches"]

    def one(path, spec):
        kv = path[-1] in ("k", "v", "k_scale", "v_scale")
        if kv and cfg.decode_attention == "sharded" and plan.cache_seq_axis:
            return spec
        if kv and isinstance(spec[2], tuple):
            raise ValueError(
                f"the cache spreads its sequence over {spec[2]} (a batch "
                f"that does not divide {plan.batch_axes}): the port's "
                f"tensor-parallel decode splits the batch over them")
        return P(spec[0], spec[1] if split else None, *spec[2:])

    return _map_with_path(lambda path, s: one(path, s), want)

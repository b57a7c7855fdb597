"""Partition-spec trees for the train / prefill / decode steps, and the
blocks they name.

The port of the JAX package's ``sharding/partition.py``. The activation
context lets model code find the plan without threading it through every
call: the steps set it (`activation_ctx`), `current_plan` reads it.
`maybe_constrain` returns its input: ``with_sharding_constraint`` changes
no values, and the port's activations have no placement to constrain. The
context also says whether this rank's activations are its block of the
batch over ``plan.batch_axes`` (``split_batch``, set by the steps that
split it) or the whole batch.

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
``keep`` (the per-layer FSDP gather over the axes other than ``model``).
`tensor_parallel` says which configs are served on blocks;
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
    "activation_ctx", "current_plan", "maybe_constrain", "split_batch",
    "batch_axis", "rebatch", "train_state_shardings", "batch_shardings",
    "decode_input_shardings", "params_only_shardings", "shard_tree",
    "gather_tree", "block", "gather_leaf", "holds_blocks", "rule_of_block",
    "psum_rule", "tensor_parallel", "serving_shardings",
    "serving_cache_shardings", "cache_seq_sharded", "block_shape",
]

_ACT: Tuple[Optional[ShardingPlan], bool, bool] = (None, False, False)


@contextmanager
def activation_ctx(plan: Optional[ShardingPlan], split_batch: bool = False,
                   blocks: bool = False):
    """Make ``plan`` the current one; ``split_batch``: this rank's
    activations are its block of the batch over ``plan.batch_axes``;
    ``blocks``: the model running holds this rank's blocks of its weights
    and caches (`serving_shardings`, `serving_cache_shardings`; set by a
    ``models.transformer.Transformer`` built on them)."""
    global _ACT
    prev = _ACT
    _ACT = (plan, bool(split_batch and plan is not None),
            bool(blocks and plan is not None))
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


def psum_rule(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum over the mesh ``axes`` (a rule's entry, from
    `rule_of_block`; None gives ``x``) of this rank's partial ``x``, a
    product over its block of a contracted axis. A bf16 partial is summed
    in float32 and rounded once: XLA's CPU all-reduce promotes a bf16 sum
    so (``add.clone_promoted``), where gloo would add in bf16."""
    if axes is None:
        return x
    from .comm import psum

    mesh = current_plan().mesh
    if x.dtype == torch.bfloat16:
        return psum(x.float(), mesh, axes).to(torch.bfloat16)
    return psum(x, mesh, axes)


def maybe_constrain(x: torch.Tensor, kind: str = "hidden") -> torch.Tensor:
    """``with_sharding_constraint`` under a plan: the values unchanged."""
    return x


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

def tensor_parallel(cfg) -> bool:
    """Whether the port serves ``cfg`` under a plan on this rank's blocks
    (`serving_shardings`): the dense decoder-only and MoE configs. The SSM
    and hybrid stacks, the encoder-decoder and the prefix configs keep
    their weights whole on every rank."""
    return (not cfg.is_encdec and not cfg.n_prefix_tokens
            and all(m == "attn" for m, _ in cfg.layer_kinds()))


def serving_shardings(cfg, plan: ShardingPlan) -> Any:
    """The specs of the weights a rank serves ``cfg`` on: the JAX serving
    steps' `params_only_shardings` for a `tensor_parallel` config, every
    leaf whole for the others."""
    specs = params_only_shardings(cfg, plan)
    if tensor_parallel(cfg):
        return specs
    return tree_map(lambda s: P(*([None] * len(s))), specs)


def cache_seq_sharded(cfg, plan: ShardingPlan) -> bool:
    """Whether a `tensor_parallel` config's attention caches shard their
    sequence over ``plan.cache_seq_axis`` (the heads stay whole: the kv
    heads do not divide ``model``)."""
    kvr = plan.rules.get("kv_heads")
    heads = bool(kvr) and cfg.n_kv_heads % plan.axis_size(kvr) == 0
    return plan.cache_seq_axis is not None and not heads


def serving_cache_shardings(cfg, plan: ShardingPlan, caches: Any,
                            split: bool) -> Any:
    """The specs of the cache blocks a rank's decode takes (``caches``:
    the global tree) when its stream is its block of the batch
    (``split``) or the whole batch: `decode_input_shardings`' for a
    `tensor_parallel` config (kv heads over ``model``, or the sequence
    over ``plan.cache_seq_axis``), with the batch entry dropped where the
    stream is whole; for the other configs the batch entry only, but the
    seq-sharded flash-decode's (``decode_attention="sharded"``), which
    takes `decode_input_shardings`' whole."""
    want = decode_input_shardings(cfg, plan, {"caches": caches})["caches"]
    tp = tensor_parallel(cfg)

    def one(path, spec):
        if (path[-1] in ("k", "v", "k_scale", "v_scale")
                and cfg.decode_attention == "sharded"
                and plan.cache_seq_axis):
            return spec
        if not tp:
            return P(None, spec[1] if split else None,
                     *([None] * (len(spec) - 2)))
        if isinstance(spec[2], tuple):
            raise ValueError(
                f"the cache spreads its sequence over {spec[2]} (a batch "
                f"that does not divide {plan.batch_axes}): the port's "
                f"tensor-parallel decode splits the batch over them")
        return P(spec[0], spec[1] if split else None, *spec[2:])

    return _map_with_path(lambda path, s: one(path, s), want)

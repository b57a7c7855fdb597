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
    "gather_tree", "block", "gather_leaf",
]

_ACT: Tuple[Optional[ShardingPlan], bool] = (None, False)


@contextmanager
def activation_ctx(plan: Optional[ShardingPlan], split_batch: bool = False):
    """Make ``plan`` the current one; ``split_batch``: this rank's
    activations are its block of the batch over ``plan.batch_axes``."""
    global _ACT
    prev = _ACT
    _ACT = (plan, bool(split_batch and plan is not None))
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


def gather_leaf(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block: one ``all_gather`` per
    sharded dimension over its axes (differentiable)."""
    from .comm import all_gather

    for dim, entry in enumerate(spec):
        if entry is not None:
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


def gather_tree(tree: Any, spec_tree: Any, mesh) -> Any:
    """Every leaf whole again from the ranks' blocks (`gather_leaf`)."""
    return _zip_map(lambda x, s: gather_leaf(x, s, mesh), tree, spec_tree)

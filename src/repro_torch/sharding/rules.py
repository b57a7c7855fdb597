"""Logical-axis -> mesh-axis rules with divisibility-aware fallbacks.

The port of the JAX package's ``sharding/rules.py``; the rules, notes and
specs are the same, held bit-equal by ``tests/test_torch_sharding.py``.

Strategy per architecture:
  * FSDP/ZeRO-3: the `embed` (d_model) dim of every parameter shards over
    the `data` axis — optimizer state is fully sharded, compute params are
    gathered layer by layer.
  * TP over `model`: vocab, d_ff (`mlp`), experts (EP), SSM inner dim /
    heads — each applied only if the dim divides the axis and the mesh axis
    is not already used by an earlier dim of the same tensor.
  * Attention heads shard over `model` only when n_kv_heads divides it;
    otherwise heads stay replicated and (for pure-attention archs) the
    sequence dim of activations shards over `model` instead (SP).

`P` is the port's ``PartitionSpec``: a tuple with one entry a dimension,
an axis name, a tuple of names or None. ``plan.mesh`` is anything with an
ordered ``shape`` dict (``launch.mesh.Mesh``, or a stand-in when no rank
exists).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ..models.common import Spec, tree_map

__all__ = ["P", "ShardingPlan", "make_plan", "param_shardings",
           "spec_to_pspec"]


def _entry(e):
    """One entry as ``PartitionSpec`` keeps it: a tuple (or list) of one
    name is the name, an empty one None, a longer one a tuple."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """``PartitionSpec(*entries)``: the mesh axes of each dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Resolved rules for one (arch, mesh) pair."""

    mesh: Any
    rules: Dict[str, Any]          # logical axis -> mesh axis (or tuple)
    batch_axes: Tuple[str, ...]    # mesh axes sharding the batch dim
    seq_axis: Optional[str]        # SP: mesh axis for activation seq dim
    cache_seq_axis: Optional[str]  # decode-cache sequence sharding
    notes: Tuple[str, ...] = ()

    def axis_size(self, name) -> int:
        if name is None:
            return 1
        if isinstance(name, tuple):
            out = 1
            for n in name:
                out *= self.mesh.shape[n]
            return out
        return self.mesh.shape[name]

    def hidden_pspec(self) -> P:
        return P(self.batch_axes, self.seq_axis, None)

    def batch_pspec(self, ndim: int) -> P:
        return P(self.batch_axes, *([None] * (ndim - 1)))


def make_plan(cfg, mesh, *, fsdp: bool = True,
              seq_parallel: Optional[bool] = None) -> ShardingPlan:
    axes = dict(mesh.shape)
    model = "model" if "model" in axes else None
    data = "data" if "data" in axes else None
    pod = "pod" if "pod" in axes else None
    msize = axes.get("model", 1)
    dsize = axes.get("data", 1)
    notes = []

    def divisible(n, size):
        return n > 0 and size > 1 and n % size == 0

    attn_tp = divisible(cfg.n_kv_heads, msize) and divisible(cfg.n_heads, msize)
    if not attn_tp and cfg.n_heads:
        notes.append(
            f"attention heads ({cfg.n_heads}q/{cfg.n_kv_heads}kv) not divisible "
            f"by model={msize}: heads replicated"
        )
    ep = divisible(cfg.n_experts, msize)
    if cfg.n_experts and not ep:
        notes.append(
            f"{cfg.n_experts} experts not divisible by model={msize}: "
            f"falling back to TP over expert d_ff={cfg.moe_d_ff or cfg.d_ff}"
        )

    # fsdp: True -> ZeRO-3 over `data`; "pod_data" -> also across pods
    fsdp_axes: Any = None
    if fsdp:
        if fsdp == "pod_data" and pod is not None:
            if divisible(cfg.d_model, dsize * axes.get("pod", 1)):
                fsdp_axes = (pod, data)
        elif divisible(cfg.d_model, dsize):
            fsdp_axes = data
    rules: Dict[str, Any] = {
        "vocab": model if divisible(cfg.padded_vocab, msize) else None,
        "embed": fsdp_axes,
        "mlp": model if divisible(cfg.d_ff or cfg.moe_d_ff, msize) or
                        divisible(cfg.moe_d_ff, msize) else None,
        "heads": model if attn_tp else None,
        "kv_heads": model if attn_tp else None,
        "head_dim": None,
        "experts": model if ep else None,
        "layers": None,
        "ssm_inner": model if divisible(cfg.ssm_d_inner, msize) else None,
        "ssm_heads": model if divisible(cfg.ssm_nheads, msize) else None,
    }

    # batch sharding: all pure-data axes
    batch_axes = tuple(a for a in (pod, data) if a is not None)

    # sequence-parallel residual stream over `model` (a placement only: the
    # port's activations stay whole along the sequence)
    if seq_parallel is None:
        seq_parallel = True
    seq_axis = model if seq_parallel else None
    if seq_parallel:
        notes.append("sequence-parallel residual stream over model axis")

    # decode caches: shard seq when heads can't shard
    cache_seq_axis = None if attn_tp else model

    return ShardingPlan(
        mesh=mesh, rules=rules, batch_axes=batch_axes, seq_axis=seq_axis,
        cache_seq_axis=cache_seq_axis, notes=tuple(notes),
    )


def spec_to_pspec(spec: Spec, plan: ShardingPlan) -> P:
    """Logical axes -> PartitionSpec, skipping conflicts / non-divisible."""
    used = set()
    out = []
    for dim, ax in zip(spec.shape, spec.axes):
        mesh_ax = plan.rules.get(ax) if ax is not None else None
        if mesh_ax is None:
            out.append(None)
            continue
        parts = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        sz = plan.axis_size(mesh_ax)
        if used & set(parts) or dim % sz != 0:
            out.append(None)
            continue
        used.update(parts)
        out.append(mesh_ax)
    return P(*out)


def param_shardings(specs: Any, plan: ShardingPlan) -> Any:
    """Spec tree -> tree of `P` (the JAX package's ``NamedSharding`` tree
    has these specs on ``plan.mesh``)."""
    return tree_map(lambda s: spec_to_pspec(s, plan), specs)

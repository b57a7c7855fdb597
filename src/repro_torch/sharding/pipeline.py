"""GPipe-style pipeline parallelism over a mesh axis.

The port of the JAX package's ``sharding/pipeline.py`` (``shard_map`` +
``ppermute``), on the ranks of a ``launch.mesh.Mesh``.

Intended placement: the `pod` axis — pipeline stages map onto pods so the
only cross-pod traffic is the (microbatch, d_model) activation handoff per
tick.

Schedule: classic GPipe fill-drain. With S stages and M microbatches the
loop runs M + S - 1 ticks; stage s computes microbatch m at tick t = m + s.
Bubble fraction = (S-1)/(M+S-1). The handoff to stage s+1 is
`comm.ppermute` and the last stage's buffer reaches every rank as a masked
`comm.psum`; both are ``torch.autograd.Function``s whose backward is the
reverse permutation and the sum, so the backward runs the schedule in
reverse as ``jax.grad`` through ``ppermute`` does.

`pipeline_apply(stage_fn, stage_params, x, mesh, axis)`:
  * stage_params: this rank's block of a tree (dicts, tuples, lists)
    whose leaves have leading dim n_stages (``partition.shard_tree`` with
    ``P(axis)``): leading dim 1;
  * stage_fn(params_slice, x_mb) -> y_mb applies ONE stage to one microbatch;
  * x: (M, mb, ...) microbatched input, whole on every rank; returns
    (M, mb, ...) outputs as produced by the LAST stage, on every rank.

Gradients follow ``sharding.comm``'s partial convention: a loss every rank
holds is backpropagated as ``loss / mesh.size``, and a stage's parameter
gradient is summed over the mesh axes other than ``axis``
(``comm.reduce_grads``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from .comm import ppermute, psum

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _first(tree: Any) -> Any:
    """Each leaf's first slice; a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_first(v) for v in tree)
    return tree[0]


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   mesh, axis: str = "pod") -> torch.Tensor:
    """Run x through n_stages = mesh.shape[axis] pipeline stages.

    x: (M, mb, ...) — M microbatches. Stage s lives on rank s of `axis`.
    """
    s_count = mesh.shape[axis]
    m_count = x.shape[0]
    ticks = m_count + s_count - 1
    perm = [(i, i + 1) for i in range(s_count - 1)]  # stage s -> s+1
    params_me = _first(stage_params)
    sid = mesh.axis_index(axis)

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(b, device=x.device)

    # every rank keeps each collective's operands in its autograd graph (as
    # the reference's jnp.where does), so all ranks run every backward
    recv = torch.zeros_like(x[0])
    outs = [torch.zeros_like(x[0]) for _ in range(m_count)]
    for t in range(ticks):
        # stage 0 feeds microbatch t (while t < M); others use recv
        x_mb = x[min(max(t, 0), m_count - 1)]
        inp = torch.where(flag(sid == 0), x_mb, recv)
        y = stage_fn(params_me, inp)
        # mask ticks where this stage has no live microbatch
        live = t >= sid and t - sid < m_count
        y = torch.where(flag(live), y, torch.zeros_like(y))
        # last stage commits its finished microbatch t - (S-1)
        o_idx = min(max(t - (s_count - 1), 0), m_count - 1)
        commit = sid == s_count - 1 and t >= s_count - 1
        outs[o_idx] = torch.where(flag(commit), y, outs[o_idx])
        # hand off to the next stage
        recv = ppermute(y, mesh, axis, perm)
    out_buf = torch.stack(outs)
    # broadcast the last stage's buffer to every rank
    mask = 1.0 if sid == s_count - 1 else 0.0
    return psum(out_buf * mask, mesh, axis)

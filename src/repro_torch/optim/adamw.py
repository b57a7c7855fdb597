"""AdamW on explicit trees of tensors (no ``torch.optim``).

The port of the JAX package's ``optim/adamw.py``. A tree is a nested dict
of tensors in the JAX layout, and its leaves are visited in the JAX
package's order (``models.common.sorted_leaves``), so the global norm sums
the leaves in the same order. The update runs in float32 leaf by leaf, as
the JAX package writes it: the bias corrections ``1 - b ** step`` on a
device scalar, the weight decay added to the update (decoupled, times
``lr``). Params keep their (master) dtype and moments ``moment_dtype``.

`apply_updates` writes the new params and moments into the given tensors
(a jitted JAX step with its state donated does the same) and returns them
with the new step: at gemma-2b's full width a second copy of the float32
master and moments would not fit beside the first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.common import sorted_leaves, tree_map

__all__ = ["AdamWConfig", "init_state", "apply_updates", "global_norm",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32


def _leaves(tree: Any):
    return [leaf for _, leaf in sorted_leaves(tree)]


def init_state(params: Any, cfg: AdamWConfig) -> Dict:
    """Zero moments beside each param (on its device) and step 0 (int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    device = _leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in the JAX order) of each leaf's float32
    sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # max_norm / (norm + 1e-9) as a true division (torch's ``float /
    # tensor`` multiplies by the reciprocal)
    num = torch.full((), max_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(num / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: Dict, cfg: AdamWConfig,
                  lr: Optional[torch.Tensor] = None,
                  norm: Optional[torch.Tensor] = None) -> Tuple[Any, Dict]:
    """One AdamW step; returns (params, {"m", "v", "step"}), the params and
    moments updated in place and the step a new tensor. ``lr`` (a device
    scalar or a float) defaults to ``cfg.lr``. With ``grad_clip > 0`` the
    gradients are clipped by their global norm first, leaf by leaf as
    `clip_by_global_norm` rounds them (no clipped copy of the tree is
    kept); ``norm`` is that norm when the caller has it (a rank holding
    blocks of the gradient passes the whole gradient's)."""
    step = state["step"] + 1
    lr = cfg.lr if lr is None else lr
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    if norm is None and cfg.grad_clip > 0:
        norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.grad_clip) if cfg.grad_clip > 0 else None

    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(state["m"]), _leaves(state["v"])):
        gf = g.float()
        if scale is not None:
            gf = (gf * scale).to(g.dtype).float()
        # m * b1 + g * (1 - b1) and v * b2 + g * g * (1 - b2), each product
        # rounded once and then added, as the JAX package computes them
        mf = m.float() * b1
        mf += gf * (1 - b1)
        vf = gf * gf
        vf *= 1 - b2
        vf += v.float() * b2
        del gf
        den = vf / c2
        den.sqrt_()
        den += cfg.eps
        delta = mf / c1
        delta /= den
        del den
        delta += cfg.weight_decay * p.float()
        delta *= lr
        p.copy_(p.float() - delta)
        m.copy_(mf)
        v.copy_(vf)
    return params, {"m": state["m"], "v": state["v"], "step": step}

"""LR schedules: linear warmup into cosine or constant decay.

The port of the JAX package's ``optim/schedule.py``, on a device scalar
``step`` (no host read). A constant divisor is the product by its float32
reciprocal (``models.common.div``), as the jitted JAX step computes it.
"""
from __future__ import annotations

import math

import torch

from ..models.common import div

__all__ = ["warmup_cosine", "warmup_constant"]


def warmup_cosine(step: torch.Tensor, base_lr: float, warmup: int,
                  total: int, final_frac: float = 0.1) -> torch.Tensor:
    step = step.float()
    warm = div(base_lr * step, max(warmup, 1))
    prog = torch.clamp(div(step - warmup, max(total - warmup, 1)), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, base_lr * cos)


def warmup_constant(step: torch.Tensor, base_lr: float,
                    warmup: int) -> torch.Tensor:
    step = step.float()
    return torch.clamp(div(base_lr * step, max(warmup, 1)), max=base_lr)

"""Gated/plain feed-forward blocks (SwiGLU / GeGLU / GELU).

The port of the JAX package's ``models/mlp.py``: GeGLU's
``jax.nn.gelu(approximate=True)`` is ``F.gelu(approximate="tanh")``, SwiGLU
gates with ``F.silu``; the products keep the operands' dtype.

A rank holding its block of d_ff (wi / wg its column blocks, wo its row
block along ``mlp``; ``sharding.partition.serving_shardings``) computes
its share of the hidden units and reduces the down-projection's partial
sum over their mesh axes, as XLA partitions the reference under
``params_only_shardings``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import Spec, einsum

__all__ = ["param_specs", "mlp"]


def param_specs(cfg, d_ff: int | None = None) -> Dict[str, Spec]:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "wi": Spec((d, f), ("embed", "mlp")),
            "wg": Spec((d, f), ("embed", "mlp")),
            "wo": Spec((f, d), ("mlp", "embed")),
        }
    return {
        "wi": Spec((d, f), ("embed", "mlp")),
        "wo": Spec((f, d), ("mlp", "embed")),
    }


def _act(cfg):
    if cfg.act == "swiglu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def mlp(p: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    act = _act(cfg)
    h = einsum("...d,df->...f", x, p["wi"])
    if "wg" in p:
        h = act(einsum("...d,df->...f", x, p["wg"])) * h
    else:
        h = act(h)
    from ..sharding.partition import psum_rule, rule_of_block

    y = einsum("...f,fd->...d", h, p["wo"])
    return psum_rule(y, rule_of_block("mlp", p["wo"].shape[0], cfg.d_ff))

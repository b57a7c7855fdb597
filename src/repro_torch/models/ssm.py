"""Mamba-2 (SSD) mixer: parameter specs only.

The shapes of the JAX package's ``models/ssm.py`` (the parameter counts of
``configs.base.ModelConfig`` need them). The chunked scan and the
O(1)-state decode wait for ROADMAP Queue 1 item 2;
``transformer.check_supported`` refuses an SSM or hybrid config before
anything runs.
"""
from __future__ import annotations

import math
from typing import Dict

from .common import Spec

__all__ = ["param_specs"]


def param_specs(cfg) -> Dict[str, Spec]:
    d = cfg.d_model
    di = cfg.ssm_d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.ssm_nheads
    k = cfg.ssm_conv
    conv_dim = di + 2 * g * n
    return {
        "wz": Spec((d, di), ("embed", "ssm_inner")),
        "wx": Spec((d, di), ("embed", "ssm_inner")),
        "wB": Spec((d, g * n), ("embed", None)),
        "wC": Spec((d, g * n), ("embed", None)),
        "wdt": Spec((d, h), ("embed", "ssm_heads")),
        "dt_bias": Spec((h,), ("ssm_heads",), init="zeros"),
        "A_log": Spec((h,), ("ssm_heads",), init="ones"),
        "D": Spec((h,), ("ssm_heads",), init="ones"),
        "conv_w": Spec((k, conv_dim), (None, None), scale=1.0 / math.sqrt(k)),
        "conv_b": Spec((conv_dim,), (None,), init="zeros"),
        "norm_w": Spec((di,), ("ssm_inner",), init="zeros"),
        "wo": Spec((di, d), ("ssm_inner", "embed")),
    }

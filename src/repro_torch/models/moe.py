"""Token-choice top-k MoE: parameter specs only.

The shapes of the JAX package's ``models/moe.py`` (the parameter counts of
``configs.base.ModelConfig`` need them). The routed compute and its
expert-parallel path wait for ROADMAP Queue 1 item 2 (the local path) and
item 3 (expert parallelism);
``transformer.check_supported`` refuses a MoE config before anything runs.
"""
from __future__ import annotations

from typing import Dict

from .common import Spec

__all__ = ["param_specs"]


def param_specs(cfg) -> Dict[str, Spec]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    return {
        "router": Spec((d, e), ("embed", "experts"), scale=0.02),
        "wi": Spec((e, d, f), ("experts", "embed", "mlp")),
        "wg": Spec((e, d, f), ("experts", "embed", "mlp")),
        "wo": Spec((e, f, d), ("experts", "mlp", "embed")),
    }

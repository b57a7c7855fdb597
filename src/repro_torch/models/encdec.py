"""Whisper-style encoder-decoder: parameter specs only.

The shapes of the JAX package's ``models/encdec.py`` (the parameter counts
of ``configs.base.ModelConfig`` need them). The encoder, the decoder with
cross-attention and their caches wait for ROADMAP Queue 1 item 2;
``transformer.check_supported`` refuses an enc-dec config before anything
runs.
"""
from __future__ import annotations

from typing import Dict

from . import attention, mlp
from .common import Spec
from .transformer import _norm_specs, _stack

__all__ = ["param_specs"]


def _enc_layer_specs(cfg, r: int) -> Dict:
    return {
        "norm1": _norm_specs(cfg, r),
        "attn": _stack(attention.param_specs(cfg), r),
        "norm2": _norm_specs(cfg, r),
        "mlp": _stack(mlp.param_specs(cfg), r),
    }


def _dec_layer_specs(cfg, r: int) -> Dict:
    return {
        "norm1": _norm_specs(cfg, r),
        "attn": _stack(attention.param_specs(cfg), r),
        "norm_x": _norm_specs(cfg, r),
        "xattn": _stack(attention.param_specs(cfg, cross=True), r),
        "norm2": _norm_specs(cfg, r),
        "mlp": _stack(mlp.param_specs(cfg), r),
    }


def param_specs(cfg) -> Dict:
    d, v = cfg.d_model, cfg.padded_vocab
    return {
        "embed": Spec((v, d), ("vocab", "embed"), scale=0.02),
        "enc_layers": _enc_layer_specs(cfg, cfg.n_enc_layers),
        "enc_norm": {"w": Spec((d,), ("embed",), init="ones"),
                     "b": Spec((d,), ("embed",), init="zeros")},
        "dec_layers": _dec_layer_specs(cfg, cfg.n_layers),
        "final_norm": {"w": Spec((d,), ("embed",), init="ones"),
                       "b": Spec((d,), ("embed",), init="zeros")},
    }

"""Meta-tensor input stand-ins for every (arch x shape) cell.

The port of the JAX package's ``configs/specs.py``: where it builds
``jax.ShapeDtypeStruct`` trees, these are tensors on the ``meta`` device
(a shape and a dtype, no storage). `input_specs(cfg, shape_name)` returns
the exact tree the corresponding step consumes; `abstract_train_state(cfg)`
mirrors ``steps.init_train_state``. The decode caches are the model's own
``init_decode_caches`` built on ``meta`` (the JAX package takes them from
``jax.eval_shape`` of its builder).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .base import ModelConfig, shape_for
from ..models import encdec, steps, transformer
from ..models.common import tree_map

__all__ = ["input_specs", "abstract_train_state", "abstract_params_tree",
           "cell_is_applicable", "step_kind"]


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def cell_is_applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """long_500k requires a sub-quadratic mixer (SSM/hybrid)."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention architecture: 524288-token decode "
                       "requires a sub-quadratic mixer (skip per assignment)")
    return True, ""


def step_kind(shape_name: str) -> str:
    return shape_for(shape_name).kind  # train | prefill | decode


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """Inputs for the step function of this cell (no state/params).

    train:   {tokens, labels[, frames | prefix_embeds]}
    prefill: {tokens[, frames | prefix_embeds]}
    decode:  {token, caches, cache_pos}
    """
    sh = shape_for(shape_name)
    b, s = sh.global_batch, sh.seq_len
    pdt = _dtype(cfg.param_dtype)

    if sh.kind in ("train", "prefill"):
        if cfg.is_encdec:
            out = {
                "frames": _sds((b, cfg.enc_seq, cfg.d_model), pdt),
                "tokens": _sds((b, s), torch.int32),
            }
        elif cfg.n_prefix_tokens:
            s_text = s - cfg.n_prefix_tokens
            out = {
                "prefix_embeds": _sds((b, cfg.n_prefix_tokens, cfg.d_model), pdt),
                "tokens": _sds((b, s_text), torch.int32),
            }
        else:
            out = {"tokens": _sds((b, s), torch.int32)}
        if sh.kind == "train":
            # label length matches the hidden-state length (prefix included)
            out["labels"] = _sds((b, s), torch.int32)
        return out

    # decode: single new token over a seq_len-deep cache
    mod = encdec if cfg.is_encdec else transformer
    caches = mod.init_decode_caches(cfg, b, s, device="meta")
    return {
        "token": _sds((b, 1), torch.int32),
        "caches": caches,
        "cache_pos": _sds((), torch.int32),
    }


def abstract_params_tree(cfg: ModelConfig, dtype: Optional[str] = None):
    dt = _dtype(dtype or cfg.param_dtype)
    return tree_map(lambda s: _sds(s.shape, dt), steps.model_param_specs(cfg))


def abstract_train_state(cfg: ModelConfig) -> Dict:
    params = abstract_params_tree(cfg, cfg.master_dtype)
    mdt = _dtype(cfg.moment_dtype)
    return {
        "params": params,
        "opt": {
            "m": tree_map(lambda p: _sds(p.shape, mdt), params),
            "v": tree_map(lambda p: _sds(p.shape, mdt), params),
            "step": _sds((), torch.int32),
        },
    }

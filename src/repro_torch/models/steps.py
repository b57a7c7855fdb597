"""Prefill / decode step factories for serving.

The port of ``make_prefill_step`` and ``make_decode_step`` of the JAX
package's ``models/steps.py``. The JAX steps cast the params to
``cfg.param_dtype`` on every call (a no-op in its serve path, whose params
are bf16 already); here the model is cast once when it is built
(`cast_model`) and a step refuses a model in another dtype, so no step
re-casts the weights (5 GB a token at gemma-2b's full width).
``init_train_state``, ``make_train_step`` and the compressed train step
wait for ``optim/`` (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from . import transformer

__all__ = ["make_prefill_step", "make_decode_step", "cast_model",
           "model_param_specs"]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def model_param_specs(cfg):
    transformer.check_supported(cfg)
    return transformer.param_specs(cfg)


def cast_model(cfg, model: transformer.Transformer) -> transformer.Transformer:
    """``model`` in ``cfg.param_dtype`` (in place; a no-op when it is)."""
    return model.to(_dtype(cfg.param_dtype))


def _checked(cfg, model):
    want = _dtype(cfg.param_dtype)
    if model.dtype != want:
        raise ValueError(f"the model is {model.dtype}, the config's "
                         f"param_dtype is {want}: cast it once with "
                         f"steps.cast_model")


def make_prefill_step(cfg) -> Callable:
    transformer.check_supported(cfg)

    def prefill_step(model, batch: Dict):
        _checked(cfg, model)
        return model.prefill(batch["tokens"])

    return prefill_step


def make_decode_step(cfg) -> Callable:
    transformer.check_supported(cfg)

    def decode_step(model, token: torch.Tensor, caches: Dict, cache_pos: int):
        _checked(cfg, model)
        logits, new_caches = model.decode_step(token, caches, cache_pos)
        next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_token[:, None], logits, new_caches

    return decode_step

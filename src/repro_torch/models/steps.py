"""Train / prefill / decode step factories.

The port of the JAX package's ``models/steps.py``.

Training: `init_train_state` draws the float32 master on the device from
an explicit generator, with the AdamW state beside it (``{"params",
"opt": {"m", "v", "step"}}``, the JAX layout). `make_train_step`'s step
casts the master to ``cfg.param_dtype`` on every call inside autograd, as
the JAX loss does, so the gradients reach the float32 master through the
cast; microbatches (``accum_steps``) are summed into an ``accum_dtype``
accumulator; the metrics are device scalars, read by no host sync in the
step. The step updates the state's tensors in place and returns it (a
jitted JAX step with its state donated does the same): the caller keeps
no reference to the old state.

Serving: the JAX steps cast the params to ``cfg.param_dtype`` on every
call (a no-op in its serve path, whose params are bf16 already); here the
model is cast once when it is built (`cast_model`) and a step refuses a
model in another dtype, so no step re-casts the weights (5 GB a token at
gemma-2b's full width).

Every step refuses a CUDA model while cuBLAS may round its GEMMs
(`exact_gemms`): the JAX package's bf16 products accumulate in float32
and its float32 products (the flash backward's) are IEEE float32. The
compressed train step waits for a ``pod`` mesh axis (ROADMAP Queue 1
item 3).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import encdec, transformer
from .common import init_params, sorted_leaves, tree_map, unflatten
from ..optim import AdamWConfig, adamw

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "init_train_state", "cast_model", "model_param_specs",
           "exact_gemms", "set_exact_gemms", "make_model"]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def model_param_specs(cfg):
    return (encdec if cfg.is_encdec else transformer).param_specs(cfg)


def make_model(cfg, params: Dict):
    """The serving module for ``cfg`` over a parameter tree of tensors: an
    `encdec.EncDec` for an encoder-decoder, else a
    `transformer.Transformer`."""
    return (encdec.EncDec if cfg.is_encdec else transformer.Transformer)(
        cfg, params)


def exact_gemms(device) -> None:
    """Raise on a CUDA ``device`` while cuBLAS may reduce bf16 GEMMs in
    bf16 (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_
    reduction``, True by default) or run float32 GEMMs in TF32: the LM
    steps' products are the JAX package's only with both off. The CLIs set
    both; a library caller sets them once."""
    if torch.device(device).type != "cuda":
        return
    flags = []
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        flags.append("torch.backends.cuda.matmul."
                     "allow_bf16_reduced_precision_reduction")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        flags.append("torch.backends.cuda.matmul.allow_tf32")
    if torch.backends.cudnn.allow_tf32:
        flags.append("torch.backends.cudnn.allow_tf32")
    if flags:
        raise RuntimeError(
            "the LM steps need exact GEMMs: bf16 products accumulated in "
            "float32 and float32 products in IEEE float32; set "
            + " and ".join(f"{f} = False" for f in flags))


def set_exact_gemms() -> None:
    """Turn off bf16 reduction and TF32 for this process (what the CLIs,
    which own their process, do at startup)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cast_model(cfg, model):
    """``model`` in ``cfg.param_dtype`` (in place; a no-op when it is)."""
    return model.to(_dtype(cfg.param_dtype))


def _checked(cfg, model):
    want = _dtype(cfg.param_dtype)
    if model.dtype != want:
        raise ValueError(f"the model is {model.dtype}, the config's "
                         f"param_dtype is {want}: cast it once with "
                         f"steps.cast_model")
    exact_gemms(model.embed.device)


# -- training ------------------------------------------------------------------

def _opt_cfg(cfg, opt_cfg: Optional[AdamWConfig]) -> AdamWConfig:
    return opt_cfg or AdamWConfig(moment_dtype=_dtype(cfg.moment_dtype))


def init_train_state(cfg, generator: torch.Generator,
                     opt_cfg: Optional[AdamWConfig] = None,
                     device="cuda") -> Dict:
    """``{"params": the master tree (cfg.master_dtype), "opt": {"m", "v",
    "step"}}`` on ``device``, the params drawn by ``init_params`` from
    ``generator`` (which lives on that device)."""
    opt_cfg = _opt_cfg(cfg, opt_cfg)
    params = init_params(model_param_specs(cfg), generator,
                         _dtype(cfg.master_dtype), device)
    return {"params": params, "opt": adamw.init_state(params, opt_cfg)}


def _forward_loss(cfg) -> Callable:
    """loss_fn(master, batch) -> (loss, nll): the master cast to
    ``cfg.param_dtype`` inside autograd, the training forward (with the
    batch's ``frames`` for an encoder-decoder, its ``prefix_embeds`` for a
    prefix config), `lm_loss`."""
    compute_dtype = _dtype(cfg.param_dtype)

    def loss_fn(master_params: Dict, batch: Dict):
        p = tree_map(lambda x: x.to(compute_dtype), master_params)
        if cfg.is_encdec:
            hidden, aux = encdec.forward(p, batch["frames"], batch["tokens"],
                                         cfg)
        elif cfg.n_prefix_tokens:
            hidden, aux = transformer.forward(
                p, batch["tokens"], cfg, prefix_embeds=batch["prefix_embeds"])
        else:
            hidden, aux = transformer.forward(p, batch["tokens"], cfg)
        return transformer.lm_loss(p, hidden, batch["labels"], cfg, aux)

    return loss_fn


def _value_and_grad(loss_fn) -> Callable:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over a tree of leaf
    tensors: ((loss, nll) detached, grads as a tree)."""
    def grad_fn(params: Dict, batch: Dict):
        paths, leaves = zip(*sorted_leaves(params))
        leaves = [t.detach().requires_grad_() for t in leaves]
        loss, nll = loss_fn(unflatten(dict(zip(paths, leaves))), batch)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), nll.detach()), unflatten(dict(zip(paths, grads)))

    return grad_fn


def _on_device(batch: Dict, device) -> Dict:
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(
        v, np.ndarray) else v).to(device) for k, v in batch.items()}


def make_train_step(cfg, opt_cfg: Optional[AdamWConfig] = None,
                    lr_schedule: Optional[Callable] = None,
                    accum_steps: int = 1,
                    accum_dtype=torch.float32) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), ``metrics`` =
    {loss, nll, grad_norm, lr} as device scalars. ``batch`` holds
    ``tokens`` and ``labels`` (B, S), and ``frames`` (B, enc_seq, D) for
    an encoder-decoder or ``prefix_embeds`` (B, P, D) for a prefix config
    (labels then cover the P + S hidden positions), tensors or numpy
    arrays (moved to the state's device).

    accum_steps > 1 splits the batch into microbatches whose gradients are
    summed into ``accum_dtype`` (bf16 halves the accumulator) and scaled by
    1 / accum_steps in float32."""
    opt_cfg = _opt_cfg(cfg, opt_cfg)
    grad_fn = _value_and_grad(_forward_loss(cfg))

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        device = state["opt"]["step"].device
        exact_gemms(device)
        batch = _on_device(batch, device)
        if accum_steps == 1:
            (loss, nll), grads = grad_fn(params, batch)
        else:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                  *v.shape[1:]) for k, v in batch.items()}
            acc = {path: torch.zeros(p.shape, dtype=accum_dtype,
                                     device=p.device)
                   for path, p in sorted_leaves(params)}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            nll = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(accum_steps):
                (loss_mb, n), g = grad_fn(params, {k: v[i] for k, v in
                                                   micro.items()})
                for path, g_leaf in sorted_leaves(g):
                    acc[path] += g_leaf.to(accum_dtype)
                loss, nll = loss + loss_mb, nll + n
                del g
            grads = unflatten(acc)
            inv = 1.0 / accum_steps
            grads = tree_map(lambda g: (g.float() * inv).to(g.dtype), grads)
            loss, nll = loss * inv, nll * inv

        gnorm = adamw.global_norm(grads)
        if lr_schedule is None:
            lr = torch.full((), opt_cfg.lr, dtype=torch.float32, device=device)
        else:
            lr = lr_schedule(state["opt"]["step"])
        new_params, new_opt = adamw.apply_updates(params, grads, state["opt"],
                                                  opt_cfg, lr=lr)
        del grads
        metrics = {"loss": loss, "nll": nll, "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


# -- serving -------------------------------------------------------------------

def make_prefill_step(cfg) -> Callable:
    """prefill_step(model, batch) -> (last-token logits, caches); the
    batch's ``frames`` go to an encoder-decoder, its ``prefix_embeds`` in
    front of a prefix config's tokens."""
    def prefill_step(model, batch: Dict):
        _checked(cfg, model)
        if cfg.is_encdec:
            return model.prefill(batch["frames"], batch["tokens"])
        if cfg.n_prefix_tokens:
            return model.prefill(batch["tokens"],
                                 prefix_embeds=batch["prefix_embeds"])
        return model.prefill(batch["tokens"])

    return prefill_step


def make_decode_step(cfg) -> Callable:
    def decode_step(model, token: torch.Tensor, caches: Dict, cache_pos: int):
        _checked(cfg, model)
        logits, new_caches = model.decode_step(token, caches, cache_pos)
        next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_token[:, None], logits, new_caches

    return decode_step

"""How well-conditioned the training path's gradients and trajectories
are, on the reference weights (``experiments/train/reference.json``'s
configs: gemma-2b, phi3-mini-3.8b and qwen1.5-32b cut to two layers,
float32, the serving reference's numpy weights, one ``SyntheticLM`` batch
of 2 x 64).

(A) For each config, per gradient leaf max |delta| / max |g|, worst leaf:
the JAX package's float32 gradients (jitted) and the port's against a
float64 evaluation by the port of the same loss; the JAX package jitted
against itself run eagerly (``jax.disable_jit``); the port against the
JAX package. The float64 run promotes every product and keeps every
``.float()`` of the port's norms and loss in float64 (``Tensor.float`` is
swapped for ``Tensor.double`` while it runs). (B) The losses of 5 train
steps of phi3 (remat none) at lr 1e-3 and 3e-4: the JAX package jitted,
eagerly, and the port; the largest relative gap of each pair.

It imports both packages and runs on the CPU (~1 min)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/train/conditioning.py
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import steps as JS
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import convert, steps, transformer
from repro_torch.models.common import sorted_leaves, unflatten
from repro_torch.optim import AdamWConfig, adamw

ARCHS = ("gemma-2b", "phi3-mini-3.8b", "qwen1.5-32b")


def configs(arch, **kw):
    return (dataclasses.replace(jget_config(arch).reduced(n_layers=2, **kw),
                                param_dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(n_layers=2, **kw),
                                param_dtype="float32"))


def batches(cfg, n):
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                 global_batch=2, seed=3))
    return [src.batch_at(i) for i in range(n)]


def port_grads(cfg, tree, batch, dtype):
    paths, leaves = zip(*sorted_leaves(tree))
    leaves = [torch.from_numpy(a.copy()).to(dtype).requires_grad_()
              for a in leaves]
    params = unflatten(dict(zip(paths, leaves)))
    toks = {k: torch.from_numpy(v) for k, v in batch.items()}
    hidden, aux = transformer.forward(params, toks["tokens"], cfg)
    loss, _ = transformer.lm_loss(params, hidden, toks["labels"], cfg, aux)
    grads = torch.autograd.grad(loss, leaves)
    return {p: g.double().numpy() for p, g in zip(paths, grads)}


def worst(a, b):
    gaps = {p: float(np.abs(a[p] - b[p]).max() / np.abs(b[p]).max())
            for p in b}
    leaf = max(gaps, key=gaps.get)
    return f"{gaps[leaf]:.3g} ({leaf})"


def gradients():
    print("(A) float32 gradients, max |delta| / max |g| of the worst leaf")
    for arch in ARCHS:
        jcfg, cfg = configs(arch)
        tree = convert.numpy_params(cfg, 0)
        batch = batches(cfg, 1)[0]
        fn = jax.value_and_grad(JS._forward_loss(jcfg), has_aux=True)
        args = (jax.tree.map(jnp.asarray, tree),
                {k: jnp.asarray(v) for k, v in batch.items()})
        _, jit = jax.jit(fn)(*args)
        with jax.disable_jit():
            _, eager = fn(*args)
        jit = {p: np.asarray(g, np.float64) for p, g in sorted_leaves(
            jax.tree.map(np.asarray, jit))}
        eager = {p: np.asarray(g, np.float64) for p, g in sorted_leaves(
            jax.tree.map(np.asarray, eager))}
        g32 = port_grads(cfg, tree, batch, torch.float32)
        as_float = torch.Tensor.float
        torch.Tensor.float = torch.Tensor.double
        try:
            g64 = port_grads(cfg, tree, batch, torch.float64)
        finally:
            torch.Tensor.float = as_float
        print(f"  {arch}: JAX f32 vs f64 {worst(jit, g64)}; port f32 vs f64 "
              f"{worst(g32, g64)}; JAX jit vs eager {worst(eager, jit)}; "
              f"port vs JAX {worst(g32, jit)}")


def trajectories():
    print("(B) 5-step loss trajectories (phi3, remat none), largest "
          "relative gap")
    jcfg, cfg = configs("phi3-mini-3.8b", remat="none")
    tree = convert.numpy_params(cfg, 0)
    data = batches(cfg, 5)
    for lr in (1e-3, 3e-4):
        out = {}
        fn = JS.make_train_step(jcfg, JAdamWConfig(lr=lr))
        for mode, step in (("jit", jax.jit(fn)), ("eager", fn)):
            state = JS.init_train_state(jcfg, jax.random.PRNGKey(0))
            state["params"] = jax.tree.map(jnp.asarray, tree)
            losses = []
            for b in data:
                b = {k: jnp.asarray(v) for k, v in b.items()}
                if mode == "eager":
                    with jax.disable_jit():
                        state, m = step(state, b)
                else:
                    state, m = step(state, b)
                losses.append(float(m["loss"]))
            out[mode] = losses
        step = steps.make_train_step(cfg, AdamWConfig(lr=lr))
        params = {p: torch.from_numpy(a.copy()) for p, a in
                  sorted_leaves(tree)}
        params = unflatten(params)
        state = {"params": params, "opt": adamw.init_state(params,
                                                           AdamWConfig())}
        out["port"] = []
        for b in data:
            state, m = step(state, b)
            out["port"].append(float(m["loss"]))

        def gap(a, b):
            return max(abs(x - y) / abs(y) for x, y in zip(out[a], out[b]))

        print(f"  lr {lr:g}: JAX jit vs eager {gap('eager', 'jit'):.3g}; "
              f"port vs JAX jit {gap('port', 'jit'):.3g}; losses "
              + "; ".join(f"{k} " + ", ".join(f"{x:.6f}" for x in v)
                          for k, v in out.items()))


if __name__ == "__main__":
    gradients()
    trajectories()

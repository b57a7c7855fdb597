"""Reference for the training path, computed by the JAX package.

Writes ``experiments/train/reference.json`` for gemma-2b, phi3-mini-3.8b
and qwen1.5-32b, each ``.reduced(n_layers=2)`` with ``param_dtype``
float32 and bfloat16 (``remat="full"``, the configs' own). The float32
master comes from the serving reference's numpy weight rule
(``experiments/serve/make_reference.py``: ``numpy_params``, seed 0), the
batches from ``data.SyntheticLM`` (seed 3, batch 2, seq 64; step ``i``
trains on ``batch_at(i)``), the optimizer is ``AdamWConfig()`` (lr 3e-4,
weight decay 0.1, clip 1.0) at a constant lr. For each config it records:

* ``step1``: loss, nll and grad_norm of the first train step;
* ``grads``: per gradient leaf its L2 norm, its largest |entry|, the
  entries at ``entry_index`` (8 fixed flat indices), ``sketch`` (the
  leaf's products with ``SKETCH`` seeded Gaussian vectors over
  sqrt(``SKETCH``), so that the distance of two sketches estimates the
  L2 distance of two gradients) and, for bfloat16, ``bf16_gap``:
  ||g_bf16 - g_f32|| / ||g_f32|| of this package's own two dtypes;
* ``params``: the same (norm, entries) for the params after one AdamW step;
* ``trajectory``: the losses of 5 train steps from the start;
* ``accum2``: loss, nll and grad_norm of one step with ``accum_steps=2``
  (``accum_dtype`` the param dtype) and the params' entries after it;
* ``remat_none``: loss and the gradients' entries with ``remat="none"``.

It imports the JAX package only and runs on the CPU (~1.5 min)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/train/make_reference.py

The PyTorch port is held to this file by ``tests/test_torch_train_ref.py``
(which also regenerates it bit for bit) and ``chip_smoke.py`` phase 14a.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.data import DataConfig, SyntheticLM
from repro.models import steps
from repro.optim import AdamWConfig

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE / "reference.json"
ARCHS = ("gemma-2b", "phi3-mini-3.8b", "qwen1.5-32b")
N_LAYERS = 2
SEED = 0
DATA = {"seed": 3, "batch": 2, "seq": 64}
TRAJECTORY = 5
ENTRIES = 8
SKETCH, SKETCH_SEED = 64, 11
DTYPES = ("float32", "bfloat16")
ACCUM_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _serve_reference():
    spec = importlib.util.spec_from_file_location(
        "serve_make_reference", HERE.parent / "serve" / "make_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


numpy_params = _serve_reference().numpy_params


def config(arch: str, dtype: str):
    return dataclasses.replace(get_config(arch).reduced(n_layers=N_LAYERS),
                               param_dtype=dtype)


def batches(cfg, n: int):
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=DATA["seq"],
                                 global_batch=DATA["batch"],
                                 seed=DATA["seed"]))
    return [src.batch_at(i) for i in range(n)]


def entry_index(size: int) -> np.ndarray:
    """The fixed flat indices recorded of a leaf of ``size`` entries."""
    return np.linspace(0, size - 1, ENTRIES).round().astype(np.int64)


def sketch(g: np.ndarray, path: str) -> list:
    """``SKETCH`` products of the flat leaf with standard normal vectors
    drawn from a generator seeded by ``SKETCH_SEED`` and the path, over
    sqrt(``SKETCH``): the distance of two sketches of one path estimates
    the L2 distance of the two leaves (within ~25% at 64 rows)."""
    flat = np.asarray(g, np.float64).reshape(-1)
    rng = np.random.default_rng([SKETCH_SEED, *path.encode()])
    return [float(np.sum(rng.standard_normal(flat.size) * flat))
            / SKETCH ** 0.5 for _ in range(SKETCH)]


def leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(x, np.float32)
            for path, x in flat}


def _state(tree):
    params = jax.tree.map(jnp.asarray, tree)
    opt = {"m": jax.tree.map(jnp.zeros_like, params),
           "v": jax.tree.map(jnp.zeros_like, params),
           "step": jnp.zeros((), jnp.int32)}
    return {"params": params, "opt": opt}


def run(arch: str, dtype: str) -> dict:
    """Everything the file records of one config, as full arrays: grads,
    params after one step, the trajectory, the accumulation and remat
    steps."""
    cfg = config(arch, dtype)
    tree = numpy_params(cfg, SEED)
    data = [{k: jnp.asarray(v) for k, v in b.items()}
            for b in batches(cfg, TRAJECTORY)]
    params = jax.tree.map(jnp.asarray, tree)
    grad_fn = jax.jit(jax.value_and_grad(steps._forward_loss(cfg),
                                         has_aux=True))
    (loss, nll), grads = grad_fn(params, data[0])
    none_fn = jax.jit(jax.value_and_grad(steps._forward_loss(
        dataclasses.replace(cfg, remat="none")), has_aux=True))
    (loss_none, _), grads_none = none_fn(params, data[0])

    step = jax.jit(steps.make_train_step(cfg, AdamWConfig()))
    state, metrics = step(_state(tree), data[0])
    after = leaves(state["params"])
    trajectory = [float(metrics["loss"])]
    for b in data[1:]:
        state, m = step(state, b)
        trajectory.append(float(m["loss"]))

    accum = jax.jit(steps.make_train_step(
        cfg, AdamWConfig(), accum_steps=2, accum_dtype=ACCUM_DTYPES[dtype]))
    state2, m2 = accum(_state(tree), data[0])
    return {
        "step1": {"loss": float(metrics["loss"]), "nll": float(metrics["nll"]),
                  "grad_norm": float(metrics["grad_norm"]),
                  "value_and_grad_loss": float(loss),
                  "value_and_grad_nll": float(nll)},
        "grads": leaves(grads), "params": after, "trajectory": trajectory,
        "accum2": {"loss": float(m2["loss"]), "nll": float(m2["nll"]),
                   "grad_norm": float(m2["grad_norm"]),
                   "params": leaves(state2["params"])},
        "remat_none": {"loss": float(loss_none),
                       "grads": leaves(grads_none)},
    }


def _entries(a: np.ndarray) -> dict:
    flat = a.reshape(-1)
    idx = entry_index(flat.size)
    return {"norm": float(np.linalg.norm(flat.astype(np.float64))),
            "absmax": float(np.abs(flat).max()),
            "values": flat[idx].tolist()}


def summarize(runs: dict) -> dict:
    """The JSON record of one arch from its two dtypes' runs."""
    out = {}
    for dtype, r in runs.items():
        grads = {p: {**_entries(g), "sketch": sketch(g, p)}
                 for p, g in r["grads"].items()}
        if dtype == "bfloat16":
            for p, g in r["grads"].items():
                g32 = runs["float32"]["grads"][p].astype(np.float64)
                grads[p]["bf16_gap"] = float(np.sqrt(np.sum(
                    (g - g32) ** 2) / np.sum(g32 ** 2)))
        out[dtype] = {
            "step1": r["step1"], "grads": grads,
            "params": {p: _entries(a) for p, a in r["params"].items()},
            "trajectory": r["trajectory"],
            "accum2": {**{k: r["accum2"][k] for k in
                          ("loss", "nll", "grad_norm")},
                       "params": {p: _entries(a)["values"] for p, a in
                                  r["accum2"]["params"].items()}},
            "remat_none": {"loss": r["remat_none"]["loss"],
                           "grads": {p: _entries(g)["values"] for p, g in
                                     r["remat_none"]["grads"].items()}},
        }
    return out


def header() -> dict:
    return {"seed": SEED, "data": DATA, "n_layers": N_LAYERS,
            "entries": ENTRIES, "sketch": SKETCH, "sketch_seed": SKETCH_SEED,
            "trajectory_steps": TRAJECTORY,
            "adamw": dataclasses.asdict(dataclasses.replace(
                AdamWConfig(), moment_dtype="float32"))}


def main(path: pathlib.Path = OUT):
    out = header()
    out["configs"] = {arch: summarize({dt: run(arch, dt) for dt in DTYPES})
                      for arch in ARCHS}
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()

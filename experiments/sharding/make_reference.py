"""Reference for the sharding slice, computed by the JAX package.

Writes ``experiments/sharding/reference.json``. Its parts:

* ``plans``: for the ten archs on the production meshes (16x16 and
  2x16x16): the plan's rules, batch / seq / cache-seq axes and notes,
  every parameter's spec, and the ``batch_shardings`` /
  ``decode_input_shardings`` spec trees of every shape (``input_specs``
  trees). Specs are lists whose entries are a name, a list of names or
  null.
* ``costs``: ``launch.analytic.analytic_cost`` (flops, hbm_bytes, detail)
  and ``launch.roofline.model_flops`` on every applicable arch x shape, at
  256 and 512 chips.
* ``mesh``: on 4 fake CPU devices (``XLA_FLAGS=
  --xla_force_host_platform_device_count=4``), in float32 at
  ``.reduced()`` width, the arrays `cases` computes:

  - ``blocks/<layout>/<coords>/<path>``: sha256 of each device's
    ``addressable_shards`` block of granite-moe-1b-a400m's numpy weights
    under ``train_state_shardings``, layouts ``2x2`` (data, model) and
    ``pod_data`` ((pod, data, model) = (2, 2, 1), ``fsdp="pod_data"``);
  - ``ep/<case>/{out,aux,grad/<leaf>}``: ``moe.moe`` under each plan (the
    ``shard_map`` ``_moe_ep``) and ``jax.grad`` of ``sum(out ** 2)``, for
    the branches of ``moe.py:117-240``: ``fsdp_local``, ``sharded``
    (experts sharded, no FSDP), ``padded`` (6 experts on 4 ranks),
    ``tiny_batch`` (batch 1 < data), ``no_seq_split`` (one position),
    ``dropping`` (capacity_factor 1.0);
  - ``decode/<cache>/<pos>/{out,k,v[,k_scale,v_scale]}``: gemma-2b's
    ``decode_attention`` (layer 0 of the conditioned weights) with
    ``decode_attention="sharded"`` on (1, 4)
    (the cache seq-sharded over ``model``), float32 and int8 caches,
    ``cache_pos`` at each slice boundary;
  - ``pipeline/<mesh>/{out,grad_w,grad_b}``: ``pipeline_apply`` of
    ``tests/test_pipeline.py``'s stage on (pod, data) = (4, 1) and (2, 2),
    and ``jax.grad`` of ``sum(y ** 2)``;
  - ``compressed/...``: the int8 pod-compressed step on (pod, data,
    model) = (2, 1, 1) at a cut gemma-2b. The JAX package's
    ``make_compressed_train_step`` does not run here (jax 0.9:
    ``ValueError: Context mesh ... should match the mesh of sharding``
    from the inner ``maybe_constrain``), so the reference is its own
    recipe: each pod's half-batch gradient (``value_and_grad`` of
    ``steps._forward_loss``), ``optim.compression.quantize_int8`` of
    gradient + error, the int8 codes and scales averaged, AdamW; two
    steps, the codes, scales and errors of each;
  - ``train/<arch>/...``: gemma-2b and granite-moe-1b-a400m on the
    layers reference's conditioned weights, on a 2 x 2 mesh: the first
    step's ``value_and_grad`` and two steps of
    ``steps.make_train_step`` jitted with ``in_shardings``
    (``train_state_shardings``, ``batch_shardings``) under
    ``activation_ctx(plan)``, their metrics and the params after them.

  - ``tp/<case>/...``: serving under a plan, each ``TP_CASES`` config
    (``.reduced()``, float32, the layers reference's conditioned weights)
    on its (data, model) mesh: ``steps.make_prefill_step`` jitted with the
    dry run's ``in_shardings`` (``params_only_shardings``,
    ``batch_shardings``) and its caches pinned to
    ``decode_input_shardings`` (``src/repro/launch/dryrun.py:110-137``),
    the prefill logits and caches (``prefill/...``); the caches padded to
    the decode window (in float32: the decode's own writes then round no
    further than its float32), then ``TP["steps"]`` teacher-forced
    ``steps.make_decode_step`` calls jitted with
    ``decode_input_shardings``, each step's logits and the written window
    of the caches (``decode/...``; an SSM layer's state and conv tail
    whole, the attention caches' slots only). ``tp_plain/<case>/...`` is
    the same run jitted with no shardings on one device: XLA against
    itself, the scale of what reordering the partial sums moves once the
    caches round to bf16. The cases cover MHA, GQA with qkv bias, MQA,
    MoE, the SSM (mamba2-370m), the hybrid (jamba-1.5-large-398b's
    8-layer period) and the prefix (paligemma-3b, 8 seeded prefix
    embeddings before the prompt, the decode from the slot after them).

  - ``tp_train/<case>/...``: training under a plan, each ``TP_TRAIN``
    config (the ``TP_CASES`` but ``mqa_sharded_1x4``; ``.reduced()``,
    float32, the conditioned weights) on its own (data, model) mesh
    through the ``train/...`` recipe: the first batch's ``value_and_grad``
    and ``STEPS`` steps, their metrics and the params after them (a
    prefix config's batches: P seeded prefix embeddings and the first
    ``seq - P`` tokens, the labels over all P + S positions).

  In the file an array of up to 4096 entries, and every ``tp/`` and
  ``tp_plain/`` array (a decode starts from their prefill caches), is
  whole (float32, or int for integer arrays, little-endian, base64); a
  larger one keeps its L2 norm,
  largest |entry|, 8 entries and a 64-row Gaussian sketch (as
  ``experiments/train``). `cases` returns every array whole, which
  ``tests/test_torch_sharding_mesh.py`` compares from a subprocess.

It imports the JAX package only and runs on the CPU (~1 min)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/sharding/make_reference.py

The PyTorch port is held to this file by ``chip_smoke.py`` phase 16a
(``repro_torch.sharding.mesh_cases`` on four gloo ranks sharing the card)
and to `cases` by ``tests/test_torch_sharding_mesh.py``;
``tests/test_torch_sharding_regen.py`` regenerates ``plans`` and ``costs``.
"""
from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import base64
import dataclasses
import hashlib
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ARCHS, get_config
from repro.configs import specs as jspecs
from repro.configs.base import SHAPES
from repro.data import DataConfig, SyntheticLM
from repro.launch.analytic import analytic_cost
from repro.launch.roofline import model_flops
from repro.models import attention, moe, steps
from repro.optim import AdamWConfig, adamw
from repro.optim.compression import quantize_int8
from repro.sharding import (activation_ctx, batch_shardings,
                            decode_input_shardings, make_plan,
                            params_only_shardings, train_state_shardings)
from repro.sharding.pipeline import pipeline_apply
from repro.sharding.rules import spec_to_pspec

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE / "reference.json"
SEED = 0
PRODUCTION = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CHIPS = (256, 512)
WHOLE = 4096
ENTRIES = 8
SKETCH = 64
SKETCH_SEED = 16
#: the EP layer's cut: d_model 64, expert d_ff 32
EP_CUT = dict(d_model=64, moe_d_ff=32)
EP_X = {"fsdp_local": (4, 16), "sharded": (4, 16), "padded": (2, 16),
        "tiny_batch": (1, 16), "no_seq_split": (4, 1), "dropping": (4, 16)}
DECODE = {"batch": 2, "smax": 64, "pos": (0, 15, 16, 31, 32, 47, 48, 63)}
PIPELINE = {"stages_micro": (6, 3, 16), "meshes": {"4x1": (4, 1),
                                                   "2x2": (2, 2)}}
COMPRESSED_CUT = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=128,
                      param_dtype="float32")
DATA = {"seed": 3, "batch": 4, "seq": 32}
STEPS = 2
TRAIN_ARCHS = ("gemma-2b", "granite-moe-1b-a400m")
#: serving on blocks: a batch of 2, an 8-token prompt prefilled, padded to
#: a 16-slot window, then 8 teacher-forced decode steps
TP = {"batch": 2, "prompt": 8, "max_len": 16, "steps": 8, "seed": 7}
#: the cache leaves with a slot per position (the others: an SSM's state
#: and conv tail)
KV = ("k", "v", "k_scale", "v_scale")
#: case: (arch, (data, model), overrides of its ``.reduced()`` config)
TP_CASES = {
    "mha_1x4": ("phi3-mini-3.8b", (1, 4), {"n_layers": 2, "n_kv_heads": 4}),
    "mha_2x2": ("phi3-mini-3.8b", (2, 2), {"n_layers": 2, "n_kv_heads": 4}),
    "gqa_bias_2x2": ("qwen1.5-32b", (2, 2), {"n_layers": 2}),
    "mqa_gathered_1x4": ("gemma-2b", (1, 4), {"n_layers": 2}),
    "mqa_sharded_1x4": ("gemma-2b", (1, 4), {"n_layers": 2,
                                             "decode_attention": "sharded"}),
    "moe_2x2": ("granite-moe-1b-a400m", (2, 2), {"n_layers": 2,
                                                 "capacity_factor": 8.0}),
    "ssm_1x4": ("mamba2-370m", (1, 4), {"n_layers": 2}),
    "ssm_2x2": ("mamba2-370m", (2, 2), {"n_layers": 2}),
    "hybrid_2x2": ("jamba-1.5-large-398b", (2, 2), {"capacity_factor": 8.0}),
    "hybrid_1x4": ("jamba-1.5-large-398b", (1, 4), {"capacity_factor": 8.0}),
    "prefix_1x4": ("paligemma-3b", (1, 4), {"n_layers": 2}),
    "encdec_1x4": ("whisper-tiny", (1, 4), {"n_layers": 2}),
    "encdec_2x2": ("whisper-tiny", (2, 2), {"n_layers": 2}),
}
#: a prefix config's seeded prefix embeddings: ``default_rng([PREFIX_SEED,
#: i])``, i the train batch's index or ``TP["seed"]`` for serving
PREFIX_SEED = 5
#: an encoder-decoder's seeded frames, the same way
FRAMES_SEED = 6
#: training on blocks: the TP_CASES configs but mqa_sharded_1x4 (its decode
#: form changes nothing in training), through the train recipe
TP_TRAIN = tuple(c for c in TP_CASES if c != "mqa_sharded_1x4")


# -- weights --------------------------------------------------------------------

def leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "shape") or isinstance(x, P))
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in flat}


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def numpy_tree(specs, seed: int = SEED) -> dict:
    """The serving reference's weight rule on any spec tree: sorted paths,
    ``standard_normal * stddev`` (0.1 for zeros/ones leaves), float32."""
    rng = np.random.default_rng(seed)
    flat = leaves(specs)
    return unflatten({p: rng.standard_normal(flat[p].shape, np.float32)
                      * np.float32(flat[p].stddev() if flat[p].init == "normal"
                                    else 0.1) for p in sorted(flat)})


def _layers_rule():
    spec = importlib.util.spec_from_file_location(
        "layers_make_reference", HERE.parent / "layers" / "make_reference.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["layers_make_reference"] = mod
    spec.loader.exec_module(mod)
    return mod.conditioned_params


def train_config(arch: str):
    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32")


def train_weights(arch: str) -> dict:
    """The layers reference's conditioned weights: on the serving rule's
    (attention scores of O(10^2)) the JAX package's own sharded and
    single-device gradients part by up to 9.6e-4 x max |g|."""
    return _layers_rule()(train_config(arch), SEED)


def prefix_embeds(cfg, batch: int, i: int) -> dict:
    """``{"prefix_embeds": (batch, P, d_model)}`` of a prefix config,
    standard normal float32 from ``default_rng([PREFIX_SEED, i])``; {} for
    the others."""
    if not cfg.n_prefix_tokens:
        return {}
    rng = np.random.default_rng([PREFIX_SEED, i])
    return {"prefix_embeds": rng.standard_normal(
        (batch, cfg.n_prefix_tokens, cfg.d_model), np.float32)}


def frames(cfg, batch: int, i: int) -> dict:
    """``{"frames": (batch, enc_seq, d_model)}`` of an encoder-decoder,
    standard normal float32 from ``default_rng([FRAMES_SEED, i])``; {} for
    the others."""
    if not cfg.is_encdec:
        return {}
    rng = np.random.default_rng([FRAMES_SEED, i])
    return {"frames": rng.standard_normal(
        (batch, cfg.enc_seq, cfg.d_model), np.float32)}


def train_batches(cfg, n: int = STEPS) -> list:
    """SyntheticLM's batches; a prefix config's take P prefix embeddings
    and the first ``seq - P`` tokens (the labels cover all P + S hidden
    positions, as ``configs.specs.input_specs`` has them); an
    encoder-decoder's take seeded frames."""
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=DATA["seq"],
                                 global_batch=DATA["batch"],
                                 seed=DATA["seed"]))
    out = [src.batch_at(i) for i in range(n)]
    if cfg.n_prefix_tokens:
        cut = DATA["seq"] - cfg.n_prefix_tokens
        out = [dict(b, tokens=b["tokens"][:, :cut],
                    **prefix_embeds(cfg, DATA["batch"], i))
               for i, b in enumerate(out)]
    if cfg.is_encdec:
        out = [dict(b, **frames(cfg, DATA["batch"], i))
               for i, b in enumerate(out)]
    return out


def ep_config(case: str):
    if case == "padded":
        cfg = get_config("granite-moe-3b-a800m").reduced(
            n_experts=6, top_k=2, **EP_CUT)
    else:
        cfg = get_config("granite-moe-1b-a400m").reduced(**EP_CUT)
    return dataclasses.replace(
        cfg, capacity_factor=1.0 if case == "dropping" else 8.0)


def ep_mesh(case: str):
    """(mesh shape, axes, fsdp) of an EP case."""
    if case == "padded":
        return (1, 4), ("data", "model"), False
    return (2, 2), ("data", "model"), case in ("fsdp_local", "no_seq_split")


def ep_inputs(case: str):
    cfg = ep_config(case)
    b, s = EP_X[case]
    x = np.random.default_rng(1).standard_normal(
        (b, s, cfg.d_model), np.float32) * np.float32(0.5)
    return cfg, numpy_tree(moe.param_specs(cfg)), x


def decode_config(cache: str):
    return dataclasses.replace(
        get_config("gemma-2b").reduced(), param_dtype="float32",
        decode_attention="sharded",
        kv_cache_dtype="int8" if cache == "int8" else "bfloat16")


def decode_inputs(cache: str):
    """(cfg, layer 0's attention weights, x (B, 1, D), cache (B, Smax,
    KV, hd) with seeded entries)."""
    cfg = decode_config(cache)
    rng = np.random.default_rng(2)
    # layer 0's attention under the conditioned rule (scores of O(1); on
    # the serving rule's q the float32 round-off of two programs grows
    # with scores of O(10^2))
    p = {k: v[0] for k, v in
         _layers_rule()(cfg, SEED)["layers"]["l0"]["attn"].items()}
    b, smax = DECODE["batch"], DECODE["smax"]
    x = rng.standard_normal((b, 1, cfg.d_model), np.float32)
    shape = (b, smax, cfg.n_kv_heads, cfg.head_dim)
    if cache == "int8":
        c = {"k": rng.integers(-127, 128, shape).astype(np.int8),
             "v": rng.integers(-127, 128, shape).astype(np.int8),
             "k_scale": (rng.random(shape[:3] + (1,), np.float32) * 0.02
                         + 0.001),
             "v_scale": (rng.random(shape[:3] + (1,), np.float32) * 0.02
                         + 0.001)}
    else:
        c = {"k": rng.standard_normal(shape, np.float32),
             "v": rng.standard_normal(shape, np.float32)}
    return cfg, p, x, c


def pipeline_inputs():
    m, mb, d = PIPELINE["stages_micro"]
    rng = np.random.default_rng(4)
    return m, mb, d, rng


def pipeline_weights(stages: int):
    m, mb, d, rng = pipeline_inputs()
    w = rng.standard_normal((stages, d, d), np.float32) * np.float32(0.3)
    b = rng.standard_normal((stages, d), np.float32) * np.float32(0.1)
    x = rng.standard_normal((m, mb, d), np.float32)
    return w, b, x


def compressed_config():
    return get_config("gemma-2b").reduced(**COMPRESSED_CUT)


# -- the JAX side -----------------------------------------------------------------

def _mesh(shape, axes):
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def _coords(mesh, device):
    return tuple(int(i) for i in np.argwhere(mesh.devices == device)[0])


def _blocks(out: dict):
    cfg = get_config("granite-moe-1b-a400m").reduced()
    tree = numpy_tree(steps.model_param_specs(cfg))
    for layout, (shape, axes, fsdp) in {
            "2x2": ((2, 2), ("data", "model"), True),
            "pod_data": ((2, 2, 1), ("pod", "data", "model"), "pod_data")
    }.items():
        mesh = _mesh(shape, axes)
        plan = make_plan(cfg, mesh, fsdp=fsdp)
        sh = train_state_shardings(cfg, plan)["params"]
        for path, x in leaves(tree).items():
            arr = jax.device_put(jnp.asarray(x), leaves(sh)[path])
            for shard in arr.addressable_shards:
                c = "".join(map(str, _coords(mesh, shard.device)))
                out[f"blocks/{layout}/{c}/{path}"] = np.array(hashlib.sha256(
                    np.ascontiguousarray(np.asarray(shard.data)).tobytes()
                ).hexdigest())


def _ep(out: dict):
    for case in EP_X:
        cfg, p, x = ep_inputs(case)
        shape, axes, fsdp = ep_mesh(case)
        mesh = _mesh(shape, axes)
        plan = make_plan(cfg, mesh, fsdp=fsdp)
        pj = jax.tree.map(jnp.asarray, p)
        xj = jnp.asarray(x)
        with mesh, activation_ctx(plan):
            y, aux = jax.jit(lambda p, x: moe.moe(p, x, cfg))(pj, xj)
            g = jax.jit(jax.grad(lambda p: jnp.sum(moe.moe(p, xj, cfg)[0]
                                                   ** 2)))(pj)
        out[f"ep/{case}/out"] = np.asarray(y)
        out[f"ep/{case}/aux"] = np.asarray(aux)
        for path, v in leaves(g).items():
            out[f"ep/{case}/grad/{path}"] = np.asarray(v)


def _decode(out: dict):
    for cache in ("float32", "int8"):
        cfg, p, x, c = decode_inputs(cache)
        mesh = _mesh((1, 4), ("data", "model"))
        plan = make_plan(cfg, mesh)
        pj = jax.tree.map(jnp.asarray, p)
        cj = {k: jnp.asarray(v, jnp.bfloat16 if k.endswith("scale") else None)
              for k, v in c.items()}
        fn = jax.jit(lambda p, x, c, pos: attention.decode_attention(
            p, x, c, pos, cfg))
        for pos in DECODE["pos"]:
            with mesh, activation_ctx(plan):
                y, new = fn(pj, jnp.asarray(x), cj, jnp.int32(pos))
            out[f"decode/{cache}/{pos}/out"] = np.asarray(y)
            for k, v in new.items():
                out[f"decode/{cache}/{pos}/{k}"] = np.asarray(
                    v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)


def _stage(params, xm):
    wi, bi = params
    return jnp.tanh(xm @ wi + bi)


def _pipeline(out: dict):
    for name, shape in PIPELINE["meshes"].items():
        mesh = _mesh(shape, ("pod", "data"))
        w, b, x = pipeline_weights(shape[0])
        wj, bj, xj = jnp.asarray(w), jnp.asarray(b), jnp.asarray(x)
        with mesh:
            y = jax.jit(lambda p, x: pipeline_apply(_stage, p, x, mesh,
                                                    "pod"))((wj, bj), xj)
            g = jax.jit(jax.grad(lambda p: jnp.sum(pipeline_apply(
                _stage, p, xj, mesh, "pod") ** 2)))((wj, bj))
        out[f"pipeline/{name}/out"] = np.asarray(y)
        out[f"pipeline/{name}/grad_w"] = np.asarray(g[0])
        out[f"pipeline/{name}/grad_b"] = np.asarray(g[1])


@jax.jit
def _quantize(g, e):
    """One leaf of the compressed step's exchange, jitted as the step is
    (XLA folds the scale's divisor into a product)."""
    gf = g.astype(jnp.float32) + e
    q8, s = quantize_int8(gf)
    return q8, s, gf - q8.astype(jnp.float32) * s


def _compressed(out: dict):
    cfg = compressed_config()
    params = jax.tree.map(jnp.asarray,
                          numpy_tree(steps.model_param_specs(cfg)))
    opt_cfg = AdamWConfig()
    opt = adamw.init_state(params, opt_cfg)
    err = [jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), params)
           for _ in range(2)]
    grad_fn = jax.jit(jax.value_and_grad(steps._forward_loss(cfg),
                                         has_aux=True))
    half = DATA["batch"] // 2
    for t, batch in enumerate(train_batches(cfg)):
        pods = []
        for pod in range(2):
            sub = {k: jnp.asarray(v[pod * half:(pod + 1) * half])
                   for k, v in batch.items()}
            pods.append(grad_fn(params, sub))
        red, codes = {}, {}
        for path in leaves(params):
            qs = []
            for pod in range(2):
                g = leaves(pods[pod][1])[path]
                q8, s, new_e = _quantize(g, leaves(err[pod])[path])
                qs.append((q8, s))
                out[f"compressed/{t}/grad/{pod}/{path}"] = np.asarray(g)
                out[f"compressed/{t}/q8/{pod}/{path}"] = np.asarray(q8)
                out[f"compressed/{t}/scale/{pod}/{path}"] = np.asarray(s)
                out[f"compressed/{t}/err/{pod}/{path}"] = np.asarray(new_e)
                codes.setdefault(pod, {})[path] = new_e
            red[path] = (jnp.sum(jnp.stack([q.astype(jnp.float32) * s
                                            for q, s in qs]), axis=0)
                         / 2).astype(g.dtype)
        err = [unflatten(codes[0]), unflatten(codes[1])]
        grads = unflatten(red)
        lr = jnp.asarray(opt_cfg.lr, jnp.float32)
        gnorm = adamw.global_norm(grads)
        params, opt = jax.jit(lambda p, g, o: adamw.apply_updates(
            p, g, o, opt_cfg, lr=lr))(params, grads, opt)
        loss = (pods[0][0][0] + pods[1][0][0]) / 2
        nll = (pods[0][0][1] + pods[1][0][1]) / 2
        out[f"compressed/{t}/loss"] = np.asarray(loss)
        out[f"compressed/{t}/nll"] = np.asarray(nll)
        out[f"compressed/{t}/grad_norm"] = np.asarray(gnorm)
    for path, v in leaves(params).items():
        out[f"compressed/params/{path}"] = np.asarray(v)


def _train_on(out: dict, key: str, cfg, mesh, tree):
    """The train recipe on ``mesh``: the first batch's ``value_and_grad``
    of ``steps._forward_loss`` and ``STEPS`` steps of
    ``steps.make_train_step``, jitted with ``train_state_shardings`` and
    ``batch_shardings`` under ``activation_ctx(plan)``; their metrics and
    the params after them, under ``key``."""
    plan = make_plan(cfg, mesh)
    batches = train_batches(cfg)
    st_sh = train_state_shardings(cfg, plan)
    b_sh = batch_shardings(cfg, plan, batches[0])
    step = jax.jit(steps.make_train_step(cfg, AdamWConfig()),
                   in_shardings=(st_sh, b_sh),
                   out_shardings=(st_sh, None))
    grad = jax.jit(jax.value_and_grad(steps._forward_loss(cfg),
                                      has_aux=True),
                   in_shardings=(st_sh["params"], b_sh))
    with mesh, activation_ctx(plan):
        (loss, nll), g = grad(tree, batches[0])
        state = jax.device_put(
            {"params": tree,
             "opt": {"m": jax.tree.map(jnp.zeros_like, tree),
                     "v": jax.tree.map(jnp.zeros_like, tree),
                     "step": jnp.zeros((), jnp.int32)}}, st_sh)
        for t, batch in enumerate(batches):
            state, m = step(state, batch)
            for k in ("loss", "nll", "grad_norm", "lr"):
                out[f"{key}/{t}/{k}"] = np.asarray(m[k])
    out[f"{key}/loss"] = np.asarray(loss)
    out[f"{key}/nll"] = np.asarray(nll)
    for path, v in leaves(g).items():
        out[f"{key}/grad/{path}"] = np.asarray(v)
    for path, v in leaves(state["params"]).items():
        out[f"{key}/params/{path}"] = np.asarray(v)


def _train(out: dict):
    for arch in TRAIN_ARCHS:
        _train_on(out, f"train/{arch}", train_config(arch),
                  _mesh((2, 2), ("data", "model")),
                  jax.tree.map(jnp.asarray, train_weights(arch)))


def tp_config(case: str):
    arch, _, over = TP_CASES[case]
    return dataclasses.replace(get_config(arch).reduced(**over),
                               param_dtype="float32")


def tp_tokens(cfg) -> np.ndarray:
    rng = np.random.default_rng(TP["seed"])
    return rng.integers(0, cfg.vocab_size,
                        (TP["batch"], TP["prompt"] + TP["steps"]),
                        dtype=np.int32)


def _serve(cfg, params, toks, out, key, plan=None):
    """Prefill (after a prefix config's seeded prefix embeddings, or over an
    encoder-decoder's seeded frames), the attention caches padded to the
    window (the SSM states and the cross caches as the prefill leaves
    them), the teacher-forced decode steps from the slot after the
    prompt; jitted with the dry run's shardings under ``plan``, else with
    none."""
    pr, n = TP["prompt"], TP["steps"]
    p0 = cfg.n_prefix_tokens
    batch = {"tokens": jnp.asarray(toks[:, :pr]),
             **{k: jnp.asarray(v) for k, v in
                {**prefix_embeds(cfg, TP["batch"], TP["seed"]),
                 **frames(cfg, TP["batch"], TP["seed"])}.items()}}
    prefill_step = steps.make_prefill_step(cfg)
    decode_step = steps.make_decode_step(cfg)
    if plan is None:
        prefill = jax.jit(prefill_step)
        decode = jax.jit(decode_step)
    else:
        p_sh = params_only_shardings(cfg, plan)
        out_abs = jax.eval_shape(prefill_step, params, batch)
        cache_sh = decode_input_shardings(cfg, plan, {"caches": out_abs[1]})
        prefill = jax.jit(prefill_step,
                          in_shardings=(p_sh, batch_shardings(cfg, plan,
                                                              batch)),
                          out_shardings=(None, cache_sh["caches"]))
    with activation_ctx(plan):
        logits, caches = prefill(params, batch)
    out[f"{key}/prefill/logits"] = np.asarray(logits)
    for path, v in leaves(caches).items():
        out[f"{key}/prefill/{path}"] = np.asarray(v.astype(jnp.float32))
    pad = TP["max_len"] - pr
    # the decode window in float32 (the port's cases do the same); only
    # the attention caches have slots, but the cross caches, whose slots
    # are the encoder's frames
    caches = {name: {k: (jnp.pad(c, ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
                         if k in KV and name != "cross" else c
                         ).astype(jnp.float32)
                     for k, c in sub.items()} for name, sub in caches.items()}
    if plan is not None:
        inputs = {"token": jnp.asarray(toks[:, pr:pr + 1]), "caches": caches,
                  "cache_pos": jnp.int32(p0 + pr)}
        dec_sh = decode_input_shardings(cfg, plan, inputs)
        decode = jax.jit(decode_step, in_shardings=(
            p_sh, dec_sh["token"], dec_sh["caches"], dec_sh["cache_pos"]),
            out_shardings=(None, None, dec_sh["caches"]))
    for t in range(n):
        with activation_ctx(plan):
            _, logits, caches = decode(
                params, jnp.asarray(toks[:, pr + t:pr + t + 1]), caches,
                jnp.int32(p0 + pr + t))
        out[f"{key}/decode/{t}/logits"] = np.asarray(logits)
    for path, v in leaves(caches).items():
        if path.rsplit("/", 1)[-1] in KV and not path.startswith("cross/"):
            v = v[:, :, p0 + pr:p0 + pr + n]
        out[f"{key}/decode/{path}"] = np.asarray(v.astype(jnp.float32))


def _tp_train(out: dict):
    for case in TP_TRAIN:
        cfg = tp_config(case)
        _train_on(out, f"tp_train/{case}", cfg,
                  _mesh(TP_CASES[case][1], ("data", "model")),
                  jax.tree.map(jnp.asarray, _layers_rule()(cfg, SEED)))


def _tp(out: dict):
    for case, (_arch, shape, _over) in TP_CASES.items():
        cfg = tp_config(case)
        params = jax.tree.map(jnp.asarray, _layers_rule()(cfg, SEED))
        toks = tp_tokens(cfg)
        mesh = _mesh(shape, ("data", "model"))
        with mesh:
            _serve(cfg, params, toks, out, f"tp/{case}",
                   make_plan(cfg, mesh))
        _serve(cfg, params, toks, out, f"tp_plain/{case}")


PARTS = {"blocks": _blocks, "ep": _ep, "decode": _decode,
         "pipeline": _pipeline, "compressed": _compressed, "train": _train,
         "tp": _tp, "tp_train": _tp_train}
#: the parts ``tests/test_torch_sharding_mesh.py`` recomputes
BASE_PARTS = ("blocks", "ep", "decode", "pipeline", "compressed", "train")


def cases(parts=BASE_PARTS) -> dict:
    """The arrays of the mesh cases of ``parts``, whole (needs 4
    devices)."""
    assert jax.device_count() >= 4, "set XLA_FLAGS first (4 host devices)"
    out: dict = {}
    for part in parts:
        PARTS[part](out)
    return out


# -- plans and costs (no devices) ---------------------------------------------------

def _spec_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def plans() -> dict:
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        rec = {}
        for name, (shape, axes) in PRODUCTION.items():
            plan = make_plan(cfg, AbstractMesh(shape, axes))
            rec[name] = {
                "rules": {k: list(v) if isinstance(v, tuple) else v
                          for k, v in plan.rules.items()},
                "batch_axes": list(plan.batch_axes),
                "seq_axis": plan.seq_axis,
                "cache_seq_axis": plan.cache_seq_axis,
                "notes": list(plan.notes),
                "params": {p: _spec_json(spec_to_pspec(s, plan)) for p, s in
                           leaves(steps.model_param_specs(cfg)).items()},
                "inputs": {},
            }
            for shape_name in SHAPES:
                inputs = jspecs.input_specs(cfg, shape_name)
                fn = (decode_input_shardings
                      if jspecs.step_kind(shape_name) == "decode"
                      else batch_shardings)
                rec[name]["inputs"][shape_name] = {
                    p: _spec_json(sh.spec)
                    for p, sh in leaves(fn(cfg, plan, inputs)).items()}
        out[arch] = rec
    return out


def costs() -> dict:
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        rec = {}
        for name, sh in SHAPES.items():
            if not jspecs.cell_is_applicable(cfg, name)[0]:
                continue
            rec[name] = {"model_flops": model_flops(cfg, sh),
                         **{str(c): analytic_cost(cfg, sh, c).to_dict()
                            for c in CHIPS}}
        out[arch] = rec
    return out


# -- the file ------------------------------------------------------------------

def entry_index(size: int) -> np.ndarray:
    return np.linspace(0, size - 1, ENTRIES).round().astype(np.int64)


def sketch(g: np.ndarray, path: str) -> list:
    """experiments/train/make_reference.py's sketch of a flat array."""
    flat = np.asarray(g, np.float64).reshape(-1)
    rng = np.random.default_rng([SKETCH_SEED, *path.encode()])
    return [float(np.sum(rng.standard_normal(flat.size) * flat))
            / SKETCH ** 0.5 for _ in range(SKETCH)]


def encode(key: str, a: np.ndarray) -> dict:
    a = np.asarray(a)
    if a.dtype.kind in "US":
        return {"sha256": str(a)}
    if a.size <= WHOLE or key.startswith(("tp/", "tp_plain/")):
        kind = "<i4" if a.dtype.kind in "iu" else "<f4"
        b = np.ascontiguousarray(a.astype(kind))
        return {"shape": list(a.shape), "dtype": kind,
                "b64": base64.b64encode(b.tobytes()).decode("ascii")}
    flat = a.astype(np.float32).reshape(-1)
    return {"shape": list(a.shape),
            "norm": float(np.linalg.norm(flat.astype(np.float64))),
            "absmax": float(np.abs(flat).max()),
            "values": flat[entry_index(flat.size)].tolist(),
            "sketch": sketch(flat, key)}


def header() -> dict:
    return {"seed": SEED, "ep_cut": EP_CUT, "ep_x": EP_X, "decode": DECODE,
            "pipeline": PIPELINE, "compressed_cut": COMPRESSED_CUT,
            "data": DATA, "steps": STEPS, "train_archs": list(TRAIN_ARCHS),
            "tp": TP, "tp_cases": {k: [a, list(m), o] for k, (a, m, o)
                                   in TP_CASES.items()},
            "tp_train": list(TP_TRAIN), "prefix_seed": PREFIX_SEED,
            "frames_seed": FRAMES_SEED,
            "whole": WHOLE, "entries": ENTRIES, "sketch": SKETCH,
            "sketch_seed": SKETCH_SEED, "jax": jax.__version__}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--npz":
        # --npz PATH [PART ...]: the whole arrays of those parts (the base
        # parts by default)
        np.savez(argv[1], **cases(tuple(argv[2:]) or BASE_PARTS))
        return
    path = pathlib.Path(argv[0]) if argv else OUT
    mesh = {k: encode(k, v) for k, v in cases(tuple(PARTS)).items()}
    path.write_text(json.dumps({**header(), "plans": plans(),
                                "costs": costs(), "mesh": mesh}) + "\n")


if __name__ == "__main__":
    main()

"""The port's side of ``experiments/sharding/make_reference.py``'s mesh
cases, as rank bodies for ``core.analysis.distributed.launch_mesh``.

`run` is one rank of a mesh of four (``launch_mesh(run, 4, ...)``): on
named meshes over those ranks it computes, under the names the reference
uses, the arrays of every case: the blocks' sha256 (``blocks/...``), the
expert-parallel MoE and its gradients (``ep/...``), the seq-sharded decode
and the gathered decode on the same inputs (``decode/...``,
``decode_gathered/...``), ``pipeline_apply`` and its gradients
(``pipeline/...``), two compressed steps on each of
`COMPRESSED_MESHES`, on the ranks' blocks (``compressed/<tag>/...``), two
sharded train steps with the first step's gradients (``train/...``) and,
in the ``tp`` part, serving on this rank's blocks: each `TP_CASES`
config's prefill and decode steps (``tp/...``) beside the port's
unsharded steps on the whole weights (``tp_plain/...``), each rank's
storage bytes (``tp_bytes/...``) and one decode step's collectives
(``tp_ops/...``); in the ``tp_train`` part, training on this rank's
blocks: each `TP_TRAIN` config through the ``train`` recipe
(``tp_train/...``) beside the gather-whole form's gradients, a step's
collectives, the saved carry's shapes, ``build_trainer``'s state and the
vocab-parallel cross-entropy (`_tp_train`); in the ``ssd`` part, the SSD
on this rank's blocks against the whole-weight SSD (``ssd/...``, `_ssd`).
A prefix config's cases carry seeded prefix embeddings (`prefix_embeds`)
and decode from the slot after them; an encoder-decoder's, seeded frames
(`frames`), and its cross caches keep the encoder's slots.
Outputs and gradients are gathered whole; rank 0 returns them with each
part's wall time. `pod_exchange` runs `steps.pod_reduce` on given
gradients and errors (whole, or the rank's blocks of them), and
`pod_exchanges` on each of `COMPRESSED_MESHES`.
``tests/test_torch_sharding_mesh.py`` holds them to the JAX package on
the CPU, ``chip_smoke.py`` phase 16a to
``experiments/sharding/reference.json`` on the card. The inputs are the
reference's: the constants and numpy rules below are copies of its.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as tdist

__all__ = ["run", "pod_exchange", "pod_exchanges", "EP_X", "DECODE",
           "PIPELINE", "COMPRESSED_CUT", "COMPRESSED_AXES",
           "COMPRESSED_MESHES", "compressed_tag", "compressed_specs",
           "reference_key", "block_of", "scale_leaf", "DATA", "STEPS",
           "TRAIN_ARCHS", "EP_CUT", "SEED",
           "TP", "TP_CASES", "TP_TRAIN", "TP_XENT", "tp_config", "tp_tokens",
           "tp_start_caches", "seq_seams", "TP_FALLBACK", "SSD",
           "PREFIX_SEED", "prefix_embeds", "FRAMES_SEED", "frames",
           "decode_caches"]

SEED = 0
EP_CUT = dict(d_model=64, moe_d_ff=32)
EP_X = {"fsdp_local": (4, 16), "sharded": (4, 16), "padded": (2, 16),
        "tiny_batch": (1, 16), "no_seq_split": (4, 1), "dropping": (4, 16)}
DECODE = {"batch": 2, "smax": 64, "pos": (0, 15, 16, 31, 32, 47, 48, 63)}
PIPELINE = {"stages_micro": (6, 3, 16), "meshes": {"4x1": (4, 1),
                                                   "2x2": (2, 2)}}
COMPRESSED_CUT = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=128,
                      param_dtype="float32")
#: the compressed step's meshes over (pod, data, model): ranks 0-1 on the
#: first, all four on the others (each rank's blocks of the state); every
#: mesh is held to the reference's one whole-tree recipe
COMPRESSED_AXES = ("pod", "data", "model")
COMPRESSED_MESHES = ((2, 1, 1), (2, 1, 2), (2, 2, 1))
DATA = {"seed": 3, "batch": 4, "seq": 32}
STEPS = 2
TRAIN_ARCHS = ("gemma-2b", "granite-moe-1b-a400m")
#: serving on blocks: a batch of 2, an 8-token prompt prefilled, padded to
#: a 16-slot window, then 8 teacher-forced decode steps
TP = {"batch": 2, "prompt": 8, "max_len": 16, "steps": 8, "seed": 7}
#: case: (arch, (data, model), overrides of its ``.reduced()`` config; two
#: layers, so that every array of a case is whole in the reference file).
#: MHA: phi3 with 4 kv heads (1 q and 1 kv head a rank on (1, 4), 2 and 2
#: with FSDP on (2, 2)); GQA with qkv bias: qwen's 4 q / 2 kv heads on
#: (2, 2); MQA: gemma's one kv head, heads replicated and the cache's
#: sequence over model under each decode form; MoE: granite's 4 experts
#: over model (no drops at capacity factor 8), FSDP over data; SSM:
#: mamba2's 16 heads, 4 a rank on (1, 4), with FSDP on (2, 2); hybrid:
#: jamba's whole 8-layer period (SSM heads, kv heads and experts over model
#: on (2, 2); its 2 kv heads replicated and the cache's sequence sharded on
#: (1, 4)); prefix: paligemma (MQA) with 8 seeded prefix embeddings before
#: the prompt; encoder-decoder: whisper over 64 seeded frames, its 4 q / 2
#: kv heads replicated and the self (16 slots) and cross (64 frames)
#: caches' sequence over model on (1, 4), the heads (2 q and 1 kv a rank)
#: and both caches' kv heads over model with FSDP on (2, 2)
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
#: the SSD on blocks against the whole-weight SSD: mamba2-370m's
#: ``.reduced()`` (16 heads, 2 chunks of 32), a 64-position forward and its
#: gradient, then 4 decode steps
SSD = {"arch": "mamba2-370m", "batch": 2, "seq": 64, "decode": 4, "seed": 9}
#: a prefix config's seeded prefix embeddings: ``default_rng([PREFIX_SEED,
#: i])``, i the train batch's index or ``TP["seed"]`` for serving
PREFIX_SEED = 5
#: an encoder-decoder's seeded frames, the same way
FRAMES_SEED = 6
#: the cache leaves with a slot per position (the others: an SSM's state
#: and conv tail)
KV = ("k", "v", "k_scale", "v_scale")
#: training on blocks: the `TP_CASES` configs through the `train` recipe
#: (`DATA`'s batch of 4 x 32, `STEPS` steps); the decode form of
#: mqa_sharded_1x4 changes nothing in training
TP_TRAIN = tuple(c for c in TP_CASES if c != "mqa_sharded_1x4")
#: each rule's fallback, trained on (1, 4) in both forms: a sequence of 30
#: positions (30 % 4: the stream stays whole), a 510-row vocabulary (510 %
#: 4: the vocabulary stays whole); case: (arch, overrides, seq)
TP_FALLBACK = {
    "seq_30": ("phi3-mini-3.8b", {"n_layers": 2, "n_kv_heads": 4}, 30),
    "vocab_510": ("gemma-2b", {"n_layers": 2, "vocab_size": 510,
                               "vocab_pad_to": 2}, 32),
}
#: the vocab-parallel cross-entropy check: gemma-2b's ``.reduced()`` at a
#: 500-token vocabulary padded to 512 (12 padded rows), a softcap, a chunk
#: of 2 x 16 positions on (1, 4)
TP_XENT = {"cut": {"vocab_size": 500, "logit_softcap": 30.0}, "chunk": 16,
           "seed": 11}


# -- inputs (the reference's rules) ---------------------------------------------------

def numpy_tree(specs, seed: int = SEED) -> Dict:
    """The serving reference's weight rule on any spec tree."""
    from ..models.common import tree_leaves, unflatten

    rng = np.random.default_rng(seed)
    flat = dict(tree_leaves(specs))
    return unflatten({p: rng.standard_normal(flat[p].shape, np.float32)
                      * np.float32(flat[p].stddev() if flat[p].init
                                    == "normal" else 0.1)
                      for p in sorted(flat)})


def ep_config(case: str):
    from ..configs import get_config

    if case == "padded":
        cfg = get_config("granite-moe-3b-a800m").reduced(
            n_experts=6, top_k=2, **EP_CUT)
    else:
        cfg = get_config("granite-moe-1b-a400m").reduced(**EP_CUT)
    return dataclasses.replace(
        cfg, capacity_factor=1.0 if case == "dropping" else 8.0)


def ep_mesh(case: str):
    if case == "padded":
        return (1, 4), ("data", "model"), False
    return (2, 2), ("data", "model"), case in ("fsdp_local", "no_seq_split")


def ep_inputs(case: str):
    from ..models import moe

    cfg = ep_config(case)
    b, s = EP_X[case]
    x = np.random.default_rng(1).standard_normal(
        (b, s, cfg.d_model), np.float32) * np.float32(0.5)
    return cfg, numpy_tree(moe.param_specs(cfg)), x


def decode_config(cache: str):
    from ..configs import get_config

    return dataclasses.replace(
        get_config("gemma-2b").reduced(), param_dtype="float32",
        decode_attention="sharded",
        kv_cache_dtype="int8" if cache == "int8" else "bfloat16")


def decode_inputs(cache: str):
    from ..models import convert

    cfg = decode_config(cache)
    rng = np.random.default_rng(2)
    p = {k: v[0] for k, v in convert.conditioned_params(cfg, SEED)[
        "layers"]["l0"]["attn"].items()}
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


def tp_config(case: str):
    from ..configs import get_config

    arch, _, over = TP_CASES[case]
    return dataclasses.replace(get_config(arch).reduced(**over),
                               param_dtype="float32")


def tp_tokens(cfg) -> np.ndarray:
    """(batch, prompt + steps) int32: the prompt, then the decode steps'
    teacher-forced tokens."""
    rng = np.random.default_rng(TP["seed"])
    return rng.integers(0, cfg.vocab_size,
                        (TP["batch"], TP["prompt"] + TP["steps"]),
                        dtype=np.int32)


def pipeline_weights(stages: int):
    m, mb, d = PIPELINE["stages_micro"]
    rng = np.random.default_rng(4)
    w = rng.standard_normal((stages, d, d), np.float32) * np.float32(0.3)
    b = rng.standard_normal((stages, d), np.float32) * np.float32(0.1)
    x = rng.standard_normal((m, mb, d), np.float32)
    return w, b, x


def compressed_config():
    from ..configs import get_config

    return get_config("gemma-2b").reduced(**COMPRESSED_CUT)


def train_config(arch: str):
    from ..configs import get_config

    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32")


def train_weights(arch: str) -> Dict:
    from ..models import convert

    return convert.conditioned_params(train_config(arch), SEED)


def prefix_embeds(cfg, batch: int, i: int) -> Dict:
    """``{"prefix_embeds": (batch, P, d_model)}`` of a prefix config,
    standard normal float32 from ``default_rng([PREFIX_SEED, i])``; {} for
    the others."""
    if not cfg.n_prefix_tokens:
        return {}
    rng = np.random.default_rng([PREFIX_SEED, i])
    return {"prefix_embeds": rng.standard_normal(
        (batch, cfg.n_prefix_tokens, cfg.d_model), np.float32)}


def frames(cfg, batch: int, i: int) -> Dict:
    """``{"frames": (batch, enc_seq, d_model)}`` of an encoder-decoder,
    standard normal float32 from ``default_rng([FRAMES_SEED, i])``; {} for
    the others."""
    if not cfg.is_encdec:
        return {}
    rng = np.random.default_rng([FRAMES_SEED, i])
    return {"frames": rng.standard_normal(
        (batch, cfg.enc_seq, cfg.d_model), np.float32)}


def decode_caches(cfg, batch: int, length: int, **kw) -> Dict:
    """``init_decode_caches`` of ``cfg``'s model (``length`` self slots;
    an encoder-decoder's cross caches ``enc_seq``)."""
    from ..models import encdec, transformer

    return (encdec if cfg.is_encdec else transformer).init_decode_caches(
        cfg, batch, length, **kw)


def train_batches(cfg, n: int = STEPS) -> list:
    """SyntheticLM's batches; a prefix config's take P prefix embeddings
    and the first ``seq - P`` tokens (the labels cover all P + S hidden
    positions); an encoder-decoder's take seeded frames."""
    from ..data import DataConfig, SyntheticLM

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


# -- helpers -------------------------------------------------------------------------

def _t(tree, dev):
    from ..models.common import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def _np(t) -> np.ndarray:
    from ..models.common import host_array

    t = t.detach()
    return host_array(t.float() if t.dtype == torch.bfloat16 else t)


def _flat(tree) -> Dict:
    from ..models.common import sorted_leaves

    return dict(sorted_leaves(tree))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh(shape, axes, dev):
    from ..launch.mesh import make_debug_mesh

    return make_debug_mesh(shape, axes, device=dev)


# -- the cases -----------------------------------------------------------------------

def _blocks(out, dev):
    from ..configs import get_config
    from ..models import steps
    from . import make_plan
    from .partition import gather_tree, shard_tree, train_state_shardings

    cfg = get_config("granite-moe-1b-a400m").reduced()
    tree = _t(numpy_tree(steps.model_param_specs(cfg)), dev)
    mine = {}
    for layout, (shape, axes, fsdp) in {
            "2x2": ((2, 2), ("data", "model"), True),
            "pod_data": ((2, 2, 1), ("pod", "data", "model"), "pod_data")
    }.items():
        mesh = _mesh(shape, axes, dev)
        plan = make_plan(cfg, mesh, fsdp=fsdp)
        specs = train_state_shardings(cfg, plan)["params"]
        blocks = shard_tree(tree, specs, mesh)
        c = "".join(str(mesh.coords[a]) for a in axes)
        for path, t in _flat(blocks).items():
            mine[f"blocks/{layout}/{c}/{path}"] = hashlib.sha256(
                np.ascontiguousarray(_np(t)).tobytes()).hexdigest()
        whole = gather_tree(blocks, specs, mesh)
        mine[f"roundtrip/{layout}/{c}"] = all(
            torch.equal(a, _flat(tree)[p]) for p, a in _flat(whole).items())
    everyone = [None] * tdist.get_world_size()
    tdist.all_gather_object(everyone, mine)
    for rec in everyone:
        for k, v in rec.items():
            out[k] = np.array(v)


def _ep(out, dev):
    from ..models import moe
    from . import comm, make_plan
    from .partition import activation_ctx, batch_axis, block, gather_leaf
    from .rules import P

    for case in EP_X:
        cfg, p, x = ep_inputs(case)
        shape, axes, fsdp = ep_mesh(case)
        mesh = _mesh(shape, axes, dev)
        plan = make_plan(cfg, mesh, fsdp=fsdp)
        ep = mesh.shape["model"]
        sharded = cfg.n_experts % ep == 0 and plan.rules["experts"] == "model"
        wspec = P("model", None, None) if sharded else P(None, None, None)
        specs = {"router": P(None, None), "wi": wspec, "wg": wspec,
                 "wo": wspec}
        params = {k: block(v, specs[k], mesh).requires_grad_()
                  for k, v in _t(p, dev).items()}
        split = batch_axis(plan, x.shape[0]) is not None
        xt = torch.from_numpy(x).to(dev)
        xl = block(xt, P(plan.batch_axes if split else None), mesh)
        with activation_ctx(plan, split):
            y, aux = moe.moe(params, xl, cfg)
            sq = torch.sum(y ** 2)
            loss = comm.psum(sq, mesh, plan.batch_axes if split else None)
            names = sorted(params)
            grads = torch.autograd.grad(loss * (1.0 / mesh.size),
                                        [params[k] for k in names])
        grads = comm.reduce_grads(dict(zip(names, grads)), specs, mesh)
        out[f"ep/{case}/out"] = _np(gather_leaf(
            y.detach(), P(plan.batch_axes if split else None), mesh))
        out[f"ep/{case}/aux"] = _np(aux)
        for k in names:
            out[f"ep/{case}/grad/{k}"] = _np(gather_leaf(grads[k], specs[k],
                                                         mesh))


def _decode(out, dev):
    from ..models import attention
    from . import make_plan
    from .partition import activation_ctx, block, gather_leaf
    from .rules import P

    for cache in ("float32", "int8"):
        cfg, p, x, c = decode_inputs(cache)
        mesh = _mesh((1, 4), ("data", "model"), dev)
        plan = make_plan(cfg, mesh)
        pt, xt = _t(p, dev), torch.from_numpy(x).to(dev)
        spec = P(plan.batch_axes, "model", None, None)
        for pos in DECODE["pos"]:
            whole = {k: torch.from_numpy(v.copy()).to(dev).to(
                torch.bfloat16 if k.endswith("scale") else None)
                for k, v in c.items()}
            mine = {k: block(v, spec, mesh) for k, v in whole.items()}
            with torch.no_grad(), activation_ctx(plan, True):
                y, new = attention.decode_attention(pt, xt, mine, pos, cfg)
            key = f"decode/{cache}/{pos}"
            out[f"{key}/out"] = _np(y)
            for k, v in new.items():
                out[f"{key}/{k}"] = _np(gather_leaf(v, spec, mesh))
            with torch.no_grad():
                y, _ = attention.decode_attention(pt, xt, whole, pos, cfg)
            out[f"decode_gathered/{cache}/{pos}/out"] = _np(y)


def _stage(params, xm):
    wi, bi = params
    return torch.tanh(xm @ wi + bi)


def _pipeline(out, dev):
    from . import comm, pipeline_apply
    from .partition import block, gather_leaf
    from .rules import P

    for name, shape in PIPELINE["meshes"].items():
        mesh = _mesh(shape, ("pod", "data"), dev)
        w, b, x = pipeline_weights(shape[0])
        wl = block(torch.from_numpy(w).to(dev), P("pod"), mesh)
        bl = block(torch.from_numpy(b).to(dev), P("pod"), mesh)
        wl.requires_grad_()
        bl.requires_grad_()
        y = pipeline_apply(_stage, (wl, bl), torch.from_numpy(x).to(dev),
                           mesh, "pod")
        gw, gb = torch.autograd.grad(torch.sum(y ** 2) * (1.0 / mesh.size),
                                     [wl, bl])
        g = comm.reduce_grads({"w": gw, "b": gb},
                              {"w": P("pod"), "b": P("pod")}, mesh)
        out[f"pipeline/{name}/out"] = _np(y)
        out[f"pipeline/{name}/grad_w"] = _np(gather_leaf(g["w"], P("pod"),
                                                         mesh))
        out[f"pipeline/{name}/grad_b"] = _np(gather_leaf(g["b"], P("pod"),
                                                         mesh))


def compressed_tag(shape) -> str:
    """The name of a `COMPRESSED_MESHES` entry in the port's keys: its
    arrays are ``compressed/<tag>/...``, held to the reference's
    ``compressed/...``."""
    return "x".join(map(str, shape))


def reference_key(key: str) -> str:
    """The reference's name of a port key: ``compressed/<tag>/...`` loses
    its mesh tag (every mesh is held to the same whole-tree recipe)."""
    part = key.split("/")
    if part[0] == "compressed":
        return "/".join(part[:1] + part[2:])
    return key


class _Shape:
    def __init__(self, shape):
        self.shape = shape


def compressed_specs(shape) -> Dict:
    """{path: spec} of `compressed_config`'s params under
    ``train_state_shardings`` on a (pod, data, model) mesh of ``shape``."""
    from . import make_plan
    from .partition import train_state_shardings

    cfg = compressed_config()
    plan = make_plan(cfg, _Shape(dict(zip(COMPRESSED_AXES, shape))))
    return _flat(train_state_shardings(cfg, plan)["params"])


def block_of(a: np.ndarray, spec, coords: Dict, shape: Dict) -> np.ndarray:
    """``partition.block`` in numpy: the block of ``a`` under ``spec`` of
    the rank at ``coords`` on a mesh of ``shape`` ({axis: size})."""
    from ..launch.mesh import axes_tuple

    for dim, entry in enumerate(spec):
        axes = axes_tuple(entry)
        if not axes:
            continue
        n, i = 1, 0
        for ax in axes:
            n, i = n * shape[ax], i * shape[ax] + coords[ax]
        size = a.shape[dim] // n
        a = np.take(a, range(i * size, (i + 1) * size), axis=dim)
    return a


def _everyone(mine):
    """Every rank's ``mine`` (None off a mesh), in rank order."""
    got = [None] * tdist.get_world_size()
    tdist.all_gather_object(got, mine)
    return got


def _compressed(out, dev):
    """The compressed step on each of `COMPRESSED_MESHES`, on this rank's
    blocks: `STEPS` steps' metrics and the params after them, gathered
    whole (``compressed/<tag>/...``); every rank's block shapes of the
    params, moments and error after them (``compressed_blocks/<tag>/
    <rank>/...``); and one leaf whose largest ``|x|`` lies on one rank's
    block, through `steps.pod_reduce` (``compressed_scale/<tag>/<rank>/
    ...``: its codes and scale on each rank, `scale_leaf`)."""
    from ..models import steps
    from ..models.common import unflatten
    from ..optim import AdamWConfig, adamw
    from ..optim.compression import init_error_state
    from . import make_plan
    from .partition import block, gather_tree, shard_tree

    cfg = compressed_config()
    for shape in COMPRESSED_MESHES:
        tag = compressed_tag(shape)
        mesh = _mesh(shape, COMPRESSED_AXES, dev)
        shapes = scaled = None
        if mesh is not None:  # (2, 1, 1): ranks past its two wait below
            specs = compressed_specs(shape)
            spec_tree = unflatten(specs)
            params = shard_tree(_t(numpy_tree(steps.model_param_specs(cfg)),
                                   dev), spec_tree, mesh)
            opt_cfg = AdamWConfig()
            state = {"params": params,
                     "opt": adamw.init_state(params, opt_cfg)}
            err = init_error_state(params)
            step = steps.make_compressed_train_step(
                cfg, make_plan(cfg, mesh), opt_cfg)
            for t, batch in enumerate(train_batches(cfg)):
                state, m, err = step(state, batch, err)
                for k in ("loss", "nll", "grad_norm"):
                    out[f"compressed/{tag}/{t}/{k}"] = _np(m[k])
            whole = gather_tree(state["params"], spec_tree, mesh)
            for path, v in _flat(whole).items():
                out[f"compressed/{tag}/params/{path}"] = _np(v)
            shapes = {f"{name}/{path}": np.array(v.shape) for name, tree in
                      (("params", state["params"]), ("m", state["opt"]["m"]),
                       ("v", state["opt"]["v"]), ("err", err))
                      for path, v in _flat(tree).items()}
            shapes["coords"] = np.array([mesh.coords[a]
                                         for a in COMPRESSED_AXES])
            x, spec = scale_leaf(mesh.coords["pod"])
            with torch.no_grad():
                blk = block(torch.from_numpy(x).to(dev), spec, mesh)
                got = steps.pod_reduce(blk, torch.zeros_like(blk), mesh,
                                       ("data", "model"))
            scaled = {"codes": _np(got[2]), "scale": _np(got[3]),
                      "coords": shapes["coords"]}
        for r, (sh, sc) in enumerate(zip(_everyone(shapes),
                                         _everyone(scaled))):
            for k, v in (sh or {}).items():
                out[f"compressed_blocks/{tag}/{r}/{k}"] = v
            for k, v in (sc or {}).items():
                out[f"compressed_scale/{tag}/{r}/{k}"] = v


def scale_leaf(pod: int):
    """(pod ``pod``'s (8, 16) float32 leaf, its spec over ``data`` and
    ``model``): its largest ``|x|`` lies in the last rank's block; the
    pods' leaves differ."""
    from .rules import P

    rng = np.random.default_rng([SEED, pod])
    x = rng.standard_normal((8, 16), np.float32)
    x[-1, -1] = np.float32(-40.0 - 8.0 * pod)
    return x, P("data", "model")


def _train_on(out, key, cfg, mesh, weights, dev, probes=None):
    """The reference's train recipe on this rank's blocks of ``weights``:
    the first batch's loss, nll and gradients (``key/grad/...``, gathered
    whole), then `STEPS` steps of ``make_train_step`` (each step's metrics
    under ``key/<t>/...``) and the params after them. Returns (the plan,
    the spec tree, the blocks before the steps).

    ``probes`` (a dict) gets ``"ops"``, the first gradients' collectives
    ("kind axes" of each), taken with the remat off (the remat changes no
    number, but re-issues a layer's collectives in the backward), and
    ``"saved"``, the shapes autograd keeps outside the remat in the first
    step."""
    from contextlib import nullcontext

    from ..models import steps
    from ..models.common import unflatten
    from ..optim import AdamWConfig, adamw
    from . import make_plan
    from .comm import record_collectives
    from .partition import gather_tree, shard_tree, train_state_shardings

    plan = make_plan(cfg, mesh)
    specs = train_state_shardings(cfg, plan)["params"]
    tree = shard_tree(_t(weights, dev), specs, mesh)
    batches = train_batches(cfg)
    first = cfg if probes is None else dataclasses.replace(cfg, remat="none")
    grad_fn = steps._mesh_grad_fn(first, plan, specs)
    batch, split = steps._batch_block(batches[0], plan, dev)
    with (nullcontext() if probes is None else record_collectives()) as rec:
        (loss, nll), g = grad_fn(tree, batch, split)
    if probes is not None:
        probes["ops"] = [f"{op.kind} {'+'.join(op.axes)}" for op in rec.ops]
        probes["saved"] = saved = []

        def pack(t):
            saved.append("x".join(map(str, t.shape)))
            return t
    out[f"{key}/loss"] = _np(loss)
    out[f"{key}/nll"] = _np(nll)
    for path, v in _flat(gather_tree(g, specs, mesh)).items():
        out[f"{key}/grad/{path}"] = _np(v)
    del g
    opt_cfg = AdamWConfig()
    blocks = {p: t.clone() for p, t in _flat(tree).items()}
    state = {"params": tree, "opt": adamw.init_state(tree, opt_cfg)}
    step = steps.make_train_step(cfg, opt_cfg, plan=plan)
    for t, batch in enumerate(batches):
        with (torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x)
              if probes is not None and t == 0 else nullcontext()):
            state, m = step(state, batch)
        for k in ("loss", "nll", "grad_norm", "lr"):
            out[f"{key}/{t}/{k}"] = _np(m[k])
    whole = gather_tree(state["params"], specs, mesh)
    for path, v in _flat(whole).items():
        out[f"{key}/params/{path}"] = _np(v)
    return plan, specs, unflatten(blocks)


def _train(out, dev):
    for arch in TRAIN_ARCHS:
        cfg = train_config(arch)
        mesh = _mesh((2, 2), ("data", "model"), dev)
        _train_on(out, f"train/{arch}", cfg, mesh, train_weights(arch), dev)


def _tp_train(out, dev):
    """Each `TP_TRAIN` case trained on this rank's blocks (``tp_train/
    <case>/...``: `_train_on`, the JAX reference's recipe), with, on the
    same blocks and batch, the form that gathers every leaf whole
    (``tp_train_whole/<case>/...``: loss, nll and gradients), `_train_on`'s
    probes of the first gradients' collectives with the remat off
    (``tp_train_ops/<case>/<c>``: "kind axes" of each, every rank) and of
    the shapes autograd saved outside the remat in the first step
    (``tp_train_saved/<case>/<c>``) and whether
    ``launch.train.build_trainer``'s state is this rank's blocks of the
    whole draw, bit for bit (``tp_train_init/<case>/<c>``; but a prefix
    config and the encoder-decoder, whose batches its synthetic data
    cannot make). Then the
    vocab-parallel cross-entropy against the whole-vocabulary one
    (``tp_xent/...``, `_tp_xent`) and each rule's fallback
    (``tp_fallback/...``, `_tp_fallback`)."""
    from ..models import convert, steps
    from .partition import gather_tree

    mine = {}
    for case in TP_TRAIN:
        _arch, shape, _over = TP_CASES[case]
        cfg = tp_config(case)
        mesh = _mesh(shape, ("data", "model"), dev)
        key = f"tp_train/{case}"
        probes = {}
        plan, specs, blocks = _train_on(
            out, key, cfg, mesh, convert.conditioned_params(cfg, SEED), dev,
            probes)
        batch, split = steps._batch_block(train_batches(cfg)[0], plan, dev)
        (loss, nll), g = steps._mesh_grad_fn(cfg, plan, specs, tp=False)(
            blocks, batch, split)
        out[f"tp_train_whole/{case}/loss"] = _np(loss)
        out[f"tp_train_whole/{case}/nll"] = _np(nll)
        for path, v in _flat(gather_tree(g, specs, mesh)).items():
            out[f"tp_train_whole/{case}/grad/{path}"] = _np(v)
        c = "".join(str(mesh.coords[a]) for a in mesh.axis_names)
        mine[f"tp_train_ops/{case}/{c}"] = probes["ops"]
        mine[f"tp_train_saved/{case}/{c}"] = probes["saved"]
        if not (cfg.n_prefix_tokens or cfg.is_encdec):
            # build_trainer refuses a prefix config and the encoder-decoder
            mine[f"tp_train_init/{case}/{c}"] = _init_is_blocks(cfg, mesh,
                                                                dev)
    _tp_xent(out, dev)
    _tp_fallback(out, mine, dev)
    everyone = [None] * tdist.get_world_size()
    tdist.all_gather_object(everyone, mine)
    for rec in everyone:
        for k, v in rec.items():
            out[k] = np.array(v)


def _tp_fallback(out, mine, dev):
    """Each `TP_FALLBACK` case's first step on (1, 4) in the
    tensor-parallel form and the gather-whole form on the same blocks
    (``tp_fallback/<case>/{tp,whole}/...``: loss and gradients), and the
    tensor-parallel step's collectives with the remat off
    (``tp_fallback_ops/<case>/<c>``)."""
    from ..configs import get_config
    from ..data import DataConfig, SyntheticLM
    from ..models import convert, steps
    from . import make_plan
    from .comm import record_collectives
    from .partition import gather_tree, shard_tree, train_state_shardings

    for case, (arch, over, seq) in TP_FALLBACK.items():
        cfg = dataclasses.replace(get_config(arch).reduced(**over),
                                  param_dtype="float32")
        mesh = _mesh((1, 4), ("data", "model"), dev)
        plan = make_plan(cfg, mesh)
        specs = train_state_shardings(cfg, plan)["params"]
        blocks = shard_tree(_t(convert.conditioned_params(cfg, SEED), dev),
                            specs, mesh)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=DATA["batch"],
                                      seed=DATA["seed"])).batch_at(0)
        batch, split = steps._batch_block(data, plan, dev)
        for form, tp in (("tp", True), ("whole", False)):
            (loss, _), g = steps._mesh_grad_fn(cfg, plan, specs, tp=tp)(
                blocks, batch, split)
            out[f"tp_fallback/{case}/{form}/loss"] = _np(loss)
            for path, v in _flat(gather_tree(g, specs, mesh)).items():
                out[f"tp_fallback/{case}/{form}/grad/{path}"] = _np(v)
        with record_collectives() as rec:
            steps._mesh_grad_fn(dataclasses.replace(cfg, remat="none"),
                                plan, specs)(blocks, batch, split)
        c = "".join(str(mesh.coords[a]) for a in mesh.axis_names)
        mine[f"tp_fallback_ops/{case}/{c}"] = [
            f"{op.kind} {'+'.join(op.axes)}" for op in rec.ops]


def seq_seams(case: str) -> int:
    """A `TP_TRAIN` case's all-gathers over model in a train step with the
    remat off, and as many reduce-scatters (each the other's adjoint): the
    embedding's vocab-parallel sum reduced onto the sequence block (a
    prefix config sums it whole, then cuts the P + S stream), each
    layer's gathers of the sequence into attention, the SSD and the MLP
    and a reduce after each whose weights are model blocks (an MoE's
    router gathered whole instead of its MLP's), the gather before the
    loss. An encoder-decoder's encoder layers likewise (attention and the
    MLP), the encoder's output gathered whole once, each decoder layer's
    self-attention, cross-attention and MLP. No parameter leaf is
    gathered over model but the router."""
    from . import make_plan

    class Shape:
        def __init__(self, shape):
            self.shape = shape

    cfg = tp_config(case)
    plan = make_plan(cfg, Shape(dict(zip(("data", "model"),
                                         TP_CASES[case][1]))))
    n = 1 + (plan.rules["vocab"] is not None and not cfg.n_prefix_tokens)
    heads = plan.rules["heads"] is not None
    if cfg.is_encdec:
        mlp = 1 + (plan.rules["mlp"] is not None)
        return (n + cfg.n_enc_layers * (1 + heads + mlp) + 1
                + cfg.n_layers * (2 * (1 + heads) + mlp))
    for mixer, ffn in cfg.layer_kinds():
        n += 1 + (plan.rules["heads" if mixer == "attn" else "ssm_inner"]
                  is not None)
        if ffn != "none":
            n += 1 if ffn == "moe" else 1 + (plan.rules["mlp"] is not None)
    return n


def _init_is_blocks(cfg, mesh, dev) -> bool:
    """Whether ``build_trainer``'s state on ``mesh`` (drawn leaf by leaf,
    each leaf cut at once) is this rank's blocks of the whole draw from
    the same seed, bit for bit, moments included."""
    from ..launch.train import build_trainer
    from ..models import steps
    from ..models.common import init_params
    from .partition import shard_tree, train_state_shardings

    init_state, _, _, _, plan = build_trainer(cfg, mesh, device=dev)
    state = init_state()
    specs = train_state_shardings(cfg, plan)["params"]
    gen = torch.Generator(device=dev).manual_seed(0)
    whole = init_params(steps.model_param_specs(cfg), gen,
                        steps._dtype(cfg.master_dtype), dev)
    want = _flat(shard_tree(whole, specs, mesh))
    got = _flat(state["params"])
    return sorted(got) == sorted(want) and all(
        torch.equal(got[p], want[p]) for p in want) and all(
        not bool(t.any()) for part in ("m", "v")
        for t in _flat(state["opt"][part]).values())


def _tp_xent(out, dev):
    """The vocab-parallel loss chunk (``transformer._loss_chunk`` on this
    rank's block of the vocab projection over model) against the whole
    vocabulary's on (1, 4): `TP_XENT`'s vocabulary has padded rows, a
    softcap, and labels on every rank's block and -1; tied and untied.
    Rank 0 keeps the loss sum, the token count and the gradients of the
    hidden states and the projection (``tp_xent/<form>/{vp,whole}/...``;
    the vocab-parallel ones summed and gathered: the partial convention,
    the loss over the ranks)."""
    from ..configs import get_config
    from ..models import transformer
    from . import comm, make_plan
    from .partition import activation_ctx, block, gather_leaf
    from .rules import P

    mesh = _mesh((1, 4), ("data", "model"), dev)
    for tied in (True, False):
        cfg = dataclasses.replace(
            get_config("gemma-2b").reduced(**TP_XENT["cut"]),
            tie_embeddings=tied, param_dtype="float32")
        plan = make_plan(cfg, mesh)
        rng = np.random.default_rng(TP_XENT["seed"])
        b, c, d, v = 2, TP_XENT["chunk"], cfg.d_model, cfg.padded_vocab
        h = torch.from_numpy(rng.standard_normal((b, c, d), np.float32)).to(
            dev)
        w = torch.from_numpy(rng.standard_normal(
            (v, d) if tied else (d, v), np.float32) * np.float32(0.2)).to(dev)
        y = torch.from_numpy(rng.integers(-1, cfg.vocab_size, (b, c)).astype(
            np.int32)).to(dev)
        # one label in every rank's block (the last rank's in its last
        # real row), one -1
        for r in range(4):
            y[0, r] = min((r + 1) * v // 4 - 1, cfg.vocab_size - 1)
        y[1, 0] = -1
        name = "embed" if tied else "lm_head"
        spec = P("model", None) if tied else P(None, "model")
        form = "tied" if tied else "untied"
        hv = h.clone().requires_grad_()
        wv = block(w, spec, mesh).requires_grad_()
        with activation_ctx(plan):
            ls, ts = transformer._loss_chunk({name: wv}, hv, y, cfg)
            gh, gw = torch.autograd.grad(ls * (1.0 / mesh.size), [hv, wv])
            gh = comm.psum(gh, mesh, "model")
            gw = gather_leaf(gw, spec, mesh)
        hw, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        lw, tw = transformer._loss_chunk({name: ww}, hw, y, cfg)
        gwh, gww = torch.autograd.grad(lw, [hw, ww])
        if mesh.rank == 0:
            for tag, vals in (("vp", (ls, ts, gh, gw)),
                              ("whole", (lw, tw, gwh, gww))):
                for k, t in zip(("loss", "count", "grad_h", "grad_w"), vals):
                    out[f"tp_xent/{form}/{tag}/{k}"] = _np(t)


def _slots(name: str, key: str) -> bool:
    """Whether cache leaf ``name/key`` has a slot per decoded position
    (an attention cache's, but the cross caches')."""
    return key in KV and name != "cross"


class _Serving:
    """One case's steps on one model (this rank's blocks under ``plan``,
    or the whole model with ``plan`` None), recording whole arrays
    (gathered over the batch and the cache blocks). ``extra``: the
    prefill's prefix embeddings or frames (the same block of the batch as
    ``toks``)."""

    def __init__(self, cfg, model, toks, plan, out, extra=None):
        self.cfg, self.model, self.plan, self.out = cfg, model, plan, out
        self.split = plan is not None and toks.shape[0] < TP["batch"]
        self.toks, self.extra = toks, extra or {}
        self.p0 = cfg.n_prefix_tokens

    def _specs(self, length):
        from .partition import serving_cache_shardings

        return serving_cache_shardings(
            self.cfg, self.plan, decode_caches(
                self.cfg, TP["batch"], self.p0 + length, device="meta"),
            self.split)

    def whole(self, caches, length):
        """The global caches (``length`` slots after the prefix) from this
        rank's blocks."""
        from .partition import gather_leaf

        if self.plan is None:
            return caches
        specs = self._specs(length)
        return {name: {k: gather_leaf(t, specs[name][k], self.plan.mesh)
                       for k, t in c.items()} for name, c in caches.items()}

    def window(self, prompt_caches):
        """This rank's blocks of the decode window (float32, ``max_len``
        slots after the prefix) holding the given global prompt caches (a
        tree of arrays; an SSM's state and conv tail, and the cross
        caches, as they are)."""
        from .partition import block

        dev = self.toks.device
        pad = TP["max_len"] - TP["prompt"]
        specs = None if self.plan is None else self._specs(TP["max_len"])
        out = {}
        for name, c in prompt_caches.items():
            out[name] = {}
            for k, t in c.items():
                w = torch.from_numpy(np.array(t, np.float32)).to(dev)
                if _slots(name, k):
                    w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad))
                out[name][k] = (w if specs is None else
                                block(w, specs[name][k], self.plan.mesh))
        return out

    def _batch(self, t):
        from .partition import gather_leaf
        from .rules import P

        if not self.split:
            return t
        return gather_leaf(t, P(self.plan.batch_axes), self.plan.mesh)

    def prefill(self, key):
        """The prompt's prefill, its logits and caches under ``key``;
        returns this rank's cache blocks."""
        from ..models import steps
        from .partition import activation_ctx

        with activation_ctx(self.plan, self.split):
            logits, caches = steps.make_prefill_step(self.cfg)(
                self.model, {"tokens": self.toks[:, :TP["prompt"]],
                             **self.extra})
            self.out[f"{key}/prefill/logits"] = _np(self._batch(logits))
            for name, c in self.whole(caches, TP["prompt"]).items():
                for k, t in c.items():
                    self.out[f"{key}/prefill/{name}/{k}"] = _np(t)
        return caches

    def decode(self, caches, key, rec_ops=None):
        """The teacher-forced decode steps from the window ``caches``;
        each step's logits and the written window under ``key``."""
        from ..models import steps
        from .comm import record_collectives
        from .partition import activation_ctx

        pr, n = self.p0 + TP["prompt"], TP["steps"]
        step = steps.make_decode_step(self.cfg)
        with activation_ctx(self.plan, self.split):
            for t in range(n):
                tok = self.toks[:, TP["prompt"] + t:TP["prompt"] + t + 1]
                if t == 0 and rec_ops is not None:
                    with record_collectives() as rec:
                        _, logits, caches = step(self.model, tok, caches, pr)
                    rec_ops.extend(rec.ops)
                else:
                    _, logits, caches = step(self.model, tok, caches, pr + t)
                self.out[f"{key}/{t}/logits"] = _np(self._batch(logits))
            for name, c in self.whole(caches, TP["max_len"]).items():
                for k, t in c.items():
                    self.out[f"{key}/{name}/{k}"] = _np(
                        t[:, :, pr:pr + n] if _slots(name, k) else t)
        return caches


def _tp(out, dev, start=None):
    """Each `TP_CASES` case on this rank's blocks (``tp/<case>/...``):
    the prefill; the decode continued from its own prefill blocks, padded
    (``continued/...``); with ``start`` ({case: the reference's prefill
    caches, whole}) the decode from those (``decode/...``, where the JAX
    decode starts: the two programs' bf16 prefill caches may round an
    entry apart, and a decode carries that). Rank 0 runs the same on the
    whole model (``tp_plain/<case>/...``), its continued decode from the
    blocks' own prefill caches gathered whole. Every rank's storage bytes
    (``tp_bytes/...``) and its first continued decode step's collectives
    (``tp_ops/...``) are all-gathered."""
    from ..models import convert, steps
    from ..models.common import tree_leaves, tree_map
    from . import make_plan
    from .partition import batch_axis, block, serving_shardings, shard_tree
    from .rules import P

    mine = {}
    for case, (_arch, shape, _over) in TP_CASES.items():
        cfg = tp_config(case)
        mesh = _mesh(shape, ("data", "model"), dev)
        plan = make_plan(cfg, mesh)
        whole = _t(convert.conditioned_params(cfg, SEED), dev)
        model = steps.make_model(
            cfg, shard_tree(whole, serving_shardings(cfg, plan), mesh), plan)
        toks = torch.from_numpy(tp_tokens(cfg)).to(dev)
        extra = _t({**prefix_embeds(cfg, TP["batch"], TP["seed"]),
                    **frames(cfg, TP["batch"], TP["seed"])}, dev)
        split = batch_axis(plan, toks.shape[0]) is not None
        cut = P(plan.batch_axes if split else None)
        tp = _Serving(cfg, model, block(toks, cut, mesh), plan, out,
                      {k: block(v, cut, mesh) for k, v in extra.items()})
        key = f"tp/{case}"
        prompt = tp.prefill(key)
        own = tree_map(lambda t: t.detach().float().cpu().numpy(),
                       tp.whole(prompt, TP["prompt"]))
        ops = []
        caches = tp.decode(tree_map(lambda t: t.float(), model.pad_caches(
            prompt, cfg.n_prefix_tokens + TP["max_len"])),
            f"{key}/continued", ops)
        if start is not None:
            tp.decode(tp.window(start[case]), f"{key}/decode")
        c = "".join(str(mesh.coords[a]) for a in mesh.axis_names)
        mine[f"tp_bytes/{case}/{c}/params"] = _storage_bytes(
            list(model.parameters()))
        mine[f"tp_bytes/{case}/{c}/caches"] = _storage_bytes(
            [t for _, t in tree_leaves(caches)])
        mine[f"tp_ops/{case}/{c}"] = [
            f"{op.kind} {'+'.join(op.axes)}" for op in ops]
        del model, caches
        if mesh.rank == 0:
            plain = _Serving(cfg, steps.make_model(cfg, whole), toks, None,
                             out, extra)
            key = f"tp_plain/{case}"
            plain.prefill(key)
            plain.decode(plain.window(own), f"{key}/continued")
            if start is not None:
                plain.decode(plain.window(start[case]), f"{key}/decode")
    everyone = [None] * tdist.get_world_size()
    tdist.all_gather_object(everyone, mine)
    for rec in everyone:
        for k, v in rec.items():
            out[k] = np.array(v)


def _ssd(out, dev):
    """The SSD on this rank's blocks on (1, 4) (`SSD`'s config: 4 of 16
    heads a rank) against the whole-weight SSD on the same inputs, every
    rank: ``ssd/<what>/<c>`` holds (largest |error|, largest |whole|) of
    the forward's output, its state (the rank's heads block of the
    whole's), its conv tail (whole), the gradient of every leaf (the
    rank's block of the whole gradient) and, after each of `SSD`'s decode
    steps from that state, the output and the new state and tail; and of
    the gated RMSNorm's statistic over the rank's columns summed over the
    ranks against the mean over the whole width."""
    from ..configs import get_config
    from ..models import ssm
    from . import comm, make_plan
    from .partition import activation_ctx, block
    from .rules import P, param_shardings

    cfg = dataclasses.replace(get_config(SSD["arch"]).reduced(),
                              param_dtype="float32")
    mesh = _mesh((1, 4), ("data", "model"), dev)
    plan = make_plan(cfg, mesh)
    specs = param_shardings(ssm.param_specs(cfg), plan)
    whole = _t(numpy_tree(ssm.param_specs(cfg)), dev)
    rng = np.random.default_rng(SSD["seed"])
    b, s, d = SSD["batch"], SSD["seq"], cfg.d_model
    u = torch.from_numpy(rng.standard_normal((b, s, d), np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((b, s, d), np.float32)).to(dev)
    steps_u = torch.from_numpy(rng.standard_normal(
        (SSD["decode"], b, 1, d), np.float32)).to(dev)
    c = "".join(str(mesh.coords[a]) for a in mesh.axis_names)
    heads = P(None, "model", None, None)
    mine = {}

    def held(what, got, want):
        mine[f"ssd/{what}/{c}"] = (float((got - want).detach().abs().max()),
                                   float(want.detach().abs().max()))

    names = sorted(whole)
    wl = {k: whole[k].clone().requires_grad_() for k in names}
    yw, stw = ssm.ssd_forward(wl, u, cfg, return_state=True)
    gw = dict(zip(names, torch.autograd.grad(torch.sum(yw * w),
                                             [wl[k] for k in names])))
    bl = {k: block(whole[k], specs[k], mesh).requires_grad_()
          for k in names}
    with activation_ctx(plan):
        y, st = ssm.ssd_forward(bl, u, cfg, return_state=True)
        g = torch.autograd.grad(torch.sum(y * w) * (1.0 / mesh.size),
                                [bl[k] for k in names])
    g = comm.reduce_grads(dict(zip(names, g)), specs, mesh)
    held("forward/out", y.detach(), yw.detach())
    held("forward/ssm", st["ssm"].detach(), block(stw["ssm"], heads, mesh))
    held("forward/conv", st["conv"].float(), stw["conv"].float())
    for k in names:
        held(f"grad/{k}", g[k], block(gw[k], specs[k], mesh))
    with torch.no_grad():
        bl = {k: v.detach() for k, v in bl.items()}
        stw = {k: v.detach() for k, v in stw.items()}
        st = {k: v.detach() for k, v in st.items()}
        for t in range(SSD["decode"]):
            yw, stw = ssm.ssd_decode(whole, steps_u[t], stw, cfg)
            with activation_ctx(plan):
                y, st = ssm.ssd_decode(bl, steps_u[t], st, cfg)
            held(f"decode/{t}/out", y, yw)
            held(f"decode/{t}/ssm", st["ssm"], block(stw["ssm"], heads,
                                                     mesh))
            held(f"decode/{t}/conv", st["conv"].float(), stw["conv"].float())
        yy = torch.from_numpy(rng.standard_normal(
            (b, s, cfg.ssm_d_inner), np.float32)).to(dev)
        with activation_ctx(plan):
            split = ssm.sq_mean(block(yy, P(None, None, "model"), mesh),
                                "model", cfg)
        held("norm/stat", split, ssm.sq_mean(yy, None, cfg))
    everyone = [None] * tdist.get_world_size()
    tdist.all_gather_object(everyone, mine)
    for rec in everyone:
        for k, v in rec.items():
            out[k] = np.array(v)


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors`` (a block's layers
    are views of its stacked leaves)."""
    return sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in tensors}.values())


PARTS = {"blocks": _blocks, "ep": _ep, "decode": _decode,
         "pipeline": _pipeline, "compressed": _compressed, "train": _train,
         "tp": _tp, "tp_train": _tp_train, "ssd": _ssd}
#: the parts of ``experiments/sharding/reference.json``'s mesh cases before
#: serving on blocks (``tp``, run on its own)
BASE_PARTS = ("blocks", "ep", "decode", "pipeline", "compressed", "train")


def run(mesh, parts=BASE_PARTS, tp_start=None) -> Dict:
    """One rank of four: every case of ``parts``; rank 0 returns
    ``(arrays, {part: wall seconds})``. ``tp_start``: the ``tp`` part's
    shared decode start (`tp_start_caches` of the reference file)."""
    from ..models import steps

    dev = mesh.device
    if dev.type == "cuda":
        steps.set_exact_gemms()
    out, walls = {}, {}
    for name in parts:
        _sync(dev)
        tdist.barrier()
        t0 = time.perf_counter()
        if name == "tp":
            _tp(out, dev, tp_start)
        else:
            PARTS[name](out, dev)
        _sync(dev)
        walls[name] = time.perf_counter() - t0
    return out, walls


def tp_start_caches(arrays: Dict) -> Dict:
    """{case: the reference's prefill caches, whole} from its ``tp/<case>/
    prefill/<name>/<k>`` arrays (``experiments/sharding/reference.json``'s
    mesh part, decoded; an encoder-decoder's ``self`` and ``cross``
    caches): `run`'s ``tp_start``."""
    from ..models.common import unflatten

    out = {}
    for case in TP_CASES:
        head = f"tp/{case}/prefill/"
        out[case] = unflatten({k[len(head):]: np.asarray(v, np.float32)
                               for k, v in arrays.items()
                               if k.startswith(head) and not
                               k.endswith("/logits")})
    return out


def pod_exchange(mesh, grads: Dict, errs: Dict, specs=None) -> list:
    """`steps.pod_reduce` on this pod's ``grads[pod]`` and ``errs[pod]``
    (numpy trees by path), whole or, with ``specs`` ({path: spec}), this
    rank's block of each leaf (its scale over the axes the spec names);
    every rank's results come back from each: [(coords, {path: (mean, new
    error, codes, scale, all codes)})] in rank order over the mesh."""
    from ..launch.mesh import spec_axes
    from ..models import steps
    from .partition import block

    pod = mesh.coords["pod"]
    dev = mesh.device
    mine = {}
    with torch.no_grad():
        for path in sorted(grads[pod]):
            g = torch.from_numpy(np.array(grads[pod][path])).to(dev)
            e = torch.from_numpy(np.array(errs[pod][path])).to(dev)
            axes = ()
            if specs is not None:
                g, e = block(g, specs[path], mesh), block(e, specs[path], mesh)
                axes = spec_axes(specs[path])
            mine[path] = tuple(_np(t) for t in steps.pod_reduce(g, e, mesh,
                                                                axes))
    everyone = [None] * mesh.size
    group, _ = mesh.group(mesh.axis_names)
    tdist.all_gather_object(everyone, (dict(mesh.coords), mine), group=group)
    return everyone


def pod_exchanges(mesh, grads: Dict, errs: Dict) -> Dict:
    """One rank of four: `pod_exchange` on each of `COMPRESSED_MESHES`
    (whole leaves on (2, 1, 1), the rank's blocks on the others); rank 0
    returns {tag: its result}."""
    out = {}
    for shape in COMPRESSED_MESHES:
        m = _mesh(shape, COMPRESSED_AXES, mesh.device)
        specs = None if shape == COMPRESSED_MESHES[0] else \
            compressed_specs(shape)
        if m is not None:
            out[compressed_tag(shape)] = pod_exchange(m, grads, errs, specs)
    return out

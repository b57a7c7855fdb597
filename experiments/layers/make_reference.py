"""Reference for the other layer kinds, computed by the JAX package.

Writes ``experiments/layers/reference.json`` for granite-moe-1b-a400m
(MoE), mamba2-370m (SSD), jamba-1.5-large-398b (the hybrid: one full
8-layer period of SSM, attention, MLP and MoE layers), whisper-tiny
(encoder-decoder) and paligemma-3b (prefix embeddings), each
``.reduced()``. Weights come from a conditioned numpy rule over the
config's whole spec tree (``steps.model_param_specs``: the enc-dec specs
for whisper), which the port implements as
``repro_torch.models.convert.conditioned_params``: the leaves sorted by
path, each drawn from one ``np.random.default_rng(seed)`` in that order
as ``standard_normal(shape, float32) * std + mean``, where a projection's
std is 1/sqrt of the size it sums over (``_fan_in``), the token tables
keep their spec's 0.02, and a zeros/ones leaf is its init value (mean)
plus 0.1 noise, ``dt_bias`` centred on -4 (dt = softplus(-4 + x) near
Mamba-2's initial range [0.001, 0.1]). The serving reference's rule
(``experiments/serve/make_reference.py``: the spec's fan-in, which for
the attention's q/k/v is the heads axis, and the zeros/ones leaves at 0.1
noise around zero) gives attention scores of O(10) and SSD steps near 0.7;
there the bfloat16 gradients are 45-190% off the float32 ones (and two
bfloat16 programs of the JAX package further apart than that), so no
bfloat16 gradient could be held. Under this rule they are 0.3-29% off
(``conditioning.py`` (B)). For each config the file lists every ``(path, shape)`` and the weights'
sha256, and records in float32 and in bfloat16 ``param_dtype``:

* ``prefill_logits``: the prefill step's last-token logits of a (2, 64)
  prompt; whisper's prefill encodes seeded frames (2, enc_seq, d_model),
  paligemma's puts seeded prefix embeddings (2, P, d_model) in front;
* ``decode_logits``: the prefill of the prompt's first half (with the
  frames or the prefix), its caches re-padded to a window of P + 64
  positions in the param dtype, then teacher-forced decode of the second
  half from there; the logits at ``DECODE_AT`` of those 32 steps, (8, 2,
  V);
* ``routing``: for each MoE layer of the full prompt's prefill, in the
  order the layers run, the routed expert ids (T, k) and each token's
  top-k margin, the k-th minus the (k+1)-th router probability;
* ``serve``: what ``launch.serve.Server`` serves for 6 requests (as
  ``experiments/serve``: prompts of 4-12 tokens, ``max_new=8``,
  ``max_batch=4``, ``max_len=64``): each request's tokens, the step count,
  and for every decode call the position, the next tokens of all slots
  and their top-2 logit gaps;
* ``train``: one train step (``AdamWConfig()``, ``remat="full"``) on a
  ``SyntheticLM`` batch (seed 3, 2 x 64; whisper's with seeded frames,
  paligemma's with P seeded prefix embeddings and 64 - P tokens): the
  loss, nll and grad_norm, and per gradient leaf its L2 norm, largest
  |entry|, 8 entries, a 64-row Gaussian sketch (as
  ``experiments/train``) and, for bfloat16, ``bf16_gap`` = ||g_bf16 -
  g_f32|| / ||g_f32||.

Arrays are float32 (bfloat16 values exactly), little-endian, base64. It
imports the JAX package only and runs on the CPU (~1.5 min)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/layers/make_reference.py

The PyTorch port is held to this file by ``tests/test_torch_layers.py``
(``tests/test_torch_layers_regen.py`` regenerates it bit for bit) and by
``chip_smoke.py`` phase 15a, under the tolerances that
``experiments/layers/conditioning.py`` measures.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.data import DataConfig, SyntheticLM
from repro.launch.serve import Request, Server
from repro.models import encdec, moe, steps, transformer
from repro.optim import AdamWConfig

OUT = pathlib.Path(__file__).resolve().parent / "reference.json"
ARCHS = ("granite-moe-1b-a400m", "mamba2-370m", "jamba-1.5-large-398b",
         "whisper-tiny", "paligemma-3b")
SEED = 0
PROMPT_SEED, PROMPT_SHAPE, HALF = 1, (2, 64), 32
DECODE_AT = tuple(range(3, 32, 4))
INPUT_SEED = 4                 # frames / prefix embeddings of the prompt
SERVE = {"seed": 2, "requests": 6, "min_len": 4, "max_len_prompt": 12,
         "max_new": 8, "max_batch": 4, "max_len": 64}
TRAIN = {"seed": 3, "batch": 2, "seq": 64, "input_seed": 6}
ENTRIES = 8
SKETCH, SKETCH_SEED = 64, 11
SMALL_LEAF_STD = 0.1
SSM_DT_BIAS = -4.0
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def config(arch: str, dtype: str = "float32"):
    return dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype)


def _leaves(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: hasattr(x, "shape"))
    return {"/".join(k.key for k in path): s for path, s in flat}


def _fan_in(s) -> int:
    """The size a projection leaf sums over: its axes but the batch axes
    (``layers``, ``experts``) and the output (the last axis, or
    ``(heads, head_dim)``)."""
    out = 2 if s.axes[-1] == "head_dim" else 1
    return int(np.prod([n for n, ax in zip(s.shape[:-out], s.axes[:-out])
                        if ax not in ("layers", "experts")]))


def conditioned_params(cfg, seed: int = SEED) -> dict:
    """The conditioned weight rule over ``model_param_specs`` (see the
    module docstring)."""
    leaves = _leaves(steps.model_param_specs(cfg))
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path in sorted(leaves):
        s = leaves[path]
        mean = 0.0
        if s.init != "normal":
            std = SMALL_LEAF_STD
            mean = SSM_DT_BIAS if path.endswith("dt_bias") else float(
                s.init == "ones")
        elif "vocab" in s.axes:
            std = s.stddev()
        else:
            std = 1.0 / float(np.sqrt(max(_fan_in(s), 1)))
        node = out
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = rng.standard_normal(s.shape, np.float32) * np.float32(
            std) + np.float32(mean)
    return out


def params_sha256(tree: dict) -> str:
    leaves = _leaves(tree)
    h = hashlib.sha256()
    for path in sorted(leaves):
        h.update(np.ascontiguousarray(leaves[path]).tobytes())
    return h.hexdigest()


def encode(x) -> dict:
    a = np.asarray(np.asarray(x).astype(np.float32), dtype="<f4")
    return {"shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(d: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]), dtype="<f4").reshape(
        d["shape"])


def prompt(cfg) -> np.ndarray:
    return np.random.default_rng(PROMPT_SEED).integers(
        0, cfg.vocab_size, PROMPT_SHAPE, dtype=np.int32)


def extra_inputs(cfg, batch: int, seed: int) -> dict:
    """Seeded float32 ``frames`` (whisper) or ``prefix_embeds``
    (paligemma), standard normal; {} for the other configs."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model), np.float32)}
    if cfg.n_prefix_tokens:
        return {"prefix_embeds": rng.standard_normal(
            (batch, cfg.n_prefix_tokens, cfg.d_model), np.float32)}
    return {}


def train_batch(cfg) -> dict:
    """The train step's batch: SyntheticLM's tokens and labels, with the
    frames or P prefix embeddings (and 64 - P tokens) beside them."""
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=TRAIN["seq"],
                                 global_batch=TRAIN["batch"],
                                 seed=TRAIN["seed"]))
    batch = dict(src.batch_at(0))
    batch.update(extra_inputs(cfg, TRAIN["batch"], TRAIN["input_seed"]))
    if cfg.n_prefix_tokens:
        batch["tokens"] = batch["tokens"][:, :TRAIN["seq"]
                                          - cfg.n_prefix_tokens]
    return batch


def serve_requests(cfg) -> list:
    rng = np.random.default_rng(SERVE["seed"])
    reqs = []
    for rid in range(SERVE["requests"]):
        plen = int(rng.integers(SERVE["min_len"], SERVE["max_len_prompt"] + 1))
        reqs.append(Request(rid, rng.integers(0, cfg.vocab_size, plen,
                                              dtype=np.int32),
                            max_new=SERVE["max_new"]))
    return reqs


def top2_gap(logits: np.ndarray) -> np.ndarray:
    top = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def topk_margin(probs: np.ndarray, k: int) -> np.ndarray:
    """Each row's k-th largest minus its (k+1)-th largest value."""
    top = -np.sort(-np.asarray(probs, np.float32), axis=-1)
    return top[:, k - 1] - top[:, k]


def _cast(x, dt):
    return jnp.asarray(x).astype(dt)


def _inputs(cfg, toks, extra, dt) -> dict:
    batch = {"tokens": jnp.asarray(toks)}
    batch.update({k: _cast(v, dt) for k, v in extra.items()})
    return batch


def continued_caches(cfg, caches, batch: int, window: int, dt):
    """A prefill's caches (sized to its prompt) in zeroed decode caches of
    ``window`` positions and dtype ``dt``: attention k/v (and enc-dec self
    k/v) written at the front, enc-dec cross k/v and SSM states as they
    are, each cast to the decode cache's dtype."""
    mod = encdec if cfg.is_encdec else transformer
    out = mod.init_decode_caches(cfg, batch, window, dtype=dt)

    def put(zero, got):
        got = got.astype(zero.dtype)
        if zero.shape == got.shape:
            return got
        return zero.at[:, :, :got.shape[2]].set(got)

    return jax.tree.map(put, out, caches)


def routing(cfg, params, batch) -> list:
    """The expert ids and top-k margins of every MoE layer of a jitted
    prefill, in the order the layers run (``jax.debug.callback`` out of
    ``moe._route``)."""
    if not cfg.n_experts:
        return []
    got = []
    route = moe._route

    def recording(xf, router, e_real, e_pad, k):
        gate, idx, p_mean = route(xf, router, e_real, e_pad, k)
        probs = jax.nn.softmax(xf @ router, axis=-1)
        jax.debug.callback(lambda i, p: got.append((np.asarray(i),
                                                    np.asarray(p))),
                           idx, probs, ordered=True)
        return gate, idx, p_mean

    moe._route = recording
    try:
        jax.block_until_ready(jax.jit(steps.make_prefill_step(cfg))(
            params, batch))
        jax.effects_barrier()
    finally:
        moe._route = route
    return [{"idx": idx.tolist(),
             "margin": encode(topk_margin(probs, cfg.top_k))}
            for idx, probs in got]


def serve(cfg, params) -> dict:
    srv = Server(cfg, params, max_batch=SERVE["max_batch"],
                 max_len=SERVE["max_len"])
    calls = []
    inner = srv.decode

    def recording(p, tok, caches, pos):
        nxt, logits, new = inner(p, tok, caches, pos)
        calls.append({"pos": int(pos),
                      "next": np.asarray(nxt)[:, 0].tolist(),
                      "gap": top2_gap(logits[:, -1].astype(jnp.float32))
                      .tolist()})
        return nxt, logits, new

    srv.decode = recording
    for req in serve_requests(cfg):
        srv.submit(req)
    while srv.step():
        pass
    return {"tokens": {str(r.rid): list(map(int, r.out)) for r in srv.done},
            "done_order": [r.rid for r in srv.done], "steps": srv.steps,
            "calls": calls}


def decode_from_prefill(cfg, params, toks, extra, dt) -> np.ndarray:
    """Prefill of the first HALF tokens, then teacher-forced decode of the
    rest from its caches; logits at DECODE_AT, (len(DECODE_AT), B, V)."""
    b, s = toks.shape
    p = cfg.n_prefix_tokens
    _, caches = jax.jit(steps.make_prefill_step(cfg))(
        params, _inputs(cfg, toks[:, :HALF], extra, dt))
    caches = continued_caches(cfg, caches, b, p + s, dt)
    step = jax.jit(steps.make_decode_step(cfg))
    out = []
    for t in range(HALF, s):
        _, logits, caches = step(params, jnp.asarray(toks[:, t:t + 1]),
                                 caches, jnp.int32(p + t))
        if t - HALF in DECODE_AT:
            out.append(np.asarray(logits[:, 0].astype(jnp.float32)))
    return np.stack(out)


def entry_index(size: int) -> np.ndarray:
    return np.linspace(0, size - 1, ENTRIES).round().astype(np.int64)


def sketch(g: np.ndarray, path: str) -> list:
    """experiments/train/make_reference.py's sketch of a flat leaf."""
    flat = np.asarray(g, np.float64).reshape(-1)
    rng = np.random.default_rng([SKETCH_SEED, *path.encode()])
    return [float(np.sum(rng.standard_normal(flat.size) * flat))
            / SKETCH ** 0.5 for _ in range(SKETCH)]


def _entries(a: np.ndarray) -> dict:
    flat = a.reshape(-1)
    return {"norm": float(np.linalg.norm(flat.astype(np.float64))),
            "absmax": float(np.abs(flat).max()),
            "values": flat[entry_index(flat.size)].tolist()}


def train_step(cfg, tree) -> dict:
    """One train step from the float32 master ``tree``: its metrics and
    the gradients (float32 arrays by path)."""
    batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
    params = jax.tree.map(jnp.asarray, tree)
    (loss, nll), grads = jax.jit(jax.value_and_grad(
        steps._forward_loss(cfg), has_aux=True))(params, batch)
    state = {"params": params,
             "opt": {"m": jax.tree.map(jnp.zeros_like, params),
                     "v": jax.tree.map(jnp.zeros_like, params),
                     "step": jnp.zeros((), jnp.int32)}}
    _, m = jax.jit(steps.make_train_step(cfg, AdamWConfig()))(state, batch)
    return {"step": {"loss": float(m["loss"]), "nll": float(m["nll"]),
                     "grad_norm": float(m["grad_norm"]),
                     "value_and_grad_loss": float(loss),
                     "value_and_grad_nll": float(nll)},
            "grads": {p: np.asarray(g, np.float32)
                      for p, g in _leaves(grads).items()}}


def record(arch: str) -> dict:
    base = config(arch)
    tree = conditioned_params(base)
    toks = prompt(base)
    extra = extra_inputs(base, PROMPT_SHAPE[0], INPUT_SEED)
    rec = {"specs": [[p, list(s.shape)] for p, s in
                     sorted(_leaves(steps.model_param_specs(base)).items())],
           "weights_sha256": params_sha256(tree),
           "prompt": toks.tolist()}
    trains = {}
    for name, dt in DTYPES.items():
        cfg = dataclasses.replace(base, param_dtype=name)
        params = jax.tree.map(lambda a: _cast(a, dt), tree)
        batch = _inputs(cfg, toks, extra, dt)
        logits, _ = jax.jit(steps.make_prefill_step(cfg))(params, batch)
        trains[name] = train_step(cfg, tree)
        rec[name] = {
            "prefill_logits": encode(logits[:, 0]),
            "decode_logits": encode(decode_from_prefill(cfg, params, toks,
                                                        extra, dt)),
            "routing": routing(cfg, params, batch),
            "serve": serve(cfg, params),
            "train": {"step": trains[name]["step"]},
        }
    for name in DTYPES:
        grads = {}
        for p, g in trains[name]["grads"].items():
            grads[p] = {**_entries(g), "sketch": sketch(g, p)}
            if name == "bfloat16":
                g32 = trains["float32"]["grads"][p].astype(np.float64)
                grads[p]["bf16_gap"] = float(np.sqrt(
                    np.sum((g - g32) ** 2) / np.sum(g32 ** 2)))
        rec[name]["train"]["grads"] = grads
    return rec


def header() -> dict:
    return {"seed": SEED, "prompt_seed": PROMPT_SEED,
            "prompt_shape": list(PROMPT_SHAPE), "half": HALF,
            "decode_at": list(DECODE_AT), "input_seed": INPUT_SEED,
            "serve": SERVE, "train": TRAIN, "entries": ENTRIES,
            "sketch": SKETCH, "sketch_seed": SKETCH_SEED,
            "small_leaf_std": SMALL_LEAF_STD,
            "adamw": dataclasses.asdict(dataclasses.replace(
                AdamWConfig(), moment_dtype="float32"))}


def main(path: pathlib.Path = OUT):
    out = header()
    out["configs"] = {arch: record(arch) for arch in ARCHS}
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()

"""Reference for the serving path, computed by the JAX package.

Writes ``experiments/serve/reference.json`` for gemma-2b, phi3-mini-3.8b
and qwen1.5-32b, each ``.reduced(n_layers=2)`` (between them MQA and MHA,
GeGLU and SwiGLU, tied and untied embeddings, ``embed_scale`` and q/k/v
biases). Weights come from one numpy rule that the PyTorch port
implements too (``repro_torch.models.convert.numpy_params``): the spec
leaves sorted by path string, each
``np.random.default_rng(SEED).standard_normal(shape, float32) * stddev``
from one generator in that order, stddev the spec's own for ``normal``
leaves and 0.1 for the zeros/ones-initialized norm weights and biases.
For each config the file lists every ``(path, shape)`` and the weights'
sha256, and records in float32 and in bfloat16 ``param_dtype``:

* ``prefill_logits``: the prefill step's last-token logits of a (2, 16)
  prompt;
* ``decode_logits``: teacher-forced decode logits over that prompt, (16,
  2, V), on caches of the param dtype;
* ``serve``: what ``launch.serve.Server`` serves for 6 requests (prompts
  of 4-12 tokens, ``max_new=8``, ``max_batch=4``, ``max_len=64``): each
  request's tokens, the step count, and for every decode call the
  position, the next tokens of all slots and their top-2 logit gaps.

``int8`` records the teacher-forced decode logits of gemma-2b in bfloat16
with the int8 KV cache. Arrays are float32 (bfloat16 values exactly),
little-endian, base64. It imports the JAX package only and runs on the
CPU (~1 min)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/serve/make_reference.py

The PyTorch port is held to this file by ``tests/test_torch_serve.py`` and
``chip_smoke.py`` phase 13a.
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
from repro.launch.serve import Request, Server
from repro.models import steps, transformer

OUT = pathlib.Path(__file__).resolve().parent / "reference.json"
ARCHS = ("gemma-2b", "phi3-mini-3.8b", "qwen1.5-32b")
N_LAYERS = 2
SEED = 0
PROMPT_SEED, PROMPT_SHAPE = 1, (2, 16)
SERVE = {"seed": 2, "requests": 6, "min_len": 4, "max_len_prompt": 12,
         "max_new": 8, "max_batch": 4, "max_len": 64}
INT8_ARCH = "gemma-2b"
SMALL_LEAF_STD = 0.1
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def config(arch: str, **overrides):
    return get_config(arch).reduced(n_layers=N_LAYERS, **overrides)


def _leaves(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: hasattr(x, "shape"))
    return {"/".join(k.key for k in path): s for path, s in flat}


def numpy_params(cfg, seed: int = SEED) -> dict:
    """The weight rule: a nested dict of float32 arrays (JAX layout)."""
    leaves = _leaves(transformer.param_specs(cfg))
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path in sorted(leaves):
        s = leaves[path]
        std = s.stddev() if s.init == "normal" else SMALL_LEAF_STD
        node = out
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = rng.standard_normal(s.shape, np.float32) * std
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


def teacher_forced(cfg, params, toks, cache_dtype) -> np.ndarray:
    b, s = toks.shape
    caches = transformer.init_decode_caches(cfg, b, s, dtype=cache_dtype)
    step = jax.jit(steps.make_decode_step(cfg))
    out = []
    for t in range(s):
        _, logits, caches = step(params, jnp.asarray(toks[:, t:t + 1]),
                                 caches, jnp.int32(t))
        out.append(np.asarray(logits[:, 0].astype(jnp.float32)))
    return np.stack(out)


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


def record(arch: str) -> dict:
    base = config(arch)
    tree = numpy_params(base)
    toks = prompt(base)
    rec = {"overrides": {"n_layers": N_LAYERS},
           "specs": [[p, list(s.shape)] for p, s in
                     sorted(_leaves(transformer.param_specs(base)).items())],
           "weights_sha256": params_sha256(tree),
           "prompt": toks.tolist()}
    for name, dt in DTYPES.items():
        cfg = dataclasses.replace(base, param_dtype=name)
        params = jax.tree.map(lambda a: jnp.asarray(a).astype(dt), tree)
        logits, _ = jax.jit(steps.make_prefill_step(cfg))(
            params, {"tokens": jnp.asarray(toks)})
        rec[name] = {
            "prefill_logits": encode(logits[:, 0]),
            "decode_cache_dtype": name,
            "decode_logits": encode(teacher_forced(cfg, params, toks, dt)),
            "serve": serve(cfg, params),
        }
    return rec


def main(path: pathlib.Path = OUT):
    out = {"seed": SEED, "prompt_seed": PROMPT_SEED, "serve": SERVE,
           "small_leaf_std": SMALL_LEAF_STD,
           "configs": {arch: record(arch) for arch in ARCHS}}
    cfg = config(INT8_ARCH, kv_cache_dtype="int8")
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                          numpy_params(cfg))
    out["int8"] = {"arch": INT8_ARCH, "overrides": {
        "n_layers": N_LAYERS, "kv_cache_dtype": "int8"},
        "param_dtype": "bfloat16",
        "decode_logits": encode(teacher_forced(cfg, params, prompt(cfg),
                                               jnp.bfloat16))}
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()

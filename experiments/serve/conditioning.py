"""How well-conditioned the serving path's logits are, on the port.

(A) At the reference sizes (``experiments/serve/reference.json``: three
configs cut to two layers, float32): the largest gap of the teacher-forced
decode logits between the JAX package's (the file), the port's float32
run and a float64 evaluation by the port on the same weights. (B) At
gemma-2b's full width cut in depth and vocabulary (``--layers``,
``--vocab``; ``init_params`` weights from seed 0): the std of layer 0's
attention scores, and prefill against teacher-forced decode over
``--tokens`` tokens, the last token's logits, in float32 and float64.

The float64 runs keep every product in float64 (the port's
``einsum_f32``, the JAX package's ``preferred_element_type=f32``, is
swapped for a promoting product) and the float32 RoPE angles. Run on the
CPU (~2 min, ~9 GB at the defaults) or the card::

    PYTHONPATH=src python experiments/serve/conditioning.py [--device cuda]
"""
from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import pathlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import attention, convert, flash, transformer
from repro_torch.models.common import init_params

REFERENCE = pathlib.Path(__file__).resolve().parent / "reference.json"


def _promoting(eq, *ops):
    dt = torch.float32
    for t in ops:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


def _float64_products(on: bool):
    for mod in (attention, flash):
        mod.einsum_f32 = _promoting if on else _ORIGINAL


_ORIGINAL = attention.einsum_f32


def teacher_forced(model, cfg, toks, dtype, dev):
    caches = transformer.init_decode_caches(cfg, toks.shape[0], toks.shape[1],
                                            dtype=dtype, device=dev)
    out = []
    for t in range(toks.shape[1]):
        logits, caches = model.decode_step(toks[:, t:t + 1], caches, t)
        out.append(logits[:, 0].double().cpu().numpy())
    return np.stack(out)


def part_a(dev):
    ref = json.loads(REFERENCE.read_text())
    for arch, rec in ref["configs"].items():
        cfg = dataclasses.replace(get_config(arch).reduced(**rec["overrides"]),
                                  param_dtype="float32")
        tree = convert.numpy_params(cfg, ref["seed"])
        toks = torch.tensor(rec["prompt"], device=dev)
        d = rec["float32"]["decode_logits"]
        jax32 = np.frombuffer(base64.b64decode(d["b64"]), "<f4").reshape(
            d["shape"]).astype(np.float64)
        runs = {}
        for dt in (torch.float32, torch.float64):
            _float64_products(dt == torch.float64)
            model = convert.from_jax_params(cfg, tree, dev).to(dt)
            runs[dt] = teacher_forced(model, cfg, toks, dt, dev)
        _float64_products(False)
        f64, port32 = runs[torch.float64], runs[torch.float32]
        print(f"(A) {arch}: decode logits, largest gap: JAX float32 to "
              f"float64 {np.abs(jax32 - f64).max():.3g}, port float32 to "
              f"float64 {np.abs(port32 - f64).max():.3g}, port to JAX "
              f"{np.abs(port32 - jax32).max():.3g}")


def part_b(dev, layers, vocab, tokens):
    cfg = dataclasses.replace(get_config("gemma-2b"), n_layers=layers,
                              vocab_size=vocab)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(transformer.param_specs(cfg), gen, torch.float32, dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, vocab, (1, tokens), dtype=np.int32)).to(dev)
    model = transformer.Transformer(cfg, params)
    with torch.no_grad():
        blk = model.layers[0]
        h = transformer._apply_norm(blk.norm1, model.embed_tokens(toks), cfg)
        q, k, _ = attention._project_qkv(blk.attn, h)
        s = torch.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) / cfg.head_dim ** 0.5
    print(f"(B) gemma-2b, {layers} layers, vocab {vocab}: layer 0's "
          f"attention scores std {float(s.std()):.1f}")
    last = {}
    for dt in (torch.float32, torch.float64):
        _float64_products(dt == torch.float64)
        model = transformer.Transformer(cfg, params).to(dt)
        lp, _ = model.prefill(toks)
        ld = teacher_forced(model, cfg, toks, dt, dev)[-1]
        lp = lp[:, 0].double().cpu().numpy()
        last[dt] = (lp, ld)
        print(f"(B) {dt}: prefill against teacher-forced decode over "
              f"{tokens} tokens, last-token logits {np.abs(lp - ld).max():.3g}"
              f" apart (largest |logit| {np.abs(lp).max():.3g})")
        del model
    _float64_products(False)
    (p32, d32), (p64, d64) = last[torch.float32], last[torch.float64]
    print(f"(B) float32 against float64: prefill {np.abs(p32 - p64).max():.3g},"
          f" decode {np.abs(d32 - d64).max():.3g}")


def main(argv=None):
    from repro_torch.core.analysis.wavefront import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--tokens", type=int, default=256)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    part_a(dev)
    part_b(dev, args.layers, args.vocab, args.tokens)


if __name__ == "__main__":
    main()

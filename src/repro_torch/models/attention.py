"""GQA/MQA/MHA attention with flash-style chunking and KV-cache decode.

The port of the JAX package's ``models/attention.py`` for the serving
path. Prefill never materializes (Sq, Skv) scores for the full sequence:
the query axis is processed in `q_chunk` blocks and the KV axis is swept
with an online softmax in `kv_chunk` blocks (`flash.flash_attention`;
`chunked_attention` is the position-based oracle). Scores are float32
products of the operands, P is cast to V's dtype before the PV product,
and masked scores are ``_NEG = -1e30``, as the reference computes them.

Decode runs the gathered path: the whole cache is read each step. The JAX
package's seq-sharded flash-decode (``_decode_attention_sharded``) runs
only under a sharding plan; without one it falls through to the gathered
path, and the port has no plan (``sharding/`` waits, ROADMAP Queue 1
item 3). ``cross_attention`` (the enc-dec decoder's, non-causal over the
memory's k and v from ``memory_kv``) runs the same flash. The int8 cache
is the KIVI-style per-(token, head) symmetric quantization of the
reference (``torch.round`` is round-half-to-even, as ``jnp.round`` is).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .common import Spec, apply_rope, div, einsum, einsum_f32

__all__ = ["param_specs", "self_attention", "cross_attention", "memory_kv",
           "decode_attention", "chunked_attention"]

_NEG = -1e30


def param_specs(cfg, cross: bool = False) -> Dict[str, Spec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = Spec((h, hd), ("heads", "head_dim"), init="zeros")
        specs["bk"] = Spec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        specs["bv"] = Spec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return specs


def _project_qkv(p, x, memory=None):
    """Returns q from x and k, v from memory (self-attn: memory = x)."""
    mem = x if memory is None else memory
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", mem, p["wk"])
    v = einsum("bsd,dhk->bshk", mem, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return q, k, v


def _pad_axis(x, axis, mult, value=0.0):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths, value=value)


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool,
                      prefix_len: int = 0, q_chunk: int = 1024,
                      kv_chunk: int = 1024, softcap: float = 0.0):
    """Online-softmax attention (the oracle of `flash.flash_attention`).

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D); q_pos: (Sq,), k_pos: (Skv,).
    Returns (B, Sq, H, D). H must be a multiple of KV (GQA groups).
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)

    qp = _pad_axis(q, 1, q_chunk)
    qpos = _pad_axis(q_pos, 0, q_chunk, value=-1)
    kp = _pad_axis(k, 1, kv_chunk)
    vp = _pad_axis(v, 1, kv_chunk)
    kpos = _pad_axis(k_pos, 0, kv_chunk, value=-1)

    nq = qp.shape[1] // q_chunk
    nk = kp.shape[1] // kv_chunk
    qb = qp.reshape(b, nq, q_chunk, kvh, g, d)
    outs = []
    for iq in range(nq):
        qc, qpc = qb[:, iq], qpos[iq * q_chunk:(iq + 1) * q_chunk]
        m = torch.full((b, kvh, g, q_chunk), _NEG, dtype=torch.float32,
                       device=q.device)
        lsum = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32,
                           device=q.device)
        acc = torch.zeros((b, kvh, g, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        for ik in range(nk):
            sl = slice(ik * kv_chunk, (ik + 1) * kv_chunk)
            kc, vc, kpc = kp[:, sl], vp[:, sl], kpos[sl]
            s = einsum_f32("bqhgd,bkhd->bhgqk", qc, kc) * scale
            if softcap > 0.0:
                s = softcap * torch.tanh(div(s, softcap))
            valid = (kpc >= 0)[None, None, None, None, :]
            if causal:
                ok = qpc[:, None] >= kpc[None, :]
                if prefix_len > 0:
                    ok = ok | (kpc[None, :] < prefix_len)
                valid = valid & ok[None, None, None, :, :]
            s = torch.where(valid, s, _NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + torch.sum(p, dim=-1)
            upd = einsum_f32("bhgqk,bkhd->bhgqd", p.to(vc.dtype), vc)
            acc = acc * corr[..., None] + upd
            m = m_new
        out = acc / torch.clamp_min(lsum[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))      # (B, qc, KV, g, D)
    out = torch.cat(outs, dim=1).reshape(b, nq * q_chunk, h, d)
    return out[:, :sq].to(q.dtype)


def _grouped(q, kvh):
    b, s, h, d = q.shape
    return q.reshape(b, s, kvh, h // kvh, d)


def _flash(q, k, v, *, causal, prefix_len, cfg, q_offset: int = 0):
    from .flash import flash_attention

    kvh = k.shape[2]
    out = flash_attention(
        _grouped(q, kvh), k, v,
        causal, prefix_len, cfg.q_chunk, cfg.kv_chunk, q_offset,
    )
    b, s = q.shape[:2]
    return out.reshape(b, s, q.shape[2], q.shape[3])


def self_attention(p, x, positions, cfg, *, causal=True, prefix_len=0,
                   use_rope=True):
    """x: (B, S, D), positions: (S,). Returns (out (B, S, D), (k, v))."""
    q, k, v = _project_qkv(p, x)
    if use_rope:
        q = apply_rope(q, positions[None, :], cfg.rope_theta)
        k = apply_rope(k, positions[None, :], cfg.rope_theta)
    out = _flash(q, k, v, causal=causal, prefix_len=prefix_len, cfg=cfg)
    return einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


def cross_attention(p, x, memory_kv, cfg):
    """x: (B, Sq, D); memory_kv: (k, v) precomputed from encoder output."""
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = memory_kv
    out = _flash(q, k, v, causal=False, prefix_len=0, cfg=cfg)
    return einsum("bshk,hkd->bsd", out, p["wo"])


def memory_kv(p, memory):
    k = einsum("bsd,dhk->bshk", memory, p["wk"])
    v = einsum("bsd,dhk->bshk", memory, p["wv"])
    return k, v


def _quant_token(t):
    """Symmetric int8 per-(token, head): t (B, 1, KV, D) -> (q8, scale)."""
    tf = t.float()
    amax = torch.amax(torch.abs(tf), dim=-1, keepdim=True)
    scale = torch.clamp_min(div(amax, 127.0), 1e-8)
    q8 = torch.clamp(torch.round(tf / scale), -127, 127)
    return q8.to(torch.int8), scale.to(torch.bfloat16)


def _cache_write(cache, k, v, cache_pos: int):
    """Write one token into the cache in place (bf16 and int8 layouts) and
    return it. The write offset is clamped into the cache as
    ``dynamic_update_slice`` clamps it."""
    smax = cache["k"].shape[1]
    pos = min(max(cache_pos, 0), smax - 1)
    if "k_scale" in cache:
        qk, sk = _quant_token(k)
        qv, sv = _quant_token(v)
        writes = (("k", qk), ("v", qv), ("k_scale", sk), ("v_scale", sv))
    else:
        writes = (("k", k), ("v", v))
    for name, val in writes:
        cache[name][:, pos:pos + 1] = val.to(cache[name].dtype)
    return cache


def _cache_read(cache):
    """Dequantized (k, v) views; int8 caches dequantize at the read site."""
    if "k_scale" in cache:
        k = cache["k"].to(torch.bfloat16) * cache["k_scale"]
        v = cache["v"].to(torch.bfloat16) * cache["v_scale"]
        return k, v
    return cache["k"], cache["v"]


def decode_attention(p, x, cache, cache_pos: int, cfg, *, use_rope=True,
                     update_cache=True):
    """Single-token decode. x: (B, 1, D); cache: {"k","v"[,scales]}:
    (B, Smax, KV, D), written in place at ``cache_pos``.

    cache_pos: int — current write offset (same across batch).
    Returns (out (B, 1, D), cache).
    """
    q, k, v = _project_qkv(p, x)
    if use_rope:
        pos = torch.full((1,), cache_pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos[None, :], cfg.rope_theta)
        k = apply_rope(k, pos[None, :], cfg.rope_theta)

    new_cache = _cache_write(cache, k, v, cache_pos) if update_cache else dict(cache)
    ck, cv = _cache_read(new_cache)
    b, smax, kvh, d = ck.shape
    h = q.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, d)
    s = div(einsum_f32("bqhgd,bkhd->bhgqk", qg, ck), math.sqrt(d))
    if cfg.logit_softcap > 0.0:
        s = cfg.logit_softcap * torch.tanh(div(s, cfg.logit_softcap))
    kpos = torch.arange(smax, device=x.device)
    s = torch.where((kpos <= cache_pos)[None, None, None, None, :], s, _NEG)
    w = torch.softmax(s, dim=-1)
    out = einsum("bhgqk,bkhd->bqhgd", w.to(cv.dtype), cv)
    out = out.reshape(b, 1, h, d)
    y = einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache

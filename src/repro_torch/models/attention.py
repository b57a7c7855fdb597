"""GQA/MQA/MHA attention with flash-style chunking and KV-cache decode.

The port of the JAX package's ``models/attention.py`` for the serving
path. Prefill never materializes (Sq, Skv) scores for the full sequence:
the query axis is processed in `q_chunk` blocks and the KV axis is swept
with an online softmax in `kv_chunk` blocks (`flash.flash_attention`;
`chunked_attention` is the position-based oracle). Scores are float32
products of the operands, P is cast to V's dtype before the PV product,
and masked scores are ``_NEG = -1e30``, as the reference computes them.

Decode runs the gathered path (the whole cache read each step) unless
``cfg.decode_attention == "sharded"`` and a sharding plan with a
``cache_seq_axis`` is current: then `_decode_attention_sharded` runs the
reference's seq-sharded flash-decode on this rank's slice of the cache
(FlashDecoding's split-K over the ranks of that axis: local partial
softmax, then an LSE merge by ``all_reduce(MAX)`` and ``all_reduce(SUM)``).
As in the reference, that path applies no logit softcap. ``cross_attention`` (the enc-dec decoder's, non-causal over the
memory's k and v from ``memory_kv``) runs the same flash; over a decode's
cross caches whose sequence shards over ``plan.cache_seq_axis`` its
softmax is partitioned over that axis (`_cross_attention_seq`), as
`_decode_attention_seq`'s is.

Under a plan, a model built on this rank's blocks
(``sharding.partition.serving_shardings``, the JAX serving steps'
``params_only_shardings``), and the sharded train step on the same
blocks, run the reference's partitioned program by hand. Where the heads shard over ``model`` (wq/wk/wv, bq/bk/bv and wo are
the rank's heads, the cache its kv heads) the projections, the flash and
the decode attention run on the local heads, whose group ratio is the
whole's, and wo's partial sum is reduced over ``model``
(``partition.psum_rule``; in the sequence-parallel training forward onto
the rank's block of the sequence, a reduce-scatter, and where the heads
stay whole each rank keeps the block of its whole output). Where they stay whole (one kv head) the cache
shards its sequence over ``plan.cache_seq_axis``: the default decode runs
the gathered decode's softmax partitioned over that axis as XLA
partitions it (`_decode_attention_seq`: the maximum and the sum over the
axis, the weights-times-values partial summed),
``decode_attention="sharded"`` merges partial softmaxes
(`_decode_attention_sharded`); either writes the new token only on the
rank that owns slot ``cache_pos``. The int8 cache
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


def _out_proj(out, wo, cfg, seq=None):
    """``out @ wo`` over (heads, head_dim); a rank holding a block of the
    heads reduces its partial sum over their mesh axes. ``seq`` (the
    sequence-parallel training forward's axis): the result is this rank's
    block of the sequence (``partition.psum_rule``: a reduce-scatter of the
    partial, or the block of a whole one where the heads are
    replicated)."""
    from ..sharding.partition import psum_rule, rule_of_block

    y = einsum("bshk,hkd->bsd", out, wo)
    return psum_rule(y, rule_of_block("heads", wo.shape[0], cfg.n_heads),
                     seq)


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
                   use_rope=True, seq=None):
    """x: (B, S, D), positions: (S,). Returns (out (B, S, D), (k, v));
    with ``seq`` (the sequence-parallel training forward: ``x`` the
    gathered sequence) ``out`` is this rank's block of the sequence
    (`_out_proj`)."""
    q, k, v = _project_qkv(p, x)
    if use_rope:
        q = apply_rope(q, positions[None, :], cfg.rope_theta)
        k = apply_rope(k, positions[None, :], cfg.rope_theta)
    out = _flash(q, k, v, causal=causal, prefix_len=prefix_len, cfg=cfg)
    return _out_proj(out, p["wo"], cfg, seq), (k, v)


def cross_attention(p, x, memory_kv, cfg, seq=None, kv_seq=None):
    """x: (B, Sq, D); memory_kv: (k, v) precomputed from encoder output.
    ``seq``: as `self_attention`'s (``x`` the gathered sequence, the
    output this rank's block of it). ``kv_seq``: the mesh axis whose ranks
    hold blocks of the memory's sequence (a decode's sequence-sharded
    cross caches): the flash's softmax partitioned over it
    (`_cross_attention_seq`)."""
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = memory_kv
    if kv_seq is not None:
        out = _cross_attention_seq(q, k, v, kv_seq)
    else:
        out = _flash(q, k, v, causal=False, prefix_len=0, cfg=cfg)
    return _out_proj(out, p["wo"], cfg, seq)


def _cross_attention_seq(q, k, v, ax):
    """The non-causal flash over memory k, v (B, S / n, KV, D) whose
    sequence shards over the mesh axis ``ax``, partitioned as XLA
    partitions the reference's decode where the memory is one KV chunk
    (``kv_chunk`` frames): the scores of this rank's slots, the maximum
    over the axis (`_seq_exp`), then one sum over it of the row sums and
    the float32 weights-times-values partials together; the output their
    quotient, in q's dtype. (B, Sq, H, D). A longer memory is the same
    softmax; there XLA re-cuts the blocks into the flash's chunks
    instead."""
    from ..sharding import comm
    from ..sharding.partition import current_plan

    mesh = current_plan().mesh
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    e = _seq_exp(einsum_f32("bqhgd,bkhd->bhgqk", qg, k) * (1.0 / math.sqrt(d)),
                 mesh, ax)
    both = comm.psum(torch.cat([torch.sum(e, dim=-1)[..., None],
                                einsum_f32("bhgqk,bkhd->bhgqd",
                                           e.to(v.dtype), v)], dim=-1),
                     mesh, ax)
    out = both[..., 1:] / torch.clamp_min(both[..., :1], 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _seq_exp(s, mesh, ax):
    """``exp(s - max)``, the maximum of the scores ``s`` (slots on the
    last dimension) taken over this rank's slots and then the mesh axis
    ``ax`` (``comm.pmax``): the numerators of a softmax partitioned over
    the sequence."""
    from ..sharding import comm

    return torch.exp(s - comm.pmax(torch.amax(s, dim=-1, keepdim=True),
                                   mesh, ax))


def memory_kv(p, memory):
    k = einsum("bsd,dhk->bshk", memory, p["wk"])
    v = einsum("bsd,dhk->bshk", memory, p["wv"])
    return k, v


def _decode_attention_sharded(p, q, k, v, cache, cache_pos: int, cfg, plan):
    """Distributed flash-decode: the KV cache stays SEQ-SHARDED over
    ``plan.cache_seq_axis``; every rank attends over its local slice and
    the partial (m, l, acc) softmax states merge with an LSE-weighted sum
    (``comm.pmax``, ``comm.psum``). ``cache``: this rank's block (B_c,
    Smax / n, KV, D) — its block of the batch when the batch shards —
    written in place by the rank that owns ``cache_pos`` only. q, k, v:
    this rank's stream (its block of the batch when
    ``partition.split_batch()``). No softcap (the reference has none here).
    """
    from ..sharding import comm
    from ..sharding.partition import batch_axis, rebatch, split_batch

    mesh = plan.mesh
    ax = plan.cache_seq_axis
    _, s_loc, kvh, d = cache["k"].shape
    h = q.shape[2]
    g = h // kvh
    split = split_batch()
    b = q.shape[0] * (plan.axis_size(plan.batch_axes) if split else 1)
    bax = batch_axis(plan, b) is not None
    q, k, v = (rebatch(t, plan, split, bax) for t in (q, k, v))
    bl = q.shape[0]
    start = mesh.axis_index(ax) * s_loc
    pos = int(cache_pos)
    # -- write: only the rank owning `pos` commits the new token ----------
    if start <= pos < start + s_loc:
        _cache_write(cache, k, v, pos - start)
    # -- local partial attention --------------------------------------------
    ck, cv = _cache_read(cache)
    qg = q.reshape(bl, 1, kvh, g, d)
    s = div(einsum_f32("bqhgd,bkhd->bhgqk", qg, ck), math.sqrt(d))
    kpos = start + torch.arange(s_loc, device=q.device)
    s = torch.where((kpos <= pos)[None, None, None, None, :], s, _NEG)
    m = torch.amax(s, dim=-1)                              # (B,KV,G,1)
    pexp = torch.exp(s - m[..., None])
    lsum = torch.sum(pexp, dim=-1)
    acc = einsum_f32("bhgqk,bkhd->bhgqd", pexp.to(cv.dtype), cv)
    # -- LSE merge across ranks ------------------------------------------------
    m_all = comm.pmax(m, mesh, ax)
    corr = torch.exp(m - m_all)
    # one all_reduce(SUM) carries both l * corr and acc * corr
    both = comm.psum(torch.cat([(lsum * corr)[..., None],
                                acc * corr[..., None]], dim=-1), mesh, ax)
    l_tot, acc_tot = both[..., 0], both[..., 1:]
    out = acc_tot / torch.clamp_min(l_tot[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(bl, 1, h, d).to(q.dtype)
    out = rebatch(out, plan, bax, split)
    return einsum("bshk,hkd->bsd", out, p["wo"]), cache


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


def _scores(q, ck, cache_pos: int, cfg, start: int = 0):
    """One query token's float32 scores over cache slots ``start`` on
    (B, S, KV, D), softcapped, the slots past ``cache_pos`` masked:
    (B, KV, G, 1, S)."""
    b, s_len, kvh, d = ck.shape
    qg = q.reshape(b, 1, kvh, q.shape[2] // kvh, d)
    s = div(einsum_f32("bqhgd,bkhd->bhgqk", qg, ck), math.sqrt(d))
    if cfg.logit_softcap > 0.0:
        s = cfg.logit_softcap * torch.tanh(div(s, cfg.logit_softcap))
    kpos = torch.arange(start, start + s_len, device=q.device)
    return torch.where((kpos <= cache_pos)[None, None, None, None, :], s,
                       _NEG)


def _attend(q, ck, cv, cache_pos: int, cfg):
    """One query token over a whole cache (B, Smax, KV, D): the softmax
    of `_scores`, the PV product in V's dtype. Returns (B, 1, H, D)."""
    w = torch.softmax(_scores(q, ck, cache_pos, cfg), dim=-1)
    out = einsum("bhgqk,bkhd->bqhgd", w.to(cv.dtype), cv)
    return out.reshape(q.shape[0], 1, q.shape[2], q.shape[3])


def _decode_attention_seq(p, q, k, v, cache, cache_pos: int, cfg, plan):
    """The gathered decode on a cache whose SEQUENCE shards over
    ``plan.cache_seq_axis`` (``decode_input_shardings`` where the heads
    stay whole), partitioned as XLA partitions the reference's gathered
    decode there: the rank that owns slot ``cache_pos`` writes the new
    token into its block (in place); each rank scores its slots (the
    softcap and the mask as the gathered decode's); the softmax takes the
    maximum and the sum over the axis (`_seq_exp`, then ``comm.psum``); each
    rank's weights times its values is a partial sum in V's dtype, summed
    over the axis (``partition.psum_rule``: a bf16 partial in float32, as
    XLA's CPU all-reduce promotes it). ``cache``: this rank's block
    (B, Smax / n, KV, D) of its stream's batch."""
    from ..sharding import comm
    from ..sharding.partition import psum_rule

    mesh = plan.mesh
    ax = plan.cache_seq_axis
    s_loc = cache["k"].shape[1]
    n = mesh.axis_size(ax)
    start = mesh.axis_index(ax) * s_loc
    pos = min(max(int(cache_pos), 0), s_loc * n - 1)
    if start <= pos < start + s_loc:
        _cache_write(cache, k, v, pos - start)
    ck, cv = _cache_read(cache)
    e = _seq_exp(_scores(q, ck, cache_pos, cfg, start), mesh, ax)
    w = e / comm.psum(torch.sum(e, dim=-1, keepdim=True), mesh, ax)
    out = einsum("bhgqk,bkhd->bqhgd", w.to(cv.dtype), cv)
    out = psum_rule(out, ax).reshape(q.shape[0], 1, q.shape[2], q.shape[3])
    return _out_proj(out, p["wo"], cfg), cache


def decode_attention(p, x, cache, cache_pos: int, cfg, *, use_rope=True,
                     update_cache=True):
    """Single-token decode. x: (B, 1, D); cache: {"k","v"[,scales]}:
    (B, Smax, KV, D), written in place at ``cache_pos``.

    cache_pos: int — current write offset (same across batch).
    Returns (out (B, 1, D), cache). Under a plan: see the module
    docstring (the rank's heads, or its block of the cache's sequence).
    """
    q, k, v = _project_qkv(p, x)
    if use_rope:
        pos = torch.full((1,), cache_pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos[None, :], cfg.rope_theta)
        k = apply_rope(k, pos[None, :], cfg.rope_theta)

    from ..sharding.partition import (cache_seq_sharded, current_plan,
                                      holds_blocks)

    plan = current_plan()
    if plan is not None and plan.cache_seq_axis:
        if cfg.decode_attention == "sharded":
            return _decode_attention_sharded(p, q, k, v, cache, cache_pos,
                                             cfg, plan)
        if holds_blocks() and cache_seq_sharded(cfg, plan):
            return _decode_attention_seq(p, q, k, v, cache, cache_pos,
                                         cfg, plan)
    new_cache = _cache_write(cache, k, v, cache_pos) if update_cache else dict(cache)
    ck, cv = _cache_read(new_cache)
    out = _attend(q, ck, cv, cache_pos, cfg)
    return _out_proj(out, p["wo"], cfg), new_cache

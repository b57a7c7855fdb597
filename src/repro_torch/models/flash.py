"""Flash attention: q-chunked, with an online-softmax sweep over KV chunks,
and its memory-exact backward.

The port of the JAX package's ``models/flash.py``, step for step. The
forward (`_flash_fwd`): scores in float32 from the operands (bf16 products
are exact in float32), ``_NEG = -1e30`` masking from the chunk counters
(`_block_mask`), P cast to V's dtype before the PV product, the output
divided by the clamped row sum; it keeps (q, k, v, out, lse). The backward
(`_flash_bwd`, the JAX package's ``custom_vjp`` as a
``torch.autograd.Function``): q, k, v, out and dout in float32, ``delta =
sum(dout * out)``, P recomputed chunk by chunk from ``lse`` under the same
mask, dq / dk / dv accumulated per chunk and cast back to the inputs'
dtypes; no (Sq, Skv) tensor is ever live. Float64 inputs compute in
float64 (``torch.autograd.gradcheck``); every other dtype in float32.

Layout is GQA-grouped: q (B, Sq, KV, G, D); k, v (B, Skv, KV, D).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["flash_attention"]

_NEG = -1e30


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype the scores and accumulators live in: float32, or float64
    for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _einsum(eq: str, acc: torch.dtype, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=float32)``: the product on
    operands upcast to ``acc``."""
    return torch.einsum(eq, *(t.to(acc) for t in ops))


def _pad(x, axis, mult):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def _block_mask(q0: int, k0: int, qc: int, kc: int, sq: int, skv: int,
                causal: bool, prefix_len: int, q_offset: int, device):
    """(qc, kc) validity for q rows q0..q0+qc vs kv cols k0..k0+kc."""
    qpos = q0 + torch.arange(qc, dtype=torch.int32, device=device) + q_offset
    kpos = k0 + torch.arange(kc, dtype=torch.int32, device=device)
    valid = (kpos < skv)[None, :] & ((qpos - q_offset) < sq)[:, None]
    if causal:
        ok = qpos[:, None] >= kpos[None, :]
        if prefix_len > 0:
            ok = ok | (kpos[None, :] < prefix_len)
        valid = valid & ok
    return valid


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp``: `_flash_fwd` forward, keeping its
    residuals, and `_flash_bwd` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, prefix_len, q_chunk, kv_chunk,
                q_offset):
        out, res = _flash_fwd(q, k, v, causal, prefix_len, q_chunk, kv_chunk,
                              q_offset)
        ctx.save_for_backward(*res)
        ctx.args = (causal, prefix_len, q_chunk, kv_chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.args, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, prefix_len: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    q_offset: int = 0):
    """q: (B, Sq, KV, G, D); k, v: (B, Skv, KV, D). Returns q-shaped output.

    q_offset: position of q row 0 relative to kv row 0 (0 for self-attn
    prefill; Skv - Sq for suffix queries).
    """
    return _FlashAttention.apply(q, k, v, causal, prefix_len, q_chunk,
                                 kv_chunk, q_offset)


def _flash_fwd(q, k, v, causal, prefix_len, q_chunk, kv_chunk, q_offset):
    """(out, (q, k, v, out, lse)): the residuals the backward takes."""
    b, sq, kvh, g, d = q.shape
    acc_t = _acc(q.dtype)
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)

    qp = _pad(q, 1, q_chunk)
    kp = _pad(k, 1, kv_chunk)
    vp = _pad(v, 1, kv_chunk)
    nq = qp.shape[1] // q_chunk
    nk = kp.shape[1] // kv_chunk

    outs, lses = [], []
    for iq in range(nq):
        qc = qp[:, iq * q_chunk:(iq + 1) * q_chunk]   # (B, qc, KV, G, D)
        m = torch.full((b, kvh, g, q_chunk), _NEG, dtype=acc_t,
                       device=q.device)
        lsum = torch.zeros((b, kvh, g, q_chunk), dtype=acc_t,
                           device=q.device)
        acc = torch.zeros((b, kvh, g, q_chunk, d), dtype=acc_t,
                          device=q.device)
        for ik in range(nk):
            k0 = ik * kv_chunk
            kc_ = kp[:, k0:k0 + kv_chunk]
            vc = vp[:, k0:k0 + kv_chunk]
            s = _einsum("bqhgd,bkhd->bhgqk", acc_t, qc, kc_) * scale
            ok = _block_mask(iq * q_chunk, k0, q_chunk, kv_chunk, sq, skv,
                             causal, prefix_len, q_offset, q.device)
            s = torch.where(ok[None, None, None], s, _NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + torch.sum(p, dim=-1)
            upd = _einsum("bhgqk,bkhd->bhgqd", acc_t, p.to(vc.dtype), vc)
            acc = acc * corr[..., None] + upd
            m = m_new
        o = acc / torch.clamp_min(lsum[..., None], 1e-30)
        lses.append(m + torch.log(torch.clamp_min(lsum, 1e-30)))
        outs.append(o.permute(0, 3, 1, 2, 4))        # (B, qc, KV, G, D)
    out = torch.cat(outs, dim=1)[:, :sq].to(q.dtype)
    lse = torch.cat(lses, dim=-1)[..., :sq]
    return out, (q, k, v, out, lse)


def _flash_bwd(causal, prefix_len, q_chunk, kv_chunk, q_offset, res, dout):
    """Double-chunked backward: an outer loop over q chunks (dk / dv
    accumulated over all of them, one dq chunk each), an inner loop over kv
    chunks. Live float32 buffers are O(qc x kc), never O(Sq x kc)."""
    q, k, v, out, lse = res
    b, sq, kvh, g, d = q.shape
    skv = k.shape[1]
    acc_t = _acc(q.dtype)
    scale = 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)

    qp = _pad(q, 1, q_chunk).to(acc_t)
    dop = _pad(dout, 1, q_chunk).to(acc_t)
    op = _pad(out, 1, q_chunk).to(acc_t)
    lsep = _pad(lse, 3, q_chunk)
    nq = qp.shape[1] // q_chunk
    kp = _pad(k, 1, kv_chunk).to(acc_t)
    vp = _pad(v, 1, kv_chunk).to(acc_t)
    nk = kp.shape[1] // kv_chunk

    dk = torch.zeros((b, nk * kv_chunk, kvh, d), dtype=acc_t, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for iq in range(nq):
        rows = slice(iq * q_chunk, (iq + 1) * q_chunk)
        qc, doc, oc = qp[:, rows], dop[:, rows], op[:, rows]
        lsec = lsep[..., rows]                        # (B, KV, G, qc)
        delta = torch.einsum("bqhgd,bqhgd->bhgq", doc, oc)
        dq_c = torch.zeros((b, q_chunk, kvh, g, d), dtype=acc_t,
                           device=q.device)
        for ik in range(nk):
            k0 = ik * kv_chunk
            cols = slice(k0, k0 + kv_chunk)
            kc_, vc = kp[:, cols], vp[:, cols]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc_) * scale
            ok = _block_mask(iq * q_chunk, k0, q_chunk, kv_chunk, sq, skv,
                             causal, prefix_len, q_offset, q.device)
            s = torch.where(ok[None, None, None], s, _NEG)
            p = torch.exp(s - lsec[..., None])        # (B, KV, G, qc, kc)
            dv[:, cols] += torch.einsum("bhgqk,bqhgd->bkhd", p, doc)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doc, vc)
            ds = p * (dp - delta[..., None]) * scale
            dq_c = dq_c + torch.einsum("bhgqk,bkhd->bqhgd", ds, kc_)
            dk[:, cols] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qc)
        dqs.append(dq_c)
    dq = torch.cat(dqs, dim=1)
    return (dq[:, :sq].to(q.dtype), dk[:, :skv].to(k.dtype),
            dv[:, :skv].to(v.dtype))

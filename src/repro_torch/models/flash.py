"""Flash attention, forward only: q-chunked, with an online-softmax sweep
over KV chunks.

The port of ``_flash_fwd`` of the JAX package's ``models/flash.py``, step
for step: scores in float32 from the operands (bf16 products are exact in
float32), ``_NEG = -1e30`` masking from the chunk counters
(`_block_mask`), P cast to V's dtype before the PV product, the output
divided by the clamped row sum. The custom backward waits for the training
slice (ROADMAP Queue 1 item 7), where it becomes a
``torch.autograd.Function``; until then a call that needs a gradient
raises `NotImplementedError`.

Layout is GQA-grouped: q (B, Sq, KV, G, D); k, v (B, Skv, KV, D).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import einsum_f32

__all__ = ["flash_attention"]

_NEG = -1e30


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


def flash_attention(q, k, v, causal: bool = True, prefix_len: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    q_offset: int = 0):
    """q: (B, Sq, KV, G, D); k, v: (B, Skv, KV, D). Returns q-shaped output.

    q_offset: position of q row 0 relative to kv row 0 (0 for self-attn
    prefill; Skv - Sq for suffix queries).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention's backward waits for the training slice "
            "(ROADMAP Queue 1 item 7)")
    out, _ = _flash_fwd(q, k, v, causal, prefix_len, q_chunk, kv_chunk,
                        q_offset)
    return out


def _flash_fwd(q, k, v, causal, prefix_len, q_chunk, kv_chunk, q_offset):
    """(out, (q, k, v, out, lse)): the residuals the backward will take."""
    b, sq, kvh, g, d = q.shape
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
        m = torch.full((b, kvh, g, q_chunk), _NEG, dtype=torch.float32,
                       device=q.device)
        lsum = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32,
                           device=q.device)
        acc = torch.zeros((b, kvh, g, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        for ik in range(nk):
            k0 = ik * kv_chunk
            kc_ = kp[:, k0:k0 + kv_chunk]
            vc = vp[:, k0:k0 + kv_chunk]
            s = einsum_f32("bqhgd,bkhd->bhgqk", qc, kc_) * scale
            ok = _block_mask(iq * q_chunk, k0, q_chunk, kv_chunk, sq, skv,
                             causal, prefix_len, q_offset, q.device)
            s = torch.where(ok[None, None, None], s, _NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + torch.sum(p, dim=-1)
            upd = einsum_f32("bhgqk,bkhd->bhgqd", p.to(vc.dtype), vc)
            acc = acc * corr[..., None] + upd
            m = m_new
        o = acc / torch.clamp_min(lsum[..., None], 1e-30)
        lses.append(m + torch.log(torch.clamp_min(lsum, 1e-30)))
        outs.append(o.permute(0, 3, 1, 2, 4))        # (B, qc, KV, G, D)
    out = torch.cat(outs, dim=1)[:, :sq].to(q.dtype)
    lse = torch.cat(lses, dim=-1)[..., :sq]
    return out, (q, k, v, out, lse)

"""Mamba-2 (SSD — state-space duality) mixer: chunked train/prefill scan and
O(1)-state decode.

The port of the JAX package's ``models/ssm.py``. The SSD computation
streams over sequence chunks carrying the (B, H, P, N) inter-chunk state,
so the per-chunk decay matrix L (B, H, Q, Q) is the largest live
intermediate. The reference's ``lax.scan`` over chunks is a Python loop
here; its ``jax.checkpoint(nothing_saveable)`` chunk body is
``torch.utils.checkpoint`` of each chunk while autograd records, so that
the backward keeps only the carry per chunk and recomputes L.

Decode keeps two buffers per layer: the SSM state (B, H, P, N) in float32
and the causal depthwise-conv tail (B, K-1, conv_dim) in the cache dtype.
Two quirks of the reference are kept: the prefill's conv tail is cast to
bfloat16 whatever the activations' dtype, and `init_decode_state`'s conv
buffer takes the cache dtype. ``softplus`` is ``jax.nn.softplus``'s
``logaddexp(x, 0)``, not ``F.softplus`` (which switches to ``x`` past a
threshold).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Spec, einsum, einsum_f32, rms_norm

__all__ = ["param_specs", "ssd_forward", "ssd_decode", "init_decode_state"]


def param_specs(cfg) -> Dict[str, Spec]:
    d = cfg.d_model
    di = cfg.ssm_d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.ssm_nheads
    k = cfg.ssm_conv
    conv_dim = di + 2 * g * n
    return {
        "wz": Spec((d, di), ("embed", "ssm_inner")),
        "wx": Spec((d, di), ("embed", "ssm_inner")),
        "wB": Spec((d, g * n), ("embed", None)),
        "wC": Spec((d, g * n), ("embed", None)),
        "wdt": Spec((d, h), ("embed", "ssm_heads")),
        "dt_bias": Spec((h,), ("ssm_heads",), init="zeros"),
        "A_log": Spec((h,), ("ssm_heads",), init="ones"),
        "D": Spec((h,), ("ssm_heads",), init="ones"),
        "conv_w": Spec((k, conv_dim), (None, None), scale=1.0 / math.sqrt(k)),
        "conv_b": Spec((conv_dim,), (None,), init="zeros"),
        "norm_w": Spec((di,), ("ssm_inner",), init="zeros"),
        "wo": Spec((di, d), ("ssm_inner", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` written as JAX writes it
    (``maximum`` splits the gradient of a tie, so d/dx at 0 is 1/2, the
    reference's sigmoid(0))."""
    return (torch.maximum(x, torch.zeros_like(x))
            + torch.log1p(torch.exp(-torch.abs(x))))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. xbc: (B, S, C); w: (K, C)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + pad[:, i:i + s, :].float() * w[i].float()
    out = out + b.float()
    return F.silu(out).to(xbc.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) with out[..., i, j] = sum_{j<k<=i} a[..., k],
    -inf above the diagonal (so exp() gives the lower-tri decay matrix)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(q, device=a.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, -math.inf)


def _split_proj(p, u, cfg):
    """u: (B, S, D) -> z, xbc (before the conv), dt."""
    z = einsum("bsd,de->bse", u, p["wz"])
    x = einsum("bsd,de->bse", u, p["wx"])
    Bp = einsum("bsd,de->bse", u, p["wB"])
    Cp = einsum("bsd,de->bse", u, p["wC"])
    dt = einsum("bsd,dh->bsh", u, p["wdt"])
    xbc = torch.cat([x, Bp, Cp], dim=-1)
    return z, xbc, dt


def _unpack_xbc(xbc, cfg):
    di = cfg.ssm_d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    x = xbc[..., :di]
    Bp = xbc[..., di:di + g * n]
    Cp = xbc[..., di + g * n:]
    return x, Bp, Cp


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """(b, q, g, n) -> (b, q, g * rep, n), each group repeated ``rep``
    times in place (``jnp.repeat(t, rep, axis=2)``; a view for one
    group)."""
    b, q, g, n = t.shape
    return t[:, :, :, None].expand(b, q, g, rep, n).reshape(b, q, g * rep, n)


def _chunk_step(state, xq, Bq, Cq, dtq, A, rep: int, out_dtype):
    """One chunk: (state (b, h, p, n) f32, x (b, q, h, p), B / C (b, q, g,
    n), dt (b, q, h) f32) -> (new state, y (b, q, h, p) in ``out_dtype``).

    The reference's float32 einsums as batched matmuls over (b, h) on
    float32 operands (a product of two bf16 values is exact in float32):
    scores C B^T, y_diag (scores * L) x dt, y_off (C state^T) * exp(a_cs),
    the new state's (x dt * decay_to_end) B."""
    a = dtq * A                                   # (b, q, h) log-decay
    a_t = a.permute(0, 2, 1)                      # (b, h, q)
    a_cs = torch.cumsum(a_t, dim=-1)              # (b, h, q)
    L = torch.exp(_segsum(a_t))                   # (b, h, q, q)
    Bh = _heads(Bq, rep).float().permute(0, 2, 1, 3)   # (b, h, q, n)
    Ch = _heads(Cq, rep).float().permute(0, 2, 1, 3)
    xdt = (xq.float() * dtq[..., None]).permute(0, 2, 1, 3)  # (b, h, q, p)
    # intra-chunk (diagonal block)
    scores = Ch @ Bh.transpose(-1, -2)            # (b, h, l, s)
    y_diag = (scores * L) @ xdt                   # (b, h, l, p)
    # contribution of the carried state
    y_off = (Ch @ state.transpose(-1, -2)) * torch.exp(a_cs)[..., None]
    # new chunk state
    decay_to_end = torch.exp(a_cs[..., -1:] - a_cs)  # (b, h, q)
    contrib = (xdt * decay_to_end[..., None]).transpose(-1, -2) @ Bh
    state = state * torch.exp(a_cs[..., -1])[..., None, None] + contrib
    return state, (y_diag + y_off).permute(0, 2, 1, 3).to(out_dtype)


def ssd_forward(p: Dict, u: torch.Tensor, cfg, return_state: bool = False):
    """Full-sequence SSD. u: (B, S, D) -> (B, S, D). S % min(ssm_chunk, S)
    == 0 (the caller pads nothing, as in the reference).

    return_state=True additionally returns the decode buffers
    {"ssm": (B, H, P, N), "conv": (B, K-1, conv_dim)} for serving prefill."""
    b, s, _ = u.shape
    h, pdim = cfg.ssm_nheads, cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, (s, q)

    z, xbc_raw, dt = _split_proj(p, u, cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    x, Bp, Cp = _unpack_xbc(xbc, cfg)

    A = -torch.exp(p["A_log"].float())                       # (H,)
    dt = softplus(dt.float() + p["dt_bias"].float())
    xh = x.reshape(b, s, h, pdim)
    Bh = Bp.reshape(b, s, g, n)
    Ch = Cp.reshape(b, s, g, n)
    rep = h // g

    state = torch.zeros((b, h, pdim, n), dtype=A.dtype, device=u.device)
    # checkpoint each chunk while autograd records: the backward then keeps
    # the (B, H, P, N) carry per chunk, never the (B, H, Q, Q) decay matrix
    remat = torch.is_grad_enabled()
    ys = []
    for c0 in range(0, s, q):
        sl = slice(c0, c0 + q)
        args = (state, xh[:, sl], Bh[:, sl], Ch[:, sl], dt[:, sl], A, rep,
                u.dtype)
        if remat:
            state, yq = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            state, yq = _chunk_step(*args)
        ys.append(yq)
    y = torch.cat(ys, dim=1)                                 # (b, s, h, p)
    y = y + xh.float().to(u.dtype) * p["D"].to(u.dtype)[None, None, :, None]
    y = y.reshape(b, s, h * pdim)
    y = rms_norm(y * F.silu(z.float()).to(u.dtype), p["norm_w"])
    out = einsum("bse,ed->bsd", y, p["wo"])
    if return_state:
        k = cfg.ssm_conv
        tail = (xbc_raw[:, -(k - 1):, :] if s >= k - 1
                else F.pad(xbc_raw, (0, 0, k - 1 - s, 0)))
        return out, {"ssm": state, "conv": tail.to(torch.bfloat16)}
    return out


def init_decode_state(cfg, batch: int, dtype=torch.float32,
                      device="cuda") -> Dict:
    """Zeroed decode buffers: the SSM state in float32, the conv tail in
    ``dtype``."""
    from ..core.analysis.wavefront import resolve_device

    dev = resolve_device(device)
    h, pdim, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, h, pdim, n), dtype=torch.float32,
                           device=dev),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=dev),
    }


def ssd_decode(p: Dict, u: torch.Tensor, state: Dict,
               cfg) -> Tuple[torch.Tensor, Dict]:
    """Single-token step. u: (B, 1, D) -> (y (B, 1, D), new state); the
    state passed in is not written."""
    b = u.shape[0]
    h, pdim = cfg.ssm_nheads, cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state

    z, xbc, dt = _split_proj(p, u, cfg)                  # (b, 1, *)
    # causal conv via rolling buffer
    window = torch.cat([state["conv"], xbc.to(state["conv"].dtype)], dim=1)
    conv_out = (einsum_f32("bkc,kc->bc", window, p["conv_w"])
                + p["conv_b"].float())
    xbc_t = F.silu(conv_out)[:, None, :].to(u.dtype)
    new_conv = window[:, 1:, :]

    x, Bp, Cp = _unpack_xbc(xbc_t, cfg)
    A = -torch.exp(p["A_log"].float())
    dtv = softplus(dt[:, 0].float() + p["dt_bias"].float())  # (b, h)
    dA = torch.exp(dtv * A)                               # (b, h)
    xh = x[:, 0].reshape(b, h, pdim).float()
    Bh = _heads(Bp.reshape(b, 1, g, n), h // g)[:, 0].float()
    Ch = _heads(Cp.reshape(b, 1, g, n), h // g)[:, 0].float()

    new_ssm = state["ssm"] * dA[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xh * dtv[..., None], Bh)
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, Ch)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(b, 1, h * pdim).to(u.dtype)
    y = rms_norm(y * F.silu(z.float()).to(u.dtype), p["norm_w"])
    out = einsum("bse,ed->bsd", y, p["wo"])
    return out, {"ssm": new_ssm, "conv": new_conv}

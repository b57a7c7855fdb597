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

Under a sharding plan the mixer runs on this rank's blocks, as XLA
partitions the reference under ``params_only_shardings`` /
``train_state_shardings``: ``wz``, ``wx``, ``norm_w`` and ``wo``'s rows are
its block of the inner width (``ssm_inner``), ``wdt``, ``dt_bias``,
``A_log`` and ``D`` its heads (``ssm_heads``); ``wB``, ``wC``, ``conv_w``
and ``conv_b`` are whole. The local widths come from the leaves (checked
by ``partition.rule_of_block``). The conv takes the rank's ``x`` columns
and ``B`` / ``C`` whole; each head uses its own group; the gated RMSNorm
over the whole inner width sums the squares of the rank's columns over
the ranks (a float32 ``(B, S, 1)`` ``psum``); ``wo``'s product is a
partial sum, reduced by ``partition.psum_rule`` (onto the rank's block of
the sequence in the sequence-parallel training forward). The state is
the rank's heads; the conv tail stays whole (``decode_input_shardings``),
so the prefill gathers its last K-1 rows' ``x`` columns and each decode
step the new token's.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Spec, einsum, einsum_f32

__all__ = ["param_specs", "ssd_forward", "ssd_decode", "init_decode_state",
           "sq_mean"]


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


def _share(p, cfg):
    """(heads, inner width, mesh axes, r): the rank's share of the mixer
    from its leaves, the axes that ``ssm_heads`` and ``ssm_inner`` split
    (None: whole) and its index along them."""
    from ..launch.mesh import axes_tuple
    from ..sharding.partition import current_plan, rule_of_block

    h, di = p["wdt"].shape[-1], p["wx"].shape[-1]
    hax = rule_of_block("ssm_heads", h, cfg.ssm_nheads)
    axes = rule_of_block("ssm_inner", di, cfg.ssm_d_inner)
    if di != h * cfg.ssm_headdim or (
            (hax is None) != (axes is None)
            or (axes is not None and axes_tuple(hax) != axes_tuple(axes))):
        raise ValueError(
            f"{h} heads and {di} inner columns: the SSM's heads and inner "
            f"width shard together (ssm_heads {hax!r}, ssm_inner {axes!r})")
    r = 0 if axes is None else current_plan().mesh.axis_index(axes)
    return h, di, axes, r


def _conv_cols(t: torch.Tensor, di: int, r: int, cfg) -> torch.Tensor:
    """The conv channels (last dim of ``t``, whole) of the rank's ``xbc``:
    its block ``r`` of the ``x`` columns, then ``B`` and ``C``."""
    whole = cfg.ssm_d_inner
    if di == whole:
        return t
    return torch.cat([t[..., r * di:(r + 1) * di], t[..., whole:]], dim=-1)


def _whole_x(t: torch.Tensor, di: int, axes) -> torch.Tensor:
    """``t`` (..., di + 2gn: the rank's ``x`` columns, ``B``, ``C``) with
    its ``x`` columns gathered over ``axes`` (the conv tail's channels)."""
    if axes is None:
        return t
    from ..sharding.comm import all_gather
    from ..sharding.partition import current_plan

    xs = all_gather(t[..., :di].contiguous(), current_plan().mesh, axes,
                    t.ndim - 1)
    return torch.cat([xs, t[..., di:]], dim=-1)


def _unpack_xbc(xbc, di: int, cfg):
    g, n = cfg.ssm_groups, cfg.ssm_state
    x = xbc[..., :di]
    Bp = xbc[..., di:di + g * n]
    Cp = xbc[..., di + g * n:]
    return x, Bp, Cp


def _groups(t: torch.Tensor, h: int, r: int, cfg) -> Tuple[torch.Tensor, int]:
    """(..., g * n) -> ((..., g', n), rep'): the groups of the rank's ``h``
    heads (block ``r``) and their heads per group."""
    g, n = cfg.ssm_groups, cfg.ssm_state
    rep = cfg.ssm_nheads // g
    t = t.reshape(*t.shape[:-1], g, n)
    if h == cfg.ssm_nheads:
        return t, rep
    if rep % h and h % rep:
        raise ValueError(f"a block of {h} heads splits a group of {rep}")
    g0, g1 = r * h // rep, (r * h + h - 1) // rep + 1
    return t[..., g0:g1, :], h // (g1 - g0)


def sq_mean(y: torch.Tensor, axes, cfg) -> torch.Tensor:
    """The gated RMSNorm's statistic, the float32 mean of ``y``'s squares
    over the whole inner width: over the rank's columns summed over
    ``axes`` (a ``(B, S, 1)`` ``psum``) where ``y`` is its block."""
    yf = y.float()
    if axes is None:
        return torch.mean(yf * yf, dim=-1, keepdim=True)
    from ..sharding.comm import psum
    from ..sharding.partition import current_plan
    from .common import div

    ss = psum(torch.sum(yf * yf, dim=-1, keepdim=True), current_plan().mesh,
              axes)
    return div(ss, float(cfg.ssm_d_inner))


def _gated_norm(y, z, w, axes, cfg, eps: float = 1e-6):
    """``rms_norm(y * silu(z), w)`` over the whole inner width (its
    operations, with the statistic of `sq_mean`)."""
    g = y * F.silu(z.float()).to(y.dtype)
    out = g.float() * torch.rsqrt(sq_mean(g, axes, cfg) + eps)
    return (out * (1.0 + w.float())).to(g.dtype)


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


def ssd_forward(p: Dict, u: torch.Tensor, cfg, return_state: bool = False,
                seq=None):
    """Full-sequence SSD. u: (B, S, D) -> (B, S, D). S % min(ssm_chunk, S)
    == 0 (the caller pads nothing, as in the reference).

    return_state=True additionally returns the decode buffers
    {"ssm": (B, H, P, N), "conv": (B, K-1, conv_dim)} for serving prefill
    (on blocks: the rank's heads, the tail whole). ``seq`` (the
    sequence-parallel training forward's axis, ``u`` the gathered
    sequence): the output is this rank's block of the sequence."""
    from ..sharding.partition import psum_rule

    b, s, _ = u.shape
    h, di, axes, r = _share(p, cfg)
    pdim = cfg.ssm_headdim
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, (s, q)

    z, xbc_raw, dt = _split_proj(p, u, cfg)
    xbc = _causal_conv(xbc_raw, _conv_cols(p["conv_w"], di, r, cfg),
                       _conv_cols(p["conv_b"], di, r, cfg))
    x, Bp, Cp = _unpack_xbc(xbc, di, cfg)

    A = -torch.exp(p["A_log"].float())                       # (H,)
    dt = softplus(dt.float() + p["dt_bias"].float())
    xh = x.reshape(b, s, h, pdim)
    Bh, rep = _groups(Bp, h, r, cfg)
    Ch, _ = _groups(Cp, h, r, cfg)

    state = torch.zeros((b, h, pdim, Bh.shape[-1]), dtype=A.dtype,
                        device=u.device)
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
    y = _gated_norm(y.reshape(b, s, h * pdim), z, p["norm_w"], axes, cfg)
    out = psum_rule(einsum("bse,ed->bsd", y, p["wo"]), axes, seq)
    if return_state:
        k = cfg.ssm_conv
        tail = (xbc_raw[:, -(k - 1):, :] if s >= k - 1
                else F.pad(xbc_raw, (0, 0, k - 1 - s, 0)))
        return out, {"ssm": state,
                     "conv": _whole_x(tail.to(torch.bfloat16), di, axes)}
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
    state passed in is not written (on blocks: the rank's heads of the
    SSM state, the conv tail whole)."""
    from ..sharding.partition import psum_rule

    b = u.shape[0]
    h, di, axes, r = _share(p, cfg)
    pdim = cfg.ssm_headdim

    z, xbc, dt = _split_proj(p, u, cfg)                  # (b, 1, *)
    # causal conv via rolling buffer
    window = torch.cat([state["conv"],
                        _whole_x(xbc.to(state["conv"].dtype), di, axes)],
                       dim=1)
    conv_out = (einsum_f32("bkc,kc->bc", _conv_cols(window, di, r, cfg),
                           _conv_cols(p["conv_w"], di, r, cfg))
                + _conv_cols(p["conv_b"], di, r, cfg).float())
    xbc_t = F.silu(conv_out)[:, None, :].to(u.dtype)
    new_conv = window[:, 1:, :]

    x, Bp, Cp = _unpack_xbc(xbc_t, di, cfg)
    A = -torch.exp(p["A_log"].float())
    dtv = softplus(dt[:, 0].float() + p["dt_bias"].float())  # (b, h)
    dA = torch.exp(dtv * A)                               # (b, h)
    xh = x[:, 0].reshape(b, h, pdim).float()
    Bg, rep = _groups(Bp, h, r, cfg)
    Cg, _ = _groups(Cp, h, r, cfg)
    Bh = _heads(Bg, rep)[:, 0].float()
    Ch = _heads(Cg, rep)[:, 0].float()

    new_ssm = state["ssm"] * dA[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xh * dtv[..., None], Bh)
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, Ch)
    y = y + xh * p["D"].float()[None, :, None]
    y = _gated_norm(y.reshape(b, 1, h * pdim).to(u.dtype), z, p["norm_w"],
                    axes, cfg)
    out = psum_rule(einsum("bse,ed->bsd", y, p["wo"]), axes)
    return out, {"ssm": new_ssm, "conv": new_conv}

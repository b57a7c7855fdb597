"""Token-choice top-k MoE, the local path.

The port of the JAX package's ``models/moe.py`` without its expert-parallel
``_moe_ep`` (ROADMAP Queue 1 item 3): the port has no sharding plan, so
`moe` always takes the single-device path, `_moe_local`, as the JAX
package does without a plan.

Routing runs in float32: softmax over the experts, top-k by a stable
descending sort (``jax.lax.top_k`` ranks equal probabilities by the lower
expert index, which ``torch.topk`` does not promise), gates renormalized
over the k. Dispatch is sort-based, as in the reference: a stable argsort
of the (T*k,) expert ids gives each slot its queue position; slots past
the capacity ``C = round8(T * k * capacity_factor / E)`` drop through the
residual. The scatter into the (E*C, D) buffer has one extra row that the
dropped slots land in (``index_add`` has no ``mode="drop"``) and which is
sliced off; each kept row receives exactly one token, so the buffer is the
reference's bit for bit. The expert FFN is three batched products, the
combine a sum of the k gated outputs in the activation dtype (accumulated
in float32, as XLA's bf16 reduction is). The Switch aux loss ``E * sum(f_e
* p_e)`` is float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import Spec, div, einsum

__all__ = ["param_specs", "moe", "capacity"]


def param_specs(cfg) -> Dict[str, Spec]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    return {
        "router": Spec((d, e), ("embed", "experts"), scale=0.02),
        "wi": Spec((e, d, f), ("experts", "embed", "mlp")),
        "wg": Spec((e, d, f), ("experts", "embed", "mlp")),
        "wo": Spec((e, f, d), ("experts", "mlp", "embed")),
    }


def capacity(local_tokens: int, n_experts: int, cfg) -> int:
    c = int(local_tokens * cfg.top_k * cfg.capacity_factor / max(n_experts, 1))
    return max(8, ((c + 7) // 8) * 8)


def _route(xf, router, k: int):
    """Router in f32. Returns gate (T,k), idx (T,k), probs_mean (E,)."""
    probs = torch.softmax(xf @ router, dim=-1)             # (T, E)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return gate, idx, probs.mean(0)


def _positions(idx_f: torch.Tensor, e: int, cap: int):
    """Sort-based queue positions (no (T, E) one-hot cumsum).

    idx_f: (T, k) -> flat slot index (T*k,) into an (e * cap) buffer,
    ``e * cap`` for dropped slots; the kept mask; per-expert counts (e,)
    in float32."""
    t, k = idx_f.shape
    flat_e = idx_f.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(e, dtype=sorted_e.dtype, device=idx_f.device)
    starts = torch.searchsorted(sorted_e, experts, side="left")
    ends = torch.searchsorted(sorted_e, experts, side="right")
    pos_sorted = torch.arange(t * k, device=idx_f.device) - starts[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    keep = pos < cap
    flat = torch.where(keep, flat_e * cap + pos, e * cap)
    return flat, keep, (ends - starts).float()


def _expert_ffn(buf, wi, wg, wo):
    """buf: (E_loc, C', D); weights (E_loc, D, F) / (E_loc, F, D)."""
    h = einsum("ecd,edf->ecf", buf, wi)
    g = F.silu(einsum("ecd,edf->ecf", buf, wg))
    return einsum("ecf,efd->ecd", h * g, wo)


def _moe_local(x2, router, wi, wg, wo, cfg):
    """Single-device path: x2 (T, D) -> (T, D), aux. (The reference's
    padding to ``e_pad`` experts serves only its expert-parallel path.)"""
    t, d = x2.shape
    e, k = cfg.n_experts, cfg.top_k
    gate, idx, p_mean = _route(x2.float(), router.float(), k)
    cap = capacity(t, e, cfg)
    flat, keep, counts = _positions(idx, e, cap)
    aux = e * torch.sum(div(counts, float(t * k)) * p_mean)

    xk = x2[:, None].expand(t, k, d).reshape(t * k, d)
    # one spare row takes the dropped slots (the reference's mode="drop")
    buf = torch.zeros((e * cap + 1, d), dtype=x2.dtype, device=x2.device)
    buf = buf.index_add(0, flat, xk)[:-1]
    y = _expert_ffn(buf.reshape(e, cap, d), wi, wg, wo)
    y_flat = y.reshape(e * cap, d)
    safe = torch.clamp_max(flat, e * cap - 1)
    yk = y_flat[safe] * (gate.reshape(t * k, 1) * keep[:, None]).to(x2.dtype)
    out = yk.reshape(t, k, d).sum(1)
    return out, aux.float()


def moe(p: Dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    b, s, d = x.shape
    out2, aux = _moe_local(x.reshape(b * s, d), p["router"], p["wi"],
                           p["wg"], p["wo"], cfg)
    return out2.reshape(b, s, d), aux

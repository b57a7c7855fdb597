"""Token-choice top-k MoE: the local path and the expert-parallel path.

The port of the JAX package's ``models/moe.py``. `moe` takes the
expert-parallel path, `_moe_ep`, exactly when the JAX package does: under
a sharding plan (``sharding.partition.activation_ctx``) whose mesh has
``model > 1``. There the GShard pipeline is explicit, as in the
reference's ``shard_map``: per-rank local dispatch, one ``all_to_all``
over ``model`` to the experts' owners, the local expert FFN, the reverse
``all_to_all``, the local combine (``sharding.comm``'s collectives, their
gradients the exact adjoints). Experts that do not divide the EP axis are
padded to the next multiple with router-masked dummy experts. Capacity is
per local shard, ``C = round8(local_tokens * top_k * cf / E_pad)``, so EP
drops other tokens than the local path does; the aux loss is averaged over
the EP axis and then the batch axes. Without a plan (or with ``model ==
1``) `_moe_local` runs, on the whole batch: a rank whose activations are
its block of the batch gathers the batch first, as the reference's
single program sees it.

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


def _route(xf, router, k: int, e_pad: int = 0):
    """Router in f32. Returns gate (T,k), idx (T,k), probs_mean (E_pad,);
    the logits of experts past the router's (padding) are -1e30."""
    logits = xf @ router                                   # (T, E)
    if e_pad > logits.shape[-1]:
        logits = F.pad(logits, (0, e_pad - logits.shape[-1]), value=-1e30)
    probs = torch.softmax(logits, dim=-1)
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


def _pad_experts(w, e_pad: int):
    return F.pad(w, (0, 0, 0, 0, 0, e_pad - w.shape[0])) if e_pad > w.shape[0] else w


def _moe_ep(x, router, wi, wg, wo, cfg, plan, need_aux: bool = True,
            seq=None):
    """Expert-parallel MoE on this rank (the reference's ``shard_map`` body
    and its in/out specs). x: this rank's (B_loc, S, D) activations, its
    block of the batch when ``partition.split_batch()``, else the whole
    batch; router whole; wi / wg / wo whole, or this rank's block of the
    experts over ``model`` when the plan shards experts (their d_model
    whole). ``seq`` (the sequence-parallel training forward's axis,
    ``model``): ``x`` already is this rank's block of the sequence, the
    ``seq_split`` tokens, as the ``shard_map``'s in-spec carries the split;
    the output stays that block. Returns (out like x, aux on every
    rank)."""
    from ..sharding import comm
    from ..sharding.partition import batch_axis, rebatch, split_batch

    mesh = plan.mesh
    ep_axis = "model"
    ep = mesh.shape[ep_axis]
    split = split_batch()
    b_loc, s, d = x.shape
    if seq is not None:
        if seq != ep_axis:
            raise ValueError(f"a sequence block over {seq!r}: the expert "
                             f"exchange splits the sequence over "
                             f"{ep_axis!r}")
        s = s * ep
    b = b_loc * plan.axis_size(plan.batch_axes) if split else b_loc
    e, k = cfg.n_experts, cfg.top_k
    e_pad = ((e + ep - 1) // ep) * ep
    e_loc = e_pad // ep
    dp = plan.batch_axes or None
    if dp is not None and batch_axis(plan, b) is None:
        dp = None  # tiny batches (long_500k) stay replicated over data
    experts_sharded = (e % ep == 0) and plan.rules.get("experts") == ep_axis
    # FSDP-local expert compute for few-token calls (decode): each rank
    # contracts its d_model slice of the expert weights and the (tiny)
    # per-slot pre-activations are summed over the FSDP axis
    fsdp_ax = plan.rules.get("embed")
    few_tokens = (b * s) <= 4096
    fsdp_local = bool(
        fsdp_ax and experts_sharded and few_tokens
        and d % plan.axis_size(fsdp_ax) == 0
    )
    if fsdp_local:
        # every rank of the FSDP axis sees ALL tokens (weight-stationary)
        dp = None
    seq_split = s % ep == 0 and s >= ep
    midx = mesh.axis_index(ep_axis)

    xl = rebatch(x, plan, split, dp is not None)
    s_loc = s // ep if seq_split else s
    if seq_split and seq is None:
        xl = xl[:, midx * s_loc:(midx + 1) * s_loc]
    bl = xl.shape[0]
    t_loc = bl * s_loc
    x2 = xl.reshape(t_loc, d)
    gate, idx, p_mean = _route(x2.float(), router.float(), k, e_pad)
    cap = capacity(t_loc, e_pad, cfg)
    flat, keep, counts = _positions(idx, e_pad, cap)
    if need_aux:
        # global aux: average across every shard
        f_e = comm.pmean(div(counts, float(t_loc * k)), mesh, ep_axis)
        f_e = comm.pmean(f_e, mesh, dp) if dp else f_e
        p_m = comm.pmean(p_mean, mesh, ep_axis)
        p_m = comm.pmean(p_m, mesh, dp) if dp else p_m
        aux = e * torch.sum(f_e * p_m)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=xl.device)

    xk = x2[:, None].expand(t_loc, k, d).reshape(t_loc * k, d)
    buf = torch.zeros((e_pad * cap + 1, d), dtype=xl.dtype, device=xl.device)
    buf = buf.index_add(0, flat, xk)[:-1].reshape(ep, e_loc, cap, d)
    # EP exchange: every rank receives the slots of ITS experts
    recv = comm.all_to_all(buf, mesh, ep_axis, 0, 2)   # (1, e_loc, ep*C, D)
    recv = recv.reshape(e_loc, ep * cap, d)

    def own(w):
        """This rank's experts of ``w`` (padded to ``e_pad`` first)."""
        if w.shape[0] == e_loc and experts_sharded:
            return w
        return _pad_experts(w, e_pad)[midx * e_loc:(midx + 1) * e_loc]

    wi_e, wg_e, wo_e = own(wi), own(wg), own(wo)
    if fsdp_local:
        dsz = plan.axis_size(fsdp_ax)
        dl = d // dsz
        d0 = mesh.axis_index(fsdp_ax) * dl
        recv_l = recv[:, :, d0:d0 + dl]
        h = comm.psum(einsum("ecd,edf->ecf", recv_l, wi_e[:, d0:d0 + dl]),
                      mesh, fsdp_ax)
        gpre = comm.psum(einsum("ecd,edf->ecf", recv_l, wg_e[:, d0:d0 + dl]),
                         mesh, fsdp_ax)
        y_l = einsum("ecf,efd->ecd", h * F.silu(gpre), wo_e[:, :, d0:d0 + dl])
        y = comm.all_gather(y_l, mesh, fsdp_ax, 2)
    else:
        y = _expert_ffn(recv, wi_e, wg_e, wo_e)          # (e_loc, ep*C, D)
    y = y.reshape(1, e_loc, ep * cap, d)
    back = comm.all_to_all(y, mesh, ep_axis, 2, 0)      # (ep, e_loc, C, D)
    y_flat = back.reshape(e_pad * cap, d)
    safe = torch.clamp_max(flat, e_pad * cap - 1)
    yk = y_flat[safe] * (gate.reshape(t_loc * k, 1) * keep[:, None]).to(xl.dtype)
    out = yk.reshape(t_loc, k, d).sum(1).reshape(bl, s_loc, d)
    if seq_split and seq is None:
        out = comm.all_gather(out, mesh, ep_axis, 1)
    return rebatch(out, plan, dp is not None, split), aux.float()


def moe(p: Dict, x: torch.Tensor, cfg, need_aux: bool = True,
        seq=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar). Under a plan with
    ``model > 1``, `_moe_ep` on ``p``'s experts: whole, or this rank's
    block of them over ``model`` (a model served or trained on its blocks;
    the router whole). ``seq``: ``x`` is this rank's block of the
    sequence over that axis (`_moe_ep`)."""
    from ..sharding.partition import current_plan, rebatch, split_batch

    plan = current_plan()
    if plan is not None and plan.mesh.shape.get("model", 1) > 1:
        return _moe_ep(x, p["router"], p["wi"], p["wg"], p["wo"], cfg, plan,
                       need_aux, seq)
    split = plan is not None and split_batch()
    if split:
        x = rebatch(x, plan, True, False)
    b, s, d = x.shape
    out2, aux = _moe_local(x.reshape(b * s, d), p["router"], p["wi"],
                           p["wg"], p["wo"], cfg)
    out = out2.reshape(b, s, d)
    return (rebatch(out, plan, False, True) if split else out), aux

"""Decoder-only LM assembly: dense / MoE / SSM / hybrid, one code path,
for serving and training.

The port of the JAX package's ``models/transformer.py``. The layer stack is
the smallest repeating layer pattern (`cfg.layer_groups()`), run
``repeats`` times; each pattern element ``l{i}`` is (mixer, ffn) with mixer
in {attn, ssm} and ffn in {mlp, moe, none}. Parameters keep the JAX einsum
layouts (``wq (d, h, hd)``, ``wo (h, hd, d)``, ``embed (V, d)``,
``lm_head (d, V)``, ``layers/l{i}/moe/wi (R, E, d, f)``) in a nested dict
with each pattern element's layers stacked on a leading axis, so carrying
weights across (``models.convert``) is a copy. The layers run in the
reference's order: repeat by repeat, the pattern unrolled inside.

One layer's computation is `layer_forward`, a function of that layer's
parameter dict (its keys name its kind); the serving `Transformer` and the
training `forward` both call it. ``prefix_embeds`` (PaliGemma's image
stub, (B, P, D)) are cast to the activations' dtype and put in front of
the scaled token embeddings; self-attention is bidirectional over them
(``prefix_len``), and the hidden states cover all P + S positions.

Training (functions of a parameter tree, differentiable):
  forward(params, tokens, cfg)       — hidden states and the summed MoE
                                       aux; per-layer remat
                                       (``cfg.remat``: full | dots | none)
  lm_loss(params, hidden, labels, cfg) — sequence-chunked cross entropy
  logits_from_hidden, embed_tokens   — the vocab projection and the lookup
Serving (methods of `Transformer`, frozen parameters, no autograd):
  forward(tokens)                    — hidden states (prefill; no remat)
  prefill(tokens)                    — last-token logits + decode caches
  decode_step(token, caches, pos)    — single-token step over the caches
and `init_decode_caches`: per pattern element ``l{i}``, stacked over the
repeats, attention k/v (bf16, or int8 with bf16 per-(token, head) scales)
or the SSM state ``{"ssm" (float32), "conv" (the cache dtype)}``.
`decode_step` writes them in place and returns them; `prefill` returns
them sized to the prompt (k/v in bf16, the SSM states as ``ssm.ssd_forward``
leaves them). Decode logits are never softcapped: as in the reference,
only the decode scores are (``attention.decode_attention``). MoE layers
drop their aux loss in decode and prefill.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention, mlp, moe, ssm
from .common import Spec, div, einsum, layer_norm, rms_norm, tree_map

__all__ = [
    "param_specs", "init_decode_caches", "layer_forward",
    "embed_tokens", "logits_from_hidden", "forward", "lm_loss", "Transformer",
]


# -- parameter specs ---------------------------------------------------------

def _norm_specs(cfg, stacked: int) -> Dict[str, Spec]:
    d = cfg.d_model
    if cfg.norm == "rms":
        return {"w": Spec((stacked, d), ("layers", "embed"), init="zeros")}
    return {
        "w": Spec((stacked, d), ("layers", "embed"), init="ones"),
        "b": Spec((stacked, d), ("layers", "embed"), init="zeros"),
    }


def _stack(specs: Any, r: int) -> Any:
    return tree_map(
        lambda s: Spec((r,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        specs)


def _layer_specs(cfg, mixer: str, ffn: str, r: int) -> Dict:
    out: Dict[str, Any] = {"norm1": _norm_specs(cfg, r)}
    if mixer == "attn":
        out["attn"] = _stack(attention.param_specs(cfg), r)
    elif mixer == "ssm":
        out["ssm"] = _stack(ssm.param_specs(cfg), r)
    else:
        raise ValueError(mixer)
    if ffn != "none":
        out["norm2"] = _norm_specs(cfg, r)
        if ffn == "moe":
            out["moe"] = _stack(moe.param_specs(cfg), r)
        else:
            out["mlp"] = _stack(mlp.param_specs(cfg), r)
    return out


def param_specs(cfg) -> Dict:
    d, v = cfg.d_model, cfg.padded_vocab
    (pattern, repeats), = cfg.layer_groups()
    specs: Dict[str, Any] = {
        "embed": Spec((v, d), ("vocab", "embed"), scale=0.02),
        "layers": {
            f"l{i}": _layer_specs(cfg, mx, ff, repeats)
            for i, (mx, ff) in enumerate(pattern)
        },
        "final_norm": tree_map(
            lambda s: Spec(s.shape[1:], s.axes[1:], s.init, s.scale),
            _norm_specs(cfg, 1)),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((d, v), ("embed", "vocab"), scale=0.02)
    return specs


def _apply_norm(np_, x, cfg):
    if cfg.norm == "rms":
        return rms_norm(x, np_["w"])
    return layer_norm(x, np_["w"], np_["b"])


# -- decode caches -------------------------------------------------------------

def init_decode_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                       device="cuda") -> Dict:
    """Zeroed decode caches, one entry per pattern element ``l{i}``
    stacked over the repeats: bf16 (or ``dtype``) k/v, or, with
    ``kv_cache_dtype="int8"``, int8 k/v and bf16 per-(token, head) scales;
    an SSM layer's ``{"ssm" float32, "conv" dtype}``."""
    from ..core.analysis.wavefront import resolve_device

    dev = resolve_device(device)
    (pattern, repeats), = cfg.layer_groups()
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (repeats, batch, max_len, kv, hd)
    caches: Dict[str, Any] = {}
    for i, (mixer, _ffn) in enumerate(pattern):
        if mixer == "ssm":
            st = ssm.init_decode_state(cfg, batch, dtype, dev)
            caches[f"l{i}"] = {k: t[None].repeat(repeats, *([1] * t.ndim))
                               for k, t in st.items()}
        elif cfg.kv_cache_dtype == "int8":
            scale = (repeats, batch, max_len, kv, 1)
            i8, bf16 = torch.int8, torch.bfloat16
            caches[f"l{i}"] = {
                "k": torch.zeros(shape, dtype=i8, device=dev),
                "v": torch.zeros(shape, dtype=i8, device=dev),
                "k_scale": torch.zeros(scale, dtype=bf16, device=dev),
                "v_scale": torch.zeros(scale, dtype=bf16, device=dev),
            }
        else:
            caches[f"l{i}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return caches


# -- one layer, and the training forward ---------------------------------------

def layer_forward(lp: Dict, x: torch.Tensor, positions: torch.Tensor, cfg,
                  prefix_len: int = 0):
    """One layer over its parameter dict ``lp``, whose keys name its kind:
    ``norm1`` and ``attn`` or ``ssm``, then ``norm2`` and ``mlp`` or
    ``moe`` (or neither). Returns (x, aux, cache): the MoE aux loss (0
    otherwise), and attention's (k, v) or the SSM's decode state."""
    h = _apply_norm(lp["norm1"], x, cfg)
    if "attn" in lp:
        y, cache = attention.self_attention(lp["attn"], h, positions, cfg,
                                            causal=True,
                                            prefix_len=prefix_len)
    else:
        y, cache = ssm.ssd_forward(lp["ssm"], h, cfg, return_state=True)
    x, aux = _ffn(lp, x + y, cfg)
    return x, aux, cache


def _ffn(lp: Dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's second half (``norm2`` and ``mlp`` or ``moe``, or
    nothing): (x, the MoE aux loss or 0)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "norm2" in lp:
        h2 = _apply_norm(lp["norm2"], x, cfg)
        if "moe" in lp:
            y2, aux = moe.moe(lp["moe"], h2, cfg)
        else:
            y2 = mlp.mlp(lp["mlp"], h2, cfg)
        x = x + y2
    return x, aux


def _layer(lp, x, positions, cfg, prefix_len):
    return layer_forward(lp, x, positions, cfg, prefix_len)[:2]


def _saves_dots(ctx, op, *args, **kwargs):
    """The JAX package's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of products without batch dimensions (the projections and the
    MLP; einsum lowers them to ``mm``, or ``bmm`` over a batch of one),
    recompute the rest."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_saves_dots)


def _remat(fn, cfg, *args):
    """``fn(*args)`` under ``cfg.remat``: ``"full"`` recomputes it in the
    backward (``torch.utils.checkpoint``), ``"dots"`` keeps its products'
    outputs (selective checkpointing), ``"none"`` keeps everything; the
    numbers are the same. Without autograd it is a plain call."""
    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"remat={cfg.remat!r}: full, dots or none")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      **({"context_fn": _dots_context}
                         if cfg.remat == "dots" else {}))


def _unbind_layers(stacked: Dict) -> List[Dict]:
    """The per-layer dicts of a stacked layer tree, from one ``unbind`` of
    each leaf (whose backward is one ``stack``; indexing each layer would
    write a zero-filled stacked gradient per layer)."""
    split = {name: {k: t.unbind(0) for k, t in sub.items()}
             for name, sub in stacked.items()}
    n = len(next(iter(split["norm1"].values())))
    return [{name: {k: ts[i] for k, ts in sub.items()}
             for name, sub in split.items()} for i in range(n)]


def embed_tokens(params: Dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:
        # the factor is cast to the activations' dtype first
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return x


def logits_from_hidden(params: Dict, h: torch.Tensor, cfg) -> torch.Tensor:
    """The tied or untied vocab projection, in the operands' promoted
    dtype (``jnp.einsum``'s)."""
    if cfg.tie_embeddings:
        return einsum("...d,vd->...v", h, params["embed"])
    return einsum("...d,dv->...v", h, params["lm_head"])


def _with_prefix(x: torch.Tensor, prefix_embeds) -> Tuple[torch.Tensor, int]:
    if prefix_embeds is None:
        return x, 0
    return (torch.cat([prefix_embeds.to(x.dtype), x], dim=1),
            prefix_embeds.shape[1])


def forward(params: Dict, tokens: torch.Tensor, cfg, *,
            prefix_embeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward over a parameter tree (``param_specs``'
    layout, in the compute dtype). tokens: (B, S) -> (hidden (B, P + S,
    D), moe_aux scalar), ``prefix_embeds`` (B, P, D) in front. Each layer
    runs under ``cfg.remat`` (`_remat`). The aux sums each repeat's
    pattern, then the repeats."""
    x, prefix_len = _with_prefix(embed_tokens(params, tokens, cfg),
                                 prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    (pattern, repeats), = cfg.layer_groups()
    layers = [_unbind_layers(params["layers"][f"l{i}"])
              for i in range(len(pattern))]
    auxs = []
    for r in range(repeats):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for per_layer in layers:
            x, a = _remat(_layer, cfg, per_layer[r], x, positions, cfg,
                          prefix_len)
            aux = aux + a
        auxs.append(aux)
    x = _apply_norm(params["final_norm"], x, cfg)
    return x, torch.sum(torch.stack(auxs))


def _loss_chunk(params, hc, yc, cfg):
    """(sum of the chunk's token losses, its token count), float32."""
    logits = logits_from_hidden(params, hc, cfg).float()
    if cfg.logit_softcap > 0.0:
        logits = cfg.logit_softcap * torch.tanh(div(logits, cfg.logit_softcap))
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp(yc, 0, cfg.padded_vocab - 1).long()
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    m = (yc >= 0).float()
    return torch.sum((lse - ll) * m), torch.sum(m)


def lm_loss(params: Dict, hidden: torch.Tensor, labels: torch.Tensor, cfg,
            moe_aux=0.0, aux_weight: float = 0.01):
    """Chunked-vocab cross entropy. labels: (B, S) int, -1 = ignore.
    Returns (nll + aux_weight * moe_aux, nll).

    Chunks along the sequence (``c_s = max(1, min(S, loss_chunk // B))``
    positions, labels padded with -1), each chunk's logits computed under
    ``torch.utils.checkpoint``: the (B, S, V) float32 logits never exist at
    once, a chunk's are recomputed in the backward.
    """
    b, s, _d = hidden.shape
    c_s = max(1, min(s, cfg.loss_chunk // max(b, 1)))
    pad = (-s) % c_s
    h, y = hidden, labels
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        y = F.pad(y, (0, pad), value=-1)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    tok_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, h.shape[1], c_s):
        ls, ts = checkpoint(_loss_chunk, params, h[:, c0:c0 + c_s],
                            y[:, c0:c0 + c_s], cfg, use_reentrant=False)
        loss_sum = loss_sum + ls
        tok_sum = tok_sum + ts
    nll = loss_sum / torch.clamp_min(tok_sum, 1.0)
    return nll + aux_weight * moe_aux, nll


# -- the serving model ---------------------------------------------------------

def _frozen(tree: Dict) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(t, requires_grad=False) for k, t in tree.items()})


class Block(nn.Module):
    """One layer: its slice of its pattern element's stacked JAX leaves."""

    def __init__(self, layer: Dict, r: int):
        super().__init__()
        self.names = tuple(layer)
        for name in self.names:
            setattr(self, name,
                    _frozen({k: t[r] for k, t in layer[name].items()}))

    def params(self) -> Dict:
        return {name: getattr(self, name) for name in self.names}

    def forward(self, x, positions, cfg, prefix_len=0):
        return layer_forward(self.params(), x, positions, cfg, prefix_len)

    def decode(self, x, cache, cache_pos, cfg):
        """One token through the layer; ``cache`` (this layer's views of
        the stacked caches) is written in place."""
        h = _apply_norm(self.norm1, x, cfg)
        if "attn" in self.names:
            y, _ = attention.decode_attention(self.attn, h, cache, cache_pos,
                                              cfg)
        else:
            y, new = ssm.ssd_decode(self.ssm, h, cache, cfg)
            for k, t in new.items():
                cache[k].copy_(t)
        return _ffn(self.params(), x + y, cfg)[0]


class Transformer(nn.Module):
    """The decoder-only LM over a parameter tree in the JAX layout
    (``param_specs``' nested dict of tensors, each pattern element's layers
    stacked on a leading axis). ``layers`` holds one `Block` per layer in
    the order they run (repeat ``r``'s element ``i`` at ``r * len(pattern)
    + i``). The parameters do not require gradients (serving only)."""

    def __init__(self, cfg, params: Dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        (pattern, repeats), = cfg.layer_groups()
        self.period = len(pattern)
        self.layers = nn.ModuleList(
            Block(params["layers"][f"l{i}"], r)
            for r in range(repeats) for i in range(self.period))
        self.final_norm = _frozen(params["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Parameter(params["lm_head"], requires_grad=False))

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def param_tree(self) -> Dict:
        """The parameters as a tree in the JAX layout (layers stacked)."""
        layers = {}
        for i in range(self.period):
            blocks = list(self.layers)[i::self.period]
            layers[f"l{i}"] = {
                name: {k: torch.stack([getattr(b, name)[k] for b in blocks])
                       for k in getattr(blocks[0], name)}
                for name in blocks[0].names}
        tree = {"embed": self.embed, "layers": layers,
                "final_norm": dict(self.final_norm)}
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        return tree

    def embed_tokens(self, tokens):
        return embed_tokens({"embed": self.embed}, tokens, self.cfg)

    def _run(self, tokens, prefix_embeds):
        """(hidden before the final norm, {l{i}: [each repeat's cache]})."""
        x, prefix_len = _with_prefix(self.embed_tokens(tokens), prefix_embeds)
        positions = torch.arange(x.shape[1], device=x.device)
        caches: Dict[str, list] = {}
        for j, block in enumerate(self.layers):
            x, _aux, cache = block(x, positions, self.cfg, prefix_len)
            caches.setdefault(f"l{j % self.period}", []).append(cache)
        return x, caches

    @torch.no_grad()
    def forward(self, tokens,
                prefix_embeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (hidden (B, P + S, D), moe_aux scalar 0)."""
        x, _ = self._run(tokens, prefix_embeds)
        x = _apply_norm(self.final_norm, x, self.cfg)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def logits_from_hidden(self, h):
        return logits_from_hidden({"embed": self.embed,
                                   "lm_head": self.lm_head}, h, self.cfg)

    @torch.no_grad()
    def decode_step(self, token, caches: Dict, cache_pos: int):
        """token: (B, 1) int; cache_pos: the next write slot (same across
        the batch). Returns (logits (B, 1, V), caches written in place)."""
        x = self.embed_tokens(token)
        pos = int(cache_pos)
        for j, block in enumerate(self.layers):
            r, i = divmod(j, self.period)
            x = block.decode(x, {k: t[r] for k, t in caches[f"l{i}"].items()},
                             pos, self.cfg)
        x = _apply_norm(self.final_norm, x, self.cfg)
        return self.logits_from_hidden(x), caches

    @torch.no_grad()
    def prefill(self, tokens, prefix_embeds=None):
        """Run the full prompt (after ``prefix_embeds``) and return
        (last-token logits, decode caches sized to it: k/v in bf16, SSM
        states as ``ssd_forward`` returns them)."""
        x, per_layer = self._run(tokens, prefix_embeds)
        x = _apply_norm(self.final_norm, x, self.cfg)
        logits = self.logits_from_hidden(x[:, -1:, :])
        caches = {}
        for name, lst in per_layer.items():
            if isinstance(lst[0], tuple):
                lst = [{"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
                       for k, v in lst]
            caches[name] = {k: torch.stack([c[k] for c in lst])
                            for k in lst[0]}
        return logits, caches

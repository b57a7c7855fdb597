"""Decoder-only LM: the dense layer stack, for serving and training.

The port of the JAX package's ``models/transformer.py`` for the
``("attn", "mlp")`` layer kind. Parameters keep the JAX einsum layouts
(``wq (d, h, hd)``, ``wo (h, hd, d)``, ``embed (V, d)``, ``lm_head (d,
V)``) in a nested dict with the layers stacked on a leading axis, so
carrying weights across (``models.convert``) is a copy. `param_specs`
covers every layer kind (the parameter counts need them); a config with
MoE or SSM layers, an encoder-decoder or prefix tokens raises
`NotImplementedError` (ROADMAP Queue 1 item 2 for the layer kinds, item 3
for expert parallelism and sharding).

One layer's computation is `layer_forward`, a function of that layer's
parameter dict; the serving `Transformer` and the training `forward` both
call it.

Training (functions of a parameter tree, differentiable):
  forward(params, tokens, cfg)       — hidden states; per-layer remat
                                       (``cfg.remat``: full | dots | none)
  lm_loss(params, hidden, labels, cfg) — sequence-chunked cross entropy
  logits_from_hidden, embed_tokens   — the vocab projection and the lookup
Serving (methods of `Transformer`, frozen parameters, no autograd):
  forward(tokens)                    — hidden states (prefill; no remat)
  prefill(tokens)                    — last-token logits + decode caches
  decode_step(token, caches, pos)    — single-token step over the caches
and `init_decode_caches` (bf16 and int8 layouts). Decode caches are
nested dicts as in the JAX package (``{"l0": {"k": (L, B, Smax, KV, D),
...}}``); `decode_step` writes them in place and returns them. Decode
logits are never softcapped: as in the reference, only the decode scores
are (``attention.decode_attention``).
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
    "param_specs", "init_decode_caches", "check_supported", "layer_forward",
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


def check_supported(cfg) -> None:
    """Raise unless every layer of ``cfg`` is the dense ("attn", "mlp")
    kind, the one the port runs so far."""
    kinds = set(cfg.layer_kinds())
    if (cfg.is_encdec or cfg.n_prefix_tokens or kinds != {("attn", "mlp")}):
        raise NotImplementedError(
            f"{cfg.arch}: only dense decoder-only configurations (every "
            f"layer ('attn', 'mlp'), no encoder, no prefix tokens) run in "
            f"the port so far; layer kinds {sorted(kinds)}, is_encdec="
            f"{cfg.is_encdec}, n_prefix_tokens={cfg.n_prefix_tokens} wait "
            f"for ROADMAP Queue 1 item 2 (the layer kinds) and item 3 "
            f"(expert parallelism, sharding)")


def _apply_norm(np_, x, cfg):
    if cfg.norm == "rms":
        return rms_norm(x, np_["w"])
    return layer_norm(x, np_["w"], np_["b"])


# -- decode caches -------------------------------------------------------------

def init_decode_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                       device="cuda") -> Dict:
    """Zeroed decode caches, stacked over the layers: bf16 (or ``dtype``)
    k/v, or, with ``kv_cache_dtype="int8"``, int8 k/v and bf16 per-(token,
    head) scales."""
    from ..core.analysis.wavefront import resolve_device

    check_supported(cfg)
    dev = resolve_device(device)
    (_pattern, repeats), = cfg.layer_groups()
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (repeats, batch, max_len, kv, hd)
    if cfg.kv_cache_dtype == "int8":
        scale = (repeats, batch, max_len, kv, 1)
        return {"l0": {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(scale, dtype=torch.bfloat16, device=dev),
            "v_scale": torch.zeros(scale, dtype=torch.bfloat16, device=dev),
        }}
    return {"l0": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                   "v": torch.zeros(shape, dtype=dtype, device=dev)}}


# -- one layer, and the training forward ---------------------------------------

def layer_forward(lp: Dict, x: torch.Tensor, positions: torch.Tensor, cfg):
    """One ("attn", "mlp") layer over its parameter dict ``lp`` (``norm1``,
    ``attn``, ``norm2``, ``mlp``). Returns (x, (k, v))."""
    h = _apply_norm(lp["norm1"], x, cfg)
    y, kv = attention.self_attention(lp["attn"], h, positions, cfg,
                                     causal=True, prefix_len=0)
    x = x + y
    h2 = _apply_norm(lp["norm2"], x, cfg)
    return x + mlp.mlp(lp["mlp"], h2, cfg), kv


def _layer(lp, x, positions, cfg):
    return layer_forward(lp, x, positions, cfg)[0]


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


def forward(params: Dict, tokens: torch.Tensor,
            cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward over a parameter tree (``param_specs``'
    layout, in the compute dtype). tokens: (B, S) -> (hidden (B, S, D),
    moe_aux scalar). Each layer runs under ``cfg.remat``: ``"full"``
    recomputes it in the backward (``torch.utils.checkpoint``), ``"dots"``
    keeps its products' outputs (selective checkpointing), ``"none"`` keeps
    everything; the numbers are the same."""
    check_supported(cfg)
    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"remat={cfg.remat!r}: full, dots or none")
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _unbind_layers(params["layers"]["l0"]):
        if cfg.remat == "none":
            x = _layer(lp, x, positions, cfg)
        elif cfg.remat == "full":
            x = checkpoint(_layer, lp, x, positions, cfg, use_reentrant=False)
        else:
            x = checkpoint(_layer, lp, x, positions, cfg, use_reentrant=False,
                           context_fn=_dots_context)
    x = _apply_norm(params["final_norm"], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


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
    """One ("attn", "mlp") layer: its slice of the stacked JAX leaves."""

    def __init__(self, layer: Dict, i: int):
        super().__init__()
        for name in ("norm1", "attn", "norm2", "mlp"):
            setattr(self, name, _frozen({k: t[i] for k, t in layer[name].items()}))

    def params(self) -> Dict:
        return {"norm1": self.norm1, "attn": self.attn, "norm2": self.norm2,
                "mlp": self.mlp}

    def forward(self, x, positions, cfg):
        return layer_forward(self.params(), x, positions, cfg)

    def decode(self, x, cache, cache_pos, cfg):
        h = _apply_norm(self.norm1, x, cfg)
        y, cache = attention.decode_attention(self.attn, h, cache, cache_pos,
                                              cfg)
        x = x + y
        h2 = _apply_norm(self.norm2, x, cfg)
        return x + mlp.mlp(self.mlp, h2, cfg)


class Transformer(nn.Module):
    """The dense decoder-only LM over a parameter tree in the JAX layout
    (``param_specs``' nested dict of tensors, layers stacked on a leading
    axis). The parameters do not require gradients (serving only)."""

    def __init__(self, cfg, params: Dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        layer = params["layers"]["l0"]
        (_pattern, repeats), = cfg.layer_groups()
        self.layers = nn.ModuleList(Block(layer, i) for i in range(repeats))
        self.final_norm = _frozen(params["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Parameter(params["lm_head"], requires_grad=False))

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def param_tree(self) -> Dict:
        """The parameters as a tree in the JAX layout (layers stacked)."""
        blocks = list(self.layers)
        layer = {name: {k: torch.stack([getattr(b, name)[k] for b in blocks])
                        for k in getattr(blocks[0], name)}
                 for name in ("norm1", "attn", "norm2", "mlp")}
        tree = {"embed": self.embed, "layers": {"l0": layer},
                "final_norm": dict(self.final_norm)}
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        return tree

    def embed_tokens(self, tokens):
        return embed_tokens({"embed": self.embed}, tokens, self.cfg)

    @torch.no_grad()
    def forward(self, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B, S) -> (hidden (B, S, D), moe_aux scalar)."""
        x = self.embed_tokens(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        for block in self.layers:
            x, _ = block(x, positions, self.cfg)
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
        stacked = caches["l0"]
        for i, block in enumerate(self.layers):
            x = block.decode(x, {k: t[i] for k, t in stacked.items()}, pos,
                             self.cfg)
        x = _apply_norm(self.final_norm, x, self.cfg)
        return self.logits_from_hidden(x), caches

    @torch.no_grad()
    def prefill(self, tokens):
        """Run the full prompt and return (last-token logits, decode caches
        sized to the prompt, bf16)."""
        x = self.embed_tokens(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        ks, vs = [], []
        for block in self.layers:
            x, (k, v) = block(x, positions, self.cfg)
            ks.append(k.to(torch.bfloat16))
            vs.append(v.to(torch.bfloat16))
        x = _apply_norm(self.final_norm, x, self.cfg)
        logits = self.logits_from_hidden(x[:, -1:, :])
        return logits, {"l0": {"k": torch.stack(ks), "v": torch.stack(vs)}}

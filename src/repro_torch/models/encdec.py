"""Whisper-style encoder-decoder backbone, for serving and training.

The port of the JAX package's ``models/encdec.py``. The conv/audio
frontend is a stub there and here: the encoder takes precomputed frame
embeddings (B, enc_seq, d_model). The encoder is a bidirectional
transformer over frames (+ sinusoidal positions, no RoPE); the decoder is
a causal transformer with per-layer cross-attention into the encoder
output. Decode keeps a self-attention KV cache plus precomputed cross KV
(``{"self": {"k", "v"}, "cross": {"k", "v"}}``, each (L, B, S, KV, hd)).

Training: `encode` and `forward` over a parameter tree, each layer under
``cfg.remat`` as ``transformer.forward`` runs its layers (the whole layer
body, as the reference's ``jax.checkpoint`` wraps it). Serving: `EncDec`,
frozen parameters beside ``transformer.Transformer``, with `encode`,
`prefill(frames, tokens)` and `decode_step(token, caches, pos)`;
`init_decode_caches` builds zeroed caches. Like ``Transformer``, `EncDec`
slices its stacked layers once, at construction, into one parameter dict
per layer. The reference's ``Server``
feeds prompts through ``decode_step`` and never calls ``encode``, so its
cross caches stay zero; the port's ``Server`` does the same.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from . import attention, mlp
from .common import Spec, layer_norm, sinusoidal_positions
from .transformer import (_apply_norm, _frozen, _norm_specs, _remat, _stack,
                          _unbind_layers, logits_from_hidden)

__all__ = [
    "param_specs", "encode", "forward", "prefill", "decode_step",
    "init_decode_caches", "EncDec",
]


def _enc_layer_specs(cfg, r: int) -> Dict:
    return {
        "norm1": _norm_specs(cfg, r),
        "attn": _stack(attention.param_specs(cfg), r),
        "norm2": _norm_specs(cfg, r),
        "mlp": _stack(mlp.param_specs(cfg), r),
    }


def _dec_layer_specs(cfg, r: int) -> Dict:
    return {
        "norm1": _norm_specs(cfg, r),
        "attn": _stack(attention.param_specs(cfg), r),
        "norm_x": _norm_specs(cfg, r),
        "xattn": _stack(attention.param_specs(cfg, cross=True), r),
        "norm2": _norm_specs(cfg, r),
        "mlp": _stack(mlp.param_specs(cfg), r),
    }


def param_specs(cfg) -> Dict:
    d, v = cfg.d_model, cfg.padded_vocab
    return {
        "embed": Spec((v, d), ("vocab", "embed"), scale=0.02),
        "enc_layers": _enc_layer_specs(cfg, cfg.n_enc_layers),
        "enc_norm": {"w": Spec((d,), ("embed",), init="ones"),
                     "b": Spec((d,), ("embed",), init="zeros")},
        "dec_layers": _dec_layer_specs(cfg, cfg.n_layers),
        "final_norm": {"w": Spec((d,), ("embed",), init="ones"),
                       "b": Spec((d,), ("embed",), init="zeros")},
    }


# -- layers -----------------------------------------------------------------

def _enc_layer(lp, x, positions, cfg):
    h = _apply_norm(lp["norm1"], x, cfg)
    y, _ = attention.self_attention(lp["attn"], h, positions, cfg,
                                    causal=False, use_rope=False)
    x = x + y
    h2 = _apply_norm(lp["norm2"], x, cfg)
    return x + mlp.mlp(lp["mlp"], h2, cfg)


def _dec_layer(lp, x, positions, mem, cfg):
    """One decoder layer over the encoder output ``mem``. Returns (x,
    self k, self v, cross k, cross v)."""
    h = _apply_norm(lp["norm1"], x, cfg)
    y, (k, v) = attention.self_attention(lp["attn"], h, positions, cfg,
                                         causal=True)
    xk, xv = attention.memory_kv(lp["xattn"], mem)
    return _dec_tail(lp, x + y, (xk, xv), cfg), k, v, xk, xv


def _dec_tail(lp, x, cross, cfg):
    """A decoder layer after its self-attention: cross-attention into the
    encoder's ``cross`` (k, v), then the MLP."""
    hx = _apply_norm(lp["norm_x"], x, cfg)
    x = x + attention.cross_attention(lp["xattn"], hx, cross, cfg)
    h2 = _apply_norm(lp["norm2"], x, cfg)
    return x + mlp.mlp(lp["mlp"], h2, cfg)


def _dec_train_layer(lp, x, positions, mem, cfg):
    return _dec_layer(lp, x, positions, mem, cfg)[0]


def _layer_list(tree) -> List[Dict]:
    """The per-layer dicts of a stacked layer tree, or a list of them (the
    serving module's) as it is."""
    return tree if isinstance(tree, list) else _unbind_layers(tree)


def _positions(frames: torch.Tensor, cfg) -> torch.Tensor:
    s = frames.shape[1]
    pos = sinusoidal_positions(s, cfg.d_model, frames.device)
    return frames + pos[None].to(frames.dtype)


# -- training (functions of a parameter tree) ---------------------------------

def encode(params: Dict, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames: (B, S_enc, D) stubbed frontend output -> encoder hidden."""
    x = _positions(frames, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _layer_list(params["enc_layers"]):
        x = _remat(_enc_layer, cfg, lp, x, positions, cfg)
    return layer_norm(x, params["enc_norm"]["w"], params["enc_norm"]["b"])


def forward(params: Dict, frames: torch.Tensor, tokens: torch.Tensor,
            cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: returns (decoder hidden (B, S, D), aux=0)."""
    mem = encode(params, frames, cfg)
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _layer_list(params["dec_layers"]):
        x = _remat(_dec_train_layer, cfg, lp, x, positions, mem, cfg)
    x = layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"])
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_decode_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                       device="cuda") -> Dict:
    from ..core.analysis.wavefront import resolve_device

    dev = resolve_device(device)
    kv, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers

    def zeros(s):
        return torch.zeros((L, batch, s, kv, hd), dtype=dtype, device=dev)

    return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
            "cross": {"k": zeros(cfg.enc_seq), "v": zeros(cfg.enc_seq)}}


def prefill(params: Dict, frames: torch.Tensor, tokens: torch.Tensor, cfg):
    """Encode + run the decoder prompt; return (last logits, caches: self
    k/v sized to the prompt and cross k/v, bf16)."""
    mem = encode(params, frames, cfg)
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    names = ("self_k", "self_v", "cross_k", "cross_v")
    kept: Dict[str, List[torch.Tensor]] = {n: [] for n in names}
    for lp in _layer_list(params["dec_layers"]):
        x, *kvs = _dec_layer(lp, x, positions, mem, cfg)
        for n, t in zip(names, kvs):
            kept[n].append(t.to(torch.bfloat16))
    x = layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"])
    logits = logits_from_hidden(params, x[:, -1:, :], cfg)
    st = {n: torch.stack(ts) for n, ts in kept.items()}
    return logits, {"self": {"k": st["self_k"], "v": st["self_v"]},
                    "cross": {"k": st["cross_k"], "v": st["cross_v"]}}


def decode_step(params: Dict, token: torch.Tensor, caches: Dict,
                cache_pos: int, cfg) -> Tuple[torch.Tensor, Dict]:
    """token: (B, 1). caches: {"self": {k,v (L,B,S,KV,hd)}, "cross": ...};
    the self caches are written in place at ``cache_pos``."""
    x = params["embed"][token]
    pos = int(cache_pos)
    for i, lp in enumerate(_layer_list(params["dec_layers"])):
        h = _apply_norm(lp["norm1"], x, cfg)
        y, _ = attention.decode_attention(
            lp["attn"], h, {k: t[i] for k, t in caches["self"].items()}, pos,
            cfg)
        cross = (caches["cross"]["k"][i], caches["cross"]["v"][i])
        x = _dec_tail(lp, x + y, cross, cfg)
    x = layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"])
    return logits_from_hidden(params, x, cfg), caches


# -- the serving model -------------------------------------------------------

def _frozen_tree(tree: Dict) -> nn.Module:
    if any(isinstance(v, dict) for v in tree.values()):
        return nn.ModuleDict({k: _frozen_tree(v) for k, v in tree.items()})
    return _frozen(tree)


def _plain(mod) -> Dict:
    """A `_frozen_tree` module back as a nested dict of tensors."""
    if isinstance(mod, nn.ParameterDict):
        return dict(mod)
    return {k: _plain(v) for k, v in mod.items()}


class EncDec(nn.Module):
    """The encoder-decoder over a parameter tree in the JAX layout
    (``param_specs``' nested dict, layers stacked on a leading axis),
    each layer's slice of the stacked leaves held as its own parameters.
    The parameters do not require gradients (serving only)."""

    def __init__(self, cfg, params: Dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        for name in ("enc_layers", "dec_layers"):
            setattr(self, name, nn.ModuleList(
                _frozen_tree(lp) for lp in _unbind_layers(params[name])))
        self.enc_norm = _frozen(params["enc_norm"])
        self.final_norm = _frozen(params["final_norm"])

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def _tree(self) -> Dict:
        """The parameters as the functions take them, layers as a list."""
        return {"embed": self.embed,
                "enc_layers": [_plain(m) for m in self.enc_layers],
                "dec_layers": [_plain(m) for m in self.dec_layers],
                "enc_norm": dict(self.enc_norm),
                "final_norm": dict(self.final_norm)}

    def param_tree(self) -> Dict:
        """The parameters as a tree in the JAX layout (layers stacked)."""
        tree = self._tree()
        for name in ("enc_layers", "dec_layers"):
            layers = tree[name]
            tree[name] = {sub: {k: torch.stack([lp[sub][k] for lp in layers])
                                for k in layers[0][sub]}
                          for sub in layers[0]}
        return tree

    @torch.no_grad()
    def encode(self, frames):
        return encode(self._tree(), frames, self.cfg)

    @torch.no_grad()
    def prefill(self, frames, tokens):
        return prefill(self._tree(), frames, tokens, self.cfg)

    @torch.no_grad()
    def decode_step(self, token, caches: Dict, cache_pos: int):
        return decode_step(self._tree(), token, caches, cache_pos, self.cfg)

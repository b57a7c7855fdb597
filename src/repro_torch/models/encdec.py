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
body, as the reference's ``jax.checkpoint`` wraps it); an encoder layer is
``transformer.layer_forward`` unmasked and without RoPE. Serving:
`EncDec`, frozen parameters beside ``transformer.Transformer`` (both
``transformer.OnBlocks``: one ``transformer.Block`` a layer), with
`encode`, `prefill(frames, tokens)` and `decode_step(token, caches, pos)`;
`init_decode_caches` builds zeroed caches. The reference's ``Server``
feeds prompts through ``decode_step`` and never calls ``encode``, so its
cross caches stay zero; the port's ``Server`` does the same.

Under a sharding plan (``EncDec(cfg, params, plan)``, what
``steps.make_model(cfg, params, plan)`` builds) the model holds this
rank's blocks of its weights (``partition.serving_shardings``: the JAX
serving steps' ``params_only_shardings``) and decodes into this rank's
cache blocks (``partition.serving_cache_shardings``): the kv heads over
``model``, or, where the heads stay whole, the sequence of the self caches
and of the cross caches (the encoder's frames) over
``plan.cache_seq_axis`` where it divides it (else whole). Each layer
gathers its leaves over the axes other than ``model`` (FSDP's ``embed``)
just before it runs; attention (the cross-attention's ``memory_kv`` too)
runs on the rank's heads, or whole where they are replicated, the MLP on
its ``d_ff`` block, the partial sums reduced over ``model``; the
embedding is vocab-parallel and the logits gathered. The decode's
cross-attention over a cross cache that shards its sequence partitions
its softmax over it (``attention.cross_attention``'s ``kv_seq``). The
sharded train step computes on the same blocks (`forward`'s
``gather_layer``): each stream (the encoder's over its frames, the
decoder's over its tokens) is this rank's block of the sequence over
``plan.seq_axis`` where its length divides it, and the encoder's output
is gathered whole for every decoder layer's ``memory_kv``.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from . import attention, mlp
from .common import Spec, layer_norm, sinusoidal_positions
from .transformer import (OnBlocks, _apply_norm, _ffn, _frozen, _norm_specs,
                          _remat, _stack, _stacked, _unbind_layers,
                          embed_tokens, layer_forward, logits_from_hidden,
                          padded_window)

__all__ = [
    "param_specs", "encode", "forward", "init_decode_caches", "EncDec",
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

def _enc_layer(lp, x, positions, cfg, gather=None, seq=None):
    """One encoder layer; ``gather`` and ``seq`` as
    ``transformer._layer``'s."""
    if gather is not None:
        lp = gather(lp)
    return layer_forward(lp, x, positions, cfg, need_aux=False, seq=seq,
                         want_cache=False, causal=False)[0]


def _dec_layer(lp, x, positions, mem, cfg, seq=None):
    """One decoder layer over the encoder output ``mem`` (whole). Returns
    (x, self k, self v, cross k, cross v); ``seq`` as
    ``transformer.layer_forward``'s."""
    from ..sharding.partition import seq_gather

    h = _apply_norm(lp["norm1"], x, cfg)
    if seq is not None:
        h = seq_gather(h, seq)
    y, (k, v) = attention.self_attention(lp["attn"], h, positions, cfg,
                                         causal=True, seq=seq)
    xk, xv = attention.memory_kv(lp["xattn"], mem)
    return _dec_tail(lp, x + y, (xk, xv), cfg, seq), k, v, xk, xv


def _dec_tail(lp, x, cross, cfg, seq=None, kv_seq=None):
    """A decoder layer after its self-attention: cross-attention into the
    encoder's ``cross`` (k, v), then the MLP (``transformer._ffn``);
    ``kv_seq`` as ``attention.cross_attention``'s."""
    from ..sharding.partition import seq_gather

    hx = _apply_norm(lp["norm_x"], x, cfg)
    if seq is not None:
        hx = seq_gather(hx, seq)
    x = x + attention.cross_attention(lp["xattn"], hx, cross, cfg, seq,
                                      kv_seq)
    return _ffn(lp, x, cfg, need_aux=False, seq=seq)[0]


def _dec_train_layer(lp, x, positions, mem, cfg, gather=None, seq=None):
    if gather is not None:
        lp = gather(lp)
    return _dec_layer(lp, x, positions, mem, cfg, seq)[0]


def _positions(frames: torch.Tensor, cfg) -> torch.Tensor:
    s = frames.shape[1]
    pos = sinusoidal_positions(s, cfg.d_model, frames.device)
    return frames + pos[None].to(frames.dtype)


# -- training (functions of a parameter tree) ---------------------------------

def encode(params: Dict, frames: torch.Tensor, cfg,
           gather_layer=None) -> torch.Tensor:
    """frames: (B, S_enc, D) stubbed frontend output -> encoder hidden
    (whole). ``gather_layer`` as ``transformer.forward``'s (the stack
    ``"enc_layers"``); in the sequence-parallel training forward the
    stream between the layers is this rank's block of the frames, and the
    output is gathered whole after the final norm."""
    from ..sharding.partition import seq_axis_for, seq_block, seq_gather

    x = _positions(frames, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    seq = seq_axis_for(x.shape[1])
    if seq is not None:
        x = seq_block(x, seq)
    gather = (None if gather_layer is None else
              functools.partial(gather_layer, "enc_layers"))
    for lp in _unbind_layers(params["enc_layers"]):
        x = _remat(_enc_layer, cfg, lp, x, positions, cfg, gather, seq)
    x = layer_norm(x, params["enc_norm"]["w"], params["enc_norm"]["b"])
    return x if seq is None else seq_gather(x, seq)


def forward(params: Dict, frames: torch.Tensor, tokens: torch.Tensor,
            cfg, *, gather_layer=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: returns (decoder hidden (B, S, D), aux=0).
    ``gather_layer`` as ``transformer.forward``'s (the stacks
    ``"enc_layers"`` and ``"dec_layers"``). In the sequence-parallel
    training forward the decoder's stream is this rank's block of the
    tokens from the (vocab-parallel) embedding on, and so are the hidden
    states returned (``transformer.lm_loss_sums`` gathers them)."""
    from ..sharding.partition import seq_axis_for

    mem = encode(params, frames, cfg, gather_layer)
    seq = seq_axis_for(tokens.shape[1])
    x = embed_tokens(params, tokens, cfg, seq)
    positions = torch.arange(tokens.shape[1], device=x.device)
    gather = (None if gather_layer is None else
              functools.partial(gather_layer, "dec_layers"))
    for lp in _unbind_layers(params["dec_layers"]):
        x = _remat(_dec_train_layer, cfg, lp, x, positions, mem, cfg, gather,
                   seq)
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


# -- the serving model -------------------------------------------------------

class EncDec(OnBlocks):
    """The encoder-decoder over a parameter tree in the JAX layout
    (``param_specs``' nested dict, layers stacked on a leading axis): one
    ``transformer.Block`` a layer in ``enc_layers`` and ``dec_layers``.
    The parameters do not require gradients (serving only). With
    ``plan``, ``params`` is this rank's blocks (the module docstring)."""

    def __init__(self, cfg, params: Dict, plan=None):
        super().__init__(cfg, params, plan)
        for name, n in (("enc_layers", cfg.n_enc_layers),
                        ("dec_layers", cfg.n_layers)):
            setattr(self, name, self._blocks(
                params[name], self.specs and self.specs[name], n))
        self.enc_norm = _frozen(params["enc_norm"])
        self.final_norm = _frozen(params["final_norm"])

    def param_tree(self) -> Dict:
        """The parameters as a tree in the JAX layout (layers stacked)."""
        return {"embed": self.embed,
                "enc_layers": _stacked(list(self.enc_layers)),
                "dec_layers": _stacked(list(self.dec_layers)),
                "enc_norm": dict(self.enc_norm),
                "final_norm": dict(self.final_norm)}

    def _ctx(self):
        from ..sharding.partition import activation_ctx, split_batch

        return activation_ctx(self._plan(), split_batch(),
                              self.plan is not None)

    def _encode(self, frames):
        x = _positions(frames, self.cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        for blk in self.enc_layers:
            x = layer_forward(blk.local_params(), x, positions, self.cfg,
                              need_aux=False, want_cache=False,
                              causal=False)[0]
        norm = self._gathered({"enc_norm": dict(self.enc_norm)})["enc_norm"]
        return layer_norm(x, norm["w"], norm["b"])

    def _top(self) -> Dict:
        return self._gathered({"embed": self.embed,
                               "final_norm": dict(self.final_norm)})

    @torch.no_grad()
    def encode(self, frames):
        with self._ctx():
            return self._encode(frames)

    @torch.no_grad()
    def prefill(self, frames, tokens):
        """Encode + run the decoder prompt; return (last logits, caches:
        self k/v sized to the prompt and cross k/v, bf16). On a mesh
        ``frames`` and ``tokens`` are this rank's block of the batch when
        ``partition.split_batch()``, and the caches are this rank's
        blocks (``partition.serving_cache_shardings``)."""
        from ..sharding.partition import (block, cache_seq_sharded,
                                          serving_cache_shardings,
                                          split_batch)
        from ..sharding.rules import P

        cfg = self.cfg
        with self._ctx():
            mem = self._encode(frames)
            top = self._top()
            x = embed_tokens(top, tokens, cfg)
            positions = torch.arange(x.shape[1], device=x.device)
            kept = []
            for blk in self.dec_layers:
                x, *kvs = _dec_layer(blk.local_params(), x, positions, mem,
                                     cfg)
                kept.append([t.to(torch.bfloat16) for t in kvs])
            x = layer_norm(x, top["final_norm"]["w"], top["final_norm"]["b"])
            logits = logits_from_hidden(top, x[:, -1:, :], cfg)
        st = [torch.stack(ts) for ts in zip(*kept)]
        caches = {"self": {"k": st[0], "v": st[1]},
                  "cross": {"k": st[2], "v": st[3]}}
        if self.plan is not None and cache_seq_sharded(cfg, self.plan):
            # the rank's block of each cache's slots, where its length
            # divides the axis (the decode reads them so)
            ax, mesh = self.plan.cache_seq_axis, self.plan.mesh
            n = mesh.axis_size(ax)
            if x.shape[1] % n:
                raise ValueError(
                    f"a {x.shape[1]}-token prompt does not divide the "
                    f"cache's sequence axis {ax!r} ({n} ranks)")
            split = split_batch()
            b = tokens.shape[0] * (self.plan.axis_size(self.plan.batch_axes)
                                   if split else 1)
            specs = serving_cache_shardings(cfg, self.plan, init_decode_caches(
                cfg, b, x.shape[1], device="meta"), split)
            caches = {name: {k: block(t, P(None, None, specs[name][k][2]),
                                      mesh) for k, t in c.items()}
                      for name, c in caches.items()}
        return logits, caches

    @torch.no_grad()
    def decode_step(self, token, caches: Dict, cache_pos: int):
        """token: (B, 1); caches: {"self": {k,v (L,B,S,KV,hd)}, "cross":
        ...}, this rank's blocks on a mesh (``token`` and the logits its
        block of the batch when ``partition.split_batch()``); the self
        caches are written in place at ``cache_pos``."""
        cfg = self.cfg
        kv_seq = None
        if caches["cross"]["k"].shape[2] != cfg.enc_seq:
            kv_seq = self.plan.cache_seq_axis
        pos = int(cache_pos)
        with self._ctx():
            top = self._top()
            x = embed_tokens(top, token, cfg)
            for i, blk in enumerate(self.dec_layers):
                # the cross caches hold what memory_kv made of wk and wv
                p = blk.local_params(skip=(("xattn", "wk"), ("xattn", "wv")))
                h = _apply_norm(p["norm1"], x, cfg)
                y, _ = attention.decode_attention(
                    p["attn"], h, {k: t[i] for k, t in caches["self"].items()},
                    pos, cfg)
                cross = (caches["cross"]["k"][i], caches["cross"]["v"][i])
                x = _dec_tail(p, x + y, cross, cfg, kv_seq=kv_seq)
            x = layer_norm(x, top["final_norm"]["w"], top["final_norm"]["b"])
            return logits_from_hidden(top, x, cfg), caches

    def pad_caches(self, caches: Dict, max_len: int) -> Dict:
        """Prefill's self caches padded to ``max_len`` slots
        (``transformer.padded_window``); the cross caches as they are."""
        return {"self": padded_window(self, caches["self"], max_len),
                "cross": caches["cross"]}

"""Model/config schema shared by every assigned architecture.

A copy of the JAX package's ``configs/base.py`` without JAX: a
`ModelConfig` fully determines parameter shapes, the layer pattern and the
four benchmark input shapes. `param_count` and `active_param_count` walk
the port's spec dict (``models.transformer.param_specs`` or, for enc-dec,
``models.encdec.param_specs``) themselves; `reduced()` is verbatim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "shape_for"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned input-shape set (LM shapes; decode_*/long_* lower serve_step).
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_for(name: str) -> ShapeSpec:
    return SHAPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio

    # transformer core
    n_layers: int = 12
    d_model: int = 1024
    n_heads: int = 16
    n_kv_heads: int = 16
    head_dim: Optional[int] = None          # default d_model // n_heads
    d_ff: int = 4096
    vocab_size: int = 32_000
    vocab_pad_to: int = 128                  # pad vocab for shardability
    act: str = "swiglu"                      # swiglu | geglu | gelu
    qkv_bias: bool = False
    norm: str = "rms"                        # rms | layer
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    embed_scale: bool = False                # gemma-style sqrt(d) scaling
    logit_softcap: float = 0.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_pattern: Tuple[int, ...] = ()        # 1 = MoE layer, 0 = dense, cycled

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid layout: per-layer mixer pattern, cycled over n_layers.
    # entries: "attn" | "ssm"
    mixer_pattern: Tuple[str, ...] = ("attn",)

    # encoder-decoder (whisper) / VLM (paligemma)
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1_500                     # whisper 30s @ 50 Hz
    n_prefix_tokens: int = 0                 # paligemma image tokens
    frontend_dim: int = 0                    # stubbed modality frontend width

    # numerics / execution
    param_dtype: str = "bfloat16"
    master_dtype: str = "float32"
    moment_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"         # bfloat16 | int8 (KIVI-style)
    decode_attention: str = "gathered"       # gathered | sharded (flash-decode)
    decode_stream: str = "batch"             # batch | replicated (weight-stationary)
    grad_compression: str = "none"           # none | int8_pod (error feedback)
    q_chunk: int = 1_024
    kv_chunk: int = 1_024
    loss_chunk: int = 16_384                 # tokens per vocab-xent chunk
    remat: str = "full"                      # full | dots | none

    # which benchmark shapes apply (long_500k only for sub-quadratic mixers)
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        v, p = self.vocab_size, self.vocab_pad_to
        return ((v + p - 1) // p) * p

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    def layer_kinds(self) -> List[Tuple[str, str]]:
        """Per-layer (mixer, ffn) pairs, length n_layers."""
        out = []
        for i in range(self.n_layers):
            mixer = self.mixer_pattern[i % len(self.mixer_pattern)]
            if self.n_experts and self.moe_pattern:
                ffn = "moe" if self.moe_pattern[i % len(self.moe_pattern)] else "mlp"
            elif self.n_experts:
                ffn = "moe"
            elif self.d_ff > 0:
                ffn = "mlp"
            else:
                ffn = "none"
            out.append((mixer, ffn))
        return out

    def layer_groups(self) -> List[Tuple[List[Tuple[str, str]], int]]:
        """(pattern, repeats): smallest repeating block of layer kinds.

        The layer scan runs over `repeats` with the pattern unrolled inside,
        keeping the HLO flat in depth for heterogeneous (Jamba-like) stacks.
        """
        kinds = self.layer_kinds()
        n = len(kinds)
        for plen in range(1, n + 1):
            if n % plen:
                continue
            pat = kinds[:plen]
            if pat * (n // plen) == kinds:
                return [(pat, n // plen)]
        return [(kinds, 1)]

    def _specs(self):
        from ..models import encdec, transformer  # local to avoid cycles

        return (encdec if self.is_encdec else transformer).param_specs(self)

    def _spec_leaves(self):
        from ..models.common import tree_leaves  # local to avoid cycles

        return [s for _, s in tree_leaves(self._specs())]

    def param_count(self) -> int:
        """Total parameters (exact, from the spec tree)."""
        return sum(int(math.prod(s.shape)) for s in self._spec_leaves())

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        total = 0
        for s in self._spec_leaves():
            cnt = int(math.prod(s.shape))
            if "experts" in s.axes:
                cnt = cnt * self.top_k // self.n_experts
            total += cnt
        return total

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            # keep one full mixer/ffn period so hybrids exercise every path
            n_layers=min(self.n_layers, max(4, len(self.mixer_pattern),
                                            2 * len(self.moe_pattern))),
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            vocab_pad_to=64,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=64 if self.is_encdec else self.enc_seq,
            n_prefix_tokens=min(self.n_prefix_tokens, 8),
            q_chunk=64, kv_chunk=64, loss_chunk=512,
        )
        if self.n_kv_heads == 1:
            small["n_kv_heads"] = 1
        small.update(overrides)
        return dataclasses.replace(self, **small)


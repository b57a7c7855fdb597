"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave + MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
[arXiv:2403.19887]. Period of 8 layers: attention at index 4, Mamba
elsewhere; MoE on every other layer (odd indices), dense MLP otherwise.

Optimizer state runs bf16 master + bf16 moments: 398B params with f32
AdamW (14 B/param) exceeds a 256-chip v5e pod's HBM; bf16 (6 B/param)
fits (see EXPERIMENTS.md memory table).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    act="swiglu",
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_pattern=(0, 1),                     # MoE every other layer
    mixer_pattern=("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm"),
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    master_dtype="bfloat16",
    moment_dtype="bfloat16",
    supports_long_context=True,             # hybrid: runs long_500k
)

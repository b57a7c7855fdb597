"""paligemma-3b [vlm] — SigLIP + gemma backbone [arXiv:2407.07726].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216. The SigLIP vision
frontend is a STUB per the assignment: `input_specs()` provides 256
precomputed patch embeddings (B, 256, d_model) which the backbone consumes
as a bidirectional prefix (prefix-LM masking).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
    n_prefix_tokens=256,
    frontend_dim=2048,
)

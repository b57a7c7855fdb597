"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256 [arXiv:2403.08295].

8 heads do not divide the 16-way model axis: attention stays head-replicated,
TP lands on d_ff/vocab (DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
)

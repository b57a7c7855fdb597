"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
llama-arch GQA [arXiv:2403.04652].

56 heads do not divide the 16-way model axis: train/prefill use
sequence-parallel attention; decode shards the KV cache along sequence
(DESIGN.md §5; one of the three hillclimb cells).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    act="swiglu",
    tie_embeddings=False,
)

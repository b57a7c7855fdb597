"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064, RoPE + SwiGLU [arXiv:2404.14219]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    act="swiglu",
    tie_embeddings=False,
)

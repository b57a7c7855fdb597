"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064, QKV bias [hf:Qwen/Qwen1.5-32B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    act="swiglu",
    qkv_bias=True,
    tie_embeddings=False,
)

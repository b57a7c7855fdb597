"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) expert
d_ff=512 vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    act="swiglu",
    n_experts=32,
    top_k=8,
    moe_d_ff=512,
    moe_pattern=(1,),                       # MoE on every layer
)

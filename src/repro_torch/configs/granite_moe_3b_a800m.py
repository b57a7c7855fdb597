"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512 vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-3b-a800m-base].

40 experts do not divide the 16-way model axis; the sharding rules fall back
to TP over the (tiny) expert FFN dim — see sharding/rules.py and DESIGN.md §5.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    act="swiglu",
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    moe_pattern=(1,),
)

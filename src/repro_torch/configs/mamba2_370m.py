"""mamba2-370m [ssm] — 48L d_model=1024, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060].

d_ff=0: pure Mamba-2 stack (mixer only, no FFN). Runs long_500k via the
O(1)-state decode path.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16,                              # unused (attention-free)
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,                                  # no FFN
    vocab_size=50280,
    mixer_pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    supports_long_context=True,
)

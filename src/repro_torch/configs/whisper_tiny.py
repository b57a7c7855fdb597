"""whisper-tiny [audio] — enc-dec, 4L encoder + 4L decoder, d_model=384,
6H, d_ff=1536, vocab=51865 [arXiv:2212.04356].

The conv audio frontend is a STUB per the assignment: `input_specs()`
provides precomputed frame embeddings (B, 1500, d_model). LayerNorm + GELU
(whisper convention); d_model=384 keeps the 16-way model axis on d_ff and
vocab only (6 heads are replicated — DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-tiny",
    family="audio",
    n_layers=4,                              # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    norm="layer",
    is_encdec=True,
    enc_seq=1500,
    frontend_dim=384,
    tie_embeddings=True,
)

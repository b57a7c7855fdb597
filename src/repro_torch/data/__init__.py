"""Deterministic, shard-aware synthetic data pipeline."""
from .pipeline import DataConfig, SyntheticLM, make_batch_iterator  # noqa: F401

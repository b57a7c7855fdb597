"""Optimizers, schedules, and gradient compression."""
from .adamw import (  # noqa: F401
    AdamWConfig, apply_updates, clip_by_global_norm, global_norm, init_state,
)
from .schedule import warmup_constant, warmup_cosine  # noqa: F401
from . import compression  # noqa: F401

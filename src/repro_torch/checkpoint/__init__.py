"""Numpy checkpointing: atomic commit, keep-k, restore onto a device."""
from .manager import CheckpointManager, latest_step, restore, save  # noqa: F401

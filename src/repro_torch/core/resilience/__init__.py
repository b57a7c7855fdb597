"""Crash-safe long runs: atomic per-tile checkpoint/resume for the tiled
out-of-core engine (`analysis.distributed.tiled_summary`)."""
from .checkpoint import TileCheckpoint, source_fingerprint

__all__ = ["TileCheckpoint", "source_fingerprint"]

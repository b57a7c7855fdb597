"""Architecture config registry: ``get_config("<arch-id>")``.

The ten assigned architectures, exact hyper-parameters from the assignment
table (the JAX package's data, copied). ``specs`` builds every cell's
input trees as meta tensors.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelConfig, SHAPES, ShapeSpec, shape_for  # noqa: F401

_ARCH_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mamba2-370m": "mamba2_370m",
    "gemma-2b": "gemma_2b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "yi-34b": "yi_34b",
    "qwen1.5-32b": "qwen1_5_32b",
    "paligemma-3b": "paligemma_3b",
    "whisper-tiny": "whisper_tiny",
}

ARCHS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}

"""Plain PyTorch versions of every kernel, under the JAX package's names.

Each plain version is defined once, beside its kernel's wrapper
(`kernels.semiring`, `kernels.seghist`); this module gathers them under
the names of ``repro/kernels/ref.py``, so callers and tests can ask for
the reference implementation by the same name in both packages. They run
on any device, on fp32 (and, where the docstring says so, narrow) inputs.
The extension point's plain versions, ``semiring_matmul_ref`` and
``semiring_matmul_batched_ref``, stand beside them; the JAX package's
``ref.py`` has no counterpart, so ``__all__`` leaves them out.
"""
from __future__ import annotations

from .seghist import value_histogram_ref
from .semiring import (batched_count_matmul_ref, batched_minplus_matmul_ref,
                       count_matmul_ref, frontier_step_packed_ref,
                       frontier_step_ref, minplus_count_matmul_ref,
                       minplus_matmul_ref, reachability_step_ref,
                       semiring_matmul_batched_ref,  # noqa: F401
                       semiring_matmul_ref)

__all__ = [
    "minplus_matmul_ref", "reachability_step_ref", "value_histogram_ref",
    "count_matmul_ref", "minplus_count_matmul_ref", "frontier_step_ref",
    "frontier_step_packed_ref",
    "batched_minplus_matmul_ref", "batched_count_matmul_ref",
]

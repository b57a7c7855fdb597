"""Value histogram — the path-length distribution's kernel and plain version.

:func:`value_histogram` counts ``floor(x)`` into int32 bins ``[0,
num_bins)`` through a hand-written CUDA kernel (``csrc/seghist.cu``, a
privatized shared-memory histogram; replaces ``repro/kernels/seghist.py``
``value_histogram_pallas``). Non-finite, negative and ``>= num_bins``
values are dropped, so the JAX package's ``-1`` padding needs no
counterpart: the kernel takes any shape as it is.

The wrapper launches the kernel on a CUDA tensor (or raises) and runs
:func:`value_histogram_ref` only for a CPU tensor or ``use_kernel=False``.
Its launches count in ``kernels.semiring.launches``, the one registry of
the port's kernels.
"""
from __future__ import annotations

import ctypes

import torch

from .semiring import _check, _use_kernel, launches

__all__ = ["value_histogram", "value_histogram_ref", "MAX_BINS"]

#: bins one block holds in its 48 KB of static-size shared memory
MAX_BINS = 48 * 1024 // 4

_LIB = None


def value_histogram_ref(x: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Histogram of floor(x) into bins [0, num_bins); non-finite and
    out-of-range values are dropped. Returns int32 counts (num_bins,)."""
    xf = x.reshape(-1).float()
    valid = torch.isfinite(xf) & (xf >= 0) & (xf < num_bins)
    idx = torch.where(valid, xf, float(num_bins)).long()  # overflow bin
    return torch.bincount(idx, minlength=num_bins + 1)[:num_bins].to(
        torch.int32)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("seghist")
        lib.repro_value_histogram_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.repro_value_histogram_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def value_histogram(x: torch.Tensor, num_bins: int,
                    use_kernel: bool = True) -> torch.Tensor:
    """int32 counts of ``floor(x)`` over ``[0, num_bins)``, any shape.

    ``x`` is fp32 and contiguous on the card; the counts land on its device.
    """
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins must be in [1, {MAX_BINS}], got "
                         f"{num_bins}")
    if not _use_kernel(use_kernel, x):
        return value_histogram_ref(x, num_bins)
    if not x.is_contiguous():
        raise ValueError("value_histogram needs a contiguous x")
    out = torch.zeros(num_bins, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    _check(_lib().repro_value_histogram_f32(
        x.data_ptr(), x.numel(), num_bins, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream), "value_histogram")
    launches["value_histogram"] += 1
    return out

"""Value histogram — the path-length distribution's kernel and plain version.

:func:`value_histogram` counts ``floor(x)`` into int32 bins ``[0,
num_bins)`` through a hand-written CUDA kernel (``csrc/seghist.cu``;
replaces ``repro/kernels/seghist.py`` ``value_histogram_pallas``): one
launch, 16-byte loads, one shared histogram per block, each block's bins
added by global atomics into a per-stream accumulator that the last
block to finish copies out and zeroes. Non-finite, negative and ``>= num_bins`` values are dropped, so
the JAX package's ``-1`` padding needs no counterpart: the kernel takes
any shape as it is. :func:`_value_histogram_blocked_ref` is a plain model
of the kernel's partition, and :func:`_hist_plan` the host's pick of
grid.

The wrapper launches the kernel on a CUDA tensor (or raises) and runs
:func:`value_histogram_ref` only for a CPU tensor or ``use_kernel=False``.
Its launches count in ``kernels.semiring.launches``, the one registry of
the port's kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from .semiring import _check, _use_kernel, launches

__all__ = ["value_histogram", "value_histogram_ref", "MAX_BINS"]

#: bins one block holds in its 48 KB of shared memory
MAX_BINS = 48 * 1024 // 4
#: threads of a block (``THREADS`` in ``csrc/seghist.cu``)
THREADS = 512
#: float4 loads a thread has in flight (``UNROLL``)
UNROLL = 4
#: blocks on an SM at most: one wave is up to BLOCKS_PER_SM x the SM count
BLOCKS_PER_SM = 2
#: full trips of UNROLL float4s a thread makes at least before a second
#: block goes on each SM
TRIPS_PER_BLOCK = 2

_LIB = None
#: (device index, stream) -> (ticket, bin accumulator)
_WORKSPACES: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_SMS: Dict[int, int] = {}


def value_histogram_ref(x: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Histogram of floor(x) into bins [0, num_bins); non-finite and
    out-of-range values are dropped. Returns int32 counts (num_bins,)."""
    xf = x.reshape(-1).float()
    valid = torch.isfinite(xf) & (xf >= 0) & (xf < num_bins)
    idx = torch.where(valid, xf, float(num_bins)).long()  # overflow bin
    return torch.bincount(idx, minlength=num_bins + 1)[:num_bins].to(
        torch.int32)


@functools.lru_cache(maxsize=256)
def _hist_plan(n: int, sms: int) -> int:
    """Blocks for ``n`` values on a card of ``sms`` SMs, as the wrapper
    launches ``csrc/seghist.cu``, whatever the bin count: one wave, of one
    block a SM, or ``BLOCKS_PER_SM`` where each thread of them still makes
    ``TRIPS_PER_BLOCK`` full trips of ``UNROLL`` float4s; and no more than
    give each thread one full trip."""
    trip = THREADS * UNROLL  # float4s
    per_sm = max(1, min(BLOCKS_PER_SM,
                        (n // 4) // (sms * trip * TRIPS_PER_BLOCK)))
    trips = -(-(n // 4) // trip)
    return max(1, min(per_sm * sms, trips))


def _value_histogram_blocked_ref(x: torch.Tensor, num_bins: int,
                                 blocks: int) -> torch.Tensor:
    """The kernel's partition of a contiguous ``x``, in plain PyTorch: the
    scalar head up to the first 16-byte boundary of ``x``'s storage, the
    float4 body split evenly over ``blocks`` (block b takes float4s
    ``nv b / blocks .. nv (b + 1) / blocks``), the scalar tail of ``(n -
    head) % 4``; block 0 also counts head and tail. Each block's partial
    histogram, then their sum (the kernel's atomics add them in any order:
    integer sums are exact): int32 (num_bins,)."""
    flat = x.reshape(-1)
    n = flat.numel()
    head = min(n, (-(flat.data_ptr() // 4)) % 4)
    nv = (n - head) // 4
    body = flat[head:head + 4 * nv]
    rest = torch.cat([flat[:head], flat[head + 4 * nv:]])
    out = torch.zeros(num_bins, dtype=torch.int32, device=x.device)
    for b in range(blocks):
        lo, hi = nv * b // blocks, nv * (b + 1) // blocks
        part = value_histogram_ref(body[4 * lo:4 * hi], num_bins)
        if b == 0:
            part += value_histogram_ref(rest, num_bins)
        out += part
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("seghist")
        lib.repro_value_histogram_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.repro_value_histogram_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _workspace(device: torch.device, stream: int,
               words: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """This (device, stream)'s ticket and bin accumulator of at least
    ``words`` int32 (grown as needed), each zeroed once when allocated: the
    kernel leaves both at zero."""
    key = (device.index, stream)
    ticket, acc = _WORKSPACES.get(key, (None, None))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
    if acc is None or acc.numel() < words:
        acc = torch.zeros(words, dtype=torch.int32, device=device)
    _WORKSPACES[key] = (ticket, acc)
    return ticket, acc


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
    out = torch.empty(num_bins, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out.zero_()
    dev = x.device
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    blocks = _hist_plan(x.numel(), _SMS[dev.index])
    # the raw handle: 0.1 µs, where torch.cuda.current_stream takes ~5
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ticket, acc = _workspace(dev, stream, num_bins)
    _check(_lib().repro_value_histogram_f32(
        x.data_ptr(), x.numel(), num_bins, blocks, acc.data_ptr(),
        ticket.data_ptr(), out.data_ptr(), stream), "value_histogram")
    launches["value_histogram"] += 1
    return out

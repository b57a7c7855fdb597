"""The port's value histogram: the kernel's partition and grid rule, on the CPU.

``csrc/seghist.cu`` splits a contiguous fp32 array into a scalar head up to
the first 16-byte boundary, a float4 body split evenly over the blocks and
a scalar tail, counts each block's share into a partial histogram and sums
the partials in one last block. ``seghist._value_histogram_blocked_ref``
models that partition in plain PyTorch; here it is held bit-equal (integer
counts) to ``value_histogram_pallas`` in interpret mode, through the JAX
package's padding ``ops.value_histogram``, at 1 and 65 bins, every length
the kernel treats apart and every storage offset mod 4. At 4096 and
12,288 bins the JAX kernel unrolls one compare per bin and takes minutes to
compile, so there the model and the CPU wrapper are held to the JAX
package's plain version ``repro.kernels.ref.value_histogram_ref`` (a
scatter-add), and to ``numpy.bincount``. The kernel itself runs only on
the card (``chip_smoke.py`` phase 3 holds it to ``value_histogram_ref`` at
these cases).
"""
import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import seghist as H

NS = [0, 1, 3, 4, 5, 1023, 1536 * 1536]
OFFSETS = [0, 1, 2, 3]
H100_SMS = 132


def _values(n, bins):
    """``n`` fp32 values spread over [-3, bins + 3), led by the specials row
    (NaN, +-inf, -0, -0.5, just below and at the top bin's end, 1e9)."""
    rng = np.random.default_rng(n * 7919 + bins)
    x = rng.uniform(-3, bins + 3, n).astype(np.float32)
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, -0.5, bins - 0.001,
                         bins, 1e9], np.float32)
    x[:len(specials)] = specials[:n]
    return x


@functools.lru_cache(maxsize=None)
def _pallas(n, bins):
    if n == 0:
        return np.zeros(bins, np.int32)
    x = _values(n, bins)
    shape = (1536, 1536) if n == 1536 * 1536 else (1, n)
    return np.asarray(rops.value_histogram(jnp.asarray(x.reshape(shape)),
                                           num_bins=bins))


@functools.lru_cache(maxsize=None)
def _jax_ref(n, bins):
    return np.asarray(rref.value_histogram_ref(jnp.asarray(_values(n, bins)),
                                               bins))


def _bincount(n, bins):
    x = _values(n, bins).astype(np.float64)
    x = x[np.isfinite(x) & (x >= 0) & (x < bins)]
    return np.bincount(np.floor(x).astype(np.int64),
                       minlength=bins).astype(np.int32)


def _view(x, offset):
    """``x`` as the contiguous view ``buf[offset:offset + n]`` of a buffer
    that starts on a 16-byte boundary, so the view is misaligned by
    ``4 offset`` bytes."""
    buf = torch.full((x.size + 4,), float("nan"))
    assert buf.data_ptr() % 16 == 0
    view = buf[offset:offset + x.size]
    view.copy_(torch.from_numpy(x))
    assert view.is_contiguous()
    assert x.size == 0 or view.data_ptr() % 16 == 4 * offset % 16
    return view


def _check_model(n, bins, offset, want):
    view = _view(_values(n, bins), offset)
    planned = H._hist_plan(n, H100_SMS)
    for blocks in sorted({planned, 3}):
        got = H._value_histogram_blocked_ref(view, bins, blocks)
        assert got.dtype == torch.int32 and got.shape == (bins,)
        np.testing.assert_array_equal(got.numpy(), want)  # integer: bit-equal
    return view


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("bins", [1, 65])
def test_blocked_model_matches_pallas(bins, n, offset):
    view = _check_model(n, bins, offset, _pallas(n, bins))
    np.testing.assert_array_equal(H.value_histogram(view, bins).numpy(),
                                  _pallas(n, bins))


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("bins", [4096, H.MAX_BINS])
def test_blocked_model_matches_bincount_at_many_bins(bins, n, offset):
    want = _jax_ref(n, bins)
    np.testing.assert_array_equal(want, _bincount(n, bins))
    view = _check_model(n, bins, offset, want)
    np.testing.assert_array_equal(H.value_histogram(view, bins).numpy(), want)
    if n > 100_000:  # values reach every bin
        assert (want > 0).all()


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("n", [1, 3, 5, 7, 8, 9])
def test_blocked_model_counts_each_value_once(n, offset):
    """Head, body split over 1, 2 or 5 blocks (some empty) and tail cover
    the input once: each value in its own bin is counted exactly once."""
    view = _view(np.arange(n, dtype=np.float32), offset)
    for blocks in (1, 2, 5):
        got = H._value_histogram_blocked_ref(view, n, blocks)
        np.testing.assert_array_equal(got.numpy(), np.ones(n, np.int32))


@pytest.mark.parametrize("bins", [1, 65, 768, 769, 4096, H.MAX_BINS])
def test_one_shared_histogram_serves_every_bin_count(bins):
    """One path for every bin count: the grid depends on the length and the
    SM count only, and the model at that grid, on 1, 66 and 132 SMs, and
    the CPU wrapper equal the JAX package's plain version."""
    n = 1536 * 4 + 3
    want = _jax_ref(n, bins)
    view = _view(_values(n, bins), 1)
    for sms in (1, 66, 132):
        got = H._value_histogram_blocked_ref(view, bins, H._hist_plan(n, sms))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(H.value_histogram(view, bins).numpy(), want)


@pytest.mark.parametrize("n, sms, blocks", [
    (1536 * 1536, 132, 132),       # the main path: one block a SM
    (1536 * 1536, 114, 114),       # an H100 PCIe
    (4096 * 4096, 132, 264),       # two a SM: each thread still makes 2 trips
    (2048 * 4 * 4 * 132, 132, 264),      # exactly 2 trips at two a SM
    (2048 * 4 * 4 * 132 - 4, 132, 132),  # one float4 short of it
    (1023, 132, 1), (5, 132, 1), (3, 132, 1), (1, 132, 1),
    (2048 * 4 * 10, 132, 10),  # one full trip of UNROLL float4s a thread
])
def test_plan_grid(n, sms, blocks):
    assert H._hist_plan(n, sms) == blocks


def test_plan_grid_stays_in_one_wave_and_bounds_the_partials():
    """One wave, each block with a full trip but the last, and so at most
    ``BLOCKS_PER_SM x sms x num_bins`` global atomics into the
    accumulator."""
    for n in (1, 4, 999, 2 ** 16, 1536 * 1536, 4096 * 4096):
        for sms in (1, 8, 132):
            blocks = H._hist_plan(n, sms)
            trip = H.THREADS * H.UNROLL * 4  # elements
            assert 1 <= blocks <= H.BLOCKS_PER_SM * sms
            assert blocks <= sms or blocks * trip * H.TRIPS_PER_BLOCK <= n
            assert (blocks - 1) * trip < n


def test_source_constants_match_the_host_rule():
    """The grid rule reads the kernel's block size and loads in flight."""
    src = (pathlib.Path(H.__file__).parent / "csrc" / "seghist.cu").read_text()
    consts = dict(re.findall(r"constexpr int (THREADS|UNROLL) = (\d+);", src))
    assert int(consts["THREADS"]) == H.THREADS
    assert int(consts["UNROLL"]) == H.UNROLL
    assert H.MAX_BINS * 4 == 48 * 1024


def test_cpu_wrapper_returns_zeros_for_an_empty_input():
    got = H.value_histogram(torch.empty(0), 65)
    assert got.dtype == torch.int32 and not got.any() and got.shape == (65,)

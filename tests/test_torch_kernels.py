"""repro_torch.kernels vs the JAX package's Pallas kernels, on the CPU.

The port's plain versions (what its wrappers run for CPU tensors) are held
bit-equal to the Pallas kernels run in interpret mode: inputs are
integer-valued fp32 made from a seeded numpy generator, so every product is
exact below 2**24 and summation order cannot matter. The CUDA kernels
themselves build and run only on the card (``chip_smoke.py`` holds them to
these plain versions there).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as rops
from repro.kernels.semiring import (COUNTING, frontier_step_batched_pallas,
                                    frontier_step_pallas,
                                    semiring_matmul_batched_pallas,
                                    semiring_matmul_pallas)
from repro_torch.kernels import build
from repro_torch.kernels import semiring as S


def _counts(rng, shape, hi=4, density=0.3):
    x = rng.integers(1, hi, shape).astype(np.float32)
    return np.where(rng.random(shape) < density, x, np.float32(0))


def _dist(rng, shape):
    d = rng.integers(0, 5, shape).astype(np.float32)
    return np.where(rng.random(shape) < 0.5, np.float32(np.inf), d)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(autouse=True)
def _fresh_counters():
    S.reset_launches()
    yield
    # every call in this file runs on CPU tensors: no kernel may launch
    assert S.launches == {"frontier_step": 0, "count_matmul": 0}


@pytest.mark.parametrize("batched", [False, True])
def test_frontier_step_matches_pallas(batched):
    rng = np.random.default_rng(0)
    lead = (2,) if batched else ()
    f = _counts(rng, lead + (256, 128))
    a = (rng.random(lead + (128, 256)) < 0.2).astype(np.float32)
    d = _dist(rng, lead + (256, 256))
    pallas = frontier_step_batched_pallas if batched else frontier_step_pallas
    want = np.asarray(pallas(jnp.asarray(f), jnp.asarray(a), jnp.asarray(d),
                             interpret=True))
    got = S.frontier_step(_t(f), _t(a), _t(d)).numpy()
    np.testing.assert_array_equal(got, want)  # tolerance: bit-equal
    np.testing.assert_array_equal(S.frontier_step_ref(_t(f), _t(a), _t(d)),
                                  want)
    assert (want > 0).any() and (want == 0).any()


@pytest.mark.parametrize("batched", [False, True])
def test_count_matmul_matches_pallas(batched):
    rng = np.random.default_rng(1)
    lead = (3,) if batched else ()
    a = _counts(rng, lead + (128, 256), hi=9, density=0.6)
    b = _counts(rng, lead + (256, 128), hi=9, density=0.6)
    mm = semiring_matmul_batched_pallas if batched else semiring_matmul_pallas
    (want,) = mm(COUNTING, (jnp.asarray(a),), (jnp.asarray(b),),
                 interpret=True)
    want = np.asarray(want)
    ref = S.batched_count_matmul_ref if batched else S.count_matmul_ref
    np.testing.assert_array_equal(ref(_t(a), _t(b)).numpy(), want)
    np.testing.assert_array_equal(S.count_matmul(_t(a), _t(b)).numpy(), want)


def test_count_matmul_takes_a_transposed_view():
    """The ECMP loop's first product reads the level mask transposed; the
    wrapper takes the strided view as it is (no copy) and agrees."""
    rng = np.random.default_rng(2)
    f_a = _counts(rng, (2, 128, 128), hi=7, density=0.5)
    z = _counts(rng, (2, 128, 128), hi=7, density=0.5)
    view = _t(f_a).transpose(-1, -2)
    assert not view.is_contiguous()
    (want,) = semiring_matmul_batched_pallas(
        COUNTING, (jnp.swapaxes(jnp.asarray(f_a), -1, -2),),
        (jnp.asarray(z),), interpret=True)
    np.testing.assert_array_equal(S.count_matmul(view, _t(z)).numpy(),
                                  np.asarray(want))


def test_ragged_shapes_match_padding_ops():
    """Shapes off the 128 tile: the JAX ops pad to blocks and slice back;
    the port's wrappers take the shapes as they are."""
    rng = np.random.default_rng(3)
    f = _counts(rng, (3, 200, 72))
    a = (rng.random((3, 72, 136)) < 0.3).astype(np.float32)
    d = _dist(rng, (3, 200, 136))
    want = np.asarray(rops.batched_frontier_step(
        jnp.asarray(f), jnp.asarray(a), jnp.asarray(d)))
    np.testing.assert_array_equal(
        S.frontier_step(_t(f), _t(a), _t(d)).numpy(), want)
    want2d = np.asarray(rops.frontier_step(
        jnp.asarray(f[0]), jnp.asarray(a[0]), jnp.asarray(d[0])))
    np.testing.assert_array_equal(
        S.frontier_step(_t(f[0]), _t(a[0]), _t(d[0])).numpy(), want2d)
    b = _counts(rng, (3, 72, 136), hi=9, density=0.7)
    want = np.asarray(rops.batched_count_matmul(jnp.asarray(f),
                                                jnp.asarray(b)))
    np.testing.assert_array_equal(S.count_matmul(_t(f), _t(b)).numpy(), want)


def test_use_kernel_false_runs_the_plain_version():
    rng = np.random.default_rng(4)
    f, a = _counts(rng, (64, 32)), _counts(rng, (32, 48))
    d = _dist(rng, (64, 48))
    np.testing.assert_array_equal(
        S.frontier_step(_t(f), _t(a), _t(d), use_kernel=False),
        S.frontier_step_ref(_t(f), _t(a), _t(d)))
    np.testing.assert_array_equal(S.count_matmul(_t(f), _t(a),
                                                 use_kernel=False),
                                  S.count_matmul_ref(_t(f), _t(a)))


def test_wrappers_refuse_other_devices_and_mixed_operands():
    meta = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        S.count_matmul(meta, meta)
    with pytest.raises(ValueError, match="different devices"):
        S.count_matmul(torch.zeros(4, 4), meta)


def test_build_targets_hopper_without_fast_math(tmp_path):
    cmd = build.nvcc_command(tmp_path / "k.cu", tmp_path / "k.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert set(build.SOURCES.values()) == {"semiring.cu"}
    assert (build.CSRC / "semiring.cu").is_file()
    assert build._target("semiring").name.startswith("libsemiring_")


def test_find_nvcc_raises_without_a_toolkit(monkeypatch):
    monkeypatch.setattr(build.os, "access", lambda *a: False)
    monkeypatch.setattr(build.shutil, "which", lambda *a: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()

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
from repro.kernels.minplus import minplus_matmul_pallas
from repro.kernels.seghist import value_histogram_pallas
from repro.kernels.semiring import (COUNTING, TROPICAL_COUNT,
                                    frontier_step_batched_pallas,
                                    frontier_step_packed_batched_pallas,
                                    frontier_step_packed_pallas,
                                    frontier_step_pallas,
                                    semiring_matmul_batched_pallas,
                                    semiring_matmul_pallas)
from repro_torch.kernels import build
from repro_torch.kernels import seghist as H
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
    assert not any(S.launches.values()), S.launches


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
    assert set(build.SOURCES.values()) == {"semiring.cu", "tropical.cu",
                                           "seghist.cu", "packed.cu"}
    for name, src in build.SOURCES.items():
        assert (build.CSRC / src).is_file()
        assert build._target(name).name.startswith(f"lib{name}_")


def test_find_nvcc_raises_without_a_toolkit(monkeypatch):
    monkeypatch.setattr(build.os, "access", lambda *a: False)
    monkeypatch.setattr(build.shutil, "which", lambda *a: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


# -- the tropical and histogram kernels' plain versions ------------------------

def _lengths(rng, shape, hi=50, p_inf=0.3):
    """Integer-valued distances with +inf holes (no NaN: not a distance)."""
    d = rng.integers(0, hi, shape).astype(np.float32)
    return np.where(rng.random(shape) < p_inf, np.float32(np.inf), d)


def test_minplus_matches_pallas():
    rng = np.random.default_rng(5)
    a, b = _lengths(rng, (128, 256)), _lengths(rng, (256, 128))
    a[:2] = np.inf  # unreached rows stay unreached
    want = np.asarray(minplus_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                            interpret=True))
    got = S.minplus_matmul(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)  # tolerance: bit-equal
    np.testing.assert_array_equal(S.minplus_matmul_ref(_t(a), _t(b)), want)
    assert np.isinf(want).any() and np.isfinite(want).any()


@pytest.mark.parametrize("m,n,k", [(200, 136, 72), (33, 65, 1), (7, 1, 300)])
def test_minplus_ragged_matches_padding_ops(m, n, k):
    """The JAX op pads with +inf to its blocks; the port takes the shapes as
    they are. A fully +inf row stays +inf."""
    rng = np.random.default_rng(m)
    a, b = _lengths(rng, (m, k)), _lengths(rng, (k, n))
    a[0] = np.inf
    want = np.asarray(rops.minplus_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = S.minplus_matmul(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[0]).all()


def test_minplus_changed_flag():
    """The fused convergence flag: 0 exactly when the product equals the
    matrix it is compared with."""
    rng = np.random.default_rng(6)
    d = _lengths(rng, (96, 96), hi=9)
    np.fill_diagonal(d, 0.0)
    x = _t(d)
    out, changed = S.minplus_matmul(x, x, compare=x)
    assert changed.dtype == torch.int32 and changed.shape == (1,)
    assert int(changed) == int(not torch.equal(out, x)) == 1
    while int(changed):
        x = out
        out, changed = S.minplus_matmul(x, x, compare=x)
    np.testing.assert_array_equal(out, x)


def _pairs(rng, shape, p_inf=0.3):
    d = _lengths(rng, shape, hi=4, p_inf=p_inf)
    c = np.where(np.isfinite(d), rng.integers(1, 4, shape), 0)
    return d, c.astype(np.float32)


@pytest.mark.parametrize("m,n,k", [(128, 128, 256), (200, 72, 136)])
def test_minplus_count_matches_pallas(m, n, k):
    """Small integer dists make many ties, so the count sums have many
    terms; they are exact below 2**24, hence bit-equal."""
    rng = np.random.default_rng(7)
    da, ca = _pairs(rng, (m, k))
    db, cb = _pairs(rng, (k, n))
    if m % 128 == 0 and n % 128 == 0 and k % 128 == 0:
        want = semiring_matmul_pallas(
            TROPICAL_COUNT, (jnp.asarray(da), jnp.asarray(ca)),
            (jnp.asarray(db), jnp.asarray(cb)), interpret=True)
    else:
        want = rops.minplus_count_matmul(*map(jnp.asarray, (da, ca, db, cb)))
    got = S.minplus_count_matmul(_t(da), _t(ca), _t(db), _t(cb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].max() > 3  # ties summed


def _hist_input(rng, shape, num_bins):
    x = rng.uniform(-3, num_bins + 3, shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:4] = [np.nan, np.inf, -np.inf, -0.0]
    flat[4:6] = [num_bins, num_bins - 0.5]
    return x


def test_value_histogram_matches_pallas():
    rng = np.random.default_rng(8)
    x = _hist_input(rng, (256, 512), 65)
    want = np.asarray(value_histogram_pallas(jnp.asarray(x), 65,
                                             interpret=True))
    got = H.value_histogram(_t(x), 65)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)  # integer: bit-equal
    np.testing.assert_array_equal(H.value_histogram_ref(_t(x), 65), want)
    assert got.sum() < x.size  # dropped values are not counted


@pytest.mark.parametrize("shape", [(300, 77), (5,), (1, 1)])
def test_value_histogram_any_shape_matches_padding_ops(shape):
    """The JAX op pads with -1 (dropped); the port takes any shape."""
    rng = np.random.default_rng(9)
    x = rng.uniform(-3, 68, shape).astype(np.float32)
    want = np.asarray(rops.value_histogram(jnp.asarray(x.reshape(
        x.shape[0], -1)), num_bins=65))
    np.testing.assert_array_equal(H.value_histogram(_t(x), 65).numpy(), want)


def test_value_histogram_refuses_bad_bins():
    with pytest.raises(ValueError, match="num_bins"):
        H.value_histogram(torch.zeros(4), 0)
    with pytest.raises(ValueError, match="num_bins"):
        H.value_histogram(torch.zeros(4), H.MAX_BINS + 1)


# -- the narrow-cell kernels -----------------------------------------------------

def _packed_inputs(rng, lead, m, n, k, big=False):
    """A packed frontier (counts, a share of them near MULT_SAT when
    ``big``, so sums pass 2**24 and clamp), a {0,1} uint8 adjacency and
    int16 distances, half unreached."""
    f = _counts(rng, lead + (m, k)).astype(np.int64)
    if big:
        f = np.where(rng.random(f.shape) < 0.05, S.MULT_SAT - f, f)
    a = (rng.random(lead + (k, n)) < 0.2).astype(np.uint8)
    d = rng.integers(0, 5, lead + (m, n)).astype(np.int16)
    d = np.where(rng.random(d.shape) < 0.5, np.int16(S.DIST_UNREACHED), d)
    return f, a, d


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("big", [False, True], ids=["exact", "saturating"])
def test_frontier_step_packed_matches_pallas(batched, big):
    """Bit-equal to the packed Pallas step on uint32 frontier cells; with
    frontier values near MULT_SAT the clamp is exercised."""
    rng = np.random.default_rng(5)
    lead = (2,) if batched else ()
    f, a, d = _packed_inputs(rng, lead, 128, 256, 128, big=big)
    pallas = (frontier_step_packed_batched_pallas if batched
              else frontier_step_packed_pallas)
    want = np.asarray(pallas(jnp.asarray(f.astype(np.uint32)),
                             jnp.asarray(a), jnp.asarray(d), interpret=True))
    ft = _t(f.astype(np.int32))
    got = S.frontier_step_packed(ft, _t(a), _t(d))
    assert got.dtype == S.MULT_DTYPE
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(
        S.frontier_step_packed_ref(ft, _t(a), _t(d)).numpy(),
        want.astype(np.int32))
    assert (want > 0).any() and (want == 0).any()
    assert (want == S.MULT_SAT).any() == big
    assert want.max() <= S.MULT_SAT


def test_frontier_step_packed_ragged_matches_padded_pallas():
    """Shapes off every tile (the source tile is 32 rows, widths ragged):
    the port takes them as they are; the Pallas step runs on the padded
    operands (phantom rows/cols zero, phantom dists unreached), sliced
    back."""
    rng = np.random.default_rng(6)
    m, n, k = 40, 136, 72
    f, a, d = _packed_inputs(rng, (3,), m, n, k)

    def pad(x, shape, fill):
        out = np.full(x.shape[:-2] + shape, fill, x.dtype)
        out[..., :x.shape[-2], :x.shape[-1]] = x
        return out

    fp = pad(f.astype(np.uint32), (128, 128), 0)
    ap = pad(a, (128, 256), 0)
    dp = pad(d, (128, 256), S.DIST_UNREACHED)
    want = np.asarray(frontier_step_packed_batched_pallas(
        jnp.asarray(fp), jnp.asarray(ap), jnp.asarray(dp),
        interpret=True))[:, :m, :n]
    got = S.frontier_step_packed(_t(f.astype(np.int32)), _t(a), _t(d))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    got2d = S.frontier_step_packed(_t(f[0].astype(np.int32)), _t(a[0]),
                                   _t(d[0]))
    np.testing.assert_array_equal(got2d.numpy().astype(np.uint32), want[0])


@pytest.mark.parametrize("big", [False, True], ids=["exact", "saturating"])
def test_count_matmul_narrow_matches_pallas_on_a_strided_slab(big):
    """The streamed pump's panel product: an int32 frontier slab
    ``F[:, k0:k0+kp]`` (a strided view) against a uint8 panel, accumulated
    in fp32, against the COUNTING Pallas product on uint32 x uint8
    operands with ``out_dtype=f32``. Bit-equal below 2**24, where every
    partial sum is an exact integer; at or above it the sum depends on the
    order of the additions, so both sides are held to lie at or above
    2**24, which is all the pump's clamp at MULT_SAT reads."""
    rng = np.random.default_rng(7)
    f, a, _ = _packed_inputs(rng, (), 32, 384, 512, big=big)
    k0, kp = 128, 256
    panel = a[k0:k0 + kp]
    (want,) = semiring_matmul_pallas(
        COUNTING, (jnp.asarray(f[:, k0:k0 + kp].astype(np.uint32)),),
        (jnp.asarray(panel),), bm=32, interpret=True, out_dtype=jnp.float32)
    want = np.asarray(want)
    slab = _t(f.astype(np.int32))[:, k0:k0 + kp]
    assert not slab.is_contiguous()
    got = S.count_matmul(slab, _t(panel)).numpy()
    assert got.dtype == np.float32
    exact = want < S.MULT_SAT
    np.testing.assert_array_equal(got[exact], want[exact])
    assert (got[~exact] >= S.MULT_SAT).all()
    assert (~exact).any() == big


def test_narrow_wrappers_refuse_other_devices_and_dtypes():
    meta_f = torch.empty((4, 4), dtype=torch.int32, device="meta")
    meta_a = torch.empty((4, 4), dtype=torch.uint8, device="meta")
    meta_d = torch.empty((4, 4), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        S.frontier_step_packed(meta_f, meta_a, meta_d)
    with pytest.raises(ValueError, match="no kernel for device"):
        S.count_matmul(meta_f, meta_a)
    with pytest.raises(ValueError, match="different devices"):
        S.frontier_step_packed(torch.zeros(4, 4, dtype=torch.int32), meta_a,
                               meta_d)


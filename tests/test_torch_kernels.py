"""repro_torch.kernels vs the JAX package's Pallas kernels, on the CPU.

The port's plain versions (what its wrappers run for CPU tensors) are held
bit-equal to the Pallas kernels run in interpret mode: inputs are
integer-valued fp32 made from a seeded numpy generator, so every product is
exact below 2**24 and summation order cannot matter. The CUDA kernels
themselves build and run only on the card (``chip_smoke.py`` holds them to
these plain versions there).
"""
import shutil
import subprocess

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



# -- the int8 tensor-core GEMM of csrc/packed.cu: its limbs, folds and bytes -----

@pytest.mark.parametrize("value", [0, 255, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 7,
                                   2 ** 31 - 1])
def test_u8_limbs_add_back_to_f(value):
    """Four u8 limbs (bits 0-7, 8-15, 16-23, 24-31) add back to f bit for
    bit; MULT_SAT = 2**24 itself needs the fourth."""
    f = torch.tensor([[value, 0], [value // 3, 1]], dtype=torch.int32)
    limbs = S._u8_limbs(f)
    assert limbs.shape == (4, 2, 2) and int(limbs.max()) <= 255
    back = sum(limbs[l] << (8 * l) for l in range(4))
    assert torch.equal(back.to(torch.int32), f)
    if value >= 2 ** 24:
        assert int(limbs[3].max()) > 0


def _limbed_step(f, a, d):
    """The frontier epilogue of csrc/packed.cu over the limbed total."""
    x = S._limbed_u8_matmul_ref(f, a)
    new = (x > 0) & (d == S.DIST_UNREACHED)
    return torch.where(new, x.clamp(max=S.MULT_SAT), 0).to(S.MULT_DTYPE)


def _pad_to(x, mults, fill):
    shape = x.shape[:-2] + tuple(-(-s // q) * q
                                 for s, q in zip(x.shape[-2:], mults))
    out = np.full(shape, fill, x.dtype)
    out[..., :x.shape[-2], :x.shape[-1]] = x
    return out


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
@pytest.mark.parametrize("big", [False, True], ids=["exact", "saturating"])
def test_limbed_packed_step_matches_pallas(batched, big):
    """The limb emulation of csrc/packed.cu's step, bit-equal to
    frontier_step_packed_ref and to the packed Pallas step in interpret
    mode, exact and with sums past MULT_SAT."""
    rng = np.random.default_rng(30)
    lead = (2,) if batched else ()
    f, a, d = _packed_inputs(rng, lead, 128, 256, 128, big=big)
    pallas = (frontier_step_packed_batched_pallas if batched
              else frontier_step_packed_pallas)
    want = np.asarray(pallas(jnp.asarray(f.astype(np.uint32)),
                             jnp.asarray(a), jnp.asarray(d), interpret=True))
    ft = _t(f.astype(np.int32))
    got = _limbed_step(ft, _t(a), _t(d))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(
        got, S.frontier_step_packed_ref(ft, _t(a), _t(d)))
    assert (want == S.MULT_SAT).any() == big
    assert (S._limb_passes(ft) == (4 if big else 1)).all()


@pytest.mark.parametrize("b,m,n,k", [(3, 40, 136, 72), (2, 33, 65, 1),
                                     (1, 1, 1, 100), (2, 32, 137, 300)])
def test_limbed_packed_step_ragged_matches_padded_pallas(b, m, n, k):
    """At the ragged shapes of the card's checks: the limb emulation on the
    shapes as they are against the batched Pallas step on operands padded
    to its blocks (phantom rows/cols zero, phantom dists unreached), 2D and
    batched."""
    rng = np.random.default_rng(31 + k)
    f, a, d = _packed_inputs(rng, (b,), m, n, k, big=True)
    want = np.asarray(frontier_step_packed_batched_pallas(
        jnp.asarray(_pad_to(f.astype(np.uint32), (128, 128), 0)),
        jnp.asarray(_pad_to(a, (128, 128), 0)),
        jnp.asarray(_pad_to(d, (128, 128), S.DIST_UNREACHED)),
        interpret=True))[:, :m, :n].astype(np.int32)
    ft = _t(f.astype(np.int32))
    np.testing.assert_array_equal(_limbed_step(ft, _t(a), _t(d)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        _limbed_step(ft[0], _t(a[0]), _t(d[0])).numpy(), want[0])


@pytest.mark.parametrize("big", [False, True], ids=["exact", "saturating"])
def test_limbed_narrow_product_matches_pallas_on_a_strided_slab(big):
    """csrc/packed.cu's narrow product, emulated on the pump's strided
    frontier slab: bit-equal to count_matmul_ref and the COUNTING Pallas
    product below 2**24, at least 2**24 where they are."""
    rng = np.random.default_rng(32)
    f, a, _ = _packed_inputs(rng, (), 32, 384, 512, big=big)
    k0, kp = 128, 256
    panel = a[k0:k0 + kp]
    (want,) = semiring_matmul_pallas(
        COUNTING, (jnp.asarray(f[:, k0:k0 + kp].astype(np.uint32)),),
        (jnp.asarray(panel),), bm=32, interpret=True, out_dtype=jnp.float32)
    want = np.asarray(want)
    slab = _t(f.astype(np.int32))[:, k0:k0 + kp]
    assert not slab.is_contiguous()
    got = S._limbed_u8_matmul_ref(slab, _t(panel)).float().numpy()
    ref = S.count_matmul_ref(slab, _t(panel)).numpy()
    exact = want < S.MULT_SAT
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_array_equal(got[exact], ref[exact])
    assert (got[~exact] >= S.MULT_SAT).all() and (ref[~exact] >= S.MULT_SAT
                                                  ).all()
    assert (~exact).any() == big


def test_limb_sums_fold_before_int32_wraps():
    """A uint8 B of 192..255 against rows of 255s over 40,000 k: one
    limb's int32 sum passes 2**31 (past 33,025 k of 255 * 255). Summed in
    one int32
    register it wraps; folded every ``chunk`` k (the card folds every
    32,256) the total is the true sum, and the step clamps it at
    MULT_SAT. Small counts through many folds stay exact."""
    k = 40_000
    f = torch.full((2, k), 255, dtype=torch.int32)
    f[1] = 1
    b = torch.full((k, 3), 255, dtype=torch.uint8)
    b[:, 1] = 192 + torch.arange(k) % 64
    true = f.long() @ b.long()
    assert true[0].min() > 2 ** 31
    wrapped = S._limbed_u8_matmul_ref(f, b, chunk=k)
    assert (wrapped[0] != true[0]).all() and (wrapped[0] < S.MULT_SAT).any()
    for chunk in (S._FOLD_K, 1024):
        folded = S._limbed_u8_matmul_ref(f, b, chunk=chunk)
        assert (folded[0] >= S.MULT_SAT).all()
        assert torch.equal(folded[1], true[1])  # below 2**24: exact
    d = torch.full((2, 3), S.DIST_UNREACHED, dtype=torch.int16)
    step = _limbed_step(f, b, d)
    assert torch.equal(step, S.frontier_step_packed_ref(f, b, d))
    assert (step[0] == S.MULT_SAT).all()
    rng = np.random.default_rng(33)
    small = _t(rng.integers(0, 3, (4, 5000)).astype(np.int32))
    b8 = _t(rng.integers(0, 256, (5000, 7)).astype(np.uint8))
    np.testing.assert_array_equal(
        S._limbed_u8_matmul_ref(small, b8, chunk=64).numpy(),
        (small.long() @ b8.long()).numpy())


def test_limb_passes_count_the_live_limbs_per_row_tile():
    f = torch.zeros((2, 70, 9), dtype=torch.int32)
    f[0, 3, 2] = 5
    f[1, 40, 1] = S.MULT_SAT + 3  # limbs 0 and 3
    f[1, 69, 0] = 300  # limbs 0 and 1
    f[1, 68, 4] = 70_000  # limb 2 too
    assert S._limb_passes(f).tolist() == [[1, 1, 1], [1, 2, 3]]


def test_packed_gemm_fits_one_block_per_sm():
    """The GEMM's four stages need the >48 KB attribute and fit one block
    of 512 threads per H100 SM (227 KB at most per block)."""
    assert 48 * 1024 < S._packed_smem_bytes() <= 227 * 1024


def test_byte_transpose_matches_numpy_on_the_host(tmp_path):
    """The kernel's 4 x 4 byte transpose (``__byte_perm``), built with g++
    against a host model of ``__byte_perm``, on random blocks."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    text = (build.CSRC / "packed.cu").read_text()
    block = text[text.index("// BEGIN transpose4x4"):
                 text.index("// END transpose4x4")]
    src = tmp_path / "transpose.cpp"
    src.write_text("""#include <cstdint>
#include <cstdio>
#define __device__
#define __forceinline__ inline
static unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
""" + block + """
int main() {
  unsigned x[4], y[4];
  while (std::scanf("%u %u %u %u", &x[0], &x[1], &x[2], &x[3]) == 4) {
    transpose4x4(x, y);
    std::printf("%u %u %u %u\\n", y[0], y[1], y[2], y[3]);
  }
}
""")
    exe = tmp_path / "transpose"
    built = subprocess.run(["g++", "-std=c++17", "-O1", "-o", str(exe),
                            str(src)], capture_output=True, text=True,
                           timeout=120)
    assert built.returncode == 0, built.stderr
    rng = np.random.default_rng(34)
    blocks = rng.integers(0, 256, (200, 4, 4), dtype=np.uint8)
    words = blocks.view("<u4").reshape(200, 4)  # row r: bytes (r, 0..3)
    out = subprocess.run([str(exe)], input="\n".join(
        " ".join(map(str, w)) for w in words), capture_output=True,
        text=True, timeout=60, check=True).stdout.split()
    got = np.array(out, dtype=np.uint64).astype(np.uint32).reshape(200, 4)
    want = np.ascontiguousarray(blocks.transpose(0, 2, 1)).view(
        "<u4").reshape(200, 4)
    np.testing.assert_array_equal(got, want)


# -- the counting tiles: the tensor-core tile's limbs and product -------------------

def _bits(x):
    return torch.as_tensor(x, dtype=torch.float32).view(torch.int32)


_LIMB_CASES = {
    "integers": np.concatenate([np.arange(0, 300), 2.0 ** np.arange(0, 41),
                                2.0 ** np.arange(1, 41) - 1,
                                [2 ** 24 - 1, 2 ** 24 + 2, 16_777_215 * 3]]),
    "non_integers": np.concatenate([
        np.random.default_rng(20).random(500) * 10.0 ** np.random.default_rng(
            21).integers(-30, 30, 500), [0.1, 1 / 3, np.pi, -2.5e-7]]),
    "zeros": np.array([0.0, -0.0]),
    "subnormals": np.array([2.0 ** -149, 2.0 ** -130, -2.0 ** -127, 1e-40,
                            -3e-39, 2.0 ** -126 * (1 - 2.0 ** -23)]),
    "small_normals": np.array([2.0 ** -110, 2.0 ** -126, 1.5e-33,
                               -2.0 ** -100 * 1.2345]),
    "non_finite": np.array([np.inf, -np.inf, np.nan]),
}


@pytest.mark.parametrize("case", list(_LIMB_CASES))
def test_bf16_limbs_sum_to_x_bit_for_bit(case):
    """hi + mid + lo == x bit for bit for every finite x (both signs,
    -0.0 too); each limb is exact in bf16 where |x| >= 2**-110 (and at
    0); below that only lo can hold bits under 2**-133; a non-finite x
    splits as (x, 0, 0)."""
    v = _LIMB_CASES[case]
    x = torch.from_numpy(np.concatenate([v, -v]).astype(np.float32))
    hi, mid, lo = S._split_bf16_limbs(x)
    finite = torch.isfinite(x)
    assert torch.equal(_bits(hi + mid + lo)[finite], _bits(x)[finite])
    exact = finite & ((x.abs() >= 2.0 ** -110) | (x == 0))
    for limb in (hi, mid, lo):
        back = limb.to(torch.bfloat16).float()
        assert torch.equal(_bits(back)[exact], _bits(limb)[exact])
    for limb in (hi, mid):  # cleared low bits: always bf16
        assert torch.equal(_bits(limb)[finite] & 0xFFFF,
                           torch.zeros_like(_bits(limb)[finite]))
    if case == "subnormals":
        assert not torch.equal(_bits(lo) & 0xFFFF, torch.zeros_like(_bits(lo)))
    if case == "non_finite":
        assert torch.equal(torch.isnan(hi), torch.isnan(x))
        assert torch.equal(hi[~torch.isnan(x)], x[~torch.isnan(x)])
        assert not mid.any() and not lo.any()
    if case == "integers":  # three 8-bit limbs: integers up to 2**24 need
        big = x.abs() < 2 ** 24  # no lo below 1, and hi carries the top
        assert torch.equal(hi[x.abs() < 256], x[x.abs() < 256])
        assert torch.equal(torch.frac(lo[big]), torch.zeros_like(lo[big]))


def _near_limit_counts(rng, lead, m, k):
    """Integer counts whose products against a dense {0,1} adjacency sum to
    [2**23, 2**24): values below 2**24 / k, one row a single 2**24 - 1."""
    f = rng.integers(2 ** 23 // k, 2 ** 24 // k, lead + (m, k))
    f[..., 0, :] = 0
    f[..., 0, 3] = 2 ** 24 - 1
    return f.astype(np.float32)


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
def test_limbed_product_is_bit_equal_near_two_to_the_24(batched):
    """The tensor-core tile's sum (three exact limb products per 16-deep k
    step, the step added in fp32) against count_matmul_ref and JAX's
    COUNTING kernel in interpret mode: bit-equal, with sums up to
    2**24 - 1."""
    rng = np.random.default_rng(22)
    lead = (2,) if batched else ()
    m, n, k = 128, 128, 128
    f = _near_limit_counts(rng, lead, m, k)
    a = (rng.random(lead + (k, n)) < 0.9).astype(np.float32)
    got = S._limbed_matmul_ref(_t(f), _t(a)).numpy()
    ref = S.batched_count_matmul_ref if batched else S.count_matmul_ref
    mm = semiring_matmul_batched_pallas if batched else semiring_matmul_pallas
    (want,) = mm(COUNTING, (jnp.asarray(f),), (jnp.asarray(a),),
                 interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))  # bit-equal
    np.testing.assert_array_equal(got, ref(_t(f), _t(a)).numpy())
    assert got.max() == 2 ** 24 - 1 and (got >= 2 ** 23).mean() > 0.5


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
def test_limbed_frontier_step_matches_pallas(batched):
    """The frontier epilogue over the limbed sum, against JAX's
    frontier_step kernel in interpret mode: bit-equal."""
    rng = np.random.default_rng(23)
    lead = (2,) if batched else ()
    f = _near_limit_counts(rng, lead, 128, 128)
    f[rng.random(f.shape) < 0.1] = 0
    a = (rng.random(lead + (128, 256)) < 0.9).astype(np.float32)
    d = _dist(rng, lead + (128, 256))
    x = S._limbed_matmul_ref(_t(f), _t(a))
    got = torch.where((x > 0) & (_t(d) == float("inf")), x, 0.0).numpy()
    pallas = frontier_step_batched_pallas if batched else frontier_step_pallas
    want = np.asarray(pallas(jnp.asarray(f), jnp.asarray(a), jnp.asarray(d),
                             interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, S.frontier_step_ref(_t(f), _t(a), _t(d)).numpy())
    assert (want >= 2 ** 23).any() and (want == 0).any()


def _layout_cases():
    """(view, b, expected loader): the callers' views and the edges of the
    16-byte paths."""
    def t(*shape):
        return torch.zeros(shape)

    z = t(2, 64, 64)
    return {
        "frontier F (B, p, p)": (z, t(2, 64, 64), S._ROW_MAJOR),
        "Z in Z x A": (z[0], t(64, 64), S._ROW_MAJOR),
        "F_a^T (stacked transpose)": (z.transpose(-1, -2), t(2, 64, 64),
                                      S._COL_MAJOR),
        "2D transpose": (t(16, 8).T, t(16, 12), S._COL_MAJOR),
        "aligned column slab": (t(8, 20)[:, 4:20], t(16, 12), S._ROW_MAJOR),
        "misaligned column slab": (t(8, 20)[:, 1:17], t(16, 12), S._STRIDED),
        "K not a multiple of 4": (t(8, 10), t(10, 12), S._STRIDED),
        "N not a multiple of 4": (t(8, 16), t(16, 10), S._STRIDED),
        "every other column": (t(8, 32)[:, ::2], t(16, 12), S._STRIDED),
        "M not a multiple of 4 (transposed)": (t(16, 6).T, t(16, 12),
                                               S._STRIDED),
        "one row": (t(1, 16), t(16, 12), S._ROW_MAJOR),
    }


@pytest.mark.parametrize("case", list(_layout_cases()))
def test_a_layout_picks_the_loader_for_each_view(case):
    a, b, want = _layout_cases()[case]
    assert S._a_layout(a, b) == want
    # every layout's plain version gives the same product
    np.testing.assert_array_equal(S.count_matmul(a, b).numpy(),
                                  S.count_matmul_ref(a.contiguous(), b))


def _routing_cases():
    """(right operand, whether it takes the SIMT tile)."""
    rng = np.random.default_rng(24)
    adj = (rng.random((64, 64)) < 0.1).astype(np.float32)

    def with_cell(value):
        b = adj.copy()
        b[5, 7] = value
        return b

    return {
        "{0,1} adjacency": (adj, False),
        "bf16-exact integers": (rng.integers(0, 256, (64, 64)) * 2.0 ** 8,
                                False),
        "-0.0": (with_cell(-0.0), False),
        "1 + 2**-10": (with_cell(1 + 2.0 ** -10), True),
        "+inf": (with_cell(np.inf), True),
        "-inf": (with_cell(-np.inf), True),
        "NaN": (with_cell(np.nan), True),
        "float z": (rng.random((64, 64)) * (rng.random((64, 64)) < 0.25),
                    True),
    }


@pytest.mark.parametrize("case", list(_routing_cases()))
def test_right_operand_picks_the_tile(case):
    """A right operand that is not exact in bf16, or not finite, takes the
    SIMT tile. On the tensor-core tile a non-finite value would meet x's
    zero limbs (0 * inf = NaN) where fmaf and the plain version give inf."""
    b, want = _routing_cases()[case]
    b = _t(np.asarray(b, np.float32))
    assert S._takes_simt_tile(b) == want
    f = torch.full((4, 64), 3.0)
    if case in ("+inf", "-inf"):
        ref = S.count_matmul_ref(f, b)
        assert torch.isinf(ref[:, 7]).all()
        assert torch.isnan(S._limbed_matmul_ref(f, b)[:, 7]).all()
    elif not want:
        assert torch.equal(S._limbed_matmul_ref(f, b),
                           S.count_matmul_ref(f, b))


def test_counting_tiles_fit_two_blocks_per_sm():
    """Each tile's dynamic shared memory, for every layout, leaves room for
    two blocks of 256 threads on one H100 SM (228 KiB, 1 KiB reserved per
    block; 227 KiB at most per block)."""
    sizes = S._counting_smem_bytes()
    assert set(sizes) == {"simt", "tensor"}
    for per_layout in sizes.values():
        assert set(per_layout) == {"row-major", "column-major", "strided"}
        for size in per_layout.values():
            assert 48 * 1024 < size and 2 * (size + 1024) <= 228 * 1024


def test_tile_launches_are_zero_without_a_card():
    S.reset_launches()
    counts = S.tile_launches()
    assert set(counts) == {"frontier_step", "count_matmul",
                           "reachability_step", "semiring_matmul",
                           "minplus_matmul", "batched_minplus_matmul",
                           "minplus_count_matmul", "semiring_matmul_vpu"}
    for name, c in counts.items():
        tiles = ({"small": 0, "large": 0, **{f"split{s}": 0
                                             for s in range(2, 9)}}
                 if "minplus" in name else {"small": 0, "large": 0}
                 if name == "semiring_matmul_vpu"
                 else {"simt": 0, "tensor": 0})
        assert c == tiles, name


# -- the min-plus tiles ----------------------------------------------------------

@pytest.mark.parametrize("batch, m, n, want", [
    (12, 2048, 2048, "large"),  # the sweep's stacked squaring
    (12, 600, 520, "large"),    # ragged, 300 large blocks
    (1, 2048, 2048, "large"),   # 256 large blocks, the threshold
    (1, 512, 512, "small"),     # the MWU oracle's 2D products
    (1, 384, 384, "small"),
    (3, 512, 512, "small"),
    (255, 128, 128, "small"),   # one block short of the threshold
    (256, 100, 1, "large"),
    (2, 33, 65, "small"),
])
def test_minplus_tile_follows_the_grid(batch, m, n, want):
    """The large min-plus tile runs where its grid has at least 256 blocks
    (about two per SM); p = 384..512 2D products keep the small (split)
    tile. The tropical count product runs on the split tile and counts its
    launches per split like the min-plus products."""
    assert S._minplus_tile(batch, m, n) == want
    assert S._TILED["minplus_count_matmul"] == S._TILED["minplus_matmul"]


def test_minplus_large_tile_mirrors_the_source():
    """The host's mirror of the tile rule and the large tile's shared memory
    hold the constants of ``csrc/tropical.cu``; the tile fits two blocks
    per SM (228 KiB, 1 KiB reserved per block; 227 KiB at most per
    block)."""
    import re

    src = (build.CSRC / "tropical.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);",
                             src).group(1))

    assert const("LTILE") == S._MINPLUS_LARGE
    assert const("LBK") == S._MINPLUS_BK
    assert const("LSTAGES") == S._MINPLUS_STAGES
    assert const("LARGE_MIN_BLOCKS") == S._MINPLUS_LARGE_MIN_BLOCKS
    size = S._minplus_smem_bytes()
    assert size == 104_448
    assert 48 * 1024 < size <= 227 * 1024 and 2 * (size + 1024) <= 228 * 1024


@pytest.mark.parametrize("b,m,n,k", [(12, 600, 520, 300), (2, 200, 136, 72)])
def test_batched_minplus_on_either_tile_matches_padding_ops(b, m, n, k):
    """The stacked min-plus at a shape of each tile (the plain version, which
    both tiles equal bit for bit on the card) against the JAX op, which
    pads with +inf; NaN-free lengths, an all-inf row."""
    rng = np.random.default_rng(b * m)
    a, c = _lengths(rng, (b, m, k)), _lengths(rng, (b, k, n))
    a[:, 0] = np.inf
    want = np.asarray(rops.batched_minplus_matmul(jnp.asarray(a),
                                                  jnp.asarray(c)))
    got = S.batched_minplus_matmul(_t(a), _t(c)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[:, 0]).all() and np.isfinite(got).any()
    assert S._minplus_tile(b, m, n) == ("large" if b == 12 else "small")


# -- the counting tiles' store policies ------------------------------------------

_HARNESS_STORES = r"""
#include <cstdio>
#include "counting_tiles.cuh"
int main() {
  int s;
  std::scanf("%d", &s);
  for (int i = 0; i < s; ++i) {
    float acc, d, c[3];
    std::scanf("%a %a", &acc, &d);
    const counting_tiles::CountStore count{c};
    const counting_tiles::FrontierStore frontier{&d, c + 1};
    const counting_tiles::BooleanStore boolean{c + 2};
    count(0, acc);
    frontier(0, acc);
    boolean(0, acc);
    std::printf("%a %a %a\n", c[0], c[1], c[2]);
  }
}
"""


def test_store_policies_agree_with_the_plain_versions_on_the_host(tmp_path):
    """The three store policies of ``csrc/counting_tiles.cuh`` (what
    ``count_matmul``, ``frontier_step`` and ``reachability_step`` store for
    a sum), compiled as host C++, against the plain versions of a product
    whose sum is that value (x @ [[1]]): NaN-aware equality."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    inf = np.inf
    acc = np.array([0.0, -0.0, 0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 2.0 ** 24 - 1,
                    2.0 ** 24, -1.0, inf, -inf, np.nan, 7.0, 0.5],
                   np.float32)
    dist = np.array([inf, inf, inf, inf, 0.0, inf, 3.0, inf, inf, -inf, inf,
                     inf, inf, inf, np.nan, 1.0], np.float32)
    src = tmp_path / "stores.cpp"
    exe = tmp_path / "stores"
    src.write_text(_HARNESS_STORES)
    built = subprocess.run(["g++", "-std=c++17", "-O1", "-I", str(build.CSRC),
                            "-o", str(exe), str(src)],
                           capture_output=True, text=True, timeout=120)
    assert built.returncode == 0, built.stderr
    stdin = " ".join([str(len(acc))] + [float(x).hex() for pair in
                                        zip(acc, dist) for x in pair])
    out = subprocess.run([str(exe)], input=stdin, capture_output=True,
                         text=True, timeout=60, check=True).stdout.split()
    got = np.array([float.fromhex(w) for w in out],
                   np.float32).reshape(-1, 3)
    x, d, one = _t(acc)[:, None], _t(dist)[:, None], torch.ones(1, 1)
    want = [S.count_matmul_ref(x, one), S.frontier_step_ref(x, one, d),
            S.reachability_step_ref(x, one)]
    for col, w in enumerate(want):
        np.testing.assert_array_equal(got[:, col], w[:, 0].numpy())

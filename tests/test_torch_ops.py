"""repro_torch.kernels.ops vs the JAX package's repro.kernels.ops, on the CPU.

Every op of the port's library surface runs on CPU tensors (its kernel's
plain version) and is held to the JAX op run through the Pallas kernels in
interpret mode, over the JAX kernel tests' shapes (m, k, n). Inputs come
from a seeded numpy generator: integer-valued counts, {0,1} masks and
integer distances with +inf holes, so every product is exact and the
tolerance is bit-equal throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import semiring as S

SHAPES = [(128, 128, 128), (256, 128, 384), (100, 200, 60), (33, 17, 129)]
UNREACHED = S.DIST_UNREACHED


def _counts(rng, shape, hi=4, density=0.3):
    x = rng.integers(1, hi, shape).astype(np.float32)
    return np.where(rng.random(shape) < density, x, np.float32(0))


def _mask(rng, shape, density=0.1):
    return (rng.random(shape) < density).astype(np.float32)


def _dist(rng, shape, hi=5, p_inf=0.3):
    d = rng.integers(0, hi, shape).astype(np.float32)
    return np.where(rng.random(shape) < p_inf, np.float32(np.inf), d)


def _packed(rng, shape_f, shape_a, shape_d):
    f = _counts(rng, shape_f).astype(np.uint32)
    a = _mask(rng, shape_a, 0.2).astype(np.uint8)
    d = rng.integers(0, 5, shape_d).astype(np.int16)
    return f, a, np.where(rng.random(shape_d) < 0.5, np.int16(UNREACHED), d)


def _inputs(name, rng, m, k, n, lead=()):
    """The op's operands as numpy arrays, shaped (lead.., m, k) x (lead..,
    k, n), plus the trailing non-tensor arguments."""
    mk, kn, mn = lead + (m, k), lead + (k, n), lead + (m, n)
    if name.endswith("minplus_matmul"):
        return (_dist(rng, mk, 50), _dist(rng, kn, 50)), ()
    if name == "reachability_step":
        return (_mask(rng, mk), _mask(rng, kn)), ()
    if name.endswith("count_matmul") and "minplus" not in name:
        return (_counts(rng, mk, 9, 0.6), _counts(rng, kn, 9, 0.6)), ()
    if name == "minplus_count_matmul":
        da, db = _dist(rng, mk), _dist(rng, kn)
        ca = np.where(np.isfinite(da), _counts(rng, mk, 4, 1.0), 0)
        cb = np.where(np.isfinite(db), _counts(rng, kn, 4, 1.0), 0)
        return (da, ca.astype(np.float32), db, cb.astype(np.float32)), ()
    if name.endswith("frontier_step"):
        return (_counts(rng, mk), _mask(rng, kn, 0.2), _dist(rng, mn)), ()
    if name.endswith("frontier_step_packed"):
        return _packed(rng, mk, kn, mn), ()
    if name == "value_histogram":
        x = rng.integers(-2, 70, (m, n)).astype(np.float32)
        return (np.where(rng.random((m, n)) < 0.1, np.float32(np.inf), x),), (
            65,)
    raise AssertionError(name)


def _np(out):
    return tuple(_np(o) for o in out) if isinstance(out, tuple) else (
        np.asarray(out))


def _run_both(name, arrays, extra):
    want = _np(getattr(rops, name)(*map(jnp.asarray, arrays), *extra))
    got = _np(getattr(ops, name)(*map(torch.from_numpy, arrays), *extra))
    return got, want


def _assert_equal(got, want, name):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _assert_equal(g, w, name)
        return
    if name.endswith("frontier_step_packed"):
        # the port's int32 cell holds the JAX package's uint32 values
        assert got.dtype == np.int32 and want.dtype == np.uint32
        got, want = got.astype(np.int64), want.astype(np.int64)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)  # tolerance: bit-equal


@pytest.fixture(autouse=True)
def _no_launches():
    S.reset_launches()
    yield
    # every call in this file runs on CPU tensors: no kernel may launch
    assert not any(S.launches.values()), S.launches


def test_names_match_the_jax_library():
    assert ops.__all__ == rops.__all__
    assert ref.__all__ == rref.__all__
    for name in rref.__all__:
        assert getattr(ops, name) is getattr(ref, name)


_TWO_D = ["minplus_matmul", "reachability_step", "count_matmul",
          "minplus_count_matmul", "frontier_step", "frontier_step_packed",
          "value_histogram"]
_STACKED = ["batched_minplus_matmul", "batched_count_matmul",
            "batched_frontier_step", "batched_frontier_step_packed"]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("name", _TWO_D + _STACKED)
def test_op_matches_jax(name, m, k, n):
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    lead = ((3,) if name == "batched_minplus_matmul" else (2,)) if (
        name in _STACKED) else ()
    arrays, extra = _inputs(name, rng, m, k, n, lead)
    got, want = _run_both(name, arrays, extra)
    _assert_equal(got, want, name)
    out = want[0] if isinstance(want, tuple) else want
    if name != "value_histogram":
        assert out.shape == lead + (m, n)


@pytest.mark.parametrize("m,k,n", SHAPES[2:])
def test_reachability_step_takes_a_stack(m, k, n):
    rng = np.random.default_rng(11)
    a, b = _mask(rng, (3, m, k)), _mask(rng, (3, k, n))
    got = ops.reachability_step(torch.from_numpy(a), torch.from_numpy(b))
    want = np.stack([np.asarray(rops.reachability_step(jnp.asarray(x),
                                                       jnp.asarray(y)))
                     for x, y in zip(a, b)])
    np.testing.assert_array_equal(got.numpy(), want)  # bit-equal
    assert 0 < want.sum() < want.size


def test_ops_cast_other_dtypes_as_the_jax_ops_do():
    """float64, int64 and bool operands (and a uint32 packed frontier)
    are cast as the JAX ops cast them."""
    rng = np.random.default_rng(12)
    m, k, n = 40, 24, 56
    cases = {
        "count_matmul": (_counts(rng, (m, k)).astype(np.int64),
                         _mask(rng, (k, n)).astype(bool)),
        "reachability_step": (_mask(rng, (m, k)).astype(bool),
                              _mask(rng, (k, n)).astype(np.float64)),
        "minplus_matmul": (_dist(rng, (m, k)).astype(np.float64),
                           _dist(rng, (k, n)).astype(np.float64)),
        "frontier_step": (_counts(rng, (m, k)).astype(np.int64),
                          _mask(rng, (k, n), 0.3).astype(bool),
                          _dist(rng, (m, n)).astype(np.float64)),
        "frontier_step_packed": (
            _counts(rng, (m, k)).astype(np.uint32),
            _mask(rng, (k, n), 0.3).astype(np.uint8),
            np.where(rng.random((m, n)) < 0.5, UNREACHED,
                     rng.integers(0, 5, (m, n))).astype(np.int64)),
        "value_histogram": (rng.integers(0, 9, (m, n)).astype(np.int64),),
    }
    for name, arrays in cases.items():
        extra = (8,) if name == "value_histogram" else ()
        got, want = _run_both(name, arrays, extra)
        _assert_equal(got, want, name)


@pytest.mark.parametrize("name", rref.__all__)
def test_ref_aliases_match_the_jax_oracles(name):
    rng = np.random.default_rng(13)
    op = name[:-len("_ref")]
    lead = (2,) if op.startswith("batched_") else ()
    arrays, extra = _inputs(op, rng, 48, 40, 36, lead)
    want = _np(getattr(rref, name)(*map(jnp.asarray, arrays), *extra))
    got = _np(getattr(ref, name)(*map(torch.from_numpy, arrays), *extra))
    _assert_equal(got, want, op)


def test_use_kernel_false_and_compare_flags():
    rng = np.random.default_rng(14)
    a, b = (torch.from_numpy(_dist(rng, (2, 30, 30), 50)) for _ in range(2))
    out = ops.batched_minplus_matmul(a, b, use_kernel=False)
    torch.testing.assert_close(out, ops.batched_minplus_matmul_ref(a, b),
                               rtol=0, atol=0)
    same, changed = ops.batched_minplus_matmul(a, b, compare=out)
    assert torch.equal(same, out) and int(changed) == 0
    _, changed = ops.batched_minplus_matmul(a, b, compare=a)
    assert int(changed) == 1


def test_ops_refuse_mixed_devices_and_flat_stacks():
    meta = torch.empty((4, 4), device="meta")
    cpu = torch.zeros(4, 4)
    for name in ("reachability_step", "count_matmul", "minplus_matmul"):
        with pytest.raises(ValueError, match="different devices"):
            getattr(ops, name)(cpu, meta)
    with pytest.raises(ValueError, match="different devices"):
        ops.batched_minplus_matmul(cpu[None], meta[None])
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.reachability_step(meta, meta)
    with pytest.raises(ValueError, match="stacks"):
        ops.batched_minplus_matmul(cpu, cpu)

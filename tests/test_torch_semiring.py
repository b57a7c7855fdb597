"""The port's Semiring extension point vs the JAX package's, on the CPU.

``repro_torch.kernels.semiring.semiring_matmul`` / ``_batched`` on CPU
tensors (their plain versions) are held to ``semiring_matmul_pallas`` /
``semiring_matmul_batched_pallas`` run in interpret mode, for the four
shipped specs, the JAX test's max-plus algebra, the max-min (bottleneck)
algebra and MXU-path algebras with narrow operands. Inputs come from a
seeded numpy generator. Tolerances: bit-equal for min/max algebras (exact
in any order) and for integer-valued sums (exact below 2**24 in any order);
float sums of k nonnegative terms within rtol k * 2**-24, the bound on the
rounding of a k-term sum, since the two packages add in different orders.

The generated CUDA source builds only on the card (``chip_smoke.py`` phase
9 holds the kernel to these plain versions and to the specialized
kernels); here each spec's algebra struct is compiled as host C++ and its
combine / accumulate / epilogue run against the torch callables.
"""
import dataclasses
import shutil
import subprocess
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import semiring as J
from repro_torch import kernels as K
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import semiring as S

_INF = float("inf")

# the JAX test's max-plus algebra (tests/test_semiring.py) and the max-min
# (bottleneck, widest-path) algebra, in both packages
J_MAXPLUS = J.Semiring(
    name="maxplus", pad_a=(-_INF,), pad_b=(-_INF,), acc_init=(-_INF,),
    combine=lambda a, b: (a[0] + b[0],),
    kreduce=lambda f: (jnp.max(f[0], axis=1),),
    accumulate=lambda x, y: (jnp.maximum(x[0], y[0]),))
J_MAXMIN = J.Semiring(
    name="maxmin", pad_a=(-_INF,), pad_b=(-_INF,), acc_init=(-_INF,),
    combine=lambda a, b: (jnp.minimum(a[0], b[0]),),
    kreduce=lambda f: (jnp.max(f[0], axis=1),),
    accumulate=lambda x, y: (jnp.maximum(x[0], y[0]),))
J_TWO_WALKS = J.Semiring(
    name="two_walks", pad_a=(0.0,), pad_b=(0.0,), acc_init=(0.0,), mxu=True,
    epilogue=lambda acc: acc >= 2)

MAXPLUS = S.Semiring(
    name="maxplus", pad_a=(-_INF,), pad_b=(-_INF,), acc_init=(-_INF,),
    combine=lambda a, b: (a[0] + b[0],),
    kreduce=lambda f: (torch.amax(f[0], dim=1),),
    accumulate=lambda x, y: (torch.maximum(x[0], y[0]),),
    cuda_combine="out[0] = a[0] + b[0];",
    cuda_accumulate="acc[0] = fmaxf(acc[0], t[0]);")
MAXMIN = S.Semiring(
    name="maxmin", pad_a=(-_INF,), pad_b=(-_INF,), acc_init=(-_INF,),
    combine=lambda a, b: (torch.minimum(a[0], b[0]),),
    kreduce=lambda f: (torch.amax(f[0], dim=1),),
    accumulate=lambda x, y: (torch.maximum(x[0], y[0]),),
    cuda_combine="out[0] = fminf(a[0], b[0]);",
    cuda_accumulate="acc[0] = fmaxf(acc[0], t[0]);")
TWO_WALKS = S.Semiring(
    name="two_walks", pad_a=(0.0,), pad_b=(0.0,), acc_init=(0.0,), mxu=True,
    epilogue=lambda acc: acc >= 2, cuda_epilogue="acc >= 2.f")


# wide algebras (the generic VPU tile is sized by the field count): max-plus
# on every field of 3 or 8, in float32 (-inf pads) and int32 (pads -2**30,
# so pad + pad is -2**31 and nothing wraps), and a lexicographic one of 3
# fields, widest path, then fewest hops, then the number of such paths
def _fieldwise_maxplus(pkg, nf, integer):
    """Per-field max-plus of ``nf`` fields, in the JAX package (``pkg`` J)
    or the port (S, with device code)."""
    pad = -2.0 ** 30 if integer else -_INF
    init = -2.0 ** 31 if integer else -_INF
    np_ = jnp if pkg is J else torch
    kw = dict(name=f"maxplus{nf}{'_int' if integer else ''}", num_fields=nf,
              pad_a=(pad,) * nf, pad_b=(pad,) * nf, acc_init=(init,) * nf,
              combine=lambda a, b: tuple(x + y for x, y in zip(a, b)),
              kreduce=(lambda f: tuple(jnp.max(x, axis=1) for x in f))
              if pkg is J else
              (lambda f: tuple(torch.amax(x, dim=1) for x in f)),
              accumulate=lambda x, y: tuple(np_.maximum(p, q)
                                            for p, q in zip(x, y)))
    if pkg is S:
        kw.update(cuda_combine="for (int f = 0; f < NF; ++f) "
                               "out[f] = a[f] + b[f];",
                  cuda_accumulate="for (int f = 0; f < NF; ++f) "
                                  "acc[f] = sr_max(acc[f], t[f]);")
    return pkg.Semiring(**kw)


def _lex(pkg, integer):
    """(width, hops, count): the widest path, then the fewest hops, then the
    number of such paths; the pads never tie a real width."""
    np_ = jnp if pkg is J else torch
    w_pad, h_pad = (-2.0 ** 31, 2.0 ** 29) if integer else (-_INF, _INF)
    h_init = 2.0 ** 30 if integer else _INF

    def better(x, y):  # y beats x, and y ties x
        ties_w = y[0] == x[0]
        return ((y[0] > x[0]) | (ties_w & (y[1] < x[1])),
                ties_w & (y[1] == x[1]))

    def accumulate(x, y):
        win, tie = better(x, y)
        return (np_.where(win, y[0], x[0]), np_.where(win, y[1], x[1]),
                np_.where(win, y[2], np_.where(tie, x[2] + y[2], x[2])))

    def kreduce(f):
        w, h, c = f
        if pkg is J:
            wm = jnp.max(w, axis=1)
            on = w == wm[:, None, :]
            hm = jnp.min(jnp.where(on, h, jnp.asarray(h_init, h.dtype)),
                         axis=1)
            tie = on & (h == hm[:, None, :])
            return wm, hm, jnp.sum(jnp.where(tie, c, 0), axis=1, dtype=c.dtype)
        wm = torch.amax(w, dim=1)
        on = w == wm[:, None, :]
        hm = torch.amin(torch.where(on, h, torch.full_like(h, h_init)), dim=1)
        tie = on & (h == hm[:, None, :])
        return wm, hm, torch.where(tie, c, torch.zeros_like(c)).sum(
            dim=1, dtype=c.dtype)

    kw = dict(name="lex_int" if integer else "lex", num_fields=3,
              pad_a=(w_pad, h_pad, 0.0), pad_b=(w_pad, h_pad, 0.0),
              acc_init=(w_pad, h_init, 0.0),
              combine=lambda a, b: (np_.minimum(a[0], b[0]), a[1] + b[1],
                                    a[2] * b[2]),
              kreduce=kreduce, accumulate=accumulate)
    if pkg is S:
        kw.update(
            cuda_combine="out[0] = sr_min(a[0], b[0]); out[1] = a[1] + b[1];"
                         " out[2] = a[2] * b[2];",
            cuda_accumulate=(
                "const bool tw = t[0] == acc[0];\n"
                "    const bool win = t[0] > acc[0] || (tw && t[1] < acc[1]);\n"
                "    const bool tie = tw && t[1] == acc[1];\n"
                "    acc[2] = win ? t[2] : tie ? acc[2] + t[2] : acc[2];\n"
                "    acc[0] = win ? t[0] : acc[0];\n"
                "    acc[1] = win ? t[1] : acc[1];"))
    return pkg.Semiring(**kw)


#: (name, dtype) -> (port spec, JAX spec) of the wide algebras
WIDE = {**{(f"maxplus{nf}", dt): (_fieldwise_maxplus(S, nf, dt == "int32"),
                                   _fieldwise_maxplus(J, nf, dt == "int32"))
           for nf in (3, 8) for dt in ("float32", "int32")},
        **{("lex", dt): (_lex(S, dt == "int32"), _lex(J, dt == "int32"))
           for dt in ("float32", "int32")}}

#: name -> (port spec, JAX spec)
SPECS = {
    "tropical": (S.TROPICAL, J.TROPICAL),
    "boolean": (S.BOOLEAN, J.BOOLEAN),
    "counting": (S.COUNTING, J.COUNTING),
    "tropical_count": (S.TROPICAL_COUNT, J.TROPICAL_COUNT),
    "maxplus": (MAXPLUS, J_MAXPLUS),
    "maxmin": (MAXMIN, J_MAXMIN),
}


def _rng(*key):
    """A generator seeded from ``key`` (stable across processes)."""
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _holes(rng, x, share, fill):
    return np.where(rng.random(x.shape) < share, np.float32(fill),
                    x).astype(np.float32)


def _operands(name, rng, lead, m, n, k):
    """Field tuples (a, b) for ``name``: lengths with +inf holes (tropical),
    integer dists and counts (tropical_count), integer counts, {0,1} masks,
    scores with -inf holes (maxplus), capacities (maxmin)."""
    sa, sb = (*lead, m, k), (*lead, k, n)
    if name == "tropical":
        return ((_holes(rng, 0.5 + 3.5 * rng.random(sa), 0.3, _INF),),
                (_holes(rng, 0.5 + 3.5 * rng.random(sb), 0.3, _INF),))
    if name == "tropical_count":
        da = _holes(rng, rng.integers(0, 4, sa), 0.3, _INF)
        db = _holes(rng, rng.integers(0, 4, sb), 0.3, _INF)
        ca = np.where(np.isfinite(da), rng.integers(1, 4, sa), 0)
        cb = np.where(np.isfinite(db), rng.integers(1, 4, sb), 0)
        return ((da, ca.astype(np.float32)), (db, cb.astype(np.float32)))
    if name == "counting":
        return ((_holes(rng, rng.integers(1, 4, sa), 0.7, 0),),
                (_holes(rng, rng.integers(1, 4, sb), 0.7, 0),))
    if name == "boolean":
        return (((rng.random(sa) < 0.05).astype(np.float32),),
                ((rng.random(sb) < 0.05).astype(np.float32),))
    if name == "maxplus":
        return ((_holes(rng, 10 * rng.random(sa), 0.1, -_INF),),
                (_holes(rng, 10 * rng.random(sb), 0.1, -_INF),))
    assert name == "maxmin"
    return ((10 * rng.random(sa, dtype=np.float32),),
            (10 * rng.random(sb, dtype=np.float32),))


def _jax(spec, a, b, batched, out_dtype=None):
    fn = (J.semiring_matmul_batched_pallas if batched
          else J.semiring_matmul_pallas)
    out = fn(spec, tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)),
             interpret=True, out_dtype=out_dtype)
    return [np.asarray(x) for x in out]


def _port(spec, a, b, batched, out_dtype=None):
    fn = S.semiring_matmul_batched if batched else S.semiring_matmul
    out = fn(spec, tuple(map(torch.from_numpy, a)),
             tuple(map(torch.from_numpy, b)), out_dtype=out_dtype)
    assert all(x.device.type == "cpu" for x in out)
    return [x.numpy() for x in out]


@pytest.fixture
def no_launches():
    S.reset_launches()
    yield
    assert not any(S.launches.values()), S.launches


# -- the specs ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tropical", "boolean", "counting",
                                  "tropical_count"])
def test_shipped_specs_match_the_jax_specs(name):
    port, jax_spec = SPECS[name]
    assert port.name == jax_spec.name
    assert port.num_fields == jax_spec.num_fields
    assert port.mxu == jax_spec.mxu
    for key in ("pad_a", "pad_b", "acc_init"):
        assert getattr(port, key) == tuple(map(float, getattr(jax_spec, key)))
    # well formed, as the JAX package's test_shipped_semiring_specs_well_formed
    assert (len(port.pad_a) == len(port.pad_b) == len(port.acc_init)
            == port.num_fields)
    if port.mxu:
        assert port.num_fields == 1 and port.epilogue and port.cuda_epilogue
    else:
        assert port.combine and port.kreduce and port.accumulate
        assert port.cuda_combine and port.cuda_accumulate
    assert getattr(ops, name.upper()) is port
    assert getattr(K, name.upper()) is port


@pytest.mark.parametrize("kwargs, match", [
    (dict(mxu=True, num_fields=2, pad_a=(0, 0), pad_b=(0, 0),
          acc_init=(0, 0), epilogue=abs), "single-field"),
    (dict(mxu=True, pad_a=(0,), pad_b=(0,), acc_init=(0,)), "epilogue"),
    (dict(pad_a=(0,), pad_b=(0,), acc_init=(0,), combine=max,
          accumulate=max), "kreduce"),
    (dict(pad_a=(0, 0), pad_b=(0,), acc_init=(0,), combine=max,
          kreduce=max, accumulate=max), "pad_a has 2 values"),
])
def test_malformed_specs_raise(kwargs, match):
    with pytest.raises(ValueError, match=match):
        S.Semiring(name="bad", **kwargs)


# -- against the JAX package ----------------------------------------------------------

def _assert_close(got, want, name, k):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        if name == "counting_float":
            np.testing.assert_allclose(g, w, rtol=k * 2.0 ** -24, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 384)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", list(SPECS) + ["counting_float"])
def test_matches_pallas(name, shape, batched, no_launches):
    m, n, k = shape
    rng = _rng(name, shape, batched)
    lead = (2,) if batched else ()
    if name == "counting_float":  # non-integer sums: rtol k * 2**-24
        port, jax_spec = SPECS["counting"]
        a = (rng.random((*lead, m, k), dtype=np.float32),)
        b = (rng.random((*lead, k, n), dtype=np.float32),)
    else:
        port, jax_spec = SPECS[name]
        a, b = _operands(name, rng, lead, m, n, k)
    want = _jax(jax_spec, a, b, batched)
    got = _port(port, a, b, batched)
    _assert_close(got, want, name, k)


def _pad(x, rows, cols, fill):
    """``x`` padded at its last two axes to (rows, cols) with ``fill``."""
    widths = [(0, 0)] * (x.ndim - 2) + [(0, rows - x.shape[-2]),
                                        (0, cols - x.shape[-1])]
    return np.pad(x, widths, constant_values=np.float32(fill))


def _bits_equal(got, want):
    """NaN matches NaN; every other cell equal, sign bit of zeros too."""
    nan = np.isnan(want)
    return (np.array_equal(np.isnan(got), nan)
            and np.array_equal(got[~nan], want[~nan])
            and np.array_equal(np.signbit(got[~nan]), np.signbit(want[~nan])))


def _signed_zero_operands(name, rng, lead, m, n, k, nans):
    """Distances drawn from {0, -0, 1, 2} (a share of NaN when ``nans``),
    with counts in 1..3 for tropical_count. -0 is drawn rarely enough that
    some zero minima come from +0 sums alone, even at k = 384."""
    vals = np.array([0.0, -0.0, 1.0, 2.0], np.float32)
    p = [0.3, 0.1, 0.3, 0.3]
    da = rng.choice(vals, (*lead, m, k), p=p)
    db = rng.choice(vals, (*lead, k, n), p=p)
    if nans:
        da = _holes(rng, da, 0.002, np.nan)
    if name == "tropical":
        return (da,), (db,)
    ca = rng.integers(1, 4, da.shape).astype(np.float32)
    cb = rng.integers(1, 4, db.shape).astype(np.float32)
    return (da, ca), (db, cb)


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
@pytest.mark.parametrize("shape, nans", [((128, 128, 128), False),
                                         ((256, 128, 384), False),
                                         ((128, 128, 128), True)],
                         ids=["128x128x128", "256x128x384", "nan"])
@pytest.mark.parametrize("name", ["tropical", "tropical_count"])
def test_tropical_specs_rank_neg_zero_below_pos_zero(name, shape, nans,
                                                     batched, no_launches):
    """The shipped specs' plain versions fold as ``jnp.min`` does: -0 ranks
    below +0 (``torch.amin`` / ``torch.minimum`` keep whichever zero they
    meet first) and NaN propagates. Distances bit-equal, sign bit of zeros
    included; counts equal (their rule compares with ``==``)."""
    m, n, k = shape
    rng = _rng("signed_zeros", name, shape, nans, batched)
    port, jax_spec = SPECS[name]
    a, b = _signed_zero_operands(name, rng, (2,) if batched else (), m, n, k,
                                 nans)
    want = _jax(jax_spec, a, b, batched)
    got = _port(port, a, b, batched)
    assert _bits_equal(got[0], want[0])  # tolerance: bit-equal
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert (np.signbit(want[0]) & (want[0] == 0)).any()  # -0 reached
    assert ((want[0] == 0) & ~np.signbit(want[0])).any()  # +0 kept
    assert np.isnan(want[0]).any() == nans


def _up(x, block=128):
    return -(-x // block) * block


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
@pytest.mark.parametrize("shape", [(100, 200, 60), (33, 17, 129)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", list(SPECS))
def test_ragged_shapes_act_as_the_pads(name, shape, batched, no_launches):
    """Any M, N, K: the port masks ragged edges with pad_a/pad_b; the JAX
    kernel gets inputs padded with them to its blocks, then sliced."""
    m, n, k = shape
    rng = _rng(name, shape, batched)
    lead = (2,) if batched else ()
    port, jax_spec = SPECS[name]
    a, b = _operands(name, rng, lead, m, n, k)
    ap = tuple(_pad(x, _up(m), _up(k), v) for x, v in zip(a, port.pad_a))
    bp = tuple(_pad(x, _up(k), _up(n), v) for x, v in zip(b, port.pad_b))
    want = [x[..., :m, :n] for x in _jax(jax_spec, ap, bp, batched)]
    got = _port(port, a, b, batched)
    _assert_close(got, want, name, k)


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
@pytest.mark.parametrize("algebra", ["counting", "two_walks"])
def test_mxu_path_with_narrow_operands_and_out_dtype(algebra, batched,
                                                     no_launches):
    """uint8 x int32 operands, cast to fp32 for the dot, int32 output."""
    port, jax_spec = ((S.COUNTING, J.COUNTING) if algebra == "counting"
                      else (TWO_WALKS, J_TWO_WALKS))
    rng = np.random.default_rng(5)
    lead = (2,) if batched else ()
    a = ((rng.random((*lead, 128, 256)) < 0.01).astype(np.uint8),)
    b = (rng.integers(0, 3, (*lead, 256, 128)).astype(np.int32),)
    want = _jax(jax_spec, a, b, batched, out_dtype=jnp.int32)
    got = _port(port, a, b, batched, out_dtype=torch.int32)
    assert got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    values = set(np.unique(got[0]).tolist())
    assert {0, 1} == values if algebra == "two_walks" else {0, 2} < values
    # without out_dtype the output takes the left operand's dtype, as in JAX
    assert _port(port, a, b, batched)[0].dtype == np.uint8


def _wide_operands(name, dtype, rng, lead, m, n, k, nf):
    """Field tuples (a, b) of a wide algebra: scores in [0, 10) (float32,
    with 10% -inf holes) or integers in [0, 1000) (int32) for max-plus;
    widths (with -inf holes in float32), hops 0..3 and counts 0..3 for the
    lexicographic algebra."""
    def field(shape, role):
        if role == "hops" or role == "count":
            x = rng.integers(0, 4, shape)
        elif dtype == "int32":
            x = rng.integers(0, 1000 if role == "score" else 8, shape)
        else:
            x = (10 * rng.random(shape) if role == "score"
                 else rng.integers(0, 8, shape))
            x = np.where(rng.random(shape) < 0.1, -np.inf, x)
        return x.astype(dtype)

    roles = ("width", "hops", "count") if name == "lex" else ("score",) * nf
    return (tuple(field((*lead, m, k), r) for r in roles),
            tuple(field((*lead, k, n), r) for r in roles))


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
@pytest.mark.parametrize("shape", [(40, 24, 36), (33, 70, 129)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name, dtype", list(WIDE),
                         ids=lambda x: str(x))
def test_wide_algebras_match_pallas(name, dtype, shape, batched, no_launches):
    """Algebras of 3 and 8 fields (per-field max-plus; the lexicographic
    widest-path, fewest-hops, path-count algebra), float32 and int32, at
    ragged shapes: the port's plain version against the JAX kernel in
    interpret mode on operands padded with the pads to its blocks. Bit-equal:
    max, min and integer sums are exact in any order."""
    port, jax_spec = WIDE[(name, dtype)]
    m, n, k = shape
    rng = _rng("wide", name, dtype, shape, batched)
    lead = (2,) if batched else ()
    a, b = _wide_operands(name, dtype, rng, lead, m, n, k, port.num_fields)
    ap = tuple(_pad(x, _up(m), _up(k), v) for x, v in zip(a, port.pad_a))
    bp = tuple(_pad(x, _up(k), _up(n), v) for x, v in zip(b, port.pad_b))
    want = [x[..., :m, :n] for x in _jax(jax_spec, ap, bp, batched)]
    got = _port(port, a, b, batched)
    _assert_close(got, want, name, k)
    assert all(g.dtype == np.dtype(dtype) for g in got)
    assert all(np.isfinite(g.astype(np.float64)).any() for g in got)


# -- the plain versions ------------------------------------------------------------------

def test_plain_vpu_version_folds_slabs_in_order():
    """The slab order of the plain version gives the broadcast definition,
    and an empty K gives acc_init."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(10 * rng.random((37, 21), dtype=np.float32))
    b = torch.from_numpy(10 * rng.random((21, 45), dtype=np.float32))
    (got,) = S.semiring_matmul_ref(MAXPLUS, (a,), (b,))
    torch.testing.assert_close(got, (a[:, :, None] + b[None]).amax(dim=1),
                               rtol=0, atol=0)
    (empty,) = S.semiring_matmul(MAXPLUS, (a[:, :0],), (b[:0],))
    assert empty.shape == (37, 45) and bool((empty == -_INF).all())
    d, c = S.semiring_matmul_batched(S.TROPICAL_COUNT, (a[None], a[None]),
                                     (b[None], b[None]))
    d_ref, c_ref = S.minplus_count_matmul_ref(a, a, b, b)
    assert torch.equal(d[0], d_ref) and torch.equal(c[0], c_ref)


def test_use_kernel_false_and_ref_aliases():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.random((16, 24), dtype=np.float32))
    b = torch.from_numpy(rng.random((24, 8), dtype=np.float32))
    (x,) = S.semiring_matmul(S.TROPICAL, (a,), (b,), use_kernel=False)
    assert torch.equal(x, S.minplus_matmul_ref(a, b))
    assert ref.semiring_matmul_ref is S.semiring_matmul_ref
    assert ref.semiring_matmul_batched_ref is S.semiring_matmul_batched_ref
    assert ops.semiring_matmul is S.semiring_matmul
    assert ops.semiring_matmul_batched is S.semiring_matmul_batched
    assert ops.semiring_matmul_ref is S.semiring_matmul_ref
    assert K.Semiring is S.Semiring is ops.Semiring


@pytest.mark.parametrize("call, match", [
    (lambda a: S.semiring_matmul(S.TROPICAL_COUNT, (a,), (a, a)), "fields"),
    (lambda a: S.semiring_matmul(S.TROPICAL, (a,), (a[:3],)), "products"),
    (lambda a: S.semiring_matmul_batched(S.TROPICAL, (a,), (a,)), "3D"),
    (lambda a: S.semiring_matmul(S.TROPICAL, (a,), (a,),
                                 out_dtype=torch.int32), "MXU-path"),
])
def test_wrappers_refuse_malformed_operands(call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.zeros(4, 4))


# -- the device path, without a card ---------------------------------------------------------

NO_DEVICE_CODE = dataclasses.replace(MAXPLUS, cuda_combine=None,
                                     cuda_accumulate=None)


def test_a_spec_without_device_code_raises_on_the_kernel_path(monkeypatch):
    """Asked for the kernel, a spec without device code raises and names
    the unset fields; it never falls back to the plain version."""
    with pytest.raises(NotImplementedError, match="cuda_combine, "
                                                  "cuda_accumulate"):
        S.semiring_source(NO_DEVICE_CODE, (torch.float32,))
    with pytest.raises(NotImplementedError, match="cuda_epilogue"):
        S.algebra_source(dataclasses.replace(TWO_WALKS, cuda_epilogue=None),
                         (torch.float32,) * 3)
    # the wrapper's kernel path, as a CUDA tensor would take it
    monkeypatch.setattr(S, "_use_kernel", lambda *a, **kw: True)
    monkeypatch.setattr(S, "semiring_matmul_ref", None)
    x = torch.zeros(4, 4)
    with pytest.raises(NotImplementedError, match="maxplus"):
        S.semiring_matmul(NO_DEVICE_CODE, (x,), (x,))
    with pytest.raises(TypeError, match="float32 or int32 fields"):
        S.semiring_matmul(MAXPLUS, (x.double(),), (x.double(),))
    with pytest.raises(TypeError, match="float32 or int32 fields"):
        S.semiring_matmul(S.TROPICAL_COUNT, (x, x.int()), (x, x.int()))
    with pytest.raises(TypeError, match="writes float32 or int32"):
        S.semiring_matmul(S.COUNTING, (x.to(torch.uint8),), (x,))
    # on the CPU, without the kernel, the same spec runs
    monkeypatch.undo()
    (y,) = S.semiring_matmul(NO_DEVICE_CODE, (x,), (x,))
    assert torch.equal(y, x)


def test_generated_source_holds_the_device_code():
    for sr in (S.TROPICAL, S.TROPICAL_COUNT, MAXPLUS, MAXMIN):
        src = S.semiring_source(sr, (torch.float32,))
        assert sr.cuda_combine in src and sr.cuda_accumulate in src
        assert '#include "semiring_generic.cuh"' in src
        assert "repro_semiring_vpu" in src and f"struct Algebra_{sr.name}" in src
    for sr in (S.BOOLEAN, S.COUNTING, TWO_WALKS):
        src = S.semiring_source(sr, (torch.uint8, torch.int32, torch.int32))
        assert sr.cuda_epilogue in src and "repro_semiring_mxu" in src
        assert "using A = unsigned char;" in src and "using Out = int;" in src
    assert (build.CSRC / build.GENERIC_HEADER).is_file()
    assert build.GENERIC_HEADER not in build.SOURCES.values()
    # an int32 field cannot hold an infinite pad
    with pytest.raises(ValueError, match="int32"):
        S.semiring_source(S.TROPICAL, (torch.int32,))


def test_build_target_follows_the_device_code():
    types = (torch.float32,)
    key = S.build_key(MAXPLUS, types)
    assert key == "semiring_maxplus_f32"
    target = build.generated_target(key, S.semiring_source(MAXPLUS, types))
    assert target.parent == build.BUILD_DIR
    assert target.name.startswith("libsemiring_maxplus_f32_")
    same = build.generated_target(key, S.semiring_source(MAXPLUS, types))
    edited = dataclasses.replace(
        MAXPLUS, cuda_accumulate="acc[0] = fmaxf(t[0], acc[0]);")
    other = build.generated_target(key, S.semiring_source(edited, types))
    assert same == target and other != target
    assert S.build_key(TWO_WALKS, (torch.uint8, torch.int32, torch.int32)) \
        == "semiring_two_walks_u8_i32_i32"
    cmd = build.nvcc_command(target.with_suffix(".cu"), target,
                             include=build.CSRC)
    assert cmd[cmd.index("-I") + 1] == str(build.CSRC)
    assert "arch=compute_90a,code=sm_90a" in cmd


def test_build_target_follows_every_header(tmp_path, monkeypatch):
    """Every library's name, built or generated, hashes every header under
    ``csrc/``: an edit to ``counting_tiles.cuh`` or ``semiring_generic.cuh``
    renames (so rebuilds) each library that includes it, checked on a
    temporary copy of the sources."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    types = (torch.float32,) * 3
    gen_key = S.build_key(S.COUNTING, types)
    gen_src = S.semiring_source(S.COUNTING, types)

    def targets():
        return ({name: build._target(name) for name in build.SOURCES}
                | {gen_key: build.generated_target(gen_key, gen_src)})

    before = targets()
    assert targets() == before  # stable while nothing changes
    for header in ("counting_tiles.cuh", build.GENERIC_HEADER):
        path = csrc / header
        path.write_text(path.read_text() + "// edited\n")
        after = targets()
        assert all(after[k] != before[k] for k in before), header
        assert all(t.parent == build.BUILD_DIR for t in after.values())
        before = after
    assert not set(build.SOURCES.values()) & {p.name for p in
                                              csrc.glob("*.cuh")}


def test_mxu_source_instantiates_the_counting_tiles():
    """A generated MXU-path kernel is count_matmul's GEMM: it includes
    ``counting_tiles.cuh`` and stores the algebra's epilogue through
    ``MxuStore``; the header has no MXU tile of its own. Pads whose product
    is not 0 are refused (the kernel zero-fills ragged K)."""
    src = S.semiring_source(TWO_WALKS, (torch.uint8, torch.int32, torch.int32))
    assert '#include "counting_tiles.cuh"' in src
    assert "counting_tiles::launch_typed" in src and "MxuStore<Alg>" in src
    header = (build.CSRC / build.GENERIC_HEADER).read_text()
    assert "mxu_tile" not in header and "launch_mxu" not in header
    vpu = S.semiring_source(MAXPLUS, (torch.float32,))
    assert "counting_tiles" not in vpu
    bad = dataclasses.replace(TWO_WALKS, pad_a=(1.0,), pad_b=(2.0,))
    with pytest.raises(ValueError, match="pad_a \\* pad_b"):
        S.semiring_source(bad, (torch.float32,) * 3)


def _mxu_routing_cases():
    """(right operand, whether the generic MXU path takes the SIMT tile)."""
    rng = np.random.default_rng(30)
    mask = (rng.random((48, 40)) < 0.2).astype(np.int32)

    def with_cell(x, value):
        x = x.copy()
        x[3, 5] = value
        return x

    return {
        "u8 0..255": ((np.arange(48 * 40).reshape(48, 40) % 256
                       ).astype(np.uint8), False),
        "u8 {0,1}": (mask.astype(np.uint8), False),
        "i32 {0,1}": (mask, False),
        "i32 256": (with_cell(mask, 256), False),
        "i32 257": (with_cell(mask, 257), True),
        "i32 above 2**24, rounded to it": (with_cell(mask, 2 ** 24 + 1),
                                           False),
        "i32 -3": (with_cell(mask, -3), False),
        "f32 {0,1}": (mask.astype(np.float32), False),
        "f32 1 + 2**-10": (with_cell(mask.astype(np.float32),
                                     1 + 2.0 ** -10), True),
        "f32 +inf": (with_cell(mask.astype(np.float32), np.inf), True),
        "f32 -inf": (with_cell(mask.astype(np.float32), -np.inf), True),
        "f32 NaN": (with_cell(mask.astype(np.float32), np.nan), True),
    }


@pytest.mark.parametrize("case", list(_mxu_routing_cases()))
def test_mxu_path_picks_the_tile_per_right_operand(case):
    """The generic MXU path runs on count_matmul's tiles, picked on the card
    from ``b.float()`` (``_takes_simt_tile`` is the pass's CPU mirror): a
    uint8 ``b`` always takes the tensor-core tile, an int32 or float32 one
    the SIMT tile when a value is not exact in bf16 or not finite. Where it
    takes the tensor-core tile on small integers, that tile's sum is the
    plain version's."""
    b, want = _mxu_routing_cases()[case]
    b = torch.from_numpy(b)
    assert S._takes_simt_tile(b) == want
    a = torch.from_numpy(np.random.default_rng(31).integers(
        0, 4, (16, b.shape[0])).astype(np.float32))
    if not want and float(b.float().abs().max()) < 2 ** 16:
        assert torch.equal(S._limbed_matmul_ref(a, b.float()),
                           S.count_matmul_ref(a, b))


#: name -> (port spec, JAX spec, out dtypes (port, JAX) or None)
_MXU_CASES = {
    "counting": (S.COUNTING, J.COUNTING, None),
    "boolean": (S.BOOLEAN, J.BOOLEAN, None),
    "two_walks_u8_i32": (TWO_WALKS, J_TWO_WALKS, (torch.int32, jnp.int32)),
    "counting_float_a": (S.COUNTING, J.COUNTING, None),
}


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "batched"])
@pytest.mark.parametrize("shape", [(128, 128, 256), (100, 200, 60)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", list(_MXU_CASES))
def test_limbed_mxu_path_matches_pallas(case, shape, batched):
    """What the card's generic MXU kernel computes when ``b`` is exact in
    bf16 (the tensor-core tile: ``_limbed_matmul_ref`` of the fp32 casts,
    then the algebra's epilogue) against the JAX package's kernel in
    interpret mode on operands padded to its blocks with the spec's pads,
    as ``repro.kernels.ops`` pads them: bit-equal on integer sums (integer
    counts, {0,1} masks, uint8 x int32 into int32), within rtol 1e-5 for a
    non-integer float ``a`` (the tile rounds once per 16-deep k step)."""
    m, n, k = shape
    port, jax_spec, out = _MXU_CASES[case]
    rng = _rng("limbed_mxu", case, shape, batched)
    lead = (2,) if batched else ()
    if case == "two_walks_u8_i32":
        a = (rng.random((*lead, m, k)) < 0.05).astype(np.uint8)
        b = rng.integers(0, 3, (*lead, k, n)).astype(np.int32)
    elif case == "counting_float_a":
        a = rng.random((*lead, m, k), dtype=np.float32)
        b = (rng.random((*lead, k, n)) < 0.1).astype(np.float32)
    else:
        (a,), (b,) = _operands(case, rng, lead, m, n, k)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert not S._takes_simt_tile(tb)
    acc = S._limbed_matmul_ref(ta.float(), tb.float())
    got = port.epilogue(acc).to(out[0] if out else ta.dtype).numpy()
    ap = _pad(a, _up(m), _up(k), port.pad_a[0])
    bp = _pad(b, _up(k), _up(n), port.pad_b[0])
    (want,) = _jax(jax_spec, (ap,), (bp,), batched,
                   out_dtype=out[1] if out else None)
    want = want[..., :m, :n]
    assert got.dtype == want.dtype and got.shape == want.shape
    if case == "counting_float_a":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        assert not np.array_equal(np.floor(want), want)  # not integer sums
    else:
        np.testing.assert_array_equal(got, want)
    want_plain = (S.semiring_matmul_batched_ref if batched
                  else S.semiring_matmul_ref)(port, (ta,), (tb,),
                                              out_dtype=out[0] if out else None)
    if case != "counting_float_a":
        np.testing.assert_array_equal(got, want_plain[0].numpy())


# -- the device code as host C++ ------------------------------------------------------------

_HARNESS_VPU = r"""
#include <cstdio>
#include "semiring_generic.cuh"
%s
using Alg = %s;
static void get(float& v) { std::scanf("%%a", &v); }
static void get(int& v) { std::scanf("%%d", &v); }
static void put(float v) { std::printf("%%a\n", (double)v); }
static void put(int v) { std::printf("%%d\n", v); }
int main() {
  using T = Alg::T;
  constexpr int NF = Alg::NF;
  int s;
  std::scanf("%%d", &s);
  T v[NF];
  Alg::pad_a(v); for (int f = 0; f < NF; ++f) put(v[f]);
  Alg::pad_b(v); for (int f = 0; f < NF; ++f) put(v[f]);
  Alg::init(v); for (int f = 0; f < NF; ++f) put(v[f]);
  for (int i = 0; i < s; ++i) {
    T a[NF], b[NF], acc[NF], t[NF];
    for (int f = 0; f < NF; ++f) get(a[f]);
    for (int f = 0; f < NF; ++f) get(b[f]);
    for (int f = 0; f < NF; ++f) get(acc[f]);
    Alg::combine(a, b, t);
    for (int f = 0; f < NF; ++f) put(t[f]);
    Alg::accumulate(acc, t);
    for (int f = 0; f < NF; ++f) put(acc[f]);
  }
}
"""

_HARNESS_MXU = r"""
#include <cstdio>
#include "semiring_generic.cuh"
%s
using Alg = %s;
static void put(float v) { std::printf("%%a\n", (double)v); }
static void put(int v) { std::printf("%%d\n", v); }
int main() {
  int s;
  std::scanf("%%d", &s);
  put(Alg::pad_a());
  put(Alg::pad_b());
  for (int i = 0; i < s; ++i) {
    float acc;
    std::scanf("%%a", &acc);
    put(static_cast<Alg::Out>(Alg::epilogue(acc)));
  }
}
"""


def _run_host(tmp_path, sr, types, harness, stdin):
    exe = tmp_path / f"algebra_{sr.name}"
    src = exe.with_suffix(".cpp")
    src.write_text(harness % (S.algebra_source(sr, types),
                              f"Algebra_{sr.name}"))
    built = subprocess.run(["g++", "-std=c++17", "-O1", "-I", str(build.CSRC),
                            "-o", str(exe), str(src)],
                           capture_output=True, text=True, timeout=120)
    assert built.returncode == 0, built.stderr
    out = subprocess.run([str(exe)], input=stdin, capture_output=True,
                         text=True, timeout=60, check=True).stdout.split()
    return out


def _word(x, dtype):
    return str(int(x)) if dtype == torch.int32 else float(x).hex()


def _value(word, dtype):
    return int(word) if dtype == torch.int32 else float.fromhex(word)


INT_MAXMIN = S.Semiring(
    name="maxmin_int", pad_a=(-2**31,), pad_b=(-2**31,), acc_init=(-2**31,),
    combine=lambda a, b: (torch.minimum(a[0], b[0]),),
    kreduce=lambda f: (torch.amax(f[0], dim=1),),
    accumulate=lambda x, y: (torch.maximum(x[0], y[0]),),
    cuda_combine="out[0] = sr_min(a[0], b[0]);",
    cuda_accumulate="acc[0] = sr_max(acc[0], t[0]);")


@pytest.mark.parametrize("sr, dtype", [
    (S.TROPICAL, torch.float32), (S.TROPICAL_COUNT, torch.float32),
    (MAXPLUS, torch.float32), (MAXMIN, torch.float32),
    (INT_MAXMIN, torch.int32)] + [
        (port, getattr(torch, dt)) for (_, dt), (port, _) in WIDE.items()],
    ids=lambda x: getattr(x, "name", str(x)))
def test_vpu_device_code_agrees_with_the_callables_on_the_host(
        tmp_path, sr, dtype):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    rng = np.random.default_rng(8)
    s, nf = 64, sr.num_fields
    # small integers, so ties are common, with the holes of each algebra's
    # domain: +inf for distances, -inf for max-plus scores, both for
    # max-min. Nothing makes a NaN (inf - inf), which is in no algebra's
    # domain: fminf/fmaxf drop it where torch.minimum/maximum keep it.
    vals = rng.integers(-3, 4, (3, s, nf)).astype(np.float64)
    wide = sr.name.startswith(("maxplus", "lex"))
    if wide and dtype == torch.float32:  # -inf holes (scores, widths)
        holes = rng.random(vals.shape) < 0.1
        if sr.name == "lex":
            holes[..., 1:] = False  # finite hops and counts
        vals[holes] = -_INF
    if sr.name.startswith("lex"):  # hops and counts: nonnegative
        vals[..., 1:] = np.abs(vals[..., 1:])
    if dtype == torch.float32 and not wide:
        if sr is not MAXPLUS:
            vals[rng.random(vals.shape) < 0.15] = _INF
        if sr in (MAXPLUS, MAXMIN):
            vals[rng.random(vals.shape) < 0.1] = -_INF
        if sr is S.TROPICAL_COUNT:  # counts: finite, 0 where dist is inf
            vals[..., 1] = np.where(np.isinf(vals[..., 0]), 0,
                                    rng.integers(0, 4, (3, s)))
    stdin = " ".join([str(s)] + [_word(x, dtype) for i in range(s)
                                 for part in vals[:, i] for x in part])
    out = _run_host(tmp_path, sr, (dtype,), _HARNESS_VPU, stdin)
    got = [_value(w, dtype) for w in out]
    head = list(sr.pad_a) + list(sr.pad_b) + list(sr.acc_init)
    assert got[:3 * nf] == [_value(_word(v, dtype), dtype) for v in head]
    body = np.array(got[3 * nf:]).reshape(s, 2, nf)
    a, b, acc = (tuple(torch.tensor(vals[j][:, f], dtype=dtype)
                       for f in range(nf)) for j in range(3))
    t = sr.combine(a, b)
    folded = sr.accumulate(acc, t)
    for f in range(nf):
        np.testing.assert_array_equal(body[:, 0, f], t[f].to(dtype).numpy())
        np.testing.assert_array_equal(body[:, 1, f],
                                      folded[f].to(dtype).numpy())


@pytest.mark.parametrize("sr, out", [
    (S.BOOLEAN, torch.float32), (S.COUNTING, torch.float32),
    (TWO_WALKS, torch.int32)], ids=lambda x: getattr(x, "name", str(x)))
def test_mxu_epilogue_agrees_with_the_callable_on_the_host(tmp_path, sr, out):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    accs = np.array([0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3.0, 7.0,
                     2.0 ** 24, 123.0], dtype=np.float32)
    stdin = " ".join([str(len(accs))] + [float(x).hex() for x in accs])
    words = _run_host(tmp_path, sr, (torch.float32, torch.float32, out),
                      _HARNESS_MXU, stdin)
    assert [float.fromhex(w) for w in words[:2]] == [sr.pad_a[0],
                                                    sr.pad_b[0]]
    got = np.array([_value(w, out) for w in words[2:]])
    want = sr.epilogue(torch.from_numpy(accs)).to(out).numpy()
    np.testing.assert_array_equal(got, want)


# -- NaN: the min-plus products propagate it as the JAX package does ----------------

def _nan_lengths(rng, shape, integer=False):
    """Distances with +inf holes and a few NaN cells (1%)."""
    x = (rng.integers(0, 4, shape) if integer
         else 0.5 + 3.5 * rng.random(shape)).astype(np.float32)
    x = _holes(rng, x, 0.3, _INF)
    return _holes(rng, x, 0.01, np.nan)


def _nan_case(op, rng):
    """(port result, JAX result) of one min-plus product on NaN inputs."""
    from repro.kernels import ops as rops

    m, n, k = 128, 128, 128
    if op in ("minplus_matmul", "batched_minplus_matmul"):
        lead = (2,) if op.startswith("batched") else ()
        a = _nan_lengths(rng, lead + (m, k))
        b = _nan_lengths(rng, lead + (k, n))
        got = getattr(S, op)(torch.from_numpy(a), torch.from_numpy(b))
        return [got.numpy()], [np.asarray(getattr(rops, op)(
            jnp.asarray(a), jnp.asarray(b)))]
    if op == "minplus_count_matmul":
        da, db = _nan_lengths(rng, (m, k), True), _nan_lengths(rng, (k, n), True)
        ca = np.where(np.isfinite(da), rng.integers(1, 4, (m, k)), 0)
        cb = np.where(np.isfinite(db), rng.integers(1, 4, (k, n)), 0)
        args = [x.astype(np.float32) for x in (da, ca, db, cb)]
        got = S.minplus_count_matmul(*map(torch.from_numpy, args))
        want = rops.minplus_count_matmul(*map(jnp.asarray, args))
        return [x.numpy() for x in got], [np.asarray(x) for x in want]
    name, batched = op.rsplit("_", 1)
    port, jax_spec = SPECS[name]
    lead = (2,) if batched == "batched" else ()
    a, b = _operands(name, rng, lead, m, n, k)
    a = (_holes(rng, a[0], 0.01, np.nan),) + a[1:]
    b = (_holes(rng, b[0], 0.01, np.nan),) + b[1:]
    return (_port(port, a, b, batched == "batched"),
            _jax(jax_spec, a, b, batched == "batched"))


@pytest.mark.parametrize("op", [
    "minplus_matmul", "batched_minplus_matmul", "minplus_count_matmul",
    "tropical_2d", "tropical_batched", "tropical_count_2d",
    "tropical_count_batched"])
def test_nan_propagates_as_in_the_jax_ops(op, no_launches):
    """A NaN sum anywhere along k makes the distance NaN (jnp.min /
    jnp.minimum propagate it) and its tropical count 0; elsewhere the
    results stay bit-equal. NaN-aware equality."""
    got, want = _nan_case(op, _rng("nan", op))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)  # NaN equals NaN here
    nan = np.isnan(want[0])
    assert nan.any() and np.isfinite(want[0]).any()
    if len(want) == 2:
        assert not want[1][nan].any()


@pytest.mark.parametrize("sr, jax_sr", [(S.TROPICAL, J.TROPICAL),
                                        (S.TROPICAL_COUNT, J.TROPICAL_COUNT)],
                         ids=["tropical", "tropical_count"])
def test_tropical_device_code_propagates_nan_on_the_host(tmp_path, sr, jax_sr):
    """The shipped TROPICAL / TROPICAL_COUNT device code, compiled as host
    C++, folds NaN as the torch callables and the JAX package's algebra do:
    NaN-aware equality. The pairs keep the algebra's contract: a count is
    0 where its distance is +inf or NaN."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    rng = np.random.default_rng(9)
    s, nf = 96, sr.num_fields
    vals = rng.integers(-3, 4, (3, s, nf)).astype(np.float64)
    vals[..., 0][rng.random((3, s)) < 0.15] = _INF
    vals[..., 0][rng.random((3, s)) < 0.25] = np.nan
    if nf == 2:
        vals[..., 1] = np.where(np.isfinite(vals[..., 0]),
                                rng.integers(0, 4, (3, s)), 0)
    stdin = " ".join([str(s)] + [float(x).hex() for i in range(s)
                                 for part in vals[:, i] for x in part])
    out = _run_host(tmp_path, sr, (torch.float32,), _HARNESS_VPU, stdin)
    body = np.array([float.fromhex(w) for w in out[3 * nf:]]).reshape(
        s, 2, nf).astype(np.float32)
    a, b, acc = (tuple(vals[j][:, f].astype(np.float32) for f in range(nf))
                 for j in range(3))
    t = sr.combine(tuple(map(torch.from_numpy, a)),
                   tuple(map(torch.from_numpy, b)))
    folded = sr.accumulate(tuple(map(torch.from_numpy, acc)), t)
    jt = jax_sr.combine(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    jfolded = jax_sr.accumulate(tuple(map(jnp.asarray, acc)), jt)
    for f in range(nf):
        np.testing.assert_array_equal(body[:, 0, f], t[f].numpy())
        np.testing.assert_array_equal(body[:, 1, f], folded[f].numpy())
        np.testing.assert_array_equal(body[:, 1, f], np.asarray(jfolded[f]))
    assert np.isnan(body[:, 1, 0]).sum() > s // 4

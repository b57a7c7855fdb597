"""The split tile of ``csrc/tropical.cu`` on the CPU.

The card's split tile folds each of S contiguous K ranges in k order and
combines the S partials in split order through a cluster's distributed
shared memory. Its plain emulations, ``S._split_k_minplus_ref`` and
``S._split_k_minplus_count_ref``, are held here to the JAX package's
Pallas kernels in interpret mode at every split: bit-equal on integer
lengths and counts (sign bits of zeros included, NaN matching NaN), on
ragged K, ties across a split boundary, all-inf rows, NaN cells and signed
zeros. The tile's per-k update, its split combine and its host rule are
plain C++ above ``#ifdef __CUDACC__``: a host compiler builds them and they
are held to ``_tc_accumulate``'s arithmetic and to the Python mirror of the
rule (``S._minplus_plan``). The kernel itself runs only on the card
(``chip_smoke.py`` phase 3).
"""
import functools
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as rops
from repro.kernels.minplus import minplus_matmul_pallas
from repro.kernels.semiring import TROPICAL_COUNT, semiring_matmul_pallas
from repro.kernels.semiring import _tc_accumulate as jax_tc_accumulate
from repro_torch.kernels import build
from repro_torch.kernels import semiring as S

SPLITS = [1, 2, 3, 4, 8]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits_equal(got, want):
    """NaN matches NaN; every other cell equal, sign bit of zeros too."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    return (np.array_equal(np.isnan(got), nan)
            and np.array_equal(got[~nan], want[~nan])
            and np.array_equal(np.signbit(got[~nan]), np.signbit(want[~nan])))


def _operands(seed, m, n, k, nans):
    """Integer lengths in [0, 4) with 30% +inf holes, half their zeros -0,
    an all-inf row of ``a``, NaN cells if asked, and counts 1..3 on the
    finite lengths (0 elsewhere)."""
    rng = np.random.default_rng(seed)

    def lengths(shape):
        d = rng.integers(0, 4, shape).astype(np.float32)
        d = np.where(rng.random(shape) < 0.3, np.float32(np.inf), d)
        return np.where((d == 0) & (rng.random(shape) < 0.5),
                        np.float32(-0.0), d)

    a, b = lengths((m, k)), lengths((k, n))
    a[0] = np.inf
    if nans:
        a[rng.random(a.shape) < 0.001] = np.nan
        b[rng.random(b.shape) < 0.001] = np.nan
    ca = np.where(np.isfinite(a), rng.integers(1, 4, a.shape), 0)
    cb = np.where(np.isfinite(b), rng.integers(1, 4, b.shape), 0)
    return a, ca.astype(np.float32), b, cb.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax(m, n, k, nans):
    """The JAX package's min-plus and count products of ``_operands``, in
    interpret mode: the kernels themselves where the shape is whole blocks
    of 128, the padding ops elsewhere."""
    a, ca, b, cb = map(jnp.asarray, _operands(m + n + k, m, n, k, nans))
    if m % 128 == 0 and n % 128 == 0 and k % 128 == 0:
        d = minplus_matmul_pallas(a, b, interpret=True)
        dc = semiring_matmul_pallas(TROPICAL_COUNT, (a, ca), (b, cb),
                                    interpret=True)
    else:
        d = rops.minplus_matmul(a, b)
        dc = rops.minplus_count_matmul(a, ca, b, cb)
    return np.asarray(d), tuple(np.asarray(x) for x in dc)


SHAPES = [(128, 128, 256, False), (128, 128, 256, True),
          (200, 72, 136, False), (200, 72, 136, True)]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("m,n,k,nans", SHAPES)
def test_split_k_minplus_matches_pallas(m, n, k, nans, splits):
    """The min-plus product split ``splits`` ways over K (136 is 4.25 K
    steps: ragged, and empty splits at 8) is the JAX kernel's bit for bit:
    min is exact in any order, -0 ranks below +0 in both, NaN propagates,
    the all-inf row stays +inf (or NaN, against a NaN of ``b``)."""
    a, _, b, _ = _operands(m + n + k, m, n, k, nans)
    want, _ = _jax(m, n, k, nans)
    got = S._split_k_minplus_ref(_t(a), _t(b), splits).numpy()
    assert _bits_equal(got, want)  # tolerance: bit-equal
    assert np.isinf(got[0][~np.isnan(got[0])]).all()  # NaN or +inf
    assert (np.signbit(want) & (want == 0)).any()  # -0 sums reached
    assert np.isnan(want).any() == nans


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("m,n,k,nans", SHAPES)
def test_split_k_count_matches_pallas(m, n, k, nans, splits):
    """The count product split ``splits`` ways: integer counts stay exact
    below 2**24, so the regrouped sums are the JAX kernel's bit for bit; a
    NaN sum gives (NaN, 0)."""
    a, ca, b, cb = _operands(m + n + k, m, n, k, nans)
    want = _jax(m, n, k, nans)[1]
    got = S._split_k_minplus_count_ref(_t(a), _t(ca), _t(b), _t(cb), splits)
    for g, w in zip(got, want):
        assert _bits_equal(g.numpy(), w)
    assert got[1].max() > 3  # ties summed
    assert not got[1][torch.isnan(got[0])].any()


@pytest.mark.parametrize("m,n,k,nans", SHAPES)
def test_plain_versions_match_pallas_with_signed_zeros(m, n, k, nans):
    """The plain versions the wrappers run on the CPU, and that the card's
    checks hold the split tile to, rank -0 below +0 as the JAX kernels do
    (``torch.amin`` alone keeps whichever zero it meets first)."""
    a, ca, b, cb = _operands(m + n + k, m, n, k, nans)
    want_d, want_dc = _jax(m, n, k, nans)
    assert _bits_equal(S.minplus_matmul(_t(a), _t(b)).numpy(), want_d)
    got = S.minplus_count_matmul(_t(a), _t(ca), _t(b), _t(cb))
    for g, w in zip(got, want_dc):
        assert _bits_equal(g.numpy(), w)


@pytest.mark.parametrize("splits", [2, 3, 4, 8])
def test_split_k_count_sums_ties_across_split_boundaries(splits):
    """Every output attains its min at the two k on either side of each
    split boundary (a -0 sum on the left, a +0 sum on the right): the
    combined count is the sum of both sides' products and the min is -0,
    as the JAX kernel gives."""
    m = n = 128
    k = 256
    rng = np.random.default_rng(splits)
    a = rng.integers(1, 4, (m, k)).astype(np.float32)
    b = rng.integers(1, 4, (k, n)).astype(np.float32)
    bounds = [lo for lo, hi in S._split_ranges(k, splits)[1:] if hi > lo]
    assert bounds
    for kb in bounds:
        a[:, kb - 1], b[kb - 1] = -0.0, -0.0
        a[:, kb], b[kb] = 0.0, 0.0
    ca = rng.integers(1, 4, (m, k)).astype(np.float32)
    cb = rng.integers(1, 4, (k, n)).astype(np.float32)
    want = semiring_matmul_pallas(
        TROPICAL_COUNT, (jnp.asarray(a), jnp.asarray(ca)),
        (jnp.asarray(b), jnp.asarray(cb)), interpret=True)
    got = S._split_k_minplus_count_ref(_t(a), _t(ca), _t(b), _t(cb), splits)
    for g, w in zip(got, want):
        assert _bits_equal(g.numpy(), np.asarray(w))
    assert (got[0] == 0).all() and torch.signbit(got[0]).all()
    ties = sum(np.outer(ca[:, j], cb[j]) for kb in bounds for j in (kb - 1, kb))
    np.testing.assert_array_equal(got[1].numpy(), ties)


def test_split_ranges_cover_k_in_whole_steps():
    """The K ranges of a split are contiguous, in order, cover 0..K and
    start on the tile's K steps; a split with no K step is empty."""
    bk = S._MINPLUS_SPLIT["bk"]
    for k in (1, 31, 32, 33, 136, 260, 512, 1536):
        for splits in range(1, S._MINPLUS_SPLIT_MAX + 1):
            ranges = S._split_ranges(k, splits)
            assert len(ranges) == splits and ranges[0][0] == 0
            assert ranges[-1][1] == k
            for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
                assert lo <= hi == lo2 and lo % bk == 0


# -- the device code on the host ---------------------------------------------------

_HARNESS = r"""
#include <cstdio>
#include <cstring>
#include "tropical.cu"
int main(int argc, char** argv) {
  int n;
  std::scanf("%d", &n);
  if (std::strcmp(argv[1], "update") == 0) {
    for (int i = 0; i < n; ++i) {
      float d, c, s, p;
      std::scanf("%a %a %a %a", &d, &c, &s, &p);
      const float m1 = tropical::min_nan(d, s), m2 = tropical::min_nan(s, d);
      float d2 = d, c2 = c;
      tropical::count_update(d, c, s, p);
      tropical::count_step(d2, c2, s, p, 1.f);
      std::printf("%a %a %a %a %a %a\n", d, c, m1, m2, d2, c2);
    }
  } else {
    for (int i = 0; i < n; ++i) {
      int nf, batch, m, nn, k, forced;
      std::scanf("%d %d %d %d %d %d", &nf, &batch, &m, &nn, &k, &forced);
      const tropical::Plan p = tropical::plan(nf, batch, m, nn, k, forced);
      std::printf("%d %d\n", p.large ? 1 : 0, p.split);
    }
  }
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """``csrc/tropical.cu``'s plain C++ part, built with ``g++``."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    tmp = tmp_path_factory.mktemp("tropical")
    src, exe = tmp / "harness.cpp", tmp / "harness"
    src.write_text(_HARNESS)
    built = subprocess.run(["g++", "-std=c++17", "-O1", "-I", str(build.CSRC),
                            "-o", str(exe), str(src)],
                           capture_output=True, text=True, timeout=120)
    assert built.returncode == 0, built.stderr

    def run(mode, rows):
        stdin = " ".join([str(len(rows))] + [str(x) for row in rows
                                             for x in row])
        return subprocess.run([str(exe), mode], input=stdin,
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.split()
    return run


_INF, _NAN = np.inf, np.nan
#: (d, c, s, p): the running pair and one k's (or one split's) pair
_UPDATES = np.array([
    (_INF, 0, 3, 2), (3, 2, 3, 5), (3, 2, 2, 5), (2, 5, 3, 7),
    (_INF, 0, _INF, 4), (_INF, 0, _INF, 0), (1, 3, _INF, 0),
    (_NAN, 0, 1, 2), (1, 2, _NAN, 3), (_NAN, 0, _NAN, 1), (_INF, 0, _NAN, 1),
    (0.0, 2, -0.0, 3), (-0.0, 2, 0.0, 3), (-0.0, 1, -0.0, 1), (0.0, 4, 0.0, 5),
    (-_INF, 1, -_INF, 2), (-_INF, 1, 0, 2), (5, 0, 5, 0), (0.5, 1.5, 0.5, 2.25),
    (2 ** 24 - 1, 2 ** 23, 2 ** 24 - 1, 2 ** 23), (7, 1, -3, 2)],
    np.float32)


def test_count_update_agrees_with_tc_accumulate_on_the_host(harness):
    """The split tile's split combine (``count_update``), its per-k update
    (``count_step``, the product fused into the add: exact products here)
    and its min (``min_nan``), compiled as host C++, against the JAX
    package's ``_tc_accumulate`` bit for bit (NaN matching NaN, -0 below
    +0 whichever side holds it), against the port's ``_tc_accumulate`` by
    value and against its plain emulation ``S._count_update`` bit for
    bit, on inf, NaN, tie and signed-zero cases."""
    out = harness("update", [[float(x).hex() for x in row]
                             for row in _UPDATES])
    got = np.array([float.fromhex(w) for w in out],
                   np.float32).reshape(-1, 6)
    d, c, s, p = (_UPDATES[:, i] for i in range(4))
    jd, jc = (np.asarray(x) for x in jax_tc_accumulate(
        (jnp.asarray(d), jnp.asarray(c)), (jnp.asarray(s), jnp.asarray(p))))
    assert _bits_equal(got[:, 0], jd) and _bits_equal(got[:, 1], jc)
    td, tc = S._tc_accumulate((_t(d), _t(c)), (_t(s), _t(p)))
    np.testing.assert_array_equal(got[:, 0], td.numpy())  # NaN-aware
    np.testing.assert_array_equal(got[:, 1], tc.numpy())
    ed, ec = S._count_update(_t(d), _t(c), _t(s), _t(p))
    assert _bits_equal(got[:, 0], ed.numpy())
    assert _bits_equal(got[:, 1], ec.numpy())
    # the min alone, both operand orders: jnp.minimum's bits
    want = np.asarray(jnp.minimum(jnp.asarray(d), jnp.asarray(s)))
    assert _bits_equal(got[:, 2], want) and _bits_equal(got[:, 3], want)
    assert np.isnan(got[7:11]).any(axis=1).all()
    assert not got[7:11, 1].any()  # a NaN min attains nothing
    # the per-k step with the product fused (here p x 1, exact): the same
    assert _bits_equal(got[:, 4], jd) and _bits_equal(got[:, 5], jc)


def _plan_cases():
    shapes = [(1, 384, 384, 384), (1, 512, 512, 512), (1, 1024, 1024, 1024),
              (1, 1536, 1536, 1536), (1, 1920, 1920, 1920),
              (1, 2048, 2048, 2048), (1, 300, 200, 260), (3, 512, 512, 512),
              (12, 2048, 2048, 2048), (12, 600, 520, 300), (2, 33, 65, 1),
              (1, 1, 1, 100), (1, 7, 1, 300), (255, 128, 128, 128),
              (256, 100, 1, 5), (1, 64, 64, 64), (1, 64, 64, 65),
              (5, 200, 136, 72), (1, 4096, 64, 8192)]
    return [(nf, *shape, forced) for nf in (1, 2) for shape in shapes
            for forced in (0, 1, 3, 8)]


def test_minplus_plan_mirrors_the_source_rule(harness):
    """``S._minplus_plan`` against ``csrc/tropical.cu``'s ``plan``, compiled
    as host C++, on the main path's shapes, ragged ones and the edges of
    the large tile's threshold, both field counts, with and without a
    forced split."""
    cases = _plan_cases()
    out = harness("plan", cases)
    got = [("large" if int(large) else "small", int(split))
           for large, split in zip(out[::2], out[1::2])]
    want = [S._minplus_plan(batch, m, n, k, nf, forced or None)
            for nf, batch, m, n, k, forced in cases]
    assert got == want


@pytest.mark.parametrize("batch,m,n,k,nf,want", [
    (1, 512, 512, 512, 1, ("small", 2)),    # the MWU oracle's product
    (1, 384, 384, 384, 1, ("small", 3)),
    (1, 512, 512, 512, 2, ("small", 2)),    # the count product
    (1, 1024, 1024, 1024, 1, ("small", 2)),  # 256 blocks: two splits
    (3, 512, 512, 512, 1, ("small", 2)),
    (1, 300, 200, 260, 1, ("small", 4)),    # ragged: 20 blocks, 9 steps
    (1, 1, 1, 100, 1, ("small", 2)),        # 4 K steps, two a split
    (1, 64, 64, 96, 1, ("small", 1)),       # 3 K steps: no split
    (12, 2048, 2048, 2048, 1, ("large", 1)),
    (12, 2048, 2048, 2048, 2, ("small", 2)),  # counts never take it
])
def test_minplus_plan_splits_small_grids(batch, m, n, k, nf, want):
    """The split of K grows the grid toward one block an SM, and splits
    every grid at least in two, while every split keeps two K steps; the
    large tile takes large min-plus grids."""
    assert S._minplus_plan(batch, m, n, k, nf) == want
    tile, split = want
    assert S._minplus_column(tile, split) == (
        tile if split == 1 else f"split{split}")


def test_split_tile_mirrors_the_source():
    """The host's mirror of the split tile's shape and split rule holds
    ``csrc/tropical.cu``'s constants; its ring fits two blocks an SM (228
    KiB, 1 KiB reserved per block) at one and two fields and holds the
    partial tile the cluster combine writes into it."""
    src = (build.CSRC / "tropical.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);",
                             src).group(1))

    assert const("SPLIT_MAX") == S._MINPLUS_SPLIT_MAX
    assert const("SPLIT_BLOCKS") == S._MINPLUS_SPLIT_BLOCKS
    assert const("SPLIT_LEAST") == S._MINPLUS_SPLIT_LEAST
    assert const("SPLIT_MIN_STEPS") == S._MINPLUS_SPLIT_MIN_STEPS
    shape = re.search(r"constexpr Shape SPLIT_SHAPE = \{([\d, ]+)\};", src)
    keys = ("bm", "bn", "tm", "tn", "kv", "bk", "stages")
    c = dict(zip(keys, map(int, shape.group(1).split(","))))
    assert c == S._MINPLUS_SPLIT
    for nf in (1, 2):
        ring = c["stages"] * nf * (c["bm"] * (c["bk"] + 4)
                                   + c["bk"] * c["bn"]) * 4
        assert 2 * (ring + 1024) <= 228 * 1024
        assert nf * c["bm"] * c["bn"] * 4 <= ring
    assert c["tm"] % 2 == 0 and c["tn"] % 4 == 0 and c["kv"] in (2, 4)
    assert c["bk"] % c["kv"] == 0 and c["bm"] * 65535 >= S._MAX_TROPICAL_ROWS
    assert S._MINPLUS_TILES == ("small", "large") + tuple(
        f"split{s}" for s in range(2, const("SPLIT_MAX") + 1))


@pytest.mark.parametrize("split", [0, 9, -1])
def test_a_split_outside_the_cluster_raises(split):
    with pytest.raises(ValueError, match="split"):
        S._split_arg(1, split)
    assert S._split_arg(1, None) == 0 and S._split_arg(3, 8) == 8
    with pytest.raises(ValueError, match="batch"):
        S._split_arg(65535, 2)


@pytest.mark.parametrize("split", [None, 1, 4, 8])
def test_forced_split_on_the_cpu_runs_the_plain_version(split):
    """On CPU tensors the private seams run the plain versions whatever the
    split, and count no launch."""
    a, ca, b, cb = (_t(x) for x in _operands(1, 40, 30, 70, False))
    S.reset_launches()
    got = S._minplus(a, b, True, None, False, split=split)
    assert _bits_equal(got.numpy(), S.minplus_matmul_ref(a, b).numpy())
    d, c = S._minplus_count(a, ca, b, cb, True, split=split)
    want = S.minplus_count_matmul_ref(a, ca, b, cb)
    assert _bits_equal(d.numpy(), want[0].numpy())
    assert _bits_equal(c.numpy(), want[1].numpy())
    assert not any(S.launches.values())

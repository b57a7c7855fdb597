"""The port's packed-cell wavefront vs the JAX package's, on the CPU.

Packed cells: int16 distances with the DIST_UNREACHED sentinel, counts
saturating at MULT_SAT = 2**24 (uint32 at the host boundary), uint8
adjacency. Both packages get the same adjacency (numpy, from the JAX
generator); the JAX engine runs its Pallas kernels in interpret mode, the
port its kernels' plain versions on CPU tensors. Every result is an
integer, so every comparison is exact: dtypes, values and the saturation
warning.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import topology as RT
from repro.core.analysis import wavefront as RWF
from repro.core.graph import Graph as RGraph
from repro.kernels import semiring as RS
from repro_torch.core.analysis import wavefront as WF
from repro_torch.kernels import semiring as S


def _check_packed(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    S.reset_launches()
    yield
    assert not any(S.launches.values()), S.launches


@pytest.mark.parametrize("fam", RT.families())
def test_packed_wavefront_bit_equal_all_families(fam):
    adj = RT.by_servers(fam, 300).adjacency_dense(np.float32)
    want = RWF.wavefront_dist_mult(adj, packed=True)
    got = WF.wavefront_dist_mult(adj, packed=True, device="cpu")
    assert got[0].dtype == np.int16 and got[1].dtype == np.uint32
    _check_packed(got, want)
    # and equal, as integers, to the port's own fp32 engine
    d32, m32 = WF.wavefront_dist_mult(adj, device="cpu")
    np.testing.assert_array_equal(
        np.where(got[0] == S.DIST_UNREACHED, np.inf, got[0]), d32)
    np.testing.assert_array_equal(got[1].astype(np.float32), m32)


def test_packed_batched_wavefront_bit_equal_all_families():
    graphs = [RT.by_servers(fam, 300) for fam in RT.families()]
    p = max(g.n for g in graphs)
    stack = np.zeros((len(graphs), p, p), np.float32)
    for i, g in enumerate(graphs):
        stack[i, :g.n, :g.n] = g.adjacency_dense(np.float32)
    want = RWF.wavefront_dist_mult(stack, packed=True)
    got = WF.wavefront_dist_mult(stack, packed=True, device="cpu")
    _check_packed(got, want)


def test_packed_device_engine_returns_cells_and_flag():
    adj = RT.make("slimfly", q=5).adjacency_dense(np.uint8)
    p = WF.pad_block(adj.shape[0])
    dist, mult, sat, (levels, sizes) = WF.dist_mult_device(
        torch.from_numpy(WF.pad_operand(adj, p, 0, np.uint8)),
        telemetry=True, packed=True)
    assert dist.dtype == S.DIST_DTYPE and mult.dtype == S.MULT_DTYPE
    assert sat.dtype == torch.bool and not bool(sat)
    # diameter 2, plus the confirmation level
    assert levels == 3 and int(sizes[3]) == 0


# -- saturation: clamp + flag, never wrap --------------------------------------

def _multiplier_chain(width: int, stages: int) -> np.ndarray:
    """Chained K_{1,width,1} blocks: sigma(source, stage-s tail) =
    width**s, so a handful of stages overflows 2**24 deterministically."""
    edges = []
    node = 1
    prev = 0
    for _ in range(stages):
        mids = list(range(node, node + width))
        tail = node + width
        node = tail + 1
        edges += [(prev, v) for v in mids] + [(v, tail) for v in mids]
        prev = tail
    return RGraph(n=node, edges=np.array(edges)).adjacency_dense(np.float32)


def test_saturation_clamps_and_flags_never_wraps():
    adj = _multiplier_chain(width=48, stages=5)    # 48**5 = 2**27.9 > 2**24
    with pytest.warns(RuntimeWarning, match="saturat"):
        d, m = WF.wavefront_dist_mult(adj, packed=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = RWF.wavefront_dist_mult(adj, packed=True)
    _check_packed((d, m), want)
    true_sigma = 48.0 ** np.arange(6)
    for s in range(1, 6):
        tail = s * 49
        assert int(m[0, tail]) == int(min(true_sigma[s], S.MULT_SAT))
        assert int(d[0, tail]) == 2 * s
    # clamped EXACTLY at MULT_SAT: a wrap would show 48**5 mod 2**32
    assert int(m[0, 5 * 49]) == S.MULT_SAT


def test_unsaturated_packed_counts_are_exact_and_silent():
    adj = _multiplier_chain(width=8, stages=5)     # 8**5 = 2**15 << 2**24
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        d, m = WF.wavefront_dist_mult(adj, packed=True, device="cpu")
    assert int(m[0, 5 * 9]) == 8 ** 5
    _check_packed((d, m), RWF.wavefront_dist_mult(adj, packed=True))


def test_pack_unpack_dist_round_trip():
    d = np.asarray([0.0, 1.0, 300.0, np.inf, 32766.0], np.float32)
    want = np.asarray(RS.pack_dist(jnp.asarray(d)))
    packed = S.pack_dist(torch.from_numpy(d))
    assert packed.dtype == S.DIST_DTYPE and int(packed[3]) == S.DIST_UNREACHED
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(S.unpack_dist(packed).numpy(), d)
    np.testing.assert_array_equal(
        S.unpack_dist(packed).numpy(),
        np.asarray(RS.unpack_dist(jnp.asarray(want))))


def test_packed_constants_match_the_jax_package():
    assert S.DIST_UNREACHED == RS.DIST_UNREACHED
    assert S.MULT_SAT == RS.MULT_SAT
    assert np.dtype(S.HOST_MULT_DTYPE) == np.dtype(RS.MULT_DTYPE)
    assert S.DIST_DTYPE == torch.int16

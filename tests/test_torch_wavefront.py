"""repro_torch.core.analysis.wavefront vs the JAX wavefront engine, on the CPU.

Both packages get the same adjacency (numpy, from the same generator). The
JAX engine runs its Pallas kernels in interpret mode; the port runs its
kernels' plain versions on CPU tensors. Tolerances: dist and mult
bit-equal (integer counts below 2**24); ECMP loads rtol 1e-5 (they divide by
sigma, so they are held to f32 round-off, as the JAX engine's own tests
hold its device loads).
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import topology as RT
from repro.core.analysis import wavefront as RWF
from repro_torch.core.analysis import wavefront as WF
from repro_torch.kernels import semiring as S

_CASES = [("slimfly", {"q": 5}), ("torus", {"dims": (6, 5)}),
          ("hypercube", {"dim": 5}), ("dragonfly", {"h": 2})]


def _adj(fam, params):
    return RT.make(fam, **params).adjacency_dense(np.float32)


@pytest.mark.parametrize("fam,params", _CASES,
                         ids=[c[0] for c in _CASES])
def test_dist_mult_2d_bit_equal(fam, params):
    adj = _adj(fam, params)
    d_ref, m_ref = RWF.wavefront_dist_mult(adj)
    dist, mult = WF.wavefront_dist_mult(adj, device="cpu")
    np.testing.assert_array_equal(dist, d_ref)
    np.testing.assert_array_equal(mult, m_ref)


def _stack():
    adjs = [_adj(f, p) for f, p in _CASES]
    n = max(a.shape[0] for a in adjs)
    out = np.zeros((len(adjs), n, n), np.float32)
    for i, a in enumerate(adjs):
        out[i, :a.shape[0], :a.shape[0]] = a
    return out


def test_batched_dist_mult_and_loads_match():
    adj = _stack()
    d_ref, m_ref = RWF.wavefront_dist_mult(adj)
    dist, mult = WF.wavefront_dist_mult(adj, device="cpu")
    np.testing.assert_array_equal(dist, d_ref)
    np.testing.assert_array_equal(mult, m_ref)

    p = RWF.pad_block(adj.shape[-1], batched=True)[0]
    assert WF.pad_block(adj.shape[-1]) == p == 128
    pad = [WF.pad_operand(x, p, fill) for x, fill in
           ((d_ref, np.inf), (m_ref, 0.0), (adj, 0.0))]
    want = np.asarray(RWF.ecmp_loads_device(*map(jnp.asarray, pad)))
    got = WF.ecmp_loads_device(*map(torch.from_numpy, pad)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got.max() > 0 and np.isfinite(got).all()


def test_levels_are_diameter_plus_one_and_counts_stay_zero():
    S.reset_launches()
    d_ref, _ = RWF.wavefront_dist_mult(_stack())
    diam = int(d_ref[np.isfinite(d_ref)].max())
    adj = torch.from_numpy(WF.pad_operand(_stack(), 128, 0.0))
    dist, mult, (levels, sizes) = WF.dist_mult_device(adj, telemetry=True)
    assert diam == int(dist[torch.isfinite(dist)].max())
    assert levels == diam + 1
    attrs = WF.telemetry_attrs((levels, sizes))
    assert attrs["converged_level"] == diam
    assert len(attrs["levels_per_graph"]) == len(_CASES)
    assert sum(attrs["frontier_sizes"]) == int(
        (torch.isfinite(dist) & (dist > 0)).sum())
    assert S.launches == {"frontier_step": 0, "count_matmul": 0}


def test_pad_operand_fills_phantoms():
    x = np.ones((2, 3, 3), np.float32)
    y = WF.pad_operand(x, 5, np.inf)
    assert y.shape == (2, 5, 5) and np.isinf(y[:, 3:, :]).all()
    assert WF.pad_operand(x, 3, 0.0) is x
    assert [WF.pad_block(n) for n in (1, 128, 129, 2025)] == [128, 128, 256,
                                                              2048]


def test_warns_when_counts_pass_f32_exact_range():
    with pytest.warns(RuntimeWarning, match="exact"):
        WF._warn_if_inexact(np.array([2.0 ** 24 + 2]))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        WF._warn_if_inexact(np.array([2.0 ** 24]))


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WF.wavefront_dist_mult(_adj("slimfly", {"q": 5}))

"""repro_torch.core.analysis vs the JAX package's analysis, on the CPU.

Both packages get the same graph: the JAX package's generator builds it and
the port rebuilds it from plain arrays (``graph_from_arrays``). The JAX
package runs its Pallas kernels in interpret mode; the port runs its
kernels' plain versions on CPU tensors. Tolerances:

* dist, multiplicities, slack counts, histograms and every integer report
  key: bit-equal / exact (integer counts below 2**24 are exact in any
  summation order);
* float report keys: rtol 1e-5 (the same host arithmetic on bit-equal
  matrices, plus ECMP loads held to f32 round-off);
* spectral keys: rtol 1e-5 when both packages start the power iteration
  from the same vector, rtol 1e-3 when each draws its own (the iteration
  stops after a fixed count, so the result depends on the start).
"""
import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import topology as RT
from repro.core.analysis import AnalysisEngine as RAnalysisEngine
from repro.core.analysis import analyze as r_analyze
from repro.core.analysis import apsp as RA
from repro.core.analysis import histograms as RH
from repro.core.analysis import paths as RP
from repro.core.analysis import spectral as RS
from repro.core.analysis import wavefront as RWF
from repro.core.graph import Graph as RGraph
from repro_torch.core import topology as T
from repro_torch.core.analysis import (AnalysisEngine, analyze, apsp,
                                       histograms, paths, spectral)
from repro_torch.core.analysis import wavefront as WF
from repro_torch.core.graph import graph_from_arrays
from repro_torch.kernels import semiring as S

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "analysis" / "reference.json"

_CASES = {
    "slimfly": lambda: RT.make("slimfly", q=5),
    "torus": lambda: RT.make("torus", dims=(6, 5)),
    "hypercube": lambda: RT.make("hypercube", dim=5),
    "dragonfly": lambda: RT.make("dragonfly", h=2),
    "disconnected": lambda: RGraph(n=7, edges=np.array(
        [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 6)]), name="two-parts"),
    "edgeless": lambda: RGraph(n=4, edges=np.empty((0, 2)), name="isolated"),
}
_SPECTRAL = ("fiedler_lambda2", "laplacian_lambda_max",
             "bisection_lower_bound", "edge_expansion_lower_bound",
             "diameter_upper_bound")


def _pair(case):
    """(JAX-package graph, the same graph and spec in the port)."""
    r = _CASES[case]()
    s = r.meta.get("spec")
    fields = None
    if s is not None:
        fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
        fields["link_classes"] = [dataclasses.asdict(lc)
                                  for lc in s.link_classes]
    return r, graph_from_arrays(r.n, np.asarray(r.edges), r.concentration,
                                r.name, fields)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_reports_match(got, want, spectral_rtol=1e-3):
    assert got.keys() == want.keys(), set(got) ^ set(want)
    for key, w in want.items():
        g = got[key]
        if key in _SPECTRAL:
            np.testing.assert_allclose(g, w, rtol=spectral_rtol, err_msg=key)
        elif isinstance(w, float):
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=key)
        else:
            assert g == w, (key, g, w)


@pytest.fixture(autouse=True)
def _no_launches():
    S.reset_launches()
    yield
    # everything here runs on CPU tensors: no kernel may launch
    assert not any(S.launches.values()), S.launches


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("use_kernel", [True, False])
def test_path_counts_with_slack_bit_equal(case, use_kernel):
    r, g = _pair(case)
    dist = np.asarray(RA.apsp_dense(r, use_kernel=False))
    want = RP.path_counts_with_slack(r, dist, use_kernel=use_kernel)
    got = paths.path_counts_with_slack(g, dist, use_kernel=use_kernel,
                                       device="cpu")
    for key in ("multiplicity", "plus1", "plus2"):
        np.testing.assert_array_equal(_np(got[key]), want[key], err_msg=key)
    assert got["exact"] and bool(want["exact"])


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("use_kernel", [True, False])
def test_shortest_path_multiplicity_bit_equal(case, use_kernel):
    r, g = _pair(case)
    d_ref, m_ref = RP.shortest_path_multiplicity(r, use_kernel=use_kernel)
    dist, mult = paths.shortest_path_multiplicity(g, use_kernel=use_kernel,
                                                  device="cpu")
    np.testing.assert_array_equal(_np(dist), d_ref)
    np.testing.assert_array_equal(_np(mult), m_ref)
    # the masked branch, from a given distance matrix
    _, m_masked = paths.shortest_path_multiplicity(
        g, torch.from_numpy(np.array(d_ref)), use_kernel=use_kernel)
    np.testing.assert_array_equal(_np(m_masked), m_ref)


@pytest.mark.parametrize("case", ["slimfly", "torus", "dragonfly",
                                  "disconnected"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_tropical_count_relaxation_bit_equal(case, use_kernel):
    r, g = _pair(case)
    d_ref, c_ref = RP.tropical_count_relaxation(r, use_kernel=use_kernel)
    d, c = paths.tropical_count_relaxation(g, use_kernel=use_kernel,
                                           device="cpu")
    np.testing.assert_array_equal(_np(d), d_ref)
    np.testing.assert_array_equal(_np(c), c_ref)
    # and the oracle agrees with the wavefront engine it checks
    dw, mw = WF.wavefront_dist_mult(g.adjacency_dense(np.float32),
                                    device="cpu")
    np.testing.assert_array_equal(_np(d), dw)
    np.testing.assert_array_equal(_np(c), mw)


@pytest.mark.parametrize("case", list(_CASES))
def test_analyze_matches(case):
    r, g = _pair(case)
    # a disconnected graph's lambda_2 is 0 up to the iteration's round-off,
    # whose sign decides whether diameter_upper_bound exists: its spectral
    # keys are held to 0 apart from the report
    spectral_keys = case != "disconnected"
    want = r_analyze(r, spectral=spectral_keys)
    got = analyze(g, spectral=spectral_keys, device="cpu")
    _assert_reports_match(got, want)
    if not spectral_keys:
        lam2 = spectral.fiedler_value(g, device="cpu")
        assert abs(lam2) < 1e-4 and abs(RS.fiedler_value(r)) < 1e-4


_STAGES = RAnalysisEngine.STAGES


@pytest.mark.parametrize("stage", _STAGES)
def test_each_engine_stage_matches(stage):
    r, g = _pair("dragonfly")
    kw = dict(throughput_demand="all-pairs", throughput_eps=0.25)
    want = RAnalysisEngine(r, **kw).report([stage])
    got = AnalysisEngine(g, device="cpu", **kw).report([stage])
    _assert_reports_match(got, want)


@pytest.mark.parametrize("case", ["slimfly", "torus", "dragonfly"])
def test_spectral_with_a_shared_start_vector(case):
    """Counterpart of a weight converter: both power iterations start from
    the vector JAX draws from its own key."""
    r, g = _pair(case)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (r.n,),
                                      jnp.float32))
    v1 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (r.n,),
                                      jnp.float32))
    np.testing.assert_allclose(
        spectral.fiedler_value(g, v0=v0, device="cpu"),
        RS.fiedler_value(r), rtol=1e-5)
    np.testing.assert_allclose(
        spectral.lambda_max(g, v0=v1, device="cpu"), RS.lambda_max(r),
        rtol=1e-5)


def test_spectral_start_vector_comes_from_the_seed():
    _, g = _pair("torus")
    a = spectral.fiedler_value(g, seed=3, iters=5, device="cpu")
    assert a == spectral.fiedler_value(g, seed=3, iters=5, device="cpu")
    assert a != spectral.fiedler_value(g, seed=4, iters=5, device="cpu")


@pytest.mark.parametrize("case", ["slimfly", "disconnected"])
def test_apsp_dense_methods_match(case):
    r, g = _pair(case)
    want = np.asarray(RA.apsp_dense(r, use_kernel=False))
    for kw in ({}, {"method": "squaring"}, {"use_kernel": False}):
        np.testing.assert_array_equal(
            _np(apsp.apsp_dense(g, device="cpu", **kw)), want, err_msg=kw)


def test_weighted_squaring_bit_equal():
    """Weighted APSP: the port's squaring loop against the JAX device
    engine on the same padded seed, with the same squaring count."""
    r, g = _pair("dragonfly")
    rng = np.random.default_rng(0)
    lengths = g.distance_seed()
    lengths[np.isfinite(lengths) & (lengths > 0)] = rng.uniform(
        0.5, 4.0, int((np.isfinite(lengths) & (lengths > 0)).sum()))
    seed = WF.pad_operand(lengths, 128, np.inf)
    seed[np.arange(g.n, 128), np.arange(g.n, 128)] = 0.0
    want, n_want = RWF.squaring_apsp_device(jnp.asarray(seed), telemetry=True)
    got, n_got = WF.squaring_apsp_device(torch.from_numpy(seed),
                                         telemetry=True)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert n_got == int(n_want)
    for use_kernel in (True, False):
        np.testing.assert_array_equal(
            _np(apsp.apsp_from_lengths(lengths, use_kernel=use_kernel,
                                       device="cpu")),
            np.asarray(RA.apsp_from_lengths(lengths, use_kernel=False)))


def test_path_length_histogram_matches():
    r, g = _pair("disconnected")
    dist = np.asarray(RA.apsp_dense(r, use_kernel=False))
    want = RH.path_length_histogram(dist)
    assert histograms.path_length_histogram(torch.tensor(dist)) == want
    assert histograms.path_length_histogram(dist, use_kernel=False) == want


def test_path_length_histogram_numpy_goes_to_the_named_device():
    r, _ = _pair("slimfly")
    dist = np.asarray(RA.apsp_dense(r, use_kernel=False))
    want = RH.path_length_histogram(dist)
    assert histograms.path_length_histogram(dist, device="cpu") == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            histograms.path_length_histogram(dist)


def test_unknown_stage_raises():
    _, g = _pair("slimfly")
    with pytest.raises(ValueError, match="unknown stages"):
        AnalysisEngine(g, device="cpu").report(["nope"])


def test_report_independent_of_cache_history():
    _, g = _pair("slimfly")
    fresh = AnalysisEngine(g, device="cpu").report(["distances", "diversity"])
    warm = AnalysisEngine(g, device="cpu")
    warm.multiplicities()  # populate the cache first
    assert fresh == warm.report(["distances", "diversity"])
    assert "edge_interference_mean" not in fresh


def test_stages_share_one_apsp_and_keep_device_tensors():
    _, g = _pair("slimfly")
    eng = AnalysisEngine(g, device="cpu")
    d1 = eng.distances()
    rep = eng.report(AnalysisEngine.DEFAULT_STAGES + ("comparison",))
    assert eng.distances() is d1  # cached, not recomputed
    assert torch.is_tensor(eng._cache["dist"])
    assert torch.is_tensor(eng._cache["paths"]["plus2"])
    assert 0 < rep["ecmp_saturation_throughput"] <= 1


def test_sampled_mode_matches():
    r, g = _pair("torus")
    want = RAnalysisEngine(r, dense_limit=10, n_sources=8).report()
    got = AnalysisEngine(g, dense_limit=10, n_sources=8,
                         device="cpu").report()
    _assert_reports_match(got, want)
    assert got["exact"] is False


_MESH = types.SimpleNamespace(size=2)


# the tiled and packed engines are ported (tests/test_torch_extreme.py);
# with a mesh they still need the composed engine, which is not
@pytest.mark.parametrize("kw", [{"tile_rows": 64, "mesh": _MESH},
                                {"packed": True, "mesh": _MESH},
                                {"mesh": _MESH}],
                         ids=["tiled", "packed", "mesh"])
def test_unported_engines_raise(kw):
    _, g = _pair("slimfly")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        AnalysisEngine(g, device="cpu", **kw).distances()


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, g = _pair("slimfly")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze(g)


# -- the committed full-width reference ----------------------------------------

def _reference():
    return json.loads(REFERENCE.read_text())


def test_reference_is_complete():
    ref = _reference()
    assert list(ref["reports"]) == ["dragonfly", "fattree", "hyperx",
                                    "jellyfish", "slimfly", "xpander"]
    assert sorted(ref["throughput"]) == ["fattree", "slimfly"]


def _reproduce_report(family):
    ref = _reference()
    want = ref["reports"][family]
    g = T.by_servers(family, ref["servers"]["reports"])
    got = AnalysisEngine(g, device="cpu").report(
        AnalysisEngine.DEFAULT_STAGES + ("comparison",))
    # at full width 150 iterations leave lambda_max short of convergence
    # (jellyfish and xpander differ by ~1e-3 between start vectors), so
    # spectral keys are held to rtol 1e-2, as chip_smoke.py holds them
    _assert_reports_match(got, want, spectral_rtol=1e-2)


def test_reference_slimfly_row_reproduces():
    _reproduce_report("slimfly")


@pytest.mark.slow
@pytest.mark.parametrize("family", ["jellyfish", "xpander", "hyperx",
                                    "dragonfly", "fattree"])
def test_reference_rows_reproduce(family):
    _reproduce_report(family)

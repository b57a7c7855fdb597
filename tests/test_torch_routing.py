"""repro_torch.core.routing, workload and obs.report vs the JAX package's,
on the CPU.

Both packages get the same graph: the JAX package's generator builds it and
the port rebuilds it from plain arrays (``graph_from_arrays``); demand comes
from the same seeded numpy spec. The JAX package runs its Pallas kernels in
interpret mode; the port runs its kernels' plain versions on CPU tensors.
Tolerances:

* float64 paths (``use_kernel=False``): rtol 1e-12 — the same arithmetic on
  bit-equal distances and counts, summed in another order;
* fp32 kernel paths: rtol 1e-5 against the JAX kernel path (loads divide by
  sigma, so they are held to f32 round-off, as every ECMP check is);
* distances, counts, next-hop tensors, sampled paths and the weighted
  Brandes engine under a demand of ones against the uniform one:
  bit-equal.
"""
import json
import pathlib
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import routing as RR
from repro.core import topology as RT
from repro.core import workload as RW
from repro.core.analysis import AnalysisEngine as RAnalysisEngine
from repro.core.analysis import wavefront as RWF
from repro.core.graph import Graph as RGraph
from repro.core.routing import assign as RA
from repro.core.traffic import TrafficSpec as RTrafficSpec
from repro.obs import report as RREP
from repro_torch import obs
from repro_torch.core import routing as R
from repro_torch.core import topology as T
from repro_torch.core import workload as W
from repro_torch.core.analysis import AnalysisEngine
from repro_torch.core.analysis import wavefront as WF
from repro_torch.core.graph import graph_from_arrays
from repro_torch.core.routing import assign as A
from repro_torch.core.traffic import TrafficSpec
from repro_torch.kernels import semiring as S
from repro_torch.obs import report as REP

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "routing" / "reference.json"

_RING = np.array([(i, (i + 1) % 8) for i in range(8)])
_CASES = {
    "slimfly": lambda: RT.make("slimfly", q=5),
    "ring": lambda: RGraph(n=8, edges=_RING, name="C8"),
    "torus": lambda: RT.make("torus", dims=(4, 4)),
    "two-parts": lambda: RGraph(n=7, edges=np.array(
        [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 6)]), name="two-parts"),
}
#: dense non-integer demand (every level) and sparse flows (some levels
#: empty, so the engines skip them)
_DEMANDS = ("hotspot:zipf_a=1.4,seed=1", "permutation:flows=12,seed=3")
_MODELS = ("uniform_shortest", "valiant", "slack")
F64 = dict(rtol=1e-12, atol=0)
F32 = dict(rtol=1e-5, atol=0)


def _pair(case):
    r = _CASES[case]()
    return r, graph_from_arrays(r.n, np.asarray(r.edges), r.concentration,
                                r.name)


def _engines(case, use_kernel):
    r, g = _pair(case)
    return (RAnalysisEngine(r, use_kernel=use_kernel),
            AnalysisEngine(g, use_kernel=use_kernel, device="cpu"))


def _demand(r, text=_DEMANDS[0]):
    return RTrafficSpec.parse(text).matrix(r)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(autouse=True)
def _no_launches():
    S.reset_launches()
    yield
    # everything here runs on CPU tensors: no kernel may launch
    assert not any(S.launches.values()), S.launches


def test_exports_match_the_jax_package():
    assert sorted(R.__all__) == sorted(RR.__all__)
    assert sorted(A.__all__) == sorted(RA.__all__)
    assert sorted(R.MODELS) == sorted(RR.MODELS)


# -- assign ---------------------------------------------------------------------

@pytest.mark.parametrize("demand", _DEMANDS, ids=["hotspot", "flows"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["f64", "kernel"])
@pytest.mark.parametrize("case", list(_CASES))
def test_ecmp_link_loads(case, use_kernel, demand):
    re, e = _engines(case, use_kernel)
    dist, mult = re.distances(), re.multiplicities()["multiplicity"]
    dem = _demand(re.g, demand)
    tol = F32 if use_kernel else F64
    want = RA.ecmp_link_loads(re.g, dist, mult, dem, use_kernel=use_kernel,
                              directed=True)
    got = A.ecmp_link_loads(e.g, dist, mult, dem, use_kernel=use_kernel,
                            directed=True, device="cpu")
    assert torch.is_tensor(got) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **tol)
    und = A.ecmp_link_loads(e.g, torch.tensor(dist), mult, dem,
                            use_kernel=use_kernel)
    assert isinstance(und, np.ndarray) and und.dtype == np.float64
    np.testing.assert_allclose(und, RA.ecmp_link_loads(
        re.g, dist, mult, dem, use_kernel=use_kernel), **tol)


@pytest.mark.parametrize("form", ["2d", "shared", "per-graph"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["f64", "kernel"])
@pytest.mark.parametrize("case", list(_CASES))
def test_ecmp_demand_loads(case, use_kernel, form):
    re, _ = _engines(case, False)
    r = re.g
    dist, mult = re.distances(), re.multiplicities()["multiplicity"]
    adj = r.adjacency_dense(np.float64)
    batch = RTrafficSpec.parse("hotspot:samples=3,seed=7").batch(r)
    if form == "2d":
        args = (dist, mult, adj, batch[0])
    elif form == "shared":
        args = (dist, mult, adj, batch)
    else:  # per-sample graphs against per-sample demand
        args = tuple(np.stack([x] * 3) for x in (dist, mult, adj)) + (batch,)
    want = RA.ecmp_demand_loads(*args, use_kernel=use_kernel)
    got = A.ecmp_demand_loads(*args, use_kernel=use_kernel, device="cpu")
    np.testing.assert_allclose(_np(got), want, **(F32 if use_kernel else F64))
    if not use_kernel:
        # the Brandes engine == the bilinear engine, per sample
        rows = batch[:1] if form == "2d" else batch
        oracle = np.stack([_np(A.ecmp_link_loads(
            _pair(case)[1], dist, mult, d, use_kernel=False, directed=True,
            device="cpu")) for d in rows])
        np.testing.assert_allclose(_np(got).reshape(oracle.shape), oracle,
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", list(_CASES))
def test_weighted_ecmp_loads_device(case):
    """The port's weighted Brandes loop against the JAX package's (padded,
    Pallas interpret mode), and a demand of ones on the reachable
    off-diagonal pairs bit-equal to the uniform loop."""
    re, _ = _engines(case, True)
    r = re.g
    dist, mult = re.distances(), re.multiplicities()["multiplicity"]
    adj = r.adjacency_dense(np.float32)
    dem = _demand(r).astype(np.float32)
    p, block = RWF.pad_block(r.n)
    want = RWF.ecmp_loads_device(
        jnp.asarray(RWF.pad_operand(dist, p, np.inf)),
        jnp.asarray(RWF.pad_operand(mult, p, 0.0)),
        jnp.asarray(RWF.pad_operand(adj, p, 0.0)),
        demand=jnp.asarray(RWF.pad_operand(dem, p, 0.0)), block=block)
    t = [torch.tensor(np.asarray(x, np.float32))
         for x in (dist, mult, adj, dem)]
    got = WF.ecmp_loads_device(*t[:3], demand=t[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:r.n, :r.n],
                               **F32)
    ones = (torch.isfinite(t[0]) & (t[0] > 0)).float()
    np.testing.assert_array_equal(
        WF.ecmp_loads_device(*t[:3], demand=ones).numpy(),
        WF.ecmp_loads_device(*t[:3]).numpy())
    # and through the routing entry points
    np.testing.assert_array_equal(
        A.ecmp_demand_loads(*t[:3], ones).numpy(),
        A.ecmp_all_pairs_loads(*t[:3]).numpy())


def test_weighted_engine_bit_equal_on_a_stack():
    """Per-sample graphs (the sweep's stacked form): a demand of ones on
    the reachable pairs gives the uniform loads bit for bit."""
    gs = [_pair(c)[1] for c in ("slimfly", "torus")]
    p = 64
    adj = torch.zeros((2, p, p))
    for i, g in enumerate(gs):
        adj[i, :g.n, :g.n] = torch.from_numpy(g.adjacency_dense(np.float32))
    dist, mult = WF.dist_mult_device(adj)
    ones = (torch.isfinite(dist) & (dist > 0)).float()
    np.testing.assert_array_equal(
        A.ecmp_demand_loads(dist, mult, adj, ones).numpy(),
        A.ecmp_all_pairs_loads(dist, mult, adj).numpy())


@pytest.mark.parametrize("slack", [0, 1, 2])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["f64", "kernel"])
@pytest.mark.parametrize("case", list(_CASES))
def test_walk_slack_link_loads(case, use_kernel, slack):
    re, e = _engines(case, use_kernel)
    model = RR.SlackRouting.from_engine(re, slack=slack)
    probs = list(model.class_probabilities())
    dem = _demand(re.g)
    want = RA.walk_slack_link_loads(re.g, re.distances(), dem, slack, probs,
                                    use_kernel=use_kernel)
    got = A.walk_slack_link_loads(e.g, re.distances(), dem, slack, probs,
                                  use_kernel=use_kernel, device="cpu")
    np.testing.assert_allclose(got, want, **(F32 if use_kernel else F64))


@pytest.mark.parametrize("prefix", ["", "expected_"])
def test_link_load_stats(prefix):
    loads = np.random.default_rng(0).random(40) * (np.arange(40) % 3 > 0)
    want = RA.link_load_stats(loads, 50, prefix=prefix)
    assert A.link_load_stats(loads, 50, prefix=prefix) == want
    assert A.link_load_stats(torch.from_numpy(loads), 50,
                             prefix=prefix) == want
    assert A.link_load_stats(np.zeros(5), 5, prefix=prefix) == \
        RA.link_load_stats(np.zeros(5), 5, prefix=prefix)


def test_directed_fold_of_a_tensor_is_host_float64():
    _, g = _pair("slimfly")
    d = torch.rand((g.n, g.n), dtype=torch.float32)
    got = A.directed_to_link_loads(g, d)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    dn = d.double().numpy()
    np.testing.assert_array_equal(got, A.directed_to_link_loads(g, dn))


# -- models ---------------------------------------------------------------------

@pytest.mark.parametrize("name", _MODELS)
@pytest.mark.parametrize("use_kernel", [False, True], ids=["f64", "kernel"])
@pytest.mark.parametrize("case", list(_CASES))
def test_model_matches(case, use_kernel, name):
    re, e = _engines(case, use_kernel)
    kw = {"slack": 2} if name == "slack" else {}
    want = RR.make_model(name, re, **kw)
    got = R.make_model(name, e, **kw)
    assert got.name == want.name and got.device == torch.device("cpu")
    tol = F32 if use_kernel else F64
    for text in _DEMANDS:
        dem = _demand(re.g, text)
        np.testing.assert_allclose(got.link_loads(dem), want.link_loads(dem),
                                   **tol)
        assert got.average_hops(dem) == pytest.approx(
            want.average_hops(dem), rel=tol["rtol"])
        assert got.disconnected_fraction(dem) == pytest.approx(
            want.disconnected_fraction(dem), rel=1e-12)
        np.testing.assert_allclose(_np(got.directed_link_loads(dem)),
                                   want.directed_link_loads(dem), **tol)
    assert got.disconnected_fraction() == pytest.approx(
        want.disconnected_fraction(), rel=1e-12)
    if name == "slack":
        np.testing.assert_allclose(got.class_probabilities().numpy(),
                                   want.class_probabilities(), **F64)
        with pytest.raises(NotImplementedError):
            got.next_hop_tensor()
    else:
        np.testing.assert_array_equal(got.next_hop_tensor(),
                                      want.next_hop_tensor())
        np.testing.assert_array_equal(got.next_hop_tensor([0, 3]),
                                      want.next_hop_tensor([0, 3]))


def test_from_engine_shares_the_engine_tensors():
    _, e = _engines("slimfly", True)
    model = R.SlackRouting.from_engine(e, slack=1)
    assert model.dist is e._cache["dist"]
    assert model.path_counts is e._cache["paths"]
    assert model.mult is e._cache["paths"]["multiplicity"]
    assert model.use_kernel and model.device == e.device
    vlb = R.ValiantVLB.from_engine(e)
    assert vlb.minimal.dist is vlb.dist


def test_models_need_the_dense_apsp():
    _, g = _pair("torus")
    with pytest.raises(ValueError, match="dense APSP"):
        R.UniformShortest.from_engine(AnalysisEngine(g, dense_limit=4,
                                                     device="cpu"))


def test_slack_rejects_out_of_range():
    _, e = _engines("ring", False)
    with pytest.raises(ValueError, match="slack must be 0..2"):
        R.SlackRouting.from_engine(e, slack=3)


def test_models_keep_numpy_operands_on_the_named_device():
    re, e = _engines("torus", False)
    dist, mult = re.distances(), re.multiplicities()["multiplicity"]
    model = R.UniformShortest(e.g, dist, mult, use_kernel=False,
                              device="cpu")
    dem = _demand(re.g)
    np.testing.assert_allclose(model.link_loads(dem), RR.UniformShortest(
        re.g, dist, mult, use_kernel=False).link_loads(dem), **F64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            R.UniformShortest(e.g, dist, mult)


# -- the JAX package's routing contracts, on the port ----------------------------

@pytest.mark.parametrize("case", list(_CASES))
def test_next_hop_tensor_row_stochastic(case):
    _, e = _engines(case, False)
    P = R.UniformShortest.from_engine(e).next_hop_tensor()
    dist = e.distances()
    rows = P.sum(axis=2).T          # rows[u, t] = sum_v P[t][u, v]
    reach = np.isfinite(dist) & (dist > 0)
    np.testing.assert_allclose(rows[reach], 1.0, atol=1e-12)
    assert (rows[~reach] == 0).all()
    assert (P >= 0).all()


def test_ecmp_conserves_hops():
    _, e = _engines("torus", False)
    g = e.g
    dist = e.distances()
    demand = np.ones((g.n, g.n)) - np.eye(g.n)
    loads = A.ecmp_link_loads(g, dist, e.shortest_path_mult(), demand,
                              use_kernel=False, device="cpu")
    assert loads.sum() == pytest.approx(dist[demand > 0].sum())


def test_valiant_average_hops_about_double_minimal():
    for g in (T.make("slimfly", q=5), T.make("hypercube", dim=4)):
        eng = AnalysisEngine(g, use_kernel=False, device="cpu")
        dist = eng.distances()
        off = ~np.eye(g.n, dtype=bool)
        demand = off.astype(float)
        h_min = R.UniformShortest.from_engine(eng).average_hops(demand)
        h_vlb = R.ValiantVLB.from_engine(eng).average_hops(demand)
        want = 2.0 * dist[off].mean() * (g.n - 1) / g.n
        assert h_vlb == pytest.approx(want, rel=1e-9)
        assert 1.5 * h_min < h_vlb < 2.5 * h_min


def test_valiant_beats_minimal_on_tornado_permutation():
    _, e = _engines("ring", False)
    n = e.g.n
    demand = np.zeros((n, n))
    demand[np.arange(n), (np.arange(n) + 3) % n] = 1.0
    assert R.ValiantVLB.from_engine(e).directed_link_loads(demand).max() < \
        R.UniformShortest.from_engine(e).directed_link_loads(demand).max()


@pytest.mark.parametrize("use_kernel", [False, True], ids=["f64", "kernel"])
def test_slack_zero_equals_ecmp(use_kernel):
    _, e = _engines("slimfly", use_kernel)
    demand = np.ones((e.g.n, e.g.n)) - np.eye(e.g.n)
    np.testing.assert_allclose(
        R.SlackRouting.from_engine(e, slack=0).link_loads(demand),
        R.UniformShortest.from_engine(e).link_loads(demand),
        rtol=1e-9 if not use_kernel else 1e-5)


def test_slack_class_probabilities_normalized():
    _, g = _pair("torus")
    e = AnalysisEngine(g, use_kernel=False, device="cpu")
    probs = R.SlackRouting.from_engine(e, slack=2).class_probabilities()
    dist = e.distances()
    off = np.isfinite(dist) & (dist > 0)
    np.testing.assert_allclose(probs.sum(dim=0).numpy()[off], 1.0,
                               atol=1e-12)
    assert (probs >= 0).all()


def test_slack_conserves_expected_hops():
    g = T.make("hypercube", dim=3)
    e = AnalysisEngine(g, use_kernel=False, device="cpu")
    dist = e.distances()
    off = ~np.eye(g.n, dtype=bool)
    demand = off.astype(float)
    s1 = R.SlackRouting.from_engine(e, slack=1)
    probs = s1.class_probabilities().numpy()
    want = (demand * (probs[0] * dist + probs[1] * (dist + 1)))[off].sum()
    assert float(s1.directed_link_loads(demand).sum()) == pytest.approx(want)


def test_slack_longer_but_flatter_than_ecmp_on_ring():
    _, e = _engines("ring", False)
    n = e.g.n
    demand = np.zeros((n, n))
    demand[0, 3] = 1.0
    ecmp = R.UniformShortest.from_engine(e)
    s2 = R.SlackRouting.from_engine(e, slack=2)
    assert s2.average_hops(demand) == pytest.approx(4.0)  # (3 + 5) / 2
    assert ecmp.average_hops(demand) == pytest.approx(3.0)
    assert (s2.link_loads(demand) > 0).sum() == n
    assert (ecmp.link_loads(demand) > 0).sum() == 3


def test_make_model_registry():
    _, e = _engines("torus", False)
    for name in _MODELS:
        assert R.make_model(name, e).name == name
    with pytest.raises(KeyError):
        R.make_model("nope", e)


def test_ecmp_loads_skip_empty_levels(monkeypatch):
    """One pair at distance 2 on a ring: the engine runs the level-2 terms
    only (2 terms of 2 products), never level 1's."""
    _, e = _engines("ring", True)
    demand = np.zeros((8, 8))
    demand[0, 2] = 1.0
    model = R.UniformShortest.from_engine(e)  # path counts run here
    calls = []
    real = A.count_product

    def counted(use_kernel):
        product = real(use_kernel)
        return lambda a, b: (calls.append(a.shape), product(a, b))[1]

    monkeypatch.setattr(A, "count_product", counted)
    loads = model.link_loads(demand)
    assert len(calls) == 4
    assert loads.sum() == pytest.approx(2.0)


# -- workload -------------------------------------------------------------------

@pytest.mark.parametrize("model", [None, "valiant"])
@pytest.mark.parametrize("case", list(_CASES))
def test_evaluate_workload_matches(case, model):
    re, e = _engines(case, False)
    dist, mult = re.distances(), re.multiplicities()["multiplicity"]
    spec = "permutation:flows=64,seed=2"
    kw_r = {"model": RR.make_model(model, re)} if model else {"mult": mult}
    kw_p = {"model": R.make_model(model, e)} if model else {"mult": mult}
    want = RW.evaluate_workload(re.g, spec, dist=dist, seed=4, **kw_r)
    # the port's sampler reads device tensors as host float32
    got = W.evaluate_workload(e.g, spec, dist=torch.tensor(dist), seed=4,
                              device="cpu", **kw_p)
    assert got.keys() == want.keys()
    for key, w in want.items():
        if key.startswith("expected_") or key == "max_expected_link_load":
            assert got[key] == pytest.approx(w, rel=1e-12), key
        else:  # the sampled side: the same seeded draws
            assert got[key] == w, key


def test_sampler_bit_equal_and_unbiased():
    re, e = _engines("slimfly", False)
    dist, mult = re.distances(), re.multiplicities()["multiplicity"]
    pairs = RTrafficSpec.parse("permutation:flows=200,seed=3").pairs(re.g)
    wl = W.Workload(pairs=pairs)
    expected = W.expected_link_loads(e.g, wl, dist, mult, device="cpu")
    np.testing.assert_allclose(expected, RW.expected_link_loads(
        re.g, RW.Workload(pairs=pairs), dist, mult), **F64)
    acc = np.zeros_like(expected)
    for i in range(32):
        loads, hops = W.sample_flow_link_loads(
            e.g, torch.tensor(dist), pairs, np.random.default_rng(i),
            mult=torch.tensor(mult))
        want, want_hops = RW.sample_flow_link_loads(
            re.g, dist, pairs, np.random.default_rng(i), mult=mult)
        np.testing.assert_array_equal(loads, want)
        assert hops == want_hops
        acc += loads
    assert acc.sum() / 32 == pytest.approx(expected.sum())
    assert np.abs(acc / 32 - expected).max() < 0.25 * max(1.0,
                                                           expected.max())


def test_evaluate_workload_keys_volume_and_spec():
    _, e = _engines("slimfly", False)
    g = e.g
    dist, mult = e.distances(), e.shortest_path_mult()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        wl = W.make_traffic(g, "permutation", flows=256, seed=2)
    unit = W.evaluate_workload(g, wl, dist=dist, mult=mult, device="cpu")
    for key in ("max_link_load", "mean_link_load", "load_imbalance",
                "links_used", "links_total", "expected_max_link_load",
                "expected_mean_link_load", "expected_load_imbalance",
                "expected_links_used", "max_expected_link_load"):
        assert key in unit, key
    assert unit["max_expected_link_load"] == unit["expected_max_link_load"]
    assert unit["load_imbalance"] >= 1.0
    heavy = W.evaluate_workload(g, W.Workload(pairs=wl.pairs, volume=5.0),
                                dist=dist, mult=mult, device="cpu")
    assert heavy["max_link_load"] == pytest.approx(5 * unit["max_link_load"])
    assert heavy["expected_max_link_load"] == pytest.approx(
        5 * unit["expected_max_link_load"])
    rep = W.evaluate_workload(g, "permutation:flows=128,seed=5", dist=dist,
                              device="cpu")
    assert rep["flows"] == 128
    assert rep["workload"] == "permutation:flows=128,seed=5"
    assert "expected_max_link_load" not in rep
    vlb = R.ValiantVLB.from_engine(e)
    over = W.evaluate_workload(g, wl, dist=dist, model=vlb, device="cpu")
    assert over["expected_max_link_load"] == A.link_load_stats(
        vlb.link_loads(wl.demand_matrix(g)), g.num_edges,
        prefix="expected_")["expected_max_link_load"]


def test_evaluate_workload_runs_its_apsp_on_the_device():
    r, g = _pair("torus")
    want = RW.evaluate_workload(r, "uniform:flows=50", seed=1)
    assert W.evaluate_workload(g, "uniform:flows=50", seed=1,
                               device="cpu") == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            W.evaluate_workload(g, "uniform:flows=50")


def test_sampler_raises_on_inconsistent_distances():
    _, g = _pair("torus")
    dist = np.full((g.n, g.n), 4.0, np.float32)
    np.fill_diagonal(dist, 0.0)
    with pytest.raises(RuntimeError, match="routing loop"):
        W.sample_flow_link_loads(g, dist, np.array([[0, 4]]),
                                 np.random.default_rng(0))


# -- throughput under a TrafficSpec ---------------------------------------------

@pytest.mark.parametrize("spec", ["permutation:flows=40,seed=1",
                                  "hotspot:zipf_a=1.4"])
def test_max_concurrent_flow_takes_a_spec(spec):
    r, g = _pair("slimfly")
    want = RR.max_concurrent_flow(r, spec, eps=0.3, max_rounds=12, seed=2)
    got = R.max_concurrent_flow(g, spec, eps=0.3, max_rounds=12, seed=2,
                                device="cpu")
    again = R.max_concurrent_flow(g, TrafficSpec.parse(spec).matrix(g),
                                  eps=0.3, max_rounds=12, seed=2,
                                  device="cpu")
    assert got.keys() == want.keys() == again.keys()
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], again[key], err_msg=key)
        np.testing.assert_allclose(got[key], w, rtol=1e-9, err_msg=key)


# -- the two device repairs ------------------------------------------------------

def test_ecmp_all_pairs_loads_numpy_goes_to_the_named_device():
    re, _ = _engines("slimfly", False)
    dist, mult = re.distances(), re.multiplicities()["multiplicity"]
    adj = re.g.adjacency_dense(np.float64)
    for use_kernel in (True, False):
        want = A.ecmp_all_pairs_loads(*(torch.tensor(np.asarray(x))
                                        for x in (dist, mult, adj)),
                                      use_kernel=use_kernel)
        got = A.ecmp_all_pairs_loads(dist, mult, adj, use_kernel=use_kernel,
                                     device="cpu")
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                A.ecmp_all_pairs_loads(dist, mult, adj,
                                       use_kernel=use_kernel)


# -- obs.report -----------------------------------------------------------------

def test_obs_report_matches_the_jax_reporter(tmp_path, capsys):
    path = tmp_path / "trace.json"
    obs.enable()
    obs.reset()
    try:
        _, e = _engines("slimfly", True)
        with obs.span("routing", families=1):
            with obs.span("routing.model", model="valiant"):
                R.ValiantVLB.from_engine(e).link_loads(_demand(e.g))
            obs.record_h2d(1 << 20, "demand")
        obs.export(str(path))
    finally:
        obs.disable()
        obs.reset()
    events, other = REP.load_events(str(path))
    assert events and events == RREP.load_events(str(path))[0]
    text = REP.format_report(events, other)
    assert text == RREP.format_report(*RREP.load_events(str(path)))
    assert "routing.model" in text
    assert REP.main([str(path)]) == 0
    assert capsys.readouterr().out.strip() == text
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert REP.main([str(empty)]) == RREP.main([str(empty)]) == 2


# -- the committed full-width reference ------------------------------------------

def _reference():
    return json.loads(REFERENCE.read_text())


def test_reference_is_complete():
    ref = _reference()
    assert list(ref["families"]) == ["dragonfly", "fattree", "hyperx",
                                     "jellyfish", "slimfly", "xpander"]
    for row in ref["families"].values():
        assert sorted(row["models"]) == ["ecmp", "slack1", "valiant"]
        assert len(row["link_ids"]) == 64
    assert ref["throughput"]["routers"] == 338


def _reproduce_row(family):
    """The example's routing row through the port on the CPU, held as
    ``chip_smoke.py`` phase 10a holds the card's."""
    ref = _reference()
    want = ref["families"][family]
    g = T.by_servers(family, ref["servers"])
    assert (g.n, g.name) == (want["routers"], want["name"])
    eng = AnalysisEngine(g, device="cpu")
    spec = TrafficSpec.parse(ref["workload"])
    wl = W.Workload(pairs=spec.pairs(g), name=spec.describe())
    rep = W.evaluate_workload(g, wl, dist=eng._dist(),
                              mult=eng._paths()["multiplicity"],
                              device="cpu")
    assert rep.keys() == want["workload"].keys()
    for key, w in want["workload"].items():
        if isinstance(w, float) and key.startswith(("expected_", "max_exp")):
            assert rep[key] == pytest.approx(w, rel=1e-5), key
        else:
            assert rep[key] == w, key
    demand = wl.demand_matrix(g)
    ids = np.asarray(want["link_ids"])
    for key, model in (
            ("ecmp", R.UniformShortest.from_engine(eng, use_kernel=False)),
            ("valiant", R.ValiantVLB.from_engine(eng, use_kernel=False)),
            ("slack1", R.SlackRouting.from_engine(eng, slack=1,
                                                  use_kernel=False))):
        loads = model.link_loads(demand)
        stats = A.link_load_stats(loads, g.num_edges)
        for k, w in want["models"][key]["stats"].items():
            if isinstance(w, float):
                assert stats[k] == pytest.approx(w, rel=1e-5), (key, k)
            else:
                assert stats[k] == w, (key, k)
        np.testing.assert_allclose(loads[ids], want["models"][key]["loads"],
                                   rtol=1e-5, err_msg=key)


def test_reference_slimfly_row_reproduces():
    _reproduce_row("slimfly")


@pytest.mark.slow
@pytest.mark.parametrize("family", ["jellyfish", "xpander", "hyperx",
                                    "dragonfly", "fattree"])
def test_reference_rows_reproduce(family):
    _reproduce_row(family)


def test_reference_throughput_reproduces():
    ref = _reference()
    st, want = ref["throughput_settings"], ref["throughput"]
    g = T.by_servers(st["family"], st["servers"])
    got = R.max_concurrent_flow(g, st["demand"], eps=st["eps"],
                                max_rounds=st["max_rounds"], seed=st["seed"],
                                device="cpu")
    for key in ("rounds", "converged", "commodities", "dropped_unreachable"):
        assert got[key] == want[key], key
    for key in ("throughput", "upper_bound", "gap", "aggregate_throughput"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   err_msg=key)
    np.testing.assert_allclose(got["link_loads"].sum(),
                               want["link_loads_sum"], rtol=1e-9)

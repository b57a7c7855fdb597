"""repro_torch.core.routing.throughput vs the JAX package's, on the CPU.

Both packages get the same graph and demand matrix and the same seed. The
MWU loop's only floating-point oracle is the min-plus squaring, which is
exact in any evaluation order, so the port's plain fp32 product and the
JAX package's give bit-equal distances; the greedy chase and the bounds
are the same host numpy on the same numpy rng. Hence the tolerances:
``rounds``, ``converged`` and the commodity counts equal; the bounds and
the link loads within rtol 1e-9 (held as tight as the closed-form tests of
the JAX package hold its bounds).
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import routing as RR
from repro.core import topology as RT
from repro.core.analysis import apsp_dense as r_apsp_dense
from repro.core.graph import Graph as RGraph
from repro_torch import obs
from repro_torch.core import topology as T
from repro_torch.core.analysis import AnalysisEngine, apsp_from_lengths
from repro_torch.core.graph import Graph
from repro_torch.core.routing import (concurrent_flow_demand,
                                      max_concurrent_flow,
                                      route_greedy_shortest)
from repro_torch.core.routing import throughput as TP
from repro_torch.kernels import semiring as S

EPS = 0.05
REFERENCE = (pathlib.Path(__file__).resolve().parents[1] / "experiments"
             / "analysis" / "reference.json")


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)], n, f"C{n}"


def _complete(n):
    return ([(i, j) for i in range(n) for j in range(i + 1, n)], n, f"K{n}")


def _star(leaves):
    return [(0, i + 1) for i in range(leaves)], leaves + 1, f"star{leaves}"


def _hypercube(dim):
    g = RT.make("hypercube", dim=dim)
    return [tuple(e) for e in np.asarray(g.edges)], g.n, g.name


#: (edges, n, name) and the closed-form optimum under all-pairs demand
_CLOSED_FORM = {"ring": (_ring(8), 1 / 8), "K5": (_complete(5), 1.0),
                "hypercube": (_hypercube(3), 1 / 4),
                "star": (_star(4), 1 / 4)}


def _pair(edges, n, name):
    e = np.array(edges, np.int64).reshape(-1, 2)
    return RGraph(n=n, edges=e, name=name), Graph(n=n, edges=e, name=name)


def _demand(r):
    return RR.concurrent_flow_demand(r, np.asarray(
        r_apsp_dense(r, use_kernel=False)), "all-pairs")


@pytest.fixture(autouse=True)
def _no_launches():
    S.reset_launches()
    yield
    # everything here runs on CPU tensors: no kernel may launch
    assert not any(S.launches.values()), S.launches


def _assert_same_result(got, want):
    for key in ("rounds", "converged", "commodities", "dropped_unreachable"):
        assert got[key] == want[key], (key, got[key], want[key])
    for key in ("throughput", "upper_bound", "gap", "aggregate_throughput",
                "disconnected_fraction"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   err_msg=key)
    np.testing.assert_allclose(got["link_loads"], want["link_loads"],
                               rtol=1e-9, atol=0)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("case", list(_CLOSED_FORM))
def test_max_concurrent_flow_matches_jax(case, use_kernel):
    (edges, n, name), opt = _CLOSED_FORM[case]
    r, g = _pair(edges, n, name)
    demand = _demand(r)
    want = RR.max_concurrent_flow(r, demand, eps=EPS, max_rounds=400,
                                  use_kernel=False, seed=3)
    got = max_concurrent_flow(g, demand, eps=EPS, max_rounds=400,
                              use_kernel=use_kernel, seed=3, device="cpu")
    _assert_same_result(got, want)
    # and the certified bounds bracket the closed-form optimum
    assert got["converged"] and got["gap"] <= 1 + EPS + 1e-9
    assert got["throughput"] <= opt * (1 + 1e-9) <= got["upper_bound"] * (
        1 + 2e-9)


def test_matches_jax_kernel_path():
    """The JAX package's device oracle (Pallas interpret mode) against the
    port's device solver on its plain product: the same MWU run."""
    r, g = _pair(*_ring(6))
    demand = _demand(r)
    want = RR.max_concurrent_flow(r, demand, eps=0.2, max_rounds=50,
                                  use_kernel=True, seed=7)
    got = max_concurrent_flow(g, demand, eps=0.2, max_rounds=50, seed=7,
                              device="cpu")
    _assert_same_result(got, want)


def test_unconverged_run_matches_jax():
    """A run that stops at ``max_rounds`` follows the same weight updates."""
    r, g = _pair(*_hypercube(4))
    demand = _demand(r)
    want = RR.max_concurrent_flow(r, demand, eps=0.01, max_rounds=6,
                                  use_kernel=False, seed=1)
    got = max_concurrent_flow(g, demand, eps=0.01, max_rounds=6, seed=1,
                              device="cpu")
    assert not got["converged"] and got["rounds"] == 6
    _assert_same_result(got, want)


def test_lower_bound_flow_is_feasible():
    g = T.make("torus", dims=(3, 3))
    dist = np.asarray(r_apsp_dense(RT.make("torus", dims=(3, 3)),
                                   use_kernel=False))
    res = max_concurrent_flow(g, concurrent_flow_demand(g, dist), eps=EPS,
                              max_rounds=400, device="cpu")
    # undirected loads sum both directions; per-direction capacity is 1.0
    assert res["link_loads"].max() <= 2.0 + 1e-9
    assert res["link_loads"].shape == (g.num_edges,)


def test_kernel_and_plain_settings_agree_exactly():
    _, g = _pair(*_ring(6))
    demand = concurrent_flow_demand(g, np.zeros((g.n, g.n)))
    a = max_concurrent_flow(g, demand, eps=EPS, use_kernel=False, seed=7,
                            device="cpu")
    b = max_concurrent_flow(g, demand, eps=EPS, use_kernel=True, seed=7,
                            device="cpu")
    _assert_same_result(b, a)


@pytest.mark.parametrize("pattern", ["all-pairs", "permutation"])
def test_concurrent_flow_demand_matches_jax(pattern):
    r = RGraph(n=6, edges=np.array([(0, 1), (1, 2), (3, 4), (4, 5)]),
               name="two-paths")
    g = Graph(n=6, edges=np.asarray(r.edges), name="two-paths")
    dist = np.asarray(r_apsp_dense(r, use_kernel=False))
    np.testing.assert_array_equal(
        concurrent_flow_demand(g, dist, pattern, seed=1),
        RR.concurrent_flow_demand(r, dist, pattern, seed=1))
    with pytest.raises(ValueError, match="unknown"):
        concurrent_flow_demand(g, dist, "tornado")


def test_permutation_demand_and_unreachable_drop():
    r = RGraph(n=6, edges=np.array([(0, 1), (1, 2), (3, 4), (4, 5)]),
               name="two-paths")
    g = Graph(n=6, edges=np.asarray(r.edges), name="two-paths")
    demand = np.zeros((6, 6))
    demand[0, 2] = demand[0, 3] = 1.0  # (0,3) is unreachable
    res = max_concurrent_flow(g, demand, eps=0.2, use_kernel=False,
                              device="cpu")
    assert res["dropped_unreachable"] == 1
    assert res["commodities"] == 1
    assert res["throughput"] == pytest.approx(1.0)  # lone path, unit caps
    _assert_same_result(res, RR.max_concurrent_flow(r, demand, eps=0.2,
                                                    use_kernel=False))


def test_all_unreachable_demand_gives_the_zero_result():
    r = RGraph(n=4, edges=np.array([(0, 1), (2, 3)]), name="two-links")
    g = Graph(n=4, edges=np.asarray(r.edges), name="two-links")
    demand = np.zeros((4, 4))
    demand[0, 2] = demand[1, 3] = 1.0
    res = max_concurrent_flow(g, demand, device="cpu")
    assert res["throughput"] == res["upper_bound"] == 0.0
    assert res["rounds"] == 0 and res["converged"]
    assert res["commodities"] == 0 and res["dropped_unreachable"] == 2
    assert res["disconnected_fraction"] == 1.0
    np.testing.assert_array_equal(res["link_loads"], np.zeros(2))
    want = RR.max_concurrent_flow(r, demand, use_kernel=False)
    assert {k: v for k, v in res.items() if k != "link_loads"} == {
        k: v for k, v in want.items() if k != "link_loads"}


def test_degenerate_demands_raise():
    _, g = _pair(*_ring(4))
    with pytest.raises(ValueError):
        max_concurrent_flow(g, np.zeros((4, 4)), device="cpu")
    with pytest.raises(ValueError):
        max_concurrent_flow(g, np.eye(4), device="cpu")
    with pytest.raises(ValueError):
        max_concurrent_flow(g, np.ones((3, 3)), device="cpu")
    with pytest.raises(ValueError, match="eps"):
        max_concurrent_flow(g, np.ones((4, 4)), eps=0.0, device="cpu")


def test_traffic_specs_are_not_ported_yet():
    """The name predates the traffic port: a ``TrafficSpec`` or a spec
    string is now accepted, as the JAX package accepts it, and gives the
    result of its sample-0 matrix bit for bit, equal to the JAX result."""
    from repro.core.traffic import TrafficSpec as RTrafficSpec
    from repro_torch.core.traffic import TrafficSpec

    r, g = _pair(*_ring(12))
    for spec in ("uniform", "tornado", TrafficSpec.parse("shift:shift=3")):
        got = max_concurrent_flow(g, spec, eps=0.3, max_rounds=20,
                                  device="cpu")
        again = max_concurrent_flow(g, TrafficSpec.parse(spec).matrix(g),
                                    eps=0.3, max_rounds=20, device="cpu")
        for key, v in got.items():
            np.testing.assert_array_equal(v, again[key], err_msg=key)
        want = RR.max_concurrent_flow(
            r, RTrafficSpec.parse(TrafficSpec.parse(spec).describe()),
            eps=0.3, max_rounds=20, use_kernel=False)
        _assert_same_result(got, want)


def test_greedy_router_matches_jax_and_conserves_hops():
    r = RT.make("torus", dims=(3, 3))
    g = T.make("torus", dims=(3, 3))
    dist = np.asarray(r_apsp_dense(r, use_kernel=False))
    lm = g.distance_seed()
    pairs = np.array([(s, t) for s in range(g.n) for t in range(g.n)
                      if s != t])
    amounts = np.ones(len(pairs))
    loads = route_greedy_shortest(g, lm, dist, pairs, amounts,
                                  np.random.default_rng(0))
    np.testing.assert_array_equal(loads, RR.route_greedy_shortest(
        r, lm, dist, pairs, amounts, np.random.default_rng(0)))
    # unit lengths: every commodity walks exactly dist hops
    assert loads.sum() == pytest.approx(dist[pairs[:, 0], pairs[:, 1]].sum())


def test_device_solver_uploads_only_the_lengths():
    """Each round uploads the (2E,) f32 lengths and nothing else, and the
    solver's distances are the weighted APSP of those lengths."""
    g = T.make("slimfly", q=5)
    solve = TP._device_apsp_solver(g, max_squarings=6,
                                   device=torch.device("cpu"))
    rng = np.random.default_rng(0)
    obs.enable()
    try:
        obs.reset()
        before = obs.counter("h2d_bytes.mwu_lengths").value
        for _ in range(2):
            lengths = rng.uniform(0.5, 2.0, 2 * g.num_edges)
            with obs.span("round") as sp:
                dist = solve(lengths)
            assert sp.args["squarings"] >= 1
            np.testing.assert_array_equal(
                dist, apsp_from_lengths(TP._length_matrix(g, lengths),
                                        device="cpu").numpy())
        uploaded = obs.counter("h2d_bytes.mwu_lengths").value - before
    finally:
        obs.disable()
    assert uploaded == 2 * (2 * g.num_edges) * 4


def test_engine_throughput_stage_report():
    g = T.make("slimfly", q=5)
    eng = AnalysisEngine(g, use_kernel=False, throughput_eps=0.25,
                         device="cpu")
    rep = eng.report(stages=("throughput",))
    for key in ("saturation_throughput", "throughput_upper_bound",
                "throughput_gap", "aggregate_throughput",
                "throughput_rounds", "throughput_converged",
                "throughput_demand"):
        assert key in rep, key
    assert rep["throughput_demand"] == "all-pairs"
    assert 0 < rep["saturation_throughput"] <= rep["throughput_upper_bound"]
    assert eng.throughput() is eng.throughput()  # cached on the engine
    assert "saturation_throughput" not in eng.report()


def test_engine_throughput_raises_in_sampled_mode():
    g = T.make("slimfly", q=5)
    eng = AnalysisEngine(g, dense_limit=10, device="cpu")
    with pytest.raises(ValueError, match="dense APSP"):
        eng.report(stages=("throughput",))


# -- the committed full-width reference ----------------------------------------

@pytest.mark.parametrize("family", ["slimfly", "fattree"])
def test_reference_throughput_rows_reproduce(family):
    ref = json.loads(REFERENCE.read_text())
    want = ref["throughput"][family]
    g = T.by_servers(family, ref["servers"]["throughput"])
    assert (g.n, g.name) == (want["routers"], want["name"])
    got = AnalysisEngine(g, device="cpu",
                         **ref["throughput_settings"]).throughput()
    for key in ("rounds", "converged", "commodities", "dropped_unreachable",
                "demand_pattern"):
        assert got[key] == want[key], key
    for key in ("throughput", "upper_bound", "gap", "aggregate_throughput"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   err_msg=key)
    np.testing.assert_allclose(got["link_loads"].sum(),
                               want["link_loads_sum"], rtol=1e-9)
    np.testing.assert_allclose(got["link_loads"].max(),
                               want["link_loads_max"], rtol=1e-9)

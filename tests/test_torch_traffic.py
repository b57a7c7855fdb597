"""repro_torch.core.traffic vs the JAX package's, on the CPU.

The port's `traffic.spec` and `traffic.patterns` are host numpy copies of
the JAX package's, seeded the same way, so every batch, matrix and pair
array is held **bit-equal** (``assert_array_equal``). Both packages get the
same graph: the JAX package builds it, the port rebuilds it from plain
arrays (``graph_from_arrays``). The demand helpers that moved to torch
(`routing.assign.mask_unreachable_demand`) run on CPU tensors and are
held to the JAX package's numpy at rtol 1e-12.

The scenario engines and the grid (`traffic.scenarios`, `traffic.grid`)
run on CPU tensors: counts and the host-summed demand volumes
(``demand_total``, ``dropped_demand_frac``) equal, float64 metrics of the
oracle paths within rtol 1e-12, the f32 kernel paths against the JAX
package in interpret mode within rtol 1e-5.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core import topology as RT
from repro.core import traffic as RTR
from repro.core import workload as RW
from repro.core.graph import Graph as RGraph
from repro.core.routing import assign as RA
from repro_torch.core import traffic as TR
from repro_torch.core import workload as W
from repro_torch.core.graph import graph_from_arrays
from repro_torch.core.routing import assign as A

ALL_PATTERNS = ("uniform", "permutation", "tornado", "shift", "bitcomp",
                "hotspot", "bursty")


def _pair(r):
    return r, graph_from_arrays(r.n, np.asarray(r.edges), r.concentration,
                                r.name)


def _slimfly():
    return _pair(RT.make("slimfly", q=5))


def test_exports_and_registry():
    assert set(TR.__all__) == set(RTR.__all__)
    assert TR.TRAFFIC_METRICS == RTR.TRAFFIC_METRICS
    assert TR.pattern_names() == RTR.pattern_names()
    assert set(ALL_PATTERNS) <= set(TR.pattern_names())


def _spec_text(name, seed, samples, flows):
    items = [f"seed={seed}", f"samples={samples}"]
    if flows is not None:
        items.append(f"flows={flows}")
    return f"{name}:" + ",".join(items)


@pytest.mark.parametrize("flows", [None, 96], ids=["closed", "flows"])
@pytest.mark.parametrize("samples", [1, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ALL_PATTERNS)
def test_spec_bit_equal(name, seed, samples, flows):
    r, g = _slimfly()
    text = _spec_text(name, seed, samples, flows)
    want, got = RTR.TrafficSpec.parse(text), TR.TrafficSpec.parse(text)
    assert got.describe() == want.describe()
    try:
        want_batch = want.batch(r)
    except ValueError as exc:  # a bursty off-phase has no flows to sample
        with pytest.raises(ValueError, match=str(exc)[:20]):
            got.batch(g)
        return
    batch = got.batch(g)
    assert batch.dtype == np.float64 and batch.shape == (samples, g.n, g.n)
    np.testing.assert_array_equal(batch, want_batch)
    np.testing.assert_array_equal(got.matrix(g), want.matrix(r))
    if flows is None:
        with pytest.raises(ValueError, match="needs flows"):
            got.pairs(g)
    else:
        np.testing.assert_array_equal(got.pairs(g), want.pairs(r))


@pytest.mark.parametrize("name", ALL_PATTERNS)
def test_generate_bit_equal_with_params(name):
    params = {"hotspot": {"zipf_a": 1.7}, "shift": {"shift": 5.0},
              "bursty": {"duty": 0.5, "sync": 0.0}}.get(name, {})
    np.testing.assert_array_equal(
        TR.generate(name, 23, rate=2.5, seed=9, samples=3, **params),
        RTR.generate(name, 23, rate=2.5, seed=9, samples=3, **params))


@pytest.mark.parametrize("text", [
    "uniform", "hotspot:zipf_a=1.4", "permutation:flows=4096,seed=2",
    "bursty:duty=0.25,rate=0.5,samples=16,sync=0", "shift:shift=3,volume=2"])
def test_parse_describe_round_trip(text):
    spec = TR.TrafficSpec.parse(text)
    assert TR.TrafficSpec.parse(spec.describe()) == spec
    assert TR.TrafficSpec.parse(spec) is spec
    assert TR.as_spec(text) == spec
    assert spec.describe() == RTR.TrafficSpec.parse(text).describe()


def test_spec_rejects_what_the_jax_package_rejects():
    with pytest.raises(KeyError):
        TR.TrafficSpec.parse("wormhole")
    with pytest.raises(ValueError):
        TR.TrafficSpec.parse("uniform:rate")
    with pytest.raises(ValueError):
        TR.TrafficSpec(pattern="uniform", params={"seed": 1})
    with pytest.raises(ValueError):
        TR.generate("shift", 8, shift=8)


def test_pairs_to_matrix_and_sampling_bit_equal():
    pairs = np.array([(0, 3), (3, 0), (0, 3), (5, 5), (2, 9)])
    np.testing.assert_array_equal(TR.pairs_to_matrix(10, pairs, 2.0),
                                  RTR.pairs_to_matrix(10, pairs, 2.0))
    m = RTR.generate("hotspot", 17, seed=4)[0]
    np.testing.assert_array_equal(
        TR.sample_pairs_from_matrix(m, 300, np.random.default_rng(5)),
        RTR.sample_pairs_from_matrix(m, 300, np.random.default_rng(5)))


def test_demand_matrix_shim_warns_and_matches():
    r, g = _pair(RT.make("torus", dims=(10,)))
    pairs = np.array([(0, 3), (3, 0), (0, 3), (5, 5), (2, 9)])
    with pytest.deprecated_call():
        got = A.demand_matrix(g, pairs, volume=2.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = RA.demand_matrix(r, pairs, volume=2.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(W.Workload(pairs=pairs, volume=2.0)
                                  .demand_matrix(g), want)


def test_make_traffic_shim_bit_equal():
    r, g = _pair(RT.make("jellyfish", n=30, r=6, seed=0))
    for pattern in ("permutation", "uniform", "skewed"):
        with pytest.deprecated_call():
            got = W.make_traffic(g, pattern, flows=777, seed=1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = RW.make_traffic(r, pattern, flows=777, seed=1)
        np.testing.assert_array_equal(got.pairs, want.pairs)
        assert got.name == want.name
    with pytest.raises(ValueError):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            W.make_traffic(g, "nope")


def _two_parts():
    return _pair(RGraph(n=7, edges=np.array(
        [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 6)]), name="two-parts"))


@pytest.mark.parametrize("renormalize", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_mask_unreachable_demand(renormalize, batched):
    from repro.core.analysis import apsp_dense

    r, g = _two_parts()
    dist = np.asarray(apsp_dense(r, use_kernel=False))
    spec = "hotspot:samples=3,seed=2" if batched else "uniform"
    demand = RTR.TrafficSpec.parse(spec).batch(r)
    demand = demand if batched else demand[0]
    want, want_frac = RA.mask_unreachable_demand(demand, dist, renormalize)
    got, frac = A.mask_unreachable_demand(demand, dist, renormalize,
                                          device="cpu")
    assert torch.is_tensor(got) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    assert frac == pytest.approx(want_frac, rel=1e-12)
    assert 0 < frac < 1
    if renormalize:
        assert float(got.sum()) == pytest.approx(
            float(np.where(~np.eye(g.n, dtype=bool), demand, 0).sum()),
            rel=1e-12)
    # a tensor operand keeps its device; numpy alone needs a device
    again, _ = A.mask_unreachable_demand(torch.tensor(demand), dist,
                                         renormalize)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            A.mask_unreachable_demand(demand, dist)


# -- the batched scenario engines and the grid ---------------------------------

#: per-matrix metrics that are volumes summed on the host, or counts
_TRAFFIC_EXACT = ("demand_total", "dropped_demand_frac", "links_used_frac",
                  "reachable_frac")


def _assert_traffic(got, want, rtol):
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == np.float64 and got[key].shape == w.shape
        if key in _TRAFFIC_EXACT:
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, rtol=rtol, err_msg=key)


def _ring(n=16):
    return _pair(RT.make("torus", dims=(n,)))


@pytest.mark.parametrize("demand", ["uniform:samples=2",
                                    "permutation:samples=3,seed=1",
                                    "matrix", "stack"])
def test_demand_batch_bit_equal(demand):
    from repro.core.traffic.scenarios import demand_batch as want_batch

    r, g = _slimfly()
    if demand == "matrix":
        demand = RTR.TrafficSpec.parse("hotspot:seed=3").matrix(r)
    elif demand == "stack":
        demand = RTR.TrafficSpec.parse("hotspot:samples=4").batch(r)
    got, label = TR.demand_batch(g, demand)
    want, want_label = want_batch(r, demand)
    assert label == want_label and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="does not match"):
        TR.demand_batch(g, np.zeros((3, 4)))
    with pytest.raises(ValueError, match="wanted"):
        TR.demand_batch(g, np.zeros((3, g.n, g.n)), samples=2)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("spec", ["tornado:samples=3", "hotspot:samples=5",
                                  "permutation:samples=4,seed=2"])
def test_evaluate_traffic_batch_matches_jax(spec, use_kernel):
    r, g = _pair(RT.make("jellyfish", n=30, r=6, seed=1))
    want = RTR.evaluate_traffic_batch(r, spec, use_kernel=use_kernel)
    got = TR.evaluate_traffic_batch(g, spec, use_kernel=use_kernel,
                                    device="cpu", mask_chunk=2)
    _assert_traffic(got, want, 1e-5 if use_kernel else 1e-12)


def test_evaluate_traffic_batch_ring_tornado_and_given_state():
    from repro.core.analysis.wavefront import wavefront_dist_mult

    r, g = _ring(16)
    out = TR.evaluate_traffic_batch(g, "tornado:samples=3", use_kernel=False,
                                    device="cpu")
    assert out["max_link_load"][0] == pytest.approx(4.0)
    assert out["tput_lb"][0] == pytest.approx(0.25)
    assert out["avg_hops"][0] == pytest.approx(8.0)
    assert out["dropped_demand_frac"][0] == 0.0
    assert out["demand_total"][0] == 16.0
    # precomputed (dist, mult): numpy goes to ``device``, tensors keep
    # theirs; both give the same metrics
    dist, mult = (np.array(x) for x in
                  wavefront_dist_mult(r.adjacency_dense()))
    for d, m, dev in ((dist, mult, "cpu"), (torch.from_numpy(dist),
                                            torch.from_numpy(mult), "cuda")):
        again = TR.evaluate_traffic_batch(g, "tornado:samples=3", dist=d,
                                          mult=m, use_kernel=False,
                                          device=dev)
        for key in out:
            np.testing.assert_array_equal(again[key], out[key], err_msg=key)


def _two_rings():
    a = RT.make("torus", dims=(8,))
    return _pair(RGraph(n=16, edges=np.concatenate([a.edges, a.edges + 8]),
                        name="two-rings"))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_dropped_demand_on_a_partitioned_graph(use_kernel):
    r, g = _two_rings()
    demand = np.zeros((16, 16))
    demand[0, 12] = 1.0   # unreachable
    demand[0, 2] = 1.0    # reachable
    demand[5, 5] = 3.0    # self-demand never routes
    got = TR.evaluate_traffic_batch(g, demand, use_kernel=use_kernel,
                                    device="cpu")
    want = RTR.evaluate_traffic_batch(r, demand, use_kernel=use_kernel)
    _assert_traffic(got, want, 1e-5 if use_kernel else 1e-12)
    assert got["dropped_demand_frac"][0] == 0.5
    assert got["max_link_load"][0] > 0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_evaluate_traffic_failure_batch_matches_jax(use_kernel):
    from repro.core import resilience as RR
    from repro_torch.core import resilience as TRR

    r, g = _pair(RT.make("jellyfish", n=30, r=6, seed=1))
    wb = RR.failure_batch(RR.failure_plan(r, samples=5, seed=2), 20)
    gb = TRR.failure_batch(TRR.failure_plan(g, samples=5, seed=2), 20)
    spec = "hotspot:samples=5,seed=2"
    want = RTR.evaluate_traffic_failure_batch(r, spec, wb.adjacency,
                                              use_kernel=use_kernel)
    got = TR.evaluate_traffic_failure_batch(g, spec, gb.adjacency,
                                            use_kernel=use_kernel,
                                            mask_chunk=2, device="cpu")
    _assert_traffic(got, want, 1e-5 if use_kernel else 1e-12)
    # a tensor stack already on its device gives the same cells
    again = TR.evaluate_traffic_failure_batch(
        g, spec, torch.from_numpy(gb.adjacency), use_kernel=use_kernel)
    for key in got:
        np.testing.assert_array_equal(again[key], got[key], err_msg=key)
    with pytest.raises(ValueError, match="cannot pair"):
        TR.evaluate_traffic_failure_batch(g, "uniform:samples=3",
                                          gb.adjacency, device="cpu")


def test_traffic_failure_batch_unfailed_matches_unfailed_engine():
    _, g = _pair(RT.make("jellyfish", n=30, r=6, seed=1))
    dem = TR.TrafficSpec.parse("hotspot:samples=4,seed=2").batch(g)
    stack = np.broadcast_to(g.adjacency_dense(np.float32),
                            (4, g.n, g.n)).copy()
    failed = TR.evaluate_traffic_failure_batch(g, dem, stack,
                                               use_kernel=False, device="cpu")
    clean = TR.evaluate_traffic_batch(g, dem, use_kernel=False, device="cpu")
    for key in TR.TRAFFIC_METRICS:
        np.testing.assert_allclose(failed[key], clean[key], rtol=1e-12,
                                   err_msg=key)
    assert np.all(failed["reachable_frac"] == 1.0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_saturation_search_ring_tornado_closed_form(use_kernel):
    r, g = _ring(16)
    sat = TR.saturation_search(g, "tornado", use_kernel=use_kernel,
                               device="cpu")
    want = RTR.saturation_search(r, "tornado", use_kernel=use_kernel)
    # ring tornado saturates at rate = 4 / n = 0.25
    assert sat["per_sample_mean"] == pytest.approx(4 / 16)
    assert sat["sat_rate"] == pytest.approx(0.25, rel=0.02)
    assert sat["rounds"] == want["rounds"]
    for key in ("sat_rate", "per_sample_mean", "ci95", "per_sample",
                "peak_at_probe"):
        np.testing.assert_allclose(sat[key], want[key], rtol=1e-12,
                                   err_msg=key)
    assert sat["demand"] == want["demand"] and sat["capacity"] == 1.0


def test_saturation_search_matches_jax_on_hotspot():
    r, g = _pair(RT.make("jellyfish", n=30, r=6, seed=1))
    spec = "hotspot:zipf_a=1.4,samples=4,rate=0.5"
    sat = TR.saturation_search(g, spec, use_kernel=False, capacity=2.0,
                               device="cpu")
    want = RTR.saturation_search(r, spec, use_kernel=False, capacity=2.0)
    assert sat["rounds"] == want["rounds"]
    for key in ("sat_rate", "per_sample_mean", "ci95", "per_sample",
                "peak_at_probe", "probe_rate"):
        np.testing.assert_allclose(sat[key], want[key], rtol=1e-12,
                                   err_msg=key)
    tiny = graph_from_arrays(4, np.array([(0, 1)]), 1, "tiny")
    with pytest.raises(ValueError, match="no demand routes"):
        TR.saturation_search(tiny, "tornado", use_kernel=False, device="cpu")


_GRID_KW = dict(families=["jellyfish", "hypercube"], max_routers=40,
                scenarios=("uniform", "tornado", "hotspot:zipf_a=1.4"),
                rates=(0.0, 0.05, 0.1), samples=8, seed=0, bootstrap=100)


@pytest.fixture(scope="module")
def small_grid():
    got = TR.traffic_failure_grid(use_kernel=False, device="cpu", **_GRID_KW)
    want = RTR.traffic_failure_grid(use_kernel=False, **_GRID_KW)
    return got, want


def _walk_same(a, b, path=""):
    """Two result dicts equal: the host-summed volumes, counts and every
    non-float equal, float64 metrics within rtol 1e-12."""
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            if path or k != "elapsed_s":
                _walk_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _walk_same(x, y, f"{path}[{i}]")
    elif isinstance(b, float):
        assert isinstance(a, float), path
        if any(k in path for k in _TRAFFIC_EXACT):
            assert a == b, (path, a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=path)
    else:
        assert a == b, (path, a, b)


def test_grid_equal_to_jax(small_grid):
    import json

    got, want = small_grid
    assert len(got["families"]) == 2
    _walk_same(json.loads(json.dumps(got)), json.loads(json.dumps(want)))
    assert TR.check_grid(got) == []
    table = TR.format_grid_table(got)
    assert "tornado" in table and "jellyfish" in table


def test_grid_rate0_bit_equal_to_unfailed_baseline(small_grid):
    from repro_torch.core.sweep import equal_cost_graphs

    got, _ = small_grid
    graphs, _ = equal_cost_graphs(["jellyfish", "hypercube"], None,
                                  ("slimfly", 2000), 40)
    by_name = {g.meta["spec"].family: g for g in graphs}
    for fam in got["families"]:
        g = by_name[fam["family"]]
        for row in fam["scenarios"]:
            spec = TR.TrafficSpec.parse(row["scenario"])
            base = TR.evaluate_traffic_batch(
                g, spec.batch(g, samples=8)[:1], use_kernel=False,
                device="cpu")
            cell = row["cells"][0]
            assert cell["rate"] == 0.0 and cell["samples"] == 1
            for key in TR.TRAFFIC_METRICS:
                assert cell["metrics"][key]["value"] == float(base[key][0])
                assert fam["baseline"][row["scenario"]][key] == \
                    float(base[key][0])


def test_grid_kernel_path_matches_jax_interpret():
    kw = dict(families=["hypercube"], max_routers=32,
              scenarios=("uniform", "tornado"), rates=(0.0, 0.1),
              samples=4, seed=1, bootstrap=50)
    got = TR.traffic_failure_grid(use_kernel=True, device="cpu", **kw)
    want = RTR.traffic_failure_grid(use_kernel=True, **kw)
    assert TR.check_grid(got) == []
    for fg, fw in zip(got["families"], want["families"]):
        for rg, rw in zip(fg["scenarios"], fw["scenarios"]):
            for cg, cw in zip(rg["cells"], rw["cells"]):
                assert (cg["rate"], cg["k"]) == (cw["rate"], cw["k"])
                for key, m in cw["metrics"].items():
                    np.testing.assert_allclose(
                        cg["metrics"][key]["value"], m["value"], rtol=1e-5,
                        err_msg=key)


def test_check_grid_catches_corruption(small_grid):
    import copy

    got, _ = small_grid
    bad = copy.deepcopy(got)
    bad["families"][0]["scenarios"][0]["cells"][0]["metrics"][
        "max_link_load"]["value"] = float("nan")
    assert any("not finite" in m for m in TR.check_grid(bad))
    bad = copy.deepcopy(got)
    bad["families"][0]["baseline"][
        bad["families"][0]["scenarios"][0]["scenario"]]["tput_lb"] = 99.0
    assert any("baseline" in m for m in TR.check_grid(bad))
    bad = copy.deepcopy(got)
    bad["families"][1]["scenarios"][1]["cells"][-1]["metrics"][
        "dropped_demand_frac"]["value"] = -1.0
    assert TR.check_grid(bad)


def test_grid_cli_smoke(tmp_path, capsys):
    import json

    rc = TR.main(["--families", "hypercube", "--max-routers", "32",
                  "--traffic", "uniform;tornado", "--rates", "0,0.1",
                  "--samples", "4", "--bootstrap", "20", "--device", "cpu",
                  "--out", str(tmp_path), "--check"])
    assert rc == 0
    assert "scenarios OK" in capsys.readouterr().out
    art = json.loads((tmp_path / "grid.json").read_text())
    assert TR.check_grid(art) == []
    assert (tmp_path / "grid.txt").read_text().startswith(
        "traffic x failure grid:")


def test_engines_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, g = _ring(8)
    for call in (lambda: TR.evaluate_traffic_batch(g, "tornado"),
                 lambda: TR.saturation_search(g, "tornado"),
                 lambda: TR.traffic_failure_grid(graphs=[g], samples=2,
                                                 rates=(0.0,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

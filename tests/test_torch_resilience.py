"""repro_torch.core.resilience vs the JAX package's, on the CPU.

Failure plans and mask batches are host numpy copies seeded the same way,
so they are held **bit-equal**. The engines run on CPU tensors (the
kernels' plain versions, or the float64 oracle) and are held to the JAX
package on the same graphs: the JAX package builds each graph and the port
rebuilds it from plain arrays (``graph_from_arrays``). Tolerances, by the
metric's arithmetic:

* integer-valued metrics (counts, distances, nearest-rank picks) are
  equal (``assert_array_equal``) on both paths;
* float64 metrics of the oracle paths within rtol 1e-12 (the same
  recurrences, other summation orders);
* the f32 kernel paths (JAX in interpret mode, at <= 64 routers) within
  rtol 1e-5.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import resilience as RR
from repro.core import topology as RT
from repro.core.graph import Graph as RGraph
from repro_torch.core import resilience as TR
from repro_torch.core.graph import graph_from_arrays
from repro_torch.core.resilience import degradation as D

#: metrics whose per-sample values are integers or ratios of counts
_EXACT = ("reachable_frac", "diameter", "mult_p10", "mult_p50", "mult_p90",
          "frac_multipath", "plus1_p50", "dropped_demand_frac")


def _carry(r):
    """A JAX-package graph rebuilt in the port from plain arrays, spec and
    all (the cable kind reads its link inventory)."""
    s = r.spec
    fields = None
    if s is not None:
        fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
        fields["link_classes"] = [dataclasses.asdict(lc)
                                  for lc in s.link_classes]
    return graph_from_arrays(r.n, np.asarray(r.edges), r.concentration,
                             r.name, fields)


def _pair(r):
    return r, _carry(r)


_FAMILIES = {
    "slimfly": lambda: RT.make("slimfly", q=5),
    "torus": lambda: RT.make("torus", dims=(4, 4)),
    "dragonfly": lambda: RT.by_servers("dragonfly", 200),
    "jellyfish": lambda: RT.make("jellyfish", n=30, r=6, seed=1),
}


def _assert_metrics(got, want, rtol):
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == np.float64 and got[key].shape == w.shape
        if key in _EXACT:
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, rtol=rtol, err_msg=key)


# -- failure plans / masks ----------------------------------------------------

@pytest.mark.parametrize("kind", ["link", "router", "cable"])
@pytest.mark.parametrize("family", ["slimfly", "torus", "dragonfly"])
def test_plans_and_batches_bit_equal(family, kind):
    r, g = _pair(_FAMILIES[family]())
    want = RR.failure_plan(r, kind=kind, samples=5, seed=3, bundle_size=4)
    got = TR.failure_plan(g, kind=kind, samples=5, seed=3, bundle_size=4)
    assert got.n_units == want.n_units and got.samples == 5
    for field in ("order", "unit_indptr", "unit_edge_ids"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    for k in (0, 1, min(7, want.n_units), want.n_units):
        wb, gb = RR.failure_batch(want, k), TR.failure_batch(got, k)
        assert gb.adjacency.dtype == np.float32 and gb.k == k
        for field in ("adjacency", "alive", "edge_failed"):
            np.testing.assert_array_equal(getattr(gb, field),
                                          getattr(wb, field))
    if kind == "cable":
        labels, names = TR.edge_class_labels(g)
        want_labels, want_names = RR.edge_class_labels(r)
        np.testing.assert_array_equal(labels, want_labels)
        assert names == want_names


def test_rate_to_k_bounds_and_bad_inputs():
    r, g = _pair(RT.make("torus", dims=(3, 3)))
    plan = TR.failure_plan(g, samples=2)
    want = RR.failure_plan(r, samples=2)
    for rate in (0.0, 0.05, 0.5, 1.0):
        assert TR.rate_to_k(plan, rate) == RR.rate_to_k(want, rate)
    assert TR.rate_to_k(plan, 0.0) == 0
    assert TR.rate_to_k(plan, 1.0) == plan.n_units
    with pytest.raises(ValueError):
        TR.rate_to_k(plan, 1.5)
    with pytest.raises(ValueError):
        TR.failure_batch(plan, plan.n_units + 1)
    with pytest.raises(ValueError):
        TR.failure_plan(g, samples=0)
    bare = graph_from_arrays(4, np.array([(0, 1), (1, 2)]), 1, "bare")
    with pytest.raises(KeyError):
        TR.failure_plan(bare, kind="cable")


# -- the batched engine -------------------------------------------------------

def _batches(family, kind="link", samples=6, k=4, seed=1):
    r, g = _pair(_FAMILIES[family]())
    want = RR.failure_batch(RR.failure_plan(r, kind=kind, samples=samples,
                                            seed=seed), k)
    got = TR.failure_batch(TR.failure_plan(g, kind=kind, samples=samples,
                                           seed=seed), k)
    return r, g, want, got


@pytest.mark.parametrize("kind", ["link", "router"])
@pytest.mark.parametrize("family", ["slimfly", "torus", "jellyfish"])
def test_evaluate_failure_batch_matches_jax_oracle(family, kind):
    r, g, wb, gb = _batches(family, kind, k=5)
    want = RR.evaluate_failure_batch(r, wb, use_kernel=False, slack=True)
    got = TR.evaluate_failure_batch(g, gb, use_kernel=False, slack=True,
                                    device="cpu")
    _assert_metrics(got, want, rtol=1e-12)


@pytest.mark.parametrize("family", ["torus", "jellyfish"])
def test_evaluate_failure_batch_kernel_path_matches_jax_interpret(family):
    r, g, wb, gb = _batches(family, k=4)
    want = RR.evaluate_failure_batch(r, wb, use_kernel=True, slack=True)
    got = TR.evaluate_failure_batch(g, gb, use_kernel=True, slack=True,
                                    device="cpu")
    _assert_metrics(got, want, rtol=1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_chunking_changes_no_per_sample_value(use_kernel):
    _, g, _, gb = _batches("jellyfish", samples=7, k=6)
    auto = TR.evaluate_failure_batch(g, gb, use_kernel=use_kernel,
                                     slack=True, device="cpu")
    assert D._auto_chunk(g.n, 7) == 7
    for chunk in (1, 3):
        got = TR.evaluate_failure_batch(g, gb, use_kernel=use_kernel,
                                        slack=True, mask_chunk=chunk,
                                        device="cpu")
        for key in auto:
            np.testing.assert_array_equal(got[key], auto[key], err_msg=key)


def test_auto_chunk_budget():
    # 8 live (chunk, p, p) f32 buffers in 1 GiB: 512 masks at p = 256
    assert D._auto_chunk(256, 10_000) == 512
    assert D._auto_chunk(2025, 32) == 8
    assert D._auto_chunk(121, 100) == 100
    assert D._auto_chunk(50_000, 3) == 1


def test_slack_matches_jax_and_single_graph_engine():
    from repro.core.analysis.apsp import apsp_dense
    from repro.core.analysis.paths import path_counts_with_slack

    r, g = _pair(RT.make("torus", dims=(4, 4)))
    gb = TR.failure_batch(TR.failure_plan(g, samples=2, seed=0), 0)
    wb = RR.failure_batch(RR.failure_plan(r, samples=2, seed=0), 0)
    got = TR.evaluate_failure_batch(g, gb, use_kernel=False, slack=True,
                                    device="cpu")
    want = RR.evaluate_failure_batch(r, wb, use_kernel=False, slack=True)
    for key in D.SLACK_METRICS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    dist = apsp_dense(r, use_kernel=False)
    pc = path_counts_with_slack(r, dist, use_kernel=False)
    off = np.isfinite(dist) & (dist > 0)
    np.testing.assert_allclose(got["plus1_mean"][0], pc["plus1"][off].mean(),
                               rtol=1e-6)
    np.testing.assert_allclose(got["plus2_mean"][0], pc["plus2"][off].mean(),
                               rtol=1e-6)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_full_failure_gives_zero_metrics(use_kernel):
    g = _carry(RT.make("torus", dims=(3, 3)))
    plan = TR.failure_plan(g, kind="link", samples=3, seed=0)
    m = TR.evaluate_failure_batch(g, TR.failure_batch(plan, plan.n_units),
                                  use_kernel=use_kernel, slack=True,
                                  device="cpu")
    for key in ("reachable_frac", "tput_lb", "diameter", "avg_spl",
                "mult_mean", "mult_p50", "plus1_mean", "plus2_mean"):
        assert (m[key] == 0.0).all(), key


@pytest.mark.parametrize("demand", ["hotspot:zipf_a=1.4", "matrix", "stack"])
def test_demand_matches_jax(demand):
    from repro.core.traffic import TrafficSpec

    r, g, wb, gb = _batches("jellyfish", samples=6, k=12)
    if demand == "matrix":
        demand = TrafficSpec.parse("hotspot:seed=2").matrix(r)
    elif demand == "stack":
        demand = TrafficSpec.parse("permutation:samples=6,seed=4").batch(r)
    want = RR.evaluate_failure_batch(r, wb, use_kernel=False, demand=demand)
    got = TR.evaluate_failure_batch(g, gb, use_kernel=False, demand=demand,
                                    device="cpu")
    assert "dropped_demand_frac" in got
    _assert_metrics(got, want, rtol=1e-12)


def test_demand_samples_must_pair_with_masks():
    _, g, _, gb = _batches("jellyfish", samples=6, k=2)
    with pytest.raises(ValueError, match="cannot pair"):
        TR.evaluate_failure_batch(g, gb, demand="uniform:samples=4",
                                  device="cpu")


def test_masked_reductions_match_numpy():
    from repro.core.resilience import degradation as RD

    gen = np.random.default_rng(5)
    vals = gen.integers(0, 9, size=(6, 7, 7)).astype(np.float64) / 4
    off = gen.random((6, 7, 7)) < 0.4
    off[2] = False                         # an empty mask reduces to 0
    qs = (0.1, 0.25, 0.5, 0.9, 0.99)
    got = D._masked_percentiles(torch.from_numpy(vals),
                                torch.from_numpy(off), qs).numpy()
    np.testing.assert_array_equal(got, RD._masked_percentiles(vals, off, qs))
    np.testing.assert_array_equal(
        D._masked_mean(torch.from_numpy(vals), torch.from_numpy(off)).numpy(),
        RD._masked_mean(vals, off))


# -- curves, gate, CLI --------------------------------------------------------

def _assert_same_result(got, want, rtol=1e-12):
    """The whole result dict, except the wall time: floats within rtol,
    everything else equal."""
    def walk(a, b, path):
        if isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                if path == "" and k == "elapsed_s":
                    continue
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        elif isinstance(b, float):
            assert isinstance(a, float), path
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=path)
        else:
            assert a == b, (path, a, b)

    walk(json.loads(json.dumps(got)), json.loads(json.dumps(want)), "")


@pytest.fixture(scope="module")
def small_curves():
    kw = dict(families=["hypercube", "torus"], max_routers=32,
              rates=(0.0, 0.05, 0.15), samples=8, bootstrap=50,
              use_kernel=False)
    return (TR.degradation_curves(device="cpu", **kw),
            RR.degradation_curves(**kw))


def test_degradation_curves_equal_to_jax(small_curves):
    got, want = small_curves
    assert len(got["families"]) == 2
    _assert_same_result(got, want)
    assert TR.check_degradation(got) == []
    table = TR.format_degradation_table(got)
    assert table.splitlines()[1:] == \
        RR.format_degradation_table(want).splitlines()[1:]


def test_degradation_curves_with_traffic_equal_to_jax():
    kw = dict(families=["hypercube"], max_routers=32, rates=(0.0, 0.1),
              samples=6, bootstrap=40, use_kernel=False, slack=False,
              demand="tornado")
    got = TR.degradation_curves(device="cpu", **kw)
    assert got["traffic"] == "tornado"
    _assert_same_result(got, RR.degradation_curves(**kw))


def test_degradation_curves_cable_kind_skips_specless():
    g = _carry(RT.make("torus", dims=(3, 3)))
    bare = _carry(RGraph(n=4, edges=np.array([(0, 1), (1, 2), (2, 3),
                                               (3, 0)]), name="bare-ring"))
    result = TR.degradation_curves(graphs=[g, bare], kind="cable",
                                   rates=(0.0, 0.2), samples=4, bootstrap=20,
                                   use_kernel=False, slack=False,
                                   device="cpu")
    assert [f["family"] for f in result["families"]] == ["torus"]


def test_check_degradation_catches_corruption(small_curves):
    got, _ = small_curves
    bad = json.loads(json.dumps(got))
    bad["families"][0]["points"][-1]["metrics"]["reachable_frac"][
        "value"] = 2.0
    assert any("reachable_frac" in m for m in TR.check_degradation(bad))
    bad = json.loads(json.dumps(got))
    bad["families"][0]["baseline"]["tput_lb"] += 1e-9
    assert any("baseline" in m for m in TR.check_degradation(bad))
    bad = json.loads(json.dumps(got))
    bad["families"][1]["points"][-1]["metrics"]["tput_lb"]["value"] = 9.0
    assert any("tput_lb rises" in m for m in TR.check_degradation(bad))


def test_cli_smoke(tmp_path, capsys):
    rc = D.main(["--families", "hypercube", "--max-routers", "32",
                 "--rates", "0,0.1", "--samples", "6", "--bootstrap", "20",
                 "--no-slack", "--device", "cpu", "--out", str(tmp_path),
                 "--check"])
    assert rc == 0
    assert "families OK" in capsys.readouterr().out
    art = json.loads((tmp_path / "degradation.json").read_text())
    assert TR.check_degradation(art) == []
    assert (tmp_path / "degradation.txt").read_text().startswith(
        "degradation sweep:")


def test_exports_match_the_jax_package():
    assert set(TR.__all__) == set(RR.__all__)
    assert D.METRICS == RR.degradation.METRICS
    assert D.SLACK_METRICS == RR.degradation.SLACK_METRICS


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, g, _, gb = _batches("torus", samples=2, k=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.evaluate_failure_batch(g, gb)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.degradation_curves(graphs=[g], samples=2, rates=(0.0,))

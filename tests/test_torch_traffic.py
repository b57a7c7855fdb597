"""repro_torch.core.traffic vs the JAX package's, on the CPU.

The port's `traffic.spec` and `traffic.patterns` are host numpy copies of
the JAX package's, seeded the same way, so every batch, matrix and pair
array is held **bit-equal** (``assert_array_equal``). Both packages get the
same graph: the JAX package builds it, the port rebuilds it from plain
arrays (``graph_from_arrays``). The demand helpers that moved to torch
(`routing.assign.mask_unreachable_demand`) run on CPU tensors and are
held to the JAX package's numpy at rtol 1e-12.
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
    assert set(TR.__all__) == {"TrafficSpec", "as_spec", "register",
                               "generate", "pattern_names",
                               "pairs_to_matrix", "sample_pairs_from_matrix"}
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

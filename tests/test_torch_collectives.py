"""The port's `core.collectives` vs the JAX package's, on the CPU.

`cost_model` and the mapping search are copies (plain Python and numpy,
the TPU constants of `HardwareModel` kept): every number and every plan is
equal. `pod_traffic_report` runs the 16 x 16 pod torus through the port's
analysis engine and routing models on CPU tensors, alone and inside gloo
meshes of 2 and 4 ranks (`mesh_ranks.report_cases`; the engine picks the
mesh up through ``mesh="auto"``, on a torus of 256 routers two shards),
against the JAX package's report on its single device. Loads are held to
rtol 1e-5 (f32 kernels' plain versions against Pallas interpret mode);
counts and model names equal.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest

from repro.core import collectives as RC
from repro_torch.core import collectives as C
from repro_torch.core.analysis import distributed as D
from repro_torch.core.analysis import mesh_ranks as MR

RTOL = 1e-5
TIMEOUT = 240
SHARDS = (2, 4)
MODELS = ("uniform_shortest", "valiant", "slack")
_N = 256  # chips of the default 16 x 16 pod


def _demand(kind):
    if kind == "uniform":
        return np.ones((_N, _N)) - np.eye(_N)
    rng = np.random.default_rng(7)
    d = rng.random((_N, _N)) * (rng.random((_N, _N)) < 0.1)
    np.fill_diagonal(d, 0.0)
    return d


def _assert_report(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, str) or k in ("links_total", "links_used"):
            assert got[k] == w, k
        else:
            assert got[k] == pytest.approx(w, rel=RTOL, abs=RTOL), k


# -- the cost model and the mapping search: copies, equal ------------------------

def test_hardware_model_keeps_the_reference_constants():
    assert dataclasses.asdict(C.HardwareModel()) == \
        dataclasses.asdict(RC.HardwareModel())
    assert C.COLLECTIVE_KINDS == RC.COLLECTIVE_KINDS


@pytest.mark.parametrize("kind", RC.COLLECTIVE_KINDS)
@pytest.mark.parametrize("axis", ["ici_ring", "dcn"])
def test_collective_time_equal(kind, axis):
    for size, nbytes in itertools.product((1, 2, 16, 64), (0.0, 1e3, 1e8)):
        for hw in (None, {"ici_latency": 0.0}):
            got = C.collective_time(kind, nbytes, C.AxisLink("a", size, axis),
                                    None if hw is None else
                                    C.HardwareModel(**hw))
            want = RC.collective_time(kind, nbytes,
                                      RC.AxisLink("a", size, axis),
                                      None if hw is None else
                                      RC.HardwareModel(**hw))
            assert got == want


def test_collective_time_rejects_unknown_kinds():
    for mod in (C, RC):
        with pytest.raises(ValueError, match="unknown collective kind"):
            mod.collective_time("gather", 1e6, mod.AxisLink("a", 4))
        with pytest.raises(ValueError, match="unknown axis kind"):
            mod.collective_time("all-reduce", 1e6,
                                mod.AxisLink("a", 4, "nvlink"))


@pytest.mark.parametrize("axes", [
    {"pod": ("pod", 2, "dcn"), "data": ("data", 16, "ici_ring")},
    {"data": ("data", 16, "ici_ring"), "model": ("model", 16, "ici_ring")},
    {"pod": ("pod", 4, "dcn")}], ids=["pod-data", "data-model", "pod"])
def test_hierarchical_all_reduce_equal(axes):
    for nbytes in (1e6, 1e8):
        assert C.hierarchical_all_reduce_time(
            nbytes, {k: C.AxisLink(*v) for k, v in axes.items()}) == \
            RC.hierarchical_all_reduce_time(
                nbytes, {k: RC.AxisLink(*v) for k, v in axes.items()})


def _plan_fields(plan):
    return (plan.assignment, plan.score_seconds, plan.alternatives,
            {k: dataclasses.astuple(v) for k, v in plan.axis_links.items()})


@pytest.mark.parametrize("mesh,fabric,traffic", [
    ({"data": 16, "model": 16}, ((16, 16), 1), None),
    ({"pod": 2, "data": 16, "model": 16}, ((16, 16), 2), None),
    ({"data": 256}, ((16, 16), 1), None),
    ({"data": 8, "model": 8, "pipe": 4}, ((8, 8, 4), 1),
     {"data": {"all-reduce": 4e6}, "model": {"all-to-all": 1e6},
      "pipe": {"collective-permute": 2e5}}),
], ids=["dp-tp", "pods", "folded", "3d"])
def test_plan_mesh_mapping_equal(mesh, fabric, traffic):
    got = C.plan_mesh_mapping(mesh, C.PhysicalFabric(*fabric), traffic)
    want = RC.plan_mesh_mapping(mesh, RC.PhysicalFabric(*fabric), traffic)
    assert _plan_fields(got) == _plan_fields(want)
    assert got.link_for(next(iter(mesh))).kind == \
        want.link_for(next(iter(mesh))).kind


@pytest.mark.parametrize("mesh,fabric", [
    ({"data": 4, "model": 999}, ((16, 16), 1)),
    ({"pod": 3, "data": 16, "model": 16}, ((16, 16), 2)),
], ids=["no-fit", "pods-differ"])
def test_plan_mesh_mapping_raises_alike(mesh, fabric):
    with pytest.raises(ValueError) as got:
        C.plan_mesh_mapping(mesh, C.PhysicalFabric(*fabric))
    with pytest.raises(ValueError) as want:
        RC.plan_mesh_mapping(mesh, RC.PhysicalFabric(*fabric))
    assert str(got.value) == str(want.value)


def test_fabric_graph_is_the_reference_torus():
    for dims in ((16, 16), (4, 4, 4)):
        got, want = C.PhysicalFabric(dims).pod_graph(), \
            RC.PhysicalFabric(dims).pod_graph()
        assert got.n == want.n == C.PhysicalFabric(dims).chips_per_pod
        np.testing.assert_array_equal(got.edges, want.edges)


# -- the pod traffic report ------------------------------------------------------

_JAX_REPORTS = {}


def _jax_report(demand, model, use_kernel=True):
    key = (demand, model, use_kernel)
    if key not in _JAX_REPORTS:
        _JAX_REPORTS[key] = RC.pod_traffic_report(
            RC.PhysicalFabric(), _demand(demand), model=model,
            use_kernel=use_kernel)
    return _JAX_REPORTS[key]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("demand", ["uniform", "random"])
def test_pod_traffic_report_matches(demand, model):
    got = C.pod_traffic_report(C.PhysicalFabric(), _demand(demand),
                               model=model, device="cpu")
    _assert_report(got, _jax_report(demand, model))


def test_pod_traffic_report_float64_path_matches():
    got = C.pod_traffic_report(C.PhysicalFabric(), _demand("random"),
                               use_kernel=False, device="cpu")
    _assert_report(got, _jax_report("random", "uniform_shortest", False))


def test_pod_traffic_report_cuda_default_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.pod_traffic_report(C.PhysicalFabric(), _demand("uniform"))


@pytest.fixture(scope="module", params=SHARDS, ids=lambda p: f"P{p}")
def mesh_reports(request, tmp_path_factory):
    """(shards, the reports made on a mesh of that many gloo ranks)."""
    path = tmp_path_factory.mktemp(f"reports{request.param}") / "cases.npz"
    D.launch_mesh(MR.report_cases, request.param, str(path),
                  _demand("random"), MODELS, device="cpu", timeout_s=TIMEOUT)
    return request.param, dict(np.load(path))


@pytest.mark.parametrize("model", MODELS)
def test_pod_traffic_report_on_a_mesh_matches(mesh_reports, model):
    _, got = mesh_reports
    # the torus (256 routers) keeps whole row tiles on two shards, so a
    # group of 4 runs its engine on the first two ranks
    assert int(got["shards"]) == 2
    _assert_report(json.loads(str(got[f"report/{model}"])),
                   _jax_report("random", model))

"""``experiments/sharding/reference.json`` regenerates from
``experiments/sharding/make_reference.py`` (the JAX package on the CPU):
its header and its ``plans`` and ``costs`` parts bit for bit (they need no
devices); the port's own plans and costs equal the file's. The ``mesh``
part needs four devices; ``tests/test_torch_sharding_mesh.py`` recomputes
it in a subprocess and holds the port to it."""
import importlib.util
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "sharding" / "reference.json"


@pytest.fixture(scope="module")
def make_ref():
    name = "sharding_make_reference"
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "experiments" / "sharding" / "make_reference.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return json.loads(REFERENCE.read_text())


def _round_trip(x):
    return json.loads(json.dumps(x))


def test_header(make_ref, ref):
    assert _round_trip(make_ref.header()) == {
        k: v for k, v in ref.items() if k not in ("plans", "costs", "mesh")}


def test_plans_regenerate_bit_for_bit(make_ref, ref):
    assert _round_trip(make_ref.plans()) == ref["plans"]


def test_costs_regenerate_bit_for_bit(make_ref, ref):
    assert _round_trip(make_ref.costs()) == ref["costs"]


def test_the_port_gives_the_files_plans_and_costs(ref):
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs import specs
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.analytic import analytic_cost
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models import steps
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding import make_plan, partition, spec_to_pspec

    class Mesh:
        def __init__(self, shape):
            self.shape = shape

    def as_json(spec):
        return _round_trip([list(e) if isinstance(e, tuple) else e
                            for e in spec])

    for arch in ARCHS:
        cfg = get_config(arch)
        for name, (shape, axes) in {
                "16x16": ((16, 16), ("data", "model")),
                "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}.items():
            want = ref["plans"][arch][name]
            plan = make_plan(cfg, Mesh(dict(zip(axes, shape))))
            assert _round_trip(plan.notes) == want["notes"]
            assert _round_trip(plan.rules) == want["rules"]
            assert {p: as_json(spec_to_pspec(s, plan)) for p, s in
                    tree_leaves(steps.model_param_specs(cfg))} == \
                want["params"]
            for shape_name in SHAPES:
                inputs = specs.input_specs(cfg, shape_name)
                fn = (partition.decode_input_shardings
                      if specs.step_kind(shape_name) == "decode"
                      else partition.batch_shardings)
                assert {p: as_json(s) for p, s in tree_leaves(
                    fn(cfg, plan, inputs))} == want["inputs"][shape_name]
        for shape_name, rec in ref["costs"][arch].items():
            sh = SHAPES[shape_name]
            assert model_flops(cfg, sh) == rec["model_flops"]
            for chips in ("256", "512"):
                assert _round_trip(analytic_cost(cfg, sh, int(chips))
                                   .to_dict()) == rec[chips]


def test_tp_train_keys_are_the_recipes(make_ref, ref):
    """The file's ``tp_train`` part holds, for each case the port trains on
    its blocks (``mesh_cases.TP_TRAIN``), the first step's loss, nll and
    every gradient leaf, each step's metrics and the params after the
    steps; ``tests/test_torch_sharding_tp.py`` recomputes the arrays in a
    JAX subprocess and holds them to the file entry by entry."""
    from repro_torch.sharding import mesh_cases as MC

    assert make_ref.TP_TRAIN == MC.TP_TRAIN
    assert ref["tp_train"] == list(MC.TP_TRAIN)
    want = set()
    for case in MC.TP_TRAIN:
        cfg = make_ref.tp_config(case)
        paths = make_ref.leaves(make_ref.steps.model_param_specs(cfg))
        key = f"tp_train/{case}"
        want |= {f"{key}/loss", f"{key}/nll"}
        want |= {f"{key}/{t}/{m}" for t in range(make_ref.STEPS)
                 for m in ("loss", "nll", "grad_norm", "lr")}
        want |= {f"{key}/{part}/{p}" for part in ("grad", "params")
                 for p in paths}
    assert want == {k for k in ref["mesh"] if k.startswith("tp_train/")}

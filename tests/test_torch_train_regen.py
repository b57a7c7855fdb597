"""``experiments/train/reference.json`` regenerates bit for bit from
``experiments/train/make_reference.py`` (the JAX package on the CPU): the
header, and each config's record (both dtypes, every part), one config a
test. Tier-1 regenerates gemma-2b's (~40 s); phi3-mini-3.8b's and
qwen1.5-32b's go through the same code and are ``slow`` (``-m slow``)."""
import importlib.util
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "train" / "reference.json"


@pytest.fixture(scope="module")
def make_ref():
    name = "train_make_reference"
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "experiments" / "train" / "make_reference.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return json.loads(REFERENCE.read_text())


def test_header_and_configs(make_ref, ref):
    assert json.loads(json.dumps(make_ref.header())) == {
        k: v for k, v in ref.items() if k != "configs"}
    assert list(ref["configs"]) == list(make_ref.ARCHS)


@pytest.mark.parametrize("arch", [
    "gemma-2b",
    pytest.param("phi3-mini-3.8b", marks=pytest.mark.slow),
    pytest.param("qwen1.5-32b", marks=pytest.mark.slow)])
def test_record_regenerates_bit_for_bit(make_ref, ref, arch):
    runs = {dt: make_ref.run(arch, dt) for dt in make_ref.DTYPES}
    got = json.loads(json.dumps(make_ref.summarize(runs)))
    assert got == ref["configs"][arch]

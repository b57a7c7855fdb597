"""``experiments/layers/reference.json`` regenerates bit for bit from
``experiments/layers/make_reference.py`` (the JAX package on the CPU):
the header, and each config's record (both dtypes, every part), one config
a test. Tier-1 regenerates mamba2-370m's (~20 s); the other four go
through the same code and are ``slow`` (``-m slow``)."""
import importlib.util
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "layers" / "reference.json"


@pytest.fixture(scope="module")
def make_ref():
    name = "layers_make_reference"
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "experiments" / "layers" / "make_reference.py")
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
    "mamba2-370m",
    pytest.param("granite-moe-1b-a400m", marks=pytest.mark.slow),
    pytest.param("jamba-1.5-large-398b", marks=pytest.mark.slow),
    pytest.param("whisper-tiny", marks=pytest.mark.slow),
    pytest.param("paligemma-3b", marks=pytest.mark.slow)])
def test_record_regenerates_bit_for_bit(make_ref, ref, arch):
    got = json.loads(json.dumps(make_ref.record(arch)))
    assert got == ref["configs"][arch]

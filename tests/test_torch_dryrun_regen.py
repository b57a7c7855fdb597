"""``experiments/dryrun/reference.json`` regenerates from
``experiments/dryrun/make_reference.py`` (the JAX dry run on 512 forced
host devices, in a subprocess): its cheap cells bit for bit here, the
whole grid with ``-m slow``. The file holds every cell of the grid and of
the hill-climb registry."""
import importlib.util
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "dryrun" / "reference.json"

#: cells the JAX package compiles in 1-2 s each, the skips, and the
#: compressed step that fails under jax 0.9
CHEAP = [f"{arch}__{shape}__{mesh}"
         for arch in ("gemma-2b", "whisper-tiny")
         for shape in ("prefill_32k", "decode_32k", "long_500k")
         for mesh in ("16x16", "2x16x16")] + [
    "phi3-mini-3.8b__train_4k__2x16x16+gradcomp"]


@pytest.fixture(scope="module")
def make_ref():
    name = "dryrun_make_reference"
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "experiments" / "dryrun" / "make_reference.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return json.loads(REFERENCE.read_text())


def test_the_file_holds_the_grid_and_the_registry(make_ref, ref):
    assert list(ref["cells"]) == sorted(make_ref.cells())
    assert len(ref["cells"]) == 10 * 4 * 2 + len(make_ref.experiments())
    statuses = [c["status"] for c in ref["cells"].values()]
    assert statuses.count("skipped") == 16
    assert statuses.count("failed") == 1  # the compressed step, jax 0.9


@pytest.fixture(scope="module")
def cheap(make_ref):
    return make_ref.run(CHEAP)


@pytest.mark.parametrize("key", CHEAP)
def test_cheap_cells_regenerate_bit_for_bit(cheap, ref, key):
    assert cheap[key] == ref["cells"][key]


@pytest.mark.slow
def test_every_cell_regenerates_bit_for_bit(make_ref, ref):
    assert make_ref.run() == ref["cells"]

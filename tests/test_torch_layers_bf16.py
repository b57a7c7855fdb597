"""chip_smoke.py 15a's bfloat16 train-step rule, planted with wrong
gradients, on the CPU.

For each config of ``experiments/layers/reference.json`` the port's
bfloat16 loss and gradients pass the rule (``_layers_bf16_tols``: every
leaf within ``BF16_NOISE_MULTIPLE`` x its own bf16-vs-f32 gap, at most
``BF16_GRAD_RTOL``; ``_bf16_rounding_held``: the whole gradient at least
``BF16_ROUNDING_FLOOR`` x the whole gap from the float32 file), and three
wrong ones planted in their place miss: the port's float32 gradients (the
floor), and zero and negated bfloat16 gradients (every leaf). Jamba's case
is ``slow``.
"""
import dataclasses
import importlib.util
import json
import pathlib
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import convert, steps
from repro_torch.models.common import sorted_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "layers" / "reference.json"
ARCHS = ("granite-moe-1b-a400m", "mamba2-370m", "jamba-1.5-large-398b",
         "whisper-tiny", "paligemma-3b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return json.loads(REFERENCE.read_text())


def _port_step(smoke, ref, arch, dtype):
    """The port's train-step loss and gradients on the file's weights and
    batch, on the CPU."""
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype)
    params = tree_map(torch.from_numpy,
                      convert.conditioned_params(cfg, ref["seed"]))
    batch = smoke._layers_train_batch(cfg, ref["train"], "cpu")
    (loss, _), grads = steps._value_and_grad(steps._forward_loss(cfg))(
        params, batch)
    return float(loss), dict(sorted_leaves(grads))


@pytest.mark.parametrize("arch", [
    pytest.param(a, marks=[pytest.mark.slow] * a.startswith("jamba"))
    for a in ARCHS])
def test_bf16_check_rejects_wrong_gradients(smoke, ref, arch):
    """15a's bfloat16 rule holds the port to bfloat16 on every leaf: the
    port's bfloat16 loss and gradients pass; its float32 ones, given in
    their place, miss the rounding floor; zero and negated bfloat16
    gradients miss on every leaf."""
    rec = ref["configs"][arch]
    want, f32 = rec["bfloat16"]["train"], rec["float32"]["train"]
    tol_of, loss_tol, _ = smoke._layers_bf16_tols(arch, want, f32)
    seed = ref["sketch_seed"]

    def misses(grads):
        out = []
        for path, r in want["grads"].items():
            try:
                smoke._grads_held("planted", {path: grads[path]}, {path: r},
                                  tol_of, seed)
            except smoke.SmokeFailure:
                out.append(path)
        return out

    def rounded(grads):
        try:
            return smoke._bf16_rounding_held("planted", grads, want, f32, seed)
        except smoke.SmokeFailure:
            return None

    loss16, g16 = _port_step(smoke, ref, arch, "bfloat16")
    assert abs(loss16 - want["step"]["value_and_grad_loss"]) <= loss_tol
    assert misses(g16) == [] and rounded(g16) is not None
    _, g32 = _port_step(smoke, ref, arch, "float32")
    assert rounded(g32) is None
    for wrong in (torch.zeros_like, torch.neg):
        assert misses({p: wrong(g) for p, g in g16.items()}) == sorted(g16)

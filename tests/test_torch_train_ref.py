"""chip_smoke.py phase 14 rehearsed on the CPU, and the training reference.

14a holds the port to ``experiments/train/reference.json`` (made by the JAX
package) under its stated tolerances; here it runs as on the card, on the
CPU. 14b (train_100m.py's configuration, the deterministic crash/restore
subprocess) and 14c (a full-width train step and the flash backward
against its oracle) run at tiny sizes. The reference regenerates bit for
bit from ``experiments/train/make_reference.py``
(``tests/test_torch_train_regen.py``).
"""
import dataclasses
import importlib.util
import json
import pathlib
import sys

import pytest
import torch

from repro_torch.configs import get_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    beside other workers (eight threads a worker made the file ~4x
    slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "train" / "reference.json"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke", ROOT / "chip_smoke.py")


@pytest.fixture(scope="module")
def ref():
    return json.loads(REFERENCE.read_text())


def test_phase_14a_rehearsed_on_the_cpu(smoke, ref):
    gaps = smoke.train_reference_phase(ref, device="cpu")
    assert len(gaps) == 3 * 2 * 3
    for key, gap in gaps.items():
        if "float32 grads" in key:
            assert gap <= smoke.F32_GRAD_TOL, key


def test_phase_14b_rehearsed_on_the_cpu(smoke, tmp_path):
    """train_100m.py's phase at a tiny width: 40 steps at lr 3e-3 fall by
    more than 0.5 nats, and the crash/restore subprocess gives bit-equal
    params and metrics."""
    overrides = dict(smoke.TRAIN_100M, n_layers=2, d_model=64, n_heads=2,
                     n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=512,
                     loss_chunk=256, q_chunk=32, kv_chunk=32)
    run = dict(smoke.TRAIN_100M_RUN, steps=40, batch=4, seq=64, warmup=5,
               lr=3e-3, resume_steps=4, profiled_steps=2)
    n = smoke._phi3(overrides).param_count()
    out = smoke.train_100m_phase("SXM", device="cpu", run=run,
                                 overrides=overrides, n_params_want=n,
                                 ckpt_root=tmp_path)
    assert out["last"] < out["first"] - 0.5
    # the card's configuration is train_100m.py's
    cfg = smoke._phi3(smoke.TRAIN_100M)
    assert cfg.param_count() == 110_119_680
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (12, 768, 16_384)


def test_phase_14c_rehearsed_on_the_cpu(smoke):
    cfg = get_config("gemma-2b").reduced(n_layers=2)
    assert cfg.remat == "full"
    out = smoke.train_full_width_phase(
        cfg, "SXM", device="cpu", run=dict(smoke.FULL_TRAIN, seq=128))
    assert len(out["metrics"]) == 2
    assert all(x <= smoke.FLASH_GRAD_TOL for x in out["flash"].values())
    # the card's: gemma-2b as configured, 6 N T of 2048 tokens = 31.1 ms
    full = get_config("gemma-2b")
    bound = 6 * full.param_count() * 2048 / smoke.BF16_PEAK["SXM"] * 1e3
    assert abs(bound - 31.14) < 0.01 and full.remat == "full"


def test_reference_weights_are_the_ports_rule(ref):
    """The file's weights are the serving reference's numpy rule, which
    the port implements (models.convert.numpy_params)."""
    from repro_torch.models import convert

    mk = _load("train_make_reference",
               ROOT / "experiments" / "train" / "make_reference.py")
    for arch in ref["configs"]:
        base = get_config(arch).reduced(n_layers=ref["n_layers"])
        jtree = mk.numpy_params(mk.config(arch, "float32"), ref["seed"])
        assert convert.params_sha256(convert.numpy_params(
            base, ref["seed"])) == convert.params_sha256(jtree)
        assert dataclasses.replace(base, param_dtype="float32").remat == "full"

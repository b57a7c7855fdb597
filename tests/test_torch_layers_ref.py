"""chip_smoke.py phase 15 rehearsed on the CPU, and the layers reference.

15a holds the port to ``experiments/layers/reference.json`` (made by the
JAX package) for each config and dtype under the tolerances that
``experiments/layers/conditioning.py`` measures and ``chip_smoke.py``
states (``LAYERS_F32_GAPS``, ``LAYERS_BF16_GAPS``, ``ROUTE_MARGIN``,
``BF16_NOISE_MULTIPLE``, ``BF16_ROUNDING_FLOOR``); here it runs as on the
card, on the CPU (``tests/test_torch_layers_bf16.py`` plants wrong
gradients in its bfloat16 rule). 15b and
15c (serving and training at full width) run at ``.reduced()`` sizes,
15d's guard on stand-ins for CUDA models. The reference regenerates bit
for bit from ``experiments/layers/make_reference.py``
(``tests/test_torch_layers_regen.py``). Jamba's float32 case is tier-1,
its bfloat16 case ``slow``.
"""
import dataclasses
import importlib.util
import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import convert, steps

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


def _cases():
    for arch in ARCHS:
        for dtype in ("float32", "bfloat16"):
            slow = arch.startswith("jamba") and dtype == "bfloat16"
            yield pytest.param(arch, dtype, marks=[pytest.mark.slow] * slow,
                               id=f"{arch}-{dtype}")


@pytest.mark.parametrize("arch,dtype", list(_cases()))
def test_phase_15a_rehearsed_on_the_cpu(smoke, ref, arch, dtype):
    gaps = smoke.layers_reference_phase(ref, device="cpu", archs=[arch],
                                        dtypes=[dtype])
    assert sorted(gaps) == sorted(f"{arch} {dtype} {k}"
                                  for k in ("prefill", "decode", "grads"))
    if dtype == "float32":
        tol = {k: smoke.LAYERS_F32_MULTIPLE * v
               for k, v in smoke.LAYERS_F32_GAPS[arch].items()}
        assert gaps[f"{arch} float32 prefill"] <= tol["prefill"]
        assert gaps[f"{arch} float32 grads"] <= tol["grads"]


def test_the_reference_covers_every_layer_kind(ref):
    kinds = set()
    for arch in ref["configs"]:
        cfg = get_config(arch).reduced()
        kinds |= set(cfg.layer_kinds())
        assert (cfg.is_encdec or cfg.n_prefix_tokens or
                cfg.layer_kinds() != [("attn", "mlp")] * cfg.n_layers)
    assert kinds == {("attn", "moe"), ("ssm", "none"), ("ssm", "mlp"),
                     ("ssm", "moe"), ("attn", "mlp")}
    jamba = ref["configs"]["jamba-1.5-large-398b"]["float32"]
    assert len(jamba["routing"]) == 4       # one full 8-layer period
    # the f32 routing margins: no token of the reference sits at a near-tie
    # the port could route otherwise (conditioning.py (C))
    for arch in ("granite-moe-1b-a400m", "jamba-1.5-large-398b"):
        for rec in ref["configs"][arch]["float32"]["routing"]:
            m = np.frombuffer(__import__("base64").b64decode(
                rec["margin"]["b64"]), "<f4")
            assert m.min() > 4.9e-5


def test_reference_weights_are_the_ports_rule(ref):
    mk = _load("layers_make_reference",
               ROOT / "experiments" / "layers" / "make_reference.py")
    for arch in ref["configs"]:
        base = get_config(arch).reduced()
        tree = mk.conditioned_params(mk.config(arch), ref["seed"])
        assert convert.params_sha256(convert.conditioned_params(
            base, ref["seed"])) == convert.params_sha256(tree) \
            == ref["configs"][arch]["weights_sha256"]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m",
                                  "whisper-tiny", "paligemma-3b"])
def test_phases_15b_15c_rehearsed_on_the_cpu(smoke, arch):
    """15b and 15c at ``.reduced()`` sizes: the server, the continued
    decode held to the whole prefill at layer 0, two train steps."""
    cfg = get_config(arch).reduced()
    out = smoke.layers_serve_full_width(
        cfg, "SXM", device="cpu", serve=dict(smoke.LAYERS_SERVE, requests=3,
                                             max_new=4), prompt_len=64)
    assert out["bound_ms"] > 0
    if cfg.n_experts:
        assert 2 <= min(out["touched"]) <= max(out["touched"]) <= 4
    out = smoke.layers_train_full_width(
        cfg, "SXM", device="cpu", run=dict(smoke.LAYERS_TRAIN, seq=64,
                                           whisper_tokens=32))
    assert len(out["metrics"]) == 2 and out["bound_ms"] > 0


def test_the_cards_configurations():
    """15b and 15c run the four configs as configured: nothing cut."""
    want = {"granite-moe-1b-a400m": (1_334_756_352, 428_196_864),
            "mamba2-370m": (368_363_008, 368_363_008),
            "whisper-tiny": (36_487_680, 36_487_680),
            "paligemma-3b": (2_508_793_856, 2_508_793_856)}
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    assert tuple(smoke.LAYERS_FULL) == tuple(want)
    for arch, (n, active) in want.items():
        cfg = get_config(arch)
        assert (cfg.param_count(), cfg.active_param_count()) == (n, active)
        assert cfg.remat == "full"
    assert smoke.LAYERS_TRAIN["seq"] == 2048
    assert get_config("paligemma-3b").n_prefix_tokens == 256
    assert get_config("whisper-tiny").enc_seq == 1500


def test_phase_15d_guard_refuses_each_kind(smoke):
    """An MoE train step, an SSM decode step and an enc-dec prefill step
    refuse a CUDA model while bf16 GEMMs may reduce in bf16."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        cuda = types.SimpleNamespace(device=torch.device("cuda"))
        model = types.SimpleNamespace(dtype=torch.bfloat16, embed=cuda)
        for arch, call in (
                ("granite-moe-1b-a400m", lambda c: steps.make_train_step(c)(
                    {"params": {}, "opt": {"step": cuda}}, {})),
                ("mamba2-370m", lambda c: steps.make_decode_step(c)(
                    model, None, {}, 0)),
                ("whisper-tiny", lambda c: steps.make_prefill_step(c)(
                    model, {}))):
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      param_dtype="bfloat16")
            with pytest.raises(RuntimeError, match="exact GEMMs"):
                call(cfg)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag

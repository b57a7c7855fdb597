"""repro_torch.launch.serve vs the JAX package's server, on the CPU, and
the serving reference.

Both servers run on the same numpy-seeded weights (the reference's rule,
``models.convert.numpy_params``) and requests. In float32 every decode
call serves the same next tokens in every slot; in bfloat16 the logits of
the two packages differ by a few bf16 ulps, so a call may serve another
token where the JAX package's top-2 logit gap is within ``BF16_TOL``
(2^-4), and the comparison ends there (the histories part), as
``chip_smoke.py`` phase 13a holds the card. Phase 13a and 13b themselves
run here on the CPU at a small size.
"""
import dataclasses
import importlib.util
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as JSV
from repro_torch.configs import get_config
from repro_torch.launch import serve as SV
from repro_torch.models import convert, transformer
from repro_torch.models.common import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "serve" / "reference.json"


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
def make_ref():
    return _load("serve_make_reference",
                 ROOT / "experiments" / "serve" / "make_reference.py")


@pytest.fixture(scope="module")
def ref():
    return json.loads(REFERENCE.read_text())


def _jax_calls(srv):
    calls, inner = [], srv.decode

    def recording(p, tok, caches, pos):
        nxt, logits, new = inner(p, tok, caches, pos)
        lf = np.asarray(logits[:, -1].astype(jnp.float32))
        top = np.sort(lf, axis=-1)[:, -2:]
        calls.append({"pos": int(pos), "next": np.asarray(nxt)[:, 0].tolist(),
                      "gap": (top[:, 1] - top[:, 0]).tolist()})
        return nxt, logits, new

    srv.decode = recording
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma-2b", "phi3-mini-3.8b", "qwen1.5-32b"])
def test_server_matches_jax(arch, dtype, smoke, make_ref):
    base = get_config(arch).reduced(n_layers=2)
    cfg = dataclasses.replace(base, param_dtype=dtype)
    jcfg = dataclasses.replace(make_ref.config(arch), param_dtype=dtype)
    tree = convert.numpy_params(cfg, 5)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    spec = dict(make_ref.SERVE, seed=9, requests=7, max_new=6, max_batch=3,
                max_len=40)
    jsrv = JSV.Server(jcfg, jax.tree.map(lambda a: jnp.asarray(a).astype(jdt),
                                         tree),
                      max_batch=spec["max_batch"], max_len=spec["max_len"])
    jcalls = _jax_calls(jsrv)
    for r in smoke._serve_requests(jcfg, spec, JSV.Request):
        jsrv.submit(r)
    while jsrv.step():
        pass
    model = convert.from_jax_params(cfg, tree, "cpu")
    srv = SV.Server(cfg, model, max_batch=spec["max_batch"],
                    max_len=spec["max_len"])
    assert srv.model.dtype == {"float32": torch.float32,
                               "bfloat16": torch.bfloat16}[dtype]
    calls = smoke._recording(srv)
    for r in smoke._serve_requests(cfg, spec, SV.Request):
        srv.submit(r)
    while srv.step():
        pass
    assert srv.steps == jsrv.steps
    assert [r.rid for r in srv.done] == [r.rid for r in jsrv.done]
    want = {"calls": jcalls}
    compared, ties = smoke._served_tokens_held(f"{arch} {dtype}", calls, want,
                                               dtype == "float32")
    if dtype == "float32":
        assert compared == len(calls) and not ties
        assert {r.rid: r.out for r in srv.done} == \
            {r.rid: r.out for r in jsrv.done}
    else:
        assert compared > 0


def test_numpy_weight_rule_matches_the_reference_script(make_ref):
    for arch in make_ref.ARCHS:
        cfg = get_config(arch).reduced(n_layers=2)
        got = dict(tree_leaves(convert.numpy_params(cfg, 3)))
        want = dict(tree_leaves(make_ref.numpy_params(make_ref.config(arch), 3)))
        assert got.keys() == want.keys()
        for path in got:
            assert got[path].dtype == np.float32
            assert np.array_equal(got[path], want[path]), path


def test_spec_lists_match_the_reference(ref):
    for arch, rec in ref["configs"].items():
        cfg = get_config(arch).reduced(**rec["overrides"])
        specs = sorted([p, list(s.shape)] for p, s in
                       tree_leaves(transformer.param_specs(cfg)))
        assert specs == rec["specs"], arch
        assert convert.params_sha256(convert.numpy_params(cfg, ref["seed"])) \
            == rec["weights_sha256"], arch


def test_port_holds_to_the_reference_on_the_cpu(ref, smoke):
    """chip_smoke.py phase 13a, here on the CPU."""
    gaps = smoke.serve_reference_phase(ref, "cpu")
    assert len(gaps) == 3 * 2 * 2 + 1
    for key, gap in gaps.items():
        if "float32 prefill" in key:
            assert gap <= smoke.F32_ATOL + smoke.F32_RTOL, key


def test_reference_regenerates_bit_for_bit(tmp_path, make_ref):
    out = tmp_path / "reference.json"
    make_ref.main(out)
    assert out.read_bytes() == REFERENCE.read_bytes()


def test_full_width_phase_runs_on_the_cpu_at_a_small_size(smoke):
    """chip_smoke.py phase 13b's control flow, on a two-layer gemma of
    reduced width with chunks of 16 (the card runs it at full width)."""
    cfg = get_config("gemma-2b").reduced(n_layers=2, q_chunk=16, kv_chunk=16)
    serve = dict(smoke.FULL_SERVE, requests=5, max_new=5, max_len=48)
    stats = smoke.serve_full_width_phase(cfg, "SXM", "cpu", serve=serve,
                                         prefill_len=24, flash_len=40)
    assert stats["tokens"] == 25 and stats["step_ms"] is None
    assert stats["busy"] is None and stats["peak_gib"] is None
    assert stats["bound_ms"] > 0


def test_serve_cli_on_the_cpu(capsys):
    SV.main(["--device", "cpu", "--requests", "5", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 5 requests, 20 tokens" in out and "on cpu" in out


def test_server_runs_one_host_read_a_step():
    cfg = get_config("gemma-2b").reduced(n_layers=1)
    model = convert.from_jax_params(cfg, convert.numpy_params(cfg, 0), "cpu")
    srv = SV.Server(cfg, model, max_batch=2, max_len=16)
    reads = []
    real = torch.Tensor.cpu

    def counting(t, *a, **k):
        reads.append(tuple(t.shape))
        return real(t, *a, **k)

    srv.submit(SV.Request(0, np.array([1, 2, 3], np.int32), max_new=4))
    torch.Tensor.cpu = counting
    try:
        while srv.step():
            pass
    finally:
        torch.Tensor.cpu = real
    assert srv.steps == 4 and reads == [(2, 1)] * 4

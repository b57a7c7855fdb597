"""repro_torch.checkpoint and launch.train vs the JAX package's, on the CPU.

The two packages share one on-disk format: a checkpoint written by either
restores in the other bit for bit (float32, bfloat16 through its uint16
view, the int32 step), with the same manifest keys, files, shapes and
dtype strings. Also: keep-k rotation, torn ``.tmp`` directories, a shape
mismatch, the crash/restart run bit-equal to the straight one
(``tests/test_system.py::test_train_checkpoint_restart_bitexact``, held
here at equality rather than its rtol 1e-5), and the ``launch.train`` CLI.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as JM
from repro.configs import get_config as jget_config
from repro.models import steps as JS
from repro_torch.checkpoint import (CheckpointManager, latest_step, manager,
                                    restore, save)
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import convert, steps
from repro_torch.models.common import sorted_leaves
from repro_torch.optim import AdamWConfig


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


def _jax_state(dtype="bfloat16"):
    cfg = dataclasses.replace(jget_config("gemma-2b").reduced(n_layers=2),
                              moment_dtype=dtype)
    state = JS.init_train_state(cfg, jax.random.PRNGKey(3))
    # nonzero moments and step, as after some training
    state["opt"]["m"] = jax.tree.map(lambda p: (p * 0.5).astype(p.dtype)
                                     if p.dtype == jnp.float32 else p,
                                     state["opt"]["m"])
    state["opt"]["m"] = jax.tree.map(
        lambda m, p: (p * 0.25).astype(m.dtype), state["opt"]["m"],
        state["params"])
    state["opt"]["v"] = jax.tree.map(
        lambda v, p: (p * p).astype(v.dtype), state["opt"]["v"],
        state["params"])
    state["opt"]["step"] = jnp.int32(17)
    return state


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (bf16 through uint16, the rest as stored)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_bits(port, jax_tree):
    p = dict(sorted_leaves(port))
    j = dict(sorted_leaves(jax.tree.map(np.asarray, jax_tree)))
    assert sorted(p) == sorted(j)
    for key in j:
        a, b = _bits(p[key]), _bits(j[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, moment):
    state = _jax_state(moment)
    JM.save(tmp_path, 17, state, extra={"arch": "gemma-2b"})
    like = convert.tree_from_jax(jax.tree.map(np.asarray, state), "cpu")
    got = restore(tmp_path, 17, like)
    _same_bits(got, state)
    assert got["opt"]["step"].dtype == torch.int32
    if moment == "bfloat16":
        assert got["opt"]["m"]["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, moment):
    state = convert.tree_from_jax(
        jax.tree.map(np.asarray, _jax_state(moment)), "cpu")
    save(tmp_path / "port", 17, state, extra={"arch": "gemma-2b"})
    like = _jax_state(moment)
    got = JM.restore(tmp_path / "port", 17, like)
    _same_bits(state, got)
    # the same files: manifest keys, shapes, dtype strings and the bytes
    JM.save(tmp_path / "jax", 17, like, extra={"arch": "gemma-2b"})
    mp = json.loads((tmp_path / "port" / "step_00000017" / "manifest.json")
                    .read_text())
    mj = json.loads((tmp_path / "jax" / "step_00000017" / "manifest.json")
                    .read_text())
    assert mp["leaves"] == mj["leaves"] and mp["extra"] == mj["extra"]
    assert mp["step"] == mj["step"] == 17
    for rec in mp["leaves"]:
        a = (tmp_path / "port" / "step_00000017" / rec["file"]).read_bytes()
        b = (tmp_path / "jax" / "step_00000017" / rec["file"]).read_bytes()
        assert a == b, rec["key"]


def test_train_state_conversion_round_trip():
    state = _jax_state("bfloat16")
    port = convert.tree_from_jax(jax.tree.map(np.asarray, state), "cpu")
    back = convert.tree_to_numpy(port)
    _same_bits(port, state)
    for (key, a), (_, b) in zip(sorted_leaves(back), sorted_leaves(
            jax.tree.map(np.asarray, state))):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), key
    # and back into JAX arrays of the same dtypes
    again = jax.tree.map(jnp.asarray, back)
    _same_bits(port, again)


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip_and_meta_like(tmp_path):
    t = _tree()
    save(tmp_path, 10, t, extra={"note": "x"})
    assert latest_step(tmp_path) == 10
    out = restore(tmp_path, 10, t)
    for (k, a), (_, b) in zip(sorted_leaves(out), sorted_leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    meta = {"a": torch.empty((2, 3), device="meta"),
            "b": {"c": torch.empty(4, device="meta"),
                  "d": torch.empty((), device="meta")}}
    out = restore(tmp_path, 10, meta)
    assert out["a"].device.type == "cpu" and torch.equal(out["a"], t["a"])
    assert out["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_atomic_ignores_torn(tmp_path):
    save(tmp_path, 5, _tree())
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000011").mkdir()   # no manifest: torn
    assert latest_step(tmp_path) == 5
    mgr = CheckpointManager(tmp_path)
    out, info = mgr.restore_latest(_tree())
    assert info["step"] == 5 and torch.equal(out["a"], _tree()["a"])


def test_checkpoint_keep_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    kept = sorted(d.name for d in tmp_path.iterdir())
    assert kept == ["step_00000003", "step_00000004"]
    assert mgr.latest() == 4


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save(tmp_path, 1, _tree())
    bad = _tree()
    bad["a"] = torch.zeros((3, 3))
    with pytest.raises(ValueError, match="shape"):
        restore(tmp_path, 1, bad)
    missing = _tree()
    missing["e"] = torch.zeros(1)
    with pytest.raises(KeyError):
        restore(tmp_path, 1, missing)


def test_train_checkpoint_restart_bitexact(tmp_path):
    """Training N steps straight == training with a crash/restore at N/2,
    bit for bit (the JAX package's system test, on the port)."""
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(n_layers=2),
                              remat="none")
    opt = AdamWConfig(lr=1e-3)
    step = steps.make_train_step(cfg, opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=2, seed=3))

    def init():
        return steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                      opt, "cpu")

    def run(n, restart_at=None):
        mgr = CheckpointManager(tmp_path / f"r{restart_at}", keep=2)
        state = init()
        metrics = []
        s = 0
        while s < n:
            state, m = step(state, data.batch_at(s))
            metrics.append({k: float(v) for k, v in m.items()})
            s += 1
            if restart_at and s == restart_at:
                mgr.save(s, state)
                del state
                state, info = mgr.restore_latest(init())
                assert info["step"] == s
        return state, metrics

    s1, m1 = run(6)
    s2, m2 = run(6, restart_at=3)
    assert m1 == m2
    for (k, a), (_, b) in zip(sorted_leaves(s1), sorted_leaves(s2)):
        assert torch.equal(a, b), k


def _cli(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_train_cli_runs_saves_and_resumes(tmp_path):
    args = ["--arch", "gemma-2b", "--reduced", "--batch", "2", "--seq", "32",
            "--log-every", "2", "--ckpt-every", "3", "--ckpt-dir",
            str(tmp_path), "--device", "cpu"]
    out = _cli(*args, "--steps", "4")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("step     1  nll ")
    assert lines[-1].startswith("done in ") and "first nll" in lines[-1]
    assert latest_step(tmp_path) == 4
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json")
                          .read_text())
    assert manifest["extra"] == {"arch": "gemma-2b"}
    keys = [rec["key"] for rec in manifest["leaves"]]
    assert keys == sorted(keys) and "opt/step" in keys
    assert "params/layers/l0/attn/wq" in keys
    out = _cli(*args, "--steps", "6")
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "[restore] resumed from step 4"
    assert "step     5  nll" in out.stdout
    assert sorted(d.name for d in tmp_path.iterdir()) == [
        "step_00000004", "step_00000006"]


def test_train_cli_needs_the_card_and_one_device(tmp_path):
    """The CLI's ``main`` (what ``python -m repro_torch.launch.train``
    runs, in process: both refusals come before it touches a flag)."""
    from repro_torch.launch import train

    args = ["--arch", "gemma-2b", "--reduced", "--steps", "1", "--ckpt-dir",
            str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(args)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        train.main([*args, "--mesh", "production", "--device", "cpu"])
    assert not any(tmp_path.iterdir())


def test_manifest_dtype_names_cover_the_state():
    assert manager._DTYPES[torch.bfloat16] == "bfloat16"
    assert manager._DTYPES[torch.int32] == "int32"
    assert manager._DTYPES[torch.float32] == "float32"

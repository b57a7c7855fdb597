"""The port's tile autotuner (``repro_torch.kernels.autotune``) against
the JAX package's (``repro.kernels.autotune``): the same shape keys and
table overlay on the same files, ``resolve``'s precedence over the port's
knobs (the JAX ``test_wavefront.py`` and ``test_packed.py`` autotuner
cases), the min-plus wrappers' launches following a tuned entry, and
``autotune`` refusing the CPU and the ops whose tile the card picks."""
import json
import types

import pytest
import torch

from repro.kernels import autotune as J
from repro_torch import obs
from repro_torch.kernels import autotune as A
from repro_torch.kernels import ops
from repro_torch.kernels import semiring as S


@pytest.fixture
def table(tmp_path, monkeypatch):
    """A fresh user table for this test (and a clean in-process cache)."""
    path = tmp_path / "table.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_TABLE", str(path))
    A.load_table(refresh=True)
    yield path
    monkeypatch.delenv("REPRO_TORCH_TUNE_TABLE")
    A.load_table(refresh=True)


@pytest.mark.parametrize("dims", [(100, 128, 129, None), (1024, 1000, 513, None),
                                  (1, 1, 1, "f32"), (4096, 4096, 4096, "packed"),
                                  (2048, 130, 512, "bf16"), (512, 512, 512, None)])
def test_shape_key_equals_the_jax_module(dims):
    assert A.shape_key(*dims) == J.shape_key(*dims)


def test_shape_bucketing():
    assert A.shape_key(100, 128, 129) == "128x128x256"
    assert A.shape_key(1024, 1000, 513) == "1024x1024x1024"


def test_table_overlay_equals_the_jax_module(tmp_path, monkeypatch):
    shipped, user = tmp_path / "shipped.json", tmp_path / "user.json"
    shipped.write_text(json.dumps({
        "minplus": {"512x512x512": {"tile": "small", "split": 2},
                    "1024x1024x1024": {"tile": "large", "split": 1}},
        "minplus_count": {"512x512x512": {"split": 2}}}))
    user.write_text(json.dumps({
        "minplus": {"512x512x512": {"tile": "small", "split": 4}},
        "batched_minplus": {"2048x2048x2048": {"tile": "small",
                                               "split": 3}}}))
    for mod, env in ((A, "REPRO_TORCH_TUNE_TABLE"), (J, "REPRO_TUNE_TABLE")):
        monkeypatch.setattr(mod, "_SHIPPED", shipped)
        monkeypatch.setenv(env, str(user))
    try:
        got = A.load_table(refresh=True)
        assert got == J.load_table(refresh=True)
        assert got["minplus"]["512x512x512"] == {"tile": "small", "split": 4}
        assert got["minplus"]["1024x1024x1024"]["tile"] == "large"
    finally:
        monkeypatch.undo()
        A.load_table(refresh=True)
        J.load_table(refresh=True)


def test_the_shipped_table_is_empty():
    assert json.loads(A._SHIPPED.read_text()) == {}
    assert A._SHIPPED.parent.name == "kernels"


def test_user_table_defaults_to_its_own_folder(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_TUNE_TABLE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert A._user_table_path() == (tmp_path / ".cache" / "repro_torch"
                                    / "tuning_table.json")


def test_resolve_precedence(table):
    """Overrides > table > the current rule (``S._minplus_rule``)."""
    base = A.resolve("minplus", 512, 512, 512)
    assert base == {"tile": "small", "split": 2} == dict(
        zip(("tile", "split"), S._minplus_rule(1, 512, 512, 512)))
    A.save_entry("minplus", A.shape_key(512, 512, 512),
                 {"tile": "small", "split": 4})
    assert A.resolve("minplus", 512, 512, 512)["split"] == 4
    assert A.resolve("minplus", 500, 511, 300)["split"] == 4  # same bucket
    # explicit arguments always beat the table
    assert A.resolve("minplus", 512, 512, 512, split=1) == {
        "tile": "small", "split": 1}
    # the large tile where the rule's grid cannot take it falls back to
    # the rule (the C entry forces the split tile only)
    A.save_entry("minplus", A.shape_key(256, 256, 256), {"tile": "large"})
    assert A.resolve("minplus", 256, 256, 256) == {
        "tile": "small", "split": S._minplus_rule(1, 256, 256, 256)[1]}
    # batched: the rule's large tile at B=12, 2048, a tuned split beats it
    assert A.resolve("batched_minplus", 2048, 2048, 2048, batch=12) == {
        "tile": "large", "split": 1}
    A.save_entry("batched_minplus", A.shape_key(2048, 2048, 2048),
                 {"tile": "small", "split": 3})
    assert A.resolve("batched_minplus", 2048, 2048, 2048, batch=12) == {
        "tile": "small", "split": 3}
    assert A.resolve("batched_minplus", 2048, 2048, 2048, batch=12,
                     tile="large") == {"tile": "large", "split": 1}
    # the count product: the split only
    assert A.resolve("minplus_count", 512, 512, 512) == {"split": 2}
    A.save_entry("minplus_count", A.shape_key(512, 512, 512), {"split": 8})
    assert A.resolve("minplus_count", 512, 512, 512) == {"split": 8}


def test_packed_dtype_key_precedence(table):
    key_f32 = A.shape_key(4096, 4096, 4096)
    key_packed = A.shape_key(4096, 4096, 4096, dtype="packed")
    assert key_packed == key_f32 + ":packed"
    A.save_entry("minplus", key_f32, {"tile": "small", "split": 2})
    A.save_entry("minplus", key_packed, {"tile": "small", "split": 5})
    # an f32 lookup never reads the packed entry and vice versa
    assert A.resolve("minplus", 4096, 4096, 4096)["split"] == 2
    assert A.resolve("minplus", 4096, 4096, 4096, dtype="packed")[
        "split"] == 5
    # an untuned packed shape falls back to the rule, not the f32 entry
    assert A.resolve("minplus", 8192, 8192, 8192, dtype="packed") == dict(
        zip(("tile", "split"), S._minplus_rule(1, 8192, 8192, 8192)))
    # explicit arguments still beat the table
    assert A.resolve("minplus", 4096, 4096, 4096, dtype="packed",
                     split=7)["split"] == 7


@pytest.mark.parametrize("op", ["count", "boolean", "frontier_step",
                                "batched_count", "batched_frontier_step"])
def test_card_picked_tiles_have_no_knob(op):
    assert A.resolve(op, 512, 512, 512) == {}
    with pytest.raises(ValueError, match="on the card from the operand"):
        A.autotune(op, 512)


def test_autotune_refuses_packed_unknown_and_the_cpu():
    with pytest.raises(ValueError, match="on the card from the operand"):
        A.autotune("frontier_step", 512, dtype="packed")
    with pytest.raises(ValueError, match="unknown"):
        A.resolve("semiring", 512, 512, 512)
    with pytest.raises(ValueError, match="no tile"):
        A.autotune("minplus", 512, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            A.autotune("minplus", 512)


def test_minplus_plan_obeys_a_tuned_entry(table):
    assert S._minplus_plan(1, 512, 512, 512) == ("small", 2)
    assert S._minplus_plan(12, 2048, 2048, 2048) == ("large", 1)
    A.save_entry("minplus", "512x512x512", {"tile": "small", "split": 6})
    A.save_entry("batched_minplus", "2048x2048x2048",
                 {"tile": "small", "split": 3})
    A.save_entry("minplus_count", "512x512x512", {"split": 8})
    assert S._minplus_plan(1, 512, 512, 512) == ("small", 6)
    assert S._minplus_plan(12, 2048, 2048, 2048) == ("small", 3)
    assert S._minplus_plan(1, 512, 512, 512, 2) == ("small", 8)
    # a forced split (the checks' seam) beats the table
    assert S._minplus_plan(1, 512, 512, 512, 1, 2) == ("small", 2)
    with pytest.raises(ValueError):
        S._minplus_plan(1, 512, 512, 512, 1, 9)
    with pytest.raises(ValueError):
        S._minplus_plan(1, 512, 512, 512, 2, None, "large")


@pytest.fixture
def launches(monkeypatch):
    """The min-plus wrappers' C entries replaced by recorders, so the host
    path (plan, forced split) runs on CPU tensors: the split argument each
    launch passes."""
    seen = []

    def entry(name, i):
        def call(*args):
            seen.append((name, args[i]))
            return 0
        return call

    lib = types.SimpleNamespace(
        repro_minplus_f32=entry("minplus", 6),
        repro_minplus_batched_f32=entry("batched", 6),
        repro_minplus_count_f32=entry("count", 7))
    monkeypatch.setattr(S, "_tropical_lib", lambda: lib)
    monkeypatch.setattr(S, "_use_kernel", lambda *a, **k: True)
    monkeypatch.setattr(S, "_tile_counts", lambda dev, name: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return seen


def test_launches_follow_the_table_and_the_keywords(table, launches):
    a = torch.zeros(512, 512)
    b3 = torch.zeros(12, 1024, 1024)
    ops.minplus_matmul(a, a)
    ops.batched_minplus_matmul(b3, b3)
    ops.minplus_count_matmul(a, a, a, a)
    A.save_entry("minplus", "512x512x512", {"tile": "small", "split": 5})
    A.save_entry("batched_minplus", "1024x1024x1024", {"tile": "small",
                                                    "split": 7})
    A.save_entry("minplus_count", "512x512x512", {"split": 3})
    ops.minplus_matmul(a, a)
    ops.batched_minplus_matmul(b3, b3)
    ops.minplus_count_matmul(a, a, a, a)
    ops.minplus_matmul(a, a, split=1)
    ops.batched_minplus_matmul(b3, b3, tile="large")
    ops.minplus_count_matmul(a, a, a, a, split=2)
    # the rule's picks (the large tile is the C entry's 0), then the
    # table's, then the keywords'
    assert launches == [("minplus", 2), ("batched", 0), ("count", 2),
                        ("minplus", 5), ("batched", 7), ("count", 3),
                        ("minplus", 1), ("batched", 0), ("count", 2)]


def test_resolve_is_an_instant_once_per_key(table, monkeypatch):
    monkeypatch.setattr(A, "_DECISIONS_SEEN", set())
    obs.enable()
    obs.reset()
    try:
        A.resolve("minplus", 512, 512, 512)
        A.resolve("minplus", 512, 512, 512)
        A.resolve("minplus", 512, 512, 512, split=3)
        A.resolve("minplus_count", 512, 512, 512)
        events = [e for e in obs.events() if e["name"] == "autotune.resolve"]
    finally:
        obs.disable()
        obs.reset()
    assert [e["args"]["op"] for e in events] == ["minplus", "minplus_count"]
    first = events[0]["args"]
    assert first["shape"] == "512x512x512"
    assert first["config"] == {"tile": "small", "split": 2}
    assert first["source"] == {"tile": "default", "split": "default"}
    assert first["tuned_entry"] is None
    assert events[0]["cat"] == "kernels"
    # disabled: nothing recorded
    A.resolve("batched_minplus", 1024, 1024, 1024, batch=2)
    assert not [e for e in obs.events() if e["name"] == "autotune.resolve"]

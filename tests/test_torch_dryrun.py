"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``experiments/dryrun/reference.json``, from
``experiments/dryrun/make_reference.py``).

Held bit for bit: status and skip reasons, plan notes, the analytic
roofline fields, and the argument bytes the JAX step's spec trees give a
rank against XLA's ``argument_size_in_bytes``. Leaf by leaf: the port's
own argument and output bytes against XLA's (the serving steps hold the
rank's bf16 blocks of the weights, gemma-2b's and whisper-tiny's alike;
XLA's outputs carry an 8-byte tuple entry a leaf). The port's own fields (its
collective list, its peak) are held to the port run for real on four gloo
CPU ranks, and the live-bytes tracker to a toy step counted by hand. The
32k-token prefill cells trace 1024 flash blocks a layer on meta (minutes)
and are ``slow``."""
import json
import math
import pathlib

import pytest
import torch
import torch.distributed as tdist

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "dryrun" / "reference.json"

ARCHS = ("gemma-2b", "whisper-tiny")
FAST_SHAPES = ("train_4k", "decode_32k", "long_500k")
MESHES = {"16x16": False, "2x16x16": True}


def _key(arch, shape, mesh):
    return f"{arch}__{shape}__{mesh}"


CELLS = [_key(a, s, m) for a in ARCHS for s in FAST_SHAPES for m in MESHES]
SLOW_CELLS = [_key(a, "prefill_32k", m) for a in ARCHS for m in MESHES]
ALL_CELLS = CELLS + [pytest.param(k, marks=pytest.mark.slow)
                     for k in SLOW_CELLS]

#: the gloo cells: granite's expert-parallel sharded train step and gemma's
#: seq-sharded decode, reduced, on (data, model) = (2, 2)
GLOO_CELLS = (
    {"arch": "granite-moe-1b-a400m", "reduced": True, "kind": "train",
     "batch": 4, "seq": 32},
    {"arch": "gemma-2b", "reduced": True, "kind": "decode", "batch": 4,
     "seq": 64, "overrides": {"decode_attention": "sharded"}},
)


@pytest.fixture(scope="module")
def ref():
    return json.loads(REFERENCE.read_text())["cells"]


_RECS, _OPS = {}, {}


def _rec(key):
    """The port's record of one cell, traced once per module (`run_cell`'s;
    every collective of the trace in ``_OPS``, where the record lists the
    first 200)."""
    if key not in _RECS:
        import time

        from repro_torch.launch import dryrun

        arch, shape, mesh = key.split("__")
        t0 = time.time()
        try:
            tr, mesh_shape, cfg, sh, meta = dryrun.lower_cell(
                arch, shape, MESHES[mesh])
        except dryrun.SkipCell:
            _RECS[key] = dryrun.run_cell(arch, shape, MESHES[mesh],
                                         save=False)
        else:
            _OPS[key] = tr["ops"]
            _RECS[key] = dryrun._finish(tr, mesh_shape, cfg, sh, meta, t0)
    return _RECS[key]


@pytest.mark.parametrize("key", ALL_CELLS)
def test_shared_fields_equal_the_jax_dry_run(key, ref):
    from repro_torch.launch import dryrun

    assert dryrun.compare_to_reference(_rec(key), ref[key]) == []
    assert not tdist.is_initialized()


def _tree_leaves(tree):
    """Leaves in path order (specs and tensors pair up)."""
    from repro_torch.models.common import sorted_leaves

    return [t for _, t in sorted_leaves(tree)]


def _blocks(t, spec, shape):
    n = t.numel() * t.element_size()
    for e in spec:
        if e is not None:
            n //= math.prod(shape[a] for a in ((e,) if isinstance(e, str)
                                               else e))
    return n


class _Shape:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("key", ALL_CELLS)
def test_argument_and_output_bytes_leaf_by_leaf(key, ref):
    """The port's argument bytes against XLA's, and its output bytes
    against XLA's: train steps take the same blocks (XLA's outputs add an
    8-byte tuple entry a leaf); serving steps hold bf16 weights where the
    JAX dry run passes float32 master blocks: the blocks of
    ``params_only_shardings`` (gemma-2b and whisper-tiny alike; XLA drops
    the leaves a step never reads, such as whisper's encoder in its
    decode), and the decode takes ``cache_pos`` as a Python int (4 B in
    XLA's)."""
    from repro_torch.configs import get_config, shape_for
    from repro_torch.configs.specs import (abstract_params_tree,
                                           abstract_train_state, input_specs)
    from repro_torch.sharding import (decode_input_shardings, make_plan,
                                      params_only_shardings)

    rec, want = _rec(key), ref[key]
    if rec["status"] == "skipped":
        assert want["status"] == "skipped"
        return
    arch, shape_name, mesh = key.split("__")
    cfg = get_config(arch)
    mesh_shape = dict(zip(("pod", "data", "model")[-len(mesh.split("x")):],
                          map(int, mesh.split("x"))))
    plan = make_plan(cfg, _Shape(mesh_shape))
    mem, xla = rec["memory"], want["memory"]
    parts = mem["argument_parts"]
    assert mem["argument_bytes"] == sum(parts.values())
    inputs = input_specs(cfg, shape_name)
    kind = shape_for(shape_name).kind
    if kind == "train":
        assert mem["argument_bytes"] == xla["argument_bytes"]
        state = abstract_train_state(cfg)
        n_out = len(_tree_leaves(state)) + 4  # the four metric scalars
        assert xla["output_bytes"] == mem["output_bytes"] + 8 * n_out
        return
    # serving: bf16 blocks here, float32 blocks of the read leaves in XLA's
    # arguments
    ptree = abstract_params_tree(cfg)
    held = sum(_blocks(t, sp, mesh_shape) for t, sp in zip(
        _tree_leaves(ptree), _tree_leaves(params_only_shardings(cfg, plan))))
    assert parts["params"] == held
    assert mem["argument_bytes"] - held == \
        xla["argument_bytes"] - mem["jax_argument_bytes"] + sum(
            v for k, v in parts.items() if k != "params")
    if kind == "decode":
        dec = decode_input_shardings(cfg, plan, inputs)
        jax_caches = sum(_blocks(t, s, mesh_shape) for t, s in zip(
            _tree_leaves(inputs["caches"]), _tree_leaves(dec["caches"])))
        token = _blocks(inputs["token"], dec["token"], mesh_shape)
        assert mem["jax_argument_bytes"] - xla["argument_bytes"] == 0
        assert parts["token"] == token
        assert parts["caches"] == jax_caches
        # XLA's outputs: the next token, the bf16 logits over the batch
        # axes and the vocabulary over model (no constraint: XLA's pick),
        # the caches in their input blocks, 8 B a leaf
        b = inputs["token"].shape[0] // plan.axis_size(plan.batch_axes)
        v = cfg.padded_vocab // mesh_shape["model"]
        n_leaves = 2 + len(_tree_leaves(inputs["caches"]))
        assert xla["output_bytes"] == token + b * v * 2 + jax_caches \
            + 8 * n_leaves
        # the port's: the next token and its bf16 logits for its batch
        # block (the whole vocabulary), the caches it holds
        assert mem["output_bytes"] == token + b * cfg.padded_vocab * 2 \
            + parts["caches"]


def test_port_notes_name_every_form_the_port_lacks():
    # gemma-2b serves on its blocks: only the Python-int position remains
    rec = _rec(_key("gemma-2b", "decode_32k", "16x16"))
    notes = " ".join(rec["port_notes"])
    assert "cache_pos" in notes and "weights whole" not in notes
    assert "decode caches" not in notes
    # so does whisper-tiny (an encoder-decoder): its blocks of the weights
    # and of the self and cross caches (the cross caches' 1500 frames whole
    # where they do not divide model=16, as the JAX step's spec has them)
    notes = " ".join(_rec(_key("whisper-tiny", "decode_32k",
                               "16x16"))["port_notes"])
    assert "cache_pos" in notes and "weights whole" not in notes
    assert "decode caches" not in notes
    # gemma-2b trains on its blocks: only attention, whole on every model
    # rank where its one kv head leaves the heads replicated, remains
    notes = _rec(_key("gemma-2b", "train_4k", "16x16"))["port_notes"]
    assert len(notes) == 1 and notes[0].startswith(
        "train: the heads replicated (8 q / 1 kv do not divide model=16)")
    assert "gathered whole" not in notes[0]


@pytest.mark.parametrize("arch", ["mamba2-370m", "whisper-tiny",
                                  "jamba-1.5-large-398b", "paligemma-3b"])
def test_train_notes_name_the_whole_layer_gather(arch):
    """No config keeps the layers gathered whole under a plan: the SSM,
    hybrid, prefix and encoder-decoder configs compute on their blocks,
    and their notes name at most attention run whole where its heads are
    replicated (none for the attention-free SSM stack), as a dense
    config's do; whisper-tiny's also name its encoder stream kept whole
    (1500 frames do not divide model=16), in its traced record too."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.sharding import make_plan

    cfg = get_config(arch)
    plan = make_plan(cfg, _Shape({"data": 16, "model": 16}))
    notes = " ".join(dryrun.train_notes(cfg, plan))
    gathered = "the layers gathered whole over every axis, model included"
    assert gathered not in notes
    if arch == "whisper-tiny":
        assert notes.startswith("train: the heads replicated (6 q / 6 kv")
        assert "the encoder's 1500 frames do not divide model=16" in notes
        assert " ".join(_rec(_key(arch, "train_4k", "16x16"))[
            "port_notes"]) == notes
    elif arch == "mamba2-370m":
        assert notes == ""
    else:
        assert notes.startswith("train: the heads replicated (")
    phi3 = get_config("phi3-mini-3.8b")
    assert dryrun.train_notes(phi3, make_plan(phi3, _Shape(
        {"data": 16, "model": 16}))) == []


def test_compressed_record_holds_the_ranks_blocks():
    """The hill-climb's ``gradcomp`` cell (phi3-mini-3.8b ``train_4k`` on
    2x16x16, int8 pod-compressed): the state and the float32 error tree
    are the rank's blocks of ``train_state_shardings``, leaf by leaf, so
    the argument bytes are ``_jax_argument_bytes(..., compressed=True)``
    (61.14 GB when every rank held them whole); no note names a whole
    state."""
    from repro_torch.configs import get_config
    from repro_torch.configs.specs import abstract_train_state, input_specs
    from repro_torch.launch import dryrun
    from repro_torch.sharding import (batch_shardings, make_plan,
                                      train_state_shardings)

    rec = dryrun.run_cell("phi3-mini-3.8b", "train_4k", True, save=False,
                          overrides={"grad_compression": "int8_pod"},
                          tag="+gradcomp")
    assert rec["status"] == "ok"
    assert not tdist.is_initialized()
    cfg = get_config("phi3-mini-3.8b")
    mesh_shape = {"pod": 2, "data": 16, "model": 16}
    plan = make_plan(cfg, _Shape(mesh_shape))
    sh = train_state_shardings(cfg, plan)
    state = abstract_train_state(cfg)

    def held(tree, specs, dtype=None):
        return sum(_blocks(t if dtype is None else t.to(dtype), sp,
                           mesh_shape)
                   for t, sp in zip(_tree_leaves(tree), _tree_leaves(specs)))

    inputs = input_specs(cfg, "train_4k")
    parts = rec["memory"]["argument_parts"]
    assert parts == {
        "params": held(state["params"], sh["params"]),
        "opt": held(state["opt"], sh["opt"]),
        "err": held(state["params"], sh["params"], torch.float32),
        "batch": held(inputs, batch_shardings(cfg, plan, inputs))}
    assert rec["memory"]["argument_bytes"] == \
        rec["memory"]["jax_argument_bytes"] < 0.3e9
    assert not any("whole" in n for n in rec["port_notes"])


def test_tensor_parallel_train_record_computes_on_the_blocks():
    """gemma-2b's train_4k step on 16x16 (its blocks, the sequence-parallel
    stream, the vocab-parallel loss): every all-gather over model is the
    stream's sequence ((16, 4096, 2048) bf16: the data rank's batch),
    none a parameter leaf; its temp bytes are under 20 GiB (86.18 GiB when
    every rank gathered each layer whole; XLA's 3.57 GiB)."""
    from repro_torch.launch import dryrun

    key = _key("gemma-2b", "train_4k", "16x16")
    rec = _rec(key)
    stream = 16 * 4096 * 2048 * 2
    model_gathers = [op for op in _OPS[key] if op.kind == "all-gather"
                     and "model" in op.axes]
    assert model_gathers and {op.result_bytes for op in model_gathers} == {
        stream}
    # the layers' FSDP gathers stay over data
    assert any(op.axes == ("data",) for op in _OPS[key])
    assert rec["memory"]["temp_bytes"] < 20 * 2**30
    assert dryrun.compare_to_reference(rec, json.loads(
        REFERENCE.read_text())["cells"][key]) == []


#: serving cells of dense configs, which serve on the rank's blocks: the
#: 32k-token prefill traces 1024 flash blocks a layer (~7 min), so a
#: 1024-token prefill of the same batch stands in for it in tier-1
TP_CELLS = [("gemma-2b", "decode_32k", None),
            ("phi3-mini-3.8b", "prefill_1k", 1024),
            pytest.param("phi3-mini-3.8b", "prefill_32k", None,
                         marks=pytest.mark.slow)]


@pytest.mark.parametrize("arch,shape_name,seq", TP_CELLS)
def test_tensor_parallel_serving_records_hold_the_blocks(arch, shape_name,
                                                         seq):
    """A dense config's serving record on 16x16: its argument bytes are
    the rank's blocks (the bf16 weights under ``params_only_shardings``,
    the batch under ``batch_shardings``, the token and the caches under
    ``decode_input_shardings``), computed here from the spec trees; its
    notes no longer say the weights are whole or the prefill unsharded."""
    from repro_torch.configs import get_config, shape_for
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.specs import abstract_params_tree, input_specs
    from repro_torch.launch import dryrun
    from repro_torch.sharding import (batch_shardings,
                                      decode_input_shardings, make_plan,
                                      params_only_shardings)

    cfg = get_config(arch)
    sh = (ShapeSpec(shape_name, seq, shape_for("prefill_32k").global_batch,
                    "prefill") if seq else shape_for(shape_name))
    mesh_shape = {"data": 16, "model": 16}
    plan = make_plan(cfg, _Shape(mesh_shape))
    inputs = input_specs(cfg, sh.name, shape=sh)
    want = sum(_blocks(t, sp, mesh_shape) for t, sp in zip(
        _tree_leaves(abstract_params_tree(cfg)),
        _tree_leaves(params_only_shardings(cfg, plan))))
    if sh.kind == "decode":
        dec = decode_input_shardings(cfg, plan, inputs)
        want += sum(_blocks(t, sp, mesh_shape) for t, sp in zip(
            _tree_leaves(inputs["caches"]), _tree_leaves(dec["caches"])))
        want += _blocks(inputs["token"], dec["token"], mesh_shape)
    else:
        want += sum(_blocks(t, sp, mesh_shape) for t, sp in zip(
            _tree_leaves(inputs), _tree_leaves(batch_shardings(
                cfg, plan, inputs))))
    tr = dryrun.dry_run(cfg, sh, (16, 16), ("data", "model"))
    assert tr["memory"]["argument_bytes"] == want
    notes = " ".join(tr["port_notes"])
    assert "weights whole" not in notes and "sharded prefill" not in notes
    assert "decode caches" not in notes
    if sh.kind == "decode":
        assert want < 0.5e9     # 9.84 GB with the weights whole
    assert not tdist.is_initialized()


@pytest.mark.parametrize("key", [k for k in CELLS if "train" in k])
def test_collectives_have_exact_axes(key):
    rec = _rec(key)
    mesh = key.split("__")[2]
    names = ("pod", "data", "model")[-len(mesh.split("x")):]
    # the record lists the first 200, as the JAX dry run's does
    assert len(rec["collectives"]) == min(rec["roofline"]["n_collectives"],
                                          200) > 0
    for op in rec["collectives"]:
        assert op["axes"] and set(op["axes"]) <= set(names), op
        assert op["kind"] in ("all-reduce", "all-gather", "reduce-scatter",
                              "all-to-all", "collective-permute")
    assert sum(rec["collective_bytes"].values()) > 0


@pytest.fixture(scope="module")
def gloo():
    """The gloo cells run for real on four CPU ranks (every rank's
    record), and the same cells traced on meta in a fake group of four."""
    from repro_torch.core.analysis.distributed import launch_mesh
    from repro_torch.launch import dryrun

    ranks = launch_mesh(dryrun.rank_collectives, (2, 2), GLOO_CELLS,
                        device="cpu", axes=("data", "model"))
    meta = []
    for cell in GLOO_CELLS:
        cfg, shape, extra = dryrun.small_cell(cell)
        meta.append(dryrun.dry_run(cfg, shape, (2, 2), ("data", "model"),
                                   extra=extra))
    return ranks, meta


@pytest.mark.parametrize("i", range(len(GLOO_CELLS)))
def test_recorded_collectives_sum_to_the_counters_of_a_real_step(gloo, i):
    ranks, meta = gloo
    assert len(ranks) == 4
    for r in ranks:
        got = r[i]
        assert got["counters"] == got["recorded"]
        assert sum(got["counters"].values()) > 0
    # rank 0 of the meta trace predicts rank 0's real step exactly
    real = ranks[0][i]
    assert meta[i]["collective_bytes"] == real["counters"]
    assert [op.to_dict() for op in meta[i]["ops"]] == real["ops"]
    assert meta[i]["memory"]["argument_bytes"] == \
        real["memory"]["argument_bytes"]
    assert not tdist.is_initialized()


def test_live_bytes_counts_a_toy_step_by_hand():
    from repro_torch.launch.dryrun import LiveBytes

    for dev in ("meta", "cpu"):
        x = torch.empty(1000, device=dev)     # an argument: never counted
        with LiveBytes() as live:
            y = x * 2                         # +4000 -> 4000
            z = y + 1                         # +4000 -> 8000
            del y                             # -4000 -> 4000
            w = z.view(10, 100)               # a view: +0
            z.add_(1)                         # in place: +0
            u = torch.cat([w.flatten(), z])   # +8000 -> 12000 (the peak)
            del u                             # -8000 -> 4000
            v = x[:10].clone()                # +40 -> 4040
        assert (live.peak, live.live) == (12000, 4040), dev
        del v, w, z


def test_fake_group_is_torn_down_after_a_cell_and_after_a_failure():
    from repro_torch.launch import dryrun, mesh

    assert not tdist.is_initialized()
    rec = dryrun.run_cell("whisper-tiny", "decode_32k", True, save=False)
    assert rec["status"] == "ok"
    assert not tdist.is_initialized()
    assert not mesh._MESH_GROUPS
    with pytest.raises(RuntimeError, match="inside"):
        with dryrun.fake_group(256):
            mesh.make_production_mesh(device="meta")
            assert mesh._MESH_GROUPS
            raise RuntimeError("inside")
    assert not tdist.is_initialized()
    assert not mesh._MESH_GROUPS


def test_cli_writes_its_records_only_under_its_own_folder(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    from repro_torch.launch import dryrun

    assert dryrun.OUT_DIR == ROOT / "experiments" / "dryrun" / "torch"
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path / "torch")
    assert dryrun.main(["--arch", "whisper-tiny", "--shape",
                        "long_500k"]) == 0
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                        "--mesh", "single"]) == 0
    out = capsys.readouterr().out
    assert out.count("SKIP") == 2 and out.count("OK   gemma-2b") == 1
    names = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert names == ["gemma-2b__decode_32k__16x16.json",
                     "whisper-tiny__long_500k__16x16.json",
                     "whisper-tiny__long_500k__2x16x16.json"]
    rec = json.loads((tmp_path / "torch" / names[0]).read_text())
    assert rec["status"] == "ok" and "trace_s" in rec


def _jax_experiments():
    """The JAX registry, read from its source: ``repro.launch.hillclimb``
    sets ``XLA_FLAGS`` (512 host devices) when imported, which would leak
    into every later JAX test of this worker."""
    import ast

    src = ROOT / "src" / "repro" / "launch" / "hillclimb.py"
    node, = [n for n in ast.parse(src.read_text()).body
             if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", None) == "EXPERIMENTS"]
    return ast.literal_eval(node.value)


def test_hillclimb_registry_equals_the_jax_one(capsys, tmp_path,
                                               monkeypatch):
    from repro_torch.launch import dryrun
    from repro_torch.launch import hillclimb as H

    assert H.EXPERIMENTS == _jax_experiments()
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    H.main(["--exp", "int8kv"])
    out = capsys.readouterr().out
    assert out.startswith("=== hillclimb int8kv: qwen1.5-32b decode_32k "
                          "16x16 {'kv_cache_dtype': 'int8'} ===")
    # qwen's 40 kv heads do not divide model=16: the decode gathers each
    # layer's replicated attention weights over data (FSDP) every step,
    # ~16 GB of wire, which dominates the HBM term (XLA's program keeps the
    # weights in place: memory-bound, 0.27 GB of wire)
    assert " dom=collective wire=" in out
    assert [p.name for p in tmp_path.iterdir()] == [
        "qwen1.5-32b__decode_32k__16x16+int8kv.json"]

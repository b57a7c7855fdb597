"""Serving under a sharding plan: the port's prefill and decode steps on
each rank's blocks of the weights and caches, on four gloo CPU ranks,
against the JAX package's steps jitted with the dry run's shardings on four
fake CPU devices (``experiments/sharding/reference.json``'s ``tp/...``
arrays, from ``experiments/sharding/make_reference.py``) and against the
port's own unsharded steps on the whole weights.

One module fixture spawns the four ranks once (``launch_mesh(
sharding.mesh_cases.run, 4, ("tp",))``); beside them one JAX subprocess
(``make_reference.py --npz PATH tp``) recomputes the file's ``tp`` part.
Each case of ``mesh_cases.TP_CASES`` (``.reduced()``, two layers, float32)
prefills an 8-token prompt of a batch of 2, pads the caches to a 16-slot
window (in float32) and takes 8 teacher-forced decode steps, once from its
own prefill blocks and once from the reference's prefill caches (where
the JAX decode starts: two programs' bf16 prefill caches may round an
entry apart, and a decode carries that as far as 1.6e-4 in the logits on
the card; the unsharded port's decode continues from the blocks' own
caches gathered whole):

* MHA (phi3, 4 kv heads) on (data, model) = (1, 4) and (2, 2) (FSDP over
  data); GQA with qkv bias (qwen) on (2, 2); MQA (gemma: one kv head, the
  heads replicated, the cache's sequence over model) under both
  ``decode_attention`` forms on (1, 4); MoE (granite, experts over model,
  capacity factor 8) on (2, 2).

Tolerances (phase 16a's decode rule, ``tests/test_torch_sharding_mesh.py``):
logits atol 5e-5 (prefill and every step); the decode window's caches
(float32) atol 5e-5; the prefill's caches are bf16, so within 5e-5 plus
one bf16 rounding of the larger entry (a float32 gap of ~1e-7 moves a
rounding by a step; the two packages' programs round 1-6 of 2048-4096
entries a leaf apart). XLA's own sharded and unsharded programs lie up to
2.1e-5 apart in these logits.

Each rank's storage is its blocks: the model's parameters are the bytes of
its ``params_only_shardings`` blocks, its caches those of its
``decode_input_shardings`` blocks (computed here from the spec trees). One
decode step's collectives are counted by kind and axes
(``record_collectives``): over ``model``, the embedding's reduce, one reduce
after attention (heads over model) and one after the MLP a layer, and the
logits' ``all_gather``; the MoE's two ``all_to_all`` instead of the MLP's
reduce; over ``data``, the per-layer FSDP gathers.
"""
import base64
import collections
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.analysis import distributed as D
from repro_torch.sharding import mesh_cases as MC

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "experiments" / "sharding" / "make_reference.py"
REFERENCE = ROOT / "experiments" / "sharding" / "reference.json"
TIMEOUT = 400
ATOL = 5e-5
CASES = list(MC.TP_CASES)


@pytest.fixture(scope="module")
def jax_live(tmp_path_factory):
    """The JAX subprocess, started at once and read on first use."""
    out = tmp_path_factory.mktemp("jax_tp") / "tp.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, str(SCRIPT), "--npz", str(out),
                             "tp"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    got = {}

    def read():
        if not got:
            _, err = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, err[-4000:]
            got.update(np.load(out))
        return got

    yield read
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _decode(rec):
    return np.frombuffer(base64.b64decode(rec["b64"]),
                         dtype=rec["dtype"]).reshape(rec["shape"])


@pytest.fixture(scope="module")
def ref():
    mesh = json.loads(REFERENCE.read_text())["mesh"]
    return {k: _decode(v) for k, v in mesh.items()
            if k.startswith(("tp/", "tp_plain/"))}


@pytest.fixture(scope="module")
def port(jax_live, ref):
    torch.set_num_threads(1)
    out, _walls = D.launch_mesh(MC.run, 4, ("tp",), MC.tp_start_caches(ref),
                                device="cpu", timeout_s=TIMEOUT)
    return out


def _held(got, want, what):
    """Logits and the float32 decode window within ATOL; the bf16 prefill
    caches within ATOL plus one bf16 rounding of the larger entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = np.full(want.shape, ATOL)
    if "/prefill/l" in what:
        big = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
        lim = lim + np.spacing(big).astype(np.float64) * 2.0 ** 16
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= lim).all(), (
        f"{what}: off by {err.max():.3g} (limit "
        f"{lim.reshape(-1)[np.argmax(err - lim)]:.3g})")


def _keys(arrays, case, part=""):
    return sorted(k[len(f"tp/{case}"):] for k in arrays
                  if k.startswith(f"tp/{case}/{part}"))


@pytest.mark.parametrize("case", CASES)
def test_tp_steps_match_the_jax_sharded_steps(port, ref, case):
    """The prefill, and the decode from the reference's prefill caches
    (where the JAX decode starts)."""
    keys = _keys(ref, case)
    # prefill logits and caches, each step's logits, the decode window
    assert len(keys) == 1 + 2 + MC.TP["steps"] + 2
    assert keys == [k for k in _keys(port, case)
                    if not k.startswith("/continued/")]
    for k in keys:
        _held(port[f"tp/{case}{k}"], ref[f"tp/{case}{k}"], f"{case}{k}")


@pytest.mark.parametrize("case", CASES)
def test_tp_steps_match_the_unsharded_port(port, case):
    """The prefill, the decode from the reference's prefill caches, and
    the decode continued from the blocks' own prefill caches (the whole
    model's from the same caches gathered whole)."""
    keys = _keys(port, case)
    assert len(_keys(port, case, "continued/")) == MC.TP["steps"] + 2
    for k in keys:
        _held(port[f"tp/{case}{k}"], port[f"tp_plain/{case}{k}"],
              f"{case}{k} (unsharded port)")


def test_reference_tp_part_is_the_jax_packages(ref, jax_live):
    """The file's ``tp`` and ``tp_plain`` arrays are what the JAX package
    computes now, bit for bit."""
    live = {k: v for k, v in jax_live().items()
            if k.startswith(("tp/", "tp_plain/"))}
    assert sorted(live) == sorted(ref)
    for k, v in live.items():
        assert np.array_equal(np.asarray(v, np.float32), ref[k]), k


class _Shape:
    def __init__(self, shape):
        self.shape = shape


def _plan(case):
    from repro_torch.sharding import make_plan

    shape = MC.TP_CASES[case][1]
    return make_plan(MC.tp_config(case),
                     _Shape(dict(zip(("data", "model"), shape))))


def _block_bytes(tree, specs, plan):
    from repro_torch.models.common import sorted_leaves

    spec_of = dict(sorted_leaves(specs))
    total = 0
    for path, t in sorted_leaves(tree):
        n = math.prod(t.shape) * t.element_size()
        for e in spec_of[path]:
            if e is not None:
                n //= plan.axis_size(e)
        total += n
    return total


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_only_its_blocks(port, case):
    from repro_torch.configs.specs import abstract_params_tree
    from repro_torch.models import transformer
    from repro_torch.models.common import sorted_leaves
    from repro_torch.sharding import (decode_input_shardings,
                                      params_only_shardings)

    cfg, plan = MC.tp_config(case), _plan(case)
    params = _block_bytes(abstract_params_tree(cfg),
                          params_only_shardings(cfg, plan), plan)
    caches = transformer.init_decode_caches(
        cfg, MC.TP["batch"], MC.TP["max_len"], dtype=torch.float32,
        device="meta")
    cache_bytes = _block_bytes(caches, decode_input_shardings(
        cfg, plan, {"caches": caches})["caches"], plan)
    whole = sum(math.prod(t.shape) * t.element_size()
                for _, t in sorted_leaves(abstract_params_tree(cfg)))
    ranks = sorted({k.split("/")[2] for k in port
                    if k.startswith(f"tp_bytes/{case}/")})
    assert len(ranks) == 4
    for c in ranks:
        assert int(port[f"tp_bytes/{case}/{c}/params"]) == params < whole
        assert int(port[f"tp_bytes/{case}/{c}/caches"]) == cache_bytes


def _expected_ops(case):
    """{(HLO kind, axes): count} of one decode step on a rank."""
    from repro_torch.models.common import sorted_leaves
    from repro_torch.sharding import params_only_shardings

    cfg, plan = MC.tp_config(case), _plan(case)
    n_layers = cfg.n_layers
    specs = dict(sorted_leaves(params_only_shardings(cfg, plan)))
    # the FSDP gathers: each leaf with a block along data, once a step
    # (a stacked leaf once a layer)
    fsdp = sum(("data" in s) * (n_layers if p.startswith("layers/") else 1)
               for p, s in specs.items())
    want = collections.Counter({("all-reduce", "model"): 1,    # embedding
                                ("all-gather", "model"): 1})   # logits
    if fsdp:
        want[("all-gather", "data")] = fsdp
    if case.startswith("mqa_gathered"):
        # the softmax's max and sum and the weights-times-values partial
        # over the cache's sequence; the MLP's reduce
        want[("all-reduce", "model")] += 4 * n_layers
    elif case.startswith("mqa_sharded"):
        # the flash-decode's max and its merged (l, acc); the MLP's reduce
        want[("all-reduce", "model")] += 3 * n_layers
    elif case.startswith("moe"):
        # attention's reduce; the router gathered whole; the expert
        # exchange there and back; the FSDP-local expert FFN's two sums
        # and its gathers of the tokens and the output over data
        want[("all-reduce", "model")] += n_layers
        want[("all-gather", "model")] += n_layers
        want[("all-to-all", "model")] += 2 * n_layers
        want[("all-reduce", "data")] += 2 * n_layers
        want[("all-gather", "data")] += 2 * n_layers
    else:
        want[("all-reduce", "model")] += 2 * n_layers
    return want


@pytest.mark.parametrize("case", CASES)
def test_a_decode_step_issues_the_plans_collectives(port, case):
    want = _expected_ops(case)
    for k in (k for k in port if k.startswith(f"tp_ops/{case}/")):
        got = collections.Counter(tuple(str(op).split(" ")) for op in port[k])
        assert got == want, (k, got, want)

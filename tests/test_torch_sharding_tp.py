"""Serving and training under a sharding plan: the port's prefill and
decode steps on each rank's blocks of the weights and caches, and its
train step on each rank's blocks of the state, on four gloo CPU ranks,
against the JAX package's steps jitted with the dry run's shardings on four
fake CPU devices (``experiments/sharding/reference.json``'s ``tp/...``
arrays, from ``experiments/sharding/make_reference.py``) and against the
port's own unsharded steps on the whole weights.

One module fixture spawns the four ranks once (``launch_mesh(
sharding.mesh_cases.run, 4, ("tp", "tp_train", "ssd"))``); beside them two
JAX subprocesses (``make_reference.py --npz PATH tp`` and ``...
tp_train``) recompute the file's ``tp`` and ``tp_train`` parts.
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
  capacity factor 8) on (2, 2);
* SSM (mamba2: 16 heads, 4 a rank, the state its heads, the conv tail
  whole) on (1, 4) and (2, 2); the hybrid (jamba's whole 8-layer period:
  SSM heads, kv heads and experts over model on (2, 2), its 2 kv heads
  replicated and the cache's sequence sharded on (1, 4)); the prefix
  (paligemma, MQA, 8 seeded prefix embeddings before the prompt, the
  decode from the slot after them) on (1, 4);
* the encoder-decoder (whisper over 64 seeded frames: its heads
  replicated, the self and cross caches' sequence over model on (1, 4);
  the heads and both caches' kv heads over model, FSDP over data, on
  (2, 2)); the decode starts from the reference's prefill ``self`` and
  ``cross`` caches.

Tolerances (phase 16a's decode rule, ``tests/test_torch_sharding_mesh.py``):
logits atol 5e-5 (prefill and every step); the decode window's caches
(float32) atol 5e-5; the prefill's caches (an encoder-decoder's cross
caches too) are bf16, so within 5e-5 plus
one bf16 rounding of the larger entry (a float32 gap of ~1e-7 moves a
rounding by a step; the two packages' programs round 1-6 of 2048-4096
entries a leaf apart). XLA's own sharded and unsharded programs lie up to
2.1e-5 apart in these logits.

The SSD alone (``mesh_cases.SSD``: ``ssm.ssd_forward`` and four
``ssd_decode`` steps on (1, 4)) matches the whole-weight SSD on the same
inputs within 1e-5 of the largest |entry| (the output, the state as the
rank's heads block, the conv tail whole, the gradient of every leaf as the
rank's block); the gated RMSNorm's statistic, the rank's sum of squares
summed over the ranks, is the whole mean within 8 float32 roundings.

Each rank's storage is its blocks: the model's parameters are the bytes of
its ``params_only_shardings`` blocks, its caches those of its
``decode_input_shardings`` blocks (computed here from the spec trees). One
decode step's collectives are counted by kind and axes
(``record_collectives``): over ``model``, the embedding's reduce, one reduce
after attention (heads over model) and one after the MLP a layer, and the
logits' ``all_gather``; the MoE's two ``all_to_all`` instead of the MLP's
reduce; an encoder-decoder's decoder layer adds its cross-attention (its
reduce, or over a sequence-sharded cross cache the softmax's maximum and
one sum of the row sums and the partials) and runs no encoder; over
``data``, the per-layer FSDP gathers of the leaves the step reads.

Training (``mesh_cases.TP_TRAIN``: the cases but mqa_sharded_1x4, through
the ``train/...`` recipe, float32, a batch of 4 x 32): the first step's
loss, nll and every gradient leaf, and two steps' metrics and params,
against the JAX sharded step at ``test_sharded_train_steps_match_jax``'s
tolerances (``tests/test_torch_sharding_mesh.py``); the gradients against
the port's form that gathers every leaf whole, on the same blocks (1e-5 x
the leaf's largest |g|; the two lie ~1e-6 apart: float32 sums in another
order); a step's collectives with the remat off: over ``model`` exactly
the sequence-parallel seams (the embedding's sum reduce-scattered onto the
sequence block, a ``seq_gather`` into attention and the MLP, a
``psum_scatter`` after each where its weights are blocks, the MoE's
router gathered whole as the JAX ``shard_map`` takes it, one gather of
the sequence before the loss) and their adjoints, so no other parameter
leaf is gathered over ``model``; the tensors autograd keeps between the
layers are the rank's block of the sequence (the whole stream is kept
only as the loss chunk's input; an encoder-decoder's encoder stream is
its block of the frames, its output kept whole only as each decoder
layer's memory); ``build_trainer``'s leaf-by-leaf state is the rank's
blocks of the whole draw, bit for bit (it refuses the prefix and
encoder-decoder configs); and the
vocab-parallel cross-entropy equals the whole vocabulary's (padded rows,
a softcap, labels on every rank's block and -1) within 2e-6 relative.
Where a rule does not divide model (a 30-position sequence, a 510-row
vocabulary, ``mesh_cases.TP_FALLBACK``) the stream or the vocabulary
stays whole and the gradients are still the gather-whole form's; the
heads' fallback is the MQA case.
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
    """The JAX subprocesses, one a part, started at once and read on first
    use."""
    tmp = tmp_path_factory.mktemp("jax_tp")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for part in ("tp", "tp_train"):
        out = tmp / f"{part}.npz"
        procs[out] = subprocess.Popen(
            [sys.executable, str(SCRIPT), "--npz", str(out), part], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    got = {}

    def read():
        if not got:
            for out, proc in procs.items():
                _, err = proc.communicate(timeout=TIMEOUT)
                assert proc.returncode == 0, err[-4000:]
                got.update(np.load(out))
        return got

    yield read
    for proc in procs.values():
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
    out, _walls = D.launch_mesh(MC.run, 4, ("tp", "tp_train", "ssd"),
                                MC.tp_start_caches(ref), device="cpu",
                                timeout_s=TIMEOUT)
    return out


def _held(got, want, what):
    """Logits and the float32 decode window within ATOL; the bf16 prefill
    caches within ATOL plus one bf16 rounding of the larger entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = np.full(want.shape, ATOL)
    if any(f"/prefill/{c}" in what for c in ("l", "self/", "cross/")):
        big = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
        lim = lim + np.spacing(big).astype(np.float64) * 2.0 ** 16
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= lim).all(), (
        f"{what}: off by {err.max():.3g} (limit "
        f"{lim.reshape(-1)[np.argmax(err - lim)]:.3g})")


def _n_cache_leaves(case):
    from repro_torch.models.common import sorted_leaves

    return len(list(sorted_leaves(MC.decode_caches(
        MC.tp_config(case), 1, 1, device="meta"))))


def _keys(arrays, case, part=""):
    return sorted(k[len(f"tp/{case}"):] for k in arrays
                  if k.startswith(f"tp/{case}/{part}"))


@pytest.mark.parametrize("case", CASES)
def test_tp_steps_match_the_jax_sharded_steps(port, ref, case):
    """The prefill, and the decode from the reference's prefill caches
    (where the JAX decode starts)."""
    keys = _keys(ref, case)
    # prefill logits and caches, each step's logits, the decode window
    n = _n_cache_leaves(case)
    assert len(keys) == 1 + n + MC.TP["steps"] + n
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
    assert len(_keys(port, case, "continued/")) == (MC.TP["steps"]
                                                    + _n_cache_leaves(case))
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
    from repro_torch.models.common import sorted_leaves
    from repro_torch.sharding import (decode_input_shardings,
                                      params_only_shardings)

    cfg, plan = MC.tp_config(case), _plan(case)
    params = _block_bytes(abstract_params_tree(cfg),
                          params_only_shardings(cfg, plan), plan)
    caches = MC.decode_caches(
        cfg, MC.TP["batch"], cfg.n_prefix_tokens + MC.TP["max_len"],
        dtype=torch.float32, device="meta")
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
    specs = dict(sorted_leaves(params_only_shardings(cfg, plan)))
    (pattern, repeats), = cfg.layer_groups()
    want = collections.Counter({("all-reduce", "model"): 1,    # embedding
                                ("all-gather", "model"): 1})   # logits
    if cfg.is_encdec:
        return want + _encdec_ops(cfg, plan, specs)
    # the FSDP gathers: each leaf with a block along data, once a step
    # (a stacked leaf once a layer)
    fsdp = sum(("data" in s) * (repeats if p.startswith("layers/") else 1)
               for p, s in specs.items())
    if fsdp:
        want[("all-gather", "data")] = fsdp
    if case.startswith(("ssm", "hybrid", "prefix")):
        return want + _layer_ops(cfg, plan, pattern, repeats)
    n_layers = cfg.n_layers
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


def _encdec_ops(cfg, plan, specs):
    """{(HLO kind, axes): count} of an encoder-decoder's decode step but
    the embedding's and the logits': per decoder layer, self-attention's
    reduce where its heads are blocks, else the gathered decode's maximum,
    sum and weights-times-values partial over the cache's sequence; the
    cross-attention's reduce, else the maximum and one sum of the row sums
    and the partials over the cross cache's sequence; the MLP's reduce.
    The FSDP gathers over data of the leaves the step reads: the
    embedding and the final norm once, each decoder layer's but the
    cross-attention's k and v projections (its cross caches hold them),
    no encoder's."""
    heads = plan.rules["heads"] is not None
    per_layer = (1 if heads else 3) + (1 if heads else 2) + 1
    want = collections.Counter({("all-reduce", "model"):
                                cfg.n_layers * per_layer})
    read = [p for p in specs if p in ("embed", "final_norm/w", "final_norm/b")
            or p.startswith("dec_layers/") and p not in (
                "dec_layers/xattn/wk", "dec_layers/xattn/wv")]
    fsdp = sum(("data" in specs[p]) * (cfg.n_layers if p.startswith(
        "dec_layers/") else 1) for p in read)
    if fsdp:
        want[("all-gather", "data")] = fsdp
    return want


def _layer_ops(cfg, plan, pattern, repeats):
    """{(HLO kind, axes): count} of the layers of one decode step, by
    kind: an SSM layer's gather of the new token's ``x`` columns (the conv
    tail whole), its gated RMSNorm's statistic and ``wo``'s partial sum;
    attention's reduce where its heads are blocks, else the gathered
    decode's maximum, sum and weights-times-values partial over the
    cache's sequence; the MLP's reduce; the MoE's router gathered whole
    and its expert exchange there and back (and, with FSDP over data, the
    expert FFN's two sums and its gathers of the tokens and the output
    over data)."""
    want = collections.Counter()
    for mixer, ffn in pattern:
        if mixer == "ssm":
            want[("all-gather", "model")] += repeats
            want[("all-reduce", "model")] += 2 * repeats
        elif plan.rules["heads"] is not None:
            want[("all-reduce", "model")] += repeats
        else:
            want[("all-reduce", "model")] += 3 * repeats
        if ffn == "mlp":
            want[("all-reduce", "model")] += repeats
        elif ffn == "moe":
            want[("all-gather", "model")] += repeats
            want[("all-to-all", "model")] += 2 * repeats
            if plan.mesh.shape["data"] > 1:
                want[("all-reduce", "data")] += 2 * repeats
                want[("all-gather", "data")] += 2 * repeats
    return want


@pytest.mark.parametrize("case", CASES)
def test_a_decode_step_issues_the_plans_collectives(port, case):
    want = _expected_ops(case)
    for k in (k for k in port if k.startswith(f"tp_ops/{case}/")):
        got = collections.Counter(tuple(str(op).split(" ")) for op in port[k])
        assert got == want, (k, got, want)


# -- training on the rank's blocks ---------------------------------------------

TRAIN_CASES = list(MC.TP_TRAIN)
LR = 3e-4


def _paths(arrays, prefix):
    return sorted(k[len(prefix):] for k in arrays if k.startswith(prefix))


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_tp_train_step_matches_the_jax_sharded_step(port, jax_live, case):
    ref = jax_live()
    k = f"tp_train/{case}"
    np.testing.assert_allclose(port[f"{k}/loss"], ref[f"{k}/loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(port[f"{k}/nll"], ref[f"{k}/nll"], rtol=1e-5)
    paths = _paths(ref, f"{k}/grad/")
    assert paths == _paths(port, f"{k}/grad/") and len(paths) > 5
    for p in paths:
        want, got = ref[f"{k}/grad/{p}"], port[f"{k}/grad/{p}"]
        assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max(), p


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_tp_train_steps_metrics_and_params_match_jax(port, jax_live, case):
    ref = jax_live()
    k = f"tp_train/{case}"
    for t in range(MC.STEPS):
        for m in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(port[f"{k}/{t}/{m}"],
                                       ref[f"{k}/{t}/{m}"], rtol=1e-4,
                                       err_msg=f"{t} {m}")
    paths = _paths(ref, f"{k}/params/")
    assert paths == _paths(port, f"{k}/params/")
    for p in paths:
        np.testing.assert_allclose(port[f"{k}/params/{p}"],
                                   ref[f"{k}/params/{p}"], rtol=0.0,
                                   atol=2 * LR * MC.STEPS + 1e-6, err_msg=p)


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_tp_train_gradients_match_the_gather_whole_form(port, case):
    k, w = f"tp_train/{case}", f"tp_train_whole/{case}"
    np.testing.assert_allclose(port[f"{k}/loss"], port[f"{w}/loss"],
                               rtol=1e-6)
    paths = _paths(port, f"{w}/grad/")
    assert paths == _paths(port, f"{k}/grad/")
    for p in paths:
        want, got = port[f"{w}/grad/{p}"], port[f"{k}/grad/{p}"]
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), p


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_tp_train_step_gathers_no_parameter_over_model(port, case):
    lists = [port[k] for k in port if k.startswith(f"tp_train_ops/{case}/")]
    assert len(lists) == 4
    # the embedding's reduce onto the sequence block, each layer's gathers
    # of the sequence and reduces after its model blocks (an MoE router
    # gathered whole), the gather before the loss; each one's adjoint
    want = MC.seq_seams(case)
    # 2 (the embedding's and the loss's) + per layer: attention or the SSD
    # 2 (1 where the heads are replicated), the MLP 2, the MoE 1; a prefix
    # puts the embedding's sum before the cut (an all-reduce)
    assert want == {
        "mha_1x4": 2 + 2 * 4, "mha_2x2": 2 + 2 * 4, "gqa_bias_2x2": 2 + 2 * 4,
        "mqa_gathered_1x4": 2 + 2 * 3, "moe_2x2": 2 + 2 * 3,
        "ssm_1x4": 2 + 2 * 2, "ssm_2x2": 2 + 2 * 2,
        "hybrid_2x2": 2 + 4 * (2 + 2) + 4 * (2 + 1),
        "hybrid_1x4": 2 + 3 * (2 + 2) + (1 + 2) + 4 * (2 + 1),
        "prefix_1x4": 1 + 2 * 3,
        # the embedding's and the loss's; the encoder's 2 layers: attention
        # 1 (2 with its heads over model), the MLP 2; the encoder's output
        # gathered once; the decoder's 2 layers: self- and cross-attention
        # 1 each (2), the MLP 2
        "encdec_1x4": 2 + 2 * 3 + 1 + 2 * 4,
        "encdec_2x2": 2 + 2 * 4 + 1 + 2 * 6}[case]
    for ops in lists:
        assert list(ops) == list(lists[0])    # every rank, the same order
        got = collections.Counter(str(op) for op in ops)
        assert got["all-gather model"] == want, got
        assert got["reduce-scatter model"] == want, got
        # the FSDP gathers of the layers' leaves stay over data
        if _plan(case).mesh.shape["data"] > 1:
            assert got["all-gather data"] > 0


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_tp_train_carry_is_the_sequence_block(port, case):
    cfg = MC.tp_config(case)
    shape = dict(zip(("data", "model"), MC.TP_CASES[case][1]))
    b = MC.DATA["batch"] // shape["data"]
    s, d = MC.DATA["seq"], cfg.d_model
    whole, block = f"{b}x{s}x{d}", f"{b}x{s // shape['model']}x{d}"
    for k in (k for k in port if k.startswith(f"tp_train_saved/{case}/")):
        saved = [str(x) for x in port[k]]
        once = 1
        if cfg.is_encdec:
            enc = f"{b}x{cfg.enc_seq // shape['model']}x{d}"
            # the encoder's stream: each layer's input the rank's block of
            # the frames; its output whole only as each decoder layer's
            # memory
            assert saved.count(enc) >= cfg.n_enc_layers, (k, saved)
            assert saved.count(f"{b}x{cfg.enc_seq}x{d}") == cfg.n_layers
            if enc == whole:
                # (2, 2): the encoder's block of the 64 frames has the
                # decoder stream's whole shape; each stream of two layers
                # keeps its block as often
                once += saved.count(block)
        # one loss chunk (its input, the gathered sequence) ...
        assert saved.count(whole) == once, (k, saved.count(whole))
        # ... and each layer's input: the rank's block of the sequence
        assert saved.count(block) >= cfg.n_layers, (k, saved)


@pytest.mark.parametrize("case", [c for c in TRAIN_CASES
                                  if not (MC.tp_config(c).n_prefix_tokens
                                          or MC.tp_config(c).is_encdec)])
def test_build_trainer_draws_each_rank_its_blocks(port, case):
    got = {k: bool(v) for k, v in port.items()
           if k.startswith(f"tp_train_init/{case}/")}
    assert len(got) == 4 and all(got.values()), got


@pytest.mark.parametrize("form", ["tied", "untied"])
def test_vocab_parallel_cross_entropy_is_the_whole_vocabularys(port, form):
    k = f"tp_xent/{form}"
    assert float(port[f"{k}/vp/count"]) == float(port[f"{k}/whole/count"])
    np.testing.assert_allclose(port[f"{k}/vp/loss"], port[f"{k}/whole/loss"],
                               rtol=2e-6)
    for g in ("grad_h", "grad_w"):
        want, got = port[f"{k}/whole/{g}"], port[f"{k}/vp/{g}"]
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max(), g


@pytest.mark.parametrize("case", sorted(MC.TP_FALLBACK))
def test_tp_train_falls_back_where_a_rule_does_not_divide(port, case):
    """A sequence that does not divide model keeps the stream whole (no
    gather or reduce-scatter over model: the layers' partial sums are
    all-reduced); a vocabulary that does not divide it keeps the
    embedding and the logits whole (the stream's seams only); either way
    the gradients are the gather-whole form's on the same blocks."""
    k = f"tp_fallback/{case}"
    np.testing.assert_allclose(port[f"{k}/tp/loss"], port[f"{k}/whole/loss"],
                               rtol=1e-6)
    paths = _paths(port, f"{k}/whole/grad/")
    assert paths == _paths(port, f"{k}/tp/grad/") and len(paths) > 5
    for p in paths:
        want, got = port[f"{k}/whole/grad/{p}"], port[f"{k}/tp/grad/{p}"]
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), p
    lists = [port[x] for x in port if x.startswith(f"tp_fallback_ops/{case}/")]
    assert len(lists) == 4
    got = collections.Counter(str(op) for op in lists[0])
    if case == "seq_30":
        assert got["all-gather model"] == got["reduce-scatter model"] == 0
        assert got["all-reduce model"] > 0
    else:
        # gemma's one kv head: per layer the sequence gathered into
        # attention and the MLP, the MLP's output reduce-scattered; the
        # gather before the loss; no embedding reduce (its rows whole)
        n = 1 + 3 * 2
        assert got["all-gather model"] == got["reduce-scatter model"] == n


def test_reference_tp_train_part_is_the_jax_packages(jax_live):
    """The file's ``tp_train`` entries are what the JAX package computes
    now, encoded by the reference script's rule (whole arrays bit for bit,
    the larger ones' norm, entries and sketch)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("sharding_make_ref_tp",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mesh = json.loads(REFERENCE.read_text())["mesh"]
    want = {k: v for k, v in mesh.items() if k.startswith("tp_train/")}
    live = {k: v for k, v in jax_live().items()
            if k.startswith("tp_train/")}
    assert sorted(live) == sorted(want) and len(want) > 100
    for k, v in live.items():
        assert json.loads(json.dumps(mod.encode(k, v))) == want[k], k


# -- the SSD on the rank's blocks ----------------------------------------------

SSD_PARTS = (["forward/out", "forward/ssm", "forward/conv"]
             + [f"grad/{k}" for k in ("A_log", "D", "conv_b", "conv_w",
                                      "dt_bias", "norm_w", "wB", "wC",
                                      "wdt", "wo", "wx", "wz")]
             + [f"decode/{t}/{k}" for t in range(MC.SSD["decode"])
                for k in ("out", "ssm", "conv")])


@pytest.mark.parametrize("what", SSD_PARTS)
def test_ssd_on_blocks_matches_the_whole_weight_ssd(port, what):
    got = {k: port[k] for k in port if k.startswith(f"ssd/{what}/")}
    assert len(got) == 4, sorted(got)
    for k, (err, scale) in got.items():
        assert scale > 0 and err <= 1e-5 * scale, (k, err, scale)


def test_ssd_split_norm_statistic_is_the_whole_mean(port):
    got = {k: port[k] for k in port if k.startswith("ssd/norm/stat/")}
    assert len(got) == 4
    for k, (err, scale) in got.items():
        assert err <= 8 * np.finfo(np.float32).eps * scale, (k, err, scale)

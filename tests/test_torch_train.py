"""The port's train step vs the JAX package's, on the CPU.

The same float32 master (the serving reference's numpy weight rule,
``models.convert.numpy_params``) and ``SyntheticLM`` batches go through
``jax.value_and_grad`` of the JAX package's train loss (jitted) and the
port's, for gemma-2b, phi3-mini-3.8b and qwen1.5-32b cut to two layers, in
float32 and bfloat16 ``param_dtype``. Tolerances:

* float32: loss rtol 1e-5; each gradient leaf max |delta| within
  ``F32_GRAD_TOL`` (5e-4) x the leaf's largest |g|. A bound of 1e-4
  cannot be met: on these weights the JAX package's own float32 gradients
  are up to 1.38e-4 (gemma-2b), 1.17e-4 (phi3) and 1.97e-4 (qwen) x max
  |g| from a float64 evaluation of the same loss, the port's up to
  2.07e-4, 1.44e-4 and 2.19e-4 (``experiments/train/conditioning.py``;
  the attention scores are O(10^2)), and the JAX package jitted is up to
  6.2e-5 from itself run eagerly; two float32 implementations may differ
  by the sum, so twice the largest. Measured here: 1.16e-4, 1.04e-4,
  6.4e-5.
* bfloat16: the port's bfloat16 against the JAX package's bfloat16, as a
  fraction of the JAX package's own bfloat16-vs-float32 gap on the same
  weights and batch. Each gradient leaf's relative L2 distance
  ||g - g_jax|| / ||g_jax|| within ``BF16_GAP_FRACTION`` (0.5) of that
  leaf's gap ||g_jax - g_jax32|| / ||g_jax32||, and never past
  ``BF16_GRAD_RTOL`` (0.4); the loss within 0.5 of its gap. On these
  weights (attention scores of O(10^2)) the gap is large: 0.060-1.041
  relative L2 by leaf (gemma-2b), 0.042-1.345 (phi3), 0.066-1.516 (qwen),
  and 1.2e-3, 4.2e-4, 2.6e-3 on the loss. Measured, the port's bfloat16
  against the JAX package's: 0.007-0.147, 0.007-0.247 and 0.006-0.059
  relative L2 by leaf, at most 0.21 of the leaf's gap; the loss 3.4e-5,
  2.0e-5, 2.8e-4 (at most 0.105 of its gap). So a bfloat16 config run in
  float32 fails (it stands at the whole gap), as do a zero gradient
  (distance 1) and a negated one (2): ``test_bf16_check_rejects_wrong_
  gradients``. The relative L2 distance, not max |delta| over max |g|:
  single entries of these gradients move by up to 0.42 x max |g| between
  the packages' bfloat16 while the leaf as a whole stays within 0.25.
* remat none, full and dots: bit-equal on the CPU (the same operations).
* a 5-step ``SyntheticLM`` trajectory (float32): rtol 1e-4 on each loss
  at the default lr (3e-4); at lr 1e-3 (``tests/test_system.py``'s) rtol
  2e-3: there the JAX package's own jitted and eager trajectories part by
  8.8e-4 at step 5 (the port and the jitted one by 6.6e-4; at lr 3e-4,
  6.2e-7 and 8.5e-7): the updates move a param by +-lr where a gradient
  entry near zero flips sign, and these weights are chaotic
  (``experiments/train/conditioning.py``).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import steps as JS
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import convert, steps, transformer as T
from repro_torch.models.common import sorted_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    beside other workers (eight threads a worker made the file ~4x
    slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

REF_ARCHS = ("gemma-2b", "phi3-mini-3.8b", "qwen1.5-32b")
F32_GRAD_TOL = 5e-4
F32_LOSS_RTOL = 1e-5
BF16_GAP_FRACTION, BF16_GRAD_RTOL = 0.5, 0.4
TRAJ_RTOL = {3e-4: 1e-4, 1e-3: 2e-3}
DTYPES = ("float32", "bfloat16")


def _configs(arch, dtype, **kw):
    return (dataclasses.replace(jget_config(arch).reduced(n_layers=2, **kw),
                                param_dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(n_layers=2, **kw),
                                param_dtype=dtype))


def _batches(cfg, n, batch=2, seq=64, seed=3):
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                 global_batch=batch, seed=seed))
    return [src.batch_at(i) for i in range(n)]


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _rel(a, b):
    """||a - b|| / ||b|| in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_grads(cfg, tree, batch):
    fn = steps._value_and_grad(steps._forward_loss(cfg))
    (loss, nll), grads = fn(_torch_tree(tree),
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), float(nll), {p: g.numpy() for p, g in
                                     sorted_leaves(grads)}


@pytest.fixture(scope="module", params=REF_ARCHS)
def jax_case(request):
    """Weights, a batch, and the JAX package's (jitted once each) and the
    port's loss and gradients in both dtypes for one arch."""
    arch = request.param
    _, cfg = _configs(arch, "float32")
    tree = convert.numpy_params(cfg, 0)
    batch = _batches(cfg, 1)[0]
    out = {"arch": arch, "tree": tree, "batch": batch}
    for dtype in DTYPES:
        jcfg, _ = _configs(arch, dtype)
        fn = jax.jit(jax.value_and_grad(JS._forward_loss(jcfg), has_aux=True))
        (loss, nll), grads = fn(jax.tree.map(jnp.asarray, tree),
                                {k: jnp.asarray(v) for k, v in batch.items()})
        out[dtype] = (float(loss), float(nll), dict(sorted_leaves(
            jax.tree.map(lambda g: np.asarray(g, np.float32), grads))))
        out["port", dtype] = _port_grads(_configs(arch, dtype)[1], tree,
                                         batch)
    return out


def _bf16_misses(loss, grads, case):
    """Where the port's bfloat16 loss and gradients lie outside the stated
    tolerances against the JAX package's bfloat16 (empty when held)."""
    (jloss, _, jgrads), (loss32, _, g32) = case["bfloat16"], case["float32"]
    misses = []
    if abs(loss - jloss) > BF16_GAP_FRACTION * abs(jloss - loss32):
        misses.append(f"loss {loss} against {jloss} (float32 {loss32})")
    for p, g in grads.items():
        gap = _rel(jgrads[p], g32[p])
        tol = min(BF16_GAP_FRACTION * gap, BF16_GRAD_RTOL)
        rel = _rel(g, jgrads[p])
        if not (np.isfinite(g).all() and rel <= tol):
            misses.append(f"{p}: {rel:.3g} relative L2 > {tol:.3g} "
                          f"(the JAX package's own gap {gap:.3g})")
    return misses


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_grads_match_jax(jax_case, dtype):
    arch = jax_case["arch"]
    loss, nll, grads = jax_case["port", dtype]
    jloss, jnll, jgrads = jax_case[dtype]
    assert sorted(grads) == sorted(jgrads)
    assert nll == loss
    for p, g in grads.items():
        assert g.dtype == np.float32 and g.shape == jgrads[p].shape, p
    if dtype == "bfloat16":
        assert not _bf16_misses(loss, grads, jax_case), (
            arch, _bf16_misses(loss, grads, jax_case))
        return
    np.testing.assert_allclose(loss, jloss, rtol=F32_LOSS_RTOL)
    for p, g in grads.items():
        scale = np.abs(jgrads[p]).max()
        gap = np.abs(g - jgrads[p]).max()
        assert np.isfinite(g).all() and gap <= F32_GRAD_TOL * scale, (
            f"{arch} {p}: {gap / scale:.3g} x max|g| > {F32_GRAD_TOL}")


def test_bf16_check_rejects_wrong_gradients(jax_case):
    """The bfloat16 tolerances hold the port to bfloat16: the port's
    float32 loss and gradients given as bfloat16 miss on the loss and every
    leaf, and so do zero and negated bfloat16 gradients on every leaf."""
    loss16, _, g16 = jax_case["port", "bfloat16"]
    loss32, _, g32 = jax_case["port", "float32"]
    assert len(_bf16_misses(loss32, g32, jax_case)) == len(g32) + 1
    for wrong in (np.zeros_like, np.negative):
        got = {p: wrong(g) for p, g in g16.items()}
        assert len(_bf16_misses(loss16, got, jax_case)) == len(g16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_remat_does_not_change_a_number(arch, dtype):
    _, cfg = _configs(arch, dtype)
    tree = convert.numpy_params(cfg, 0)
    batch = _batches(cfg, 1)[0]
    ref = _port_grads(dataclasses.replace(cfg, remat="none"), tree, batch)
    for remat in ("full", "dots"):
        got = _port_grads(dataclasses.replace(cfg, remat=remat), tree, batch)
        assert got[0] == ref[0] and got[1] == ref[1], remat
        for p in ref[2]:
            assert np.array_equal(got[2][p], ref[2][p]), (remat, p)


def test_remat_dots_keeps_the_products(monkeypatch):
    """"dots" keeps the outputs of the products without batch dimensions
    (the projections, the MLP, each a ``mm`` or a ``bmm`` over a batch of
    one) and recomputes everything else, the attention's batched products
    included."""
    from torch.utils.checkpoint import CheckpointPolicy

    _, cfg = _configs("phi3-mini-3.8b", "float32", remat="dots")
    params = tree_map(lambda t: t.requires_grad_(),
                      _torch_tree(convert.numpy_params(cfg, 0)))
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    decisions = []
    policy = T._saves_dots

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((str(op), out))
        return out

    monkeypatch.setattr(T, "_saves_dots", counting)
    T.forward(params, batch["tokens"], cfg)
    saved = {op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE}
    recomputed = {op for op, d in decisions
                  if d == CheckpointPolicy.PREFER_RECOMPUTE}
    # q, k, v, o projections and three MLP products a layer
    assert sum(d == CheckpointPolicy.MUST_SAVE for _, d in decisions) == 7 * 2
    assert saved <= {"aten.mm.default", "aten.bmm.default"}
    assert "aten.bmm.default" in recomputed     # the attention's products


def test_accum_steps_match_jax(jax_case):
    """accum_steps=2 with a bfloat16 accumulator (bf16 compute) against the
    JAX step on the same batch (its two rows the microbatches), within
    ``BF16_GAP_FRACTION`` of the JAX package's own bf16-vs-f32 gap of the
    batch's loss and gradient norm (measured: at most 0.105 and 0.355 of
    it); float32 accumulation of the two microbatches against one step on
    the whole batch."""
    arch, tree, batch = jax_case["arch"], jax_case["tree"], jax_case["batch"]
    jcfg, cfg = _configs(arch, "bfloat16")
    jstep = jax.jit(JS.make_train_step(jcfg, JAdamWConfig(), accum_steps=2,
                                       accum_dtype=jnp.bfloat16))
    jstate = JS.init_train_state(jcfg, jax.random.PRNGKey(0))
    jstate["params"] = jax.tree.map(jnp.asarray, tree)
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    step = steps.make_train_step(cfg, AdamWConfig(), accum_steps=2,
                                 accum_dtype=torch.bfloat16)
    params = _torch_tree(tree)
    state, m = step({"params": params,
                     "opt": adamw.init_state(params, AdamWConfig())}, batch)
    assert state["opt"]["step"].dtype == torch.int32
    assert int(state["opt"]["step"]) == 1
    (l16, _, g16), (l32, _, g32) = jax_case["bfloat16"], jax_case["float32"]
    norm = {k: float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                 for g in grads.values())))
            for k, grads in (("16", g16), ("32", g32))}
    gaps = {"loss": abs(l16 - l32), "nll": abs(l16 - l32),
            "grad_norm": abs(norm["16"] - norm["32"])}
    for key, gap in gaps.items():
        assert abs(float(m[key]) - float(jm[key])) <= BF16_GAP_FRACTION * gap, (
            key, float(m[key]), float(jm[key]), gap)
    assert float(m["lr"]) == float(jm["lr"])
    # float32: two microbatches against the whole batch, one step each
    _, c32 = _configs(arch, "float32")
    one = steps.make_train_step(c32, AdamWConfig())
    two = steps.make_train_step(c32, AdamWConfig(), accum_steps=2)
    p1, p2 = _torch_tree(tree), _torch_tree(tree)
    _, m1 = one({"params": p1, "opt": adamw.init_state(p1, AdamWConfig())},
                batch)
    _, m2 = two({"params": p2, "opt": adamw.init_state(p2, AdamWConfig())},
                batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=F32_LOSS_RTOL)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=F32_GRAD_TOL)


@pytest.mark.parametrize("lr", sorted(TRAJ_RTOL))
def test_trajectory_matches_jax(lr):
    """5 steps of SyntheticLM batches (phi3 cut to two layers, remat none,
    as tests/test_system.py trains) against the JAX train step."""
    jcfg, cfg = _configs("phi3-mini-3.8b", "float32", remat="none")
    tree = convert.numpy_params(cfg, 0)
    data = _batches(cfg, 5)
    jstep = jax.jit(JS.make_train_step(jcfg, JAdamWConfig(lr=lr)))
    jstate = JS.init_train_state(jcfg, jax.random.PRNGKey(0))
    jstate["params"] = jax.tree.map(jnp.asarray, tree)
    step = steps.make_train_step(cfg, AdamWConfig(lr=lr))
    params = _torch_tree(tree)
    state = {"params": params, "opt": adamw.init_state(params, AdamWConfig())}
    for b in data:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, b)
        assert all(v.shape == () and v.dtype == torch.float32
                   for v in m.values())
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=TRAJ_RTOL[lr])
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=0)
        if int(state["opt"]["step"]) == 1:   # the same params: one gradient
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]),
                                       rtol=F32_GRAD_TOL)
    assert int(state["opt"]["step"]) == 5 == int(jstate["opt"]["step"])


def test_init_train_state_layout_matches_jax():
    jcfg, cfg = _configs("gemma-2b", "bfloat16")
    jstate = JS.init_train_state(jcfg, jax.random.PRNGKey(0))
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    jl = {p: (x.shape, str(x.dtype)) for p, x in sorted_leaves(
        jax.tree.map(np.asarray, jstate))}
    tl = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
          for p, x in sorted_leaves(state)}
    assert tl == jl
    # the master is float32 whatever param_dtype is
    assert state["params"]["embed"].dtype == torch.float32


def test_the_step_casts_the_master_every_call():
    """The master stays float32; the forward sees param_dtype; gradients
    reach the master through the cast (float32 gradients)."""
    _, cfg = _configs("gemma-2b", "bfloat16")
    tree = convert.numpy_params(cfg, 0)
    seen = []
    forward = T.forward

    def spy(params, tokens, c):
        seen.append(params["embed"].dtype)
        return forward(params, tokens, c)

    T.forward = spy
    try:
        loss, _, grads = _port_grads(cfg, tree, _batches(cfg, 1)[0])
    finally:
        T.forward = forward
    assert seen == [torch.bfloat16]
    assert all(g.dtype == np.float32 for g in grads.values())


# -- the exact-GEMM guard --------------------------------------------------------

def _flags():
    return (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _set_flags(bf16, tf32, cudnn_tf32):
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bf16
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32


@pytest.mark.parametrize("flags", [(True, False, False), (False, True, False),
                                   (False, False, True)])
def test_guard_refuses_a_cuda_model_while_gemms_may_round(flags):
    before = _flags()
    try:
        _set_flags(*flags)
        with pytest.raises(RuntimeError, match="exact GEMMs"):
            steps.exact_gemms("cuda")
        steps.exact_gemms("cpu")            # a CPU model passes
        _, cfg = _configs("gemma-2b", "bfloat16")
        cuda = types.SimpleNamespace(device=torch.device("cuda"))
        state = {"params": {}, "opt": {"step": cuda}}
        with pytest.raises(RuntimeError, match="exact GEMMs"):
            steps.make_train_step(cfg)(state, {})
        model = types.SimpleNamespace(dtype=torch.bfloat16, embed=cuda)
        with pytest.raises(RuntimeError, match="exact GEMMs"):
            steps.make_decode_step(cfg)(model, None, {}, 0)
        with pytest.raises(RuntimeError, match="exact GEMMs"):
            steps.make_prefill_step(cfg)(model, {})
    finally:
        _set_flags(*before)


def test_set_exact_gemms_lets_the_guard_pass():
    before = _flags()
    try:
        _set_flags(True, True, True)
        steps.set_exact_gemms()
        assert _flags() == (False, False, False)
        steps.exact_gemms("cuda")
    finally:
        _set_flags(*before)


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = _configs("gemma-2b", "float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.init_train_state(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tree_from_jax({"step": np.int32(0)})

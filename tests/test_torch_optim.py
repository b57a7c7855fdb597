"""repro_torch.optim vs the JAX package's optim, on the CPU.

The optimizer is held on identical inputs (the same params, gradients and
state): a train step's gradients differ between the packages by float32
round-off, and Adam's first steps move a param by about lr sign(g), so a
gradient entry near zero that flips sign moves it by 2 lr; the train step
is held on its loss, gradients and trajectory instead
(``tests/test_torch_train.py``). Tolerances:

* AdamW: float32 params and moments within 2 float32 ulp of the JAX
  package's jitted update (the same float32 operations, rounded in another
  order where XLA fuses or contracts them), an ulp taken of the largest
  term each output sums (``m b1`` and ``g (1 - b1)`` for m, ``v b2`` and
  ``g^2 (1 - b2)`` for v, ``p`` and ``lr delta`` for p: where two terms
  cancel, the result's own ulp is far below their rounding); bfloat16
  moments and params within one bfloat16 ulp of the same (a float32 value
  one ulp away may round the other way); with clipping, also within four
  times the two global norms' relative gap of the term (each package
  scales the gradients by its own norm, summed in its own order, and v is
  quadratic in them);
* ``global_norm``: rtol 1e-6 (a float32 sum in another order);
* schedules: rtol 1e-6;
* int8 compression: ``q`` bit-equal and the scale equal, the error state
  ``(g + e) - q scale`` within 2 float32 ulp of the leaf's largest
  ``|g + e|`` (XLA may fuse the product into the subtraction, rounding
  once where torch rounds twice).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JAW, compression as JC, schedule as JSC
from repro_torch.models.common import sorted_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw, compression, schedule
from repro_torch.optim import (apply_updates, clip_by_global_norm,
                               global_norm, init_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs
    beside other workers (eight threads a worker made the file ~4x
    slower)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = {"embed": (64, 16), "layers": {"l0": {"wq": (3, 16, 4, 8),
                                                "norm": (3, 16)}},
          "final": (16,)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tree(rng, scale=1.0):
    return tree_map(lambda s: rng.standard_normal(s).astype(np.float32)
                    * scale, SHAPES)


def _pair(tree, dtype):
    return (jax.tree.map(lambda a: jnp.asarray(a).astype(JDT[dtype]), tree),
            tree_map(lambda a: torch.from_numpy(a.copy()).to(TDT[dtype]), tree))


def _ulps(got, want, n, dtype, scale=None, rel=0.0):
    """|got - want| <= n ulps (float32 or bfloat16 spacing) of ``scale``
    (default: of want), plus ``rel`` x scale."""
    got, want = _np(got), _np(want)
    scale = np.abs(want) if scale is None else np.maximum(np.abs(want), scale)
    spacing = np.spacing(scale.astype(np.float32))
    if dtype == "bfloat16":
        spacing = spacing * 2.0 ** 16   # a bf16 ulp is 2^16 float32 ulps
    bad = np.abs(got - want) > n * spacing + rel * scale
    assert not bad.any(), (f"{int(bad.sum())} entries off by up to "
                           f"{np.abs(got - want).max():.3g}")


def _terms(p, g, m, v, cfg, scale, lr):
    """The largest term each AdamW output sums, per entry (float64)."""
    p, g, m, v = (_np(x).astype(np.float64) for x in (p, g, m, v))
    g = g * scale
    return {"m": np.maximum(np.abs(m) * cfg.b1, np.abs(g) * (1 - cfg.b1)),
            "v": np.maximum(np.abs(v) * cfg.b2, g * g * (1 - cfg.b2)),
            "p": np.maximum(np.abs(p), 2 * lr * (1 + cfg.weight_decay
                                                 * np.abs(p)))}


def _jax_cfg(cfg, moment):
    return JAW.AdamWConfig(lr=cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                           weight_decay=cfg.weight_decay,
                           grad_clip=cfg.grad_clip, moment_dtype=JDT[moment])


@pytest.mark.parametrize("param, grad, moment", [
    ("float32", "float32", "float32"),
    ("float32", "float32", "bfloat16"),
    ("float32", "bfloat16", "float32"),   # a bf16 accumulator's gradients
    ("bfloat16", "bfloat16", "bfloat16"),
])
@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("step, lr", [(0, 3e-4), (6, 1.7e-4)])
def test_apply_updates_matches_jax(param, grad, moment, clip, step, lr):
    """One update from the same params, gradients and state (the first
    step, and a later one from nonzero moments)."""
    rng = np.random.default_rng(step)
    p0, g0 = _tree(rng, 0.5), _tree(rng, 3.0)
    m0 = _tree(rng, 0.1 if step else 0.0)
    v0 = tree_map(np.abs, _tree(rng, 0.01 if step else 0.0))
    cfg = AdamWConfig(lr=3e-4, weight_decay=0.1, grad_clip=clip,
                      moment_dtype=TDT[moment])
    jcfg = _jax_cfg(cfg, moment)
    jp, tp = _pair(p0, param)
    jg, tg = _pair(g0, grad)
    jm, tm = _pair(m0, moment)
    jv, tv = _pair(v0, moment)
    norm = float(JAW.global_norm(jg))
    scale = min(1.0, clip / (norm + 1e-9)) if clip > 0 else 1.0
    norm_gap = abs(float(global_norm(tg)) - norm) / norm if clip > 0 else 0.0
    assert norm_gap <= 1e-6
    terms = {path: _terms(tp_, g_, m_, v_, cfg, scale, lr)
             for (path, tp_), (_, g_), (_, m_), (_, v_) in zip(
                 sorted_leaves(tp), sorted_leaves(tg),
                 sorted_leaves(tm), sorted_leaves(tv))}
    jp, jstate = jax.jit(lambda p, g, s, lr: JAW.apply_updates(
        p, g, s, jcfg, lr=lr))(jp, jg, {"m": jm, "v": jv,
                                        "step": jnp.int32(step)},
                               jnp.float32(lr))
    tp, tstate = apply_updates(tp, tg, {"m": tm, "v": tv, "step": torch.tensor(
        step, dtype=torch.int32)}, cfg, lr=torch.tensor(lr, dtype=torch.float32))
    assert int(tstate["step"]) == step + 1
    assert tstate["step"].dtype == torch.int32
    outs = {"p": (tp, jp, param), "m": (tstate["m"], jstate["m"], moment),
            "v": (tstate["v"], jstate["v"], moment)}
    for name, (got, want, dtype) in outs.items():
        for (path, a), (_, b) in zip(
                sorted_leaves(got), sorted_leaves(jax.tree.map(np.asarray, want))):
            assert a.dtype == TDT[dtype], path
            _ulps(a, b, 2 if dtype == "float32" else 1, dtype,
                  terms[path][name], 4 * norm_gap)


def test_apply_updates_defaults_to_the_configs_lr():
    rng = np.random.default_rng(1)
    p, g = _tree(rng), _tree(rng)
    cfg = AdamWConfig(lr=1e-3)
    jp, tp = _pair(p, "float32")
    jg, tg = _pair(g, "float32")
    jp, _ = jax.jit(lambda p, g: JAW.apply_updates(
        p, g, JAW.init_state(p, _jax_cfg(cfg, "float32")),
        _jax_cfg(cfg, "float32")))(jp, jg)
    tp, _ = apply_updates(tp, tg, init_state(tp, cfg), cfg)
    for (_, a), (_, b) in zip(sorted_leaves(tp),
                              sorted_leaves(jax.tree.map(np.asarray, jp))):
        _ulps(a, b, 2, "float32")


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(2)
    g = _tree(rng, 10.0)
    jg, tg = _pair(g, "float32")
    np.testing.assert_allclose(float(global_norm(tg)),
                               float(JAW.global_norm(jg)), rtol=1e-6)
    clipped, norm = clip_by_global_norm(tg, 1.0)
    jclipped, jnorm = JAW.clip_by_global_norm(jg, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    for (_, a), (_, b) in zip(sorted_leaves(clipped),
                              sorted_leaves(jax.tree.map(np.asarray, jclipped))):
        _ulps(a, b, 2, "float32")
    # a bf16 tree: squares summed in float32
    jb, tb = _pair(g, "bfloat16")
    np.testing.assert_allclose(float(global_norm(tb)),
                               float(JAW.global_norm(jb)), rtol=1e-6)


def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    st = init_state(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, st = apply_updates(params, grads, st, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_moment_dtype_and_device_respected():
    cfg = AdamWConfig(moment_dtype=torch.bfloat16)
    st = init_state({"w": torch.zeros((4,)), "b": {"c": torch.zeros(2)}}, cfg)
    assert st["m"]["w"].dtype == torch.bfloat16
    assert st["v"]["b"]["c"].dtype == torch.bfloat16
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()


@pytest.mark.parametrize("total", [300, 30])
def test_schedules_match_jax(total):
    steps = np.arange(0, 320, 7, dtype=np.int32)
    t = torch.from_numpy(steps)
    got = schedule.warmup_cosine(t, 6e-4, 30, total)
    want = jax.jit(lambda s: JSC.warmup_cosine(s, 6e-4, 30, total))(
        jnp.asarray(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    got = schedule.warmup_constant(t, 3e-4, 20)
    want = jax.jit(lambda s: JSC.warmup_constant(s, 3e-4, 20))(
        jnp.asarray(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_is_bit_equal(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-3, 1)).astype(
        np.float32)
    # exact ties of the scaled value (k + 1/2) * scale
    x[:64] = (np.arange(64) - 31.5).astype(np.float32) * np.float32(0.125)
    x[64] = 127 * 0.125
    q, s = compression.quantize_int8(torch.from_numpy(x))
    jq, js = jax.jit(JC.quantize_int8)(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        compression.dequantize_int8(q, s).numpy(),
        np.asarray(JC.dequantize_int8(jq, js)))


def test_compressed_reduce_matches_jax():
    rng = np.random.default_rng(3)
    grads = _tree(rng, 0.1)
    jerr = JC.init_error_state(jax.tree.map(jnp.asarray, grads))
    terr = compression.init_error_state(tree_map(torch.from_numpy, grads))
    for (_, a), (_, b) in zip(sorted_leaves(terr),
                              sorted_leaves(jax.tree.map(np.asarray, jerr))):
        assert a.dtype == torch.float32 and np.array_equal(_np(a), b)
    fn = jax.jit(JC.compressed_reduce)
    for k in range(4):
        # both packages carry the same error state into each call
        g = _tree(rng, 10.0 ** -k)
        prev = jax.tree.map(np.asarray, jerr)
        jout, jerr = fn(jax.tree.map(jnp.asarray, g), jerr)
        tout, terr = compression.compressed_reduce(
            tree_map(lambda a: torch.from_numpy(a.copy()), g),
            tree_map(lambda a: torch.from_numpy(a.copy()), prev))
        for (_, a), (_, b) in zip(sorted_leaves(tout),
                                  sorted_leaves(jax.tree.map(np.asarray, jout))):
            _ulps(a, b, 2, "float32")
        for (path, a), (_, b) in zip(
                sorted_leaves(terr), sorted_leaves(jax.tree.map(np.asarray, jerr))):
            big = np.abs(dict(sorted_leaves(g))[path]
                         + dict(sorted_leaves(prev))[path]).max()
            np.testing.assert_allclose(_np(a), b, rtol=0, atol=2 * float(
                np.spacing(np.float32(big))))
    assert sorted(p for p, _ in sorted_leaves(terr)) == sorted(
        p for p, _ in sorted_leaves(grads))


def test_error_feedback_preserves_sum():
    rng = np.random.default_rng(1)
    seq = [torch.from_numpy((rng.normal(size=(256,)) * (
        10 ** rng.uniform(-3, 0))).astype(np.float32)) for _ in range(50)]
    err = compression.init_error_state({"g": seq[0]})
    total_true = torch.zeros(256)
    total_sent = torch.zeros(256)
    for g in seq:
        out, err = compression.compressed_reduce({"g": g}, err)
        total_true += g
        total_sent += out["g"]
    np.testing.assert_allclose((total_sent + err["g"]).numpy(),
                               total_true.numpy(), rtol=1e-4, atol=1e-4)


def test_exports_match_jax():
    import repro.optim as J
    import repro_torch.optim as P

    for name in ("AdamWConfig", "apply_updates", "clip_by_global_norm",
                 "global_norm", "init_state", "warmup_constant",
                 "warmup_cosine", "compression"):
        assert hasattr(J, name) and hasattr(P, name), name
    assert adamw.__all__ == JAW.__all__
    assert compression.__all__ == JC.__all__

"""repro_torch.models and configs vs the JAX package's, on the CPU.

The same numpy-seeded inputs and weights go through the JAX function and
its port. The JAX step functions run jitted, as the JAX server runs them
(XLA folds a constant divisor into a product by its reciprocal there, and
the port computes it so). Tolerances:

* float32: rtol 1e-4 / atol 1e-5 on logits and on each module's output
  (the flash forward at rtol/atol 2e-5, as ``tests/test_models.py`` holds
  it to its oracle); the logits of every position (forward, teacher-forced
  decode) at atol ``F32_SEQ_ATOL`` (5e-5): the JAX package's own float32
  decode logits are 2.0e-5 from a float64 evaluation on these weights
  (``experiments/serve/conditioning.py``: their attention scores reach
  O(10^2), and the softmax amplifies ulp-level differences);
* bfloat16: ``BF16_TOL`` (2^-4, eight bf16 epsilons) on logits; a
  bfloat16 attention output within 2^-7 of the largest |v| (P and the
  output are rounded to bf16 once each); elementwise modules within two
  bf16 ulps of the output's scale;
* decode caches: bf16 entries as the JAX package writes them within one
  bf16 ulp; int8 codes and their scales bit-equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, get_config as jget_config
from repro.models import attention as JA, common as JC, mlp as JM
from repro.models import steps as JS, transformer as JT
from repro.models.flash import flash_attention as jflash
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as SV
from repro_torch.models import attention as A, common as C, convert, mlp as M
from repro_torch.models import steps, transformer as T
from repro_torch.models.flash import flash_attention

F32_RTOL, F32_ATOL = 1e-4, 1e-5
F32_SEQ_ATOL = 5e-5
BF16_TOL = 2.0 ** -4
REF_ARCHS = ("gemma-2b", "phi3-mini-3.8b", "qwen1.5-32b")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    """float32 numpy of a JAX or torch array (bf16 exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or x.dtype.name == "bfloat16" else x


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype]))


def _configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jget_config(arch).reduced(n_layers=2, **kw),
                                param_dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(n_layers=2, **kw),
                                param_dtype=dtype))


def _models(arch, dtype, seed=0, **kw):
    jcfg, cfg = _configs(arch, dtype, **kw)
    tree = convert.numpy_params(cfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(JDT[dtype]), tree)
    model = steps.cast_model(cfg, convert.from_jax_params(cfg, tree, "cpu"))
    return jcfg, cfg, jp, model


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


# -- flash forward -------------------------------------------------------------

#: (causal, prefix, sq, skv, q_chunk, kv_chunk, q_offset)
FLASH_CASES = [
    (True, 0, 64, 64, 32, 32, 0),
    (True, 13, 100, 100, 32, 32, 0),
    (False, 0, 37, 129, 32, 32, 0),
    (False, 0, 100, 100, 64, 64, 0),
    (True, 0, 100, 100, 48, 40, 0),      # chunks that do not divide
    (True, 0, 24, 88, 16, 32, 64),       # suffix queries, q_offset = skv - sq
    (True, 5, 37, 129, 32, 24, 92),      # prefix and offset, ragged chunks
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_forward_matches_jax(case, dtype):
    causal, prefix, sq, skv, qc, kc, off = case
    B, KV, G, D = 2, 2, 3, 16
    rng = np.random.default_rng(sq * 1000 + skv + off)
    q = rng.standard_normal((B, sq, KV, G, D), np.float32)
    k = rng.standard_normal((B, skv, KV, D), np.float32)
    v = rng.standard_normal((B, skv, KV, D), np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    want = jflash(jq, jk, jv, causal, prefix, qc, kc, off)
    got = flash_attention(tq, tk, tv, causal, prefix, qc, kc, off)
    assert got.dtype == TDT[dtype] and got.shape == q.shape
    oracle = JA.chunked_attention(
        jq.reshape(B, sq, KV * G, D), jk, jv, jnp.arange(sq) + off,
        jnp.arange(skv), causal=causal, prefix_len=prefix, q_chunk=qc,
        kv_chunk=kc).reshape(q.shape)
    if dtype == "float32":
        _close(got, want, 2e-5, 2e-5)
        _close(got, oracle, 2e-5, 2e-5)
    else:
        tol = 2.0 ** -7 * float(np.abs(v).max())
        _close(got, want, 0, tol)
        _close(got, oracle, 0, tol)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_jax(dtype, softcap):
    rng = np.random.default_rng(7)
    B, sq, skv, H, KV, D = 2, 50, 70, 4, 2, 16
    q = rng.standard_normal((B, sq, H, D), np.float32)
    k = rng.standard_normal((B, skv, KV, D), np.float32)
    v = rng.standard_normal((B, skv, KV, D), np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    qpos, kpos = np.arange(sq) + 20, np.arange(skv)
    kw = dict(causal=True, prefix_len=3, q_chunk=16, kv_chunk=24,
              softcap=softcap)
    want = jax.jit(functools.partial(JA.chunked_attention, **kw))(
        jq, jk, jv, jnp.asarray(qpos), jnp.asarray(kpos))
    got = A.chunked_attention(tq, tk, tv, torch.from_numpy(qpos),
                              torch.from_numpy(kpos), **kw)
    if dtype == "float32":
        _close(got, want, 2e-5, 2e-5)
    else:
        _close(got, want, 0, 2.0 ** -7 * float(np.abs(v).max()))


# -- norms, RoPE, MLP ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64), np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    b = rng.standard_normal(64).astype(np.float32) * 0.1
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, b))
    tol = (F32_RTOL, F32_ATOL) if dtype == "float32" else (2.0 ** -7, 2.0 ** -7)
    got = C.rms_norm(tx, tw)
    assert got.dtype == TDT[dtype]
    _close(got, jax.jit(JC.rms_norm)(jx, jw), *tol)
    _close(C.layer_norm(tx, tw, tb), jax.jit(JC.layer_norm)(jx, jw, jb), *tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [32, 96, 256])
def test_apply_rope_matches_jax(head_dim, dtype):
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 24, 3, head_dim), np.float32)
    pos = (np.arange(24) * 37)[None, :]          # positions up to 851
    jx, tx = _pair(x, dtype)
    want = jax.jit(JC.apply_rope)(jx, jnp.asarray(pos))
    got = C.apply_rope(tx, torch.from_numpy(pos))
    assert got.dtype == TDT[dtype]
    # float32 angles of positions up to 851: the two libraries' cos/sin
    # and exp differ by an ulp, a few 1e-5 on the output
    tol = (F32_RTOL, 2e-4) if dtype == "float32" else (2.0 ** -7, 2.0 ** -7)
    _close(got, want, *tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["geglu", "swiglu", "gelu"])
def test_mlp_matches_jax(act, dtype):
    jcfg, cfg = _configs("gemma-2b", act=act)
    rng = np.random.default_rng(3)
    specs = M.param_specs(cfg)
    p = {k: rng.standard_normal(s.shape, np.float32) * s.stddev()
         for k, s in specs.items()}
    x = rng.standard_normal((2, 5, cfg.d_model), np.float32)
    jp = {k: _pair(a, dtype)[0] for k, a in p.items()}
    tp = {k: _pair(a, dtype)[1] for k, a in p.items()}
    jx, tx = _pair(x, dtype)
    want = jax.jit(functools.partial(JM.mlp, cfg=jcfg))(jp, jx)
    got = M.mlp(tp, tx, cfg)
    assert got.dtype == TDT[dtype]
    if dtype == "float32":
        _close(got, want, F32_RTOL, F32_ATOL)
    else:
        # XLA rounds the gate's elementwise steps to bf16, torch once
        _close(got, want, 0, 2 * 2.0 ** -7 * float(np.abs(_np(want)).max()))


# -- decode attention and the caches ----------------------------------------------

def _decode_case(kv_cache_dtype, dtype, seed=11):
    jcfg, cfg = _configs("gemma-2b", dtype, kv_cache_dtype=kv_cache_dtype)
    rng = np.random.default_rng(seed)
    specs = A.param_specs(cfg)
    p = {k: rng.standard_normal(s.shape, np.float32) * s.stddev()
         for k, s in specs.items()}
    B, smax = 3, 12
    xs = rng.standard_normal((smax, B, 1, cfg.d_model), np.float32)
    jp = {k: _pair(a, dtype)[0] for k, a in p.items()}
    tp = {k: _pair(a, dtype)[1] for k, a in p.items()}
    jc = jax.tree.map(lambda a: a[0], JT.init_decode_caches(jcfg, B, smax)["l0"])
    tc = {k: t[0] for k, t in T.init_decode_caches(cfg, B, smax,
                                                   device="cpu")["l0"].items()}
    step = jax.jit(lambda p_, x, c, pos: JA.decode_attention(p_, x, c, pos, jcfg))
    return cfg, jp, tp, xs, jc, tc, step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_cache_dtype", ["bfloat16", "int8"])
def test_decode_attention_matches_jax(kv_cache_dtype, dtype):
    cfg, jp, tp, xs, jc, tc, step = _decode_case(kv_cache_dtype, dtype)
    for t, x in enumerate(xs):
        jx, tx = _pair(x, dtype)
        jy, jc = step(jp, jx, jc, jnp.int32(t))
        ty, tc = A.decode_attention(tp, tx, tc, t, cfg)
        scale = float(np.abs(_np(jy)).max())
        if dtype == "float32" and kv_cache_dtype == "bfloat16":
            tol = 2.0 ** -8 * scale     # the PV product's bf16 output
        else:
            tol = 2.0 ** -6 * scale
        _close(ty, jy, 0, tol, f"step {t}")
    for name in jc:
        if kv_cache_dtype == "int8":
            # int8 codes and their bf16 scales, bit for bit
            got, want = tc[name], np.asarray(jc[name])
            if got.dtype == torch.bfloat16:
                got, want = got.view(torch.int16), want.view(np.int16)
            assert np.array_equal(got.numpy(), want), name
        else:
            _close(tc[name], jc[name], 2.0 ** -7, 0, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_cache_write_is_bit_equal(dtype):
    """The same token quantized and written by both packages: int8 codes
    and bf16 scales bit for bit (``torch.round`` rounds half to even, as
    ``jnp.round`` does; ties included)."""
    rng = np.random.default_rng(4)
    k = rng.standard_normal((3, 1, 2, 32), np.float32)
    k[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]     # ties at scale 1
    v = rng.standard_normal((3, 1, 2, 32), np.float32) * 40
    jcache = {n: jnp.zeros((3, 9) + s, dt) for n, s, dt in (
        ("k", (2, 32), jnp.int8), ("v", (2, 32), jnp.int8),
        ("k_scale", (2, 1), jnp.bfloat16), ("v_scale", (2, 1), jnp.bfloat16))}
    tcache = {n: torch.zeros((3, 9) + s, dtype=dt) for n, s, dt in (
        ("k", (2, 32), torch.int8), ("v", (2, 32), torch.int8),
        ("k_scale", (2, 1), torch.bfloat16), ("v_scale", (2, 1), torch.bfloat16))}
    (jk, tk), (jv, tv) = _pair(k, dtype), _pair(v, dtype)
    want = jax.jit(JA._cache_write)(jcache, jk, jv, jnp.int32(5))
    got = A._cache_write(tcache, tk, tv, 5)
    for name in want:
        w = np.asarray(want[name])
        g = got[name]
        if g.dtype == torch.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16)), name
        else:
            assert np.array_equal(g.numpy(), w), name
    # the write offset is clamped into the cache, as dynamic_update_slice
    A._cache_write(tcache, tk, tv, 40)
    assert torch.equal(tcache["k"][:, 8:9], got["k"][:, 5:6])


# -- the model: forward, prefill, decode ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_prefill_and_forward_match_jax(arch, dtype):
    jcfg, cfg, jp, model = _models(arch, dtype)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    jl, jcaches = jax.jit(JS.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tcaches = steps.make_prefill_step(cfg)(
        model, {"tokens": torch.from_numpy(toks)})
    hidden = jax.jit(lambda p, t: JT.logits_from_hidden(
        p, JT.forward(p, t, jcfg)[0], jcfg))(jp, jnp.asarray(toks))
    h, aux = model.forward(torch.from_numpy(toks))
    assert float(aux) == 0.0
    full = model.logits_from_hidden(h)
    assert tl.shape == (2, 1, cfg.padded_vocab) and tl.dtype == TDT[dtype]
    if dtype == "float32":
        _close(tl, jl, F32_RTOL, F32_ATOL)
        _close(full, hidden, F32_RTOL, F32_SEQ_ATOL)
    else:
        _close(tl, jl, 0, BF16_TOL)
        _close(full, hidden, 0, BF16_TOL)
    got = convert.tree_to_numpy(tcaches)
    for name in ("k", "v"):
        assert tcaches["l0"][name].dtype == torch.bfloat16
        want = _np(jcaches["l0"][name])
        assert got["l0"][name].shape == want.shape
        # bf16 caches: within one ulp of the largest entry (float32) or two
        tol = (1 if dtype == "float32" else 2) * 2.0 ** -7
        _close(got["l0"][name], want, 0, tol * np.abs(want).max(), name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_teacher_forced_decode_matches_jax(arch, dtype):
    jcfg, cfg, jp, model = _models(arch, dtype)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    jc = JT.init_decode_caches(jcfg, 2, 12, dtype=JDT[dtype])
    tc = T.init_decode_caches(cfg, 2, 12, dtype=TDT[dtype], device="cpu")
    jstep = jax.jit(JS.make_decode_step(jcfg))
    tstep = steps.make_decode_step(cfg)
    for t in range(12):
        jn, jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        tn, tl, tc = tstep(model, torch.from_numpy(toks[:, t:t + 1]), tc, t)
        assert tn.dtype == torch.int32 and tn.shape == (2, 1)
        if dtype == "float32":
            _close(tl, jl, F32_RTOL, F32_SEQ_ATOL, f"step {t}")
            assert np.array_equal(tn.numpy(), np.asarray(jn)), t
        else:
            _close(tl, jl, 0, BF16_TOL, f"step {t}")
    got = convert.tree_to_numpy(tc)
    for name in ("k", "v"):
        want = _np(jc["l0"][name])
        _close(got["l0"][name], want, 0, 2.0 ** -6 * np.abs(want).max(), name)


def test_int8_decode_matches_jax():
    jcfg, cfg, jp, model = _models("gemma-2b", "bfloat16",
                                   kv_cache_dtype="int8")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 10),
                                             dtype=np.int32)
    jc = JT.init_decode_caches(jcfg, 2, 10)
    tc = T.init_decode_caches(cfg, 2, 10, device="cpu")
    assert tc["l0"]["k"].dtype == torch.int8
    assert tc["l0"]["k_scale"].shape == (2, 2, 10, 1, 1)
    jstep = jax.jit(JS.make_decode_step(jcfg))
    for t in range(10):
        _, jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        _, tl, tc = steps.make_decode_step(cfg)(
            model, torch.from_numpy(toks[:, t:t + 1]), tc, t)
        # one int8 code is 1/127 of the token's largest entry (2^-3, as
        # chip_smoke.py's INT8_TOL)
        _close(tl, jl, 0, 2.0 ** -3, f"step {t}")
    # layer 0's codes and scales bit for bit; layer 1's tokens come through
    # layer 0's bf16 attention, whose rounding may move a code (the logits
    # above hold them)
    for name in tc["l0"]:
        got, want = tc["l0"][name][0], np.asarray(jc["l0"][name])[0]
        if got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(np.int16)
        assert np.array_equal(got.numpy(), want), name


# -- configs, conversion, refusals ------------------------------------------------------

def test_registry_matches_jax():
    assert ARCHS == JARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
        assert dataclasses.asdict(get_config(arch).reduced()) == \
            dataclasses.asdict(jget_config(arch).reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch):
    """Full size, specs only: nothing is materialized."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.reduced().param_count() == jcfg.reduced().param_count()


def test_spec_tree_matches_jax():
    for arch in REF_ARCHS + ("granite-moe-1b-a400m", "mamba2-370m"):
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        jl = jax.tree_util.tree_flatten_with_path(
            JT.param_specs(jcfg), is_leaf=lambda x: hasattr(x, "shape"))[0]
        want = {"/".join(k.key for k in p): tuple(s) for p, s in jl}
        got = {p: tuple(s) for p, s in C.tree_leaves(T.param_specs(cfg))}
        assert got == want, arch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_params_round_trip(dtype):
    jcfg, cfg = _configs("qwen1.5-32b", dtype)
    tree = jax.tree.map(lambda a: np.asarray(a),
                        JC.init_params(jax.random.PRNGKey(0),
                                       JT.param_specs(jcfg), JDT[dtype]))
    model = convert.from_jax_params(cfg, tree, "cpu")
    assert model.dtype == TDT[dtype]
    assert model.layers[1].attn["bq"].shape == (cfg.n_heads, cfg.head_dim)
    back = convert.to_numpy_params(model)
    flat_back = dict(C.tree_leaves(back))
    for path, a in C.tree_leaves(tree):
        assert np.array_equal(flat_back[path], a.astype(np.float32)), path
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="does not match"):
        convert.from_jax_params(cfg, bad, "cpu")


def test_caches_round_trip():
    jcfg, cfg = _configs("gemma-2b", kv_cache_dtype="int8")
    jc = JT.init_decode_caches(jcfg, 2, 5)
    jc = jax.tree.map(lambda a: a + jnp.ones_like(a), jc)
    tc = convert.tree_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert tc["l0"]["k"].dtype == torch.int8
    assert tc["l0"]["k_scale"].dtype == torch.bfloat16
    back = convert.tree_to_numpy(tc)
    for name in jc["l0"]:
        assert back["l0"][name].dtype == np.asarray(jc["l0"][name]).dtype
        assert np.array_equal(_np(back["l0"][name]), _np(jc["l0"][name])), name


def test_a_step_refuses_a_model_in_another_dtype():
    _, cfg = _configs("gemma-2b", "bfloat16")
    model = convert.from_jax_params(cfg, convert.numpy_params(cfg, 0), "cpu")
    with pytest.raises(ValueError, match="cast it once"):
        steps.make_decode_step(cfg)(model, torch.zeros((1, 1), dtype=torch.int32),
                                    T.init_decode_caches(cfg, 1, 2, device="cpu"), 0)
    assert steps.cast_model(cfg, model).dtype == torch.bfloat16


def test_entry_points_default_to_the_card():
    """Without a card, every entry point that makes tensors raises unless
    the caller names the CPU; none moves there on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("gemma-2b").reduced(n_layers=1)
    gen = torch.Generator()
    for call in (lambda: C.init_params(T.param_specs(cfg), gen),
                 lambda: T.init_decode_caches(cfg, 1, 4),
                 lambda: convert.from_jax_params(
                     cfg, convert.numpy_params(cfg, 0)),
                 lambda: convert.tree_from_jax({"l0": {}}),
                 lambda: SV.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

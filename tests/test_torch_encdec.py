"""repro_torch.models.encdec and the cross-attention vs the JAX package's,
on the CPU.

whisper-tiny ``.reduced()`` (2 encoder and 4 decoder layers over 64
frames, LayerNorm, GELU) on numpy-seeded weights and frames, through the
JAX functions (jitted) and the port. Tolerances: float32 rtol 1e-4 / atol
1e-5 on hidden states and logits (this config's float32 logits are 3.7e-8
from a float64 evaluation, ``experiments/layers/conditioning.py``); bf16
within four bf16 ulps of the output's scale (XLA may keep excess
precision between two bf16 ops; logits: 2^-4, as 13a holds them); the
bf16 caches within one bf16 ulp of their scale from a float32 model, four
from a bf16 one; the sinusoidal table within four float32 ulps of its largest
angle (``seq``: an ulp of a frequency's ``exp`` moves the angle by as
much); cache round trips bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as JA, common as JC, encdec as JE
from repro.models import steps as JS
from repro_torch.configs import get_config
from repro_torch.models import attention as A, common as C, convert
from repro_torch.models import encdec as E
from repro_torch.models import steps

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_TOL = 2.0 ** -4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(dtype="float32"):
    return (dataclasses.replace(jget_config("whisper-tiny").reduced(),
                                param_dtype=dtype),
            dataclasses.replace(get_config("whisper-tiny").reduced(),
                                param_dtype=dtype))


def _setup(dtype):
    jcfg, cfg = _configs(dtype)
    tree = convert.numpy_params(cfg, 0)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(JDT[dtype]), tree)
    model = steps.cast_model(cfg, convert.from_jax_params(cfg, tree, "cpu"))
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((2, cfg.enc_seq, cfg.d_model), np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    return jcfg, cfg, tree, jp, model, frames, toks


def _close(got, want, dtype, what="", logits=False):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=what)
    else:
        tol = BF16_TOL if logits else 4 * 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, what


@pytest.mark.parametrize("seq,dim", [(64, 128), (1500, 384), (7, 10)])
def test_sinusoidal_positions_match_jax(seq, dim):
    got = C.sinusoidal_positions(seq, dim).numpy()
    want = np.asarray(jax.jit(JC.sinusoidal_positions,
                              static_argnums=(0, 1))(seq, dim))
    assert got.dtype == np.float32 and got.shape == (seq, dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0 ** -24 * seq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_and_memory_kv_match_jax(dtype):
    jcfg, cfg = _configs(dtype)
    tree = convert.numpy_params(cfg, 0)["dec_layers"]["xattn"]
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]).astype(JDT[dtype]), tree)
    tp = {k: torch.from_numpy(a[0].copy()).to(TDT[dtype])
          for k, a in tree.items()}
    assert "bq" not in tp               # the cross projections have no bias
    rng = np.random.default_rng(2)
    mem = rng.standard_normal((2, cfg.enc_seq, cfg.d_model), np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model), np.float32)
    jmem, tmem = (jnp.asarray(mem).astype(JDT[dtype]),
                  torch.from_numpy(mem).to(TDT[dtype]))
    jkv = jax.jit(JA.memory_kv)(jp, jmem)
    kv = A.memory_kv(tp, tmem)
    for got, want, name in zip(kv, jkv, "kv"):
        _close(got, want, dtype, name)
    jout = jax.jit(lambda p, x, kv: JA.cross_attention(p, x, kv, jcfg))(
        jp, jnp.asarray(x).astype(JDT[dtype]), jkv)
    out = A.cross_attention(tp, torch.from_numpy(x).to(TDT[dtype]), kv, cfg)
    assert out.dtype == TDT[dtype] and out.shape == (2, 5, cfg.d_model)
    _close(out, jout, dtype, "cross_attention")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    jcfg, cfg, _, jp, model, frames, _ = _setup(dtype)
    jf = jnp.asarray(frames).astype(JDT[dtype])
    want = jax.jit(lambda p, f: JE.encode(p, f, jcfg))(jp, jf)
    got = model.encode(torch.from_numpy(frames).to(TDT[dtype]))
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype, "encode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """The prefill's last logits and caches (self k/v sized to the prompt,
    cross k/v over the frames, bf16), then teacher-forced decode from zero
    self caches and the prefill's cross caches."""
    jcfg, cfg, _, jp, model, frames, toks = _setup(dtype)
    jb = {"frames": jnp.asarray(frames).astype(JDT[dtype]),
          "tokens": jnp.asarray(toks)}
    jl, jc = jax.jit(JS.make_prefill_step(jcfg))(jp, jb)
    tb = {"frames": torch.from_numpy(frames).to(TDT[dtype]),
          "tokens": torch.from_numpy(toks)}
    logits, caches = steps.make_prefill_step(cfg)(model, tb)
    _close(logits, jl, dtype, "prefill logits", logits=True)
    for part in ("self", "cross"):
        for k in ("k", "v"):
            got, want = caches[part][k], np.asarray(
                jc[part][k].astype(jnp.float32))
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            ulps = 1 if dtype == "float32" else 4
            np.testing.assert_allclose(
                got.float().numpy(), want, rtol=0,
                atol=ulps * 2.0 ** -8 * np.abs(want).max(),
                err_msg=f"{part} {k}")
    jcache = JE.init_decode_caches(jcfg, 2, 16, dtype=JDT[dtype])
    jcache["cross"] = jax.tree.map(lambda a: a.astype(JDT[dtype]), jc["cross"])
    cache = E.init_decode_caches(cfg, 2, 16, dtype=TDT[dtype], device="cpu")
    assert cache["cross"]["k"].shape == (cfg.n_layers, 2, cfg.enc_seq,
                                         cfg.n_kv_heads, cfg.head_dim)
    for k in ("k", "v"):
        cache["cross"][k] = convert.tree_from_jax(
            {"a": np.asarray(jcache["cross"][k])}, "cpu")["a"]
    jstep = jax.jit(JS.make_decode_step(jcfg))
    step = steps.make_decode_step(cfg)
    for t in range(toks.shape[1]):
        _, jlog, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                                jnp.int32(t))
        _, log, cache = step(model, torch.from_numpy(toks[:, t:t + 1]), cache,
                             t)
        _close(log, jlog, dtype, f"decode {t}", logits=True)


def test_forward_and_its_gradients_match_jax():
    """The training forward (encoder + decoder, remat full) and jax.grad
    of the loss, float32, per leaf within 1e-4 x its largest entry."""
    jcfg, cfg, tree, jp, _, frames, toks = _setup("float32")
    labels = np.roll(toks, -1, axis=1)
    batch = {"frames": frames, "tokens": toks, "labels": labels}
    (jl, _), jg = jax.jit(jax.value_and_grad(JS._forward_loss(jcfg),
                                             has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, _), grads = steps._value_and_grad(steps._forward_loss(cfg))(
        convert.tree_from_jax(tree, "cpu"), steps._on_device(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    flat = dict(C.sorted_leaves(grads))
    for path, g in C.sorted_leaves(jax.tree.map(np.asarray, jg)):
        np.testing.assert_allclose(flat[path].numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=path)


def test_encdec_caches_round_trip_bit_for_bit():
    jcfg, _ = _configs()
    jc = JE.init_decode_caches(jcfg, 2, 5)
    jc = jax.tree.map(lambda a: a + jnp.asarray(np.random.default_rng(0)
                                                .standard_normal(a.shape))
                      .astype(a.dtype), jc)
    tc = convert.tree_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert set(tc) == {"self", "cross"}
    assert tc["cross"]["k"].dtype == torch.bfloat16
    back = convert.tree_to_numpy(tc)
    for part in jc:
        for k in jc[part]:
            a, b = np.asarray(jc[part][k]), back[part][k]
            assert a.dtype == b.dtype
            assert np.array_equal(a.view(np.uint16), b.view(np.uint16))


def test_the_server_builds_zero_cross_caches():
    """The JAX Server never calls encode: its cross caches stay zero, and
    the port's too."""
    from repro_torch.launch.serve import Request, Server

    _, cfg, _, _, model, _, toks = _setup("float32")
    srv = Server(cfg, model, max_batch=2, max_len=16)
    assert set(srv.caches) == {"self", "cross"}
    srv.submit(Request(0, toks[0, :4], max_new=3))
    while srv.step():
        pass
    assert len(srv.done[0].out) == 3
    assert not srv.caches["cross"]["k"].any() and srv.caches["self"]["k"].any()

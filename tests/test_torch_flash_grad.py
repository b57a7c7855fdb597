"""The flash backward and the chunked loss of repro_torch vs the JAX
package's, on the CPU.

The flash backward (``models.flash``'s ``torch.autograd.Function``) is held
to ``jax.grad`` of the JAX package's ``flash_attention`` (its custom VJP)
on the same inputs, over the JAX package's own gradient case
(``tests/test_models.py::test_flash_grads_match_oracle``: B 2, S 96, KV 2,
G 2, D 8, chunks of 32) and the forward's ``FLASH_CASES``, through the
objective ``sum(sin(out))``. Tolerances: float32 dq, dk, dv within 1e-4
(rtol and atol, the JAX test's against its oracle) and within 2e-5 x the
largest |grad| of JAX's; bfloat16 within 2^-6 x the largest |grad| (q, k,
v and the output are rounded to bf16 once each; the backward itself runs
in float32). ``torch.autograd.gradcheck`` runs in float64 on a tiny case.

``lm_loss``: against the unchunked cross entropy at rtol 1e-5 (the JAX
test's), against the JAX package's ``lm_loss`` on the same hidden states
and params at rtol 1e-6 (loss) and 2e-5 x max |grad| (its gradients with
respect to the hidden states and the embedding), with softcap, with ignored
labels, and with a chunk that does not divide the sequence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as JA, transformer as JT
from repro.models.flash import flash_attention as jflash
from repro_torch.configs import get_config
from repro_torch.models import attention as A, convert, transformer as T
from repro_torch.models.common import tree_map
from repro_torch.models.flash import flash_attention


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

#: (causal, prefix, sq, skv, q_chunk, kv_chunk, q_offset): the forward's
#: cases (tests/test_torch_models.py) and the JAX package's gradient case
FLASH_CASES = [
    (True, 0, 64, 64, 32, 32, 0),
    (True, 13, 100, 100, 32, 32, 0),
    (False, 0, 37, 129, 32, 32, 0),
    (False, 0, 100, 100, 64, 64, 0),
    (True, 0, 100, 100, 48, 40, 0),      # chunks that do not divide
    (True, 0, 24, 88, 16, 32, 64),       # suffix queries, q_offset = skv - sq
    (True, 5, 37, 129, 32, 24, 92),      # prefix and offset, ragged chunks
]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flash_grads(q, k, v, dtype, args, B=2, KV=2, G=3, D=16):
    jq, jk, jv = (jnp.asarray(x).astype(JDT[dtype]) for x in (q, k, v))

    def f(q, k, v):
        out = jflash(q, k, v, *args)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jq, jk, jv)
    ins = [torch.from_numpy(x.copy()).to(TDT[dtype]).requires_grad_()
           for x in (q, k, v)]
    out = flash_attention(*ins, *args)
    torch.sin(out.float()).sum().backward()
    return [x.grad for x in ins], want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_matches_jax(case, dtype):
    causal, prefix, sq, skv, qc, kc, off = case
    B, KV, G, D = 2, 2, 3, 16
    rng = np.random.default_rng(sq * 1000 + skv + off + 7)
    q = rng.standard_normal((B, sq, KV, G, D), np.float32)
    k = rng.standard_normal((B, skv, KV, D), np.float32)
    v = rng.standard_normal((B, skv, KV, D), np.float32)
    got, want = _flash_grads(q, k, v, dtype, (causal, prefix, qc, kc, off))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == TDT[dtype] and a.shape == b.shape, name
        scale = float(np.abs(_np(b)).max())
        tol = 2e-5 if dtype == "float32" else 2.0 ** -6
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol * scale,
                                   err_msg=name)


def test_flash_grads_match_the_jax_oracle_case():
    """The JAX package's own case, against jax.grad of JAX's flash and of
    its chunked oracle (and the port's oracle through autograd)."""
    B, S, KV, G, D = 2, 96, 2, 2, 8
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, KV, G, D), np.float32)
    k = rng.standard_normal((B, S, KV, D), np.float32)
    v = rng.standard_normal((B, S, KV, D), np.float32)
    got, want = _flash_grads(q, k, v, "float32", (True, 0, 32, 32, 0))

    def f_ref(q, k, v):
        o = JA.chunked_attention(q.reshape(B, S, KV * G, D), k, v,
                                 jnp.arange(S), jnp.arange(S), causal=True,
                                 q_chunk=32, kv_chunk=32)
        return jnp.sum(jnp.sin(o))

    oracle = jax.jit(jax.grad(f_ref, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    ins = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    pos = torch.arange(S)
    o = A.chunked_attention(ins[0].reshape(B, S, KV * G, D), ins[1], ins[2],
                            pos, pos, causal=True, q_chunk=32, kv_chunk=32)
    torch.sin(o).sum().backward()
    for a, b, c, d in zip(got, want, oracle, ins):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(a), _np(c), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(a), _np(d.grad), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", [(True, 0, 0), (True, 3, 0), (False, 0, 0),
                                  (True, 0, 4)])
def test_flash_gradcheck_float64(case):
    causal, prefix, off = case
    gen = torch.Generator().manual_seed(1)
    sq, skv = 5, 5 + off
    q = torch.randn((1, sq, 1, 2, 4), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    k = torch.randn((1, skv, 1, 4), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    v = torch.randn((1, skv, 1, 4), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, causal, prefix, 2, 3, off),
        (q, k, v))


def test_flash_without_a_gradient_keeps_nothing():
    q = torch.zeros((1, 4, 1, 1, 8), requires_grad=True)
    k = torch.zeros((1, 4, 1, 8))
    with torch.no_grad():
        out = flash_attention(q, k, k)
    assert out.shape == q.shape and out.grad_fn is None
    assert flash_attention(q, k, k).grad_fn is not None


# -- lm_loss -----------------------------------------------------------------

def _loss_case(arch="phi3-mini-3.8b", seed=0, b=2, s=48, **kw):
    jcfg = dataclasses.replace(jget_config(arch).reduced(n_layers=1, **kw),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(n_layers=1, **kw),
                              param_dtype="float32")
    tree = convert.numpy_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    hidden = rng.standard_normal((b, s, cfg.d_model), np.float32)
    labels = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    return jcfg, cfg, tree, hidden, labels


def _port_loss(cfg, tree, hidden, labels):
    params = tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(),
                      tree)
    h = torch.from_numpy(hidden.copy()).requires_grad_()
    loss, nll = T.lm_loss(params, h, torch.from_numpy(labels), cfg)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    dh, dw = torch.autograd.grad(loss, (h, head))
    return loss, nll, dh, dw


@pytest.mark.parametrize("kw", [dict(loss_chunk=64), dict(loss_chunk=512),
                                dict(loss_chunk=70, logit_softcap=30.0)],
                         ids=["chunk64", "one-chunk", "softcap-ragged"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma-2b"])
def test_lm_loss_matches_jax(arch, kw):
    jcfg, cfg, tree, hidden, labels = _loss_case(arch, **kw)
    loss, nll, dh, dw = _port_loss(cfg, tree, hidden, labels)

    def f(p, h):
        return JT.lm_loss(p, h, jnp.asarray(labels), jcfg)[0]

    head = "embed" if cfg.tie_embeddings else "lm_head"
    jp = jax.tree.map(jnp.asarray, tree)
    jloss, (jgp, jdh) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        jp, jnp.asarray(hidden))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(nll) == float(loss)   # no MoE aux
    for a, b in ((dh, jdh), (dw, jgp[head])):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=0,
                                   atol=2e-5 * np.abs(b).max())


def test_lm_loss_matches_unchunked():
    # 48 positions in chunks of 32: the last chunk padded with -1 labels
    _, cfg, tree, hidden, labels = _loss_case(loss_chunk=64)
    assert cfg.loss_chunk // 2 == 32 and 48 % 32
    params = tree_map(torch.from_numpy, tree)
    h = torch.from_numpy(hidden)
    _, nll = T.lm_loss(params, h, torch.from_numpy(labels), cfg)
    logits = T.logits_from_hidden(params, h, cfg).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.from_numpy(labels).long()[..., None])
    want = torch.mean(lse - ll[..., 0])
    np.testing.assert_allclose(float(nll), float(want), rtol=1e-5)


def test_labels_ignore_index():
    jcfg, cfg, tree, hidden, labels = _loss_case(s=32)
    params = tree_map(torch.from_numpy, tree)
    h = torch.from_numpy(hidden)
    _, nll_all = T.lm_loss(params, h, torch.from_numpy(labels), cfg)
    half = labels.copy()
    half[:, 16:] = -1
    _, nll_half = T.lm_loss(params, h, torch.from_numpy(half), cfg)
    assert not np.isclose(float(nll_all), float(nll_half))
    assert np.isfinite(float(nll_half))
    _, jhalf = JT.lm_loss(jax.tree.map(jnp.asarray, tree), jnp.asarray(hidden),
                          jnp.asarray(half), jcfg)
    np.testing.assert_allclose(float(nll_half), float(jhalf), rtol=1e-6)
    none = np.full_like(labels, -1)
    _, nll_none = T.lm_loss(params, h, torch.from_numpy(none), cfg)
    assert float(nll_none) == 0.0


def test_lm_loss_keeps_no_full_logits():
    """The chunk's logits are recomputed in the backward: what autograd
    keeps is the chunk inputs, never a (B, S, V) tensor."""
    _, cfg, tree, hidden, labels = _loss_case(loss_chunk=64)
    params = tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(),
                      tree)
    h = torch.from_numpy(hidden.copy()).requires_grad_()
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = T.lm_loss(params, h, torch.from_numpy(labels), cfg)
    v = cfg.padded_vocab
    assert not any(len(s) == 3 and s[-1] == v for s in saved), saved
    loss.backward()

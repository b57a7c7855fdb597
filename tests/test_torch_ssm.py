"""repro_torch.models.ssm (Mamba-2 SSD) vs the JAX package's, on the CPU.

The same numpy-seeded mixer weights and inputs go through the JAX
functions (jitted) and the port. The chunk scan's three- and
four-operand float32 products contract in another order in torch, so
float32 is held at a tolerance, not bit for bit: rtol 1e-4 / atol 1e-5
on outputs and states (on these inputs the JAX package's own chunked
scan and its stepwise decode differ by ~1e-6, ``tests/test_models.py``
holds them at 5e-3), gradients within 1e-4 x each leaf's largest entry;
bfloat16 outputs within two bf16 ulps of their scale. The conv tails
(bf16 in both packages' prefill) are held bit for bit where the
projections are float32, within a bf16 ulp (2^-7 relative) where they
are bf16; softplus
within 2 float32 ulps (XLA flushes the subnormal softplus(-100) to 0).
bfloat16 gradients by chip_smoke's 15a rule: each leaf's relative L2
distance to the JAX package's bfloat16 gradient within twice that
package's own bf16-vs-f32 distance (at most 0.4), which zero and negated
gradients miss; and the whole gradient's distance to the float32 one at
least a quarter of the JAX package's whole bf16-vs-f32 distance, which
float32 gradients miss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import ssm as S
from repro_torch.models.common import tree_leaves, unflatten

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs():
    return (jget_config("mamba2-370m").reduced(n_layers=1),
            get_config("mamba2-370m").reduced(n_layers=1))


def _params(cfg, seed=0):
    """The reference weight rule over ssm.param_specs: normal leaves at
    their spec stddev, the zeros/ones-initialized ones at 0.1 around
    their init (so that A_log, D and the norm weight are not constants)."""
    leaves = dict(tree_leaves(S.param_specs(cfg)))
    rng = np.random.default_rng(seed)
    out = {}
    for p in sorted(leaves):
        s = leaves[p]
        a = rng.standard_normal(s.shape, np.float32)
        out[p] = (a * s.stddev() if s.init == "normal" else
                  a * np.float32(0.1) + np.float32(s.init == "ones"))
    return unflatten(out)


def _u(cfg, s=64, b=2, seed=1):
    return (np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model), np.float32) * 0.3)


def _pair(tree, dtype):
    return (jax.tree.map(lambda a: jnp.asarray(a).astype(JDT[dtype]), tree),
            {k: torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype])
             for k, a in tree.items()})


def _close(got, want, dtype, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=what)
    else:
        assert np.abs(got - want).max() <= 2 * 2.0 ** -8 * np.abs(
            want).max(), what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_forward_matches_jax(dtype):
    """Two chunks of 32 (the reduced config's), with and without the
    decode state."""
    jcfg, cfg = _configs()
    jp, tp = _pair(_params(cfg), dtype)
    u = _u(cfg)
    ju, tu = jnp.asarray(u).astype(JDT[dtype]), torch.from_numpy(u).to(TDT[dtype])
    jout = jax.jit(lambda p, u: JS.ssd_forward(p, u, jcfg))(jp, ju)
    out = S.ssd_forward(tp, tu, cfg)
    assert out.dtype == TDT[dtype] and out.shape == tu.shape
    _close(out, jout, dtype, "out")
    jout2, jst = jax.jit(lambda p, u: JS.ssd_forward(p, u, jcfg,
                                                     return_state=True))(jp, ju)
    out2, st = S.ssd_forward(tp, tu, cfg, return_state=True)
    assert torch.equal(out2, out)
    assert st["ssm"].dtype == torch.float32
    assert st["conv"].dtype == torch.bfloat16      # in every dtype
    _close(st["ssm"], jst["ssm"], "float32" if dtype == "float32" else dtype,
           "state")
    # the tail is the raw projections' last K-1 rows, rounded to bf16: bit
    # for bit from float32 projections, within a bf16 ulp from bf16 ones
    np.testing.assert_allclose(st["conv"].float().numpy(),
                               np.asarray(jst["conv"].astype(jnp.float32)),
                               rtol=0 if dtype == "float32" else 2.0 ** -7)


def test_ssd_forward_short_prompt_pads_the_conv_tail():
    """A prompt shorter than K-1 gives a zero-padded tail, as the JAX
    package's (one chunk of the prompt's length)."""
    jcfg, cfg = _configs()
    jp, tp = _pair(_params(cfg), "float32")
    u = _u(cfg, s=2)
    _, jst = JS.ssd_forward(jp, jnp.asarray(u), jcfg, return_state=True)
    _, st = S.ssd_forward(tp, torch.from_numpy(u), cfg, return_state=True)
    assert np.array_equal(st["conv"].float().numpy(),
                          np.asarray(jst["conv"].astype(jnp.float32)))
    assert not st["conv"][:, 0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_matches_jax(dtype):
    """Eight single-token steps from a nonzero state, the conv buffer in
    the cache dtype (bf16)."""
    jcfg, cfg = _configs()
    jp, tp = _pair(_params(cfg), dtype)
    u = _u(cfg, s=8)
    rng = np.random.default_rng(3)
    st0 = {"ssm": rng.standard_normal((2, cfg.ssm_nheads, cfg.ssm_headdim,
                                       cfg.ssm_state), np.float32),
           "conv": rng.standard_normal((2, cfg.ssm_conv - 1, cfg.ssm_d_inner
                                        + 2 * cfg.ssm_state), np.float32)}
    jst = {"ssm": jnp.asarray(st0["ssm"]),
           "conv": jnp.asarray(st0["conv"]).astype(jnp.bfloat16)}
    tst = {"ssm": torch.from_numpy(st0["ssm"]),
           "conv": torch.from_numpy(st0["conv"]).to(torch.bfloat16)}
    step = jax.jit(lambda p, u, s: JS.ssd_decode(p, u, s, jcfg))
    for t in range(8):
        jy, jst = step(jp, jnp.asarray(u[:, t:t + 1]).astype(JDT[dtype]), jst)
        y, tst = S.ssd_decode(tp, torch.from_numpy(u[:, t:t + 1]).to(
            TDT[dtype]), tst, cfg)
        _close(y, jy, dtype, f"step {t}")
        assert tst["conv"].dtype == torch.bfloat16
    _close(tst["ssm"], jst["ssm"], "float32" if dtype == "float32" else dtype)
    assert np.array_equal(tst["conv"].float().numpy(),
                          np.asarray(jst["conv"].astype(jnp.float32)))


def test_prefill_state_continues_decode():
    """The state a prefill returns equals the state after stepping the
    same tokens through decode (``tests/test_models.py``'s contract), and
    both equal the JAX package's."""
    jcfg, cfg = _configs()
    jp, tp = _pair(_params(cfg), "float32")
    u = torch.from_numpy(_u(cfg, s=32, b=1))
    _, st_prefill = S.ssd_forward(tp, u, cfg, return_state=True)
    st = S.init_decode_state(cfg, 1, device="cpu")
    assert st["conv"].dtype == torch.float32 and not st["ssm"].any()
    for t in range(32):
        _, st = S.ssd_decode(tp, u[:, t:t + 1], st, cfg)
    np.testing.assert_allclose(st_prefill["ssm"].numpy(), st["ssm"].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st_prefill["conv"].float().numpy(),
                               st["conv"].float().numpy(), rtol=2 ** -8)
    _, jst = JS.ssd_forward(jp, jnp.asarray(u.numpy()), jcfg,
                            return_state=True)
    np.testing.assert_allclose(st_prefill["ssm"].numpy(),
                               np.asarray(jst["ssm"]), rtol=1e-4, atol=1e-5)


def test_chunked_matches_stepwise():
    """The chunked scan against the recurrence (the port's own decode)."""
    _, cfg = _configs()
    _, tp = _pair(_params(cfg), "float32")
    u = torch.from_numpy(_u(cfg))
    y = S.ssd_forward(tp, u, cfg)
    st = S.init_decode_state(cfg, 2, device="cpu")
    ys = []
    for t in range(u.shape[1]):
        yt, st = S.ssd_decode(tp, u[:, t:t + 1], st, cfg)
        ys.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_gradients_match_jax_grad():
    """Through the chunk loop (each chunk checkpointed), the conv, the
    softplus and the gated norm, float32: jax.grad of sum(out * w)."""
    jcfg, cfg = _configs()
    p, u = _params(cfg), _u(cfg)
    w = np.random.default_rng(5).standard_normal(u.shape).astype(np.float32)
    jg, jgu = jax.jit(jax.grad(
        lambda p, u: jnp.sum(JS.ssd_forward(p, u, jcfg) * w), argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(u))
    tp = {k: torch.from_numpy(a).requires_grad_() for k, a in p.items()}
    tu = torch.from_numpy(u).requires_grad_()
    torch.sum(S.ssd_forward(tp, tu, cfg) * torch.from_numpy(w)).backward()
    for name, g in list(jg.items()) + [("u", jgu)]:
        got = (tu if name == "u" else tp[name]).grad.numpy()
        want = np.asarray(g)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def _rel(a, b, ref):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / np.linalg.norm(ref))


def test_bf16_gradients_match_jax_grad():
    """bfloat16 gradients (weights and input in bf16, as a bf16 train step
    runs the mixer) against jax.grad by 15a's rule (module docstring):
    the port's bf16 passes, its float32 and a zero or negated bf16
    gradient miss. ``dt_bias`` is centred on -4 as in the layers reference's
    conditioned rule (``convert.conditioned_params``)."""
    jcfg, cfg = _configs()
    p, u = _params(cfg), _u(cfg)
    p["dt_bias"] = p["dt_bias"] - np.float32(4.0)
    w = np.random.default_rng(5).standard_normal(u.shape).astype(np.float32)

    def jloss(p, u):
        return jnp.sum(JS.ssd_forward(p, u, jcfg).astype(jnp.float32) * w)

    jg, tg = {}, {}
    for dt in ("float32", "bfloat16"):
        g, gu = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            *_pair(p, dt)[:1], jnp.asarray(u).astype(JDT[dt]))
        jg[dt] = {k: np.asarray(v.astype(jnp.float32), np.float64)
                  for k, v in {**g, "u": gu}.items()}
        tp = {k: t.requires_grad_() for k, t in _pair(p, dt)[1].items()}
        tu = torch.from_numpy(u).to(TDT[dt]).requires_grad_()
        torch.sum(S.ssd_forward(tp, tu, cfg).float()
                  * torch.from_numpy(w)).backward()
        tg[dt] = {k: t.grad.double().numpy()
                  for k, t in {**tp, "u": tu}.items()}
    # 15a's two-sided rule (chip_smoke._layers_bf16_tols)
    for name, want in jg["bfloat16"].items():
        ref = jg["float32"][name]
        gap = _rel(want, ref, ref)
        tol = min(2.0 * gap, 0.4)
        for wrong in (np.zeros_like, np.negative):
            assert _rel(wrong(tg["bfloat16"][name]), want, ref) > tol
        assert _rel(tg["bfloat16"][name], want, ref) <= tol, (name, gap)

    def whole(g, ref):
        return float(np.sqrt(sum(np.sum((g[k] - ref[k]) ** 2) for k in ref)
                             / sum(np.sum(ref[k] ** 2) for k in ref)))

    gap = whole(jg["bfloat16"], jg["float32"])
    assert (whole(tg["bfloat16"], jg["float32"]) >= 0.25 * gap
            > whole(tg["float32"], jg["float32"]))


def test_training_keeps_no_decay_matrix():
    """With autograd recording, each chunk is checkpointed: no (.., Q, Q)
    tensor is saved for the backward, only the carries and inputs."""
    _, cfg = _configs()
    tp = {k: torch.from_numpy(a).requires_grad_()
          for k, a in _params(cfg).items()}
    u = torch.from_numpy(_u(cfg)).requires_grad_()
    q = cfg.ssm_chunk
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        y = S.ssd_forward(tp, u, cfg)
    assert saved and not any(len(s) >= 2 and s[-2:] == (q, q) for s in saved)
    y.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in tp.values())


def test_masked_decay_has_zero_gradient_above_the_diagonal():
    """exp(-inf) above the diagonal: the gradient there is 0, not NaN."""
    a = torch.randn(2, 3, 8, dtype=torch.float32, requires_grad=True)
    L = torch.exp(S._segsum(a))
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    (L * torch.randn_like(L)).sum().backward()
    assert torch.isfinite(a.grad).all()
    ja = jnp.asarray(a.detach().numpy())
    np.testing.assert_allclose(S._segsum(a).detach().numpy(),
                               np.asarray(JS._segsum(ja)), rtol=1e-6,
                               atol=1e-6)


def test_softplus_is_jax_softplus():
    x = np.array([-100.0, -30.0, -1.0, -1e-3, 0.0, 1e-3, 1.0, 20.0, 30.0,
                  100.0], np.float32)
    got = S.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=2.0 ** -22, atol=1e-38)
    t = torch.from_numpy(x).requires_grad_()
    S.softplus(t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(
        jax.grad(lambda v: jnp.sum(jax.nn.softplus(v)))(x)), rtol=1e-6,
        atol=1e-7)

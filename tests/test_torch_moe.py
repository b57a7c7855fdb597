"""repro_torch.models.moe (the local path) vs the JAX package's, on the CPU.

The same numpy-seeded router, experts and activations go through the JAX
functions (jitted, as the steps run them) and the port. Routing is
discontinuous: a near-tie between the k-th and (k+1)-th router
probability can send a token to another expert, which moves its output
by a whole expert's contribution. So every check records the smallest
such margin; expert ids are held equal (as sets: the order inside the
top k only pairs gates with experts) on every token whose margin exceeds
``MARGIN`` (2^-12: the port's router probabilities are within 1e-7 of
the JAX package's on these inputs), outputs only on those tokens, and
the number of tokens below the margin is stated in each assertion.
Tolerances: float32 outputs rtol 1e-4 / atol 1e-5 (four products of 128
terms), the aux loss rtol 1e-6; bfloat16 outputs within two bf16 ulps of
the output's scale (the expert products round to bf16 once each);
float32 gradients within 1e-4 x each leaf's largest entry; bfloat16
gradients by chip_smoke's 15a rule: each leaf's relative L2 distance to
the JAX package's bfloat16 gradient within twice that package's own
bf16-vs-f32 distance (at most 0.4), which zero and negated gradients
miss; and the whole gradient's distance to the float32 one at least a
quarter of the JAX package's whole bf16-vs-f32 distance, which float32
gradients miss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.models import moe as M
from repro_torch.models.common import tree_leaves, unflatten

MARGIN = 2.0 ** -12
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(**kw):
    return (jget_config("granite-moe-1b-a400m").reduced(**kw),
            get_config("granite-moe-1b-a400m").reduced(**kw))


def _params(cfg, seed=0):
    """The reference weight rule over moe.param_specs (float32 numpy)."""
    leaves = dict(tree_leaves(M.param_specs(cfg)))
    rng = np.random.default_rng(seed)
    return unflatten({p: rng.standard_normal(leaves[p].shape, np.float32)
                      * leaves[p].stddev() for p in sorted(leaves)})


def _x(cfg, scale=0.5, seed=1):
    return (np.random.default_rng(seed).standard_normal(
        (2, 64, cfg.d_model), np.float32) * scale)


def _margins(x2, router, k):
    probs = torch.softmax(x2.float() @ router.float(), dim=-1).numpy()
    top = -np.sort(-probs, axis=-1)
    return top[:, k - 1] - top[:, k]


def _same_sets(a, b):
    return (np.sort(np.asarray(a), 1) == np.sort(np.asarray(b), 1)).all(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_jax(dtype):
    jcfg, cfg = _configs()
    p, x = _params(cfg), _x(cfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(JDT[dtype]), p)
    tp = {k: torch.from_numpy(a).to(TDT[dtype]) for k, a in p.items()}
    jx, tx = jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    jout, jaux = jax.jit(lambda p, x: JM.moe(p, x, jcfg))(jp, jx)
    out, aux = M.moe(tp, tx, cfg)
    assert out.dtype == TDT[dtype] and aux.dtype == torch.float32

    x2 = tx.reshape(-1, cfg.d_model)
    margin = _margins(x2, tp["router"], cfg.top_k)
    _, jidx = jax.lax.top_k(jax.nn.softmax(
        jx.reshape(-1, cfg.d_model).astype(jnp.float32)
        @ jp["router"].astype(jnp.float32)), cfg.top_k)
    _, idx, _ = M._route(x2.float(), tp["router"].float(), cfg.top_k)
    ok = margin > MARGIN
    same = _same_sets(idx, jidx)
    below = int((~ok).sum())
    assert same[ok].all(), f"{below} tokens below margin {MARGIN}"
    got = out.float().numpy().reshape(-1, cfg.d_model)
    want = np.asarray(jout.astype(jnp.float32)).reshape(-1, cfg.d_model)
    if dtype == "float32":
        np.testing.assert_allclose(got[ok & same], want[ok & same],
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"{below} tokens below margin")
    else:
        tol = 2 * 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want)[ok & same].max() <= tol, below
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # Switch aux loss is ~1 for balanced routing (tests/test_models.py)
    assert 0.5 < float(aux) < cfg.n_experts


def test_capacity_drops_match_jax():
    """capacity_factor=0.1: most slots drop through the residual (out 0),
    none is NaN, and the kept slots' outputs are the JAX package's."""
    jcfg, cfg = _configs(capacity_factor=0.1)
    p, x = _params(cfg), _x(cfg, scale=1.0)
    jout, jaux = jax.jit(lambda p, x: JM.moe(p, x, jcfg))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    out, aux = M.moe(tp, torch.from_numpy(x), cfg)
    x2 = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, idx, _ = M._route(x2, tp["router"], cfg.top_k)
    cap = M.capacity(x2.shape[0], cfg.n_experts, cfg)
    flat, keep, counts = M._positions(idx, cfg.n_experts, cap)
    assert cap == 8 and int((~keep).sum()) > 0 and int(keep.sum()) == 32
    assert bool(torch.isfinite(out).all())
    ok = _margins(x2, tp["router"], cfg.top_k) > MARGIN
    np.testing.assert_allclose(out.numpy().reshape(-1, cfg.d_model)[ok],
                               np.asarray(jout).reshape(-1, cfg.d_model)[ok],
                               rtol=1e-4, atol=1e-5,
                               err_msg=f"{int((~ok).sum())} below margin")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_dispatch_is_the_jax_dispatch_exactly():
    """Given the same expert ids (ties included), the queue positions,
    kept mask, counts and drop slot equal the JAX package's."""
    rng = np.random.default_rng(4)
    for t, k, e, cap in ((64, 2, 4, 24), (64, 8, 32, 8), (5, 2, 4, 1)):
        idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
            np.int32)
        jflat, jkeep, jcounts = jax.jit(
            JM._positions, static_argnums=(1, 2))(jnp.asarray(idx), e, cap)
        flat, keep, counts = M._positions(torch.from_numpy(idx).long(), e, cap)
        assert np.array_equal(flat.numpy(), np.asarray(jflat))
        assert np.array_equal(keep.numpy(), np.asarray(jkeep))
        assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    # the scatter's buffer: each kept row holds exactly its one token
    x = torch.from_numpy(rng.standard_normal((5 * 2, 3)).astype(np.float32))
    buf = torch.zeros((4 * 1 + 1, 3)).index_add(0, flat, x)[:-1]
    jbuf = jnp.zeros((4, 3)).at[jnp.asarray(flat.numpy())].add(
        jnp.asarray(x.numpy()), mode="drop")
    assert np.array_equal(buf.numpy(), np.asarray(jbuf))


def test_top_k_breaks_ties_by_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    logits = np.log(probs)
    gate, idx, _ = M._route(torch.from_numpy(logits), torch.eye(4), 2)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits) @ jnp.eye(4)),
                            2)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(idx.numpy(), [[0, 1], [1, 2], [0, 2]])


@pytest.mark.parametrize("t,cf", [(64, 1.25), (5, 1.0), (4096, 0.1)])
def test_capacity_is_the_jax_formula(t, cf):
    jcfg, cfg = _configs(capacity_factor=cf)
    assert M.capacity(t, 4, cfg) == JM.capacity(t, 4, jcfg)


def test_gradients_match_jax_grad():
    """Gradients through the gather, the scatter and the gates (the
    default autograd of index_add / indexing) against jax.grad of
    sum(out * w) + aux, float32."""
    jcfg, cfg = _configs()
    p, x = _params(cfg), _x(cfg)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = JM.moe(p, x, jcfg)
        return jnp.sum(out * w) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.from_numpy(a).requires_grad_() for k, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = M.moe(tp, tx, cfg)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    # the gradients sum over every token: held where every token routes
    # as in the JAX package (those below the margin included)
    x2 = tx.detach().reshape(-1, cfg.d_model)
    below = int((_margins(x2, tp["router"].detach(), cfg.top_k)
                 <= MARGIN).sum())
    _, idx, _ = M._route(x2, tp["router"].detach(), cfg.top_k)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x2.numpy())
                                           @ jnp.asarray(p["router"])),
                            cfg.top_k)
    assert _same_sets(idx, jidx).all(), f"{below} tokens below margin"
    for name, g in jg.items():
        want = np.asarray(g)
        np.testing.assert_allclose(tp[name].grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
    want = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _rel(a, b, ref):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / np.linalg.norm(ref))


def test_bf16_gradients_match_jax_grad():
    """bfloat16 gradients (weights and activations in bf16, as a bf16
    train step runs the layer) against jax.grad by 15a's rule (module
    docstring): the port's bf16 passes, its float32 and a zero or
    negated bf16 gradient miss. The router is drawn at its fan-in (the
    layers reference's conditioned rule, ``convert.conditioned_params``),
    so that every token routes alike in both packages and dtypes."""
    jcfg, cfg = _configs()
    p, x = _params(cfg), _x(cfg)
    p["router"] = (np.random.default_rng(7).standard_normal(
        p["router"].shape, np.float32) / np.float32(np.sqrt(cfg.d_model)))
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = JM.moe(p, x, jcfg)
        return jnp.sum(out.astype(jnp.float32) * w) + aux

    jg, tg, idx = {}, {}, {}
    for dt in ("float32", "bfloat16"):
        g, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jax.tree.map(lambda a: jnp.asarray(a).astype(JDT[dt]), p),
            jnp.asarray(x).astype(JDT[dt]))
        jg[dt] = {k: np.asarray(v.astype(jnp.float32), np.float64)
                  for k, v in {**g, "x": gx}.items()}
        tp = {k: torch.from_numpy(a).to(TDT[dt]).requires_grad_()
              for k, a in p.items()}
        tx = torch.from_numpy(x).to(TDT[dt]).requires_grad_()
        out, aux = M.moe(tp, tx, cfg)
        (torch.sum(out.float() * torch.from_numpy(w)) + aux).backward()
        tg[dt] = {k: t.grad.double().numpy()
                  for k, t in {**tp, "x": tx}.items()}
        x2 = tx.detach().reshape(-1, cfg.d_model)
        idx[dt] = M._route(x2, tp["router"].detach(), cfg.top_k)[1]
        jx2 = jnp.asarray(x).astype(JDT[dt]).reshape(-1, cfg.d_model)
        _, jidx = jax.lax.top_k(jax.nn.softmax(
            (jx2 @ jnp.asarray(p["router"]).astype(JDT[dt])).astype(
                jnp.float32)), cfg.top_k)
        margins = _margins(x2, tp["router"].detach(), cfg.top_k)
        assert _same_sets(idx[dt], jidx).all(), (dt, margins.min())
    assert _same_sets(idx["float32"], idx["bfloat16"]).all()
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


def test_a_config_with_moe_on_alternate_layers_builds_its_pattern():
    """jamba's pattern: MoE at odd layers (moe_pattern (0, 1)), its specs
    stacked per pattern element."""
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced())
    (pattern, repeats), = cfg.layer_groups()
    assert len(pattern) == 8 and repeats == 1
    assert [ffn for _, ffn in pattern] == ["mlp", "moe"] * 4

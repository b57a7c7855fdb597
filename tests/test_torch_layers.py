"""The layer pattern through the port for all ten archs, the prefix, the
caches and the CLIs, on the CPU.

* Every arch's ``.reduced()`` config trains one step and decodes one step
  through the port (``tests/test_arch_smoke.py``'s contract: finite
  metrics and logits, params updated, the decode cache of the arch's
  kind), and its ``param_count`` equals the materialized tree.
* PaliGemma's prefix forward against the JAX package's
  (``transformer.forward(prefix_embeds=...)``). These weights' attention
  is sharp (scores of order 10^2), so the hidden states at every position
  are held against a float64 evaluation by the port: float32 within
  twice the JAX package's own float32-vs-float64 gap (5.5e-3 here), bf16
  in relative L2 within 0.75 of the JAX package's own bf16-vs-f32 gap
  (0.14 against 0.46 here).
* SSM and hybrid decode caches cross ``convert`` bit for bit, and an MoE
  train state's checkpoint restores across the packages bit for bit.
* ``launch.serve`` takes every arch; ``launch.train`` trains MoE and SSM
  configs and refuses enc-dec and prefix configs by name.

Jamba's cases here are ``slow``; its tier-1 case is
``tests/test_torch_layers_ref.py``'s float32 reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as JCM
from repro.configs import get_config as jget_config
from repro.models import steps as JS, transformer as JT
from repro_torch.checkpoint import restore, save
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as SV, train as TR
from repro_torch.models import attention, convert, encdec, steps, transformer
from repro_torch.models.common import sorted_leaves, tree_map
from repro_torch.optim import AdamWConfig

B, S = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arch_params(archs=ARCHS):
    return [pytest.param(a, marks=pytest.mark.slow) if a.startswith("jamba")
            else a for a in archs]


def _batch(cfg, seed=0):
    """test_arch_smoke.py's batch shapes, from numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model), np.float32)
    if cfg.n_prefix_tokens:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model), np.float32)
        batch["tokens"] = batch["tokens"][:, :S - cfg.n_prefix_tokens]
    return batch


@pytest.mark.parametrize("arch", _arch_params())
def test_train_step_and_decode_step(arch):
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    state = steps.init_train_state(cfg, gen, device="cpu")
    first = {p: t.clone() for p, t in sorted_leaves(state["params"])}
    state, m = steps.make_train_step(cfg)(state, _batch(cfg))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    after = dict(sorted_leaves(state["params"]))
    assert all(after[p].shape == t.shape for p, t in first.items())
    path = next(iter(first))
    assert not torch.equal(after[path], first[path])

    model = steps.cast_model(cfg, steps.make_model(
        cfg, tree_map(lambda t: t.detach(), state["params"])))
    mod = encdec if cfg.is_encdec else transformer
    caches = mod.init_decode_caches(cfg, B, S, device="cpu")
    kinds = {m for m, _ in cfg.layer_kinds()}
    if cfg.is_encdec:
        assert set(caches) == {"self", "cross"}
    else:
        leaves = {k for c in caches.values() for k in c}
        assert leaves == ({"k", "v"} if kinds == {"attn"} else
                          {"ssm", "conv"} if kinds == {"ssm"} else
                          {"k", "v", "ssm", "conv"})
    tok = torch.ones((B, 1), dtype=torch.int32)
    nxt, logits, _ = steps.make_decode_step(cfg)(model, tok, caches, 5)
    assert nxt.shape == (B, 1) and logits.shape[-1] == cfg.padded_vocab
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", _arch_params())
def test_param_count_matches_materialized(arch):
    cfg = get_config(arch).reduced()
    params = steps.init_train_state(cfg, torch.Generator(),
                                    device="cpu")["params"]
    n = sum(t.numel() for _, t in sorted_leaves(params))
    assert n == cfg.param_count()
    assert cfg.param_count() == jget_config(arch).reduced().param_count()


@pytest.mark.parametrize("arch", _arch_params(["granite-moe-1b-a400m",
                                               "mamba2-370m",
                                               "jamba-1.5-large-398b",
                                               "whisper-tiny", "paligemma-3b"]))
def test_remat_modes_give_the_same_gradients(arch):
    """remat full (the layer checkpointed, the SSD chunks checkpointed
    inside it) and dots (selective checkpointing around them) recompute
    the same operations as none: the loss and every gradient equal."""
    base = get_config(arch).reduced()
    tree = convert.numpy_params(base, 0)
    batch = steps._on_device(_batch(base, seed=3), "cpu")
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat, param_dtype="float32")
        (loss, _), grads = steps._value_and_grad(steps._forward_loss(cfg))(
            convert.tree_from_jax(tree, "cpu"), batch)
        out[remat] = (float(loss), dict(sorted_leaves(grads)))
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0], remat
        for path, g in out["none"][1].items():
            assert torch.equal(out[remat][1][path], g), (remat, path)


@pytest.mark.slow
def test_hybrid_blocks_run_in_the_pattern_order():
    cfg = get_config("jamba-1.5-large-398b").reduced()
    model = convert.from_jax_params(cfg, convert.numpy_params(cfg, 0), "cpu")
    got = [("attn" if "attn" in b.names else "ssm",
            "moe" if "moe" in b.names else "mlp" if "mlp" in b.names
            else "none") for b in model.layers]
    assert got == cfg.layer_kinds()
    back = convert.to_numpy_params(model)
    for path, a in sorted_leaves(convert.numpy_params(cfg, 0)):
        assert np.array_equal(dict(sorted_leaves(back))[path], a), path


def _promoting(eq, *ops):
    dt = torch.float32
    for t in ops:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


def _prefix_forward(arch, dtype, tree, batch, jax_side):
    if jax_side:
        jcfg = dataclasses.replace(jget_config(arch).reduced(),
                                   param_dtype=dtype)
        jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
        h, aux = jax.jit(lambda p, t, e: JT.forward(
            p, t, jcfg, prefix_embeds=e))(
            jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), tree),
            jnp.asarray(batch["tokens"]), jnp.asarray(batch["prefix_embeds"]))
        return np.asarray(h.astype(jnp.float32), np.float64), float(aux)
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}[dtype]
    h, aux = transformer.forward(
        tree_map(lambda a: torch.from_numpy(a).to(tdt), tree),
        torch.from_numpy(batch["tokens"]), cfg,
        prefix_embeds=torch.from_numpy(batch["prefix_embeds"]).to(tdt))
    assert h.dtype == tdt and h.shape == (B, S, cfg.d_model)
    return h.detach().double().numpy(), float(aux)


def test_prefix_forward_matches_jax():
    """The hidden states over P prefix embeddings and S tokens: the prefix
    cast to the activations' dtype after embed_scale, bidirectional over
    the prefix, causal after it; then the serving prefill's caches."""
    arch = "paligemma-3b"
    cfg = get_config(arch).reduced()
    tree = convert.numpy_params(cfg, 0)
    batch = _batch(cfg, seed=1)
    saved = (torch.Tensor.float, attention.einsum_f32)
    torch.Tensor.float, attention.einsum_f32 = torch.Tensor.double, _promoting
    try:
        h64, _ = _prefix_forward(arch, "float64", tree, batch, False)
    finally:
        torch.Tensor.float, attention.einsum_f32 = saved
    j32, jaux = _prefix_forward(arch, "float32", tree, batch, True)
    p32, aux = _prefix_forward(arch, "float32", tree, batch, False)
    assert aux == jaux == 0.0
    own = np.abs(j32 - h64).max()
    assert np.abs(p32 - j32).max() <= 2 * own, own
    j16, _ = _prefix_forward(arch, "bfloat16", tree, batch, True)
    p16, _ = _prefix_forward(arch, "bfloat16", tree, batch, False)
    gap = np.linalg.norm(j16 - j32) / np.linalg.norm(j32)
    assert np.linalg.norm(p16 - j16) / np.linalg.norm(j32) <= 0.75 * gap
    # the serving module's prefill over the same prefix: caches of P + S
    model = convert.from_jax_params(cfg, tree, "cpu")
    _, caches = model.prefill(torch.from_numpy(batch["tokens"]),
                              prefix_embeds=torch.from_numpy(
                                  batch["prefix_embeds"]))
    assert caches["l0"]["k"].shape == (cfg.n_layers, B, S, cfg.n_kv_heads,
                                       cfg.head_dim)


@pytest.mark.parametrize("arch", _arch_params(["mamba2-370m",
                                               "jamba-1.5-large-398b"]))
def test_ssm_caches_round_trip_bit_for_bit(arch):
    """init_decode_caches and prefill caches of the JAX package (SSM
    states: float32 ssm, bf16 conv; attention k/v) through convert and
    back."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jc = JT.init_decode_caches(jcfg, 2, 8)
    rng = np.random.default_rng(0)
    jc = jax.tree.map(lambda a: (a + jnp.asarray(rng.standard_normal(
        a.shape))).astype(a.dtype), jc)
    tc = convert.tree_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    mine = transformer.init_decode_caches(cfg, 2, 8, device="cpu")
    assert ({p: (t.shape, t.dtype) for p, t in sorted_leaves(tc)}
            == {p: (t.shape, t.dtype) for p, t in sorted_leaves(mine)})
    back = dict(sorted_leaves(convert.tree_to_numpy(tc)))
    for path, a in sorted_leaves(jax.tree.map(np.asarray, jc)):
        b = back[path]
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def _moe_state(moment):
    cfg = dataclasses.replace(jget_config("granite-moe-1b-a400m").reduced(),
                              moment_dtype=moment)
    state = JS.init_train_state(cfg, jax.random.PRNGKey(3))
    state["opt"]["m"] = jax.tree.map(lambda m, p: (p * 0.25).astype(m.dtype),
                                     state["opt"]["m"], state["params"])
    state["opt"]["v"] = jax.tree.map(lambda v, p: (p * p).astype(v.dtype),
                                     state["opt"]["v"], state["params"])
    state["opt"]["step"] = jnp.int32(9)
    return state


def _same_bits(port, jtree):
    p = dict(sorted_leaves(port))
    j = dict(sorted_leaves(jax.tree.map(np.asarray, jtree)))
    assert sorted(p) == sorted(j)
    for key, a in j.items():
        b = convert.tree_to_numpy({"x": p[key]})["x"]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a.reshape(-1).view(np.uint8),
                              b.reshape(-1).view(np.uint8)), key


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_moe_checkpoint_restores_across_packages(tmp_path, moment):
    state = _moe_state(moment)
    assert "moe" in state["params"]["layers"]["l0"]
    JCM.save(tmp_path / "jax", 9, state, extra={"arch": "granite"})
    like = convert.tree_from_jax(jax.tree.map(np.asarray, state), "cpu")
    _same_bits(restore(tmp_path / "jax", 9, like), state)
    save(tmp_path / "port", 9, like, extra={"arch": "granite"})
    _same_bits(like, JCM.restore(tmp_path / "port", 9, _moe_state(moment)))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m",
                                  "whisper-tiny"])
def test_serve_cli_takes_the_arch(arch, capsys):
    SV.main(["--arch", arch, "--device", "cpu", "--requests", "2",
             "--max-new", "2"])
    out = capsys.readouterr().out
    assert "served 2 requests, 4 tokens" in out and "on cpu" in out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-370m"])
def test_train_cli_trains_moe_and_ssm(arch, tmp_path, capsys):
    TR.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
             "--seq", "64", "--log-every", "1", "--device", "cpu",
             "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     2" in out and "done in" in out


@pytest.mark.parametrize("arch,missing", [("whisper-tiny", "frames"),
                                          ("paligemma-3b", "prefix_embeds")])
def test_train_cli_refuses_inputs_the_data_lacks(arch, missing, tmp_path):
    """The JAX launch.train fails on these at its first step (SyntheticLM
    yields no frames or prefix embeddings); the port refuses them by
    name."""
    with pytest.raises(ValueError, match=missing):
        TR.build_trainer(get_config(arch).reduced(), device="cpu")
    with pytest.raises(ValueError, match=missing):
        TR.main(["--arch", arch, "--reduced", "--steps", "1", "--device",
                 "cpu", "--ckpt-dir", str(tmp_path)])


def test_accumulated_moe_step_is_the_mean_of_its_microbatches():
    """accum_steps=2 on an MoE config: routing, capacity and the aux loss
    are per microbatch (as in the JAX package's scan), so the step's loss
    and gradients are the means of the two halves'. (Against the JAX
    package the MoE train step is held by the reference, 15a: on these
    uniform tokens a float32 near-tie already routes a token otherwise in
    layer 0.)"""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    tree = convert.numpy_params(cfg, 0)
    batch = steps._on_device(_batch(cfg, seed=2), "cpu")
    grad_fn = steps._value_and_grad(steps._forward_loss(cfg))
    halves = [grad_fn(convert.tree_from_jax(tree, "cpu"),
                      {k: v[i:i + 1] for k, v in batch.items()})
              for i in range(2)]
    from repro_torch.optim import adamw

    params = convert.tree_from_jax(tree, "cpu")
    state = {"params": params, "opt": adamw.init_state(params, AdamWConfig())}
    _, m = steps.make_train_step(cfg, AdamWConfig(), accum_steps=2)(state,
                                                                    batch)
    want = (float(halves[0][0][0]) + float(halves[1][0][0])) / 2
    np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-6)
    g = [dict(sorted_leaves(h[1])) for h in halves]
    norm = sum(float(torch.sum(((a + g[1][p]) / 2) ** 2))
               for p, a in g[0].items()) ** 0.5
    np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-5)

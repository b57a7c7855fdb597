"""How well-conditioned the other layer kinds are, on the reference weights
(``experiments/layers/reference.json``'s configs: granite-moe-1b-a400m,
mamba2-370m, jamba-1.5-large-398b, whisper-tiny and paligemma-3b, each
``.reduced()``, the file's numpy weights, prompt and inputs).

(A) float32, per config: the prefill's last-token logits, the
teacher-forced decode continuing from a prefill's caches (the file's
``decode_logits``) and the train step's gradients, from the JAX package
(jitted), the port, and a float64 evaluation by the port of the same
weights: the largest logit gap of each pair, and per gradient leaf max
|delta| / max |g| (worst leaf). The float64 run promotes every product
(the port's ``einsum_f32`` is swapped for a promoting product) and keeps
every ``.float()`` in float64 (``Tensor.float`` is swapped for
``Tensor.double`` while it runs); the bf16 casts of the prefill's caches
(attention k/v, the SSM conv tail) stay, as in both packages.

(A') float32 decode from a prefill's caches, per config: the largest
logit change when every weight moves by 2^-22 relative noise (8 draws,
a float32 round-off's size). The prefill writes its k/v caches in bf16,
so such a move re-rounds the few cache entries that sit next to a bf16
rounding boundary, as another float32 implementation's round-off does;
on paligemma one such entry moves the decode logits by 4e-4, twenty
times the float32-vs-float64 gap of (A).

(B) bfloat16, per config: each gradient leaf's relative L2 distance to the
JAX package's float32 gradient (its own bf16 gap, the file's
``bf16_gap``), and, as fractions of that gap, the port's distance to the
JAX package's bf16 gradient and the JAX package's distance to itself
compiled with ``xla_allow_excess_precision`` off (XLA by default may skip
a bf16 rounding between two ops; both evaluations are bf16 programs);
the same three distances for the loss and the gradients' global norm.

(B') bfloat16 logits, per config: the prefill's last-token logits and the
decode from a prefill's caches, the port against the JAX package, and the
JAX package against itself with excess precision off.

(C) routing, per config and dtype: per MoE layer of the full prompt's
prefill (in the order they run), the largest router-probability gap
between the port and the JAX package, and the tokens routed to another
expert set with their file margins; the smallest top-k margin, and how
many token-layers fall below each dtype's margin threshold.

(D) the controls of chip_smoke.py 15a's bfloat16 train-step rule, per
config, on the port's CPU step: the port's bf16 gradients as a fraction
of each leaf's tolerance (largest), zero and negated gradients as
multiples of it (smallest), the port's float32 gradients' leaves as a
fraction of it (largest: a distance to the bf16 file cannot reject them),
the whole gradient's distance from the float32 file over the whole bf16
gap for the port's bf16 and float32 gradients (against the floor), and
the loss's distance to the file for both, against its tolerance.

It imports both packages and runs on the CPU (~5 min)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/layers/conditioning.py [arch ...]
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import moe as JM, steps as JS
from repro_torch.models import (attention, convert, encdec, ssm, steps,
                                transformer)
from repro_torch.models.common import sorted_leaves, tree_map, unflatten

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


mk = _load("layers_make_reference", HERE / "make_reference.py")
smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
REF = json.loads((HERE / "reference.json").read_text())


def _promoting(eq, *ops):
    dt = torch.float32
    for t in ops:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


class float64:
    """The port evaluated in float64 (see the module docstring)."""

    def __enter__(self):
        self.saved = (torch.Tensor.float, attention.einsum_f32,
                      ssm.einsum_f32, steps._checked)
        torch.Tensor.float = torch.Tensor.double
        attention.einsum_f32 = ssm.einsum_f32 = _promoting
        steps._checked = lambda cfg, model: None
        return self

    def __exit__(self, *exc):
        (torch.Tensor.float, attention.einsum_f32, ssm.einsum_f32,
         steps._checked) = self.saved


def port_logits(cfg, tree, dtype):
    """(prefill's last-token logits, decode-from-prefill logits) of the
    port with its weights in ``dtype``."""
    model = convert.from_jax_params(cfg, tree, "cpu").to(dtype)
    toks = np.asarray(REF["configs"][cfg.arch]["prompt"], np.int32)
    extra = smoke._layers_extra(cfg, toks.shape[0], REF["input_seed"])
    batch = smoke._layers_batch(cfg, toks, extra, dtype, "cpu")
    logits, _ = steps.make_prefill_step(cfg)(model, batch)
    dec = smoke._decode_from_prefill(cfg, model, batch, REF["half"],
                                     REF["decode_at"], "cpu")
    return logits[:, 0].double().numpy(), dec.astype(np.float64)


def port_grads(cfg, tree, dtype):
    """The port's gradients of the train step's loss with every leaf in
    ``dtype`` (no cast to ``param_dtype``: the float64 evaluation)."""
    paths, leaves = zip(*sorted_leaves(tree))
    leaves = [torch.from_numpy(a.copy()).to(dtype).requires_grad_()
              for a in leaves]
    p = unflatten(dict(zip(paths, leaves)))
    batch = smoke._layers_train_batch(cfg, REF["train"], "cpu")
    batch = {k: (v.to(dtype) if v.is_floating_point() else v)
             for k, v in batch.items()}
    if cfg.is_encdec:
        hidden, aux = encdec.forward(p, batch["frames"], batch["tokens"], cfg)
    else:
        hidden, aux = transformer.forward(
            p, batch["tokens"], cfg, prefix_embeds=batch.get("prefix_embeds"))
    loss, _ = transformer.lm_loss(p, hidden, batch["labels"], cfg, aux)
    grads = torch.autograd.grad(loss, leaves)
    return {path: g.double().numpy() for path, g in zip(paths, grads)}


def port_bf16_grads(cfg, tree):
    """(loss, gradients) of the port's bfloat16 step."""
    params = tree_map(lambda a: torch.from_numpy(a.copy()), tree)
    batch = smoke._layers_train_batch(cfg, REF["train"], "cpu")
    (loss, _), grads = steps._value_and_grad(steps._forward_loss(cfg))(
        params, batch)
    return float(loss), {p: g.double().numpy() for p, g in sorted_leaves(grads)}


def jax_grads(cfg, tree, strict=False, with_loss=False):
    batch = {k: jnp.asarray(v) for k, v in mk.train_batch(cfg).items()}
    fn = jax.value_and_grad(JS._forward_loss(cfg), has_aux=True)
    opts = ({"compiler_options": {"xla_allow_excess_precision": False}}
            if strict else {})
    (loss, _), g = jax.jit(fn, **opts)(jax.tree.map(jnp.asarray, tree), batch)
    g = {p: np.asarray(x, np.float64) for p, x in mk._leaves(g).items()}
    return (float(loss), g) if with_loss else g


def worst(a, b):
    gaps = {p: float(np.abs(a[p] - b[p]).max() / np.abs(b[p]).max())
            for p in b}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def float32_gaps(arch):
    cfg = mk.config(arch, "float32")
    tree = mk.conditioned_params(cfg)
    want = REF["configs"][arch]["float32"]
    jp = mk.decode_array(want["prefill_logits"])
    jd = mk.decode_array(want["decode_logits"])
    p32, d32 = port_logits(cfg, tree, torch.float32)
    with float64():
        p64, d64 = port_logits(cfg, tree, torch.float64)
        g64 = port_grads(cfg, tree, torch.float64)
    g32 = port_grads(cfg, tree, torch.float32)
    gj = jax_grads(cfg, tree)

    def gap(a, b):
        return float(np.abs(a - b).max())

    print(f"  {arch}: prefill logits JAX f32 vs f64 {gap(jp, p64):.3g}, "
          f"port f32 vs f64 {gap(p32, p64):.3g}, port vs JAX "
          f"{gap(p32, jp):.3g}; decode from prefill JAX {gap(jd, d64):.3g}, "
          f"port {gap(d32, d64):.3g}, port vs JAX {gap(d32, jd):.3g}; "
          f"gradients (max |delta| / max |g|, worst leaf) JAX f32 vs f64 "
          "%.3g (%s), port f32 vs f64 %.3g (%s), port vs JAX %.3g (%s)"
          % (*worst(gj, g64), *worst(g32, g64), *worst(g32, gj)))


def flip_gaps(arch, draws=8):
    cfg = mk.config(arch, "float32")
    tree = mk.conditioned_params(cfg)
    _, base = port_logits(cfg, tree, torch.float32)
    got = []
    for i in range(draws):
        rng = np.random.default_rng(100 + i)
        moved = tree_map(lambda a: a * (1 + np.float32(2.0 ** -22) * rng.
                                        standard_normal(a.shape, np.float32)),
                         tree)
        got.append(float(np.abs(port_logits(cfg, moved, torch.float32)[1]
                                - base).max()))
    print(f"  {arch}: decode from prefill, largest change over {draws} "
          f"draws {max(got):.3g} (each: {', '.join(f'{g:.2g}' for g in got)})")


def bf16_gaps(arch):
    c32, c16 = mk.config(arch, "float32"), mk.config(arch, "bfloat16")
    tree = mk.conditioned_params(c32)
    l32, g32 = jax_grads(c32, tree, with_loss=True)
    l16, g16 = jax_grads(c16, tree, with_loss=True)
    ls, strict = jax_grads(c16, tree, strict=True, with_loss=True)
    lp, port = port_bf16_grads(c16, tree)

    def rel(a, b, ref):
        return float(np.linalg.norm(a - b) / np.linalg.norm(ref))

    def norm(g):
        return float(np.sqrt(sum(np.sum(x ** 2) for x in g.values())))

    rows = {p: (rel(g16[p], g32[p], g32[p]), rel(port[p], g16[p], g32[p]),
                rel(strict[p], g16[p], g32[p])) for p in g32}
    n32, n16, np_, ns = norm(g32), norm(g16), norm(port), norm(strict)
    print(f"  {arch}: {len(rows)} leaves, bf16 gaps "
          f"{min(r[0] for r in rows.values()):.3g}-"
          f"{max(r[0] for r in rows.values()):.3g}; as a fraction of each "
          f"leaf's gap, the port's distance to the JAX bf16 at most "
          f"{max(r[1] / r[0] for r in rows.values()):.3g}, the JAX "
          f"package's strict-rounding bf16 at most "
          f"{max(r[2] / r[0] for r in rows.values()):.3g}; loss gap "
          f"{abs(l16 - l32):.3g}, port vs JAX {abs(lp - l16):.3g}, strict "
          f"vs default {abs(ls - l16):.3g}; gradient norm gap "
          f"{abs(n16 - n32):.3g} of {n32:.5g}, port vs JAX "
          f"{abs(np_ - n16):.3g}, strict vs default {abs(ns - n16):.3g}")


def _strict_jit(fn, **kw):
    return _JIT(fn, compiler_options={"xla_allow_excess_precision": False},
                **kw)


_JIT = jax.jit


def bf16_logits(arch):
    cfg = mk.config(arch, "bfloat16")
    tree = mk.conditioned_params(cfg)
    want = REF["configs"][arch]["bfloat16"]
    jp = mk.decode_array(want["prefill_logits"])
    jd = mk.decode_array(want["decode_logits"])
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    toks = mk.prompt(cfg)
    extra = mk.extra_inputs(cfg, toks.shape[0], mk.INPUT_SEED)
    mk.jax.jit = _strict_jit
    try:
        sp, _ = jax.jit(JS.make_prefill_step(cfg))(
            params, mk._inputs(cfg, toks, extra, jnp.bfloat16))
        sd = mk.decode_from_prefill(cfg, params, toks, extra, jnp.bfloat16)
    finally:
        mk.jax.jit = _JIT
    sp = np.asarray(sp[:, 0].astype(jnp.float32))
    pp, pd = port_logits(cfg, tree, torch.bfloat16)

    def gap(a, b):
        return float(np.abs(a - b).max())

    print(f"  {arch}: prefill logits port vs JAX {gap(pp, jp):.3g}, JAX "
          f"strict vs default {gap(sp, jp):.3g}; decode from prefill port "
          f"vs JAX {gap(pd, jd):.3g}, JAX strict vs default {gap(sd, jd):.3g}")


def routing(arch):
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        cfg = mk.config(arch, name)
        if not cfg.n_experts:
            return
        tree = mk.conditioned_params(cfg)
        toks = mk.prompt(cfg)
        extra = mk.extra_inputs(cfg, toks.shape[0], mk.INPUT_SEED)
        got = []
        route = JM._route

        def recording(xf, router, e_real, e_pad, k):
            out = route(xf, router, e_real, e_pad, k)
            jax.debug.callback(lambda p: got.append(np.asarray(p)),
                               jax.nn.softmax(xf @ router, axis=-1),
                               ordered=True)
            return out

        JM._route = recording
        try:
            jax.block_until_ready(jax.jit(JS.make_prefill_step(cfg))(
                jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), tree),
                mk._inputs(cfg, toks, extra, jdt)))
            jax.effects_barrier()
        finally:
            JM._route = route
        model = steps.cast_model(cfg, convert.from_jax_params(cfg, tree,
                                                              "cpu"))
        with smoke._RouteRecorder() as rr:
            steps.make_prefill_step(cfg)(model, smoke._layers_batch(
                cfg, toks, extra, tdt, "cpu"))
        layers = []
        for (idx, p), q in zip(rr.calls, got):
            m = smoke._margins(q, cfg.top_k)
            jidx = np.argsort(-q, axis=1, kind="stable")[:, :cfg.top_k]
            moved = np.flatnonzero((np.sort(idx, 1) != np.sort(jidx, 1))
                                   .any(1))
            layers.append(f"{float(np.abs(p - q).max()):.3g}"
                          + (f" (tokens routed otherwise at margins "
                             f"{', '.join(f'{x:.2g}' for x in m[moved])})"
                             if moved.size else ""))
        margins = np.concatenate([smoke._margins(q, cfg.top_k) for q in got])
        thr = smoke.ROUTE_MARGIN[name]
        print(f"  {arch} {name}: router probabilities port vs JAX per MoE "
              f"layer at most " + "; ".join(layers) + f"; {got[0].shape[0]} "
              f"tokens a layer; smallest top-{cfg.top_k} margin "
              f"{margins.min():.3g}; {int((margins <= thr).sum())} of "
              f"{margins.size} token-layers at or below the threshold "
              f"{thr:.3g}")


def controls(arch):
    rec = REF["configs"][arch]
    want, f32 = rec["bfloat16"]["train"], rec["float32"]["train"]
    tol_of, loss_tol, _ = smoke._layers_bf16_tols(arch, want, f32)
    seed = REF["sketch_seed"]
    got = {}
    for name in ("bfloat16", "float32"):
        cfg = mk.config(arch, name)
        params = tree_map(lambda a: torch.from_numpy(a.copy()),
                          mk.conditioned_params(cfg))
        batch = smoke._layers_train_batch(cfg, REF["train"], "cpu")
        (loss, _), g = steps._value_and_grad(steps._forward_loss(cfg))(
            params, batch)
        got[name] = (float(loss), dict(sorted_leaves(g)))

    def leaf(g, p):
        r = want["grads"][p]
        sk = smoke._sketch(g, p, len(r["sketch"]), seed)
        return float(np.linalg.norm(sk - np.asarray(r["sketch"]))
                     / r["norm"]) / tol_of(p)

    def whole(g):
        sq = sum(float(np.sum((smoke._sketch(g[p], p, len(r["sketch"]), seed)
                               - np.asarray(r["sketch"])) ** 2))
                 for p, r in f32["grads"].items())
        return (sq / sum(r["norm"] ** 2 for r in f32["grads"].values())
                ) ** 0.5 / smoke._whole_gap(want, f32)

    (l16, g16), (l32, g32) = got["bfloat16"], got["float32"]
    off = want["step"]["value_and_grad_loss"]
    print(f"  {arch}: {len(g16)} leaves; of each leaf's tolerance the "
          f"port's bf16 at most {max(leaf(g, p) for p, g in g16.items()):.3g},"
          f" zero at least {min(leaf(torch.zeros_like(g), p) for p, g in g16.items()):.3g}"
          f" x, negated at least {min(leaf(-g, p) for p, g in g16.items()):.3g} x,"
          f" float32 at most {max(leaf(g, p) for p, g in g32.items()):.3g}; "
          f"whole gradient from the float32 file over the whole gap "
          f"{smoke._whole_gap(want, f32):.3g}: bf16 {whole(g16):.3g}, float32 "
          f"{whole(g32):.2e} (floor {smoke.BF16_ROUNDING_FLOOR}); loss off "
          f"the file: bf16 {abs(l16 - off):.3g}, float32 {abs(l32 - off):.3g}"
          f" (tol {loss_tol:.3g})")


def main(archs):
    torch.set_num_threads(4)
    print("(A) float32: largest logit gaps, gradients' worst leaf")
    for arch in archs:
        float32_gaps(arch)
    print("(A') float32 decode under round-off-sized weight moves")
    for arch in archs:
        flip_gaps(arch)
    print("(B) bfloat16 gradients: distances as fractions of each leaf's "
          "own bf16-vs-f32 gap")
    for arch in archs:
        bf16_gaps(arch)
    print("(B') bfloat16 logits: largest gaps")
    for arch in archs:
        bf16_logits(arch)
    print("(C) routing")
    for arch in archs:
        routing(arch)
    print("(D) the controls of 15a's bfloat16 train-step rule")
    for arch in archs:
        controls(arch)


if __name__ == "__main__":
    main(sys.argv[1:] or list(mk.ARCHS))

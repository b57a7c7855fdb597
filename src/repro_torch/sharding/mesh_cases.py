"""The port's side of ``experiments/sharding/make_reference.py``'s mesh
cases, as rank bodies for ``core.analysis.distributed.launch_mesh``.

`run` is one rank of a mesh of four (``launch_mesh(run, 4, ...)``): on
named meshes over those ranks it computes, under the names the reference
uses, the arrays of every case: the blocks' sha256 (``blocks/...``), the
expert-parallel MoE and its gradients (``ep/...``), the seq-sharded decode
and the gathered decode on the same inputs (``decode/...``,
``decode_gathered/...``), ``pipeline_apply`` and its gradients
(``pipeline/...``), two compressed steps (``compressed/...``), two
sharded train steps with the first step's gradients (``train/...``) and,
in the ``tp`` part, serving on this rank's blocks: each `TP_CASES`
config's prefill and decode steps (``tp/...``) beside the port's
unsharded steps on the whole weights (``tp_plain/...``), each rank's
storage bytes (``tp_bytes/...``) and one decode step's collectives
(``tp_ops/...``).
Outputs and gradients are gathered whole; rank 0 returns them with each
part's wall time. `pod_exchange` runs `steps.pod_reduce` on given
gradients and errors (one pod a rank). ``tests/test_torch_sharding_mesh.py``
holds them to the JAX package on the CPU, ``chip_smoke.py`` phase 16a to
``experiments/sharding/reference.json`` on the card. The inputs are the
reference's: the constants and numpy rules below are copies of its.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as tdist

__all__ = ["run", "pod_exchange", "EP_X", "DECODE", "PIPELINE",
           "COMPRESSED_CUT", "DATA", "STEPS", "TRAIN_ARCHS", "EP_CUT", "SEED",
           "TP", "TP_CASES", "tp_config", "tp_tokens", "tp_start_caches"]

SEED = 0
EP_CUT = dict(d_model=64, moe_d_ff=32)
EP_X = {"fsdp_local": (4, 16), "sharded": (4, 16), "padded": (2, 16),
        "tiny_batch": (1, 16), "no_seq_split": (4, 1), "dropping": (4, 16)}
DECODE = {"batch": 2, "smax": 64, "pos": (0, 15, 16, 31, 32, 47, 48, 63)}
PIPELINE = {"stages_micro": (6, 3, 16), "meshes": {"4x1": (4, 1),
                                                   "2x2": (2, 2)}}
COMPRESSED_CUT = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=128,
                      param_dtype="float32")
DATA = {"seed": 3, "batch": 4, "seq": 32}
STEPS = 2
TRAIN_ARCHS = ("gemma-2b", "granite-moe-1b-a400m")
#: serving on blocks: a batch of 2, an 8-token prompt prefilled, padded to
#: a 16-slot window, then 8 teacher-forced decode steps
TP = {"batch": 2, "prompt": 8, "max_len": 16, "steps": 8, "seed": 7}
#: case: (arch, (data, model), overrides of its ``.reduced()`` config; two
#: layers, so that every array of a case is whole in the reference file).
#: MHA: phi3 with 4 kv heads (1 q and 1 kv head a rank on (1, 4), 2 and 2
#: with FSDP on (2, 2)); GQA with qkv bias: qwen's 4 q / 2 kv heads on
#: (2, 2); MQA: gemma's one kv head, heads replicated and the cache's
#: sequence over model under each decode form; MoE: granite's 4 experts
#: over model (no drops at capacity factor 8), FSDP over data
TP_CASES = {
    "mha_1x4": ("phi3-mini-3.8b", (1, 4), {"n_layers": 2, "n_kv_heads": 4}),
    "mha_2x2": ("phi3-mini-3.8b", (2, 2), {"n_layers": 2, "n_kv_heads": 4}),
    "gqa_bias_2x2": ("qwen1.5-32b", (2, 2), {"n_layers": 2}),
    "mqa_gathered_1x4": ("gemma-2b", (1, 4), {"n_layers": 2}),
    "mqa_sharded_1x4": ("gemma-2b", (1, 4), {"n_layers": 2,
                                             "decode_attention": "sharded"}),
    "moe_2x2": ("granite-moe-1b-a400m", (2, 2), {"n_layers": 2,
                                                 "capacity_factor": 8.0}),
}


# -- inputs (the reference's rules) ---------------------------------------------------

def numpy_tree(specs, seed: int = SEED) -> Dict:
    """The serving reference's weight rule on any spec tree."""
    from ..models.common import tree_leaves, unflatten

    rng = np.random.default_rng(seed)
    flat = dict(tree_leaves(specs))
    return unflatten({p: rng.standard_normal(flat[p].shape, np.float32)
                      * np.float32(flat[p].stddev() if flat[p].init
                                    == "normal" else 0.1)
                      for p in sorted(flat)})


def ep_config(case: str):
    from ..configs import get_config

    if case == "padded":
        cfg = get_config("granite-moe-3b-a800m").reduced(
            n_experts=6, top_k=2, **EP_CUT)
    else:
        cfg = get_config("granite-moe-1b-a400m").reduced(**EP_CUT)
    return dataclasses.replace(
        cfg, capacity_factor=1.0 if case == "dropping" else 8.0)


def ep_mesh(case: str):
    if case == "padded":
        return (1, 4), ("data", "model"), False
    return (2, 2), ("data", "model"), case in ("fsdp_local", "no_seq_split")


def ep_inputs(case: str):
    from ..models import moe

    cfg = ep_config(case)
    b, s = EP_X[case]
    x = np.random.default_rng(1).standard_normal(
        (b, s, cfg.d_model), np.float32) * np.float32(0.5)
    return cfg, numpy_tree(moe.param_specs(cfg)), x


def decode_config(cache: str):
    from ..configs import get_config

    return dataclasses.replace(
        get_config("gemma-2b").reduced(), param_dtype="float32",
        decode_attention="sharded",
        kv_cache_dtype="int8" if cache == "int8" else "bfloat16")


def decode_inputs(cache: str):
    from ..models import convert

    cfg = decode_config(cache)
    rng = np.random.default_rng(2)
    p = {k: v[0] for k, v in convert.conditioned_params(cfg, SEED)[
        "layers"]["l0"]["attn"].items()}
    b, smax = DECODE["batch"], DECODE["smax"]
    x = rng.standard_normal((b, 1, cfg.d_model), np.float32)
    shape = (b, smax, cfg.n_kv_heads, cfg.head_dim)
    if cache == "int8":
        c = {"k": rng.integers(-127, 128, shape).astype(np.int8),
             "v": rng.integers(-127, 128, shape).astype(np.int8),
             "k_scale": (rng.random(shape[:3] + (1,), np.float32) * 0.02
                         + 0.001),
             "v_scale": (rng.random(shape[:3] + (1,), np.float32) * 0.02
                         + 0.001)}
    else:
        c = {"k": rng.standard_normal(shape, np.float32),
             "v": rng.standard_normal(shape, np.float32)}
    return cfg, p, x, c


def tp_config(case: str):
    from ..configs import get_config

    arch, _, over = TP_CASES[case]
    return dataclasses.replace(get_config(arch).reduced(**over),
                               param_dtype="float32")


def tp_tokens(cfg) -> np.ndarray:
    """(batch, prompt + steps) int32: the prompt, then the decode steps'
    teacher-forced tokens."""
    rng = np.random.default_rng(TP["seed"])
    return rng.integers(0, cfg.vocab_size,
                        (TP["batch"], TP["prompt"] + TP["steps"]),
                        dtype=np.int32)


def pipeline_weights(stages: int):
    m, mb, d = PIPELINE["stages_micro"]
    rng = np.random.default_rng(4)
    w = rng.standard_normal((stages, d, d), np.float32) * np.float32(0.3)
    b = rng.standard_normal((stages, d), np.float32) * np.float32(0.1)
    x = rng.standard_normal((m, mb, d), np.float32)
    return w, b, x


def compressed_config():
    from ..configs import get_config

    return get_config("gemma-2b").reduced(**COMPRESSED_CUT)


def train_config(arch: str):
    from ..configs import get_config

    return dataclasses.replace(get_config(arch).reduced(),
                               param_dtype="float32")


def train_weights(arch: str) -> Dict:
    from ..models import convert

    return convert.conditioned_params(train_config(arch), SEED)


def train_batches(cfg, n: int = STEPS) -> list:
    from ..data import DataConfig, SyntheticLM

    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=DATA["seq"],
                                 global_batch=DATA["batch"],
                                 seed=DATA["seed"]))
    return [src.batch_at(i) for i in range(n)]


# -- helpers -------------------------------------------------------------------------

def _t(tree, dev):
    from ..models.common import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def _np(t) -> np.ndarray:
    from ..models.common import host_array

    t = t.detach()
    return host_array(t.float() if t.dtype == torch.bfloat16 else t)


def _flat(tree) -> Dict:
    from ..models.common import sorted_leaves

    return dict(sorted_leaves(tree))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh(shape, axes, dev):
    from ..launch.mesh import make_debug_mesh

    return make_debug_mesh(shape, axes, device=dev)


# -- the cases -----------------------------------------------------------------------

def _blocks(out, dev):
    from ..configs import get_config
    from ..models import steps
    from . import make_plan
    from .partition import gather_tree, shard_tree, train_state_shardings

    cfg = get_config("granite-moe-1b-a400m").reduced()
    tree = _t(numpy_tree(steps.model_param_specs(cfg)), dev)
    mine = {}
    for layout, (shape, axes, fsdp) in {
            "2x2": ((2, 2), ("data", "model"), True),
            "pod_data": ((2, 2, 1), ("pod", "data", "model"), "pod_data")
    }.items():
        mesh = _mesh(shape, axes, dev)
        plan = make_plan(cfg, mesh, fsdp=fsdp)
        specs = train_state_shardings(cfg, plan)["params"]
        blocks = shard_tree(tree, specs, mesh)
        c = "".join(str(mesh.coords[a]) for a in axes)
        for path, t in _flat(blocks).items():
            mine[f"blocks/{layout}/{c}/{path}"] = hashlib.sha256(
                np.ascontiguousarray(_np(t)).tobytes()).hexdigest()
        whole = gather_tree(blocks, specs, mesh)
        mine[f"roundtrip/{layout}/{c}"] = all(
            torch.equal(a, _flat(tree)[p]) for p, a in _flat(whole).items())
    everyone = [None] * tdist.get_world_size()
    tdist.all_gather_object(everyone, mine)
    for rec in everyone:
        for k, v in rec.items():
            out[k] = np.array(v)


def _ep(out, dev):
    from ..models import moe
    from . import comm, make_plan
    from .partition import activation_ctx, batch_axis, block, gather_leaf
    from .rules import P

    for case in EP_X:
        cfg, p, x = ep_inputs(case)
        shape, axes, fsdp = ep_mesh(case)
        mesh = _mesh(shape, axes, dev)
        plan = make_plan(cfg, mesh, fsdp=fsdp)
        ep = mesh.shape["model"]
        sharded = cfg.n_experts % ep == 0 and plan.rules["experts"] == "model"
        wspec = P("model", None, None) if sharded else P(None, None, None)
        specs = {"router": P(None, None), "wi": wspec, "wg": wspec,
                 "wo": wspec}
        params = {k: block(v, specs[k], mesh).requires_grad_()
                  for k, v in _t(p, dev).items()}
        split = batch_axis(plan, x.shape[0]) is not None
        xt = torch.from_numpy(x).to(dev)
        xl = block(xt, P(plan.batch_axes if split else None), mesh)
        with activation_ctx(plan, split):
            y, aux = moe.moe(params, xl, cfg)
            sq = torch.sum(y ** 2)
            loss = comm.psum(sq, mesh, plan.batch_axes if split else None)
            names = sorted(params)
            grads = torch.autograd.grad(loss * (1.0 / mesh.size),
                                        [params[k] for k in names])
        grads = comm.reduce_grads(dict(zip(names, grads)), specs, mesh)
        out[f"ep/{case}/out"] = _np(gather_leaf(
            y.detach(), P(plan.batch_axes if split else None), mesh))
        out[f"ep/{case}/aux"] = _np(aux)
        for k in names:
            out[f"ep/{case}/grad/{k}"] = _np(gather_leaf(grads[k], specs[k],
                                                         mesh))


def _decode(out, dev):
    from ..models import attention
    from . import make_plan
    from .partition import activation_ctx, block, gather_leaf
    from .rules import P

    for cache in ("float32", "int8"):
        cfg, p, x, c = decode_inputs(cache)
        mesh = _mesh((1, 4), ("data", "model"), dev)
        plan = make_plan(cfg, mesh)
        pt, xt = _t(p, dev), torch.from_numpy(x).to(dev)
        spec = P(plan.batch_axes, "model", None, None)
        for pos in DECODE["pos"]:
            whole = {k: torch.from_numpy(v.copy()).to(dev).to(
                torch.bfloat16 if k.endswith("scale") else None)
                for k, v in c.items()}
            mine = {k: block(v, spec, mesh) for k, v in whole.items()}
            with torch.no_grad(), activation_ctx(plan, True):
                y, new = attention.decode_attention(pt, xt, mine, pos, cfg)
            key = f"decode/{cache}/{pos}"
            out[f"{key}/out"] = _np(y)
            for k, v in new.items():
                out[f"{key}/{k}"] = _np(gather_leaf(v, spec, mesh))
            with torch.no_grad():
                y, _ = attention.decode_attention(pt, xt, whole, pos, cfg)
            out[f"decode_gathered/{cache}/{pos}/out"] = _np(y)


def _stage(params, xm):
    wi, bi = params
    return torch.tanh(xm @ wi + bi)


def _pipeline(out, dev):
    from . import comm, pipeline_apply
    from .partition import block, gather_leaf
    from .rules import P

    for name, shape in PIPELINE["meshes"].items():
        mesh = _mesh(shape, ("pod", "data"), dev)
        w, b, x = pipeline_weights(shape[0])
        wl = block(torch.from_numpy(w).to(dev), P("pod"), mesh)
        bl = block(torch.from_numpy(b).to(dev), P("pod"), mesh)
        wl.requires_grad_()
        bl.requires_grad_()
        y = pipeline_apply(_stage, (wl, bl), torch.from_numpy(x).to(dev),
                           mesh, "pod")
        gw, gb = torch.autograd.grad(torch.sum(y ** 2) * (1.0 / mesh.size),
                                     [wl, bl])
        g = comm.reduce_grads({"w": gw, "b": gb},
                              {"w": P("pod"), "b": P("pod")}, mesh)
        out[f"pipeline/{name}/out"] = _np(y)
        out[f"pipeline/{name}/grad_w"] = _np(gather_leaf(g["w"], P("pod"),
                                                         mesh))
        out[f"pipeline/{name}/grad_b"] = _np(gather_leaf(g["b"], P("pod"),
                                                         mesh))


def _compressed(out, dev):
    from ..models import steps
    from ..optim import AdamWConfig, adamw
    from ..optim.compression import init_error_state
    from . import make_plan

    mesh = _mesh((2, 1, 1), ("pod", "data", "model"), dev)
    if mesh is None:  # ranks past the mesh's two
        return
    cfg = compressed_config()
    params = _t(numpy_tree(steps.model_param_specs(cfg)), dev)
    opt_cfg = AdamWConfig()
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
    err = init_error_state(params)
    step = steps.make_compressed_train_step(cfg, make_plan(cfg, mesh),
                                            opt_cfg)
    for t, batch in enumerate(train_batches(cfg)):
        state, m, err = step(state, batch, err)
        for k in ("loss", "nll", "grad_norm"):
            out[f"compressed/{t}/{k}"] = _np(m[k])
    for path, v in _flat(state["params"]).items():
        out[f"compressed/params/{path}"] = _np(v)


def _train(out, dev):
    from ..models import steps
    from ..optim import AdamWConfig, adamw
    from . import make_plan
    from .partition import gather_tree, shard_tree, train_state_shardings

    for arch in TRAIN_ARCHS:
        cfg = train_config(arch)
        mesh = _mesh((2, 2), ("data", "model"), dev)
        plan = make_plan(cfg, mesh)
        specs = train_state_shardings(cfg, plan)["params"]
        tree = shard_tree(_t(train_weights(arch), dev), specs, mesh)
        batches = train_batches(cfg)
        grad_fn = steps._mesh_grad_fn(cfg, plan, specs)
        batch, split = steps._batch_block(batches[0], plan, dev)
        (loss, nll), g = grad_fn(tree, batch, split)
        out[f"train/{arch}/loss"] = _np(loss)
        out[f"train/{arch}/nll"] = _np(nll)
        for path, v in _flat(gather_tree(g, specs, mesh)).items():
            out[f"train/{arch}/grad/{path}"] = _np(v)
        del g
        opt_cfg = AdamWConfig()
        state = {"params": tree, "opt": adamw.init_state(tree, opt_cfg)}
        step = steps.make_train_step(cfg, opt_cfg, plan=plan)
        for t, batch in enumerate(batches):
            state, m = step(state, batch)
            for k in ("loss", "nll", "grad_norm", "lr"):
                out[f"train/{arch}/{t}/{k}"] = _np(m[k])
        whole = gather_tree(state["params"], specs, mesh)
        for path, v in _flat(whole).items():
            out[f"train/{arch}/params/{path}"] = _np(v)


class _Serving:
    """One case's steps on one model (this rank's blocks under ``plan``,
    or the whole model with ``plan`` None), recording whole arrays
    (gathered over the batch and the cache blocks)."""

    def __init__(self, cfg, model, toks, plan, out):
        self.cfg, self.model, self.plan, self.out = cfg, model, plan, out
        self.split = plan is not None and toks.shape[0] < TP["batch"]
        self.toks = toks

    def _specs(self, length):
        from ..models import transformer
        from .partition import serving_cache_shardings

        return serving_cache_shardings(
            self.cfg, self.plan, transformer.init_decode_caches(
                self.cfg, TP["batch"], length, device="meta"), self.split)

    def whole(self, caches, length):
        """The global caches from this rank's blocks."""
        from .partition import gather_leaf

        if self.plan is None:
            return caches
        specs = self._specs(length)
        return {name: {k: gather_leaf(t, specs[name][k], self.plan.mesh)
                       for k, t in c.items()} for name, c in caches.items()}

    def window(self, prompt_caches):
        """This rank's blocks of the decode window (float32, ``max_len``
        slots) holding the given global prompt caches (a tree of arrays)."""
        from .partition import block

        dev = self.toks.device
        pad = TP["max_len"] - TP["prompt"]
        specs = None if self.plan is None else self._specs(TP["max_len"])
        out = {}
        for name, c in prompt_caches.items():
            out[name] = {}
            for k, t in c.items():
                w = torch.nn.functional.pad(
                    torch.from_numpy(np.array(t, np.float32)).to(dev),
                    (0, 0, 0, 0, 0, pad))
                out[name][k] = (w if specs is None else
                                block(w, specs[name][k], self.plan.mesh))
        return out

    def _batch(self, t):
        from .partition import gather_leaf
        from .rules import P

        if not self.split:
            return t
        return gather_leaf(t, P(self.plan.batch_axes), self.plan.mesh)

    def prefill(self, key):
        """The prompt's prefill, its logits and caches under ``key``;
        returns this rank's cache blocks."""
        from ..models import steps
        from .partition import activation_ctx

        with activation_ctx(self.plan, self.split):
            logits, caches = steps.make_prefill_step(self.cfg)(
                self.model, {"tokens": self.toks[:, :TP["prompt"]]})
            self.out[f"{key}/prefill/logits"] = _np(self._batch(logits))
            for name, c in self.whole(caches, TP["prompt"]).items():
                for k, t in c.items():
                    self.out[f"{key}/prefill/{name}/{k}"] = _np(t)
        return caches

    def decode(self, caches, key, rec_ops=None):
        """The teacher-forced decode steps from the window ``caches``;
        each step's logits and the written window under ``key``."""
        from ..models import steps
        from .comm import record_collectives
        from .partition import activation_ctx

        pr, n = TP["prompt"], TP["steps"]
        step = steps.make_decode_step(self.cfg)
        with activation_ctx(self.plan, self.split):
            for t in range(n):
                tok = self.toks[:, pr + t:pr + t + 1]
                if t == 0 and rec_ops is not None:
                    with record_collectives() as rec:
                        _, logits, caches = step(self.model, tok, caches, pr)
                    rec_ops.extend(rec.ops)
                else:
                    _, logits, caches = step(self.model, tok, caches, pr + t)
                self.out[f"{key}/{t}/logits"] = _np(self._batch(logits))
            for name, c in self.whole(caches, TP["max_len"]).items():
                for k, t in c.items():
                    self.out[f"{key}/{name}/{k}"] = _np(t[:, :, pr:pr + n])
        return caches


def _tp(out, dev, start=None):
    """Each `TP_CASES` case on this rank's blocks (``tp/<case>/...``):
    the prefill; the decode continued from its own prefill blocks, padded
    (``continued/...``); with ``start`` ({case: the reference's prefill
    caches, whole}) the decode from those (``decode/...``, where the JAX
    decode starts: the two programs' bf16 prefill caches may round an
    entry apart, and a decode carries that). Rank 0 runs the same on the
    whole model (``tp_plain/<case>/...``), its continued decode from the
    blocks' own prefill caches gathered whole. Every rank's storage bytes
    (``tp_bytes/...``) and its first continued decode step's collectives
    (``tp_ops/...``) are all-gathered."""
    from ..models import convert, steps
    from ..models.common import tree_leaves, tree_map
    from . import make_plan
    from .partition import batch_axis, block, serving_shardings, shard_tree
    from .rules import P

    mine = {}
    for case, (_arch, shape, _over) in TP_CASES.items():
        cfg = tp_config(case)
        mesh = _mesh(shape, ("data", "model"), dev)
        plan = make_plan(cfg, mesh)
        whole = _t(convert.conditioned_params(cfg, SEED), dev)
        model = steps.make_model(
            cfg, shard_tree(whole, serving_shardings(cfg, plan), mesh), plan)
        toks = torch.from_numpy(tp_tokens(cfg)).to(dev)
        split = batch_axis(plan, toks.shape[0]) is not None
        tp = _Serving(cfg, model, block(
            toks, P(plan.batch_axes if split else None, None), mesh), plan,
            out)
        key = f"tp/{case}"
        prompt = tp.prefill(key)
        own = tree_map(lambda t: t.detach().float().cpu().numpy(),
                       tp.whole(prompt, TP["prompt"]))
        ops = []
        caches = tp.decode(tree_map(lambda t: t.float(), model.pad_caches(
            prompt, TP["max_len"])), f"{key}/continued", ops)
        if start is not None:
            tp.decode(tp.window(start[case]), f"{key}/decode")
        c = "".join(str(mesh.coords[a]) for a in mesh.axis_names)
        mine[f"tp_bytes/{case}/{c}/params"] = _storage_bytes(
            list(model.parameters()))
        mine[f"tp_bytes/{case}/{c}/caches"] = _storage_bytes(
            [t for _, t in tree_leaves(caches)])
        mine[f"tp_ops/{case}/{c}"] = [
            f"{op.kind} {'+'.join(op.axes)}" for op in ops]
        del model, caches
        if mesh.rank == 0:
            plain = _Serving(cfg, steps.make_model(cfg, whole), toks, None,
                             out)
            key = f"tp_plain/{case}"
            plain.prefill(key)
            plain.decode(plain.window(own), f"{key}/continued")
            if start is not None:
                plain.decode(plain.window(start[case]), f"{key}/decode")
    everyone = [None] * tdist.get_world_size()
    tdist.all_gather_object(everyone, mine)
    for rec in everyone:
        for k, v in rec.items():
            out[k] = np.array(v)


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors`` (a block's layers
    are views of its stacked leaves)."""
    return sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in tensors}.values())


PARTS = {"blocks": _blocks, "ep": _ep, "decode": _decode,
         "pipeline": _pipeline, "compressed": _compressed, "train": _train,
         "tp": _tp}
#: the parts of ``experiments/sharding/reference.json``'s mesh cases before
#: serving on blocks (``tp``, run on its own)
BASE_PARTS = ("blocks", "ep", "decode", "pipeline", "compressed", "train")


def run(mesh, parts=BASE_PARTS, tp_start=None) -> Dict:
    """One rank of four: every case of ``parts``; rank 0 returns
    ``(arrays, {part: wall seconds})``. ``tp_start``: the ``tp`` part's
    shared decode start (`tp_start_caches` of the reference file)."""
    from ..models import steps

    dev = mesh.device
    if dev.type == "cuda":
        steps.set_exact_gemms()
    out, walls = {}, {}
    for name in parts:
        _sync(dev)
        tdist.barrier()
        t0 = time.perf_counter()
        if name == "tp":
            _tp(out, dev, tp_start)
        else:
            PARTS[name](out, dev)
        _sync(dev)
        walls[name] = time.perf_counter() - t0
    return out, walls


def tp_start_caches(arrays: Dict) -> Dict:
    """{case: the reference's prefill caches, whole} from its ``tp/<case>/
    prefill/<l>/<k>`` arrays (``experiments/sharding/reference.json``'s
    mesh part, decoded): `run`'s ``tp_start``."""
    from ..models.common import unflatten

    out = {}
    for case in TP_CASES:
        head = f"tp/{case}/prefill/"
        out[case] = unflatten({k[len(head):]: np.asarray(v, np.float32)
                               for k, v in arrays.items()
                               if k.startswith(head) and not
                               k.endswith("/logits")})
    return out


def pod_exchange(mesh, grads: Dict, errs: Dict) -> Dict:
    """`steps.pod_reduce` on this pod's ``grads[pod]`` and ``errs[pod]``
    (numpy trees by path); every pod's results come back from pod 0:
    {pod: {path: (mean, new error, codes, scale, all codes)}}."""
    from ..models import steps

    pod = mesh.coords["pod"]
    dev = mesh.device
    mine = {}
    with torch.no_grad():
        for path in sorted(grads[pod]):
            g = torch.from_numpy(np.array(grads[pod][path])).to(dev)
            e = torch.from_numpy(np.array(errs[pod][path])).to(dev)
            mine[path] = tuple(_np(t) for t in steps.pod_reduce(g, e, mesh))
    everyone = [None] * mesh.shape["pod"]
    group, _ = mesh.group("pod")
    tdist.all_gather_object(everyone, mine, group=group)
    return dict(enumerate(everyone))

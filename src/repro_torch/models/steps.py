"""Train / prefill / decode step factories.

The port of the JAX package's ``models/steps.py``.

Training: `init_train_state` draws the float32 master on the device from
an explicit generator, with the AdamW state beside it (``{"params",
"opt": {"m", "v", "step"}}``, the JAX layout). `make_train_step`'s step
casts the master to ``cfg.param_dtype`` on every call inside autograd, as
the JAX loss does, so the gradients reach the float32 master through the
cast; microbatches (``accum_steps``) are summed into an ``accum_dtype``
accumulator; the metrics are device scalars, read by no host sync in the
step. The step updates the state's tensors in place and returns it (a
jitted JAX step with its state donated does the same): the caller keeps
no reference to the old state.

Serving: under a plan the prefill and decode steps run on this rank's
blocks of the weights and caches (`make_model(cfg, blocks, plan)`, the
steps inside ``partition.activation_ctx(plan, split)``;
``models.transformer``). The JAX steps cast the params to
``cfg.param_dtype`` on every call (a no-op in its serve path, whose params are bf16 already); here the
model is cast once when it is built (`cast_model`) and a step refuses a
model in another dtype, so no step re-casts the weights (5 GB a token at
gemma-2b's full width).

Under a sharding plan (``make_train_step(..., plan=)``, what
``launch.train`` builds on a mesh) the state is this rank's blocks
(``sharding.partition.shard_tree`` of the master, ``m`` and ``v``) and the
batch splits over ``plan.batch_axes``. The loss casts the master blocks
to ``cfg.param_dtype`` and gathers each cast leaf over its spec's axes
before use (the bf16 cast, not the float32 master, as the reference pins
the cast copy to the master's sharding): the top-level leaves once, each
layer's inside its remat (`transformer.forward`'s and
``encdec.forward``'s ``gather_layer``). Every config gathers over every
axis but ``model`` (FSDP's ``embed``) and computes on its ``model``
blocks, as XLA partitions the reference under ``train_state_shardings``:
heads, the MLP, the SSD's heads and inner width and the experts over
``model``, their partial sums reduced, each residual stream between the
layers (a prefix's positions included; an encoder-decoder's encoder
stream over its frames and decoder stream over its tokens) the rank's
block of the sequence over ``plan.seq_axis``
(``partition.seq_axis_for``), the loss vocab-parallel. The loss and nll
are
global-batch means on every rank; the gradients follow
``sharding.comm``'s partial convention (the loss over ``mesh.size``, then
each leaf summed over the axes its spec does not name), so each rank ends
with its block of the global gradient; the global norm counts each block
once; AdamW updates the rank's blocks. `make_compressed_train_step`
exchanges int8 gradients over a ``pod`` axis with error feedback.

Every step refuses a CUDA model while cuBLAS may round its GEMMs
(`exact_gemms`): the JAX package's bf16 products accumulate in float32
and its float32 products (the flash backward's) are IEEE float32.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import encdec, transformer
from .common import init_params, sorted_leaves, tree_map, unflatten
from ..optim import AdamWConfig, adamw

__all__ = ["make_train_step", "make_compressed_train_step", "pod_reduce",
           "make_prefill_step", "make_decode_step", "init_train_state",
           "cast_model", "model_param_specs", "exact_gemms",
           "set_exact_gemms", "make_model"]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def model_param_specs(cfg):
    return (encdec if cfg.is_encdec else transformer).param_specs(cfg)


def make_model(cfg, params: Dict, plan=None):
    """The serving module for ``cfg`` over a parameter tree of tensors: an
    `encdec.EncDec` for an encoder-decoder, else a
    `transformer.Transformer`. Under a sharding ``plan`` ``params`` are
    this rank's blocks (``partition.shard_tree(params,
    partition.serving_shardings(cfg, plan), mesh)``: the JAX serving
    steps' ``params_only_shardings``) and the model runs only under that
    plan."""
    return (encdec.EncDec if cfg.is_encdec else transformer.Transformer)(
        cfg, params, plan)


def exact_gemms(device) -> None:
    """Raise on a CUDA ``device`` while cuBLAS may reduce bf16 GEMMs in
    bf16 (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_
    reduction``, True by default) or run float32 GEMMs in TF32: the LM
    steps' products are the JAX package's only with both off. The CLIs set
    both; a library caller sets them once."""
    if torch.device(device).type != "cuda":
        return
    flags = []
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        flags.append("torch.backends.cuda.matmul."
                     "allow_bf16_reduced_precision_reduction")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        flags.append("torch.backends.cuda.matmul.allow_tf32")
    if torch.backends.cudnn.allow_tf32:
        flags.append("torch.backends.cudnn.allow_tf32")
    if flags:
        raise RuntimeError(
            "the LM steps need exact GEMMs: bf16 products accumulated in "
            "float32 and float32 products in IEEE float32; set "
            + " and ".join(f"{f} = False" for f in flags))


def set_exact_gemms() -> None:
    """Turn off bf16 reduction and TF32 for this process (what the CLIs,
    which own their process, do at startup)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cast_model(cfg, model):
    """``model`` in ``cfg.param_dtype`` (in place; a no-op when it is)."""
    return model.to(_dtype(cfg.param_dtype))


def _checked(cfg, model):
    want = _dtype(cfg.param_dtype)
    if model.dtype != want:
        raise ValueError(f"the model is {model.dtype}, the config's "
                         f"param_dtype is {want}: cast it once with "
                         f"steps.cast_model")
    exact_gemms(model.embed.device)


# -- training ------------------------------------------------------------------

def _opt_cfg(cfg, opt_cfg: Optional[AdamWConfig]) -> AdamWConfig:
    return opt_cfg or AdamWConfig(moment_dtype=_dtype(cfg.moment_dtype))


def init_train_state(cfg, generator: torch.Generator,
                     opt_cfg: Optional[AdamWConfig] = None,
                     device="cuda") -> Dict:
    """``{"params": the master tree (cfg.master_dtype), "opt": {"m", "v",
    "step"}}`` on ``device``, the params drawn by ``init_params`` from
    ``generator`` (which lives on that device)."""
    opt_cfg = _opt_cfg(cfg, opt_cfg)
    params = init_params(model_param_specs(cfg), generator,
                         _dtype(cfg.master_dtype), device)
    return {"params": params, "opt": adamw.init_state(params, opt_cfg)}


def _forward_loss(cfg) -> Callable:
    """loss_fn(master, batch) -> (loss, nll): the master cast to
    ``cfg.param_dtype`` inside autograd, the training forward (with the
    batch's ``frames`` for an encoder-decoder, its ``prefix_embeds`` for a
    prefix config), `lm_loss`."""
    compute_dtype = _dtype(cfg.param_dtype)

    def loss_fn(master_params: Dict, batch: Dict):
        p = tree_map(lambda x: x.to(compute_dtype), master_params)
        if cfg.is_encdec:
            hidden, aux = encdec.forward(p, batch["frames"], batch["tokens"],
                                         cfg)
        elif cfg.n_prefix_tokens:
            hidden, aux = transformer.forward(
                p, batch["tokens"], cfg, prefix_embeds=batch["prefix_embeds"])
        else:
            hidden, aux = transformer.forward(p, batch["tokens"], cfg)
        return transformer.lm_loss(p, hidden, batch["labels"], cfg, aux)

    return loss_fn


def _value_and_grad(loss_fn) -> Callable:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over a tree of leaf
    tensors: ((loss, nll) detached, grads as a tree)."""
    def grad_fn(params: Dict, batch: Dict):
        paths, leaves = zip(*sorted_leaves(params))
        leaves = [t.detach().requires_grad_() for t in leaves]
        loss, nll = loss_fn(unflatten(dict(zip(paths, leaves))), batch)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), nll.detach()), unflatten(dict(zip(paths, grads)))

    return grad_fn


# -- training under a sharding plan ----------------------------------------------

def _leaf_gather(cfg, plan, spec_of: Dict, tp: bool):
    """(gather_top(path, t), gather_layer(stack, lp)): a cast leaf from
    this rank's block, gathered over its spec's axes: with ``tp`` over all
    but ``model``, whose blocks the layers compute on
    (``partition.tp_keep``: an MoE router, and experts that ``model`` does
    not split, whole); else whole, but an expert-parallel layer's experts,
    which stay this rank's block along ``model``. ``stack``: the path of
    the layer's stacked leaves (``layers/l{i}``, ``enc_layers``,
    ``dec_layers``)."""
    from ..sharding.partition import gather_leaf, tp_keep
    from ..sharding.rules import P

    mesh = plan.mesh
    ep = plan.mesh.shape.get("model", 1) > 1
    # each stack's per-layer specs by part (the stacked spec without its
    # layers entry)
    layer_specs: Dict = {}
    for path, sp in spec_of.items():
        parts = path.split("/")
        if parts[0] in _STACKS:
            layer_specs.setdefault("/".join(parts[:-2]), {}).setdefault(
                parts[-2], {})[parts[-1]] = P(*sp[1:])

    def keep(ls: Dict, name: str, key: str) -> tuple:
        if tp:
            return tp_keep(name, key, ls)
        if ep and name == "moe" and key in ("wi", "wg", "wo") \
                and ls[name][key][0] == "model":
            return ("model",)
        return ()

    def gather_top(path, t):
        return gather_leaf(t, spec_of[path], mesh, ("model",) if tp else ())

    def gather_layer(stack, lp):
        ls = layer_specs[stack]
        return {name: {k: gather_leaf(t, ls[name][k], mesh,
                                      keep(ls, name, k))
                       for k, t in sub.items()} for name, sub in lp.items()}

    return gather_top, gather_layer


#: the top-level keys of the stacked layer trees
_STACKS = ("layers", "enc_layers", "dec_layers")


def _mesh_grad_fn(cfg, plan, spec_tree, outer=(), tp=True):
    """grad_fn(blocks, batch, split) -> ((loss, nll), grads) on this rank:
    the global-batch loss and nll (``batch`` is this rank's block of the
    batch when ``split``), and this rank's block of the gradient. Axes in
    ``outer`` are left alone (the compressed step's ``pod``): the ranks
    along them run their own programs. ``tp`` (False gives the form that
    gathers every leaf whole, the oracle of the checks): the layers
    compute on the rank's ``model`` blocks, each residual stream between
    them is the rank's block of the sequence over ``plan.seq_axis`` and
    the loss is vocab-parallel (``models.transformer``,
    ``models.encdec``); a leaf whole along ``model``
    (a norm, the router, replicated heads) is still summed over it by
    ``comm.reduce_grads``, a ``model`` block is not."""
    from ..sharding import comm
    from ..sharding.partition import activation_ctx

    mesh = plan.mesh
    inner = tuple(a for a in mesh.axis_names if a not in outer)
    n_inner = mesh.axis_size(inner)
    compute_dtype = _dtype(cfg.param_dtype)
    gather_top, gather_layer = _leaf_gather(
        cfg, plan, dict(sorted_leaves(spec_tree)), tp)

    def gathered(path, v):
        if isinstance(v, dict):
            return {k: gathered(f"{path}/{k}", t) for k, t in v.items()}
        return gather_top(path, v)

    def loss_sums(p, batch):
        top = {k: v if k in _STACKS else gathered(k, v)
               for k, v in p.items()}
        if cfg.is_encdec:
            hidden, aux = encdec.forward(top, batch["frames"],
                                         batch["tokens"], cfg,
                                         gather_layer=gather_layer)
        else:
            extra = ({"prefix_embeds": batch["prefix_embeds"]}
                     if cfg.n_prefix_tokens else {})
            hidden, aux = transformer.forward(top, batch["tokens"], cfg,
                                              gather_layer=gather_layer,
                                              **extra)
        ls, ts = transformer.lm_loss_sums(top, hidden, batch["labels"], cfg)
        return ls, ts, aux

    def grad_fn(params: Dict, batch: Dict, split: bool):
        paths, leaves = zip(*sorted_leaves(params))
        leaves = [t.detach().requires_grad_() for t in leaves]
        p = tree_map(lambda x: x.to(compute_dtype),
                     unflatten(dict(zip(paths, leaves))))
        with activation_ctx(plan, split, seq=tp):
            ls, ts, aux = loss_sums(p, batch)
            baxes = tuple(a for a in plan.batch_axes if a not in outer)
            if split and baxes:
                ts = comm.psum(ts.detach(), mesh, baxes)
                ls = comm.psum(ls, mesh, baxes)
            nll = ls / torch.clamp_min(ts, 1.0)
            loss = nll + 0.01 * aux
            grads = torch.autograd.grad(loss * (1.0 / n_inner), leaves)
        grads = unflatten(dict(zip(paths, grads)))
        with torch.no_grad():
            grads = comm.reduce_grads(grads, spec_tree, mesh, outer)
        return (loss.detach(), nll.detach()), grads

    return grad_fn


def _block_norm(grads: Dict, spec_tree, mesh) -> torch.Tensor:
    """The global gradient's norm from this rank's blocks: each block's
    sum of squares counted once (by the rank at index 0 of the axes its
    spec does not name), summed over the mesh."""
    from ..launch.mesh import spec_axes
    from ..sharding import comm

    spec_of = dict(sorted_leaves(spec_tree))
    total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for path, g in sorted_leaves(grads):
        named = spec_axes(spec_of[path])
        if all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in named):
            total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(comm.psum(total, mesh, mesh.axis_names))


def _batch_block(batch: Dict, plan, device) -> Tuple[Dict, bool]:
    """(this rank's block of the batch over ``plan.batch_axes`` on
    ``device``, whether it is a block): whole when the batch does not
    divide the axes."""
    from ..sharding.partition import batch_axis, rebatch

    b = next(iter(batch.values())).shape[0]
    split = batch_axis(plan, b) is not None
    out = {k: rebatch(v, plan, False, split) for k, v in
           _on_device(batch, device).items()}
    return out, split


def _on_device(batch: Dict, device) -> Dict:
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(
        v, np.ndarray) else v).to(device) for k, v in batch.items()}


def make_train_step(cfg, opt_cfg: Optional[AdamWConfig] = None,
                    lr_schedule: Optional[Callable] = None,
                    accum_steps: int = 1,
                    accum_dtype=torch.float32, plan=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), ``metrics`` =
    {loss, nll, grad_norm, lr} as device scalars. ``batch`` holds
    ``tokens`` and ``labels`` (B, S), and ``frames`` (B, enc_seq, D) for
    an encoder-decoder or ``prefix_embeds`` (B, P, D) for a prefix config
    (labels then cover the P + S hidden positions), tensors or numpy
    arrays (moved to the state's device).

    accum_steps > 1 splits the batch into microbatches whose gradients are
    summed into ``accum_dtype`` (bf16 halves the accumulator) and scaled by
    1 / accum_steps in float32.
    With ``plan`` (a sharding plan on a ``launch.mesh.Mesh``) the state
    is this rank's blocks (``partition.shard_tree`` under
    ``partition.train_state_shardings``), ``batch`` the global batch, of
    which the step takes this rank's block; see the module docstring."""
    opt_cfg = _opt_cfg(cfg, opt_cfg)
    if plan is not None:
        from ..sharding.partition import train_state_shardings

        spec_tree = train_state_shardings(cfg, plan)["params"]
        mesh_grad = _mesh_grad_fn(cfg, plan, spec_tree)
        split = {}

        def grad_fn(params, batch):
            return mesh_grad(params, batch, split["split"])
    else:
        grad_fn = _value_and_grad(_forward_loss(cfg))

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        device = state["opt"]["step"].device
        exact_gemms(device)
        if plan is not None:
            batch, split["split"] = _batch_block(batch, plan, device)
        else:
            batch = _on_device(batch, device)
        if accum_steps == 1:
            (loss, nll), grads = grad_fn(params, batch)
        else:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                  *v.shape[1:]) for k, v in batch.items()}
            acc = {path: torch.zeros(p.shape, dtype=accum_dtype,
                                     device=p.device)
                   for path, p in sorted_leaves(params)}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            nll = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(accum_steps):
                (loss_mb, n), g = grad_fn(params, {k: v[i] for k, v in
                                                   micro.items()})
                for path, g_leaf in sorted_leaves(g):
                    acc[path] += g_leaf.to(accum_dtype)
                loss, nll = loss + loss_mb, nll + n
                del g
            grads = unflatten(acc)
            inv = 1.0 / accum_steps
            grads = tree_map(lambda g: (g.float() * inv).to(g.dtype), grads)
            loss, nll = loss * inv, nll * inv

        gnorm = (adamw.global_norm(grads) if plan is None else
                 _block_norm(grads, spec_tree, plan.mesh))
        if lr_schedule is None:
            lr = torch.full((), opt_cfg.lr, dtype=torch.float32, device=device)
        else:
            lr = lr_schedule(state["opt"]["step"])
        new_params, new_opt = adamw.apply_updates(params, grads, state["opt"],
                                                  opt_cfg, lr=lr, norm=gnorm)
        del grads
        metrics = {"loss": loss, "nll": nll, "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def pod_reduce(g: torch.Tensor, e: torch.Tensor, mesh, axes=()):
    """One leaf of the compressed exchange over ``pod``: (the pods' mean
    gradient in ``g``'s dtype, the new error, this pod's int8 codes and
    scale, every pod's codes). ``g + e`` is quantized to int8 with one
    float32 scale; the codes and scales are all-gathered (int8 on the
    wire), dequantized and summed, then divided by the pod count.

    ``g`` and ``e`` may be this rank's block of the leaf over ``axes``
    (the mesh axes its spec names): the scale then takes the largest
    ``|g + e|`` over them (``comm.pmax``), so it is the whole leaf's and
    the codes are the block of the whole leaf's codes."""
    from ..optim.compression import quantize_int8
    from ..sharding import comm
    from .common import div

    n_pods = mesh.shape.get("pod", 1)
    gf = g.float() + e
    q8, s = quantize_int8(gf, lambda amax: comm.pmax(amax, mesh, axes))
    new_e = gf - q8.float() * s
    allq = comm.all_gather(q8[None], mesh, "pod", 0)
    alls = comm.all_gather(s[None], mesh, "pod", 0)
    red = div(torch.sum(allq.float() * alls.reshape(
        (n_pods,) + (1,) * g.ndim), dim=0), float(n_pods))
    return red.to(g.dtype), new_e, q8, s, allq


def make_compressed_train_step(cfg, plan, opt_cfg: Optional[AdamWConfig] = None,
                               lr_schedule: Optional[Callable] = None
                               ) -> Callable:
    """Train step with int8 error-feedback gradient compression across the
    ``pod`` axis: each pod computes gradients on its share of the batch
    (its ranks along the other axes as in the sharded step, each on its
    blocks of ``train_state_shardings``), quantizes (grad + carried
    error) to int8 (`pod_reduce`; the scale the whole leaf's),
    all-gathers the int8 codes and the scales over ``pod``, and averages
    the dequantized gradients; the quantization residual is the new
    pod-local error.

    Returns train_step(state, batch, err, probe=None) -> (state, metrics,
    new err): ``state`` this rank's blocks (as `make_train_step`'s under
    a plan), ``err`` a float32 tree of the params' blocks
    (``compression.init_error_state`` of them); loss and nll are averaged
    over ``pod``. The state is updated in place, as `make_train_step`'s.
    ``probe(path, g + e, codes, scale)``, where given, sees each leaf's
    blocks as they are exchanged. A plan whose FSDP names ``pod``
    (``fsdp="pod_data"``) is refused: the JAX step gathers such a leaf
    over ``pod`` at its region's edge, which this step does not do."""
    from ..launch.mesh import spec_axes
    from ..sharding import comm
    from ..sharding.partition import train_state_shardings

    import dataclasses as _dc

    opt_cfg = _opt_cfg(cfg, opt_cfg)
    mesh = plan.mesh
    n_pods = mesh.shape.get("pod", 1)
    spec_tree = train_state_shardings(cfg, plan)["params"]
    axes_of = {path: spec_axes(sp) for path, sp in sorted_leaves(spec_tree)}
    on_pod = sorted(p for p, axes in axes_of.items() if "pod" in axes)
    if on_pod:
        raise ValueError(
            f"make_compressed_train_step: the plan shards {len(on_pod)} "
            f"leaves over pod (fsdp='pod_data'; {on_pod[0]}, ...); the "
            f"compressed step exchanges whole-pod gradients, so its FSDP "
            f"must not name pod")
    # inside a pod the batch is already pod-split: the inner plan's batch
    # axes name only the others
    inner_plan = _dc.replace(
        plan, batch_axes=tuple(a for a in plan.batch_axes if a != "pod"))
    grad_fn = _mesh_grad_fn(cfg, inner_plan, spec_tree, outer=("pod",))

    def train_step(state: Dict, batch: Dict, err: Dict, probe=None):
        params = state["params"]
        device = state["opt"]["step"].device
        exact_gemms(device)
        # each pod takes its share of the batch, split again over the
        # pod's own batch axes
        bp = next(iter(batch.values())).shape[0] // n_pods
        pi = mesh.axis_index("pod")
        batch, split = _batch_block(
            {k: v[pi * bp:(pi + 1) * bp] for k, v in batch.items()},
            inner_plan, device)
        (loss, nll), grads = grad_fn(params, batch, split)
        errors = dict(sorted_leaves(err))
        red, new_e = {}, {}
        with torch.no_grad():
            for path, g in sorted_leaves(grads):
                out = pod_reduce(g, errors[path], mesh, axes_of[path])
                red[path], new_e[path] = out[:2]
                if probe is not None:
                    probe(path, g.float() + errors[path], out[2], out[3])
        del grads
        grads = unflatten(red)
        loss = comm.pmean(loss, mesh, "pod")
        nll = comm.pmean(nll, mesh, "pod")
        # the reduced gradient is equal on every pod: each block counted
        # once, by pod 0
        gnorm = _block_norm(grads, spec_tree, mesh)
        if lr_schedule is None:
            lr = torch.full((), opt_cfg.lr, dtype=torch.float32, device=device)
        else:
            lr = lr_schedule(state["opt"]["step"])
        new_params, new_opt = adamw.apply_updates(params, grads, state["opt"],
                                                  opt_cfg, lr=lr, norm=gnorm)
        metrics = {"loss": loss, "nll": nll, "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt}, metrics, \
            unflatten(new_e)

    return train_step


# -- serving -------------------------------------------------------------------

def make_prefill_step(cfg) -> Callable:
    """prefill_step(model, batch) -> (last-token logits, caches); the
    batch's ``frames`` go to an encoder-decoder, its ``prefix_embeds`` in
    front of a prefix config's tokens."""
    def prefill_step(model, batch: Dict):
        _checked(cfg, model)
        if cfg.is_encdec:
            return model.prefill(batch["frames"], batch["tokens"])
        if cfg.n_prefix_tokens:
            return model.prefill(batch["tokens"],
                                 prefix_embeds=batch["prefix_embeds"])
        return model.prefill(batch["tokens"])

    return prefill_step


def make_decode_step(cfg) -> Callable:
    def decode_step(model, token: torch.Tensor, caches: Dict, cache_pos: int):
        _checked(cfg, model)
        logits, new_caches = model.decode_step(token, caches, cache_pos)
        next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_token[:, None], logits, new_caches

    return decode_step

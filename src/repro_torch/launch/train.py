"""End-to-end training driver.

The port of the JAX package's ``launch/train.py``: config -> init (or
restore) -> train loop -> checkpoints -> metrics, with the same flags and
printed lines (the plan's ``[plan]`` notes first), plus ``--device``
(``cuda`` by default; it raises without a card and never moves to the CPU
on its own). ``--mesh debug`` trains under the 1 x 1 debug mesh's plan on
this process's device; ``--mesh production`` asks
``launch.mesh.make_production_mesh`` for its 256 ranks, which raises in a
single process, as ``jax.make_mesh`` does without the devices::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --reduced --steps 200 --batch 8 --seq 256 --ckpt-dir <dir>

`build_trainer(cfg, mesh)` takes any mesh: on one of several ranks
(``core.analysis.distributed.launch_mesh(fn, shape, axes=...)``) each rank
keeps only its blocks of the master and the moments, takes its block of
the batch, and runs ``steps.make_train_step(..., plan=)``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data import DataConfig, SyntheticLM
from ..models import steps as steps_mod
from ..models.common import init_params, tree_map
from ..optim import AdamWConfig, adamw, warmup_cosine


def build_trainer(cfg, mesh=None, *, lr=3e-4, warmup=20, total_steps=200,
                  seed=0, data_cfg: Optional[DataConfig] = None,
                  accum_steps: int = 1, device="cuda"):
    """Returns (init_state_fn, step_fn, data_fn, like_state_fn, plan): the
    fourth gives the train state's structure as meta tensors (what a
    restore needs, nothing allocated), the fifth the sharding plan of
    ``mesh`` (``launch.mesh.make_debug_mesh((1, 1))`` on ``device`` by
    default). On a mesh of more than one rank the state is this rank's
    blocks (``sharding.partition.train_state_shardings``), drawn from the
    seed leaf by leaf, each leaf cut to the rank's block and freed before
    the next is drawn (the same stream in the same order as the whole
    draw, so the blocks are its blocks bit for bit), and the step takes
    the global batch.

    ``SyntheticLM`` yields tokens and labels only, so an encoder-decoder
    (which needs ``frames``) or a prefix config (``prefix_embeds``) is
    refused here; the JAX package's ``launch.train`` fails on them at its
    first step."""
    from ..sharding import make_plan
    from ..models.common import sorted_leaves
    from ..sharding.partition import (block, shard_tree,
                                      train_state_shardings)
    from .mesh import make_debug_mesh

    missing = ("frames" if cfg.is_encdec else
               "prefix_embeds" if cfg.n_prefix_tokens else None)
    if missing:
        raise ValueError(
            f"{cfg.arch}: its train step needs batch[{missing!r}], which "
            f"the synthetic data source (data.SyntheticLM: tokens and "
            f"labels) does not yield")

    mesh = mesh if mesh is not None else make_debug_mesh((1, 1),
                                                         device=device)
    dev = mesh.device
    plan = make_plan(cfg, mesh)
    sharded = mesh.size > 1
    opt_cfg = AdamWConfig(lr=lr)
    sched = lambda step: warmup_cosine(step, lr, warmup, total_steps)  # noqa: E731
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, sched, accum_steps,
                                        plan=plan if sharded else None)
    specs = train_state_shardings(cfg, plan)

    data_cfg = data_cfg or DataConfig(
        vocab_size=cfg.vocab_size, seq_len=512, global_batch=8, seed=seed)
    src = SyntheticLM(data_cfg)

    def data_at(step: int) -> Dict[str, np.ndarray]:
        return src.batch_at(step)

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(seed)
        if not sharded:
            return steps_mod.init_train_state(cfg, gen, opt_cfg, dev)
        spec_of = dict(sorted_leaves(specs["params"]))
        params = init_params(steps_mod.model_param_specs(cfg), gen,
                             steps_mod._dtype(cfg.master_dtype), dev,
                             cut=lambda path, t: block(t, spec_of[path],
                                                       mesh))
        return {"params": params, "opt": adamw.init_state(params, opt_cfg)}

    def like_state():
        params = tree_map(lambda s: torch.empty(s.shape, device="meta"),
                          steps_mod.model_param_specs(cfg))
        if sharded:
            params = shard_tree(params, specs["params"], mesh)
        return {"params": params, "opt": adamw.init_state(params, opt_cfg)}

    return init_state, step_fn, data_at, like_state, plan


def main(argv=None):
    from ..core.analysis.wavefront import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--mesh", default="debug", choices=["debug", "production"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from .mesh import make_debug_mesh, make_production_mesh

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, loss_chunk=max(512, args.batch * 64))

    mesh = (make_production_mesh(device=dev) if args.mesh == "production"
            else make_debug_mesh((1, 1), device=dev))
    steps_mod.set_exact_gemms()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    init_state, run_step, data_at, like_state, plan = build_trainer(
        cfg, mesh, lr=args.lr, total_steps=args.steps, data_cfg=data_cfg,
        accum_steps=args.accum)
    for note in plan.notes:
        print(f"[plan] {note}")

    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    def save_fn(step, state):
        mgr.save(step, state, extra={"arch": cfg.arch})

    def restore_fn():
        out, info = mgr.restore_latest(like_state(), dev)
        if out is None:
            return None
        print(f"[restore] resumed from step {info['step']}")
        return out, info["step"]

    t0 = time.time()
    losses = []
    restored = restore_fn()
    state = init_state() if restored is None else restored[0]
    start = 0 if restored is None else restored[1]
    for step in range(start, args.steps):
        batch = data_at(step)
        state, metrics = run_step(state, batch)
        if (step + 1) % args.log_every == 0 or step == start:
            loss = float(metrics["nll"])
            losses.append(loss)
            dt = time.time() - t0
            tok_s = (step + 1 - start) * args.batch * args.seq / max(dt, 1e-9)
            print(f"step {step+1:5d}  nll {loss:7.4f}  lr {float(metrics['lr']):.2e}"
                  f"  gnorm {float(metrics['grad_norm']):8.3f}  tok/s {tok_s:,.0f}")
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            save_fn(step + 1, state)
    print(f"done in {time.time()-t0:.1f}s; first nll {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()

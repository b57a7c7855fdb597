"""End-to-end driver on the PyTorch port (the twin of ``train_100m.py``):
train a ~100M-parameter LM for a few hundred steps, with checkpointing and
restart-exactness demonstrated mid-run. Every option is the original's,
plus ``--device cuda|cpu`` (default ``cuda``: the card, which it needs).

  PYTHONPATH=src python examples/train_100m_torch.py [--steps 300]
  PYTHONPATH=src python examples/train_100m_torch.py --quick --device cpu

Uses the phi3 family at ~100M scale (12L x 768d, 16k vocab) on synthetic
Markov-Zipf data; loss drops from ~ln(V) within the first hundred steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.analysis.wavefront import resolve_device
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import steps as steps_mod
from repro_torch.optim import AdamWConfig, warmup_cosine


def config(quick: bool):
    """The example's model: ~10M parameters with ``quick``, else ~110M."""
    if quick:
        return dataclasses.replace(
            get_config("phi3-mini-3.8b"),
            n_layers=6, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
            d_ff=1024, vocab_size=4_096, loss_chunk=1024,
            q_chunk=128, kv_chunk=128, remat="none",
        )
    return dataclasses.replace(
        get_config("phi3-mini-3.8b"),
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=2048, vocab_size=16_384, loss_chunk=2048,
        q_chunk=256, kv_chunk=256, remat="none",
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_100m_ckpt"))
    ap.add_argument("--quick", action="store_true",
                    help="~10M-param CPU-sized variant (minutes, not hours)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    steps_mod.set_exact_gemms()

    if args.quick:
        args.steps = min(args.steps, 120)
        args.batch, args.seq = 4, 128
    cfg = config(args.quick)
    n = cfg.param_count()
    print(f"model: {n/1e6:.1f}M params ({cfg.n_layers}L x {cfg.d_model}d)")

    opt_cfg = AdamWConfig(lr=6e-4, weight_decay=0.01)
    sched = lambda s: warmup_cosine(s, 6e-4, 30, args.steps)  # noqa: E731
    train_step = steps_mod.make_train_step(cfg, opt_cfg, sched)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch, seed=17))

    shutil.rmtree(args.ckpt, ignore_errors=True)
    mgr = CheckpointManager(args.ckpt, keep=2)
    state = steps_mod.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), opt_cfg, dev)

    t0 = time.time()
    first = last = None
    for step in range(args.steps):
        state, m = train_step(state, data.batch_at(step))
        if step == 0:
            first = float(m["nll"])
        if (step + 1) % 25 == 0:
            last = float(m["nll"])
            tok_s = (step + 1) * args.batch * args.seq / (time.time() - t0)
            print(f"step {step+1:4d}  nll {last:6.3f}  "
                  f"lr {float(m['lr']):.2e}  tok/s {tok_s:,.0f}")
        ckpt_every = 50 if args.quick else 100
        if (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, state, extra={"arch": "phi3-100m"})
        # demonstrate crash/restart mid-run: restore the latest checkpoint
        if step + 1 == ckpt_every * 3 // 2:
            print(">> simulating restart: restoring latest checkpoint")
            restored, info = mgr.restore_latest(state)
            assert info["step"] == ckpt_every
            state = restored
            # data pipeline seeks: continue from restored step
    print(f"\nnll: {first:.3f} -> {last:.3f} in {args.steps} steps "
          f"({time.time()-t0:.0f}s)")
    assert last < first - 0.5, "loss must decrease"
    print("OK")


if __name__ == "__main__":
    main()

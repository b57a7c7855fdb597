"""Batched serving driver: decode loop with continuous batching.

The port of the JAX package's ``launch/serve.py``. The server keeps a
fixed-capacity decode batch; finished sequences free their slot and queued
requests are prefilled into it. Its behaviour is the reference's, quirks
included:

* the naive per-slot prefill feeds the prompt through the whole-batch
  decode step at the slot's position, so each prompt token also writes
  that position in every other slot's cache row;
* the batch decodes at one position, ``slot_pos`` of the first active
  slot;
* a freed slot keeps its position and its cache rows;
* for an SSM layer the naive prefill therefore advances every slot's
  recurrent state, not only the admitted one's;
* an encoder-decoder's cross caches stay zero (prompts go through
  ``decode_step``; nothing calls ``encode``).

One host read of the next tokens a step. Runs on the card (``device="cuda"``
by default, ``--device`` on the CLI) and raises without one; it never
moves to the CPU on its own::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..models import encdec, steps as steps_mod, transformer
from ..models.common import init_params


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new: int = 16
    out: Optional[List[int]] = None


class Server:
    """Fixed-slot continuous-batching decode server over a `Transformer`
    or an `EncDec` (cast once to ``cfg.param_dtype`` here), on the model's
    device."""

    def __init__(self, cfg, model, max_batch: int = 8, max_len: int = 512):
        self.cfg = cfg
        self.model = steps_mod.cast_model(cfg, model)
        self.max_batch = max_batch
        self.max_len = max_len
        self.decode = steps_mod.make_decode_step(cfg)
        dev = model.embed.device
        mod = encdec if cfg.is_encdec else transformer
        self.caches = mod.init_decode_caches(cfg, max_batch, max_len,
                                             device=dev)
        self.slot_pos = np.zeros(max_batch, dtype=np.int32)   # next write slot
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.tokens = torch.zeros((max_batch, 1), dtype=torch.int32, device=dev)
        self.steps = 0

    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[slot] = req
                # naive per-slot prefill: feed prompt tokens through decode
                # one at a time, as the reference does
                for t in req.prompt:
                    self._step_single(slot, int(t))

    def _step_single(self, slot: int, token: int):
        tok = self.tokens.clone()
        tok[slot, 0] = token
        pos = int(self.slot_pos[slot])
        nxt, _, self.caches = self.decode(self.model, tok, self.caches, pos)
        self.tokens = nxt
        self.slot_pos[slot] += 1

    def step(self):
        """One decode step for the whole batch."""
        self._admit()
        active = [s for s in range(self.max_batch) if self.slot_req[s] is not None]
        if not active:
            return False
        pos = int(self.slot_pos[active[0]])  # aligned single-pos decode
        nxt, _logits, self.caches = self.decode(
            self.model, self.tokens, self.caches, pos)
        self.tokens = nxt
        nxt_np = nxt.cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            req.out.append(int(nxt_np[s, 0]))
            self.slot_pos[s] += 1
            if len(req.out) >= req.max_new or self.slot_pos[s] >= self.max_len - 1:
                self.done.append(req)
                self.slot_req[s] = None
        self.steps += 1
        return True


def main(argv=None):
    from ..core.analysis.wavefront import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    steps_mod.set_exact_gemms()
    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(steps_mod.model_param_specs(cfg), gen,
                         torch.float32, dev)
    model = steps_mod.make_model(cfg, params).to(torch.bfloat16)
    del params
    srv = Server(cfg, model, max_batch=4, max_len=128)

    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        plen = int(rng.integers(4, 12))
        srv.submit(Request(rid, rng.integers(0, cfg.vocab_size, plen,
                                             dtype=np.int32),
                           max_new=args.max_new))
    t0 = time.time()
    while srv.step():
        pass
    dt = time.time() - t0
    n_tok = sum(len(r.out) for r in srv.done)
    print(f"served {len(srv.done)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok/max(dt,1e-9):.1f} tok/s, {srv.steps} batch steps) "
          f"on {dev}")
    for r in srv.done[:3]:
        print(f"  req {r.rid}: {len(r.out)} tokens -> {r.out[:8]}...")


if __name__ == "__main__":
    main()

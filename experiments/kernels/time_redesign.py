"""Times the generic MXU path, the min-plus products and the counting
kernels of one source tree on one card, for comparing two trees in turns.

    python experiments/kernels/time_redesign.py --src <tree>/src --label L

Imports ``repro_torch`` from ``--src`` (builds its kernels into that
tree's ``build/``), makes the operands on the card from fixed seeds (the
same in every tree) and prints the card's name and power limit, then one
JSON line per case: the event time of one call (CUDA events, median of 10
calls after 2 warm-up calls, of 50 where that median is below 1 ms; the
wrapper's host time included) and the device time of one call
(``torch.profiler``, all kernels of 10 calls: conversion passes and both
tiles' launches included, divided by 10).
Compare two trees by running it on each in one command, in turns:
parent, change, change, parent. Cases, at the sweep's and the extension
point's shapes: ``batched_minplus_matmul`` at B=12, 2048^3; 2D
``minplus_matmul`` and ``minplus_count_matmul`` at p = 512; the generic
kernel (``semiring_matmul``) on COUNTING 2D and B=12, BOOLEAN 2D and a
uint8 x int32 -> int32 algebra at 2048^3; ``count_matmul`` on both tiles,
``frontier_step`` and ``reachability_step``; ``torch.mm``/``torch.bmm``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys


def timed_ms(fn, iters=10):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=10):
    """Device time of all kernels of one call, from a profile of ``reps``
    calls; None when the profile records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / reps if total > 0 else None


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", required=True)
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_redesign: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import semiring as S

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(18)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def lengths(*shape):
        x = torch.randint(0, 4, shape, generator=gen, device="cuda").float()
        return torch.where(rand(*shape) < 0.5, float("inf"), x)

    def counts(*shape):
        x = torch.randint(1, 4, shape, generator=gen, device="cuda").float()
        return x * (rand(*shape) < 0.3)

    b, p = 12, 2048
    sa, sb = lengths(b, p, p), lengths(b, p, p)
    ta, tb = lengths(512, 512), lengths(512, 512)
    da, db = lengths(512, 512), lengths(512, 512)
    ca = torch.where(torch.isfinite(da), 2.0, 0.0)
    cb = torch.where(torch.isfinite(db), 3.0, 0.0)
    f, adj = counts(b, p, p), (rand(b, p, p) < 0.05).float()
    gt, z = counts(b, p, p).transpose(-1, -2), rand(b, p, p) * (
        rand(b, p, p) < 0.25)
    dist = torch.where(rand(b, p, p) < 0.5, float("inf"), 1.0)
    ma, mb = (rand(p, p) < 0.02).float(), (rand(p, p) < 0.02).float()
    wa = (rand(p, p) < 0.01).to(torch.uint8)
    wb = (rand(p, p) < 0.05).to(torch.int32)
    two_walks = S.Semiring(
        name="two_walks", pad_a=(0.0,), pad_b=(0.0,), acc_init=(0.0,),
        mxu=True, epilogue=lambda acc: acc >= 2, cuda_epilogue="acc >= 2.f")
    cases = {
        "batched_minplus_matmul B=12 2048^3":
            lambda: S.batched_minplus_matmul(sa, sb),
        "minplus_matmul 512^3": lambda: S.minplus_matmul(ta, tb),
        "minplus_count_matmul 512^3":
            lambda: S.minplus_count_matmul(da, ca, db, cb),
        "semiring_matmul COUNTING 2D 2048^3":
            lambda: S.semiring_matmul(S.COUNTING, (f[0],), (adj[0],)),
        "semiring_matmul COUNTING B=12 2048^3":
            lambda: S.semiring_matmul_batched(S.COUNTING, (f,), (adj,)),
        "semiring_matmul BOOLEAN 2D 2048^3":
            lambda: S.semiring_matmul(S.BOOLEAN, (ma,), (mb,)),
        "semiring_matmul two_walks u8 x i32 -> i32 2048^3":
            lambda: S.semiring_matmul(two_walks, (wa,), (wb,),
                                      out_dtype=torch.int32),
        "count_matmul 2D (f, adj) 2048^3":
            lambda: S.count_matmul(f[0], adj[0]),
        "count_matmul B=12 (f, adj) 2048^3": lambda: S.count_matmul(f, adj),
        "count_matmul B=12 (gt, z) 2048^3": lambda: S.count_matmul(gt, z),
        "frontier_step B=12 2048^3": lambda: S.frontier_step(f, adj, dist),
        "reachability_step 2D 2048^3":
            lambda: S.reachability_step(ma, mb),
        "torch.mm 2048^3": lambda: torch.mm(f[0], adj[0]),
        "torch.bmm B=12 2048^3": lambda: torch.bmm(f, adj),
    }
    for name, fn in cases.items():
        fn()  # builds at first use, outside the timed windows
        torch.cuda.synchronize()
        ms = timed_ms(fn)
        if ms < 1.0:
            ms = timed_ms(fn, iters=50)
        print(json.dumps({"label": args.label, "case": name, "ms": ms,
                          "device_ms": device_ms(fn)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

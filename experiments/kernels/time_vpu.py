"""Times the generic VPU path of the extension point and the specialized
min-plus kernels of one source tree on one card, for comparing two trees
in turns.

    python experiments/kernels/time_vpu.py --src <tree>/src --label L

Imports ``repro_torch`` from ``--src`` (builds its kernels into that
tree's ``build/``, every generated one in one parallel ``nvcc`` call before
any timing), makes the operands on the card from fixed seeds (the same in
every tree) and prints the card's name and power limit, then one JSON line
per case: the event time of one call (CUDA events, median of 10 calls
after 2 warm-up calls, of 50 where that median is below 1 ms; the
wrapper's host time included) and the device time of one call
(``torch.profiler``, all kernels of 10 calls, divided by 10). Compare two
trees by running it on each in one command, in turns: parent, change,
change, parent. Only public entry points are called, so any tree of the
port since the extension point runs it. Cases: ``batched_minplus_matmul``
and the generic TROPICAL on the same B=12, 2048^3 stack; max-plus and
max-min at B=12 and 2D 2048^3; TROPICAL_COUNT at B=12, 2048^3 and 2D
p = 512; ragged 300 x 200 x 260 products (2D and B=3); per-field max-plus
algebras of 3, 8 and 16 fields at B=2, 1024^3.
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


def fieldwise_maxplus(S, nf):
    """Max-plus on each of ``nf`` float32 fields, with device code."""
    import torch

    inf = float("inf")
    return S.Semiring(
        name=f"maxplus{nf}", num_fields=nf, pad_a=(-inf,) * nf,
        pad_b=(-inf,) * nf, acc_init=(-inf,) * nf,
        combine=lambda a, b: tuple(x + y for x, y in zip(a, b)),
        kreduce=lambda f: tuple(torch.amax(x, dim=1) for x in f),
        accumulate=lambda x, y: tuple(torch.maximum(p, q)
                                      for p, q in zip(x, y)),
        cuda_combine="for (int f = 0; f < NF; ++f) out[f] = a[f] + b[f];",
        cuda_accumulate="for (int f = 0; f < NF; ++f) "
                        "acc[f] = fmaxf(acc[f], t[f]);")


def algebras(S):
    """max-plus, max-min (one field each) and per-field max-plus of 3, 8
    and 16 fields, with device code."""
    import torch

    inf = float("inf")
    maxplus = S.Semiring(
        name="maxplus", pad_a=(-inf,), pad_b=(-inf,), acc_init=(-inf,),
        combine=lambda a, b: (a[0] + b[0],),
        kreduce=lambda f: (torch.amax(f[0], dim=1),),
        accumulate=lambda x, y: (torch.maximum(x[0], y[0]),),
        cuda_combine="out[0] = a[0] + b[0];",
        cuda_accumulate="acc[0] = fmaxf(acc[0], t[0]);")
    maxmin = S.Semiring(
        name="maxmin", pad_a=(-inf,), pad_b=(-inf,), acc_init=(-inf,),
        combine=lambda a, b: (torch.minimum(a[0], b[0]),),
        kreduce=lambda f: (torch.amax(f[0], dim=1),),
        accumulate=lambda x, y: (torch.maximum(x[0], y[0]),),
        cuda_combine="out[0] = fminf(a[0], b[0]);",
        cuda_accumulate="acc[0] = fmaxf(acc[0], t[0]);")
    return maxplus, maxmin, {nf: fieldwise_maxplus(S, nf) for nf in (3, 8, 16)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", required=True)
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_vpu: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels import semiring as S

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    maxplus, maxmin, wide = algebras(S)
    f32 = (torch.float32,)
    build.build_generated({S.build_key(sr, f32): S.semiring_source(sr, f32)
                           for sr in (S.TROPICAL, S.TROPICAL_COUNT, maxplus,
                                      maxmin, *wide.values())})
    gen = torch.Generator(device="cuda").manual_seed(19)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def lengths(*shape):
        x = torch.randint(0, 4, shape, generator=gen, device="cuda").float()
        return torch.where(rand(*shape) < 0.5, float("inf"), x)

    def scores(*shape):
        return torch.where(rand(*shape) < 0.1, -float("inf"),
                           10 * rand(*shape))

    def pairs(*shape):
        d = lengths(*shape)
        return d, torch.where(torch.isfinite(d), 2.0, 0.0)

    b, p = 12, 2048
    sa, sb = lengths(b, p, p), lengths(b, p, p)
    xa, xb = scores(b, p, p), scores(b, p, p)
    na, nb = 10 * rand(b, p, p), 10 * rand(b, p, p)
    tca, tcb = pairs(b, p, p), pairs(b, p, p)
    da, db = pairs(512, 512), pairs(512, 512)
    ra, rb = scores(300, 260), scores(260, 200)
    rsa, rsb = scores(3, 300, 260), scores(3, 260, 200)
    ta, tb = lengths(300, 260), lengths(260, 200)
    wide_ops = {nf: (tuple(scores(2, 1024, 1024) for _ in range(nf)),
                     tuple(scores(2, 1024, 1024) for _ in range(nf)))
                for nf in wide}
    mm, mmb = S.semiring_matmul, S.semiring_matmul_batched
    cases = {
        "batched_minplus_matmul B=12 2048^3":
            lambda: S.batched_minplus_matmul(sa, sb),
        "TROPICAL B=12 2048^3": lambda: mmb(S.TROPICAL, (sa,), (sb,)),
        "maxplus B=12 2048^3": lambda: mmb(maxplus, (xa,), (xb,)),
        "maxmin B=12 2048^3": lambda: mmb(maxmin, (na,), (nb,)),
        "maxplus 2D 2048^3": lambda: mm(maxplus, (xa[0],), (xb[0],)),
        "maxmin 2D 2048^3": lambda: mm(maxmin, (na[0],), (nb[0],)),
        "TROPICAL 2D 2048^3": lambda: mm(S.TROPICAL, (sa[0],), (sb[0],)),
        "minplus_matmul 2D 2048^3": lambda: S.minplus_matmul(sa[0], sb[0]),
        "TROPICAL_COUNT B=12 2048^3":
            lambda: mmb(S.TROPICAL_COUNT, tca, tcb),
        "TROPICAL_COUNT 512^3": lambda: mm(S.TROPICAL_COUNT, da, db),
        "minplus_count_matmul 512^3":
            lambda: S.minplus_count_matmul(da[0], da[1], db[0], db[1]),
        "maxplus 300x200x260": lambda: mm(maxplus, (ra,), (rb,)),
        "maxplus B=3 300x200x260": lambda: mmb(maxplus, (rsa,), (rsb,)),
        "TROPICAL 300x200x260": lambda: mm(S.TROPICAL, (ta,), (tb,)),
        **{f"maxplus{nf} B=2 1024^3": (lambda nf=nf: mmb(wide[nf],
                                                         *wide_ops[nf]))
           for nf in wide},
    }
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        ms = timed_ms(fn)
        if ms < 1.0:
            ms = timed_ms(fn, iters=50)
        print(json.dumps({"label": args.label, "case": name, "ms": ms,
                          "device_ms": device_ms(fn)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port, ``repro_torch``.

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc/``, holds each
against its plain PyTorch version on the card, runs the equal-cost sweep at
the committed configuration (checked against
``experiments/sweep/comparison.json``) and at full width (~10k servers,
12 families padded to 2048 routers), once on the kernels and once on the
plain versions, and checks that the full-width run went through both
kernels the expected number of times. Phase 6 runs the analysis path of
``examples/topology_analysis.py`` at full width: ``AnalysisEngine.report()``
on six families at ~10k servers and the max-concurrent-flow throughput on
two at ~2k servers, held to ``experiments/analysis/reference.json`` (made
by the JAX package), and checks that it went through all five kernels.
Phase 7 runs the extreme-scale path: the sampled sweep at 4096 routers
held to ``experiments/extreme/reference.json`` (made by the JAX package),
six families at ~100k routers with the adjacency resident, dragonfly
again with it streamed, and the packed wavefront on phase 5's stack, and
checks that it went through the three narrow-cell kernels.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

The second-to-last line of output is a JSON summary of the kernels (times,
bounds, launches); the last line is ``{"ok": true, "device": {...}}``. Any
failed check ends the run with a nonzero exit and no result line, as does a
machine without a CUDA device or a directory without the package.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
EXACT = 2.0 ** 24  # f32 counts are exact integers below this

# Published peaks (NVIDIA H100 data sheet, dense, at the full power limit):
# IEEE fp32 on the CUDA cores, and device-memory bandwidth.
PEAKS = {"SXM": (67e12, 3.35e12), "PCIe": (51e12, 2.0e12),
         "NVL": (60e12, 3.9e12)}


#: fp32 operations that are not fused multiply-adds (an add, a min, a
#: compare) execute at one per lane per clock: half the FMA-counted peak
NON_FMA = 0.5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def part_of(name: str) -> str:
    """H100 form factor from the device name ("H100 80GB HBM3" is SXM)."""
    for part in ("PCIe", "NVL"):
        if part.lower() in name.lower():
            return part
    return "SXM"


def timed_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median time of one call, by CUDA events around each call."""
    for _ in range(warmup):
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


def profiled(fn):
    """Run ``fn`` under torch.profiler with CPU and CUDA activity; returns
    (the profile's device kernel rows, host wall ms of the window). Each
    row is (name, launches, device ms in total)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[2]), wall


def kernel_device_ms(fn, marker: str, reps: int = 20):
    """Device time of one launch of the kernel whose name holds ``marker``,
    from a profile of ``reps`` calls of ``fn``; None when the profile holds
    no such kernel (no device activity recorded)."""
    rows, _ = profiled(lambda: [fn() for _ in range(reps)])
    hits = [(c, t) for name, c, t in rows if marker in name]
    if not hits or sum(t for _, t in hits) <= 0:
        return None
    return sum(t for _, t in hits) / sum(c for c, _ in hits)


def bound_ms(flops: float, nbytes: float, part: str):
    """Least time for the work on this part, and what bounds it."""
    peak_flops, peak_bw = PEAKS[part]
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# -- phase 3: each kernel against its plain version ------------------------------

def _inputs(gen, b, m, n, k):
    """BFS- and ECMP-like operands: sparse integer counts f (b,m,k) and
    g (b,k,m), a {0,1} adjacency a (b,k,n), distances d (b,m,n) half +inf,
    and a sparse float operand z (b,k,n) in (0, 1)."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def counts(*shape):
        x = torch.randint(1, 4, shape, generator=gen, device="cuda").float()
        return x * (rand(*shape) < 0.3)

    f, g = counts(b, m, k), counts(b, k, m)
    a = (rand(b, k, n) < 0.05).float()
    d = torch.where(rand(b, m, n) < 0.5, float("inf"),
                    torch.randint(0, 5, (b, m, n), generator=gen,
                                  device="cuda").float())
    z = rand(b, k, n) * (rand(b, k, n) < 0.25)
    return f, g, a, d, z


def kernel_checks(S, part):
    """Both kernels, 2D and batched, at the sweep's shape and two ragged
    ones: bit-equal to the plain version on integer inputs, rtol 1e-5 on
    the float ECMP-like operand (read transposed, through its strides).
    Then times at the sweep's shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_ops = None
    errs = {"frontier_step": 0.0, "count_matmul": 0.0}
    for b, m, n, k in ((12, 2048, 2048, 2048), (3, 200, 200, 200),
                       (2, 200, 136, 72)):
        ops = _inputs(gen, b, m, n, k)
        for batched in (True, False):
            f, g, a, d, z = ops if batched else (x[0] for x in ops)
            gt = g.transpose(-1, -2)
            tag = (f"B={b} " if batched else "2D ") + f"{m}x{n}x{k}"
            x, x_ref = S.frontier_step(f, a, d), S.frontier_step_ref(f, a, d)
            c = S.count_matmul(f, a)
            c_ref = (S.batched_count_matmul_ref(f, a) if batched
                     else S.count_matmul_ref(f, a))
            ct, ct_ref = S.count_matmul(gt, z), S.count_matmul_ref(gt, z)
            torch.cuda.synchronize()
            check(torch.equal(x, x_ref), f"frontier_step {tag}: not bit-equal")
            check(bool((x > 0).any()), f"frontier_step {tag}: all zero")
            check(torch.equal(c, c_ref), f"count_matmul {tag}: not bit-equal")
            check(torch.allclose(ct, ct_ref, rtol=1e-5, atol=0.0),
                  f"count_matmul {tag} transposed float: beyond rtol 1e-5")
            err_f = float((x - x_ref).abs().max())
            err_c = max(float((c - c_ref).abs().max()),
                        float((ct - ct_ref).abs().max()))
            errs["frontier_step"] = max(errs["frontier_step"], err_f)
            errs["count_matmul"] = max(errs["count_matmul"], err_c)
            print(f"  {tag:22s} frontier_step max_abs_err={err_f:g}  "
                  f"count_matmul max_abs_err={err_c:g}")
            if batched and main_ops is None:
                main_ops = (f, gt, a, d, z)

    f, gt, a, d, z = main_ops
    m, k, n = f.shape[-2], f.shape[-1], a.shape[-1]
    out = {}
    for batched in (True, False):
        # the sweep's launches are batched; the 2D form is the same kernel
        # with B = 1, timed for the record
        ff, gg, aa, dd, zz = ((f, gt, a, d, z) if batched
                              else (f[0], gt[0], a[0], d[0], z[0]))
        bsz = ff.shape[0] if batched else 1
        library = torch.bmm if batched else torch.mm
        flops = 2.0 * bsz * m * n * k
        cases = {
            "frontier_step": (lambda: S.frontier_step(ff, aa, dd),
                              lambda: S.frontier_step_ref(ff, aa, dd), ff, aa,
                              4.0 * (ff.numel() + aa.numel() + 2 * dd.numel())),
            "count_matmul": (lambda: S.count_matmul(gg, zz),
                             lambda: S.count_matmul_ref(gg, zz), gg, zz,
                             4.0 * (gg.numel() + zz.numel() + dd.numel())),
        }
        for name, (kern, plain, lhs, rhs, nbytes) in cases.items():
            ms, plain_ms = timed_ms(kern), timed_ms(plain)
            library_ms = timed_ms(lambda: library(lhs, rhs))
            bms, by = bound_ms(flops, nbytes, part)
            if batched:
                out[name] = dict(ms=ms, plain_ms=plain_ms,
                                 library_ms=library_ms, bound_ms=bms,
                                 bound_by=by, max_abs_err=errs[name])
            shape = (f"B={bsz} " if batched else "2D ") + f"{m}x{n}x{k}"
            print(f"  {name} {shape}: {ms:.3f} ms (plain {plain_ms:.3f}, "
                  f"torch.{library.__name__} {library_ms:.3f}, bound "
                  f"{bms:.3f} by {by}; {flops / ms / 1e9:.1f} TFLOP/s)")
    ms = timed_ms(lambda: S.count_matmul(z, a))
    print(f"  count_matmul B={f.shape[0]} {m}x{n}x{k}, contiguous left "
          f"operand: {ms:.3f} ms")
    return out


def _abs_err(x, y):
    """Largest |x - y| where the two differ (equal +inf cells count 0)."""
    if x.numel() == 0:
        return 0.0
    return float(torch.where(x == y, 0.0, (x.float() - y.float()).abs()).max())


def _lengths(gen, shape, p_inf, integer=False):
    """Edge-length-like fp32 operands: uniform in [0.5, 4) (or integers in
    [0, 4)) with a share of +inf holes."""
    if integer:
        x = torch.randint(0, 4, shape, generator=gen, device="cuda").float()
    else:
        x = 0.5 + 3.5 * torch.rand(shape, generator=gen, device="cuda")
    holes = torch.rand(shape, generator=gen, device="cuda") < p_inf
    return torch.where(holes, float("inf"), x)


def tropical_checks(S, H, part):
    """The min-plus, tropical-count and histogram kernels against their
    plain versions: bit-equal (min is exact in any order; counts below
    2**24 and histogram bins are integers), at the main path's shapes and
    at ragged ones with +inf, NaN, negative and >= num_bins inputs. Then
    times at the main path's shapes: p = 512 (fattree's padded squaring
    seed) and a (1536, 1536) distance matrix into 65 bins."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {"minplus_matmul": 0.0, "minplus_count_matmul": 0.0,
            "value_histogram": 0.0}
    for m, n, k in ((512, 512, 512), (200, 136, 72), (33, 65, 1),
                    (1, 1, 100)):
        a = _lengths(gen, (m, k), 0.5)
        b = _lengths(gen, (k, n), 0.5)
        a[0] = float("inf")  # an unreached row stays unreached
        out, out_ref = S.minplus_matmul(a, b), S.minplus_matmul_ref(a, b)
        da = _lengths(gen, (m, k), 0.3, integer=True)
        db = _lengths(gen, (k, n), 0.3, integer=True)
        ca = torch.where(torch.isfinite(da), torch.randint(
            1, 4, (m, k), generator=gen, device="cuda").float(), 0.0)
        cb = torch.where(torch.isfinite(db), torch.randint(
            1, 4, (k, n), generator=gen, device="cuda").float(), 0.0)
        d, c = S.minplus_count_matmul(da, ca, db, cb)
        d_ref, c_ref = S.minplus_count_matmul_ref(da, ca, db, cb)
        torch.cuda.synchronize()
        tag = f"{m}x{n}x{k}"
        check(torch.equal(out, out_ref), f"minplus_matmul {tag}: not bit-equal")
        check(bool(torch.isinf(out[0]).all()),
              f"minplus_matmul {tag}: an all-inf row became finite")
        check(torch.equal(d, d_ref) and torch.equal(c, c_ref),
              f"minplus_count_matmul {tag}: not bit-equal")
        errs["minplus_matmul"] = max(errs["minplus_matmul"],
                                     _abs_err(out, out_ref))
        errs["minplus_count_matmul"] = max(
            errs["minplus_count_matmul"], _abs_err(d, d_ref),
            _abs_err(c, c_ref))
        print(f"  {tag:14s} minplus_matmul bit-equal; minplus_count_matmul "
              f"bit-equal (largest count {float(c_ref.max()):g})")
        if m == n == k:
            # the fused convergence flag against the squaring it tests
            sq = torch.where(torch.eye(m, device="cuda", dtype=torch.bool),
                             0.0, a)
            prod, changed = S.minplus_matmul(sq, sq, compare=sq)
            check(int(changed) == int(not torch.equal(prod, sq)) == 1,
                  "minplus_matmul changed flag: wrong on a first squaring")
            while int(changed):
                sq = prod
                prod, changed = S.minplus_matmul(sq, sq, compare=sq)
            check(torch.equal(prod, sq) and torch.equal(
                S.minplus_matmul_ref(sq, sq), sq),
                "minplus_matmul changed flag: 0 before convergence")
            main = (a, b, da, ca, db, cb)

    specials = torch.tensor([float("nan"), float("inf"), -float("inf"),
                             -0.0, -0.5, -3.0, 64.999, 65.0, 1e9, 0.0],
                            device="cuda")
    for shape in ((1536, 1536), (7, 13), (1,), (0,)):
        x = torch.randint(0, 8, shape, generator=gen, device="cuda").float()
        x = torch.where(torch.rand(shape, generator=gen, device="cuda")
                        < 0.1, float("inf"), x)
        flat = x.reshape(-1)
        flat[:len(specials)] = specials[:flat.numel()]
        h, h_ref = H.value_histogram(x, 65), H.value_histogram_ref(x, 65)
        torch.cuda.synchronize()
        check(torch.equal(h, h_ref), f"value_histogram {shape}: not equal")
        errs["value_histogram"] = max(errs["value_histogram"],
                                      _abs_err(h, h_ref))
        print(f"  {str(shape):14s} value_histogram equal "
              f"({int(h.sum())} of {x.numel()} counted)")
        if shape == (1536, 1536):
            hist_x = x

    a, b, da, ca, db, cb = main
    p = a.shape[0]
    valid = torch.isfinite(hist_x) & (hist_x >= 0) & (hist_x < 65)
    idx = hist_x[valid].long()
    markers = {"minplus_matmul": "tropical_tile<false>",
               "minplus_count_matmul": "tropical_tile<true>",
               "value_histogram": "value_hist"}
    cases = {
        # p^3 adds and p^3 mins; operands read once, output written once
        "minplus_matmul": (lambda: S.minplus_matmul(a, b),
                           lambda: S.minplus_matmul_ref(a, b), None,
                           2.0 * p ** 3, 3 * p * p * 4.0),
        # per (i, j, k): the add, the compare, the count product and its
        # accumulation; two fields in and out
        "minplus_count_matmul": (
            lambda: S.minplus_count_matmul(da, ca, db, cb),
            lambda: S.minplus_count_matmul_ref(da, ca, db, cb), None,
            4.0 * p ** 3, 6 * p * p * 4.0),
        # one read of the matrix; the bins are negligible
        "value_histogram": (
            lambda: H.value_histogram(hist_x, 65),
            lambda: H.value_histogram_ref(hist_x, 65),
            lambda: torch.bincount(idx, minlength=65),
            3.0 * hist_x.numel(), hist_x.numel() * 4.0 + 65 * 4),
    }
    out = {}
    for name, (kern, plain, library, ops, nbytes) in cases.items():
        ms, plain_ms = timed_ms(kern), timed_ms(plain)
        library_ms = timed_ms(library) if library is not None else None
        bms, by = bound_ms(ops / NON_FMA, nbytes, part)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bms, bound_by=by, max_abs_err=errs[name])
        lib = ("" if library_ms is None
               else f", torch.bincount {library_ms:.4f}")
        # the events bracket one call from the host, wrapper included;
        # the profile gives the kernel's own device time
        dev = kernel_device_ms(kern, markers[name])
        dev = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f}{lib}, bound "
              f"{bms:.4f} by {by}); kernel device time {dev}")
    return out


# -- phase 3: the narrow-cell kernels --------------------------------------------

#: the extreme path's padded router count (781 x 128, ~100k routers)
EXTREME_WIDTH = 99_968


def _packed_operands(gen, lead, m, n, k, density, hi=4, sat_share=0.0):
    """Packed-cell operands: an int32 frontier f of sparse counts in
    [0, hi), with a share ``sat_share`` of cells at or above MULT_SAT; a
    {0,1} uint8 adjacency a of ``density``, drawn in row blocks so a 10 GB
    one needs no float copy; int16 distances d, half DIST_UNREACHED."""
    from repro_torch.kernels.semiring import DIST_UNREACHED, MULT_SAT

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    f = torch.randint(0, hi, (*lead, m, k), generator=gen, device="cuda",
                      dtype=torch.int32) * (rand(*lead, m, k) < 0.3)
    if sat_share:
        f = torch.where(rand(*lead, m, k) < sat_share,
                        MULT_SAT + torch.randint(0, 8, f.shape, generator=gen,
                                                 device="cuda",
                                                 dtype=torch.int32), f)
    a = torch.empty((*lead, k, n), dtype=torch.uint8, device="cuda")
    rows = a.view(-1, n)
    for r0 in range(0, rows.shape[0], 4096):
        r1 = min(rows.shape[0], r0 + 4096)
        rows[r0:r1] = rand(r1 - r0, n) < density
    d = torch.randint(0, 5, (*lead, m, n), generator=gen, device="cuda",
                      dtype=torch.int16)
    d = torch.where(rand(*lead, m, n) < 0.5, DIST_UNREACHED, d)
    return f.to(torch.int32), a, d.to(torch.int16)


def packed_checks(S, part):
    """The packed frontier step (2D and batched) and the narrow counting
    product against their plain versions, bit-equal: at the extreme path's
    shapes (a 32-row source tile against a 99,968-wide uint8 adjacency;
    the pump's (32 x 256) slab against a (256 x 99,968) panel; the
    sweep's stack, B=12, 2048^3) and at ragged ones, with frontier cells
    at and above MULT_SAT so the clamp is exercised (the narrow product's
    inputs keep their sums below 2**24, where fp32 sums are exact in any
    order). Then times at the main shapes."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = ("frontier_step_packed", "frontier_step_packed_batched",
             "count_matmul_narrow")
    errs = dict.fromkeys(names, 0.0)
    k0 = 128

    def step_check(name, f, a, d, tag):
        x, x_ref = S.frontier_step_packed(f, a, d), S.frontier_step_packed_ref(
            f, a, d)
        torch.cuda.synchronize()
        check(torch.equal(x, x_ref), f"{name} {tag}: not bit-equal")
        errs[name] = max(errs[name], _abs_err(x, x_ref))
        sat = int((x_ref == S.MULT_SAT).sum())
        print(f"  {name} {tag}: bit-equal ({int((x_ref > 0).sum())} new "
              f"cells, {sat} clamped at MULT_SAT)")
        return sat

    def narrow_check(f, b, tag):
        c, c_ref = S.count_matmul(f, b), S.count_matmul_ref(f, b)
        torch.cuda.synchronize()
        check(torch.equal(c, c_ref), f"count_matmul_narrow {tag}: not "
                                     f"bit-equal")
        errs["count_matmul_narrow"] = max(errs["count_matmul_narrow"],
                                          _abs_err(c, c_ref))
        print(f"  count_matmul_narrow {tag}: bit-equal (largest sum "
              f"{float(c_ref.max()):g})")

    for b, m, n, k in ((3, 40, 136, 72), (2, 33, 65, 1), (1, 1, 1, 100),
                       (2, 32, 137, 300)):
        f, a, d = _packed_operands(gen, (b,), m, n, k, 0.2, sat_share=0.02)
        step_check("frontier_step_packed_batched", f, a, d,
                   f"B={b} {m}x{n}x{k}")
        step_check("frontier_step_packed", f[0], a[0], d[0], f"{m}x{n}x{k}")
        g, _, _ = _packed_operands(gen, (b,), m, 1, 2 * k, 0.2)
        narrow_check(g[..., k:], a, f"B={b} {m}x{n}x{k} strided")
        narrow_check(g[0, :, k:], a[0], f"{m}x{n}x{k} strided")

    fb, ab, db = _packed_operands(gen, (12,), 2048, 2048, 2048, 0.05,
                                  sat_share=1e-4)
    check(step_check("frontier_step_packed_batched", fb, ab, db,
                     "B=12 2048x2048x2048") > 0, "no cell clamped at B=12")
    f, a, d = _packed_operands(gen, (), 32, EXTREME_WIDTH, EXTREME_WIDTH,
                               1e-3, sat_share=1e-4)
    check(step_check("frontier_step_packed", f, a, d,
                     f"32x{EXTREME_WIDTH}x{EXTREME_WIDTH}") > 0,
          "no cell clamped at the extreme shape")
    g, _, _ = _packed_operands(gen, (), 32, 1, EXTREME_WIDTH, 1.0)
    slab, panel = g[:, k0:k0 + 256], a[k0:k0 + 256]
    check(not slab.is_contiguous(), "the pump's slab should be strided")
    narrow_check(slab, panel, f"32x{EXTREME_WIDTH}x256 strided slab")

    cases = {  # name -> (kernel, plain, lhs, rhs, library, ops, bytes)
        "frontier_step_packed": (
            lambda: S.frontier_step_packed(f, a, d),
            lambda: S.frontier_step_packed_ref(f, a, d), f, a, torch.mm,
            2.0 * f.shape[0] * a.shape[0] * a.shape[1],
            4.0 * f.numel() + a.numel() + (2.0 + 4.0) * d.numel()),
        "frontier_step_packed_batched": (
            lambda: S.frontier_step_packed(fb, ab, db),
            lambda: S.frontier_step_packed_ref(fb, ab, db), fb, ab, torch.bmm,
            2.0 * 12 * 2048 ** 3,
            4.0 * fb.numel() + ab.numel() + (2.0 + 4.0) * db.numel()),
        "count_matmul_narrow": (
            lambda: S.count_matmul(slab, panel),
            lambda: S.count_matmul_ref(slab, panel), slab, panel, torch.mm,
            2.0 * slab.shape[0] * panel.shape[0] * panel.shape[1],
            4.0 * slab.numel() + panel.numel()
            + 4.0 * slab.shape[0] * panel.shape[1]),
    }
    markers = {"frontier_step_packed": "narrow_gemm<true",
               "frontier_step_packed_batched": "narrow_gemm<true",
               "count_matmul_narrow": "narrow_gemm<false"}
    out = {}
    for name, (kern, plain, lhs, rhs, library, ops, nbytes) in cases.items():
        ms, plain_ms = timed_ms(kern), timed_ms(plain)
        lf, rf = lhs.float(), rhs.float()  # library: the product only
        library_ms = timed_ms(lambda: library(lf, rf))
        del lf, rf
        dev = kernel_device_ms(kern, markers[name], reps=5)
        bms, by = bound_ms(ops, nbytes, part)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bms, bound_by=by, max_abs_err=errs[name])
        dev = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"  {name} {tuple(lhs.shape)}x{tuple(rhs.shape)}: {ms:.4f} ms "
              f"(plain {plain_ms:.4f}, torch.{library.__name__} "
              f"{library_ms:.4f}, bound {bms:.4f} by {by}; "
              f"{ops / ms / 1e9:.1f} TFLOP/s); kernel device time {dev}")
    del f, a, d, fb, ab, db, g, slab, panel
    torch.cuda.empty_cache()
    return out


# -- phases 4 and 5: the sweep ------------------------------------------------------

_EXACT_COLS = ("routers", "servers", "radix", "diameter", "cables_electrical",
               "cables_optical")


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


def check_committed(result, path):
    ref = {r["family"]: r for r in json.loads(path.read_text())["rows"]}
    rows = {r["family"]: r for r in result["rows"]}
    check(rows.keys() == ref.keys(),
          f"families differ: {sorted(rows)} vs {sorted(ref)}")
    for fam, want in ref.items():
        got = rows[fam]
        for col in _EXACT_COLS:
            check(got[col] == want[col], f"{fam}.{col}: {got[col]} != {want[col]}")
        for col in ("avg_spl", "mult_mean", "cost", "power_kw"):
            check(_close(got[col], want[col], 1e-9),
                  f"{fam}.{col}: {got[col]} vs {want[col]} (rtol 1e-9)")
        check(_close(got["tput_lb"], want["tput_lb"], 1e-5),
              f"{fam}.tput_lb: {got['tput_lb']} vs {want['tput_lb']} (rtol 1e-5)")


def compare_chains(WF, S, adj_np):
    """Full-width stack through the kernels and through the plain versions,
    on the card: dist bit-equal, mult bit-equal below 2**24 (rtol 1e-5
    above), loads rtol 1e-5."""
    adj = torch.from_numpy(WF.pad_operand(adj_np, WF.pad_block(adj_np.shape[-1]),
                                          0.0)).cuda()
    dk, mk = WF.dist_mult_device(adj)
    dp, mp = WF.dist_mult_device(adj, use_kernel=False)
    check(torch.equal(dk, dp), "full width: dist not bit-equal")
    big = mp >= EXACT
    check(torch.equal(mk[~big], mp[~big]),
          "full width: mult below 2**24 not bit-equal")
    check(torch.allclose(mk[big], mp[big], rtol=1e-5, atol=0.0),
          "full width: mult above 2**24 beyond rtol 1e-5")
    lk = WF.ecmp_loads_device(dk, mk, adj)
    lp = WF.ecmp_loads_device(dp, mp, adj, use_kernel=False)
    check(torch.allclose(lk, lp, rtol=1e-5, atol=0.0),
          "full width: loads beyond rtol 1e-5")
    rel = float(((lk - lp).abs() / lp.abs().clamp_min(1e-30)).max())
    print(f"  chains: dist bit-equal; mult >= 2**24 in {int(big.sum())} cells "
          f"(max {float(mp.max()):.4g}); loads max rel diff {rel:.3g}")


# -- phase 6: the analysis path ------------------------------------------------------

ANALYSIS_FAMILIES = ("slimfly", "jellyfish", "xpander", "hyperx",
                     "dragonfly", "fattree")
THROUGHPUT_FAMILIES = ("slimfly", "fattree")
SPECTRAL_KEYS = ("fiedler_lambda2", "laplacian_lambda_max",
                 "bisection_lower_bound", "edge_expansion_lower_bound",
                 "diameter_upper_bound")
_TP_EXACT = ("rounds", "converged", "commodities", "dropped_unreachable",
             "demand_pattern")
_TP_CLOSE = ("throughput", "upper_bound", "gap", "aggregate_throughput")
#: the kernels the analysis path runs
ANALYSIS_KERNELS = ("frontier_step", "count_matmul", "minplus_matmul",
                    "minplus_count_matmul", "value_histogram")


def check_report(fam, got, want, spectral_rtol=1e-2):
    """Integer keys and histograms exact, float keys within rtol 1e-5,
    spectral keys within ``spectral_rtol`` (each package draws its own
    power-iteration start vector). Returns the largest spectral relative
    deviation."""
    check(got.keys() == want.keys(),
          f"{fam}: report keys differ: {sorted(set(got) ^ set(want))}")
    worst = 0.0
    for key, w in want.items():
        g = got[key]
        if key in SPECTRAL_KEYS:
            dev = abs(g - w) / max(abs(w), 1e-30)
            worst = max(worst, dev)
            check(dev <= spectral_rtol,
                  f"{fam}.{key}: {g} vs {w} (rtol {spectral_rtol})")
        elif isinstance(w, float):
            check(_close(g, w, 1e-5), f"{fam}.{key}: {g} vs {w} (rtol 1e-5)")
        else:
            check(g == w, f"{fam}.{key}: {g!r} != {w!r}")
    return worst


def check_throughput(fam, got, want):
    for key in _TP_EXACT:
        check(got[key] == want[key],
              f"{fam} throughput.{key}: {got[key]!r} != {want[key]!r}")
    loads = got["link_loads"]
    for key, g in [(k, got[k]) for k in _TP_CLOSE] + [
            ("link_loads_sum", float(loads.sum())),
            ("link_loads_max", float(loads.max()))]:
        check(_close(g, want[key], 1e-9),
              f"{fam} throughput.{key}: {g} vs {want[key]} (rtol 1e-9)")


def analysis_phase(obs, S, T, AnalysisEngine, paths, ref):
    """The example's analysis path on the card at full width, counted:
    six reports at ~10k servers, the hyperx wavefront against its
    tropical-count oracle, and two all-pairs throughputs at ~2k servers,
    held to the reference ``ref``. Returns (launches, reports)."""
    stages = AnalysisEngine.DEFAULT_STAGES + ("comparison",)
    graphs = {fam: T.by_servers(fam, ref["servers"]["reports"])
              for fam in ANALYSIS_FAMILIES}
    tp_graphs = {fam: T.by_servers(fam, ref["servers"]["throughput"])
                 for fam in THROUGHPUT_FAMILIES}
    spans, reports, results = {}, {}, {}
    obs.enable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.reset_launches()
    t0 = time.perf_counter()
    for fam, g in graphs.items():
        obs.reset()
        reports[fam] = AnalysisEngine(g, device="cuda").report(stages)
        spans[fam] = obs.span_summary()
    g = graphs["hyperx"]
    obs.reset()
    with obs.span("oracle.wavefront"):
        dw, mw = paths.shortest_path_multiplicity(g, device="cuda")
        torch.cuda.synchronize()
    with obs.span("oracle.tropical_count"):
        dt, ct = paths.tropical_count_relaxation(g, device="cuda")
        torch.cuda.synchronize()
    spans["hyperx oracle"] = obs.span_summary()
    for fam, g in tp_graphs.items():
        obs.reset()
        results[fam] = AnalysisEngine(
            g, device="cuda", **ref["throughput_settings"]).throughput()
        spans[f"{fam} throughput"] = obs.span_summary()
    wall = time.perf_counter() - t0
    counts = dict(S.launches)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    obs.disable()

    print(f"[6 analysis] {wall:.3f} s; launches {counts}; peak device "
          f"memory {peak_mb:.1f} MiB")
    for label, row in spans.items():
        cells = ", ".join(f"{name} {r['total_ms']:.3f} ms"
                          for name, r in sorted(row.items()))
        print(f"  spans {label}: {cells}")
    worst = 0.0
    for fam, rep in reports.items():
        worst = max(worst, check_report(fam, rep, ref["reports"][fam]))
        print(f"  {fam}: {rep['routers']} routers, diameter "
              f"{rep['diameter']}, mult mean "
              f"{rep['path_multiplicity_mean']:.6g}, +2 mean "
              f"{rep['nonminimal_plus2_mean']:.6g}, ecmp tput "
              f"{rep['ecmp_saturation_throughput']:.6g}, lambda2 "
              f"{rep['fiedler_lambda2']:.6g}")
    print(f"  reports match reference.json; largest spectral deviation "
          f"{worst:.3g} (rtol 1e-2)")
    check(torch.equal(dw, dt) and torch.equal(mw, ct),
          "hyperx: wavefront (dist, mult) != tropical_count_relaxation")
    print(f"  hyperx ({graphs['hyperx'].n} routers): wavefront dist and mult "
          f"bit-equal to tropical_count_relaxation on the card")
    for fam, res in results.items():
        check_throughput(fam, res, ref["throughput"][fam])
        print(f"  {fam} throughput ({tp_graphs[fam].n} routers): lambda in "
              f"[{res['throughput']:.9g}, {res['upper_bound']:.9g}], "
              f"rounds {res['rounds']}, converged {res['converged']}: "
              f"matches reference.json (rtol 1e-9)")
    for name in ANALYSIS_KERNELS:
        check(counts[name] > 0, f"analysis path: {name} never launched")

    # where the device time goes: one report and one throughput again,
    # under the profiler (after the counted run, so it does not count)
    for label, run in (
            ("dragonfly report", lambda: AnalysisEngine(
                graphs["dragonfly"], device="cuda").report(stages)),
            ("fattree throughput", lambda: AnalysisEngine(
                tp_graphs["fattree"], device="cuda",
                **ref["throughput_settings"]).throughput())):
        rows, wall = profiled(run)
        busy = sum(t for _, _, t in rows)
        if busy <= 0:
            print(f"  profile {label}: device busy share not measured "
                  f"(no device activity in the profile)")
            continue
        print(f"  profile {label}: wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.2f}%), idle "
              f"{100 * (1 - busy / wall):.2f}%")
        for name, c, t in rows[:6]:
            print(f"    {t:9.3f} ms x{c:<5d} {name[:90]}")
    return counts, reports


def plain_chain(T, AnalysisEngine, card_reports, ref, fam="hyperx"):
    """The same report on the CPU through the plain versions, held to the
    card's: the kernel and plain chains agree at full width."""
    g = T.by_servers(fam, ref["servers"]["reports"])
    t0 = time.perf_counter()
    rep = AnalysisEngine(g, device="cpu").report(
        AnalysisEngine.DEFAULT_STAGES + ("comparison",))
    worst = check_report(f"{fam} (plain vs card)", rep, card_reports[fam])
    print(f"  plain chain ({fam}, CPU, {time.perf_counter() - t0:.2f} s) "
          f"matches the card's report; spectral deviation {worst:.3g}")


# -- phase 7: the extreme-scale path ----------------------------------------------

#: the families whose numpy generators build ~100k routers in seconds
#: (experiments/extreme/time_generators.py times all twelve)
EXTREME_FAMILIES = ("hammingmesh", "hypercube", "megafly", "dragonfly",
                    "fattree", "torus")
#: keeps a ~100k-router uint8 adjacency (10-17 GB) resident on the card
RESIDENT_BUDGET = 24 << 30


def check_same(got, want, what, rtol=1e-9):
    """Integers, bools, strings and None equal; floats (the CI bounds
    among them) within ``rtol``; timing keys skipped."""
    if isinstance(want, dict):
        keys = set(want) - {"elapsed_s", "peak_rss_mb"}
        check(set(got) - {"elapsed_s", "peak_rss_mb"} == keys,
              f"{what}: keys differ")
        for k in keys:
            check_same(got[k], want[k], f"{what}.{k}", rtol)
    elif isinstance(want, list):
        check(len(got) == len(want), f"{what}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            check_same(g, w, f"{what}[{i}]", rtol)
    elif isinstance(want, float):
        check(_close(got, want, rtol), f"{what}: {got} vs {want} (rtol {rtol})")
    else:
        check(got == want, f"{what}: {got!r} != {want!r}")


def spot_checked(D, packed=True):
    """Wrap the tiled pump so the first row of every run's first tile is
    kept; ``verify()`` then holds each kept row to the CSR Brandes oracle,
    bit-equal after packing (the JAX CLI's spot check), after the timed
    run."""
    real = D.tiled_dist_mult_tiles
    kept = []

    def pump(source, *args, **kw):
        ids = kw.get("source_ids")
        first = True
        for r0, r1, d, m in real(source, *args, **kw):
            if first:
                i = int(ids[r0]) if ids is not None else r0
                kept.append((source, i, d[0].copy(), m[0].copy()))
                first = False
            yield r0, r1, d, m

    def verify():
        for g, i, d, m in kept:
            od, osig = D.oracle_rows(g, i, packed)
            check(np.array_equal(d, od) and np.array_equal(m, osig),
                  f"{g.name}: source {i} differs from the BFS oracle")
        return [(g, i, int((m == D.S.MULT_SAT).sum())) for g, i, _, m
                in kept]

    D.tiled_dist_mult_tiles = pump
    return real, verify


def extreme_phase(obs, S, SW, D, WF, ref, stack):
    """The extreme-scale path on the card, counted: (a) the 4096-router
    sampled sweep and tiled summary held to ``ref``; (b) six families at
    ~100k routers, adjacency resident, one sampled source each held to the
    BFS oracle; (c) dragonfly streamed under the default budget, rows
    equal to (b)'s; (d) the packed wavefront on phase 5's stack against
    the fp32 one. Returns the launches."""
    obs.enable()
    torch.cuda.synchronize()
    S.reset_launches()
    t_phase = time.perf_counter()

    # (a) the reference
    t0 = time.perf_counter()
    got = SW.sweep_extreme(device="cuda", **ref["sweep_settings"])
    check_same(json.loads(json.dumps(got)), ref["sweep"], "sweep@4096")
    st = ref["tiled_settings"]
    from repro_torch.core import topology as T

    g = T.make(st["family"], n=st["n"], r=st["r"], seed=st["seed"])
    summ = D.tiled_summary(g, sources=tuple(st["sources"]),
                           packed=st["packed"], device="cuda")
    check_same(json.loads(json.dumps(summ)), ref["tiled_summary"],
               "tiled_summary")
    print(f"[7a reference] 12-family sweep at 4096 routers and the "
          f"{g.name} tiled summary match reference.json "
          f"({time.perf_counter() - t0:.2f} s)")

    # (b) full width, resident
    real, verify = spot_checked(D)
    rows = {}
    try:
        for fam in EXTREME_FAMILIES:
            obs.reset()
            before = dict(S.launches)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = SW.sweep_extreme([fam], target_routers=100_000,
                                   k_sources=32, seed=0,
                                   adjacency_budget=RESIDENT_BUDGET,
                                   device="cuda")
            (row,) = res["rows"]
            check("error" not in row, f"{fam}: {row.get('error')}")
            rows[fam] = row
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            spans = obs.span_summary()
            levels = [ev["args"].get("levels") for ev in obs.events()
                      if ev.get("name") == "tiled.tile"]
            launched = {k: v - before[k] for k, v in S.launches.items()
                        if v != before[k]}
            print(f"[7b 100k resident] {row['family']}: {row['routers']} "
                  f"routers, diameter >= {row['diameter_lb']}, avg_spl "
                  f"{row['avg_spl']:.6g}, mult_mean {row['mult_mean']:.6g}, "
                  f"saturated {row['saturated']}; build "
                  f"{spans['sweep.extreme.build']['total_ms']:.1f} ms, "
                  f"levels {levels} in "
                  f"{spans['tiled.tile']['total_ms']:.1f} ms, family "
                  f"{spans['sweep.extreme.family']['total_ms']:.1f} ms; "
                  f"launches {launched}; peak device memory "
                  f"{peak_gb:.2f} GiB")
            check(row["sampled_sources"] == 32
                  and np.isfinite(row["avg_spl"]) and row["avg_spl"] > 1
                  and 0 < row["reached_frac"] <= 1, f"bad row {row}")
    finally:
        D.tiled_dist_mult_tiles = real
    t0 = time.perf_counter()
    graphs = {}
    for g, i, sat in verify():
        graphs[g.name.split("(")[0]] = g
        print(f"  {g.name}: sampled source {i} bit-equal to bfs_dist_sigma "
              f"({sat} cells clamped at MULT_SAT)")
    print(f"  oracle checks {time.perf_counter() - t0:.2f} s")

    # (c) dragonfly again, streamed through the pinned pump
    obs.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = S.launches["count_matmul_narrow"]
    t0 = time.perf_counter()
    res = SW.sweep_extreme(["dragonfly"], target_routers=100_000,
                           k_sources=32, seed=0, device="cuda")
    wall = time.perf_counter() - t0
    (row,) = res["rows"]
    check_same(row, rows["dragonfly"], "dragonfly streamed vs resident",
               rtol=0.0)
    spans = obs.span_summary()
    print(f"[7c 100k streamed] {row['family']}: rows equal to the resident "
          f"run; {wall:.2f} s (family "
          f"{spans['sweep.extreme.family']['total_ms']:.1f} ms, resident "
          f"{rows['dragonfly']['elapsed_s']} s in the estimator); "
          f"{S.launches['count_matmul_narrow'] - before} panel products; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    obs.disable()

    # (d) the packed wavefront on the full-width stack
    p = WF.pad_block(stack.shape[-1])
    adj8 = torch.from_numpy(WF.pad_operand(stack, p, 0, np.uint8)).cuda()
    t0 = time.perf_counter()
    dp, mp, sat = WF.dist_mult_device(adj8, packed=True)
    torch.cuda.synchronize()
    t_packed = time.perf_counter() - t0
    adj = adj8.float()
    t0 = time.perf_counter()
    df, mf = WF.dist_mult_device(adj)
    torch.cuda.synchronize()
    t_f32 = time.perf_counter() - t0
    check(torch.equal(S.unpack_dist(dp), df), "packed stack: dist differs")
    big = mf >= EXACT
    check(torch.equal(mp[~big].float(), mf[~big]),
          "packed stack: mult below 2**24 differs")
    check(bool((mp[big] == S.MULT_SAT).all()),
          "packed stack: mult at or above 2**24 not clamped at MULT_SAT")
    check(bool(sat) == bool(big.any()) and bool(big.any()),
          "packed stack: the saturation flag is wrong")
    print(f"[7d packed stack] B={stack.shape[0]} p={p}: dist equal, mult "
          f"equal below 2**24 and MULT_SAT in all {int(big.sum())} cells at "
          f"or above it; packed {t_packed:.3f} s, fp32 {t_f32:.3f} s")
    del adj8, adj, dp, mp, df, mf, big

    counts = dict(S.launches)
    print(f"[7 extreme] {time.perf_counter() - t_phase:.2f} s; launches "
          f"{counts}")
    for name in ("frontier_step_packed", "frontier_step_packed_batched",
                 "count_matmul_narrow"):
        check(counts[name] > 0, f"extreme path: {name} never launched")

    # where the device time goes: one 32-source tile of the pump again,
    # resident and streamed, under the profiler (after the counted run)
    ids = np.random.default_rng(0).choice(97_000, size=32, replace=False)
    for label, fam, budget in (("hammingmesh resident", "hammingmesh",
                                RESIDENT_BUDGET),
                               ("dragonfly streamed", "dragonfly",
                                D._ADJ_BUDGET)):
        rows, wall = profiled(lambda: list(D.tiled_dist_mult_tiles(
            graphs[fam], source_ids=np.sort(ids), packed=True,
            adjacency_budget=budget, device="cuda")))
        busy = sum(t for _, _, t in rows)
        if busy <= 0:
            print(f"  profile {label}: device busy share not measured "
                  f"(no device activity in the profile)")
            continue
        print(f"  profile {label}: wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.2f}%), idle "
              f"{100 * (1 - busy / wall):.2f}%")
        for name, c, t in rows[:6]:
            print(f"    {t:9.3f} ms x{c:<5d} {name[:90]}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import obs
    from repro_torch.core import sweep as SW
    from repro_torch.core import topology as T
    from repro_torch.core.analysis import AnalysisEngine, paths
    from repro_torch.core.analysis import distributed as D
    from repro_torch.core.analysis import wavefront as WF
    from repro_torch.kernels import build
    from repro_torch.kernels import seghist as H
    from repro_torch.kernels import semiring as S

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip()
    name = torch.cuda.get_device_name(0)
    part = part_of(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] {smi}")
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name} ({part} peaks used for bounds); "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[2 build] {len(built)} libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for res in built.values():
        print(f"  {res.path.name}: nvcc {res.seconds:.2f} s")
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    # 3. kernel vs plain
    print("[3 kernels] kernel vs plain version on the card")
    kstats = kernel_checks(S, part)
    kstats.update(tropical_checks(S, H, part))
    kstats.update(packed_checks(S, part))
    print("kernels: " + " ".join(f"{k}=pass" for k in kstats))

    # 4. the committed configuration
    t0 = time.perf_counter()
    small = SW.sweep(ref=("slimfly", 2000), max_routers=200, device="cuda")
    check_committed(small, ROOT / "experiments" / "sweep" / "comparison.json")
    print(f"[4 committed] 12-family table matches comparison.json "
          f"({time.perf_counter() - t0:.2f} s)")

    # 5. full width: the main path, counted
    obs.enable()
    obs.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.reset_launches()
    t0 = time.perf_counter()
    full = SW.sweep(ref=("slimfly", 10000), max_routers=2048, device="cuda")
    wall_k = time.perf_counter() - t0
    counts = dict(S.launches)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    spans = obs.span_summary()
    obs.disable()
    diam = max(r["diameter"] for r in full["rows"])
    print(SW.format_table(full))
    print(f"[5 full width] kernel sweep {wall_k:.3f} s; launches {counts}; "
          f"max diameter {diam}; peak device memory {peak_mb:.1f} MiB")
    for span, row in sorted(spans.items()):
        print(f"  span {span}: {row['total_ms']:.3f} ms x{row['count']}")
    print("  BFS levels per family: " + ", ".join(
        f"{r['family']} {r['wavefront_levels']}" for r in full["rows"]))
    check(counts["frontier_step"] == diam + 1,
          f"frontier launches {counts['frontier_step']} != diameter+1 {diam + 1}")
    check(counts["count_matmul"] == 2 * diam,
          f"counting launches {counts['count_matmul']} != 2*diameter {2 * diam}")
    for r in full["rows"]:
        check(r["routers"] <= 2048 and np.isfinite(r["tput_lb"])
              and 0 < r["tput_lb"] <= 1, f"bad row {r}")

    obs.enable()
    obs.reset()
    t0 = time.perf_counter()
    plain = SW.sweep(ref=("slimfly", 10000), max_routers=2048, device="cuda",
                     use_kernel=False)
    wall_p = time.perf_counter() - t0
    spans = obs.span_summary()
    obs.disable()
    print(f"[5 full width] plain sweep {wall_p:.3f} s")
    for span, row in sorted(spans.items()):
        print(f"  span {span}: {row['total_ms']:.3f} ms x{row['count']}")
    rows_p = {r["family"]: r for r in plain["rows"]}
    for r in full["rows"]:
        p = rows_p[r["family"]]
        for col in _EXACT_COLS + ("avg_spl",):
            check(r[col] == p[col], f"{r['family']}.{col} kernel != plain")
        check(_close(r["mult_mean"], p["mult_mean"], 1e-5),
              f"{r['family']}.mult_mean kernel vs plain")
        check(_close(r["tput_lb"], p["tput_lb"], 1e-5),
              f"{r['family']}.tput_lb kernel vs plain")
    graphs, _ = SW.equal_cost_graphs(ref=("slimfly", 10000), max_routers=2048)
    compare_chains(WF, S, SW._stack_adjacency(graphs))

    sweep_counts = counts

    # 6. the analysis path at full width, counted
    ref = json.loads((ROOT / "experiments" / "analysis"
                      / "reference.json").read_text())
    analysis_counts, reports = analysis_phase(obs, S, T, AnalysisEngine,
                                              paths, ref)
    plain_chain(T, AnalysisEngine, reports, ref)

    # 7. the extreme-scale path, counted
    xref = json.loads((ROOT / "experiments" / "extreme"
                       / "reference.json").read_text())
    extreme_counts = extreme_phase(obs, S, SW, D, WF, xref,
                                   SW._stack_adjacency(graphs))

    csrc = "src/repro_torch/kernels/csrc/"
    sources = {  # name -> (CUDA source, the TPU kernel it replaces)
        "frontier_step": ("semiring.cu", "src/repro/kernels/semiring.py:343"),
        "count_matmul": ("semiring.cu", "src/repro/kernels/semiring.py:486"),
        "minplus_matmul": ("tropical.cu", "src/repro/kernels/minplus.py:18"),
        "minplus_count_matmul": ("tropical.cu",
                                 "src/repro/kernels/semiring.py:566"),
        "value_histogram": ("seghist.cu", "src/repro/kernels/seghist.py:39"),
        "frontier_step_packed": ("packed.cu",
                                 "src/repro/kernels/semiring.py:370"),
        "frontier_step_packed_batched": ("packed.cu",
                                         "src/repro/kernels/semiring.py:406"),
        "count_matmul_narrow": ("packed.cu",
                                "src/repro/kernels/semiring.py:437"),
    }
    kernels = []
    for kname, st in kstats.items():
        launches = (sweep_counts[kname] + analysis_counts[kname]
                    + extreme_counts[kname])
        print(f"  {kname}: {sweep_counts[kname]} launches in the sweep, "
              f"{analysis_counts[kname]} in the analysis path, "
              f"{extreme_counts[kname]} in the extreme path")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": csrc + sources[kname][0],
            "replaces": sources[kname][1], "launches": launches,
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": st["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port, ``repro_torch``.

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc/``, holds each
against its plain PyTorch version on the card, runs the equal-cost sweep at
the committed configuration (checked against
``experiments/sweep/comparison.json``) and at full width (~10k servers,
12 families padded to 2048 routers), once on the kernels and once on the
plain versions, and checks that the full-width run went through both
kernels the expected number of times.

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
    from repro_torch.core.analysis import wavefront as WF
    from repro_torch.kernels import build
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

    sources = {
        "frontier_step": "src/repro/kernels/semiring.py:343",
        "count_matmul": "src/repro/kernels/semiring.py:486",
    }
    kernels = []
    for kname, st in kstats.items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/semiring.cu",
            "replaces": sources[kname], "launches": counts[kname],
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

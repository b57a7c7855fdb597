"""The value histogram of ``csrc/seghist.cu``: candidate builds and grids,
their registers and times, beside the parent's kernel, on one card.

    python experiments/kernels/seghist_variants.py [--parent <tree>]

1. **Variants.** Copies of ``seghist.cu`` with its ``THREADS`` and
   ``UNROLL`` lines rewritten to each pair in ``VARIANTS`` (all ``nvcc``
   calls at once), what ptxas reports for each, and, at a grid of 1 and 2
   blocks an SM (no more than give each thread one full trip), per case
   in ``CASES``:
   equal to ``value_histogram_ref``, event ms of one call (CUDA events,
   median of 10 after 2 warm-ups, the C entry point called through
   ctypes), device ms L2-warm (``torch.profiler``, 20 calls back to back,
   the kernel's rows only) and L2-cold (a 128 MB buffer written between
   calls).
2. **Parent against change.** With ``--parent``, an unpacked tree of the
   parent commit (``git archive <commit> | tar -x -C build/parent``), its
   ``seghist.cu`` (a memset, then the histogram) is built into this tree's
   ``build/``, and each case runs through the parent's and the shipped
   wrapper's calls in turns (parent, change, change, parent): event ms,
   device ms L2-warm and L2-cold (all kernels of a call, memset included).
3. **Host time of one call.** The host's µs per call, over 500 calls
   back to back with no synchronisation (the device queue has room), of
   the shipped wrapper ``value_histogram`` at the main path's shape and of
   its pieces: ``torch.empty`` of the counts, the current stream's handle,
   the grid rule, the ctypes call of the C entry point alone.

``--skip-variants`` leaves out part 1.

Prints the card's name and power limit, then one JSON line per result.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: (threads, unroll); the shipped build first
VARIANTS = ((512, 4), (512, 8), (256, 4))
#: (name, shape, bins, spread): spread False draws the main path's
#: distances (integers 0..7, 10% +inf), True values over all bins
CASES = (("main", (1536, 1536), 65, False), ("big", (4096, 4096), 65, False),
         ("bins4096", (1536, 1536), 4096, True),
         ("bins12288", (1536, 1536), 12288, True))
FLUSH_BYTES = 128 << 20


def timed_ms(torch, fn, iters=10):
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


def device_ms(torch, fn, marker=None, reps=20, between=None):
    """Device ms of one call of ``fn``: its kernels (those whose name holds
    ``marker``, or all but ``between``'s) over ``reps`` calls, each after
    ``between`` if given; None when the profile holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    skip = set()
    if between is not None:  # the names of the flush's own kernels
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            between()
            torch.cuda.synchronize()
        skip = {e.key for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.key not in skip
                and (marker is None or marker in e.key))
    return total / 1e3 / reps if total > 0 else None


def inputs(torch, gen, shape, bins, spread):
    if spread:
        return torch.rand(shape, generator=gen, device="cuda") * bins
    x = torch.randint(0, 8, shape, generator=gen, device="cuda").float()
    return torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.1,
                       float("inf"), x)


def variant_source(text, threads, unroll):
    """``seghist.cu``'s text with its THREADS and UNROLL lines set to the
    variant's; raises if a line moved."""
    for name, value in (("THREADS", threads), ("UNROLL", unroll)):
        text, hits = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", text)
        if hits != 1:
            raise RuntimeError(f"seghist.cu: the {name} line moved")
    return text


def variant_libraries(build):
    """One rewritten copy of the source per variant, built at once:
    key -> (path, log, variant)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "seghist.cu").read_text()
    jobs = {}
    for threads, unroll in VARIANTS:
        key = f"seghist_t{threads}_u{unroll}"
        src = variant_source(text, threads, unroll)
        digest = hashlib.sha256(src.encode()).hexdigest()[:16]
        path = build.BUILD_DIR / f"lib{key}_{digest}.so"
        cu = path.with_suffix(".cu")
        cu.write_text(src)
        jobs[key] = (cu, path)
    built = build._compile([(k, cu, out, build.CSRC)
                            for k, (cu, out) in jobs.items()])
    return {k: (jobs[k][1], built[k].log, v)
            for k, v in zip(jobs, VARIANTS)}


def bind(path):
    lib = ctypes.CDLL(str(path))
    lib.repro_value_histogram_f32.argtypes = [P, LL, I, I, P, P, P, P]
    lib.repro_value_histogram_f32.restype = I
    return lib


def parent_library(build, tree):
    csrc = pathlib.Path(tree) / "src" / "repro_torch" / "kernels" / "csrc"
    src = csrc / "seghist.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = build.BUILD_DIR / f"libparent_seghist_{digest}.so"
    build._compile([("parent", src, out, csrc)])
    lib = ctypes.CDLL(str(out))
    lib.repro_value_histogram_f32.argtypes = [P, LL, I, P, P]
    lib.repro_value_histogram_f32.restype = I
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="an unpacked tree of the parent")
    parser.add_argument("--skip-variants", action="store_true",
                        help="leave out part 1")
    args = parser.parse_args()
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import seghist as H

    if not torch.cuda.is_available():
        print("seghist_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def cold():
        flush.fill_(1.0)

    data = {name: (inputs(torch, gen, shape, bins, spread), bins)
            for name, shape, bins, spread in CASES}
    want = {name: H.value_histogram_ref(x, bins)
            for name, (x, bins) in data.items()}
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")

    def measure(lib, key, name, x, bins, blocks, bps):
        n = x.numel()
        acc = torch.zeros(bins, dtype=torch.int32, device="cuda")
        out = torch.empty(bins, dtype=torch.int32, device="cuda")

        def run():
            rc = lib.repro_value_histogram_f32(
                x.data_ptr(), n, bins, blocks, acc.data_ptr(),
                ticket.data_ptr(), out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"{key}: cudaError {rc}")

        run()
        torch.cuda.synchronize()
        print(json.dumps({
            "variant": key, "case": name, "blocks_per_sm": bps, "blocks": blocks,
            "equal": torch.equal(out, want[name]),
            "event_ms": timed_ms(torch, run),
            "device_ms": device_ms(torch, run, "value_hist"),
            "cold_device_ms": device_ms(torch, run, "value_hist",
                                        between=cold),
            "bound_ms": n * 4 / 3.35e12 * 1e3}))

    # 1. variants and grids
    libs = {} if args.skip_variants else variant_libraries(build)
    for key, (so, log, (threads, unroll)) in libs.items():
        usage = [(u["registers"], u["spill_stores"], u["spill_loads"])
                 for u in build.kernel_usage(log)]
        print(json.dumps({"variant": key, "usage": usage}))
        lib = bind(so)
        for name, (x, bins) in data.items():
            trips = -(-(x.numel() // 4) // (threads * unroll))
            for bps in (1, 2):
                measure(lib, key, name, x, bins,
                        max(1, min(bps * sms, trips)), bps)

    # 2. parent against change, through each tree's wrapper calls
    if args.parent:
        parent = parent_library(build, args.parent)

        def parent_call(x, bins):
            out = torch.zeros(bins, dtype=torch.int32, device="cuda")
            rc = parent.repro_value_histogram_f32(
                x.data_ptr(), x.numel(), bins, out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"parent: cudaError {rc}")
            return out

        for name, (x, bins) in data.items():
            check = {"parent": torch.equal(parent_call(x, bins), want[name]),
                     "change": torch.equal(H.value_histogram(x, bins),
                                           want[name])}
            for turn in ("parent", "change", "change", "parent"):
                fn = ((lambda: parent_call(x, bins)) if turn == "parent"
                      else (lambda: H.value_histogram(x, bins)))
                print(json.dumps({
                    "turn": turn, "case": name, "equal": check[turn],
                    "event_ms": timed_ms(torch, fn),
                    "device_ms": device_ms(torch, fn),
                    "cold_device_ms": device_ms(torch, fn, between=cold)}))

    # 3. host time of one call, and of its pieces
    x, bins = data["main"]
    H.value_histogram(x, bins)
    blocks = H._hist_plan(x.numel(), sms)
    ticket, acc = H._workspace(x.device, stream, bins)
    lib = H._lib()
    out = torch.empty(bins, dtype=torch.int32, device="cuda")
    pieces = {
        "value_histogram": lambda: H.value_histogram(x, bins),
        "torch.empty": lambda: torch.empty(bins, dtype=torch.int32,
                                           device=x.device),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "_hist_plan": lambda: H._hist_plan(x.numel(), sms),
        "ctypes call": lambda: lib.repro_value_histogram_f32(
            x.data_ptr(), x.numel(), bins, blocks, acc.data_ptr(),
            ticket.data_ptr(), out.data_ptr(), stream)}
    for name, fn in pieces.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        host = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
        print(json.dumps({"host_us": name, "us": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Tile variants of ``csrc/packed.cu``'s int8 GEMM, timed on one card.

Builds copies of ``src/repro_torch/kernels/csrc/packed.cu`` with other
column tiles (``BN``: 256 columns and 512 threads, one block per SM, or
128 columns and 256 threads, two blocks per SM) and ring depths
(``STAGES``), all ``nvcc`` calls at once, holds each variant bit-equal to
the shipped kernel, and times the packed step at the extreme path's
shape (32 x 99,968^2, a 10 GB adjacency of density 1e-3; counts below 4,
one limb pass, and any nonnegative int32, four) and at the sweep stack's
(B=12, 2048^3), and the narrow product ((32 x 256) x (256 x
99,968), a strided slab): CUDA events, median of 10 calls, variants in
turns, forward then backward, each shape's two medians averaged::

    python experiments/extreme/packed_variants.py

Prints the card's name and power limit, then one JSON line per variant.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
VARIANTS = [(256, 4), (256, 3), (256, 6), (128, 4), (128, 6)]


def variant_source(text: str, bn: int, stages: int) -> str:
    for name, value in (("BN", bn), ("STAGES", stages)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        assert n == 1, name
    return text


def timed_ms(fn, iters=10):
    import torch

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("packed_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import semiring as S

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    text = (build.CSRC / "packed.cu").read_text()
    sources = {f"packed_bn{bn}_s{st}": variant_source(text, bn, st)
               for bn, st in VARIANTS}
    built = build.build_generated(sources)
    libs = {}
    for key, src in sources.items():
        lib = build.load_generated(key, src)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_frontier_step_packed.argtypes = [P, P, P, P, P, I, I, I, I,
                                                   P]
        lib.repro_count_matmul_narrow.argtypes = [P, L, L, L, P, P, P, I, I,
                                                  I, I, P]
        libs[key] = lib
        regs = sorted(set(re.findall(r"Used (\d+) registers",
                                     built[key].log)))
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores",
                                       built[key].log)))
        print(f"{key}: registers {regs}, spill stores {spills} bytes")

    gen = torch.Generator(device="cuda").manual_seed(3)

    def operands(lead, m, n, k, density):
        f = torch.randint(0, 4, (*lead, m, k), generator=gen, device="cuda",
                          dtype=torch.int32)
        a = torch.empty((*lead, k, n), dtype=torch.uint8, device="cuda")
        rows = a.view(-1, n)
        for r0 in range(0, rows.shape[0], 4096):
            r1 = min(rows.shape[0], r0 + 4096)
            rows[r0:r1] = torch.rand((r1 - r0, n), generator=gen,
                                     device="cuda") < density
        d = torch.where(torch.rand((*lead, m, n), generator=gen,
                                   device="cuda") < 0.5,
                        S.DIST_UNREACHED, 0).to(torch.int16)
        return f, a, d

    def step(lib, f, a, d):
        batch, m, n, k = S._dims(f, a)
        x = torch.empty(d.shape, dtype=torch.int32, device="cuda")
        limbs = S._limb_scratch(batch, m, k, x.device)
        rc = lib.repro_frontier_step_packed(
            f.data_ptr(), a.data_ptr(), d.data_ptr(), x.data_ptr(),
            limbs.data_ptr(), batch, m, n, k,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return x

    def narrow(lib, g, b):
        batch, m, n, k = S._dims(g, b)
        c = torch.empty((m, n), dtype=torch.float32, device="cuda")
        limbs = S._limb_scratch(batch, m, k, c.device)
        rc = lib.repro_count_matmul_narrow(
            g.data_ptr(), 0, g.stride(0), g.stride(1), b.data_ptr(),
            c.data_ptr(), limbs.data_ptr(), batch, m, n, k,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return c

    width = 99_968
    f2, a2, d2 = operands((), 32, width, width, 1e-3)
    fb, ab, db = operands((12,), 2048, 2048, 2048, 0.05)
    slab, panel = f2[:, 128:384], a2[128:384]
    f4 = torch.randint(0, 2 ** 31 - 1, f2.shape, generator=gen,
                       device="cuda", dtype=torch.int32)
    cases = {"step_2d": (step, (f2, a2, d2)),
             "step_2d_four_limbs": (step, (f4, a2, d2)),
             "step_batched": (step, (fb, ab, db)),
             "narrow": (narrow, (slab, panel))}
    want = {name: (S.count_matmul(*args) if name == "narrow"
                   else S.frontier_step_packed(*args))
            for name, (_, args) in cases.items()}
    times = {key: {name: [] for name in cases} for key in libs}
    order = list(libs)
    for keys in (order, order[::-1]):
        for key in keys:
            for name, (fn, args) in cases.items():
                got = fn(libs[key], *args)
                torch.cuda.synchronize()
                assert torch.equal(got, want[name]), (key, name)
                times[key][name].append(
                    timed_ms(lambda: fn(libs[key], *args)))
    for key in order:
        print(json.dumps({"variant": key, **{
            name: sum(t) / len(t) for name, t in times[key].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

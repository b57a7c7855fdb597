"""The large VPU tile of ``csrc/vpu_tiles.cuh``: configurations per field
count, their registers, spills and times, and the element rates of the
one-field algebras, on one card.

    python experiments/kernels/vpu_variants.py [--nf 1,2,4,8,16]

1. **Variants.** For each field count NF, a per-field max-plus algebra
   (``out[f] = a[f] + b[f]``, ``acc[f] = fmaxf(acc[f], t[f])``, fp32; for
   NF = 2 also ``TROPICAL_COUNT``) is built into one source per candidate
   (``tm`` x ``tn`` outputs a thread, ``kv`` k per read of A, ``bv`` n per
   read of B; the K step and ring depth by the header's rule, ``config``,
   here :func:`sized`), written into the source as the tile's template
   arguments, all ``nvcc`` calls at once. For each candidate it prints
   what ptxas reports (registers, spill
   stores and loads, for the 16-byte and the single-element loader), holds
   its output bit-equal to the shipped kernel's 32 x 32 tile on the same
   operands and times both (CUDA events, median of 5 calls after two
   warm-ups) at B = 4, 1024^3 (scores in [0, 10) with 10% -inf holes;
   TROPICAL_COUNT on integer lengths with 50% +inf), for NF <= 2 also at
   B = 12, 2048^3, and with every base one element off the 16-byte grid
   (the single-element loader) at B = 4, 1024^3. The first candidate of
   each NF up to 12 is the shipped configuration; past 12 fields nothing
   ships (the 32 x 32 tile runs), and the candidates show why.
2. **Rates.** A microbenchmark of a 8 x 8 register tile's inner step over
   64 independent accumulators: ``fmaxf(acc, x_i + y_j)`` (max-plus),
   ``fmaxf(acc, fminf(x_i, y_j))`` (max-min) and ``min.NaN(acc, x_i +
   y_j)`` (the shipped TROPICAL); elements (one combine and one
   accumulate) per second.
3. **Instruction mix.** ``cuobjdump -sass`` of the shipped kernels of the
   one-field max-plus and of ``TROPICAL_COUNT``, both tiles: the count of
   each opcode in each body (``minplus_variants.sass_mix``).

Prints the card's name and power limit, then one JSON line per result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

from time_vpu import fieldwise_maxplus, timed_ms

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

#: candidate (tm, tn, kv, bv) per field-count range; the shipped one, where
#: there is one, is added first
CANDIDATES = {
    1: [(4, 8, 2, 4)],
    2: [(4, 4, 2, 4), (8, 4, 2, 4)],
    4: [(4, 2, 4, 2), (4, 4, 4, 4)],
    8: [(4, 2, 4, 2), (1, 4, 2, 4)],
    12: [(1, 4, 2, 4), (2, 2, 1, 2), (4, 1, 4, 1)],
    16: [(1, 4, 1, 1), (2, 2, 2, 2), (1, 4, 2, 4)]}

ENTRY = r"""
extern "C" int run_large(const void* const* a, const void* const* b,
                         void* const* out, void* counters, int batch, int m,
                         int n, int k, void* stream) {
  using Alg = %s;
  using T = Alg::T;
  vpu_tiles::Operands<Alg> p;
  repro_semiring::VpuStore<Alg> st;
  for (int f = 0; f < Alg::NF; ++f) {
    p.a[f] = static_cast<const T*>(a[f]);
    p.b[f] = static_cast<const T*>(b[f]);
    st.out[f] = static_cast<T*>(out[f]);
  }
  return vpu_tiles::launch_config<Alg, vpu_tiles::Tile<%s>>(
      p, st, static_cast<int*>(counters) + 1, batch, m, n, k, stream);
}
"""

RATES_SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float min_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

// OP 0: fmaxf(acc, x + y); 1: fmaxf(acc, fminf(x, y)); 2: min.NaN(acc, x + y)
template <int OP>
__global__ void __launch_bounds__(256) rate(const float* seed, float* out,
                                            int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float x[8], y[8], acc[64];
  for (int i = 0; i < 8; ++i) {
    x[i] = seed[(t + i) & 1023];
    y[i] = seed[(t + 7 * i) & 1023];
  }
  for (int i = 0; i < 64; ++i) acc[i] = OP == 2 ? 1e30f : -1e30f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = x[i] * 0.999f + 1.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float& a = acc[8 * i + j];
        if constexpr (OP == 0) a = fmaxf(a, x[i] + y[j]);
        if constexpr (OP == 1) a = fmaxf(a, fminf(x[i], y[j]));
        if constexpr (OP == 2) a = min_nan(a, x[i] + y[j]);
      }
  }
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += acc[i];
  out[t] = s;
}

extern "C" int run_rate(int op, const void* seed, void* out, int blocks,
                        int iters) {
  auto s = static_cast<const float*>(seed);
  auto o = static_cast<float*>(out);
  if (op == 0) rate<0><<<blocks, 256>>>(s, o, iters);
  if (op == 1) rate<1><<<blocks, 256>>>(s, o, iters);
  if (op == 2) rate<2><<<blocks, 256>>>(s, o, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def sized(S, nf, tm, tn, kv, bv):
    """A candidate micro-tile with the K step and ring depth that
    ``vpu_tiles::config`` gives a shape: the deepest K step of 32, 16 or 8
    at which two stages fit, three stages where they fit; None where
    nothing fits."""
    bm, bn = 16 * tm, 16 * tn
    for bk in S._VPU_BKS:
        stage = nf * (bm * (bk + 4) + bk * bn) * S._VPU_FIELD_BYTES
        if 2 * stage <= S._VPU_SMEM_MAX:
            stages = 3 if 3 * stage <= S._VPU_SMEM_MAX else 2
            return dict(bm=bm, bn=bn, tm=tm, tn=tn, kv=kv, bv=bv, bk=bk,
                        stages=stages, smem=stages * stage)
    return None


def operands(S, sr, gen, b_, p, offset):
    """Field tuples (a, b) of (b_, p, p) on the card, each field's base
    ``offset`` elements into its allocation."""
    import torch

    def field(fill):
        buf = torch.empty(b_ * p * p + offset, device="cuda")
        x = buf[offset:].view(b_, p, p)
        x.copy_(fill())
        return x

    def scores():
        x = 10 * torch.rand((b_, p, p), generator=gen, device="cuda")
        return torch.where(torch.rand((b_, p, p), generator=gen,
                                      device="cuda") < 0.1, -float("inf"), x)

    def lengths():
        x = torch.randint(0, 4, (b_, p, p), generator=gen,
                          device="cuda").float()
        return torch.where(torch.rand((b_, p, p), generator=gen,
                                      device="cuda") < 0.5, float("inf"), x)

    if sr is S.TROPICAL_COUNT:
        da, db = field(lengths), field(lengths)
        return ((da, field(lambda: torch.where(torch.isfinite(da), 2.0, 0.0))),
                (db, field(lambda: torch.where(torch.isfinite(db), 3.0, 0.0))))
    nf = sr.num_fields
    return (tuple(field(scores) for _ in range(nf)),
            tuple(field(scores) for _ in range(nf)))


def rates(build, torch):
    import ctypes

    lib = build.build_generated({"vpurates": RATES_SOURCE})["vpurates"]
    fn = ctypes.CDLL(str(lib.path)).run_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int]
    seed = torch.rand(1024, device="cuda")
    blocks, iters = 132 * 8, 2048
    out = torch.empty(blocks * 256, device="cuda")
    for op, name in enumerate(("max-plus: fmaxf(acc, x + y)",
                               "max-min: fmaxf(acc, fminf(x, y))",
                               "min-plus: min.NaN(acc, x + y)")):
        ms = timed_ms(lambda: fn(op, seed.data_ptr(), out.data_ptr(), blocks,
                                 iters), iters=5)
        elements = blocks * 256 * iters * 64
        print(json.dumps({"rate": name, "ms": ms,
                          "elements_per_s": elements / ms * 1e3}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nf", default="1,2,3,4,5,8,9,12,16")
    args = parser.parse_args()
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("vpu_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import semiring as S

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    f32 = (torch.float32,)
    cands = []  # (spec, candidate, config, shipped)
    for nf in map(int, args.nf.split(",")):
        algs = [fieldwise_maxplus(S, nf)] + ([S.TROPICAL_COUNT]
                                             if nf == 2 else [])
        shipped = S._vpu_config(nf)
        shipped = (tuple(shipped[k] for k in ("tm", "tn", "kv", "bv"))
                   if shipped else None)
        rng = next(most for most in CANDIDATES if nf <= most)
        for sr in algs:
            for cand in [shipped] * bool(shipped) + [
                    c for c in CANDIDATES[rng] if c != shipped]:
                c = sized(S, nf, *cand)
                if c is None or c["tm"] * c["tn"] * nf > 64:
                    continue
                cands.append((sr, cand, c, cand == shipped))
    sources = {}
    for sr, cand, c, _ in cands:
        tile = ", ".join(str(c[key]) for key in (
            "bm", "bn", "tm", "tn", "kv", "bv", "bk", "stages"))
        key = f"vpuvar_{sr.name}_{'_'.join(map(str, cand))}"
        sources[key] = ('#include "semiring_generic.cuh"\n'
                        '#include "vpu_tiles.cuh"\n'
                        + S.algebra_source(sr, f32)
                        + ENTRY % (f"Algebra_{sr.name}", tile))
    gens = {S.build_key(sr, f32): S.semiring_source(sr, f32)
            for sr, *_ in cands}
    built = build.build_generated({**sources, **gens})
    print(f"built {len(built)} sources, nvcc "
          f"{max(r.seconds for r in built.values()):.2f} s the longest")

    gen = torch.Generator(device="cuda").manual_seed(19)
    counters = torch.zeros(2, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    P = ctypes.c_void_p
    cases = {}  # (algebra, shape) -> (a, b, small-tile output, its ms)

    def case(sr, b_, p, offset):
        key = (sr.name, b_, p, offset)
        if key not in cases:
            cases.clear()  # one case's operands on the card at a time
            a, b = operands(S, sr, gen, b_, p, offset)
            small = S._semiring(sr, a, b, None, True, True, tile="small")
            ms = timed_ms(lambda: S._semiring(sr, a, b, None, True, True,
                                              tile="small"), iters=5)
            cases[key] = (a, b, small, ms)
        return cases[key]

    for (sr, cand, c, shipped), key in zip(cands, sources):
        nf = sr.num_fields
        fn = ctypes.CDLL(str(built[key].path)).run_large
        fn.argtypes = [P, P, P, P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, P]
        usage = {("vec" if "Lb1E" in u["name"] else "scalar"): u
                 for u in build.kernel_usage(built[key].log)
                 if "big_tile" in u["name"]}
        row = {"algebra": sr.name, "nf": nf, "candidate": cand,
               "shipped": shipped,
               **{k: c[k] for k in ("bm", "bn", "bk", "stages", "smem")},
               "registers": {k: u["registers"] for k, u in usage.items()},
               "spills": {k: [u["spill_stores"], u["spill_loads"]]
                          for k, u in usage.items()}}
        shapes = [(4, 1024, 0), (4, 1024, 1)] + ([(12, 2048, 0)]
                                                if nf <= 2 else [])
        for b_, p, offset in shapes:
            a, b, small, small_ms = case(sr, b_, p, offset)
            out = tuple(torch.empty_like(x) for x in small)
            ptrs = [(P * nf)(*(x.data_ptr() for x in xs))
                    for xs in (a, b, out)]

            def run():
                rc = fn(*ptrs, counters.data_ptr(), b_, p, p, p, stream)
                if rc != 0:
                    raise RuntimeError(f"{key}: cudaError {rc}")

            ms = timed_ms(run, iters=5)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(out, small)):
                print(f"{key} B={b_} {p}^3 offset {offset}: differs from "
                      f"the 32 x 32 tile", file=sys.stderr)
                return 1
            tag = f"B={b_} {p}^3{' offset' if offset else ''}"
            row[tag] = {"ms": ms, "small_tile_ms": small_ms}
        print(json.dumps(row))
    cases.clear()
    rates(build, torch)
    from minplus_variants import sass_mix

    for sr in {sr.name: sr for sr, *_ in cands
               if sr.name in ("maxplus1", "tropical_count")}.values():
        lib = built[S.build_key(sr, f32)].path
        for tile in ("big_tile", "vpu_tile"):
            for name, mix in sass_mix(lib, tile).items():
                print(json.dumps({"sass": sr.name, "kernel": name[:120],
                                  "instructions": sum(mix.values()),
                                  "opcodes": mix}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

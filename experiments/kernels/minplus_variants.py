"""The large min-plus tile of ``csrc/tropical.cu``: variants, instruction
rates and instruction mix, on one card.

Three parts, all ``nvcc`` calls at once::

    python experiments/kernels/minplus_variants.py

1. **Variants.** Copies of ``src/repro_torch/kernels/csrc/tropical.cu``
   with other knobs of the large tile (``LKV``: k per shared-memory read of
   A, 2 or 4; ``LSTAGES``: ring depth), each held bit-equal to the shipped
   kernel and timed on the batched product at the sweep's stack (B=12,
   2048^3, lengths in [0, 4) with 30% +inf): with 16-byte copies (aligned
   bases) and with single-float copies (bases 4 bytes off the 16-byte
   grid). CUDA events, median of 10 calls, variants in turns, forward then
   backward, the two medians averaged.
2. **Rates.** A microbenchmark of the inner step of an 8x8 register tile,
   ``acc = min(acc, x_i + y_j)`` over 64 independent accumulators, in four
   forms: fp32 add and ``min.NaN.f32`` (the shipped fold), fp32 add and
   ``fminf``, int32 add and min, and Hopper's DPX ``__viaddmin_s32`` (add
   and min in one instruction). Each step also updates the 8 x values (one
   multiply-add each), as a tile loads them. Reports elements (one add and
   one min) per second.
3. **Instruction mix.** ``cuobjdump -sass`` of the shipped large tile:
   the count of each opcode in its body.

Prints the card's name and power limit, then one JSON line per result.
"""
from __future__ import annotations

import collections
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
VARIANTS = [(2, 3), (4, 3), (2, 2)]  # (LKV, LSTAGES); the first is shipped

RATES_SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float min_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

// OP 0: fp32 add + min.NaN; 1: fp32 add + fminf; 2: int add + min;
// 3: __viaddmin_s32
template <int OP>
__global__ void __launch_bounds__(256) rate(const float* seed, float* out,
                                            int iters) {
  using T = typename std::conditional<(OP >= 2), int, float>::type;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  T x[8], y[8], acc[64];
  for (int i = 0; i < 8; ++i) {
    x[i] = static_cast<T>(seed[(t + i) & 1023] * 100.f);
    y[i] = static_cast<T>(seed[(t + 7 * i) & 1023] * 100.f);
  }
  for (int i = 0; i < 64; ++i) acc[i] = static_cast<T>(1 << 30);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (OP >= 2)
        x[i] = static_cast<int>(
            (static_cast<unsigned>(x[i]) * 1664525u + 1013904223u) >> 4);
      else
        x[i] = x[i] * 0.999f + 1.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        T& a = acc[8 * i + j];
        if constexpr (OP == 0) a = min_nan(a, x[i] + y[j]);
        if constexpr (OP == 1) a = fminf(a, x[i] + y[j]);
        if constexpr (OP == 2) a = min(a, x[i] + y[j]);
        if constexpr (OP == 3) a = __viaddmin_s32(x[i], y[j], a);
      }
  }
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += static_cast<float>(acc[i]);
  out[t] = s;
}

extern "C" int run_rate(int op, const void* seed, void* out, int blocks,
                        int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sd = static_cast<const float*>(seed);
  float* o = static_cast<float*>(out);
  switch (op) {
    case 0: rate<0><<<blocks, 256, 0, s>>>(sd, o, iters); break;
    case 1: rate<1><<<blocks, 256, 0, s>>>(sd, o, iters); break;
    case 2: rate<2><<<blocks, 256, 0, s>>>(sd, o, iters); break;
    case 3: rate<3><<<blocks, 256, 0, s>>>(sd, o, iters); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""
RATE_NAMES = ["fp32 add + min.NaN", "fp32 add + fminf", "int32 add + min",
              "DPX __viaddmin_s32"]


def variant_source(text: str, lkv: int, stages: int) -> str:
    for name, value in (("LKV", lkv), ("LSTAGES", stages)):
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


def sass_mix(lib: pathlib.Path, kernel: str) -> dict:
    """Opcode counts in the SASS of the kernels whose name holds
    ``kernel`` (cuobjdump from the toolkit); empty without cuobjdump."""
    from repro_torch.kernels.build import find_nvcc

    tool = pathlib.Path(find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict = {}
    for block in text.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        if kernel not in name:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in
            re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                        block))
        counts[name] = dict(ops.most_common(14))
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("minplus_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import semiring as S

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    work = build.BUILD_DIR / "minplus_variants"
    if work.exists():
        shutil.rmtree(work)
    (work / "csrc").mkdir(parents=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, work / "csrc" / header.name)
    text = (build.CSRC / "tropical.cu").read_text()
    jobs = []
    for lkv, stages in VARIANTS:
        src = work / "csrc" / f"tropical_{lkv}_{stages}.cu"
        src.write_text(variant_source(text, lkv, stages))
        jobs.append((f"{lkv}_{stages}", src, work / f"lib{src.stem}.so",
                     None))
    rates_src = work / "rates.cu"
    rates_src.write_text("#include <type_traits>\n" + RATES_SOURCE)
    jobs.append(("rates", rates_src, work / "librates.so", None))
    built = build._compile(jobs)
    for key, res in built.items():
        for line in res.log.splitlines():
            if ("registers" in line or "spill" in line) and key != "rates":
                print(f"  {key}: {line.strip()}")

    # 1. variants
    libs = {}
    for lkv, stages in VARIANTS:
        lib = ctypes.CDLL(str(built[f"{lkv}_{stages}"].path))
        fn = lib.repro_minplus_batched_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[(lkv, stages)] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    bsz, p = 12, 2048
    numel = bsz * p * p

    def lengths():
        buf = torch.randint(0, 4, (numel + 4,), generator=gen,
                            device="cuda").float()
        holes = torch.rand(numel + 4, generator=gen, device="cuda") < 0.3
        return torch.where(holes, float("inf"), buf)

    bufs = (lengths(), lengths())
    counters = torch.zeros(2, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases = {"16-byte copies": 0, "single-float copies": 1}
    out = torch.empty((bsz, p, p), device="cuda")
    want = {}
    for case, off in cases.items():
        a, b = (x[off:off + numel].view(bsz, p, p) for x in bufs)
        want[case] = S.batched_minplus_matmul(a, b)
    times = {(v, c): [] for v in VARIANTS for c in cases}
    for order in (VARIANTS, VARIANTS[::-1]):
        for variant in order:
            fn = libs[variant]
            for case, off in cases.items():
                a, b = (x[off:off + numel].view(bsz, p, p) for x in bufs)

                def call():
                    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), None,
                            None, counters.data_ptr(), bsz, p, p, p, stream)
                    assert rc == 0, rc

                call()
                torch.cuda.synchronize()
                assert torch.equal(out, want[case]), (variant, case)
                times[(variant, case)].append(timed_ms(call))
    for (variant, case), ts in times.items():
        print(json.dumps({"part": "variant", "LKV": variant[0],
                          "LSTAGES": variant[1], "copies": case,
                          "shipped": variant == VARIANTS[0],
                          "ms": statistics.mean(ts), "ms_runs": ts,
                          "bit_equal": True}))

    # 2. rates
    lib = ctypes.CDLL(str(built["rates"].path))
    lib.run_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.run_rate.restype = ctypes.c_int
    seed = torch.rand(1024, generator=gen, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 2048
    sink = torch.empty(blocks * 256, device="cuda")
    elements = blocks * 256 * iters * 64
    for op, name in enumerate(RATE_NAMES):
        def call():
            assert lib.run_rate(op, seed.data_ptr(), sink.data_ptr(), blocks,
                                iters, stream) == 0

        ms = timed_ms(call)
        print(json.dumps({"part": "rate", "form": name, "ms": ms,
                          "elements_per_s": elements / ms * 1e3,
                          "elements_per_sm_per_s": elements / ms * 1e3 / sms}))

    # 3. instruction mix of the shipped large tile
    shipped = build.build_all(["tropical"])["tropical"].path
    for name, mix in sass_mix(shipped, "tropical_big_tile").items():
        print(json.dumps({"part": "sass", "kernel": name, "opcodes": mix}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The split tile of ``csrc/tropical.cu`` (``minplus_matmul`` and
``minplus_count_matmul`` off the large tile): candidate configurations,
splits of K and ring depths, their registers, spills, shared memory and
times, beside the parent's tile, on one card.

    python experiments/kernels/tropical_small_variants.py \\
        [--parent <tree>] [--quick]

0. **Signed zeros.** ``min.NaN.f32`` (the tiles' min) and ``fminf`` on
   (+0, -0) and (-0, +0): whether the min ranks -0 below +0 whichever
   operand holds it.
1. **Variants.** Per field count (1: min-plus, 2: the count product) and
   candidate ``(bm, bn, tm, tn, kv, bk, stages)``, one source includes
   ``csrc/tropical.cu`` and instantiates its ``launch_config`` with that
   tile; all ``nvcc`` calls at once. An unfused count candidate (``fused``
   0) copies ``tropical.cu`` into its own source with the per-k
   ``count_step`` (the product fused into the add) rewritten as
   ``count_update`` of the product (a multiply, then the add). Per candidate: what ptxas reports
   (registers, spill stores and loads) and ``cudaFuncGetAttributes``
   (registers, local memory, static and the most dynamic shared memory)
   for the 16-byte and the single-float loader, and the 16-byte kernel's
   SASS opcode mix (``minplus_variants.sass_mix``). Then at each shape
   (p = 384, 512, 1024, 1536 2D, ragged 300 x 200 x 260, B = 3 at p = 512;
   the count product 2D only) and each split of K in ``SPLITS``: bit-equal
   to the plain version (integer lengths with +inf holes; counts 1..3),
   event ms (CUDA events, median of 10 calls after 2 warm-ups) and device
   ms (``torch.profiler``, all kernels of 10 calls, divided by 10).
2. **Parent against change.** With ``--parent``, an unpacked tree of the
   parent commit (``git archive <commit> | tar -x -C build/parent``), its
   ``tropical.cu`` is built into this tree's ``build/`` and both products
   run through each tree's C entry point (the change's at the split its
   host rule picks, and at split 1, no cluster) at every shape, in turns:
   parent, change, change at split 1, change at split 1, change, parent.
   Per turn: event ms of one call (as above), device ms, and over 50
   calls back to back the host's µs to enqueue one and the event ms per
   call, which tell the launch's host cost from its device time.

3. **Placement.** A probe kernel launched as the split tile is, over the
   64 output tiles of a p = 512 grid split S = 1..8 ways, at 2, 3 and 4
   blocks an SM (shared memory sets the cap): the SMs its blocks land on
   and its span; and per candidate, the blocks an SM holds and the
   clusters of S the card holds at once (``cudaOccupancyMaxActiveClusters``).

``--quick`` runs part 1 on the shipped configurations only. Prints the
card's name and power limit, then one JSON line per result.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys
import threading

from minplus_variants import sass_mix
from time_vpu import device_ms, timed_ms

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

#: candidate (bm, bn, tm, tn, kv, bk, stages[, fused]) per field count
#: (fused 0: the count product's per-k update as count_update, a multiply
#: and an add, instead of count_step's fmaf; see :func:`tile_source`); the
#: shipped one is added first
CANDIDATES = {
    1: [(64, 64, 4, 4, 4, 16, 4), (64, 64, 4, 4, 4, 16, 6),
        (64, 64, 4, 4, 2, 32, 3), (64, 64, 4, 4, 4, 32, 2),
        (64, 64, 8, 8, 2, 32, 3), (128, 64, 4, 4, 4, 32, 3),
        (128, 128, 8, 8, 2, 32, 3)],
    2: [(64, 64, 4, 4, 4, 32, 3, 0), (64, 64, 4, 4, 4, 16, 4),
        (64, 64, 4, 4, 2, 32, 3), (64, 64, 4, 4, 4, 32, 2),
        (64, 64, 2, 4, 2, 32, 3), (128, 64, 4, 4, 4, 32, 3)]}
#: the splits of K timed per shape (the host rule's pick is marked)
SPLITS = (1, 2, 3, 4, 5, 6, 7, 8)
#: (batch, m, n, k), batch 0: 2D
SHAPES = ((0, 384, 384, 384), (0, 512, 512, 512), (0, 1024, 1024, 1024),
          (0, 1536, 1536, 1536), (0, 300, 200, 260), (3, 512, 512, 512))

ENTRY = r"""
%s

namespace {
using Cfg = Tile<%s>;
constexpr int NF = %d;
template <int F> struct MakeStore;
template <> struct MakeStore<1> {
  static tropical::MinPlusStore make(void* o0, void*) {
    return {static_cast<float*>(o0), nullptr, nullptr, false};
  }
};
template <> struct MakeStore<2> {
  static tropical::CountStore make(void* o0, void* o1) {
    return {static_cast<float*>(o0), static_cast<float*>(o1)};
  }
};
using Store = decltype(MakeStore<NF>::make(nullptr, nullptr));
}  // namespace

extern "C" int run_variant(const void* a0, const void* a1, const void* b0,
                           const void* b1, void* o0, void* o1,
                           void* counters, int split, int batch, int m,
                           int n, int k, void* stream) {
  const void* as[2] = {a0, a1};
  const void* bs[2] = {b0, b1};
  Operands<NF> p;
  for (int f = 0; f < NF; ++f) {
    p.a[f] = static_cast<const float*>(as[f]);
    p.b[f] = static_cast<const float*>(bs[f]);
  }
  return launch_config<NF, Cfg>(p, MakeStore<NF>::make(o0, o1),
                                static_cast<int*>(counters), split, batch, m,
                                n, k, stream);
}

// blocks of the 16-byte kernel an SM holds at once, and clusters of
// `split` blocks the card holds at once
extern "C" int variant_occupancy(int split, int* out) {
  constexpr int bytes = Cfg::template smem_bytes<NF>();
  cudaError_t e = allow_smem<split_tile<NF, Cfg, true, Store>>(bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, split_tile<NF, Cfg, true, Store>, Cfg::THREADS, bytes);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8, 8, split);
  cfg.blockDim = dim3(Cfg::THREADS);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(out + 1,
                                       split_tile<NF, Cfg, true, Store>, &cfg);
  return static_cast<int>(e);
}

// registers, local bytes, static shared bytes, most dynamic shared bytes
// and threads of the 16-byte (vec 1) or single-float (vec 0) kernel
extern "C" int variant_attributes(int vec, int* out) {
  cudaFuncAttributes f;
  const cudaError_t e =
      vec ? cudaFuncGetAttributes(&f, split_tile<NF, Cfg, true, Store>)
          : cudaFuncGetAttributes(&f, split_tile<NF, Cfg, false, Store>);
  out[0] = f.numRegs;
  out[1] = static_cast<int>(f.localSizeBytes);
  out[2] = static_cast<int>(f.sharedSizeBytes);
  out[3] = f.maxDynamicSharedSizeBytes;
  out[4] = f.maxThreadsPerBlock;
  return static_cast<int>(e);
}
"""

ZEROS = r"""
#include <cuda_runtime.h>
#include <math.h>

__global__ void zero_mins(const float* x, float* out) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x[0]), "f"(x[1]));
  out[0] = r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x[1]), "f"(x[0]));
  out[1] = r;
  out[2] = fminf(x[0], x[1]);
  out[3] = fminf(x[1], x[0]);
}

extern "C" int run_zero_mins(const void* x, void* out) {
  zero_mins<<<1, 1>>>(static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""

PLACE = r"""
#include <cuda_runtime.h>

// Where the blocks of a cluster launch land: each block records its SM and
// its first and last %globaltimer reading, spinning `spin` ns between them.
__global__ void place(int* sm, long long* t0, long long* t1, long long spin) {
  long long start, now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(start));
  now = start;
  while (now - start < spin)
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (threadIdx.x == 0) {
    const int b =
        blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    int id;
    asm("mov.u32 %0, %%smid;" : "=r"(id));
    sm[b] = id;
    t0[b] = start;
    t1[b] = now;
  }
}

extern "C" int run_place(int split, int smem, int threads, long long spin,
                         void* sm, void* t0, void* t1) {
  cudaError_t e = cudaFuncSetAttribute(
      place, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8, 8, split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, place, static_cast<int*>(sm),
                         static_cast<long long*>(t0),
                         static_cast<long long*>(t1), spin);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
"""

P, I = ctypes.c_void_p, ctypes.c_int


def placement(path, torch):
    """Part 3: how the 64 output tiles of a p = 512 grid, split S ways in
    clusters of S, land on the SMs at 2, 3 and 4 blocks an SM (shared
    memory sets the cap), each block spinning 20 us: SMs used, most blocks
    on one SM, and the launch's span in spins."""
    fn = ctypes.CDLL(str(path)).run_place
    fn.argtypes = [I, I, I, ctypes.c_longlong, P, P, P]
    spin = 20_000
    for per_sm, smem in ((2, 110 * 1024), (3, 72 * 1024), (4, 52 * 1024)):
        for split in range(1, 9):
            n = 64 * split
            sm = torch.empty(n, dtype=torch.int32, device="cuda")
            t0 = torch.empty(n, dtype=torch.int64, device="cuda")
            t1 = torch.empty(n, dtype=torch.int64, device="cuda")
            if fn(split, smem, 256, spin, sm.data_ptr(), t0.data_ptr(),
                  t1.data_ptr()) != 0:
                raise RuntimeError(f"place split {split}: launch failed")
            torch.cuda.synchronize()
            per = torch.bincount(sm.long())
            print(json.dumps({"placement": {
                "cap_per_sm": per_sm, "split": split, "blocks": n,
                "sms_used": int((per > 0).sum()),
                "most_on_one_sm": int(per.max()),
                "span_in_spins": float(t1.max() - t0.min()) / spin}}))


def smem_bytes(nf, bm, bn, tm, tn, kv, bk, stages, *_):
    """The split tile's dynamic shared memory (its ``smem_bytes``)."""
    return stages * nf * (bm * (bk + 4) + bk * bn) * 4


#: the split tile's per-k count update as ``tropical.cu`` ships it, and
#: what an unfused candidate puts in its place
FUSED_STEP = """count_step(acc[i][j][0], acc[i][j][1], sum, part(ra[i][1], kk),
                         part(rb[j / 4][1], j % 4));"""
UNFUSED_STEP = """count_update(acc[i][j][0], acc[i][j][1], sum,
                           part(ra[i][1], kk) * part(rb[j / 4][1], j % 4));"""


def fused(cand):
    return cand[7] if len(cand) > 7 else 1


def tile_source(csrc, cand):
    """What the candidate's source builds on: ``tropical.cu`` itself, or for
    an unfused candidate a copy with its per-k count update rewritten."""
    if fused(cand):
        return '#include "tropical.cu"'
    text = (csrc / "tropical.cu").read_text()
    if text.count(FUSED_STEP) != 1:
        raise RuntimeError("tropical.cu: the per-k count_step call moved; "
                           "update FUSED_STEP")
    return text.replace(FUSED_STEP, UNFUSED_STEP)


def tile_args(cand):
    """The candidate as ``Tile``'s template arguments."""
    return ", ".join(map(str, cand[:7]))


def back_to_back(fn, calls=50):
    """``calls`` calls enqueued back to back: the host's µs to enqueue one
    (the device queue has room for all, so the host does not wait) and
    the event ms per call."""
    import time

    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return host / calls * 1e6, start.elapsed_time(end) / calls


def signed_zeros(path, torch):
    fn = ctypes.CDLL(str(path)).run_zero_mins
    fn.argtypes = [P, P]
    x = torch.tensor([0.0, -0.0], device="cuda")
    out = torch.empty(4, device="cuda")
    if fn(x.data_ptr(), out.data_ptr()) != 0:
        raise RuntimeError("zero_mins launch failed")
    signs = torch.signbit(out).tolist()
    print(json.dumps({"signed_zeros": {
        "min.NaN(+0, -0)": "-0" if signs[0] else "+0",
        "min.NaN(-0, +0)": "-0" if signs[1] else "+0",
        "fminf(+0, -0)": "-0" if signs[2] else "+0",
        "fminf(-0, +0)": "-0" if signs[3] else "+0"}}))


def operands(torch, gen, batch, m, n, k):
    """Integer lengths in [0, 4) with 30% +inf holes, and counts 1..3 on
    the finite ones: (a, ca, b, cb), with a leading batch axis if any."""
    lead = (batch,) if batch else ()

    def lengths(*shape):
        x = torch.randint(0, 4, shape, generator=gen, device="cuda").float()
        holes = torch.rand(shape, generator=gen, device="cuda") < 0.3
        return torch.where(holes, float("inf"), x)

    def counts(d):
        c = torch.randint(1, 4, d.shape, generator=gen, device="cuda")
        return torch.where(torch.isfinite(d), c.float(), 0.0)

    a, b = lengths(*lead, m, k), lengths(*lead, k, n)
    return a, counts(a), b, counts(b)


def parent_library(build, tree):
    """The parent tree's tropical.cu, built into this tree's build/."""
    csrc = pathlib.Path(tree) / "src" / "repro_torch" / "kernels" / "csrc"
    src = csrc / "tropical.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    out = build.BUILD_DIR / f"libparent_tropical_{h.hexdigest()[:16]}.so"
    build._compile([("parent", src, out, csrc)])
    lib = ctypes.CDLL(str(out))
    lib.repro_minplus_f32.argtypes = [P, P, P, P, P, P, I, I, I, P]
    lib.repro_minplus_batched_f32.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                              P]
    lib.repro_minplus_count_f32.argtypes = [P, P, P, P, P, P, I, I, I, P]
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="an unpacked tree of the parent")
    parser.add_argument("--quick", action="store_true",
                        help="the shipped configurations only")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tropical_small_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import semiring as S

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    parent = {}
    if args.parent:  # built while the variants build
        thread = threading.Thread(target=lambda: parent.update(
            lib=parent_library(build, args.parent)))
        thread.start()

    cands = []  # (nf, candidate, shipped)
    for nf in (1, 2):
        c = S._MINPLUS_SPLIT
        shipped = tuple(c[key] for key in ("bm", "bn", "tm", "tn", "kv",
                                           "bk", "stages"))
        others = [] if args.quick else [x for x in CANDIDATES[nf]
                                        if x != shipped]
        cands += [(nf, shipped, True)] + [(nf, x, False) for x in others]
    sources = {f"tropvar_{nf}_{'_'.join(map(str, cand))}":
               ENTRY % (tile_source(build.CSRC, cand), tile_args(cand), nf)
               for nf, cand, _ in cands}
    built = build.build_generated({**sources, "tropical_zero_mins": ZEROS,
                                   "tropical_place": PLACE})
    print(f"built {len(built)} sources, nvcc "
          f"{max(r.seconds for r in built.values()):.2f} s the longest")
    signed_zeros(built["tropical_zero_mins"].path, torch)
    placement(built["tropical_place"].path, torch)

    gen = torch.Generator(device="cuda").manual_seed(20)
    counters = torch.zeros(len(S._MINPLUS_TILES), dtype=torch.int32,
                           device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    inputs = {}
    for batch, m, n, k in SHAPES:
        a, ca, b, cb = operands(torch, gen, batch, m, n, k)
        ref = (S.batched_minplus_matmul_ref(a, b) if batch
               else S.minplus_matmul_ref(a, b))
        cref = None if batch else S.minplus_count_matmul_ref(a, ca, b, cb)
        inputs[(batch, m, n, k)] = (a, ca, b, cb, ref, cref)

    for (nf, cand, shipped), key in zip(cands, sources):
        lib = ctypes.CDLL(str(built[key].path))
        fn = lib.run_variant
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, P]
        attrs = {}
        for vec in (1, 0):
            out = (ctypes.c_int * 5)()
            if lib.variant_attributes(vec, out) != 0:
                raise RuntimeError(f"{key}: cudaFuncGetAttributes failed")
            attrs["vec" if vec else "scalar"] = dict(zip(
                ("registers", "local_bytes", "static_smem", "max_dynamic_smem",
                 "max_threads"), list(out)))
        mangled = f"split_tileILi{nf}ENS_4TileI" + "".join(
            f"Li{v}E" for v in cand[:7])
        usage = {("vec" if mangled + "EELb1E" in u["name"] else "scalar"): u
                 for u in build.kernel_usage(built[key].log)
                 if mangled in u["name"]}
        mix = {("vec" if mangled + "EELb1E" in name else "scalar"): ops
               for name, ops in sass_mix(built[key].path, mangled).items()}
        occupancy = {}
        for split in SPLITS:
            out = (ctypes.c_int * 2)()
            if lib.variant_occupancy(split, out) != 0:
                raise RuntimeError(f"{key}: occupancy query failed")
            occupancy[split] = list(out)
        row = {"nf": nf, "candidate": cand, "shipped": shipped,
               "smem": smem_bytes(nf, *cand), "attributes": attrs,
               "blocks_per_sm": occupancy[1][0],
               "active_clusters": {s_: o[1] for s_, o in occupancy.items()},
               "spills": {k_: [u["spill_stores"], u["spill_loads"]]
                          for k_, u in usage.items()},
               "sass_16_byte_loader": mix.get("vec"), "shapes": {}}
        for shape, (a, ca, b, cb, ref, cref) in inputs.items():
            batch, m, n, k = shape
            if nf == 2 and batch:
                continue
            want = (ref,) if nf == 1 else cref
            picked = S._minplus_plan(max(batch, 1), m, n, k, nf)[1]
            res = {}
            for split in SPLITS:
                if cand[0] * cand[1] == 0 or max(batch, 1) * split > 65535:
                    continue
                outs = [torch.empty_like(want[0]) for _ in range(2)]

                def run():
                    rc = fn(a.data_ptr(), ca.data_ptr(), b.data_ptr(),
                            cb.data_ptr(), outs[0].data_ptr(),
                            outs[1].data_ptr(), counters.data_ptr(), split,
                            max(batch, 1), m, n, k, stream)
                    if rc != 0:
                        raise RuntimeError(f"{key} split {split}: "
                                           f"cudaError {rc}")

                run()
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(outs, want)):
                    print(f"{key} {shape} split {split}: differs from the "
                          f"plain version", file=sys.stderr)
                    return 1
                res[split] = {"ms": timed_ms(run), "device_ms": device_ms(run),
                              "host_pick": split == picked}
            row["shapes"][str(shape)] = res
        print(json.dumps(row))

    if args.parent:
        thread.join()
        parent = parent["lib"]
        for shape, (a, ca, b, cb, ref, cref) in inputs.items():
            batch, m, n, k = shape
            o1, o2 = torch.empty_like(ref), torch.empty_like(ref)
            c1, c2 = torch.empty_like(ref), torch.empty_like(ref)
            nocount = torch.zeros(2, dtype=torch.int32, device="cuda")
            change = S._tropical_lib()
            # both trees through their C entry points (the change's at the
            # split its host rule picks, split 0, and at split 1), so the
            # events time the same path
            if batch:
                runs = {"minplus": (
                    lambda: parent.repro_minplus_batched_f32(
                        a.data_ptr(), b.data_ptr(), o1.data_ptr(), None, None,
                        nocount.data_ptr(), batch, m, n, k, stream),
                    lambda split: change.repro_minplus_batched_f32(
                        a.data_ptr(), b.data_ptr(), c1.data_ptr(), None, None,
                        counters.data_ptr(), split, batch, m, n, k, stream))}
            else:
                runs = {"minplus": (
                    lambda: parent.repro_minplus_f32(
                        a.data_ptr(), b.data_ptr(), o1.data_ptr(), None, None,
                        nocount.data_ptr(), m, n, k, stream),
                    lambda split: change.repro_minplus_f32(
                        a.data_ptr(), b.data_ptr(), c1.data_ptr(), None, None,
                        counters.data_ptr(), split, m, n, k, stream)),
                    "count": (
                    lambda: parent.repro_minplus_count_f32(
                        a.data_ptr(), ca.data_ptr(), b.data_ptr(),
                        cb.data_ptr(), o1.data_ptr(), o2.data_ptr(), m, n, k,
                        stream),
                    lambda split: change.repro_minplus_count_f32(
                        a.data_ptr(), ca.data_ptr(), b.data_ptr(),
                        cb.data_ptr(), c1.data_ptr(), c2.data_ptr(),
                        counters.data_ptr(), split, m, n, k, stream))}
            for product, (par, chg_at) in runs.items():
                chg, chg1 = (lambda: chg_at(0)), (lambda: chg_at(1))
                want = ref if product == "minplus" else cref[0]
                for tree, fn_, got in (("parent", par, o1),
                                       ("change", chg, c1),
                                       ("change split 1", chg1, c1)):
                    if fn_() != 0:
                        raise RuntimeError(f"{tree} {product}: launch failed")
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        print(f"{product} {shape}: the {tree} differs from "
                              f"the plain version", file=sys.stderr)
                        return 1
                plan = S._minplus_plan(max(batch, 1), m, n, k,
                                       1 if product == "minplus" else 2)
                row = {"product": product, "shape": shape,
                       "change_plan": plan, "turns": []}
                for label, fn_ in (("parent", par), ("change", chg),
                                   ("change split 1", chg1),
                                   ("change split 1", chg1),
                                   ("change", chg), ("parent", par)):
                    host_us, queued_ms = back_to_back(fn_)
                    row["turns"].append({"tree": label, "ms": timed_ms(fn_),
                                         "device_ms": device_ms(fn_),
                                         "enqueue_us": host_us,
                                         "back_to_back_ms": queued_ms})
                print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())

// The register-blocked VPU tile for Hopper (sm_90a): the large tile of the
// generic semiring product, C[i,j] = fold_k accumulate(combine(A[i,k],
// B[k,j])) over a user's algebra of NF fields, 2D or batched over
// blockIdx.z, with what is stored left to a store policy. The kernel
// generated per VPU-path Semiring (kernels/semiring.py semiring_source)
// runs it where its grid has at least LARGE_MIN_BLOCKS blocks and
// semiring_generic.cuh's 32x32 tile elsewhere (launch below; kernels/
// semiring.py _vpu_tile mirrors the rule). This header is not a library of
// its own: kernels/build.py hashes every csrc/*.cuh into the name of each
// library, so an edit here rebuilds every user.
//
// Replaces (src/repro/kernels/semiring.py): the VPU path of
// semiring_matmul_pallas / semiring_matmul_batched_pallas (_vpu_kernel,
// _vpu_kernel_batched) run with a user's Semiring, on large grids.
//
// What bounds it: per (i, j, k) one combine and one accumulate per field on
// the CUDA cores, at least one issue slot each (an add, a min or a compare
// runs at one per lane per clock, 33.5 T/s on the H100 SXM): at B = 12,
// 2048^3 a one-field algebra is 2.06e11 of each against 0.6 GB of operands,
// 6.15 ms of issue slots and 0.18 ms of bytes. So the tile must keep the
// issue slots for the algebra: few shared-memory loads per operation, no
// stall on device memory.
//
// Design (tropical.cu's large min-plus tile, made generic over the algebra
// and sized by NF): 256 threads (16 x 16) per block, each a TM x TN register
// micro-tile of NF accumulators per output, its rows in two groups BM / 2
// apart (TM >= 2) and its columns in groups of BV, BN / (TN / BV) apart, so
// that the shared-memory reads are free of bank conflicts: A is staged
// [m][k] (rows padded by 4) and read KV k of one row at a time, B [k][n]
// and read BV n at a time (one field: an 8 x 8 micro-tile, KV = 2, BV = 4,
// 8 + 4 shared loads per 2 k for 128 combines and 128 accumulates). Fields
// stay separate arrays (struct of arrays). K is staged BK deep through a
// ring of STAGES cp.async copies (3 where they fit, else 2): 16-byte chunks
// where K and N are multiples of 4 and every field's bases 16-byte aligned,
// single elements otherwise (SCALAR_COPY_UNROLL at a time, so that their
// addresses do not spill). A copy outside M, N or K is not issued; its
// cells are stored as the algebra's pad_a / pad_b, one value per field.
// Each output folds accumulate over k = 0..K-1 in order, as the 32x32 tile
// does, so the two tiles agree bit for bit on every algebra, a float sum
// whose rounding depends on the order included (both also fold the pads of
// the last k step, pad_a x pad_b, which a semiring's accumulate leaves as
// it is). combine and accumulate are the user's device code, called as
// they are: an accumulate with data-dependent branches (if / else) runs
// 2.4x slower here than the same algebra written with selects (TROPICAL_
// COUNT at B = 12, 2048^3 on an H100), likely because the 16 warps an SM
// has here hide divergent branches less well than the 32x32 tile's up to
// 64. The launch counter is bumped after the stores, as in the 32x32 tile,
// where an atomic before the k loop made the tile 43% slower.
//
// Sizing: the accumulators of a thread, TM * TN * NF, stay at most MAX_ACC
// = 64 registers, and the dynamic shared memory of a block at most
// SMEM_MAX, so two blocks fit on an SM (__launch_bounds__(256, 2)): wide
// algebras take smaller micro-tiles and shallower K steps, and past 12
// fields the 32x32 tile runs whatever the grid. shape() below
// is the table, picked from the registers, spills and times of candidates
// (experiments/kernels/vpu_variants.py); config() is plain C++, so a host
// compiler can print it without a card.
#pragma once

#ifdef __CUDACC__
#define VT_FN __host__ __device__
#else
#define VT_FN
#endif

namespace vpu_tiles {

constexpr int THREADS = 256;
// the micro-tile's accumulators per thread, over all fields
constexpr int MAX_ACC = 64;
// dynamic shared memory of a block: two blocks per SM (228 KB, 1 KB of it
// reserved per block) leave 113 KB each, less 512 bytes for the tile's
// static tables (field pointers and pads)
constexpr int SMEM_MAX = 113 * 1024 - 512;
// the fewest blocks of a grid that takes the large tile: about two per SM
// of the H100's 132, as tropical.cu's large min-plus tile
constexpr long long LARGE_MIN_BLOCKS = 256;
constexpr int MAX_FIELDS = 16;
// bytes of a field: the VPU path's device types, float and int
constexpr int FIELD_BYTES = 4;

// One configuration of the tile. bk == 0: no configuration.
struct Config {
  int bm, bn;      // output tile edges
  int tm, tn;      // micro-tile of one thread (bm = 16 tm, bn = 16 tn)
  int kv, bv;      // k per shared-memory read of A, n per read of B
  int bk, stages;  // K staged per step, cp.async ring depth
  int smem;        // dynamic shared memory of one block, bytes
};

// The micro-tile and read widths for nf fields (bk, stages, smem unset),
// picked by registers, spills and time (experiments/kernels/
// vpu_variants.py): the largest micro-tile within MAX_ACC, except where a
// smaller one spills less and runs faster. Past 12 fields no
// configuration: the best candidate (16 x 64 outputs, 1 x 4 a thread)
// gained nothing on the 32 x 32 tile with aligned operands and lost 30%
// with bases off the 16-byte grid, so those algebras keep the 32 x 32 tile.
constexpr VT_FN Config shape(int nf) {
  return nf == 1    ? Config{128, 128, 8, 8, 2, 4, 0, 0, 0}
         : nf == 2  ? Config{64, 128, 4, 8, 2, 4, 0, 0, 0}
         : nf <= 4  ? Config{64, 64, 4, 4, 2, 4, 0, 0, 0}
         : nf <= 8  ? Config{32, 64, 2, 4, 2, 4, 0, 0, 0}
         : nf <= 12 ? Config{32, 32, 2, 2, 2, 2, 0, 0, 0}
                    : Config{0, 0, 0, 0, 0, 0, 0, 0, 0};
}

// Elements of one ring stage: per field, A as [bm][bk + 4] and B [bk][bn].
constexpr VT_FN int stage_elems(int nf, int bm, int bn, int bk) {
  return nf * (bm * (bk + 4) + bk * bn);
}

// The shipped configuration for nf fields (of FIELD_BYTES each): shape(nf),
// with the deepest K step of 32, 16 or 8 at which two stages fit in
// SMEM_MAX, and three stages where they fit at that depth.
constexpr VT_FN Config config(int nf) {
  Config c = shape(nf);
  for (int bk = 32; c.bm > 0 && bk >= 8; bk /= 2) {
    const int bytes = stage_elems(nf, c.bm, c.bn, bk) * FIELD_BYTES;
    if (2 * bytes <= SMEM_MAX) {
      c.bk = bk;
      c.stages = 3 * bytes <= SMEM_MAX ? 3 : 2;
      c.smem = c.stages * bytes;
      return c;
    }
  }
  return c;
}

}  // namespace vpu_tiles

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <stdint.h>

#include "counting_tiles.cuh"  // cp.async helpers, allow_smem
#include "semiring_generic.cuh"  // the 32x32 tile, VpuStore, count_launch

namespace vpu_tiles {
// Internal linkage, as counting_tiles.cuh's: two generated libraries of one
// algebra name and other field types would share the kernels' mangled
// names and allow_smem's static.
namespace {

using counting_tiles::allow_smem;
using counting_tiles::cp_async16;
using counting_tiles::cp_async4;
using counting_tiles::cp_async_commit;

// single-element copies of a stage unrolled in the loader's loop: fully
// unrolled, their addresses stay live and spill
constexpr int SCALAR_COPY_UNROLL = 4;

// A configuration as template arguments.
template <int BM_, int BN_, int TM_, int TN_, int KV_, int BV_, int BK_,
          int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, KV = KV_,
                       BV = BV_, BK = BK_, STAGES = STAGES_;
};

// The shipped configuration of an algebra.
template <class Alg>
struct Shipped {
  static constexpr Config c = config(Alg::NF);
  using type = Tile<c.bm, c.bn, c.tm, c.tn, c.kv, c.bv, c.bk, c.stages>;
};

// Vectors of W elements of T, and their parts.
template <class T, int W>
struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<int, 1> { using type = int; };
template <> struct Vec<int, 2> { using type = int2; };
template <> struct Vec<int, 4> { using type = int4; };
template <class T, int W>
using vec_t = typename Vec<T, W>::type;

__device__ __forceinline__ float part(float v, int) { return v; }
__device__ __forceinline__ int part(int v, int) { return v; }
__device__ __forceinline__ float part(const float2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ int part(const int2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ int part(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// W elements from global to shared memory (cp.async), or W copies of a pad.
template <int W, class T>
__device__ __forceinline__ void copy_in(T* dst, const T* src) {
  if constexpr (W == 4)
    cp_async16(dst, src, true);
  else
    cp_async4(dst, src, true);
}
template <int W, class T>
__device__ __forceinline__ void fill_pad(T* dst, T v) {
  if constexpr (W == 4) {
    vec_t<T, 4> w;
    w.x = w.y = w.z = w.w = v;
    *reinterpret_cast<vec_t<T, 4>*>(dst) = w;
  } else {
    *dst = v;
  }
}

template <class Alg>
struct Operands {
  const typename Alg::T* a[Alg::NF];
  const typename Alg::T* b[Alg::NF];
};

template <class Alg, class Cfg>
constexpr VT_FN int smem_bytes() {
  return Cfg::STAGES * stage_elems(Alg::NF, Cfg::BM, Cfg::BN, Cfg::BK) *
         static_cast<int>(sizeof(typename Alg::T));
}

// One stage's copies of one operand: NF fields of CH copies of W elements
// each, spread over the block's threads, U of them unrolled (0: all).
// at(f, c) issues copy c of field f.
template <int NF, int CH, int U, class At>
__device__ __forceinline__ void copies(int tid, At at) {
  static_assert(CH % THREADS == 0 || THREADS % CH == 0, "whole passes");
  constexpr int PASSES = (NF * CH + THREADS - 1) / THREADS;
  constexpr int UNROLL = U == 0 || U > PASSES ? PASSES : U;
#pragma unroll (UNROLL)
  for (int i = 0; i < PASSES; ++i) {
    if constexpr (CH >= THREADS) {
      at(i / (CH / THREADS), tid + (i % (CH / THREADS)) * THREADS);
    } else {
      const int f = i * (THREADS / CH) + tid / CH;
      if (f < NF) at(f, tid % CH);
    }
  }
}

template <class Alg, class Cfg, bool VEC, class Store>
__global__ void __launch_bounds__(THREADS, 2)
big_tile(Operands<Alg> p, Store st, int* counter, int M, int N, int K) {
  using T = typename Alg::T;
  constexpr int NF = Alg::NF;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, TM = Cfg::TM, TN = Cfg::TN;
  constexpr int KV = Cfg::KV, BV = Cfg::BV, BK = Cfg::BK;
  constexpr int STAGES = Cfg::STAGES;
  constexpr int LDA = BK + 4;     // [m][k] A rows: KV-wide reads conflict-free
  constexpr int A_F = BM * LDA;   // one field's A tile, elements
  constexpr int B_F = BK * BN;    // one field's B tile
  constexpr int STAGE = NF * (A_F + B_F);
  constexpr int RG = TM >= 2 ? 2 : 1;  // row groups, BM / RG apart
  constexpr int RH = TM / RG;          // rows per group
  constexpr int CG = TN / BV;          // column groups, BN / CG apart
  constexpr int W = VEC ? 4 : 1;       // elements per copy
  static_assert(NF >= 1 && NF <= MAX_FIELDS, "1 to 16 fields");
  static_assert(sizeof(T) == FIELD_BYTES, "4-byte fields");
  static_assert(BM == 16 * TM && BN == 16 * TN, "16 x 16 threads");
  static_assert(TM * TN * NF <= MAX_ACC, "accumulators in registers");
  static_assert(smem_bytes<Alg, Cfg>() <= SMEM_MAX, "two blocks per SM");
  static_assert(STAGES >= 2 && BK % 4 == 0 && BK % KV == 0, "the ring");
  static_assert(TM % RG == 0 && TN % BV == 0, "whole groups");
  static_assert((KV == 1 || KV == 2 || KV == 4) &&
                    (BV == 1 || BV == 2 || BV == 4),
                "read widths");
  constexpr int LU = VEC ? 0 : SCALAR_COPY_UNROLL;  // 0: all

  extern __shared__ __align__(16) unsigned char vpu_smem[];
  T* smem = reinterpret_cast<T*>(vpu_smem);
  // field pointers (moved to this block's problem of the stack) and pads,
  // for copies whose field is only known at run time
  __shared__ const T* sa[NF];
  __shared__ const T* sb[NF];
  __shared__ T spad[2][NF];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long bz = blockIdx.z;
  if (tid == 0) {
    T v[NF];
    Alg::pad_a(v);
#pragma unroll
    for (int f = 0; f < NF; ++f) spad[0][f] = v[f];
    Alg::pad_b(v);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      spad[1][f] = v[f];
      sa[f] = p.a[f] + bz * M * K;
      sb[f] = p.b[f] + bz * K * N;
    }
  }
  __syncthreads();

  // A: copy c of a field at m = c / (BK / W), k = W (c % (BK / W)), so
  // neighbouring threads walk k, A's unit-stride axis; B: at k = c / (BN /
  // W), n = W (c % (BN / W)).
  auto load = [&](int stage, int k0) {
    T* as = smem + stage * STAGE;
    T* bs = as + NF * A_F;
    copies<NF, BM * BK / W, LU>(tid, [&](int f, int c) {
      const int m = c / (BK / W), k = W * (c % (BK / W));
      T* dst = as + f * A_F + m * LDA + k;
      if (row0 + m < M && k0 + k < K)
        copy_in<W>(dst, sa[f] + (long long)(row0 + m) * K + k0 + k);
      else
        fill_pad<W>(dst, spad[0][f]);
    });
    copies<NF, BK * BN / W, LU>(tid, [&](int f, int c) {
      const int k = c / (BN / W), n = W * (c % (BN / W));
      T* dst = bs + f * B_F + k * BN + n;
      if (k0 + k < K && col0 + n < N)
        copy_in<W>(dst, sb[f] + (long long)(k0 + k) * N + col0 + n);
      else
        fill_pad<W>(dst, spad[1][f]);
    });
  };

  T acc[TM][TN][NF];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) Alg::init(acc[i][j]);

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < ktiles) load(next % STAGES, next * BK);
    cp_async_commit();

    const T* as = smem + (t % STAGES) * STAGE;
    const T* bs = as + NF * A_F;
#pragma unroll
    for (int kq = 0; kq < BK; kq += KV) {
      vec_t<T, KV> ra[TM][NF];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = (i / RH) * (BM / RG) + ty * RH + i % RH;
#pragma unroll
        for (int f = 0; f < NF; ++f)
          ra[i][f] = *reinterpret_cast<const vec_t<T, KV>*>(
              &as[f * A_F + r * LDA + kq]);
      }
#pragma unroll
      for (int kk = 0; kk < KV; ++kk) {
        vec_t<T, BV> rb[CG][NF];
#pragma unroll
        for (int g = 0; g < CG; ++g)
#pragma unroll
          for (int f = 0; f < NF; ++f)
            rb[g][f] = *reinterpret_cast<const vec_t<T, BV>*>(
                &bs[f * B_F + (kq + kk) * BN + g * (BN / CG) + tx * BV]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          T av[NF];
#pragma unroll
          for (int f = 0; f < NF; ++f) av[f] = part(ra[i][f], kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            T bv[NF], tv[NF];
#pragma unroll
            for (int f = 0; f < NF; ++f) bv[f] = part(rb[j / BV][f], j % BV);
            Alg::combine(av, bv, tv);
            Alg::accumulate(acc[i][j], tv);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  Store out = st;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i / RH) * (BM / RG) + ty * RH + i % RH;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + (j / BV) * (BN / CG) + tx * BV + j % BV;
      if (c >= N) continue;
      out(bz * M * N + (long long)r * N + c, acc[i][j]);
    }
  }
  out.finish();
  repro_semiring::count_launch(counter);  // after the loop, as the 32x32 tile
}

// One launch of the large tile in configuration Cfg; returns the launch's
// cudaError_t.
template <class Alg, class Cfg, bool VEC, class Store>
int launch_big(const Operands<Alg>& p, Store st, int* counter, int batch,
               int m, int n, int k, void* stream) {
  constexpr int bytes = smem_bytes<Alg, Cfg>();
  const cudaError_t e = allow_smem<big_tile<Alg, Cfg, VEC, Store>>(bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + Cfg::BN - 1) / Cfg::BN, (m + Cfg::BM - 1) / Cfg::BM,
                  batch);
  big_tile<Alg, Cfg, VEC, Store>
      <<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
          p, st, counter, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// Whether the 16-byte copies apply: whole chunks of 4 along k (A) and n
// (B), and every field's bases 16-byte aligned.
template <class Alg>
bool whole_chunks(const Operands<Alg>& p, int n, int k) {
  bool ok = k % 4 == 0 && n % 4 == 0;
  for (int f = 0; f < Alg::NF; ++f)
    ok = ok && reinterpret_cast<uintptr_t>(p.a[f]) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.b[f]) % 16 == 0;
  return ok;
}

// The large tile in configuration Cfg, with the copies the operands allow.
template <class Alg, class Cfg, class Store>
int launch_config(const Operands<Alg>& p, Store st, int* counter, int batch,
                  int m, int n, int k, void* stream) {
  return whole_chunks(p, n, k)
             ? launch_big<Alg, Cfg, true>(p, st, counter, batch, m, n, k,
                                          stream)
             : launch_big<Alg, Cfg, false>(p, st, counter, batch, m, n, k,
                                           stream);
}

// Whether a product of `batch` (m, n) outputs takes the large tile: its
// grid has at least LARGE_MIN_BLOCKS blocks (kernels/semiring.py _vpu_tile
// is the same rule).
template <class Alg>
bool large_tile(int batch, int m, int n) {
  constexpr Config c = Shipped<Alg>::c;
  if (c.bk == 0) return false;
  const long long blocks = (long long)batch * ((m + c.bm - 1) / c.bm) *
                           ((n + c.bn - 1) / c.bn);
  return blocks >= LARGE_MIN_BLOCKS;
}

// The generic VPU product: `batch` contiguous (m,k) x (k,n) products; a, b
// and out hold NF field pointers each. `counters` holds two ints, the
// launches of the 32x32 and of the large tile, to which the tile that runs
// adds one. tile < 0 takes the tile large_tile() picks, 0 the 32x32 tile,
// 1 the large one. Returns the launch's cudaError_t.
template <class Alg>
int launch(const void* const* a, const void* const* b, void* const* out,
           int* counters, int tile, int batch, int m, int n, int k,
           void* stream) {
  using T = typename Alg::T;
  const bool large = tile < 0 ? large_tile<Alg>(batch, m, n) : tile == 1;
  if constexpr (Shipped<Alg>::c.bk > 0) {
    if (large) {
      Operands<Alg> p;
      repro_semiring::VpuStore<Alg> st;
      for (int f = 0; f < Alg::NF; ++f) {
        p.a[f] = static_cast<const T*>(a[f]);
        p.b[f] = static_cast<const T*>(b[f]);
        st.out[f] = static_cast<T*>(out[f]);
      }
      return launch_config<Alg, typename Shipped<Alg>::type>(
          p, st, counters + 1, batch, m, n, k, stream);
    }
  }
  if (large) return static_cast<int>(cudaErrorInvalidValue);
  return repro_semiring::launch_vpu<Alg>(a, b, out, counters, batch, m, n, k,
                                         stream);
}

}  // namespace
}  // namespace vpu_tiles

#endif  // __CUDACC__

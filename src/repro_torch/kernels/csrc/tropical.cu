// Tropical (min, +) products for Hopper (sm_90a): the plain min-plus matmul,
// 2D or batched over blockIdx.z, optionally with a "changed" flag against a
// reference matrix, and the two-field (dist, count) product that sums
// counts over tying k.
//
// Replaces (src/repro/kernels/):
//   minplus_matmul        <- minplus.py minplus_matmul_pallas, i.e.
//                            semiring.py semiring_matmul_pallas on the VPU
//                            path (_vpu_kernel / _vpu_block) with TROPICAL
//   batched_minplus_matmul <- semiring.py semiring_matmul_batched_pallas on
//                            the VPU path (_vpu_kernel_batched) with TROPICAL
//   minplus_count_matmul  <- semiring.py semiring_matmul_pallas with
//                            TROPICAL_COUNT (_tc_combine / _tc_kreduce /
//                            _tc_accumulate)
//
// What bounds it: (min, +) has no tensor-core form, so every (i, j, k) is an
// fp32 add and a min (plus, for the counts, a fused multiply-add and the
// compares and selects that keep the tying k: ~5 instructions in all) on
// the CUDA cores. At the MWU oracle's shape (p =
// 384..512) one product is 2 p^3 = 0.11-0.27 GFLOP-equivalent against 3 p^2
// * 4 bytes of operands, so it is bound by the fp32 pipes, not by memory; at
// the sweep's stack (B = 12, p = 2048) one batched launch is 2.06e11 adds
// and mins against 0.6 GB, bound the same way.
//
// Design: two SIMT tiles through shared memory, picked on the host from
// (batch, m, n, k) alone (no device read), by plan() below
// (kernels/semiring.py _minplus_plan mirrors it): the large tile for a
// plain min-plus product wherever its grid has at least LARGE_MIN_BLOCKS =
// 256 blocks, about two per SM of the H100's 132 (the sweep's stacks, B =
// 12 at p = 2048: 3,072 blocks); the split tile for every other min-plus
// product and for every count product. Each tile adds one to its own
// device counter when it runs, the split tile to one counter per split.
//
// Split tile (split_tile): the large tile's register-blocked, pipelined
// mainloop on a smaller block tile, templated on the field count (1: dists;
// 2: dists and counts) and on a store policy, with the K range split over
// a thread-block cluster where the grid is small. A BM x BN output tile per
// block of (BM / TM) (BN / TN) threads, each a TM x TN register micro-tile
// whose rows sit in two groups BM / 2 apart and whose columns in groups of
// four, BN / (TN / 4) apart, so the shared-memory reads are free of bank
// conflicts: A is staged [m][k] (rows padded by 4) and read KV k of one row
// at a time, B [k][n] and read as float4 along n. K is staged BK deep
// through a ring of STAGES cp.async copies, 16-byte chunks where K and N
// are multiples of 4 and every base is 16-byte aligned, else single floats;
// a copy outside M, N or K is not issued and its cells are stored as the
// semiring's zero, +inf for dists and 0 for counts. SPLIT_SHAPE is the
// shipped configuration, picked from the registers, spills and times of
// candidates (experiments/kernels/tropical_small_variants.py).
//
// Split-K: the min-plus MWU oracle's products (p = 384..512) give 9-16
// large blocks, or 36-64 split-tile blocks, on 132 SMs. So plan() splits K
// over S <= 8 blocks (the portable cluster size) of one thread-block
// cluster (S by the constants SPLIT_*): the S blocks share one output
// tile, sit at blockIdx.z = batch * S + s, and each folds its own
// contiguous range of the K steps (s T / S .. (s + 1) T / S of T). After
// its K loop each block writes its partial tile into its own shared memory
// (the ring's), the cluster syncs, and each block combines a 1/S slice of
// the tile over the S partials in split order, read through distributed
// shared memory, then stores it; a last cluster sync keeps every block's
// shared memory alive until the others have read it. One launch
// (cudaLaunchKernelEx with a cluster dimension), no scratch tensor, no
// atomics on the data. S = 1 is the same kernel storing its registers.
//
// Exactness: within a split each output folds over k in order, and the
// partials fold in split order with the same update, so the min (with any
// rule for ties of -0 and +0, as long as it is one fixed rule) is the k-order
// fold bit for bit: min is associative, and the fold keeps the order of its
// operands. The count field's sums are regrouped by the split, exact where
// every partial sum is an integer below 2**24 (within k 2**-24 relative
// elsewhere). NaN propagates as in the JAX package's jnp.min / jnp.minimum:
// the min is min.NaN.f32 (NaN if either input is, and otherwise the same
// result as fminf's min.f32, -0 and +0 included), so a NaN sum anywhere
// along k makes the output NaN. The count update is _tc_accumulate's,
// without branches (count_step below, the product fused into the add: one
// instruction fewer, 18% less time at p = 512, the same sums wherever
// products and sums are exact): a NaN min attains nothing, so a NaN sum
// gives (NaN, 0) and the pair stays there, as the reference's
// where(x == d, ...) sums give. The split combine is count_update, the
// same update on two pairs.
//
// Large tile (tropical_big_tile): a 128x128 output tile per block of 256
// threads, an 8x8 register micro-tile per thread in two 4x4 quadrants 64
// rows/cols apart. A is staged [m][k] and read as float2 along k (LKV = 2
// k of one row), B [k][n] and read as float4 along n, all conflict-free:
// per 2 k a thread issues 8 + 4 shared loads for 128 adds and 128 mins, so
// the pipes are the limit (experiments/kernels/minplus_variants.py times
// LKV = 4, 16 loads per 4 k, and the other knobs). K is staged 32
// deep through a 3-stage ring of cp.async copies: 16-byte chunks where K
// and N are multiples of 4 and the bases 16-byte aligned (the sweep's
// stacks), else single floats (a warp copies 32 consecutive floats of one
// row: coalesced, any K, N and alignment). A copy that falls outside M, N
// or K is not issued and its cells are stored +inf instead, the
// semiring's zero. 104,448 B of dynamic shared memory, two blocks per SM.
//
// Both tiles mask ragged M, N, K with the semiring's zero, (+inf) or
// (+inf, 0), and at the store, so callers need no padding. The batch
// index is blockIdx.z (over S for the split tile), with 64-bit batch
// offsets applied once per block; the "changed" flag is one int for the
// whole stack. Both fold each output over k in order, so they agree bit
// for bit on every input. Built without --use_fast_math, so the +inf
// arithmetic and the compares keep IEEE semantics.
//
// The part above `#ifdef __CUDACC__` (the tile rule, the per-k update and
// the store policies) is plain C++, so a host compiler can check it
// without a card (tests/test_torch_tropical_tiles.py).
#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TR_FN __host__ __device__ __forceinline__
#else
#define TR_FN inline
#endif

namespace tropical {

// the large tile
constexpr int LTILE = 128;         // output tile edge
constexpr int LBK = 32;            // K staged per step
constexpr int LSTAGES = 3;         // cp.async ring depth
constexpr long long LARGE_MIN_BLOCKS = 256;

// the split tile's block tile, micro-tile, k per read of A, K step and
// ring depth, for one field and for two alike: the fastest candidate for
// both (tropical_small_variants.py part 1)
struct Shape {
  int bm, bn, tm, tn, kv, bk, stages;
};
constexpr Shape SPLIT_SHAPE = {64, 64, 4, 4, 4, 32, 3};
// Split-K: at most SPLIT_MAX blocks a cluster (the portable cluster size);
// as many as keep the grid within SPLIT_BLOCKS blocks, and at least
// SPLIT_LEAST wherever every split keeps SPLIT_MIN_STEPS K steps. A cluster
// launch of the H100 places one block an SM up to 128 blocks, but past
// that packs two or three onto some SMs of 124 while others idle
// (tropical_small_variants.py part 3), so a split past one block an SM
// runs slower; and two splits even of a large grid balance its waves.
constexpr int SPLIT_MAX = 8;
constexpr long long SPLIT_BLOCKS = 128;
constexpr int SPLIT_LEAST = 2;
constexpr int SPLIT_MIN_STEPS = 2;

// Which tile a product of `batch` (m, n, k) outputs over nf fields runs
// on, and over how many splits of K: the large tile (split 1) for a plain
// min-plus product whose large grid has at least LARGE_MIN_BLOCKS blocks;
// else the split tile, split as the constants above allow. forced >= 1
// takes the split tile with that split (a private seam for the checks).
// kernels/semiring.py _minplus_plan is the same rule.
struct Plan {
  bool large;
  int split;
};
inline Plan plan(int nf, int batch, int m, int n, int k, int forced) {
  if (forced >= 1) return Plan{false, forced};
  const long long large = (long long)batch * ((m + LTILE - 1) / LTILE) *
                          ((n + LTILE - 1) / LTILE);
  if (nf == 1 && large >= LARGE_MIN_BLOCKS) return Plan{true, 1};
  const Shape c = SPLIT_SHAPE;
  const long long blocks =
      (long long)batch * ((m + c.bm - 1) / c.bm) * ((n + c.bn - 1) / c.bn);
  long long s = SPLIT_BLOCKS / (blocks > 0 ? blocks : 1);
  if (s < SPLIT_LEAST) s = SPLIT_LEAST;
  const long long steps = ((long long)k + c.bk - 1) / c.bk;
  if (s > steps / SPLIT_MIN_STEPS) s = steps / SPLIT_MIN_STEPS;
  if (s > SPLIT_MAX) s = SPLIT_MAX;
  return Plan{false, s < 1 ? 1 : static_cast<int>(s)};
}

// NaN if either input is NaN, else the smaller, -0 below +0: the card's
// min.NaN.f32, and on the host its emulation.
TR_FN float min_nan(float x, float y) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
#else
  if (x != x || y != y) return NAN;
  if (x == y) return signbit(x) ? x : y;
  return x < y ? x : y;
#endif
}

// One k of the count product, and the split combine: (d, c) folds in the
// pair (s, p), _tc_accumulate's form without branches. The counts of the
// sides that attain the min add; a NaN min attains nothing, so the pair
// becomes (NaN, 0) and stays there.
TR_FN void count_update(float& d, float& c, float s, float p) {
  const float m = min_nan(d, s);
  c = (d == m ? c : 0.f) + (s == m ? p : 0.f);
  d = m;
}

// One k of the count product with the product fused into the add: the
// same pair as count_update(d, c, s, ca * cb) wherever ca * cb and the sum
// are exact (integer counts below 2**24), one instruction fewer.
TR_FN void count_step(float& d, float& c, float s, float ca, float cb) {
  const float m = min_nan(d, s);
  const float kept = d == m ? c : 0.f;
  c = s == m ? fmaf(ca, cb, kept) : kept;
  d = m;
}

// Store policies: what the split tile stores for an output, given its flat
// offset in the contiguous (batch, M, N) output and its NF fields.
// The min-plus product, and "changed" where it differs from `compare`
// (finish() sets the flag once per thread).
struct MinPlusStore {
  float* out;
  const float* compare;
  int* changed;
  bool differs;
  TR_FN void operator()(long long off, const float* v) {
    out[off] = v[0];
    if (compare != nullptr && v[0] != compare[off]) differs = true;
  }
  // every writer stores the same 1, so the race is benign
  TR_FN void finish() const {
    if (differs) *changed = 1;
  }
};

// The count product's two fields.
struct CountStore {
  float* od;
  float* oc;
  TR_FN void operator()(long long off, const float* v) const {
    od[off] = v[0];
    oc[off] = v[1];
  }
  TR_FN void finish() const {}
};

}  // namespace tropical

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "counting_tiles.cuh"  // cp.async helpers, allow_smem

namespace {

namespace cg = cooperative_groups;
using counting_tiles::allow_smem;
using counting_tiles::cp_async16;
using counting_tiles::cp_async4;
using counting_tiles::cp_async_commit;
using tropical::count_step;
using tropical::count_update;
using tropical::LARGE_MIN_BLOCKS;
using tropical::LBK;
using tropical::LSTAGES;
using tropical::LTILE;
using tropical::min_nan;

constexpr int THREADS = 256;       // the large tile's block

// the large tile
constexpr int LHALF = LTILE / 2;   // the micro-tile's quadrants are 64 apart
constexpr int LKV = 2;             // k per shared-memory read of A
constexpr int LA_LD = LBK + 4;     // [m][k] A rows: float2 reads conflict-free
constexpr int LSTAGE = LTILE * LA_LD + LBK * LTILE;  // floats per stage
constexpr int LARGE_SMEM = LSTAGES * LSTAGE * 4;       // 104,448 bytes

// A's shared-memory read: LKV consecutive k of one row, and its parts.
using AVec = std::conditional_t<LKV == 4, float4, float2>;
__device__ __forceinline__ float part(const float2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The first block of a launch adds one to its tile's counter (if any).
__device__ __forceinline__ void count_launch(int* counter) {
  if (counter != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0 && threadIdx.x == 0)
    atomicAdd(counter, 1);
}

// -- the split tile -----------------------------------------------------------

// A configuration of the split tile as template arguments.
template <int BM_, int BN_, int TM_, int TN_, int KV_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, KV = KV_,
                       BK = BK_, STAGES = STAGES_;
  static constexpr int THREADS = (BM / TM) * (BN / TN);
  static constexpr int LDA = BK + 4;  // [m][k] A rows
  template <int NF>
  static constexpr int smem_bytes() {
    return STAGES * NF * (BM * LDA + BK * BN) * 4;
  }
};

// The shipped configuration.
constexpr tropical::Shape SHIP = tropical::SPLIT_SHAPE;
using Shipped = Tile<SHIP.bm, SHIP.bn, SHIP.tm, SHIP.tn, SHIP.kv, SHIP.bk,
                     SHIP.stages>;

template <int W> struct FVec;
template <> struct FVec<2> { using type = float2; };
template <> struct FVec<4> { using type = float4; };

// The operands' field pointers: dists, then counts.
template <int NF>
struct Operands {
  const float* a[NF];
  const float* b[NF];
};

// the semiring's zero of field f: +inf for dists, 0 for counts
__device__ __forceinline__ float pad(int f) { return f == 0 ? INFINITY : 0.f; }

template <int NF, class Cfg, bool VEC, class Store>
__global__ void __launch_bounds__(Cfg::THREADS)
split_tile(Operands<NF> p, Store st, int* counter, int splits, int M, int N,
           int K) {
  constexpr int BM = Cfg::BM, BN = Cfg::BN, TM = Cfg::TM, TN = Cfg::TN;
  constexpr int KV = Cfg::KV, BK = Cfg::BK, STAGES = Cfg::STAGES;
  constexpr int NT = Cfg::THREADS, LDA = Cfg::LDA;
  constexpr int TX = BN / TN;         // threads along n
  constexpr int RH = TM / 2;          // rows per group; two groups BM / 2 apart
  constexpr int CG = TN / 4;          // column groups of 4, BN / CG apart
  constexpr int A_F = BM * LDA;       // one field's A tile, floats
  constexpr int B_F = BK * BN;        // one field's B tile
  constexpr int STAGE = NF * (A_F + B_F);
  constexpr int W = VEC ? 4 : 1;      // floats per copy
  constexpr int A_COPIES = BM * BK / W, B_COPIES = BK * BN / W;
  using AV = typename FVec<KV>::type;
  static_assert(NF == 1 || NF == 2, "dists, or dists and counts");
  static_assert(TM % 2 == 0 && TN % 4 == 0 && BK % KV == 0 && BK % 4 == 0 &&
                    (KV == 2 || KV == 4),
                "whole groups and reads");
  static_assert(STAGES >= 2, "a ring");
  static_assert(NF * BM * BN <= STAGES * STAGE, "the partials fit the ring");

  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int s = blockIdx.z % splits;
  const long long bz = blockIdx.z / splits;
  const float* a[NF];
  const float* b[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    a[f] = p.a[f] + bz * M * K;
    b[f] = p.b[f] + bz * K * N;
  }
  // this split's K steps
  const int ktiles = (K + BK - 1) / BK;
  const int t0 = static_cast<int>((long long)s * ktiles / splits);
  const int nt = static_cast<int>((long long)(s + 1) * ktiles / splits) - t0;

  // A: copy c at m = c / (BK / W), k = W (c % (BK / W)), so neighbouring
  // threads walk k, A's unit-stride axis; B: at k = c / (BN / W), n =
  // W (c % (BN / W)).
  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    float* as = smem + stage * STAGE;
    float* bs = as + NF * A_F;
#pragma unroll
    for (int i = 0; i < (A_COPIES + NT - 1) / NT; ++i) {
      const int c = tid + i * NT;
      if (A_COPIES % NT != 0 && c >= A_COPIES) break;
      const int m = c / (BK / W), k = W * (c % (BK / W));
      const bool in = row0 + m < M && k0 + k < K;
      const long long off = (long long)(row0 + m) * K + k0 + k;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float* dst = as + f * A_F + m * LDA + k;
        if (in) {
          if (VEC) cp_async16(dst, a[f] + off, true);
          else cp_async4(dst, a[f] + off, true);
        } else if (VEC) {
          const float v = pad(f);
          *reinterpret_cast<float4*>(dst) = make_float4(v, v, v, v);
        } else {
          *dst = pad(f);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < (B_COPIES + NT - 1) / NT; ++i) {
      const int c = tid + i * NT;
      if (B_COPIES % NT != 0 && c >= B_COPIES) break;
      const int k = c / (BN / W), n = W * (c % (BN / W));
      const bool in = k0 + k < K && col0 + n < N;
      const long long off = (long long)(k0 + k) * N + col0 + n;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float* dst = bs + f * B_F + k * BN + n;
        if (in) {
          if (VEC) cp_async16(dst, b[f] + off, true);
          else cp_async4(dst, b[f] + off, true);
        } else if (VEC) {
          const float v = pad(f);
          *reinterpret_cast<float4*>(dst) = make_float4(v, v, v, v);
        } else {
          *dst = pad(f);
        }
      }
    }
  };

  float acc[TM][TN][NF];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[i][j][f] = f == 0 ? INFINITY : 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nt) load(i, t0 + i);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < nt) load(next % STAGES, t0 + next);
    cp_async_commit();

    const float* as = smem + (t % STAGES) * STAGE;
    const float* bs = as + NF * A_F;
#pragma unroll
    for (int kq = 0; kq < BK; kq += KV) {
      AV ra[TM][NF];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = (i / RH) * (BM / 2) + ty * RH + i % RH;
#pragma unroll
        for (int f = 0; f < NF; ++f)
          ra[i][f] = *reinterpret_cast<const AV*>(&as[f * A_F + r * LDA + kq]);
      }
#pragma unroll
      for (int kk = 0; kk < KV; ++kk) {
        float4 rb[CG][NF];
#pragma unroll
        for (int g = 0; g < CG; ++g)
#pragma unroll
          for (int f = 0; f < NF; ++f)
            rb[g][f] = *reinterpret_cast<const float4*>(
                &bs[f * B_F + (kq + kk) * BN + g * (BN / CG) + tx * 4]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = part(ra[i][0], kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const float sum = x + part(rb[j / 4][0], j % 4);
            if constexpr (NF == 1) {
              acc[i][j][0] = min_nan(acc[i][j][0], sum);
            } else {
              count_step(acc[i][j][0], acc[i][j][1], sum, part(ra[i][1], kk),
                         part(rb[j / 4][1], j % 4));
            }
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  Store out = st;
  const long long base = bz * M * N;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + (i / RH) * (BM / 2) + ty * RH + i % RH;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = col0 + (j / 4) * (BN / CG) + tx * 4 + j % 4;
        if (c < N) out(base + (long long)r * N + c, acc[i][j]);
      }
    }
  } else {
    // the partial tile, [NF][BM][BN], in this block's ring
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = (i / RH) * (BM / 2) + ty * RH + i % RH;
#pragma unroll
      for (int g = 0; g < CG; ++g)
#pragma unroll
        for (int f = 0; f < NF; ++f)
          *reinterpret_cast<float4*>(
              &smem[f * BM * BN + r * BN + g * (BN / CG) + tx * 4]) =
              make_float4(acc[i][4 * g][f], acc[i][4 * g + 1][f],
                          acc[i][4 * g + 2][f], acc[i][4 * g + 3][f]);
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    // this block's slice of the tile, in units of four columns, folded
    // over the partials in split order (the cluster's block rank is s)
    constexpr int UNITS = BM * BN / 4;
    const int lo = s * UNITS / splits, hi = (s + 1) * UNITS / splits;
    for (int u = lo + tid; u < hi; u += NT) {
      const int r = u / (BN / 4), c = 4 * (u % (BN / 4));
      float v[4][NF];
      for (int q = 0; q < splits; ++q) {
        const float* part_q = cluster.map_shared_rank(smem, q);
        float4 w[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f)
          w[f] = *reinterpret_cast<const float4*>(
              &part_q[f * BM * BN + r * BN + c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (q == 0) {
#pragma unroll
            for (int f = 0; f < NF; ++f) v[e][f] = part(w[f], e);
          } else if constexpr (NF == 1) {
            v[e][0] = min_nan(v[e][0], part(w[0], e));
          } else {
            count_update(v[e][0], v[e][1], part(w[0], e), part(w[1], e));
          }
        }
      }
      if (row0 + r < M) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col0 + c + e < N)
            out(base + (long long)(row0 + r) * N + col0 + c + e, v[e]);
      }
    }
    // no block leaves while another may still read its partials
    cluster.sync();
  }
  out.finish();
  count_launch(counter);  // after the stores, as the other tiles
}

// The split tile in configuration Cfg: the grid, the cluster of `split`
// blocks along z, and the counter of that split (counters[0] for split 1,
// counters[split] above). Returns the launch's cudaError_t.
template <int NF, class Cfg, bool VEC, class Store>
int launch_split(const Operands<NF>& p, Store st, int* counters, int split,
                 int batch, int m, int n, int k, void* stream) {
  constexpr int bytes = Cfg::template smem_bytes<NF>();
  cudaError_t e = allow_smem<split_tile<NF, Cfg, VEC, Store>>(bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + Cfg::BN - 1) / Cfg::BN, (m + Cfg::BM - 1) / Cfg::BM,
                     batch * split);
  cfg.blockDim = dim3(Cfg::THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  int* counter = counters == nullptr ? nullptr
                                     : counters + (split == 1 ? 0 : split);
  e = cudaLaunchKernelEx(&cfg, split_tile<NF, Cfg, VEC, Store>, p, st,
                         counter, split, m, n, k);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Whether the 16-byte copies apply (to either tile): whole chunks of 4
// along k (A) and n (B), and every base 16-byte aligned.
template <int NF>
bool whole_chunks(const Operands<NF>& p, int n, int k) {
  bool ok = k % 4 == 0 && n % 4 == 0;
  for (int f = 0; f < NF; ++f)
    ok = ok && reinterpret_cast<uintptr_t>(p.a[f]) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.b[f]) % 16 == 0;
  return ok;
}

// The split tile in configuration Cfg, with the copies the operands allow.
template <int NF, class Cfg, class Store>
int launch_config(const Operands<NF>& p, Store st, int* counters, int split,
                  int batch, int m, int n, int k, void* stream) {
  if (split < 1 || split > tropical::SPLIT_MAX ||
      (long long)batch * split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return whole_chunks(p, n, k)
             ? launch_split<NF, Cfg, true>(p, st, counters, split, batch, m,
                                           n, k, stream)
             : launch_split<NF, Cfg, false>(p, st, counters, split, batch, m,
                                            n, k, stream);
}

// -- the large tile -----------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
tropical_big_tile(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, const float* __restrict__ compare,
                  int* __restrict__ changed, int* __restrict__ counter, int M,
                  int N, int K) {
  count_launch(counter);
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * LTILE;
  const int col0 = blockIdx.x * LTILE;
  const float inf = INFINITY;
  const long long bz = blockIdx.z;
  a += bz * M * K;
  b += bz * K * N;
  out += bz * M * N;
  if (compare != nullptr) compare += bz * M * N;

  // copies of a stage, c = tid + 256 i: 16-byte chunks (VEC), A's at m =
  // c / 8, k = 4 (c % 8) and B's at k = c / 32, n = 4 (c % 32), i = 0..3;
  // else single elements, A's at m = c / 32, k = c % 32 and B's at k =
  // c / 128, n = c % 128, i = 0..15
  const int am = VEC ? tid / 8 : tid / 32;
  const int ak = VEC ? 4 * (tid % 8) : tid % 32;
  const int bk = VEC ? tid / 32 : tid / LTILE;
  const int bn = VEC ? 4 * (tid % 32) : tid % LTILE;
  const float* ap = a + (long long)(row0 + am) * K + ak;
  const float* bp = b + (long long)bk * N + col0 + bn;
  const float4 inf4 = make_float4(inf, inf, inf, inf);

  auto load = [&](int stage, int k0) {
    float* as = smem + stage * LSTAGE;
    float* bs = as + LTILE * LA_LD;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = am + 32 * i;
        float* dst = as + m * LA_LD + ak;
        if (row0 + m < M && k0 + ak < K)
          cp_async16(dst, ap + (long long)32 * i * K, true);
        else
          *reinterpret_cast<float4*>(dst) = inf4;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = bk + 8 * i;
        float* dst = bs + k * LTILE + bn;
        if (k0 + k < K && col0 + bn < N)
          cp_async16(dst, bp + (long long)8 * i * N, true);
        else
          *reinterpret_cast<float4*>(dst) = inf4;
      }
      ap += LBK;
      bp += (long long)LBK * N;
      return;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = am + 8 * i;
      float* dst = as + m * LA_LD + ak;
      if (row0 + m < M && k0 + ak < K)
        cp_async4(dst, ap + (long long)8 * i * K, true);
      else
        *dst = inf;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = bk + 2 * i;
      float* dst = bs + k * LTILE + bn;
      if (k0 + k < K && col0 + bn < N)
        cp_async4(dst, bp + (long long)2 * i * N, true);
      else
        *dst = inf;
    }
    ap += LBK;
    bp += (long long)LBK * N;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = inf;

  const int ktiles = (K + LBK - 1) / LBK;
#pragma unroll
  for (int s = 0; s < LSTAGES - 1; ++s) {
    if (s < ktiles) load(s, s * LBK);
    cp_async_commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(LSTAGES - 2));
    __syncthreads();
    const int next = t + LSTAGES - 1;
    if (next < ktiles) load(next % LSTAGES, next * LBK);
    cp_async_commit();

    const float* as = smem + (t % LSTAGES) * LSTAGE;
    const float* bs = as + LTILE * LA_LD;
#pragma unroll
    for (int kq = 0; kq < LBK; kq += LKV) {
      // rows ty*4 + i and 64 + ty*4 + i, k kq .. kq + LKV - 1
      AVec ra[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ra[i] = *reinterpret_cast<const AVec*>(&as[(ty * 4 + i) * LA_LD + kq]);
        ra[4 + i] = *reinterpret_cast<const AVec*>(
            &as[(LHALF + ty * 4 + i) * LA_LD + kq]);
      }
#pragma unroll
      for (int kk = 0; kk < LKV; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(
            &bs[(kq + kk) * LTILE + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(
            &bs[(kq + kk) * LTILE + LHALF + tx * 4]);
        const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = part(ra[i], kk);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = min_nan(acc[i][j], x + rb[j]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  bool differs = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : LHALF + ty * 4 + (i - 4));
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : LHALF + tx * 4 + (j - 4));
      if (c >= N) continue;
      const long long off = (long long)r * N + c;
      out[off] = acc[i][j];
      if (compare != nullptr && acc[i][j] != compare[off]) differs = true;
    }
  }
  if (differs) *changed = 1;  // every writer stores the same 1
}

template <bool VEC>
int launch_large(const Operands<1>& p, void* out, const void* compare,
                 void* changed, int* counter, int batch, int m, int n, int k,
                 void* stream) {
  const cudaError_t e = allow_smem<tropical_big_tile<VEC>>(LARGE_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + LTILE - 1) / LTILE, (m + LTILE - 1) / LTILE, batch);
  tropical_big_tile<VEC><<<grid, THREADS, LARGE_SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      p.a[0], p.b[0], static_cast<float*>(out),
      static_cast<const float*>(compare), static_cast<int*>(changed), counter,
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[z] = min_k a[z,i,k] + b[z,k,j] over `batch` contiguous (m,k) x (k,n)
// fp32 problems, on the tile and split tropical::plan() picks (split >= 1
// forces the split tile with that split, at most SPLIT_MAX). When `compare`
// is not null (a contiguous (batch,m,n) stack), *changed is set to 1 if out
// differs from it anywhere in the stack; the caller zeroes it first.
// `counters` holds SPLIT_MAX + 1 ints, the launches of the split tile at
// split 1, of the large tile, then of the split tile at splits 2 ..
// SPLIT_MAX, to which the tile that runs adds one. Returns the launch's
// cudaError_t.
extern "C" int repro_minplus_batched_f32(const void* a, const void* b,
                                         void* out, const void* compare,
                                         void* changed, void* counters,
                                         int split, int batch, int m, int n,
                                         int k, void* stream) {
  int* counts = static_cast<int*>(counters);
  const Operands<1> p{{static_cast<const float*>(a)},
                      {static_cast<const float*>(b)}};
  const tropical::Plan plan = tropical::plan(1, batch, m, n, k, split);
  if (plan.large)
    return whole_chunks(p, n, k)
               ? launch_large<true>(p, out, compare, changed, counts + 1,
                                    batch, m, n, k, stream)
               : launch_large<false>(p, out, compare, changed, counts + 1,
                                     batch, m, n, k, stream);
  const tropical::MinPlusStore st{static_cast<float*>(out),
                                  static_cast<const float*>(compare),
                                  static_cast<int*>(changed), false};
  return launch_config<1, Shipped>(p, st, counts, plan.split, batch, m, n, k,
                                   stream);
}

// The 2D product: repro_minplus_batched_f32 with batch 1.
extern "C" int repro_minplus_f32(const void* a, const void* b, void* out,
                                 const void* compare, void* changed,
                                 void* counters, int split, int m, int n,
                                 int k, void* stream) {
  return repro_minplus_batched_f32(a, b, out, compare, changed, counters,
                                   split, 1, m, n, k, stream);
}

// (od, oc) = lexicographic min-plus over (dist, count) pairs: od the
// min-plus product of da and db, oc the sum of ca[i,k]*cb[k,j] over the k
// that attain it. All operands contiguous fp32; always the split tile, at
// the split tropical::plan() picks (split >= 1 forces one). `counters` as
// repro_minplus_batched_f32's. Returns the launch's cudaError_t.
extern "C" int repro_minplus_count_f32(const void* da, const void* ca,
                                       const void* db, const void* cb,
                                       void* od, void* oc, void* counters,
                                       int split, int m, int n, int k,
                                       void* stream) {
  const tropical::Plan plan = tropical::plan(2, 1, m, n, k, split);
  const Operands<2> p{
      {static_cast<const float*>(da), static_cast<const float*>(ca)},
      {static_cast<const float*>(db), static_cast<const float*>(cb)}};
  const tropical::CountStore st{static_cast<float*>(od),
                                static_cast<float*>(oc)};
  return launch_config<2, Shipped>(p, st, static_cast<int*>(counters),
                                   plan.split, 1, m, n, k, stream);
}

#endif  // __CUDACC__

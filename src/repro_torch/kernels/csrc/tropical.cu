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
// fp32 add and a min (plus a compare and a multiply-add for the counts) on
// the CUDA cores. At the MWU oracle's shape (p = 384..512) one product is
// 2 p^3 = 0.11-0.27 GFLOP-equivalent against 3 p^2 * 4 bytes of operands,
// so it is bound by the fp32 pipes, not by memory; at the sweep's stack
// (B = 12, p = 2048) one batched launch is 2.06e11 adds and mins against
// 0.6 GB, bound the same way.
//
// Design: two SIMT tiles through shared memory, picked on the host from
// the grid alone (batch, m, n; no device read): the large tile wherever
// its grid has at least LARGE_MIN_BLOCKS = 256 blocks, about two per SM of
// the H100's 132 (the sweep's stacks, B = 12 at p = 2048: 3,072 blocks),
// the small tile elsewhere (the MWU oracle's 2D products at p = 384..512,
// 9-16 large blocks, would leave most SMs idle). kernels/semiring.py
// _minplus_tile mirrors the rule. Each tile adds one to its own device
// counter when it runs.
//
// Small tile (tropical_tile, also the count product's): a 32x32 output
// tile per block of 256 threads (16x16), K staged 32 deep, each thread a
// 2x2 micro-tile whose rows and columns are 16 apart, so shared-memory
// reads are conflict-free (A is a broadcast, B is unit-stride) and the
// stores coalesce. It keeps 144-256 blocks in flight at p = 384..512, but
// it issues one shared-memory load per two operations, so load issue, not
// the add and min pipes, bounds it.
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
// index is blockIdx.z, with 64-bit batch offsets applied once per block;
// the "changed" flag is one int for the whole stack. Both fold each output
// over k in order k = 0..K-1, so they agree bit for bit on every input.
// Min is exact in any order, so minplus_matmul is bit-equal to any other
// evaluation order. The count field's sums are exact below 2**24. NaN
// propagates as in the JAX package's jnp.min / jnp.minimum: the min is
// min.NaN.f32 (NaN if either input is, and otherwise the same result as
// fminf's min.f32, -0 and +0 included), so a NaN sum anywhere along k makes
// the output NaN. The count product keeps its lexicographic update as it
// was (a NaN sum takes neither branch) and a NaN-propagating min of the
// sums beside it, one instruction per (i, j, k); at the store a NaN there
// makes the pair (NaN, 0), as the reference's where(x == d, ...) sums give.
// Built without --use_fast_math, so the +inf arithmetic and the compares
// keep IEEE semantics.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "counting_tiles.cuh"  // cp.async helpers, allow_smem

namespace {

using counting_tiles::allow_smem;
using counting_tiles::cp_async16;
using counting_tiles::cp_async4;
using counting_tiles::cp_async_commit;

constexpr int TILE = 32;  // output tile edge (BM = BN)
constexpr int BK = 32;    // K staged through shared memory per step
constexpr int TSUB = 2;   // micro-tile edge per thread
constexpr int THREADS = (TILE / TSUB) * (TILE / TSUB);  // 256
constexpr int STEP = TILE / TSUB;  // 16: micro-tile rows/cols are 16 apart

// the large tile
constexpr int LTILE = 128;         // output tile edge
constexpr int LBK = 32;            // K staged per step
constexpr int LSTAGES = 3;         // cp.async ring depth
constexpr int LHALF = LTILE / 2;   // the micro-tile's quadrants are 64 apart
constexpr int LKV = 2;             // k per shared-memory read of A
constexpr int LA_LD = LBK + 4;     // [m][k] A rows: float2 reads conflict-free
constexpr int LSTAGE = LTILE * LA_LD + LBK * LTILE;  // floats per stage
constexpr int LARGE_SMEM = LSTAGES * LSTAGE * 4;       // 104,448 bytes
constexpr long long LARGE_MIN_BLOCKS = 256;

// NaN if either input is NaN, else fminf(x, y)
__device__ __forceinline__ float fmin_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

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

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
tropical_tile(const float* __restrict__ da, const float* __restrict__ ca,
              const float* __restrict__ db, const float* __restrict__ cb,
              float* __restrict__ od, float* __restrict__ oc,
              const float* __restrict__ compare, int* __restrict__ changed,
              int* __restrict__ counter, int M, int N, int K) {
  count_launch(counter);
  // A tiles are stored transposed ([k][m]) with one column of padding, so
  // the row-major global reads (neighbouring threads along k) store
  // without bank conflicts.
  __shared__ float Ad[BK][TILE + 1];
  __shared__ float Bd[BK][TILE];
  __shared__ float Ac[COUNT ? BK : 1][TILE + 1];
  __shared__ float Bc[COUNT ? BK : 1][TILE];

  const int tid = threadIdx.x;
  const int tx = tid % STEP;
  const int ty = tid / STEP;
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const float inf = INFINITY;
  // this block's problem of the stack: the bases move once, so the tile's
  // own offsets stay those of a 2D product
  const long long bz = blockIdx.z;
  da += bz * M * K;
  db += bz * K * N;
  od += bz * M * N;
  if (COUNT) {
    ca += bz * M * K;
    cb += bz * K * N;
    oc += bz * M * N;
  }
  if (compare != nullptr) compare += bz * M * N;

  float accd[TSUB][TSUB];
  float accc[TSUB][TSUB];
  float sums_min[TSUB][TSUB];  // count path: NaN once any sum is NaN
#pragma unroll
  for (int i = 0; i < TSUB; ++i)
#pragma unroll
    for (int j = 0; j < TSUB; ++j) {
      accd[i][j] = inf;
      accc[i][j] = 0.f;
      sums_min[i][j] = inf;
    }

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int t = 0; t < (TILE * BK) / THREADS; ++t) {
      const int idx = tid + t * THREADS;
      // A: neighbouring threads walk k (A's unit-stride axis)
      const int am = idx / BK, ak = idx % BK;
      const int gm = row0 + am, gk = k0 + ak;
      const bool a_in = gm < M && gk < K;
      const long long aoff = (long long)gm * K + gk;
      Ad[ak][am] = a_in ? da[aoff] : inf;
      // B: neighbouring threads walk n (B's unit-stride axis)
      const int bk = idx / TILE, bn = idx % TILE;
      const int gk2 = k0 + bk, gn = col0 + bn;
      const bool b_in = gk2 < K && gn < N;
      const long long boff = (long long)gk2 * N + gn;
      Bd[bk][bn] = b_in ? db[boff] : inf;
      if (COUNT) {
        Ac[ak][am] = a_in ? ca[aoff] : 0.f;
        Bc[bk][bn] = b_in ? cb[boff] : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TSUB], rb[TSUB], rca[TSUB], rcb[TSUB];
#pragma unroll
      for (int i = 0; i < TSUB; ++i) {
        ra[i] = Ad[kk][ty + i * STEP];
        rb[i] = Bd[kk][tx + i * STEP];
        if (COUNT) {
          rca[i] = Ac[kk][ty + i * STEP];
          rcb[i] = Bc[kk][tx + i * STEP];
        }
      }
#pragma unroll
      for (int i = 0; i < TSUB; ++i)
#pragma unroll
        for (int j = 0; j < TSUB; ++j) {
          const float s = ra[i] + rb[j];
          if (COUNT) {
            // lexicographic: a shorter k resets the count, a tie adds; the
            // (inf, 0) pad only ever adds 0
            const float c = rca[i] * rcb[j];
            if (s < accd[i][j]) {
              accd[i][j] = s;
              accc[i][j] = c;
            } else if (s == accd[i][j]) {
              accc[i][j] += c;
            }
            sums_min[i][j] = fmin_nan(sums_min[i][j], s);
          } else {
            accd[i][j] = fmin_nan(accd[i][j], s);
          }
        }
    }
    __syncthreads();
  }

  bool differs = false;
#pragma unroll
  for (int i = 0; i < TSUB; ++i) {
    const int r = row0 + ty + i * STEP;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TSUB; ++j) {
      const int c = col0 + tx + j * STEP;
      if (c >= N) continue;
      const long long off = (long long)r * N + c;
      if (COUNT && sums_min[i][j] != sums_min[i][j]) {  // a NaN sum
        accd[i][j] = sums_min[i][j];
        accc[i][j] = 0.f;
      }
      od[off] = accd[i][j];
      if (COUNT) oc[off] = accc[i][j];
      if (compare != nullptr && accd[i][j] != compare[off]) differs = true;
    }
  }
  // every writer stores the same 1, so the race is benign
  if (differs) *changed = 1;
}

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
            acc[i][j] = fmin_nan(acc[i][j], x + rb[j]);
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

// Whether the plain min-plus product of `batch` (m, n) outputs takes the
// large tile (kernels/semiring.py _minplus_tile is the same rule).
bool large_tile(int batch, int m, int n) {
  const long long blocks = (long long)batch * ((m + LTILE - 1) / LTILE) *
                           ((n + LTILE - 1) / LTILE);
  return blocks >= LARGE_MIN_BLOCKS;
}

template <bool COUNT>
int launch(const void* da, const void* ca, const void* db, const void* cb,
           void* od, void* oc, const void* compare, void* changed,
           int* counter, int batch, int m, int n, int k, void* stream) {
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, batch);
  tropical_tile<COUNT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(da), static_cast<const float*>(ca),
      static_cast<const float*>(db), static_cast<const float*>(cb),
      static_cast<float*>(od), static_cast<float*>(oc),
      static_cast<const float*>(compare), static_cast<int*>(changed), counter,
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_large(const void* a, const void* b, void* out,
                 const void* compare, void* changed, int* counter, int batch,
                 int m, int n, int k, void* stream) {
  const cudaError_t e = allow_smem<tropical_big_tile<VEC>>(LARGE_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + LTILE - 1) / LTILE, (m + LTILE - 1) / LTILE, batch);
  tropical_big_tile<VEC><<<grid, THREADS, LARGE_SMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), static_cast<const float*>(compare),
      static_cast<int*>(changed), counter, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// The large tile's 16-byte copies need whole chunks of 4 along k (A) and n
// (B), and 16-byte aligned bases.
bool whole_chunks(const void* a, const void* b, int n, int k) {
  return k % 4 == 0 && n % 4 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

// out[z] = min_k a[z,i,k] + b[z,k,j] over `batch` contiguous (m,k) x (k,n)
// fp32 problems, on the tile large_tile() picks. When `compare` is not
// null (a contiguous (batch,m,n) stack), *changed is set to 1 if out
// differs from it anywhere in the stack; the caller zeroes it first.
// `counters` holds two ints, the launches of the small and the large tile,
// to which the tile that runs adds one. Returns the launch's cudaError_t.
extern "C" int repro_minplus_batched_f32(const void* a, const void* b,
                                         void* out, const void* compare,
                                         void* changed, void* counters,
                                         int batch, int m, int n, int k,
                                         void* stream) {
  int* counts = static_cast<int*>(counters);
  if (large_tile(batch, m, n))
    return whole_chunks(a, b, n, k)
               ? launch_large<true>(a, b, out, compare, changed, counts + 1,
                                    batch, m, n, k, stream)
               : launch_large<false>(a, b, out, compare, changed, counts + 1,
                                     batch, m, n, k, stream);
  return launch<false>(a, nullptr, b, nullptr, out, nullptr, compare, changed,
                       counts, batch, m, n, k, stream);
}

// The 2D product: repro_minplus_batched_f32 with batch 1.
extern "C" int repro_minplus_f32(const void* a, const void* b, void* out,
                                 const void* compare, void* changed,
                                 void* counters, int m, int n, int k,
                                 void* stream) {
  return repro_minplus_batched_f32(a, b, out, compare, changed, counters, 1,
                                   m, n, k, stream);
}

// (od, oc) = lexicographic min-plus over (dist, count) pairs: od the
// min-plus product of da and db, oc the sum of ca[i,k]*cb[k,j] over the k
// that attain it. All operands contiguous fp32; always the small tile.
// Returns the launch's cudaError_t.
extern "C" int repro_minplus_count_f32(const void* da, const void* ca,
                                       const void* db, const void* cb,
                                       void* od, void* oc, int m, int n,
                                       int k, void* stream) {
  return launch<true>(da, ca, db, cb, od, oc, nullptr, nullptr, nullptr, 1, m,
                      n, k, stream);
}

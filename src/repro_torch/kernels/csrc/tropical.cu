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
// Design: a SIMT tile through shared memory. A 32x32 output tile per block
// of 256 threads (16x16), K staged 32 deep, each thread a 2x2 micro-tile
// whose rows and columns are 16 apart, so shared-memory reads are
// conflict-free (A is a broadcast, B is unit-stride) and the stores
// coalesce. The small tile keeps 144-256 blocks in flight at p = 384..512.
// Ragged M, N, K are masked at the loads with the semiring's zero, (+inf)
// or (+inf, 0), and at the store, so callers need no padding. The batch
// index is blockIdx.z, with 64-bit batch offsets; the "changed" flag is one
// int for the whole stack.
//
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

namespace {

constexpr int TILE = 32;  // output tile edge (BM = BN)
constexpr int BK = 32;    // K staged through shared memory per step
constexpr int TSUB = 2;   // micro-tile edge per thread
constexpr int THREADS = (TILE / TSUB) * (TILE / TSUB);  // 256
constexpr int STEP = TILE / TSUB;  // 16: micro-tile rows/cols are 16 apart

// NaN if either input is NaN, else fminf(x, y)
__device__ __forceinline__ float fmin_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
tropical_tile(const float* __restrict__ da, const float* __restrict__ ca,
              const float* __restrict__ db, const float* __restrict__ cb,
              float* __restrict__ od, float* __restrict__ oc,
              const float* __restrict__ compare, int* __restrict__ changed,
              int M, int N, int K) {
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

template <bool COUNT>
int launch(const void* da, const void* ca, const void* db, const void* cb,
           void* od, void* oc, const void* compare, void* changed, int batch,
           int m, int n, int k, void* stream) {
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, batch);
  tropical_tile<COUNT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(da), static_cast<const float*>(ca),
      static_cast<const float*>(db), static_cast<const float*>(cb),
      static_cast<float*>(od), static_cast<float*>(oc),
      static_cast<const float*>(compare), static_cast<int*>(changed), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[z] = min_k a[z,i,k] + b[z,k,j] over `batch` contiguous (m,k) x (k,n)
// fp32 problems. When `compare` is not null (a contiguous (batch,m,n)
// stack), *changed is set to 1 if out differs from it anywhere in the
// stack; the caller zeroes it first. Returns the launch's cudaError_t.
extern "C" int repro_minplus_batched_f32(const void* a, const void* b,
                                         void* out, const void* compare,
                                         void* changed, int batch, int m,
                                         int n, int k, void* stream) {
  return launch<false>(a, nullptr, b, nullptr, out, nullptr, compare, changed,
                       batch, m, n, k, stream);
}

// The 2D product: repro_minplus_batched_f32 with batch 1.
extern "C" int repro_minplus_f32(const void* a, const void* b, void* out,
                                 const void* compare, void* changed, int m,
                                 int n, int k, void* stream) {
  return repro_minplus_batched_f32(a, b, out, compare, changed, 1, m, n, k,
                                   stream);
}

// (od, oc) = lexicographic min-plus over (dist, count) pairs: od the
// min-plus product of da and db, oc the sum of ca[i,k]*cb[k,j] over the k
// that attain it. All operands contiguous fp32. Returns the launch's
// cudaError_t.
extern "C" int repro_minplus_count_f32(const void* da, const void* ca,
                                       const void* db, const void* cb,
                                       void* od, void* oc, int m, int n,
                                       int k, void* stream) {
  return launch<true>(da, ca, db, cb, od, oc, nullptr, nullptr, 1, m, n, k,
                      stream);
}

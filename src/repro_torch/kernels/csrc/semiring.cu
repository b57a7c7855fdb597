// Counting-semiring GEMMs for Hopper (sm_90a): the fused BFS frontier step,
// the plain counting product and the boolean (reachability) product, all
// batched over blockIdx.z. One tile body, three epilogues.
//
// Replaces (src/repro/kernels/semiring.py):
//   frontier_step      <- frontier_step_batched_pallas / _frontier_kernel_batched
//                         (and the 2D frontier_step_pallas / _frontier_kernel, B = 1)
//   count_matmul       <- semiring_matmul_batched_pallas / _mxu_kernel_batched
//                         with COUNTING (and the 2D semiring_matmul_pallas, B = 1)
//   reachability_step  <- semiring_matmul_pallas / _mxu_kernel with BOOLEAN,
//                         via reachability.py reachability_step_pallas: the
//                         fp32 dot, then acc > 0.5, the counts never stored
//
// What bounds it: at the sweep's shape (B = 12, M = N = K = 2048) one launch
// is 2*B*M*N*K = 2.06e11 fp32 operations (an FMA counts two) against ~0.8 GB
// of operands, so it is bound by the card's IEEE-fp32 rate, not by memory. The counts must
// stay exact below 2**24, so no TF32 and no tensor-core path: every product
// is an fp32 FMA on the CUDA cores. The boolean product does the same work
// per (i, j, k) and only thresholds at the store.
//
// Design: the classic shared-memory tiled SGEMM. A 128x128 output tile per
// block of 256 threads, K staged through shared memory 8 deep, and an 8x8
// register micro-tile per thread (two 4x4 quadrants 64 rows/cols apart, so
// the shared-memory reads are float4 and conflict-free). Operand reuse in
// registers and shared memory keeps the FMA units fed from on-chip memory;
// each operand element is read from device memory only once per tile row or
// column. Ragged M, N, K are masked at the loads (zero fill) and at the store,
// so callers need no padding. The frontier epilogue reads the distance
// block once and keeps acc only where acc > 0 and dist is +inf; the boolean
// epilogue stores acc > 0.5 as 1 or 0. For {0,1} masks that threshold cannot
// depend on summation order: a sum of nonnegative fp32 terms never rounds
// below its largest term. Batch and row offsets are 64-bit. Built without
// --use_fast_math so isinf is exact.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int A_PAD = 4;  // keeps the row-major A tile stores bank-conflict free

// One strided (batch, row, col) view of the left operand, in elements.
struct Strided {
  const float* ptr;
  long long sb, sr, sc;
};

// What the tile stores: the counts, the counts masked to first reaches, or
// the boolean threshold of the counts.
enum Epilogue { kCount, kFrontier, kBoolean };

template <Epilogue EPI>
__global__ void __launch_bounds__(THREADS)
tile_gemm(Strided a, const float* __restrict__ b, const float* __restrict__ d,
          float* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long bz = blockIdx.z;

  const float* ab = a.ptr + bz * a.sb;
  const float* bb = b + bz * (long long)K * N;
  const long long cbase = bz * (long long)M * N;
  // neighbouring threads walk A's unit-stride axis: rows for a transposed view
  const bool a_rows_fast = (a.sr == 1 && a.sc != 1);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int m = a_rows_fast ? idx % BM : idx / BK;
      const int k = a_rows_fast ? idx / BM : idx % BK;
      const int gm = row0 + m;
      const int gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? ab[gm * a.sr + gk * a.sc] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int k = idx / BN;
      const int n = idx % BN;
      const int gk = k0 + k;
      const int gn = col0 + n;
      Bs[k][n] = (gk < K && gn < N) ? bb[(long long)gk * N + gn] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tx * 4]);
      const float ra[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
      if (col >= N) continue;
      const long long off = cbase + (long long)r * N + col;
      float v = acc[i][j];
      if (EPI == kFrontier) {
        const float dv = d[off];
        v = (v > 0.f && isinf(dv) && dv > 0.f) ? v : 0.f;
      } else if (EPI == kBoolean) {
        v = v > 0.5f ? 1.f : 0.f;
      }
      c[off] = v;
    }
  }
}

template <Epilogue EPI>
int launch(Strided a, const void* b, const void* d, void* c, int batch, int m,
           int n, int k, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  tile_gemm<EPI><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(b), static_cast<const float*>(d),
      static_cast<float*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X = where((F@A > 0) & (D == +inf), F@A, 0) over `batch` contiguous
// (m,k)x(k,n) problems. Returns the launch's cudaError_t.
extern "C" int repro_frontier_step_f32(const void* f, const void* a,
                                       const void* d, void* x, int batch,
                                       int m, int n, int k, void* stream) {
  const Strided fv{static_cast<const float*>(f), (long long)m * k, k, 1};
  return launch<kFrontier>(fv, a, d, x, batch, m, n, k, stream);
}

// C = A@B over `batch` problems; A is read through its strides (batch, row,
// col, in elements), so a transposed view needs no copy. B and C are
// contiguous. Returns the launch's cudaError_t.
extern "C" int repro_count_matmul_f32(const void* a, long long sab,
                                      long long sar, long long sac,
                                      const void* b, void* c, int batch, int m,
                                      int n, int k, void* stream) {
  const Strided av{static_cast<const float*>(a), sab, sar, sac};
  return launch<kCount>(av, b, nullptr, c, batch, m, n, k, stream);
}

// R = (A@B > 0.5) as fp32 {0,1} over `batch` problems: the boolean-semiring
// product of {0,1} masks. A is read through its strides, as in
// repro_count_matmul_f32; B and R are contiguous. Returns the launch's
// cudaError_t.
extern "C" int repro_reachability_step_f32(const void* a, long long sab,
                                           long long sar, long long sac,
                                           const void* b, void* r, int batch,
                                           int m, int n, int k, void* stream) {
  const Strided av{static_cast<const float*>(a), sab, sar, sac};
  return launch<kBoolean>(av, b, nullptr, r, batch, m, n, k, stream);
}

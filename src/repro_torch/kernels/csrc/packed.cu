// Narrow-cell counting GEMMs for Hopper (sm_90a): the packed BFS frontier
// step and the counting product of an int32 left operand with a uint8 right
// operand, batched over blockIdx.z.
//
// Replaces (src/repro/kernels/semiring.py):
//   frontier_step_packed <- frontier_step_packed_pallas / _frontier_kernel_packed
//                           (B = 1) and frontier_step_packed_batched_pallas /
//                           _frontier_kernel_packed_batched
//   count_matmul_narrow  <- semiring_matmul_pallas / _mxu_kernel with COUNTING,
//                           a uint32 left and uint8 right operand and
//                           out_dtype=f32 (the streamed pump's panel product)
//
// The packed cells: the frontier is int32 counts (every stored count is at
// most MULT_SAT = 2**24, so int32 holds exactly what the TPU kernel's uint32
// holds), the adjacency uint8 {0,1}, the distances int16 with DIST_UNREACHED
// = 32767 as +inf. Products accumulate in IEEE fp32 (fmaf, no TF32, no fast
// math), as the TPU kernels do. Every operand is an integer of at most 2**24,
// so the conversion to fp32 is exact and each partial sum is exact while it
// stays below 2**24; all terms are nonnegative, so a sum that passes 2**24
// ends at or above it in any order and the epilogue's clamp at MULT_SAT gives
// the same bits whatever the order.
//
// What bounds it: on the extreme-scale path M is the source tile, 32 rows,
// and N = K is the padded router count, ~1e5. One step is 2*M*N*K = 6.4e11
// fp32 operations (an FMA counts two) against the K*N-byte adjacency (10 GB):
// ~9.5 ms of operations at 67 TFLOP/s, ~3.0 ms of bytes at 3.35 TB/s, so the
// IEEE-fp32 rate bounds it. Counts must stay exact, so there is no
// tensor-core path yet.
//
// Design: a 32x128 output tile per block of 128 threads, so the 32-row
// source tile fills one tile edge instead of idling three quarters of a
// 128-row one. K is staged through shared memory 32 deep; each thread keeps
// a 4x8 register micro-tile (4 rows, two groups of 4 columns 64 apart, so the
// shared-memory reads are float4 and conflict-free). The left operand is
// read through its strides (the pump's [:, k0:k0+kp] frontier slab is a
// strided view) and widened to fp32 on the way into shared memory. The
// uint8 panel is read 4 bytes a thread, neighbouring threads on neighbouring
// words, widened in registers and stored as float4; a scalar path takes
// widths that are not a multiple of 4. Ragged M, N, K are masked at the
// loads (zero fill) and at the store. The frontier epilogue reads the int16
// distance block once and writes where((acc > 0) & (d == DIST_UNREACHED),
// min(acc, MULT_SAT), 0) as int32. Batch and row offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
constexpr int F_PAD = 4;  // keeps the transposed frontier rows 16-byte aligned
constexpr float MULT_SAT = 16777216.f;  // 2**24
constexpr int16_t DIST_UNREACHED = 32767;

// One strided (batch, row, col) view of the int32 left operand, in elements.
struct Strided {
  const int32_t* ptr;
  long long sb, sr, sc;
};

template <bool FRONTIER, bool VEC>
__global__ void __launch_bounds__(THREADS)
narrow_gemm(Strided f, const uint8_t* __restrict__ a,
            const int16_t* __restrict__ d, void* __restrict__ out, int M,
            int N, int K) {
  __shared__ __align__(16) float Fs[BK][BM + F_PAD];
  __shared__ __align__(16) float As[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // 0..15: column group
  const int ty = tid / (BN / TN);  // 0..7: row group
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long bz = blockIdx.z;

  const int32_t* fb = f.ptr + bz * f.sb;
  const uint8_t* ab = a + bz * (long long)K * N;
  const long long obase = bz * (long long)M * N;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // frontier tile, BM x BK: neighbouring threads walk k, the slab's unit
    // stride, and store it transposed (k-major) for the float4 reads below
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int m = idx / BK;
      const int k = idx % BK;
      const int gm = row0 + m;
      const int gk = k0 + k;
      Fs[k][m] = (gm < M && gk < K)
                     ? (float)fb[(long long)gm * f.sr + (long long)gk * f.sc]
                     : 0.f;
    }
    // adjacency tile, BK x BN bytes
    if (VEC) {
#pragma unroll
      for (int i = 0; i < (BK * BN / 4) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int k = idx / (BN / 4);
        const int c = (idx % (BN / 4)) * 4;
        const int gk = k0 + k;
        const int gn = col0 + c;  // N % 4 == 0: the word is all in or all out
        uchar4 v = make_uchar4(0, 0, 0, 0);
        if (gk < K && gn < N)
          v = *reinterpret_cast<const uchar4*>(ab + (long long)gk * N + gn);
        *reinterpret_cast<float4*>(&As[k][c]) =
            make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < (BK * BN) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int k = idx / BN;
        const int n = idx % BN;
        const int gk = k0 + k;
        const int gn = col0 + n;
        As[k][n] = (gk < K && gn < N) ? (float)ab[(long long)gk * N + gn] : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&Fs[kk][ty * TM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&As[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&As[kk][BN / 2 + tx * 4]);
      const float ra[TM] = {a4.x, a4.y, a4.z, a4.w};
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
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
      if (col >= N) continue;
      const long long off = obase + (long long)r * N + col;
      if (FRONTIER) {
        const float v = acc[i][j];
        const bool fresh = v > 0.f && d[off] == DIST_UNREACHED;
        static_cast<int32_t*>(out)[off] = fresh ? (int32_t)fminf(v, MULT_SAT) : 0;
      } else {
        static_cast<float*>(out)[off] = acc[i][j];
      }
    }
  }
}

template <bool FRONTIER>
int launch(Strided f, const void* a, const void* d, void* out, int batch,
           int m, int n, int k, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* ap = static_cast<const uint8_t*>(a);
  const int16_t* dp = static_cast<const int16_t*>(d);
  // 4-byte panel loads need every row to start on a word
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(ap) % 4 == 0;
  if (vec)
    narrow_gemm<FRONTIER, true><<<grid, THREADS, 0, s>>>(f, ap, dp, out, m, n, k);
  else
    narrow_gemm<FRONTIER, false><<<grid, THREADS, 0, s>>>(f, ap, dp, out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X = where((F@A > 0) & (D == DIST_UNREACHED), min(F@A, MULT_SAT), 0) over
// `batch` contiguous problems: F int32 (m,k), A uint8 (k,n), D int16 (m,n),
// X int32 (m,n). Returns the launch's cudaError_t.
extern "C" int repro_frontier_step_packed(const void* f, const void* a,
                                          const void* d, void* x, int batch,
                                          int m, int n, int k, void* stream) {
  const Strided fv{static_cast<const int32_t*>(f), (long long)m * k, k, 1};
  return launch<true>(fv, a, d, x, batch, m, n, k, stream);
}

// C = A@B in fp32 over `batch` problems: A int32 read through its strides
// (batch, row, col, in elements), B uint8 (k,n) and C fp32 (m,n) contiguous.
// Returns the launch's cudaError_t.
extern "C" int repro_count_matmul_narrow(const void* a, long long sab,
                                         long long sar, long long sac,
                                         const void* b, void* c, int batch,
                                         int m, int n, int k, void* stream) {
  const Strided av{static_cast<const int32_t*>(a), sab, sar, sac};
  return launch<false>(av, b, nullptr, c, batch, m, n, k, stream);
}

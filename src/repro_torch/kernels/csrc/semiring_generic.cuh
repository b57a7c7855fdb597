// Generic semiring products for Hopper (sm_90a): the blocked product over a
// user's algebra, 2D or batched over blockIdx.z. A VPU-path algebra
// (combine / accumulate over NF fields) runs on two tiles: vpu_tiles.cuh's
// register-blocked, cp.async-pipelined tile where the grid is large, and
// this header's 32x32 tile elsewhere. An MXU-path algebra (the IEEE fp32 dot
// with the algebra's epilogue at the store) runs on counting_tiles.cuh, the
// GEMM of count_matmul, with the store policy MxuStore below.
//
// Replaces (src/repro/kernels/semiring.py):
//   semiring_matmul         <- semiring_matmul_pallas (_vpu_kernel,
//                              _mxu_kernel) run with a user's Semiring
//   semiring_matmul_batched <- semiring_matmul_batched_pallas
//                              (_vpu_kernel_batched, _mxu_kernel_batched)
//
// How it is used: this header is not a library of its own. For each algebra
// and field types, kernels/semiring.py emits a source that includes it (and
// vpu_tiles.cuh for the VPU path, counting_tiles.cuh for the MXU path),
// defines one algebra struct from the
// Semiring's device code and exports a plain C entry point
// (repro_semiring_vpu or repro_semiring_mxu); kernels/build.py compiles
// that source at first use, keyed by a hash of the generated text, every
// csrc/*.cuh and the flags. The algebra struct, for the VPU tile:
//   struct Alg {
//     using T = float;                // or int: the type of every field
//     static constexpr int NF = 2;    // fields per element
//     static SR_FN void pad_a(T (&v)[NF]);   // the semiring's pads and
//     static SR_FN void pad_b(T (&v)[NF]);   // the accumulator's start
//     static SR_FN void init(T (&acc)[NF]);
//     static SR_FN void combine(const T (&a)[NF], const T (&b)[NF],
//                               T (&out)[NF]);
//     static SR_FN void accumulate(T (&acc)[NF], const T (&t)[NF]);
//   };
// and for the MXU path:
//   struct Alg {
//     using A = unsigned char;        // left operand: float, int or uint8
//     using B = int;                  // right operand: the same choice
//     using Out = int;                // output: float or int
//     static SR_FN float pad_a();     // the pads, as the fp32 the dot sees
//     static SR_FN float pad_b();
//     static SR_FN auto epilogue(float acc);  // cast to Out at the store
//   };
// The part above `#ifdef __CUDACC__` is plain C++, so a host compiler can
// build an algebra struct and check its functions without a card.
//
// What bounds it: the VPU path does, per (i, j, k), one combine and one
// accumulate per field on the CUDA cores, which run an add, a min or a
// compare at one per lane per clock (33.5 T/s on the H100 SXM): at 2048^3
// a single-field product is 1.7e10 such operations against 50 MB of
// operands, ~0.51 ms of operations and ~0.015 ms of bytes, so the pipes
// bound it. The MXU path is count_matmul's (counting_tiles.cuh): 2*M*N*K
// fp32 FMAs on tile (a), 67 TFLOP/s, ~0.26 ms at 2048^3, or three bf16
// tensor-core passes on tile (b) for a right operand exact in bf16.
//
// Design. The small VPU tile (vpu_tile, for grids below vpu_tiles.cuh's
// LARGE_MIN_BLOCKS large blocks): a SIMT tile through shared memory, a
// 32x32 output tile per block of 256 threads (16x16), K staged 32 deep (16
// or 8 deep for algebras of more than 4 or 8 fields, so the staged tiles
// stay within 48 KB of static shared memory), each thread a 2x2 micro-tile
// whose rows and columns are 16 apart (shared-memory reads are a broadcast
// and unit-stride, stores coalesce), with NF accumulators per output in
// registers. It issues one shared-memory load per two operations and loads
// single-buffered, so load issue bounds it; it keeps small grids (p = 512:
// 256 blocks) on every SM. Fields are separate arrays (struct of arrays), as
// in the JAX package. Both VPU tiles fold `accumulate` over k in order, so
// they agree bit for bit; that is the semiring's reduce, so `accumulate`
// must be associative and commutative, as the TPU kernel also assumes when
// it reduces block by block. The tiles mask ragged M, N and K with the
// algebra's pads at the loads and at the store, so callers need no padding.
// Each block moves its base pointers once by its 64-bit batch offset;
// per-load batch offsets spill (tropical.cu's history). Each tile adds one
// to its own device counter when it runs.
//
// MXU path: the operands are cast to fp32 as _mxu_kernel casts them (A into
// an fp32 copy, B by the conversion pass), and the results are
// count_matmul's: bit-equal to the plain version epilogue(a.float() @
// b.float()) wherever every partial sum is an integer below 2**24, within
// rtol 1e-5 elsewhere (tile (b) rounds once per 16-deep k step), and a B
// value that is not finite takes tile (a), which keeps fmaf's inf and NaN.
// Ragged K is zero-filled, not filled with pad_a / pad_b: the pads of an
// MXU-path algebra are annihilators of x, so a padded k adds pad_a * pad_b
// = 0, as a zero-filled one does (the wrapper refuses pads whose product
// is not 0). Built without --use_fast_math: the pads are often +-inf and
// must stay IEEE.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SR_FN __host__ __device__ __forceinline__
#else
#define SR_FN inline
#endif

// Helpers for device code: the smaller and the larger of two values of any
// ordered type (for an int field, where fminf/fmaxf do not apply). Neither
// is defined for NaN.
template <class T>
SR_FN T sr_min(T x, T y) { return y < x ? y : x; }
template <class T>
SR_FN T sr_max(T x, T y) { return x < y ? y : x; }

// fminf that propagates NaN, as jnp.minimum and torch.minimum do: NaN if
// either input is NaN, else fminf(x, y) (on the card one min.NaN.f32, which
// orders -0 and +0 as min.f32, fminf's instruction, does).
SR_FN float sr_fmin_nan(float x, float y) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
#else
  return (x != x || y != y) ? NAN : fminf(x, y);
#endif
}

namespace repro_semiring {

// The VPU path's store policy for vpu_tiles.cuh: each field of an output to
// its own array.
template <class Alg>
struct VpuStore {
  typename Alg::T* out[Alg::NF];
  SR_FN void operator()(long long off,
                        const typename Alg::T (&acc)[Alg::NF]) const {
    for (int f = 0; f < Alg::NF; ++f) out[f][off] = acc[f];
  }
  SR_FN void finish() const {}
};

// The MXU path's store policy for counting_tiles.cuh: the algebra's
// epilogue of the fp32 sum, cast to its output type.
template <class Alg>
struct MxuStore {
  typename Alg::Out* c;
  SR_FN void operator()(long long off, float acc) const {
    c[off] = static_cast<typename Alg::Out>(Alg::epilogue(acc));
  }
};

}  // namespace repro_semiring

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace repro_semiring {

// The first block of a launch adds one to its tile's counter (if any).
__device__ __forceinline__ void count_launch(int* counter) {
  if (counter != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0 && threadIdx.x == 0)
    atomicAdd(counter, 1);
}

// -- the small VPU tile ---------------------------------------------------------

constexpr int VTILE = 32;                 // output tile edge (BM = BN)
constexpr int VSUB = 2;                   // micro-tile edge per thread
constexpr int VSTEP = VTILE / VSUB;       // 16: micro-tile rows/cols 16 apart
constexpr int VTHREADS = VSTEP * VSTEP;   // 256
constexpr int VPU_MAX_FIELDS = 16;

template <class Alg>
struct VpuArgs {
  const typename Alg::T* a[Alg::NF];
  const typename Alg::T* b[Alg::NF];
  typename Alg::T* out[Alg::NF];
};

template <class Alg>
__global__ void __launch_bounds__(VTHREADS)
vpu_tile(VpuArgs<Alg> p, int* counter, int M, int N, int K) {
  using T = typename Alg::T;
  constexpr int NF = Alg::NF;
  // K staged per step: fewer rows for wide algebras, so the staged tiles
  // stay at 33,280 bytes of shared memory at most
  constexpr int BK = NF <= 4 ? 32 : NF <= 8 ? 16 : 8;
  static_assert(NF >= 1 && NF <= VPU_MAX_FIELDS, "1 to 16 fields");
  static_assert((VTILE * BK) % VTHREADS == 0, "whole loads per thread");
  // A tiles are stored transposed ([k][m]) with one column of padding, so
  // the row-major global reads (neighbouring threads along k) store
  // without bank conflicts.
  __shared__ T As[NF][BK][VTILE + 1];
  __shared__ T Bs[NF][BK][VTILE];

  const int tid = threadIdx.x;
  const int tx = tid % VSTEP;
  const int ty = tid / VSTEP;
  const int row0 = blockIdx.y * VTILE;
  const int col0 = blockIdx.x * VTILE;
  // this block's problem of the stack: the bases move once, so the tile's
  // own offsets stay those of a 2D product
  const long long bz = blockIdx.z;
  const T* a[NF];
  const T* b[NF];
  T* out[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    a[f] = p.a[f] + bz * M * K;
    b[f] = p.b[f] + bz * K * N;
    out[f] = p.out[f] + bz * M * N;
  }
  T pad_a[NF], pad_b[NF];
  Alg::pad_a(pad_a);
  Alg::pad_b(pad_b);

  T acc[VSUB][VSUB][NF];
#pragma unroll
  for (int i = 0; i < VSUB; ++i)
#pragma unroll
    for (int j = 0; j < VSUB; ++j) Alg::init(acc[i][j]);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int t = 0; t < (VTILE * BK) / VTHREADS; ++t) {
      const int idx = tid + t * VTHREADS;
      // A: neighbouring threads walk k (A's unit-stride axis)
      const int am = idx / BK, ak = idx % BK;
      const int gm = row0 + am, gk = k0 + ak;
      const bool a_in = gm < M && gk < K;
      const long long aoff = (long long)gm * K + gk;
      // B: neighbouring threads walk n (B's unit-stride axis)
      const int bk = idx / VTILE, bn = idx % VTILE;
      const int gk2 = k0 + bk, gn = col0 + bn;
      const bool b_in = gk2 < K && gn < N;
      const long long boff = (long long)gk2 * N + gn;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        As[f][ak][am] = a_in ? a[f][aoff] : pad_a[f];
        Bs[f][bk][bn] = b_in ? b[f][boff] : pad_b[f];
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      T ra[VSUB][NF], rb[VSUB][NF];
#pragma unroll
      for (int i = 0; i < VSUB; ++i)
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          ra[i][f] = As[f][kk][ty + i * VSTEP];
          rb[i][f] = Bs[f][kk][tx + i * VSTEP];
        }
#pragma unroll
      for (int i = 0; i < VSUB; ++i)
#pragma unroll
        for (int j = 0; j < VSUB; ++j) {
          T t[NF];
          Alg::combine(ra[i], rb[j], t);
          Alg::accumulate(acc[i][j], t);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < VSUB; ++i) {
    const int r = row0 + ty + i * VSTEP;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < VSUB; ++j) {
      const int c = col0 + tx + j * VSTEP;
      if (c >= N) continue;
      const long long off = (long long)r * N + c;
#pragma unroll
      for (int f = 0; f < NF; ++f) out[f][off] = acc[i][j][f];
    }
  }
  // at the end: an atomic before the k loop made the tile 43% slower (11.9
  // -> 17.0 us on an H100 at 300 x 200 x 260, experiments/kernels/
  // time_vpu.py)
  count_launch(counter);
}

// `batch` contiguous (m,k) x (k,n) products on the small tile; a, b and out
// hold NF field pointers each; the tile adds one to *counter. Returns the
// launch's cudaError_t.
template <class Alg>
int launch_vpu(const void* const* a, const void* const* b, void* const* out,
               int* counter, int batch, int m, int n, int k, void* stream) {
  using T = typename Alg::T;
  VpuArgs<Alg> p;
  for (int f = 0; f < Alg::NF; ++f) {
    p.a[f] = static_cast<const T*>(a[f]);
    p.b[f] = static_cast<const T*>(b[f]);
    p.out[f] = static_cast<T*>(out[f]);
  }
  const dim3 grid((n + VTILE - 1) / VTILE, (m + VTILE - 1) / VTILE, batch);
  vpu_tile<Alg><<<grid, VTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, counter, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_semiring

#endif  // __CUDACC__

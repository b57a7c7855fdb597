// The counting GEMM for Hopper (sm_90a): C = A@B over (+, x) in fp32, 2D or
// batched over blockIdx.z, on two tiles picked on the device, with what is
// stored left to a store policy. One GEMM, two users:
//   semiring.cu           instantiates it with three policies: the counts,
//                         the BFS frontier mask, the boolean threshold
//                         (frontier_step, count_matmul, reachability_step);
//   semiring_generic.cuh  the kernel generated per MXU-path Semiring
//                         (kernels/semiring.py semiring_source) stores
//                         static_cast<Out>(Alg::epilogue(acc)).
// (tropical.cu and vpu_tiles.cuh include it too, for its cp.async helpers
// and allow_smem.)
// This header is not a library of its own: kernels/build.py hashes every
// csrc/*.cuh into the name of each library, so an edit here rebuilds every
// user.
//
// A store policy is a small struct passed to the tiles by value; for each
// output it receives the flat offset of (batch, r, col) in the contiguous
// (batch, M, N) output and the fp32 sum, and stores what it likes:
//   struct Store { float* c;
//     CT_FN void operator()(long long off, float acc) const; };
// The part above `#ifdef __CUDACC__` (the policies) is plain C++, so a host
// compiler can check them without a card.
//
// What bounds it: at the sweep's shape (B = 12, M = N = K = 2048) one launch
// is 2*B*M*N*K = 2.06e11 multiply-adds' worth of operations against ~0.8 GB
// of operands. On the CUDA cores that is the IEEE-fp32 rate (67 TFLOP/s,
// 3.08 ms); as three bf16 tensor-core passes it is 6.18e11 at 989 TFLOP/s
// (0.63 ms), where the 0.24 ms of bytes is not yet the limit. The counts
// must stay exact below 2**24, so TF32 is never used.
//
// One call is three launches on the caller's stream (four when A is not
// fp32): to_bf16 converts B to a zero-padded bf16 copy and raises a device
// flag if any value of B is not finite or not exact in bf16; then simt_tile
// and tc_tile are both launched and each returns at once unless the flag
// selects it. The choice is made on the device, so a caller's level loop
// gains no host sync. Each tile adds one to its own device counter when it
// runs. Operand types: B may be float, int or unsigned char; the pass reads
// it in its own type, casts each value to fp32 (int values above 2**24
// round as torch's .float() does) and, for an int B, also writes the fp32
// copy that tile (a) reads. A uint8 B is always exact in bf16, so it always
// takes tile (b) and needs no fp32 copy. An A that is not fp32 is cast into
// an fp32 copy first (to_f32). Both casts are those of the plain version,
// a.float() @ b.float().
//
// Tile (a), simt_tile: fp32 FMAs on the CUDA cores, for a B that bf16 cannot
// hold (the first Brandes product F_a^T x Z). A 128x128 output tile per
// block of 256 threads, an 8x8 register micro-tile per thread (two 4x4
// quadrants 64 rows/cols apart, so the shared-memory reads are float4 and
// conflict-free), K staged 32 deep through a 3-stage ring of cp.async
// copies, so tile t+1 and t+2 load while tile t is computed. Each output is
// one fmaf per k in order k = 0..K-1 from 0.
//
// Tile (b), tc_tile: for a B exact in bf16 (the {0,1} adjacency, boolean
// masks). Once per k step of the block, A's fp32 stage is read into
// registers and split into three bf16 limbs, hi = x with its low
// 16 bits cleared (bf16 rounded toward zero), mid = the same of x - hi, and
// lo = x - hi - mid: 24 significand bits are 8 + 8 + 8, so hi + mid + lo = x
// exactly for every finite x with |x| >= 2**-110 (below that lo can fall
// under bf16's subnormal grid and loses bits under 2**-133); a non-finite x
// goes in as (x, 0, 0), so inf and NaN act as in fmaf. A non-finite value
// of B takes tile (a): there a zero limb times inf would give NaN where
// fmaf gives inf. Per 16-deep k step
// and 16x8 output fragment, the three limb products run as three
// mma.sync.m16n8k16 bf16 products chained into a fragment that starts at 0,
// which is then added to the fp32 accumulator with one IEEE add. Where every
// partial sum is an integer below 2**24, every step is exact and the result
// is bit-equal to tile (a). A k step whose 16 terms hold one nonzero product
// adds exactly x*b, as fmaf does; otherwise the step's sum is formed first
// (the tensor core truncates where it cannot hold it), so on other sums the
// tile is within rtol 1e-5 of the plain version, not bit-equal. The limbs
// go to three [m][k] bf16 tiles in shared memory, so each value is split
// once per block, not once per warp that reads it (a split per warp, in
// registers, does it four times and is bound by those ALU operations
// rather than by the products). Warps own 64x32 of the 128x128 block tile (2 x 4 warps)
// and read the limbs with ldmatrix and B's bf16 fragments with
// ldmatrix.trans from the same 3-stage cp.async ring. mma.sync, not
// wgmma: the asynchronous warpgroup product with TMA is the next step.
//
// The left operand is read in one of three layouts, a template parameter
// chosen on the host from the strides: row-major (unit stride along k: F,
// and Z in Z x A), copied 16 bytes at a time into a [m][k] tile;
// column-major (unit stride along m: the transposed F_a^T), 16-byte copies
// into a [k][m] tile; or any other view, 4-byte copies into [k][m]. The
// 16-byte paths need K (row-major) or M (column-major) and the strides to be
// multiples of 4, 16-byte aligned bases, and N a multiple of 4; the host
// takes the strided path otherwise. Per-thread 64-bit source pointers are
// set once per block and advanced by the k step. Ragged M, N, K are masked
// by zero-filled copies and at the store, so callers need no padding: a
// zero-filled k adds 0 * 0 to every sum.
//
// Built without --use_fast_math, so the adds stay IEEE.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define CT_FN __host__ __device__ __forceinline__
#else
#define CT_FN inline
#endif

namespace counting_tiles {

// -- store policies ---------------------------------------------------------------

// The counts.
struct CountStore {
  float* c;
  CT_FN void operator()(long long off, float acc) const { c[off] = acc; }
};

// The counts masked to first reaches: acc where acc > 0 and the running
// distance d is still +inf, else 0 (d is contiguous like c).
struct FrontierStore {
  const float* d;
  float* c;
  CT_FN void operator()(long long off, float acc) const {
    c[off] = (acc > 0.f && d[off] == INFINITY) ? acc : 0.f;
  }
};

// The boolean threshold of the counts, as fp32 {0,1}. For {0,1} masks it
// cannot depend on summation order: a sum of nonnegative fp32 terms never
// rounds below its largest term.
struct BooleanStore {
  float* c;
  CT_FN void operator()(long long off, float acc) const {
    c[off] = acc > 0.5f ? 1.f : 0.f;
  }
};

}  // namespace counting_tiles

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace counting_tiles {
// Internal linkage: each library that includes this header keeps its own
// copy. Two generated libraries of one algebra name and other dtypes
// instantiate kernels of one mangled name, and a function-local static of
// an external template (allow_smem's) is a GNU unique symbol that the
// loader unifies across libraries: the second library's kernel would then
// launch without its shared-memory attribute.
namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int TM = 8;  // tile (a) micro-tile
constexpr int TN = 8;
constexpr int KM_LD = BM + 4;   // [k][m] A tile row: conflict-free for both tiles
constexpr int B_LD = BN;        // tile (a)'s fp32 B rows
constexpr int B16_LD = BN + 8;  // tile (b)'s bf16 B rows: ldmatrix conflict-free
constexpr int MK_LD = BK + 4;   // [m][k] A tile row: conflict-free reads
constexpr int AL_LD = BK + 8;   // tile (b)'s bf16 limb rows: ldmatrix conflict-free

// How the left operand is laid out (see the header comment).
enum Layout { kRowMajor, kColMajor, kStrided };

// One strided (batch, row, col) view of the left operand, in elements.
struct Strided {
  const float* ptr;
  long long sb, sr, sc;
};

template <Layout L>
__host__ __device__ constexpr int a_floats() {
  return L == kRowMajor ? BM * MK_LD : BK * KM_LD;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// Per-thread source pointer of A for the k step at k0 = 0, and the
// element step between the thread's copies. The thread's copies of one
// stage are at p + i * step, i = 0..3 (16-byte) or 0..15 (4-byte).
template <Layout L>
struct ALoader {
  const float* p;
  long long step;   // elements between copy i and i + 1
  long long kstep;  // elements per BK of k
  int gm, gk;       // this thread's first row and k offset (tile-relative k)

  __device__ ALoader(const Strided& a, int bz, int row0, int tid) {
    const float* base = a.ptr + (long long)bz * a.sb;
    if (L == kRowMajor) {  // chunk c = tid + 256 i: m = c / 8, k = 4 (c % 8)
      gm = row0 + tid / 8;
      gk = 4 * (tid % 8);
      step = 32 * a.sr;
      kstep = BK;
      p = base + (long long)gm * a.sr + gk;
    } else if (L == kColMajor) {  // c: k = c / 32, m = 4 (c % 32)
      gm = row0 + 4 * (tid % 32);
      gk = tid / 32;
      step = 8 * a.sc;
      kstep = BK * a.sc;
      p = base + gm + (long long)gk * a.sc;
    } else {  // c: m = c % 128, k = c / 128 + 2 i
      gm = row0 + tid % BM;
      gk = tid / BM;
      step = 2 * a.sc;
      kstep = BK * a.sc;
      p = base + (long long)gm * a.sr + (long long)gk * a.sc;
    }
  }

  // Copies the stage for k0 into `as` (its layout) and advances p.
  __device__ void load(float* as, int k0, int M, int K, int tid) {
    if (L == kRowMajor) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = tid / 8 + 32 * i;
        cp_async16(as + m * MK_LD + gk, p + i * step,
                   gm + 32 * i < M && k0 + gk < K);
      }
    } else if (L == kColMajor) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = gk + 8 * i;
        cp_async16(as + k * KM_LD + 4 * (tid % 32), p + i * step,
                   gm < M && k0 + k < K);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int k = gk + 2 * i;
        cp_async4(as + k * KM_LD + tid % BM, p + i * step,
                  gm < M && k0 + k < K);
      }
    }
    p += kstep;
  }
};

// Returns whether this block runs (the flag selects its tile); the first
// block of the tile that runs counts the launch.
__device__ __forceinline__ bool selected(const int* flag, bool want_inexact,
                                         int* counter) {
  if ((*flag != 0) != want_inexact) return false;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0)
    atomicAdd(counter, 1);
  return true;
}

// -- the conversion passes ----------------------------------------------------------

// b16[z][k][n] = the top 16 bits of float(b[z][k][n]) (zero outside K x N,
// up to the padded Kp x Np); *inexact = 1 if any value is not exact in
// bf16 or not finite (+-inf, NaN: tile (a) keeps fmaf's answer). When b32
// is not null, b32[z][k][n] = float(b[z][k][n]) too (the fp32 copy of a B
// that is not fp32). Each thread takes 8 consecutive n of one k.
template <class TB>
__global__ void __launch_bounds__(THREADS)
to_bf16(const TB* __restrict__ b, uint4* __restrict__ b16,
        float* __restrict__ b32, int* __restrict__ inexact, int K, int N,
        int Kp, int Np) {
  const int groups = Np / 8;
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (item >= (long long)Kp * groups) return;
  const int k = static_cast<int>(item / groups);
  const int n0 = static_cast<int>(item % groups) * 8;
  const long long row = (long long)blockIdx.y * K * N + (long long)k * N;
  unsigned h[8];
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in = k < K && n0 + j < N;
    const float v = in ? static_cast<float>(b[row + n0 + j]) : 0.f;
    if (b32 != nullptr && in) b32[row + n0 + j] = v;
    const unsigned bits = __float_as_uint(v);
    bad |= (bits & 0xffffu) != 0 || (bits & 0x7f800000u) == 0x7f800000u;
    h[j] = bits >> 16;
  }
  b16[(long long)blockIdx.y * Kp * groups + item] =
      make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                 h[6] | h[7] << 16);
  if (bad) *inexact = 1;  // every writer stores the same 1
}

// a32[i] = float(a[i]) over `count` contiguous values: the fp32 copy of a
// left operand that is not fp32.
template <class TA>
__global__ void __launch_bounds__(THREADS)
to_f32(const TA* __restrict__ a, float* __restrict__ a32, long long count) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < count; i += stride)
    a32[i] = static_cast<float>(a[i]);
}

// -- tile (a): fp32 on the CUDA cores -----------------------------------------------

template <class Store, Layout L>
__global__ void __launch_bounds__(THREADS, 2)
simt_tile(Strided a, const float* __restrict__ b, Store st,
          const int* __restrict__ flag, int* __restrict__ counter, int M,
          int N, int K) {
  if (!selected(flag, true, counter)) return;
  extern __shared__ __align__(16) float smem[];
  constexpr int A_FLOATS = a_floats<L>();
  constexpr int STAGE = A_FLOATS + BK * B_LD;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int bz = blockIdx.z;

  ALoader<L> al(a, bz, row0, tid);
  // B: 16-byte copies along n (k = c / 32, n = 4 (c % 32)), or 4-byte ones
  // (n = c % 128, k = c / 128 + 2 i) on the strided path
  const int bk = L == kStrided ? tid / BN : tid / 32;
  const int bn = L == kStrided ? tid % BN : 4 * (tid % 32);
  const float* bp = b + (long long)bz * K * N + (long long)bk * N + col0 + bn;

  auto load = [&](int stage, int k0) {
    float* as = smem + stage * STAGE;
    float* bs = as + A_FLOATS;
    al.load(as, k0, M, K, tid);
    if (L == kStrided) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int k = bk + 2 * i;
        cp_async4(bs + k * B_LD + bn, bp + (long long)2 * i * N,
                  k0 + k < K && col0 + bn < N);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = bk + 8 * i;
        cp_async16(bs + k * B_LD + bn, bp + (long long)8 * i * N,
                   k0 + k < K && col0 + bn < N);
      }
    }
    bp += (long long)BK * N;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait_ring();
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < ktiles) load(next % STAGES, next * BK);
    cp_async_commit();

    const float* as = smem + (t % STAGES) * STAGE;
    const float* bs = as + A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TM];
      if (L == kRowMajor) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ra[i] = as[(ty * 4 + i) * MK_LD + kk];
          ra[4 + i] = as[(BM / 2 + ty * 4 + i) * MK_LD + kk];
        }
      } else {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[kk * KM_LD + ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&as[kk * KM_LD + BM / 2 + ty * 4]);
        ra[0] = a0.x; ra[1] = a0.y; ra[2] = a0.z; ra[3] = a0.w;
        ra[4] = a1.x; ra[5] = a1.y; ra[6] = a1.z; ra[7] = a1.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk * B_LD + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[kk * B_LD + BN / 2 + tx * 4]);
      const float rb[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  const long long cbase = (long long)bz * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
      if (col >= N) continue;
      st(cbase + (long long)r * N + col, acc[i][j]);
    }
  }
}

// -- tile (b): three exact bf16 limbs on the tensor cores ---------------------------

// x -> the fp32 bit patterns of its limbs (hi, mid, lo), each exact in bf16
// (see the header comment), a zero limb with x's sign; non-finite x ->
// (x, 0, 0), NaN as the canonical quiet NaN, whose top 16 bits are a bf16
// NaN. kernels/semiring.py _split_bf16_limbs is the same on the host.
__device__ __forceinline__ void split3(float x, unsigned& hi, unsigned& mid,
                                       unsigned& lo) {
  const unsigned xb = __float_as_uint(x);
  const unsigned sign = xb & 0x80000000u;
  const float h = __uint_as_float(xb & 0xffff0000u);
  const float r = x - h;
  const float m = __uint_as_float(__float_as_uint(r) & 0xffff0000u);
  const float l = r - m;
  const bool finite = fabsf(x) < INFINITY;
  hi = finite ? __float_as_uint(h) : (x != x ? 0x7fc00000u : xb);
  mid = finite ? __float_as_uint(m) | sign : 0u;
  lo = finite ? __float_as_uint(l) | sign : 0u;
}

// Two fp32 limb patterns -> one bf16x2 register (lower k in the low half).
__device__ __forceinline__ unsigned pack2(unsigned lo_k, unsigned hi_k) {
  return __byte_perm(lo_k, hi_k, 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class Store, Layout L>
__global__ void __launch_bounds__(THREADS, 2)
tc_tile(Strided a, const uint4* __restrict__ b16, Store st,
        const int* __restrict__ flag, int* __restrict__ counter, int M, int N,
        int K, int Np) {
  if (!selected(flag, false, counter)) return;
  extern __shared__ __align__(16) float smem[];
  constexpr int A_FLOATS = a_floats<L>();
  constexpr int STAGE = A_FLOATS + BK * B16_LD / 2;  // in floats
  // the current stage's A as three bf16 limb tiles, [limb][m][k]
  unsigned short* limbs =
      reinterpret_cast<unsigned short*>(smem + STAGES * STAGE);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = (warp / 4) * 64;  // the warp's 64 x 32 of the block tile
  const int wn = (warp % 4) * 32;
  const int g = lane / 4;
  const int q = 2 * (lane % 4);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int bz = blockIdx.z;
  // the split: thread tid takes row sm and k in [sk, sk + 16) of a stage
  const int sm = tid % BM;
  const int sk = 16 * (tid / BM);

  ALoader<L> al(a, bz, row0, tid);
  // B16 is (Kp, Np) per problem, padded with zeros: every 16-byte copy is
  // whole (k = c / 16, n = 8 (c % 16), c = tid + 256 i, i = 0, 1)
  const int groups = Np / 8;
  const uint4* bp = b16 + (long long)bz * ((K + BK - 1) / BK * BK) * groups +
                    (long long)(tid / 16) * groups + col0 / 8 + tid % 16;

  auto load = [&](int stage, int k0) {
    float* as = smem + stage * STAGE;
    unsigned short* bs = reinterpret_cast<unsigned short*>(as + A_FLOATS);
    al.load(as, k0, M, K, tid);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(bs + (tid / 16 + 16 * i) * B16_LD + 8 * (tid % 16),
                 bp + (long long)16 * i * groups, true);
    bp += (long long)BK * groups;
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait_ring();
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < ktiles) load(next % STAGES, next * BK);
    cp_async_commit();

    const float* as = smem + (t % STAGES) * STAGE;
    const unsigned short* bs =
        reinterpret_cast<const unsigned short*>(as + A_FLOATS);
    // split this stage's A once for the block: 16 values a thread, 8 at a
    // time (the 64 accumulators are live here)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k0 = sk + 8 * half;
      float x[8];
      if (L == kRowMajor) {
#pragma unroll
        for (int j = 0; j < 8; j += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(&as[sm * MK_LD + k0 + j]);
          x[j] = v.x; x[j + 1] = v.y; x[j + 2] = v.z; x[j + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = as[(k0 + j) * KM_LD + sm];
      }
      unsigned w[3][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned h0, m0, l0, h1, m1, l1;
        split3(x[2 * j], h0, m0, l0);
        split3(x[2 * j + 1], h1, m1, l1);
        w[0][j] = pack2(h0, h1);
        w[1][j] = pack2(m0, m1);
        w[2][j] = pack2(l0, l1);
      }
#pragma unroll
      for (int l = 0; l < 3; ++l)
        *reinterpret_cast<uint4*>(limbs + (l * BM + sm) * AL_LD + k0) =
            make_uint4(w[l][0], w[l][1], w[l][2], w[l][3]);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      // B fragments of the warp's four n8 tiles: two ldmatrix.x4.trans
      unsigned bf[4][2];
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const int krow = ks + (lane / 8 % 2) * 8 + lane % 8;
        const int ncol = wn + (2 * pr + lane / 16) * 8;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(bf[2 * pr][0]), "=r"(bf[2 * pr][1]),
              "=r"(bf[2 * pr + 1][0]), "=r"(bf[2 * pr + 1][1])
            : "r"(smem_u32(bs + krow * B16_LD + ncol)));
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // A fragments of the three limbs: rows wm + 16 mi + (0..15), k ks +
        // (0..15), one ldmatrix.x4 each
        unsigned af[3][4];
        const int r = wm + mi * 16 + lane % 16;
        const int k = ks + (lane / 16) * 8;
#pragma unroll
        for (int l = 0; l < 3; ++l)
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
              "{%0,%1,%2,%3}, [%4];\n"
              : "=r"(af[l][0]), "=r"(af[l][1]), "=r"(af[l][2]),
                "=r"(af[l][3])
              : "r"(smem_u32(limbs + (l * BM + r) * AL_LD + k)));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(part, af[0], bf[ni][0], bf[ni][1]);
          mma_bf16(part, af[1], bf[ni][0], bf[ni][1]);
          mma_bf16(part, af[2], bf[ni][0], bf[ni][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[e];
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  const long long cbase = (long long)bz * M * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
      if (r >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = col0 + wn + ni * 8 + q + (e & 1);
        if (col >= N) continue;
        st(cbase + (long long)r * N + col, acc[mi][ni][e]);
      }
    }
}

// -- the launch ----------------------------------------------------------------------

template <auto kernel>
cudaError_t allow_smem(int bytes) {
  // once per kernel: dynamic shared memory above 48 KB
  static const cudaError_t done = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return done;
}

template <Layout L>
constexpr int simt_smem_bytes() {
  return STAGES * (a_floats<L>() + BK * B_LD) * sizeof(float);
}

template <Layout L>
constexpr int tc_smem_bytes() {
  return STAGES * (a_floats<L>() + BK * B16_LD / 2) * sizeof(float) +
         3 * BM * AL_LD * 2;
}

// The conversion pass, then both tiles. `b` is the contiguous (batch, k, n)
// right operand in its own type; b32 its fp32 copy, written by the pass
// and read by tile (a), for an int B (null for a float B, which tile (a)
// reads in place, and for a uint8 B, which never takes tile (a)).
template <class Store, Layout L, class TB>
int launch(Strided a, const TB* b, float* b32, Store st, void* b16,
           void* flag, void* counters, int batch, int m, int n, int k,
           cudaStream_t s) {
  static_assert(std::is_same<TB, float>::value ||
                    std::is_same<TB, int>::value ||
                    std::is_same<TB, unsigned char>::value,
                "B is float, int or unsigned char");
  const int kp = (k + BK - 1) / BK * BK;
  const int np = (n + BN - 1) / BN * BN;
  int* f = static_cast<int*>(flag);
  int* counts = static_cast<int*>(counters);
  cudaError_t e = cudaMemsetAsync(f, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (kp > 0) {
    const long long items = (long long)kp * (np / 8);
    const dim3 cgrid(static_cast<unsigned>((items + THREADS - 1) / THREADS),
                     batch);
    to_bf16<TB><<<cgrid, THREADS, 0, s>>>(
        b, static_cast<uint4*>(b16),
        std::is_same<TB, int>::value ? b32 : nullptr, f, k, n, kp, np);
  }
  const float* bf = std::is_same<TB, float>::value
                        ? reinterpret_cast<const float*>(b) : b32;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  constexpr int simt_bytes = simt_smem_bytes<L>();
  constexpr int tc_bytes = tc_smem_bytes<L>();
  if ((e = allow_smem<simt_tile<Store, L>>(simt_bytes)) != cudaSuccess ||
      (e = allow_smem<tc_tile<Store, L>>(tc_bytes)) != cudaSuccess)
    return static_cast<int>(e);
  simt_tile<Store, L><<<grid, THREADS, simt_bytes, s>>>(a, bf, st, f, counts,
                                                        m, n, k);
  tc_tile<Store, L><<<grid, THREADS, tc_bytes, s>>>(
      a, static_cast<const uint4*>(b16), st, f, counts + 1, m, n, k, np);
  return static_cast<int>(cudaGetLastError());
}

// `launch` for the left-operand layout the host chose (0 row-major, 1
// column-major, 2 strided). Returns the first launch error (a cudaError_t).
template <class Store, class TB>
int dispatch(int layout, Strided a, const TB* b, float* b32, Store st,
             void* b16, void* flag, void* counters, int batch, int m, int n,
             int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kRowMajor:
      return launch<Store, kRowMajor>(a, b, b32, st, b16, flag, counters,
                                      batch, m, n, k, s);
    case kColMajor:
      return launch<Store, kColMajor>(a, b, b32, st, b16, flag, counters,
                                      batch, m, n, k, s);
    case kStrided:
      return launch<Store, kStrided>(a, b, b32, st, b16, flag, counters,
                                     batch, m, n, k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The product of contiguous operands in their own types: A (batch, m, k)
// of type TA, cast into the fp32 scratch a32 first unless TA is float (a32
// unused then), B (batch, k, n) of type TB. `layout` is that of the fp32 A
// the tiles read (row-major or, where its 16-byte conditions fail,
// strided).
template <class Store, class TA, class TB>
int launch_typed(int layout, const TA* a, float* a32, const TB* b, float* b32,
                 Store st, void* b16, void* flag, void* counters, int batch,
                 int m, int n, int k, void* stream) {
  static_assert(std::is_same<TA, float>::value ||
                    std::is_same<TA, int>::value ||
                    std::is_same<TA, unsigned char>::value,
                "A is float, int or unsigned char");
  const float* af = reinterpret_cast<const float*>(a);
  if constexpr (!std::is_same<TA, float>::value) {
    const long long count = (long long)batch * m * k;
    if (count > 0) {
      const long long blocks = (count + THREADS - 1) / THREADS;
      to_f32<TA><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                   THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, a32,
                                                                   count);
    }
    af = a32;
  }
  const Strided av{af, (long long)m * k, k, 1};
  return dispatch(layout, av, b, b32, st, b16, flag, counters, batch, m, n, k,
                  stream);
}

}  // namespace
}  // namespace counting_tiles

#endif  // __CUDACC__

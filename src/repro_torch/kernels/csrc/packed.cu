// Narrow-cell counting GEMMs for Hopper (sm_90a) on the int8 tensor cores:
// the packed BFS frontier step and the counting product of an int32 left
// operand with a uint8 right operand, batched over blockIdx.z.
//
// Replaces (src/repro/kernels/semiring.py):
//   frontier_step_packed <- frontier_step_packed_pallas / _frontier_kernel_packed
//                           (B = 1) and frontier_step_packed_batched_pallas /
//                           _frontier_kernel_packed_batched
//   count_matmul_narrow  <- semiring_matmul_pallas / _mxu_kernel with COUNTING,
//                           a uint32 left and uint8 right operand and
//                           out_dtype=f32 (the streamed pump's panel product)
//
// The packed cells: the frontier F is int32 counts (the TPU kernel's uint32
// cell; the contract is any nonnegative int32, which the kernel reads as its
// uint32 bits), the adjacency A any uint8 (a {0,1} matrix on every caller's
// path), the distances int16 with DIST_UNREACHED = 32767 as +inf.
//
// Exact integer products on the tensor cores: F splits into four u8 limbs,
// bits 0-7, 8-15, 16-23 and 24-31, so F = sum_l limb_l << 8l, and every
// u8 x u8 product summed in int32 is exact. One term is at most 255 * 255 =
// 65,025, so a limb's int32 sum is exact for 32,256 k (2,097,446,400 plus
// a carry of at most 2**24 stays below 2**31; 33,025 k alone would wrap).
// Every FOLD_STAGES stages (32,256 k) the thread folds its limb sums into
// one total, clamps it
// at MULT_SAT = 2**24 and carries that into limb 0's sum; the last fold is
// not clamped. The total is therefore the exact F@A wherever F@A < 2**24
// (bit-equal to the fp32 plain versions, whose partial sums are exact
// integers there), and at least 2**24 wherever F@A >= 2**24. The frontier
// epilogue clamps at MULT_SAT, so its cells are the plain version's in
// every case; the narrow product's f32 is >= 2**24 there, and the pump
// clamps its panel sum at MULT_SAT, so every stored cell is the same.
//
// What bounds it: on the extreme-scale path M is the source tile, 32 rows,
// and N = K is the padded router count, ~1e5. One step is four limb
// passes of 2*M*N*K = 6.4e11 int8 operations, 2.56e12 in all (1.29 ms at
// 1,979 dense int8 TOP/s), against the K*N-byte adjacency (10 GB, 2.99 ms
// at 3.35 TB/s): the bytes bound it. The kernel streams the adjacency once
// through a ring of asynchronous copies and keeps the products off the
// CUDA cores.
//
// One call is a memset of the flags below and two launches on the caller's
// stream:
//   split_limbs reads F through its (batch, row, col) strides (the pump's
//     [:, k0:k0+256] slab is a strided view) and writes the limbs to a
//     zero-padded (batch, 4, Mp, Kp) u8 scratch (Mp = M rounded up to BM,
//     Kp = K to BK), so the GEMM's A loads are whole, aligned 16-byte
//     copies. 12.8 MB at the extreme shape; L2 (50 MB) holds it while the
//     adjacency streams.
//   packed_gemm: a 32 x 256 output tile per block of 512 threads (16
//     warps), one block per SM. K is staged 64 deep through a ring of
//     STAGES shared-memory stages filled with cp.async: the limbs of the
//     32 source rows (up to a 128-row left operand) and the 64 x 256 byte
//     adjacency tile. Warp (wm, wn) owns source rows 16 wm .. 16 wm + 15
//     (one m16 tile per limb) and columns 32 wn .. 32 wn + 31 (four n8
//     tiles), so a thread holds every limb sum of the same 16 output cells
//     and folds them in registers. Products are
//     mma.sync.m16n8k32.row.col.s32.u8.u8.s32; one B fragment feeds every
//     limb, and the limbs' A fragments come from ldmatrix.x4.
//   The split pass also flags, per row block, which limbs are not zero
//   anywhere in it. A block runs the GEMM body instantiated for its number
//   of live limbs (1 to 4; limb 0 always, as the fold's carry goes there)
//   and skips the copies and products of the others, whose sums are 0:
//   counts below 2**8 need one limb pass, below 2**16 two, the BFS's
//   MULT_SAT cells (2**24) limbs 0 and 3. The choice is uniform across the
//   block and made on the device, with no host sync.
//
// The adjacency is (K, N) with N contiguous, but the 8-bit tensor-core B
// operand is K-contiguous (no transposed form exists for 8-bit types), and A
// need not be symmetric. So each thread reads four words of the tile, rows
// k .. k+3 of one 4-column group, and transposes the 4 x 4 bytes with
// __byte_perm into four registers of 4 consecutive k each: one column for
// each of its four n8 tiles. n8 tile j's column c is then the block's
// column 32 wn + 4 c + j, which the epilogue maps back (each thread stores 4
// consecutive columns). The tile's 16-byte chunks are XOR-swizzled by row
// so those word reads are conflict-free. The limb rows are padded to 80
// bytes, which keeps ldmatrix conflict-free.
//
// Ragged and unaligned shapes: the limb scratch is padded with zeros, the
// adjacency copies zero-fill rows past K and chunks past N. The 16-byte
// copies need N % 16 == 0 and a 16-byte aligned A; otherwise the same tile
// is filled by guarded byte loads (VEC = false), and the epilogue stores
// one cell at a time. Batch, row and k offsets are 64-bit (K*N ~ 1e10).
// The frontier epilogue reads the int16 distance once and writes
// where((F@A > 0) & (d == DIST_UNREACHED), min(F@A, MULT_SAT), 0) as int32;
// the narrow one writes F@A as f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;   // source rows per block
constexpr int BN = 256;  // columns per block
constexpr int BK = 64;   // k per stage
constexpr int STAGES = 4;
constexpr int WARPS_N = BN / 32;  // warps along n; two along m
constexpr int THREADS = 64 * WARPS_N;
constexpr int MIN_BLOCKS = 65536 / (128 * THREADS);  // at most 128 registers
constexpr int LIMBS = 4;
constexpr int B_COPIES = BK * BN / 16 / THREADS;  // 16-byte copies
constexpr int A_LD = BK + 16;  // limb row in bytes: ldmatrix conflict-free
constexpr int A_BYTES = LIMBS * BM * A_LD;  // 10,240
constexpr int B_BYTES = BK * BN;            // 16,384
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 106,496
// 504 stages = 32,256 k: 65,025 * 32,256 + 2**24 < 2**31
constexpr int FOLD_STAGES = 504;
constexpr int MULT_SAT = 1 << 24;
constexpr int16_t DIST_UNREACHED = 32767;

// One strided (batch, row, col) view of the int32 left operand, in elements.
struct Strided {
  const int32_t* ptr;
  long long sb, sr, sc;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// Byte offset of the 16-byte chunk `chunk` (0..15) of adjacency tile row
// `k`: chunks are XOR-swizzled by (k / 4) % 4, so the words that the 32
// threads of a warp read at once (rows 4 t + r, t = 0..3, of eight
// neighbouring words) fall in 32 different banks.
__device__ __forceinline__ int b_chunk(int k, int chunk) {
  return k * BN + 16 * (chunk ^ (((k >> 2) & 3) << 1));
}

// BEGIN transpose4x4
// x[r] holds bytes (r, 0..3) of a 4 x 4 byte block, column 0 in the low
// byte; y[c] gets bytes (0..3, c), row 0 in the low byte.
__device__ __forceinline__ void transpose4x4(const unsigned (&x)[4],
                                             unsigned (&y)[4]) {
  const unsigned t0 = __byte_perm(x[0], x[1], 0x5140);
  const unsigned t1 = __byte_perm(x[0], x[1], 0x7362);
  const unsigned t2 = __byte_perm(x[2], x[3], 0x5140);
  const unsigned t3 = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}
// END transpose4x4

__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- the split pass --------------------------------------------------------------

// limbs[z][l][m][k] = byte l of F[z][m][k] (read as uint32), zero outside
// M x K up to the padded Mp x Kp. Each thread writes 4 consecutive k of one
// row, for all four limbs; bit l of used[z][m / BM] is set if limb l is
// not zero there (used starts at 0). A block's 256 items lie in at most two
// row blocks (one holds 8 Kp >= 512 items), so the bits are gathered per
// warp and per block before one global atomic per row block.
__global__ void __launch_bounds__(256)
split_limbs(Strided f, uint8_t* __restrict__ limbs,
            unsigned* __restrict__ used, int M, int K, int Mp, int Kp) {
  __shared__ unsigned seen[2];
  if (threadIdx.x < 2) seen[threadIdx.x] = 0u;
  __syncthreads();
  const long long items = (long long)Mp * (Kp / 4);
  const long long first = (long long)blockIdx.x * 256;
  const long long item = first + threadIdx.x;
  const long long bz = blockIdx.y;
  const int rb0 = static_cast<int>(first / (Kp / 4)) / BM;
  unsigned bits = 0u;
  int m = 0;
  if (item < items) {
    m = static_cast<int>(item / (Kp / 4));
    const int k0 = static_cast<int>(item % (Kp / 4)) * 4;
    const int32_t* row = f.ptr + bz * f.sb + (long long)m * f.sr;
    unsigned w[LIMBS] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j;
      const unsigned v = (m < M && k < K)
                             ? static_cast<unsigned>(row[(long long)k * f.sc])
                             : 0u;
#pragma unroll
      for (int l = 0; l < LIMBS; ++l)
        w[l] |= ((v >> (8 * l)) & 0xffu) << (8 * j);
    }
    unsigned* out = reinterpret_cast<unsigned*>(limbs);
#pragma unroll
    for (int l = 0; l < LIMBS; ++l) {
      out[((bz * LIMBS + l) * Mp + m) * (Kp / 4) + k0 / 4] = w[l];
      bits |= static_cast<unsigned>(w[l] != 0u) << l;
    }
  }
  const bool second = m / BM != rb0;
  const unsigned in0 = __reduce_or_sync(0xffffffffu, second ? 0u : bits);
  const unsigned in1 = __reduce_or_sync(0xffffffffu, second ? bits : 0u);
  if (threadIdx.x % 32 == 0) {
    if (in0) atomicOr(&seen[0], in0);
    if (in1) atomicOr(&seen[1], in1);
  }
  __syncthreads();
  if (threadIdx.x < 2 && seen[threadIdx.x] != 0u)
    atomicOr(&used[bz * (Mp / BM) + rb0 + threadIdx.x], seen[threadIdx.x]);
}

// -- the GEMM ------------------------------------------------------------------------

// The block's GEMM over its NL live limbs: limb (ord >> 8 i) & 0xff in slot
// i, in increasing order, slot 0 always limb 0 (the fold's carry has weight
// 1). Each slot is one m16 tile per warp and one set of int32 sums.
template <bool FRONTIER, bool VEC, int NL>
__device__ __forceinline__ void gemm_body(
    uint8_t* smem, unsigned ord, const uint8_t* __restrict__ limbs,
    const uint8_t* __restrict__ a, const int16_t* __restrict__ d,
    void* __restrict__ out, int M, int N, int K, int Mp, int Kp) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / WARPS_N;  // source rows 16 wm ..
  const int wn = warp % WARPS_N;  // columns 32 wn ..
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const long long bz = blockIdx.z;

  // limb copies: chunks c = tid + THREADS i < 128 NL, slot c / 128, row
  // (c / 4) % 32, chunk c % 4 of the row's 64 bytes
  const uint8_t* lbase = limbs + (bz * LIMBS * Mp + row0) * Kp;
  // adjacency copies: chunks c = tid + THREADS i, row c / (BN / 16),
  // chunk c % (BN / 16)
  const uint8_t* bbase = a + bz * (long long)K * N;

  auto load = [&](int stage, int k0) {
    uint8_t* as = smem + stage * STAGE_BYTES;
    uint8_t* bs = as + A_BYTES;
#pragma unroll
    for (int i = 0; i < (128 * NL + THREADS - 1) / THREADS; ++i) {
      const int c = tid + THREADS * i;
      const int slot = c / 128, m = (c / 4) % BM, ch = c % 4;
      const int l = (ord >> (8 * slot)) & 0xff;
      if (c < 128 * NL)
        cp_async16(as + (slot * BM + m) * A_LD + 16 * ch,
                   lbase + ((long long)l * Mp + m) * Kp + k0 + 16 * ch, 16);
    }
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i) {
      const int c = tid + THREADS * i;
      const int k = c / (BN / 16), ch = c % (BN / 16);
      const int gk = k0 + k, gn = col0 + 16 * ch;
      uint8_t* dst = bs + b_chunk(k, ch);
      if (VEC) {
        const bool in = gk < K && gn < N;  // N % 16 == 0: whole or out
        cp_async16(dst, in ? bbase + (long long)gk * N + gn : bbase,
                   in ? 16 : 0);
      } else {
        unsigned w[4] = {0u, 0u, 0u, 0u};
        if (gk < K) {
          const uint8_t* src = bbase + (long long)gk * N;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (gn + j < N) w[j / 4] |= (unsigned)src[gn + j] << (8 * (j % 4));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  int acc[NL][4][4];
#pragma unroll
  for (int i = 0; i < NL; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  int shift[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) shift[i] = 8 * ((ord >> (8 * i)) & 0xff);
  // the slots' sums of one cell as one total
  auto total = [&](int j, int e) {
    long long v = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) v += (long long)acc[i][j][e] << shift[i];
    return v;
  };

  // the thread's adjacency words: column group 8 wn + g (bytes 32 wn + 4 g
  // .. +3), rows 4 t4 + r (+16) of each 32-deep half stage
  const int bword = 8 * wn + g;
  const int ktiles = Kp / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s * BK);
    cp_async_commit();
  }
  int since_fold = 0;
  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait_ring();
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < ktiles) load(next % STAGES, next * BK);
    cp_async_commit();

    const uint8_t* as = smem + (t % STAGES) * STAGE_BYTES;
    const uint8_t* bs = as + A_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned b0[4], b1[4];
      {
        unsigned x[4], y[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = ks + 4 * t4 + r;
          x[r] = *reinterpret_cast<const unsigned*>(
              bs + b_chunk(k, bword / 4) + 4 * (bword % 4));
          y[r] = *reinterpret_cast<const unsigned*>(
              bs + b_chunk(k + 16, bword / 4) + 4 * (bword % 4));
        }
        transpose4x4(x, b0);
        transpose4x4(y, b1);
      }
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        unsigned af[4];
        const int r = 16 * wm + lane % 16;
        const int k = ks + 16 * (lane / 16);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(af[0]), "=r"(af[1]), "=r"(af[2]), "=r"(af[3])
            : "r"(smem_u32(as + (i * BM + r) * A_LD + k)));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_u8(acc[i][j], af, b0[j], b1[j]);
      }
    }
    if (++since_fold == FOLD_STAGES && t + 1 < ktiles) {
      since_fold = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long v = total(j, e);
          acc[0][j][e] = static_cast<int>(v < MULT_SAT ? v : MULT_SAT);
#pragma unroll
          for (int i = 1; i < NL; ++i) acc[i][j][e] = 0;
        }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  // cell (e, j): row 16 wm + g (+8 for e >= 2), column
  // 32 wn + 8 t4 + 4 (e & 1) + j: four consecutive columns per (e)
  const long long obase = bz * (long long)M * N;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = row0 + 16 * wm + g + (e >= 2 ? 8 : 0);
    const int c0 = col0 + 32 * wn + 8 * t4 + 4 * (e & 1);
    if (r >= M || c0 >= N) continue;
    const long long off = obase + (long long)r * N + c0;
    long long v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = total(j, e);
    if (FRONTIER) {
      int x[4];
      if (VEC) {  // N % 16 == 0: the four columns are in, 8-byte aligned
        const short4 dv = *reinterpret_cast<const short4*>(d + off);
        const short dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[j] = (v[j] > 0 && dd[j] == DIST_UNREACHED)
                     ? static_cast<int>(v[j] < MULT_SAT ? v[j] : MULT_SAT)
                     : 0;
        *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + off) =
            make_int4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < N)
            static_cast<int32_t*>(out)[off + j] =
                (v[j] > 0 && d[off + j] == DIST_UNREACHED)
                    ? static_cast<int>(v[j] < MULT_SAT ? v[j] : MULT_SAT)
                    : 0;
      }
    } else {
      if (VEC) {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + off) =
            make_float4(__ll2float_rn(v[0]), __ll2float_rn(v[1]),
                        __ll2float_rn(v[2]), __ll2float_rn(v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < N)
            static_cast<float*>(out)[off + j] = __ll2float_rn(v[j]);
      }
    }
  }
}

// One block: reads which limbs its rows use (limb 0 always) and runs the
// GEMM over those alone, a branch uniform across the block.
template <bool FRONTIER, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
packed_gemm(const uint8_t* __restrict__ limbs,
            const unsigned* __restrict__ used, const uint8_t* __restrict__ a,
            const int16_t* __restrict__ d, void* __restrict__ out, int M,
            int N, int K, int Mp, int Kp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const unsigned live =
      used[(long long)blockIdx.z * (Mp / BM) + blockIdx.y] | 1u;
  unsigned ord = 0u;
  int nl = 0;
#pragma unroll
  for (int l = 0; l < LIMBS; ++l)
    if (live >> l & 1u) ord |= static_cast<unsigned>(l) << (8 * nl++);
  switch (nl) {
    case 1:
      gemm_body<FRONTIER, VEC, 1>(smem, ord, limbs, a, d, out, M, N, K, Mp, Kp);
      break;
    case 2:
      gemm_body<FRONTIER, VEC, 2>(smem, ord, limbs, a, d, out, M, N, K, Mp, Kp);
      break;
    case 3:
      gemm_body<FRONTIER, VEC, 3>(smem, ord, limbs, a, d, out, M, N, K, Mp, Kp);
      break;
    default:
      gemm_body<FRONTIER, VEC, 4>(smem, ord, limbs, a, d, out, M, N, K, Mp, Kp);
  }
}

// -- the launch ----------------------------------------------------------------------

template <auto kernel>
cudaError_t allow_smem() {
  // once per instantiation: dynamic shared memory above 48 KB
  static const cudaError_t done = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  return done;
}

template <bool FRONTIER, bool VEC>
cudaError_t gemm(const uint8_t* limbs, const unsigned* used, const uint8_t* a,
                 const int16_t* d, void* out, int batch, int m, int n, int k,
                 int mp, int kp, cudaStream_t s) {
  const cudaError_t e = allow_smem<packed_gemm<FRONTIER, VEC>>();
  if (e != cudaSuccess) return e;
  const dim3 grid((n + BN - 1) / BN, mp / BM, batch);
  packed_gemm<FRONTIER, VEC><<<grid, THREADS, SMEM_BYTES, s>>>(
      limbs, used, a, d, out, m, n, k, mp, kp);
  return cudaGetLastError();
}

template <bool FRONTIER>
int launch(Strided f, const void* a, const void* d, void* out, void* limbs,
           int batch, int m, int n, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mp = (m + BM - 1) / BM * BM;
  const int kp = (k + BK - 1) / BK * BK;
  uint8_t* lp = static_cast<uint8_t*>(limbs);
  unsigned* used =
      reinterpret_cast<unsigned*>(lp + (long long)batch * LIMBS * mp * kp);
  cudaError_t e = cudaMemsetAsync(
      used, 0, sizeof(unsigned) * (size_t)batch * (mp / BM), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (kp > 0) {
    const long long items = (long long)mp * (kp / 4);
    const dim3 sgrid(static_cast<unsigned>((items + 255) / 256), batch);
    split_limbs<<<sgrid, 256, 0, s>>>(f, lp, used, m, k, mp, kp);
  }
  const uint8_t* ap = static_cast<const uint8_t*>(a);
  const int16_t* dp = static_cast<const int16_t*>(d);
  // 16-byte adjacency copies need every row on a 16-byte boundary; the
  // frontier's 8-byte distance reads then need an 8-byte aligned base
  const bool vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(ap) % 16 == 0 &&
                   (!FRONTIER || reinterpret_cast<uintptr_t>(dp) % 8 == 0) &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  e = vec ? gemm<FRONTIER, true>(lp, used, ap, dp, out, batch, m, n, k, mp,
                                 kp, s)
          : gemm<FRONTIER, false>(lp, used, ap, dp, out, batch, m, n, k, mp,
                                  kp, s);
  return static_cast<int>(e);
}

}  // namespace

// Both entry points take `limbs`, scratch for batch * 4 * Mp * Kp bytes
// (Mp = m rounded up to 32, Kp = k to 64) followed by batch * Mp / 32
// 32-bit flags (which limbs each row block uses), and return the first launch
// error (a cudaError_t).

// X = where((F@A > 0) & (D == DIST_UNREACHED), min(F@A, MULT_SAT), 0) over
// `batch` contiguous problems: F int32 (m,k), A uint8 (k,n), D int16 (m,n),
// X int32 (m,n).
extern "C" int repro_frontier_step_packed(const void* f, const void* a,
                                          const void* d, void* x, void* limbs,
                                          int batch, int m, int n, int k,
                                          void* stream) {
  const Strided fv{static_cast<const int32_t*>(f), (long long)m * k, k, 1};
  return launch<true>(fv, a, d, x, limbs, batch, m, n, k, stream);
}

// C = A@B as f32 over `batch` problems: A int32 read through its strides
// (batch, row, col, in elements), B uint8 (k,n) and C f32 (m,n) contiguous.
extern "C" int repro_count_matmul_narrow(const void* a, long long sab,
                                         long long sar, long long sac,
                                         const void* b, void* c, void* limbs,
                                         int batch, int m, int n, int k,
                                         void* stream) {
  const Strided av{static_cast<const int32_t*>(a), sab, sar, sac};
  return launch<false>(av, b, nullptr, c, limbs, batch, m, n, k, stream);
}

// Value histogram for Hopper (sm_90a): int32 counts of floor(x) over
// [0, num_bins) for a flat fp32 array; non-finite, negative and
// >= num_bins values are dropped.
//
// Replaces src/repro/kernels/seghist.py value_histogram_pallas (_hist_kernel),
// which avoids scatters on the TPU with one compare-and-popcount pass per bin.
//
// What bounds it: one read of the input, 4n bytes at 3.35 TB/s (an input
// that sits in the 50 MB L2 can be read faster), and a few integer
// operations per element.
//
// Design, one launch a call:
// - No memset, and `out` takes plain stores only. Each stream keeps an
//   accumulator of num_bins int32 that is zero between launches. Every
//   block adds its nonzero bins into it with global atomics (fire-and-
//   forget reductions in L2, at most num_bins a block); a ticket
//   (atomicAdd after __threadfence) picks the last block to finish, which
//   copies the accumulator to `out` with plain stores, zeroes it and
//   resets the ticket for the next launch.
//   Integer sums: exact and deterministic in any order. Launches on one
//   stream are ordered, so each stream needs an accumulator and a ticket of
//   its own: two streams must never share a ticket (the wrapper keeps one
//   pair per device and stream). Timed and dropped: every block writing
//   its whole partial row and the last block summing the rows, a serial
//   tail that was slower on every timed case.
// - One wave of blocks: one a SM, two where each thread still makes two
//   full trips (the host's rule), so few blocks contend for the
//   accumulator.
// - 16-byte loads, UNROLL float4s in flight per thread before any is
//   counted. The float4 body starts at the first 16-byte boundary; block 0's
//   first warp counts the scalar head before it and the scalar tail of
//   (n - head) % 4 elements after it.
// - One shared histogram per block (up to 12,288 bins, opting in past
//   48 KB), each lane making its own shared atomicAdd. Timed and dropped:
//   bins private to each warp (no consistent gap at 65 bins), lanes that
//   hit one bin grouped by __match_any_sync and one atomicAdd a group
//   (slower on every timed case, though a distance matrix's lanes collide
//   often), bins private to each thread, and fewer blocks where the bins
//   are many (slower at 4096 and 12,288 bins).
//   experiments/kernels/seghist_variants.py times other thread counts and
//   loads in flight on rewritten copies of this file.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 4;
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 227 * 1024;

__device__ __forceinline__ int bin_of(float v, float top) {
  // false for NaN and -inf (v >= 0) and for +inf (v < top); -0 is bin 0
  return (v >= 0.f && v < top) ? static_cast<int>(v) : -1;
}

__device__ __forceinline__ void count(int* bins, int bin) {
  if (bin >= 0) atomicAdd(&bins[bin], 1);
}

__device__ __forceinline__ void count4(int* bins, float4 v, float top) {
  count(bins, bin_of(v.x, top));
  count(bins, bin_of(v.y, top));
  count(bins, bin_of(v.z, top));
  count(bins, bin_of(v.w, top));
}

__global__ void __launch_bounds__(THREADS)
value_hist(const float* __restrict__ x, long long n, int head, int num_bins,
           int* __restrict__ acc, unsigned* __restrict__ ticket,
           int* __restrict__ out) {
  extern __shared__ int bins[];  // [num_bins], then the last-block flag
  int* last = bins + num_bins;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  for (int i = t; i < num_bins; i += THREADS) bins[i] = 0;
  __syncthreads();
  const float top = static_cast<float>(num_bins);

  // the float4 body [head, head + 4 nv), split evenly over the blocks; the
  // loop bounds are uniform over the block, so warps stay converged
  const long long nv = (n - head) / 4;
  const float4* __restrict__ v4 = reinterpret_cast<const float4*>(x + head);
  const long long lo = nv * blockIdx.x / gridDim.x;
  const long long hi = nv * (blockIdx.x + 1) / gridDim.x;
  long long base = lo;
  for (; base + UNROLL * THREADS <= hi; base += UNROLL * THREADS) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(&v4[base + u * THREADS + t]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) count4(bins, v[u], top);
  }
  for (; base < hi; base += THREADS) {
    float4 v = make_float4(-1.f, -1.f, -1.f, -1.f);  // -1: no bin
    if (base + t < hi) v = __ldg(&v4[base + t]);
    count4(bins, v, top);
  }
  if (blockIdx.x == 0 && warp == 0) {  // the scalar head and tail
    const int tail = static_cast<int>((n - head) % 4);
    float v = -1.f;
    if (lane < head) v = x[lane];
    else if (lane < head + tail) v = x[head + 4 * nv + (lane - head)];
    count(bins, bin_of(v, top));
  }
  __syncthreads();

  // every block adds its nonzero bins into the stream's accumulator (zero
  // between launches); the last block copies it to `out` and zeroes it
  for (int b = t; b < num_bins; b += THREADS) {
    const int s = bins[b];
    if (s != 0) atomicAdd(&acc[b], s);
  }
  __threadfence();
  __syncthreads();
  if (t == 0) *last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*last) return;
  for (int b = t; b < num_bins; b += THREADS) {
    out[b] = __ldcg(&acc[b]);
    acc[b] = 0;
  }
  if (t == 0) *ticket = 0;
}

}  // namespace

// out[b] = #{i : floor(x[i]) == b} for b in [0, num_bins), over n >= 1
// contiguous fp32 values, in one launch of `blocks` blocks. acc is this
// stream's accumulator of num_bins int32 and ticket its counter, both zero
// before the launch and zero after it. Returns the cudaError_t.
extern "C" int repro_value_histogram_f32(const void* x, long long n,
                                         int num_bins, int blocks,
                                         void* acc, void* ticket, void* out,
                                         void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (n < 1 || num_bins < 1 || blocks < 1 || addr % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long head_max = static_cast<long long>((16 - addr % 16) % 16) / 4;
  const int head = static_cast<int>(head_max < n ? head_max : n);
  const size_t smem = (static_cast<size_t>(num_bins) + 1) * sizeof(int);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > SMEM_DEFAULT) {  // 48 KB of bins and the flag: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        value_hist, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  value_hist<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, head, num_bins,
      static_cast<int*>(acc), static_cast<unsigned*>(ticket),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

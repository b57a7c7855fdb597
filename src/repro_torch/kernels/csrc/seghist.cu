// Value histogram for Hopper (sm_90a): int32 counts of floor(x) over
// [0, num_bins) for a flat fp32 array; non-finite, negative and
// >= num_bins values are dropped.
//
// Replaces src/repro/kernels/seghist.py value_histogram_pallas (_hist_kernel),
// which avoids scatters on the TPU with one compare-and-popcount pass per bin.
//
// What bounds it: one read of the input, n * 4 bytes, and a few integer
// operations per element, so it is bound by device-memory bandwidth.
//
// Design: a privatized shared-memory histogram. Each block walks its
// grid-stride slice of the input (neighbouring threads on neighbouring
// addresses), counts into int bins in shared memory, then adds its nonzero
// bins into the global int32 output with one atomicAdd each. A distance
// matrix holds a handful of values, so most lanes of a warp hit the same
// bin: __match_any_sync groups the lanes by bin and one lane per group adds
// the group's size, so a warp makes one shared atomic per distinct bin.
// Integer counts are exact in any order: the result is bit-equal to any
// other evaluation. num_bins is a runtime argument (dynamic shared memory).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1056;  // 8 resident blocks on each of 132 SMs

__global__ void __launch_bounds__(THREADS)
value_hist(const float* __restrict__ x, long long n, int num_bins,
           int* __restrict__ out) {
  extern __shared__ int bins[];
  for (int b = threadIdx.x; b < num_bins; b += THREADS) bins[b] = 0;
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const float top = static_cast<float>(num_bins);
  const long long stride = (long long)gridDim.x * THREADS;
  // the loop bound is uniform over the block, so every warp stays converged
  // for __match_any_sync; lanes past the end carry bin -1
  for (long long base = (long long)blockIdx.x * THREADS; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    int bin = -1;
    if (i < n) {
      const float v = x[i];
      if (isfinite(v) && v >= 0.f && v < top) bin = static_cast<int>(v);
    }
    const unsigned group = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(group) - 1)
      atomicAdd(&bins[bin], __popc(group));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_bins; b += THREADS)
    if (bins[b] != 0) atomicAdd(&out[b], bins[b]);
}

}  // namespace

// out[b] += #{i : floor(x[i]) == b} for b in [0, num_bins), over n contiguous
// fp32 values; the caller zeroes out. Returns the launch's cudaError_t.
extern "C" int repro_value_histogram_f32(const void* x, long long n,
                                         int num_bins, void* out,
                                         void* stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  const size_t smem = static_cast<size_t>(num_bins) * sizeof(int);
  value_hist<<<static_cast<int>(blocks), THREADS, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, num_bins, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

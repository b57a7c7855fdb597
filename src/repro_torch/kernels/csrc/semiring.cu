// Counting-semiring GEMMs for Hopper (sm_90a): the fused BFS frontier step,
// the plain counting product and the boolean (reachability) product, all
// batched over blockIdx.z: one GEMM on two tiles, three store policies.
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
// The GEMM itself, its two tiles and the device flag that picks one per
// call, lives in counting_tiles.cuh, which the kernels generated for a
// user's MXU-path Semiring instantiate too; this file gives it the three
// store policies of the entry points below: the counts (CountStore), the
// counts masked to first reaches, reading the distance block once
// (FrontierStore), and the boolean threshold acc > 0.5 (BooleanStore).
// Built without --use_fast_math, so the compares and adds stay IEEE.
#include "counting_tiles.cuh"

using counting_tiles::BooleanStore;
using counting_tiles::CountStore;
using counting_tiles::FrontierStore;
using counting_tiles::Strided;
using counting_tiles::dispatch;

// The three entry points share their arguments. `a` is read through its
// (batch, row, col) strides in elements, in the layout the host chose
// (0 row-major, 1 column-major, 2 strided); b is a contiguous (batch, k, n)
// stack. b16 is scratch for batch * Kp * Np bf16 values (Kp = k rounded up
// to 32, Np = n to 128), flag one int of scratch, and counters two ints,
// the launches of tile (a) and tile (b), to which the tile that runs adds
// one. Each returns the first launch error (a cudaError_t).

// X = where((F@A > 0) & (D == +inf), F@A, 0); d is contiguous like x.
extern "C" int repro_frontier_step_f32(int layout, const void* f,
                                       long long sfb, long long sfr,
                                       long long sfc, const void* a,
                                       const void* d, void* x, void* b16,
                                       void* flag, void* counters, int batch,
                                       int m, int n, int k, void* stream) {
  const Strided fv{static_cast<const float*>(f), sfb, sfr, sfc};
  const FrontierStore st{static_cast<const float*>(d), static_cast<float*>(x)};
  return dispatch(layout, fv, static_cast<const float*>(a), nullptr, st, b16,
                  flag, counters, batch, m, n, k, stream);
}

// C = A@B.
extern "C" int repro_count_matmul_f32(int layout, const void* a,
                                      long long sab, long long sar,
                                      long long sac, const void* b,
                                      const void* unused_d, void* c, void* b16,
                                      void* flag, void* counters, int batch,
                                      int m, int n, int k, void* stream) {
  const Strided av{static_cast<const float*>(a), sab, sar, sac};
  return dispatch(layout, av, static_cast<const float*>(b), nullptr,
                  CountStore{static_cast<float*>(c)}, b16, flag, counters,
                  batch, m, n, k, stream);
}

// R = (A@B > 0.5) as fp32 {0,1}: the boolean-semiring product of {0,1}
// masks.
extern "C" int repro_reachability_step_f32(int layout, const void* a,
                                           long long sab, long long sar,
                                           long long sac, const void* b,
                                           const void* unused_d, void* r,
                                           void* b16, void* flag,
                                           void* counters, int batch, int m,
                                           int n, int k, void* stream) {
  const Strided av{static_cast<const float*>(a), sab, sar, sac};
  return dispatch(layout, av, static_cast<const float*>(b), nullptr,
                  BooleanStore{static_cast<float*>(r)}, b16, flag, counters,
                  batch, m, n, k, stream);
}

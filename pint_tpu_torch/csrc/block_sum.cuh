// A fixed-order block reduction for the port's normal-equation kernels
// (normal_eq.cu, ecorr_normal_eq.cu): no atomics, so a sum is bitwise the
// same run after run (ROADMAP C3).
#pragma once

#include <cuda_runtime.h>

namespace pint {

// Sum v[0..Q) over a block of THREADS threads into out[0..Q) (visible to
// all threads after return): a shuffle tree within each warp, then the
// warps' sums in warp order.
template <int THREADS, int Q>
__device__ __forceinline__ void block_sum(double (&v)[Q], double *out) {
  __shared__ double part[THREADS / 32][Q];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    double x = v[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = __dadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) part[warp][q] = x;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += THREADS) {
    double s = 0.0;
    for (int k = 0; k < THREADS / 32; ++k) s = __dadd_rn(s, part[k][q]);
    out[q] = s;
  }
  __syncthreads();
}

}  // namespace pint

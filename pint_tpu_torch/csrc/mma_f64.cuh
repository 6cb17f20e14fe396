// The float64 tensor-core (DMMA) and cp.async helpers shared by the port's
// kernels that run matrix products on Hopper's float64 tensor cores: kernel
// K3's Gram (ecorr_normal_eq.cu) and the backward kernels K9 and K10
// (noise_grad.cu, pta_grad.cu, through grad_tiles.cuh).
//
// mma.sync.m16n8k8 .f64: D (16 x 8) = A (16 x 8) B (8 x 8) + C. With the
// lane's group gi = lane / 4 and thread ti = lane % 4, a lane holds
//   A: a0 (gi, ti), a1 (gi + 8, ti), a2 (gi, ti + 4), a3 (gi + 8, ti + 4);
//   B: b0 (ti, gi), b1 (ti + 4, gi);
//   C, D: c0 (gi, 2 ti), c1 (gi, 2 ti + 1), c2 (gi + 8, 2 ti), c3 (gi + 8, 2 ti + 1).
#pragma once

#include <cuda_runtime.h>

namespace pint {

__device__ __forceinline__ void cp_async16(double *dst, const double *src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
// 8 bytes, or zeros where !valid (src must still be a valid address: the
// copy reads nothing then)
__device__ __forceinline__ void cp_async8(double *dst, const double *src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one m16n8k8 product: MR rows, KS deep; a lane holds NA values of A, NB of
// B and NACC of the accumulator
constexpr int MR = 16, KS = 8, NACC = 4;
constexpr int NA = KS / 4 * (MR / 8), NB = KS / 4;

// acc += A B: this lane's A values av, B values bv
__device__ __forceinline__ void mma(double (&acc)[NACC], const double (&av)[NA],
                                    const double (&bv)[NB]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(acc[0]), "+d"(acc[1]), "+d"(acc[2]), "+d"(acc[3])
      : "d"(av[0]), "d"(av[1]), "d"(av[2]), "d"(av[3]), "d"(bv[0]), "d"(bv[1]));
}

}  // namespace pint

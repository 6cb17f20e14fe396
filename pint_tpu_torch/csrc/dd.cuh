// Double-double arithmetic for CUDA: the device side of pint_tpu_torch/ops/dd.py.
//
// Replaces pint_tpu/ops/dd.py (two_sum, quick_two_sum, _split/two_prod,
// dd_add/_fp, dd_sub, dd_mul/_fp, dd_div, dd_rint), which XLA compiled into
// every TPU program of the phase chain. A value is the unevaluated sum
// hi + lo of two doubles.
//
// Contraction: the error-free transforms depend on every add, subtract and
// multiply being rounded on its own. nvcc contracts a*b+c into an FMA by
// default, which breaks Knuth's two_sum and Dekker's split. So every such
// operation here is an explicit __dadd_rn/__dsub_rn/__dmul_rn (which nvcc
// never contracts), and the kernels are also built with --fmad=false.
//
// two_prod uses fma(a, b, -p): the FMA rounds once, so it returns the exact
// error a*b - fl(a*b), which is what Dekker's split product returns for
// finite inputs whose products neither overflow nor underflow. The two are
// therefore bitwise equal on every timing quantity, and the FMA form costs
// 2 operations instead of 17.
//
// Operation order follows the Python twins term by term, so that the twins
// on the card reproduce these results bit for bit (checked by chip_smoke.py).
#pragma once

#include <cuda_runtime.h>

namespace pint {

struct dd {
  double hi, lo;
};

__device__ __forceinline__ void two_sum(double a, double b, double &s, double &e) {
  s = __dadd_rn(a, b);
  const double bb = __dsub_rn(s, a);
  e = __dadd_rn(__dsub_rn(a, __dsub_rn(s, bb)), __dsub_rn(b, bb));
}

__device__ __forceinline__ void quick_two_sum(double a, double b, double &s, double &e) {
  s = __dadd_rn(a, b);
  e = __dsub_rn(b, __dsub_rn(s, a));
}

__device__ __forceinline__ void two_prod(double a, double b, double &p, double &e) {
  p = __dmul_rn(a, b);
  e = __fma_rn(a, b, -p);
}

__device__ __forceinline__ dd dd_make(double hi, double lo = 0.0) { return dd{hi, lo}; }

__device__ __forceinline__ dd dd_neg(dd x) { return dd{-x.hi, -x.lo}; }

__device__ __forceinline__ dd dd_add(dd x, dd y) {
  double s1, s2, t1, t2;
  two_sum(x.hi, y.hi, s1, s2);
  two_sum(x.lo, y.lo, t1, t2);
  s2 = __dadd_rn(s2, t1);
  quick_two_sum(s1, s2, s1, s2);
  s2 = __dadd_rn(s2, t2);
  dd r;
  quick_two_sum(s1, s2, r.hi, r.lo);
  return r;
}

__device__ __forceinline__ dd dd_add_fp(dd x, double b) {
  double s, e;
  two_sum(x.hi, b, s, e);
  e = __dadd_rn(e, x.lo);
  dd r;
  quick_two_sum(s, e, r.hi, r.lo);
  return r;
}

__device__ __forceinline__ dd dd_sub(dd x, dd y) { return dd_add(x, dd_neg(y)); }

__device__ __forceinline__ dd dd_mul(dd x, dd y) {
  double p, e;
  two_prod(x.hi, y.hi, p, e);
  e = __dadd_rn(__dadd_rn(e, __dmul_rn(x.hi, y.lo)), __dmul_rn(x.lo, y.hi));
  dd r;
  quick_two_sum(p, e, r.hi, r.lo);
  return r;
}

__device__ __forceinline__ dd dd_mul_fp(dd x, double b) {
  double p, e;
  two_prod(x.hi, b, p, e);
  e = __dadd_rn(e, __dmul_rn(x.lo, b));
  dd r;
  quick_two_sum(p, e, r.hi, r.lo);
  return r;
}

__device__ __forceinline__ dd dd_div(dd x, dd y) {
  const double q1 = __ddiv_rn(x.hi, y.hi);
  dd r = dd_add(x, dd_neg(dd_mul(y, dd_make(q1))));
  const double q2 = __ddiv_rn(r.hi, y.hi);
  r = dd_add(r, dd_neg(dd_mul(y, dd_make(q2))));
  const double q3 = __ddiv_rn(r.hi, y.hi);
  double s, e;
  two_sum(q1, q2, s, e);
  dd out;
  quick_two_sum(s, __dadd_rn(e, q3), out.hi, out.lo);
  return out;
}

// (nearest integer, dd remainder); rint rounds half to even like torch.round
__device__ __forceinline__ dd dd_rint(dd x, double &n) {
  const double n1 = rint(x.hi);
  dd r = dd_add_fp(x, -n1);
  const double n2 = rint(r.hi);
  r = dd_add_fp(r, -n2);
  n = __dadd_rn(n1, n2);
  return r;
}

__device__ __forceinline__ double dd_to_float(dd x) { return __dadd_rn(x.hi, x.lo); }

}  // namespace pint

// Every library exports this for the ctypes wrappers' error messages.
#define PINT_EXPORT_ERROR_STRING                                  \
  extern "C" const char *pint_cuda_error_string(int code) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(code));    \
  }

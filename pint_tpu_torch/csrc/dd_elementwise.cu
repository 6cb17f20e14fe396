// K0 dd_elementwise: one operation of dd.cuh over n elements.
//
// Replaces: the elementwise double-double arithmetic of pint_tpu/ops/dd.py,
// which the TPU programs inlined everywhere; here it serves the fit loops'
// parameter updates (fitting/wls.py apply_delta) and lets chip_smoke.py hold
// the header bitwise against the plain-torch twins in ops/dd.py.
//
// Bound: device-memory bytes. Each element reads at most four doubles and
// writes at most three, against ~20-60 double operations: far below the
// H100's ~10 flops-per-byte ridge. One thread per element, grid-stride loop,
// neighbouring threads on neighbouring addresses.
//
// op codes (ops/dd.py _K0_OPS): 0 add(x, y) 1 add_fp(x, y.hi) 2 mul(x, y)
// 3 mul_fp(x, y.hi) 4 div(x, y) 5 two_prod(x.hi, y.hi) 6 rint(x) -> (n, r)
#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

__global__ void dd_elementwise_kernel(int op, const double *__restrict__ xhi,
                                      const double *__restrict__ xlo,
                                      const double *__restrict__ yhi,
                                      const double *__restrict__ ylo,
                                      double *__restrict__ o0, double *__restrict__ o1,
                                      double *__restrict__ o2, long long n) {
  using namespace pint;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const dd x{xhi[i], xlo[i]};
    dd r{0.0, 0.0};
    switch (op) {
      case 0: r = dd_add(x, dd{yhi[i], ylo[i]}); break;
      case 1: r = dd_add_fp(x, yhi[i]); break;
      case 2: r = dd_mul(x, dd{yhi[i], ylo[i]}); break;
      case 3: r = dd_mul_fp(x, yhi[i]); break;
      case 4: r = dd_div(x, dd{yhi[i], ylo[i]}); break;
      case 5: two_prod(x.hi, yhi[i], r.hi, r.lo); break;
      case 6: {
        double k;
        r = dd_rint(x, k);
        o0[i] = k;
        o1[i] = r.hi;
        o2[i] = r.lo;
        continue;
      }
      default: return;
    }
    o0[i] = r.hi;
    o1[i] = r.lo;
  }
}

}  // namespace

extern "C" int dd_elementwise(int op, const double *xhi, const double *xlo,
                              const double *yhi, const double *ylo, double *o0,
                              double *o1, double *o2, long long n, void *stream) {
  if (op < 0 || op > 6) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  dd_elementwise_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      op, xhi, xlo, yhi, ylo, o0, o1, o2, n);
  return static_cast<int>(cudaGetLastError());
}

// K7 chebyshev_eval: the Chebyshev kernel-pack serve. For each (epoch,
// requested body), one thread walks the body's chain of pack rows to the
// SSB (the DE layout: the Earth is Earth -> EMB -> SSB); for each row it
// picks the record, evaluates the Chebyshev series and its analytic
// derivative, and adds the row into the body's position and velocity.
//
// Replaces: the `prepare_kernel_eval` device program of
// pint_tpu/astro/device_prepare.py:233-266 (_build_kernel_program), which
// XLA compiled from pint_tpu/astro/kernel_ephemeris.py eval_rows (:146-193)
// with xp=jnp. Plain twin: pint_tpu_torch/astro/kernel_ephemeris.py
// eval_posvel (via device_prepare.chebyshev_eval_plain).
//
// Bound: bytes at the prepare's sizes. Each (epoch, row) reads one record
// (C x 3 coefficients and its midpoint, ~340 bytes at C = 14) and does ~20
// operations per coefficient; the records of a pack (4 MB for the N-body
// snapshot, 11 bodies x 1,096 records) stay in L2, and neighbouring epochs
// (sorted TOAs) read the same record. The design: no shared memory, the
// recurrence values T_k and dT_k in a small per-thread array so that the
// terms can be summed from the highest order down.
//
// Arithmetic follows pint_tpu's eval_rows term by term (built with
// --fmad=false, so nothing is contracted): the epoch in two steps,
// (t * 36525.0) * 86400.0 [ET s] (a one-constant product rounds epochs
// ~5e-8 s differently, ~2 mm of EMB motion); the record index
// floor((t - init) / intlen) clipped to [0, nrec - 1]; tau = (t - mid) /
// radius; T_k = 2 tau T_{k-1} - T_{k-2}, dT_k = 2 T_{k-1} + 2 tau dT_{k-1} -
// dT_{k-2}; the terms summed small to large (the highest order first, the
// constant last); the velocity the derivative sum over the radius; the
// chain's rows added in order, then x 1e3 (km to m).
#include <cuda_runtime.h>

#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

constexpr int MAX_COEF = 32;

// rows: (nc, L) int32, each requested body's chain of pack rows, -1 after
// its last
__global__ void chebyshev_eval_kernel(const double *__restrict__ tjc,
                                      const double *__restrict__ coef,
                                      const double *__restrict__ mid,
                                      const double *__restrict__ init,
                                      const double *__restrict__ intlen,
                                      const int *__restrict__ nrec, int R, int C,
                                      const int *__restrict__ rows, int L,
                                      double *__restrict__ pos, double *__restrict__ vel,
                                      long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int slot = blockIdx.y;
  const double et = (tjc[i] * 36525.0) * 86400.0;
  double accp[3] = {0.0, 0.0, 0.0}, accv[3] = {0.0, 0.0, 0.0};
  double T[MAX_COEF], dT[MAX_COEF];
  for (int l = 0; l < L; ++l) {
    const int b = rows[slot * L + l];
    if (b < 0) break;
    long long r = static_cast<long long>(floor((et - init[b]) / intlen[b]));
    r = r < 0 ? 0 : r;
    r = r > nrec[b] - 1 ? nrec[b] - 1 : r;
    const double *cb = coef + (static_cast<long long>(b) * R + r) * C * 3;
    const double radius = intlen[b] * 0.5;
    const double tau = (et - mid[static_cast<long long>(b) * R + r]) / radius;
    T[0] = 1.0;
    dT[0] = 0.0;
    if (C > 1) {
      T[1] = tau;
      dT[1] = 1.0;
    }
    for (int k = 2; k < C; ++k) {
      T[k] = 2.0 * tau * T[k - 1] - T[k - 2];
      dT[k] = 2.0 * T[k - 1] + 2.0 * tau * dT[k - 1] - dT[k - 2];
    }
    for (int c = 0; c < 3; ++c) {
      double tail = 0.0, v = 0.0;
      for (int k = C - 1; k >= 1; --k) {
        tail = tail + cb[3 * k + c] * T[k];
        v = v + cb[3 * k + c] * dT[k];
      }
      accp[c] = accp[c] + (cb[c] + tail);
      accv[c] = accv[c] + v / radius;
    }
  }
  double *po = pos + (slot * n + i) * 3, *vo = vel + (slot * n + i) * 3;
  for (int c = 0; c < 3; ++c) {
    po[c] = accp[c] * 1e3;
    vo[c] = accv[c] * 1e3;
  }
}

}  // namespace

extern "C" int chebyshev_eval(const double *tjc, const double *coef, const double *mid,
                              const double *init, const double *intlen, const int *nrec, int B,
                              int R, int C, const int *rows, int nc, int L, double *pos,
                              double *vel, long long n, void *stream) {
  if (B <= 0 || R <= 0 || C <= 0 || C > MAX_COEF || nc <= 0 || nc > 65535 || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  const dim3 grid_dim(static_cast<unsigned>(blocks), static_cast<unsigned>(nc));
  chebyshev_eval_kernel<<<grid_dim, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      tjc, coef, mid, init, intlen, nrec, R, C, rows, L, pos, vel, n);
  return static_cast<int>(cudaGetLastError());
}

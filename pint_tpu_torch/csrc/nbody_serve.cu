// K6 nbody_serve: the N-body window's serve. For each (epoch, requested
// body), one thread: the cubic-Hermite interpolation of the integrated
// trajectory and, for the Earth and the Moon, the subtraction of the
// in-band correction (the window's misfit against the analytic anchors).
//
// Replaces: the `prepare_nbody` device program of
// pint_tpu/astro/device_prepare.py:175-230 (_build_nbody_program, with
// _band_design_jnp :154-172), which XLA fused from pint_tpu/astro/nbody.py
// NBodyEphemeris.posvel / _posvel_raw / _band_design. Plain twin:
// pint_tpu_torch/astro/nbody.py NBodyEphemeris.posvel.
//
// Bound: float64 operations for the Earth and the Moon, bytes for the
// others. A body without the correction reads its epoch, two grid samples
// of position and velocity (96 bytes, from a 4 MB window that stays in L2)
// and writes 48 bytes for ~60 operations. The Earth adds 39 design columns
// and their derivatives: 16 sines and cosines (~35 operations each) and ~250
// other operations; the Moon adds the Moon's 27 columns on top (10 more sines
// and cosines). The design keeps every column in registers and adds it into
// the sum as it is made (no design matrix in memory); the correction
// coefficients (at most 7 + 4 x 16 rows of 3) are read by every thread of a
// warp at one address and stay in L1.
//
// Arithmetic follows pint_tpu's host numpy term by term (built with
// --fmad=false, so nothing is contracted): t = (t_jcent - t0) * CENT_S; the
// grid cell by numpy's float floor division (fmod, then the quotient of the
// remainder-free part, then floor with numpy's half-way fix), which is not
// floor(a / b) at exact multiples of the grid step; the Hermite weights and
// their derivatives in numpy's operation order. Two departures from numpy,
// which the twin on the card shares, so the two are bitwise equal there:
// powers are left-to-right products (numpy's power calls a vector pow), and
// G . corr is summed column by column in order (numpy's BLAS product sums
// in an order of its own; the two differ by ~1e-9 m on the flagship window).
//
// consts layout (doubles, device_prepare._k6_consts): [0] t0 [1] CENT_S
// [2] S = half span (s) [3] 1 / S, then the angular rates (rad/s) of the
// Earth's ne trusted periods and of the Moon's nm.
#include <cuda_runtime.h>

#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

constexpr int NPOLY = 7;
constexpr int MAX_PERIODS = 32;

__device__ __forceinline__ double ipow(double x, int k) {
  double out = x;
  for (int j = 1; j < k; ++j) out = out * x;
  return out;
}

// numpy's float floor division a // b (npy_divmod)
__device__ __forceinline__ double np_floor_divide(double a, double b) {
  const double mod = fmod(a, b);
  double div = (a - mod) / b;
  if (mod != 0.0 && ((b < 0.0) != (mod < 0.0))) div = div - 1.0;
  if (div == 0.0) return copysign(0.0, a / b);
  double fl = floor(div);
  if (div - fl > 0.5) fl = fl + 1.0;
  return fl;
}

// one design column g (and its derivative dg) into the sums: s += g corr_j
__device__ __forceinline__ void add_col(int j, double g, double dg, const double *corr,
                                        double sp[3], double sv[3]) {
  for (int c = 0; c < 3; ++c) {
    const double cj = corr[3 * j + c];
    if (j == 0) {
      sp[c] = g * cj;
      sv[c] = dg * cj;
    } else {
      sp[c] = sp[c] + g * cj;
      sv[c] = sv[c] + dg * cj;
    }
  }
}

// G . corr and dG . corr of one band: {1, tn..tn^6} + (1, tn) x sin/cos at
// each of the nper angular rates w (NBodyEphemeris._band_design, deriv=True)
__device__ void band_sum(double t, const double *w, int nper, const double *corr, double S,
                         double invS, double sp[3], double sv[3]) {
  const double tn = t / S;
  add_col(0, 1.0, 0.0, corr, sp, sv);
  add_col(1, tn, invS, corr, sp, sv);
  for (int k = 2; k < NPOLY; ++k)
    add_col(k, ipow(tn, k), (static_cast<double>(k) * ipow(tn, k - 1)) / S, corr, sp, sv);
  for (int p = 0; p < nper; ++p) {
    const double wp = w[p];
    const double wt = wp * t;
    const double s = sin(wt), c = cos(wt);
    const double tw = tn * wp;
    const int j = NPOLY + 4 * p;
    add_col(j, s, wp * c, corr, sp, sv);
    add_col(j + 1, c, (-wp) * s, corr, sp, sv);
    add_col(j + 2, tn * s, s / S + tw * c, corr, sp, sv);
    add_col(j + 3, tn * c, c / S - tw * s, corr, sp, sv);
  }
}

// codes: (nb, 2) int32, the body's index in the window and its band (0 none,
// 1 the Earth's correction, 2 the Earth's and the Moon's)
__global__ void nbody_serve_kernel(const double *__restrict__ tjc,
                                   const double *__restrict__ grid, int G,
                                   const double *__restrict__ wpos,
                                   const double *__restrict__ wvel, int nbody,
                                   const double *__restrict__ corr_e,
                                   const double *__restrict__ corr_m,
                                   const double *__restrict__ consts, int ne, int nm,
                                   const int *__restrict__ codes, double *__restrict__ pos,
                                   double *__restrict__ vel, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int slot = blockIdx.y;
  const int bi = codes[2 * slot], band = codes[2 * slot + 1];
  const double t0 = consts[0], CENT_S = consts[1], S = consts[2], invS = consts[3];
  const double t = (tjc[i] - t0) * CENT_S;

  // the grid cell and the Hermite weights
  const double h = grid[1] - grid[0];
  long long k = static_cast<long long>(np_floor_divide(t - grid[0], h));
  k = k < 0 ? 0 : (k > G - 2 ? G - 2 : k);
  const double u = (t - grid[k]) / h;
  const double u2 = ipow(u, 2), u3 = ipow(u, 3);
  const double h00 = 2.0 * u3 - 3.0 * u2 + 1.0;
  const double h10 = u3 - 2.0 * u2 + u;
  const double h01 = -2.0 * u3 + 3.0 * u2;
  const double h11 = u3 - u2;
  const double d00 = (6.0 * u2 - 6.0 * u) / h;
  const double d10 = (3.0 * u2 - 4.0 * u + 1.0) / h;
  const double d01 = (-6.0 * u2 + 6.0 * u) / h;
  const double d11 = (3.0 * u2 - 2.0 * u) / h;
  const double *q0 = wpos + (k * nbody + bi) * 3, *q1 = wpos + ((k + 1) * nbody + bi) * 3;
  const double *r0 = wvel + (k * nbody + bi) * 3, *r1 = wvel + ((k + 1) * nbody + bi) * 3;
  double p[3], v[3];
  for (int c = 0; c < 3; ++c) {
    const double p0 = q0[c], p1 = q1[c], v0 = r0[c] * h, v1 = r1[c] * h;
    p[c] = h00 * p0 + h10 * v0 + h01 * p1 + h11 * v1;
    v[c] = d00 * p0 + d10 * v0 + d01 * p1 + d11 * v1;
  }

  // the in-band corrections, each summed whole and then subtracted
  if (band >= 1) {
    double sp[3], sv[3];
    band_sum(t, consts + 4, ne, corr_e, S, invS, sp, sv);
    for (int c = 0; c < 3; ++c) {
      p[c] = p[c] - sp[c];
      v[c] = v[c] - sv[c];
    }
  }
  if (band >= 2) {
    double sp[3], sv[3];
    band_sum(t, consts + 4 + ne, nm, corr_m, S, invS, sp, sv);
    for (int c = 0; c < 3; ++c) {
      p[c] = p[c] - sp[c];
      v[c] = v[c] - sv[c];
    }
  }
  double *po = pos + (slot * n + i) * 3, *vo = vel + (slot * n + i) * 3;
  for (int c = 0; c < 3; ++c) {
    po[c] = p[c];
    vo[c] = v[c];
  }
}

}  // namespace

extern "C" int nbody_serve(const double *tjc, const double *grid, int G, const double *wpos,
                           const double *wvel, int nbody, const double *corr_e,
                           const double *corr_m, const double *consts, int ne, int nm,
                           const int *codes, int nb, double *pos, double *vel, long long n,
                           void *stream) {
  if (G < 2 || nb <= 0 || nb > 65535 || ne < 0 || nm < 0 || ne > MAX_PERIODS ||
      nm > MAX_PERIODS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  const dim3 grid_dim(static_cast<unsigned>(blocks), static_cast<unsigned>(nb));
  nbody_serve_kernel<<<grid_dim, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      tjc, grid, G, wpos, wvel, nbody, corr_e, corr_m, consts, ne, nm, codes, pos, vel, n);
  return static_cast<int>(cudaGetLastError());
}

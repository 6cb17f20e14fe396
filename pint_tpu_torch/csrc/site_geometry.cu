// K4 site_geometry: ITRF -> GCRS position and velocity of one observatory
// at N epochs, one thread per epoch.
//
// Replaces: the `prepare_geometry` device program of
// pint_tpu/astro/device_prepare.py:91-118, which XLA fused from
// pint_tpu/astro/erot.py itrf_to_gcrs_posvel (Fukushima-Williams precession,
// truncated IAU2000B nutation, ERA/GMST/GAST, the NPB matrix and polar
// motion). Plain twin: pint_tpu_torch/astro/erot.py itrf_to_gcrs_posvel.
//
// Bound: float64 operations. Each epoch reads 4 doubles and writes 6, and
// does ~64 sines and cosines (30 nutation arguments, each sine and cosine,
// and 5 angles) and ~500 other operations: ~2,700 operations against 80
// bytes, far above the card's ~10 operations per byte. The design keeps the
// per-epoch chain in registers; the 30-term nutation table and the
// polynomial coefficients (the twin's, passed in, so the series have one
// source) sit in shared memory, read by all threads of a warp at once.
//
// Arithmetic follows the twin and pint_tpu's numpy term by term (built with
// --fmad=false, so nothing is contracted): the nutation sums in numpy's
// pairwise order (8 partial sums, erot.npsum), the 3x3 matrix products as
// numpy's matmul runs them (a0 b0, then two fused multiply-adds), the
// remainders with the divisor's sign (np.remainder; fmod keeps the
// dividend's).
//
// consts layout (doubles, erot.py via device_prepare._k4_consts):
//   [0] ARCSEC [1] TWO_PI [2] OMEGA_EARTH
//   [3..8] FW_GAMB [9..14] FW_PHIB [15..20] FW_PSIB [21..26] FW_EPSA
//   [27..32] GMST_POLY, then NUT_TABLE (NTERMS x 9)
#include <cuda_runtime.h>

#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

constexpr int NCONST = 33;
constexpr int NCOEF = 6;

__device__ __forceinline__ double poly6(const double *c, double T) {
  double out = 0.0;
  for (int k = NCOEF - 1; k >= 0; --k) out = out * T + c[k];
  return out;
}

// np.remainder for a positive divisor
__device__ __forceinline__ double pymod(double x, double m) {
  const double r = fmod(x, m);
  return r < 0.0 ? r + m : r;
}

struct mat3 {
  double a[3][3];
};

__device__ __forceinline__ mat3 rx(double t) {
  const double c = cos(t), s = sin(t);
  return mat3{{{1.0, 0.0, 0.0}, {0.0, c, s}, {0.0, -s, c}}};
}

__device__ __forceinline__ mat3 rz(double t) {
  const double c = cos(t), s = sin(t);
  return mat3{{{c, s, 0.0}, {-s, c, 0.0}, {0.0, 0.0, 1.0}}};
}

// numpy's order for stacked 3x3 products: a0 b0, then fma over k = 1, 2
__device__ __forceinline__ mat3 mul(const mat3 &x, const mat3 &y) {
  mat3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.a[i][j] = __fma_rn(x.a[i][2], y.a[2][j],
                           __fma_rn(x.a[i][1], y.a[1][j], x.a[i][0] * y.a[0][j]));
  return r;
}

// one term of the nutation series: (amplitude + rate T) * sin or cos(arg)
__device__ __forceinline__ double nut_term(const double *row, const double *args, double T,
                                           bool psi) {
  double arg = args[0] * row[0];
  for (int j = 1; j < 5; ++j) arg = arg + args[j] * row[j];
  return psi ? (row[5] + row[6] * T) * sin(arg) : (row[7] + row[8] * T) * cos(arg);
}

// numpy's pairwise sum of the n <= 128 terms (erot.npsum)
__device__ double nut_sum(const double *tab, int n, const double *args, double T, bool psi) {
  if (n < 8) {
    double res = 0.0;
    for (int i = 0; i < n; ++i) res = res + nut_term(tab + 9 * i, args, T, psi);
    return res;
  }
  double r[8];
  for (int j = 0; j < 8; ++j) r[j] = nut_term(tab + 9 * j, args, T, psi);
  const int m = n - n % 8;
  int i = 8;
  for (; i < m; i += 8)
    for (int j = 0; j < 8; ++j) r[j] = r[j] + nut_term(tab + 9 * (i + j), args, T, psi);
  double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; ++i) res = res + nut_term(tab + 9 * i, args, T, psi);
  return res;
}

__global__ void site_geometry_kernel(const double *__restrict__ ut1_mjd,
                                     const double *__restrict__ tt_jcent,
                                     const double *__restrict__ xp_rad,
                                     const double *__restrict__ yp_rad,
                                     const double *__restrict__ consts, int nterms, double sx,
                                     double sy, double sz, double *__restrict__ pos,
                                     double *__restrict__ vel, long long n) {
  extern __shared__ double sh[];
  const int ntab = NCONST + 9 * nterms;
  for (int k = threadIdx.x; k < ntab; k += blockDim.x) sh[k] = consts[k];
  __syncthreads();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double ARCSEC = sh[0], TWO_PI = sh[1], OMEGA = sh[2];
  const double *tab = sh + NCONST;
  const double T = tt_jcent[i];

  // Fukushima-Williams angles
  const double gamb = poly6(sh + 3, T) * ARCSEC;
  const double phib = poly6(sh + 9, T) * ARCSEC;
  const double psib = poly6(sh + 15, T) * ARCSEC;
  const double epsa = poly6(sh + 21, T) * ARCSEC;

  // Delaunay arguments and the nutation
  const double T2 = T * T, T3 = T * T * T;
  double args[5];
  args[0] = (485868.249036 + 1717915923.2178 * T + 31.8792 * T2 + 0.051635 * T3) * ARCSEC;
  args[1] = (1287104.79305 + 129596581.0481 * T - 0.5532 * T2 + 0.000136 * T3) * ARCSEC;
  args[2] = (335779.526232 + 1739527262.8478 * T - 12.7512 * T2 - 0.001037 * T3) * ARCSEC;
  args[3] = (1072260.70369 + 1602961601.2090 * T - 6.3706 * T2 + 0.006593 * T3) * ARCSEC;
  args[4] = (450160.398036 - 6962890.5431 * T + 7.4722 * T2 + 0.007702 * T3) * ARCSEC;
  const double dpsi = nut_sum(tab, nterms, args, T, true) * 1e-7 * ARCSEC;
  const double deps = nut_sum(tab, nterms, args, T, false) * 1e-7 * ARCSEC;

  // ERA, GMST, GAST
  const double du = ut1_mjd[i] - 51544.5;
  const double f = pymod(du, 1.0);
  const double era = TWO_PI * pymod(0.7790572732640 + f + 0.00273781191135448 * du, 1.0);
  const double theta = (era + poly6(sh + 27, T) * ARCSEC) + dpsi * cos(epsa);

  // NPB: R1(-(eps + deps)) R3(-(psi + dpsi)) R1(phi) R3(gamb)
  const mat3 M = mul(mul(mul(rx(-(epsa + deps)), rz(-(psib + dpsi))), rx(phib)), rz(gamb));

  // polar motion, Earth rotation, then the transpose of M
  const double xp = xp_rad[i], yp = yp_rad[i];
  const double xw = sx - xp * sz;
  const double yw = sy + yp * sz;
  const double zw = sz + xp * sx - yp * sy;
  const double c = cos(theta), s = sin(theta);
  const double r[3] = {c * xw - s * yw, s * xw + c * yw, zw};
  const double v[3] = {OMEGA * (-s * xw - c * yw), OMEGA * (c * xw - s * yw), OMEGA * 0.0};
  for (int k = 0; k < 3; ++k) {
    pos[3 * i + k] = (M.a[0][k] * r[0] + M.a[1][k] * r[1]) + M.a[2][k] * r[2];
    vel[3 * i + k] = (M.a[0][k] * v[0] + M.a[1][k] * v[1]) + M.a[2][k] * v[2];
  }
}

}  // namespace

extern "C" int site_geometry(const double *ut1_mjd, const double *tt_jcent, const double *xp_rad,
                             const double *yp_rad, const double *consts, int nterms, double sx,
                             double sy, double sz, double *pos, double *vel, long long n,
                             void *stream) {
  if (nterms <= 0 || nterms > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  const size_t shmem = sizeof(double) * (NCONST + 9 * nterms);
  site_geometry_kernel<<<(unsigned)blocks, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      ut1_mjd, tt_jcent, xp_rad, yp_rad, consts, nterms, sx, sy, sz, pos, vel, n);
  return static_cast<int>(cudaGetLastError());
}

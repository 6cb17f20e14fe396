// K5 analytic_ephemeris: barycentric ICRS positions and velocities of the
// requested solar-system bodies at N TDB epochs, from the built-in analytic
// ephemeris.
//
// Replaces: the `prepare_ephemeris` device program of
// pint_tpu/astro/device_prepare.py:121-151, which XLA fused from
// pint_tpu/astro/ephemeris.py AnalyticEphemeris._posvel_analytic for every
// requested body: the Fukushima-Williams ecliptic-of-date rotation, the
// truncated VSOP87D series (Earth 195 terms, Venus 52, Jupiter 92, Saturn
// 117, Uranus 168, Neptune 124: sum A cos(B + C tau) times tau^k), Mercury,
// Mars and the EMB from mean elements with a 10-step Kepler solve, the Meeus
// Moon series and the Sun's barycentric constraint, at T - dT, T and T + dT
// (dT = 16 s), velocities by central difference. Plain twin:
// pint_tpu_torch/astro/ephemeris.py analytic_posvel.
//
// Bound: float64 operations. Each epoch evaluates the system three times,
// ~850 cosines and sines each (~2,550 per epoch, ~40 operations each), and
// reads 8 bytes and writes 48 per body: thousands of operations per byte.
// The design: one thread per (epoch, offset), blockIdx.y the offset, so the
// three evaluations of an epoch run in parallel; the term tables (one
// float64 tensor, ephemeris.pack_tables, the twin's own tables) are staged
// in shared memory, and every thread of a warp reads the same term at the
// same time, which the shared memory broadcasts. The centre offset writes
// the positions; the outer two write a scratch buffer that a second small
// kernel differences into the velocities. A requested planet's
// heliocentric position waits in its output slot until the Sun (which needs
// every planet) is known, then gets the Sun added.
//
// Arithmetic follows the twin and pint_tpu's numpy term by term (built with
// --fmad=false): each power's terms summed in numpy's pairwise order
// (erot.npsum: 8 partial sums), the 3x3 products as numpy's matmul (a0 b0
// and two fused multiply-adds), the of-date rotation as numpy's einsum
// ((p0 + p2) + p1), remainders with the divisor's sign.
//
// Body codes (ephemeris.BODIES): 0 sun 1 mercury 2 venus 3 earth 4 moon
// 5 mars 6 jupiter 7 saturn 8 uranus 9 neptune 10 emb.
// layout (ints): [(vsop body * 3 + coord) * 6 + k] * 2 -> (first term,
// count) for VSOP bodies earth, venus, jupiter, saturn, uranus, neptune;
// then the offsets (in doubles) of the Moon's L/R rows (6 each), their count,
// the B rows (5 each), their count, the mean elements (12 per body: mercury,
// emb, mars) and the consts block, and the table's length.
// consts (doubles): ARCSEC, DEG, TWO_PI, AU_M, GM_TOTAL, 1 + EMRAT,
// GM of the 8 element-table bodies in order, ECL2EQU (9), FW_GAMB, FW_PHIB,
// FW_PSIB (6 each).
#include <cuda_runtime.h>

#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

constexpr int NVSOP = 6;
constexpr int LAYOUT_LEN = NVSOP * 3 * 6 * 2 + 7;
constexpr int NBODY = 11;
// element-table order (the Sun constraint sums in it) -> source:
// VSOP body index (>= 0) or mean-element body index (-1 - j)
__constant__ int ELEMENT_SRC[8] = {-1, 1, -2, -3, 2, 3, 4, 5};
// element-table order -> body code (-1: the EMB, which is served from the
// Earth and the Moon, not from its mean elements)
__constant__ int ELEMENT_CODE[8] = {1, 2, -1, 5, 6, 7, 8, 9};

struct ctx {
  const double *tab;
  const int *lay;
  const double *k;  // consts
};

__device__ __forceinline__ double pymod(double x, double m) {
  const double r = fmod(x, m);
  return r < 0.0 ? r + m : r;
}

__device__ __forceinline__ double poly6(const double *c, double T) {
  double out = 0.0;
  for (int k = 5; k >= 0; --k) out = out * T + c[k];
  return out;
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

__device__ __forceinline__ mat3 mul(const mat3 &x, const mat3 &y) {
  mat3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.a[i][j] = __fma_rn(x.a[i][2], y.a[2][j],
                           __fma_rn(x.a[i][1], y.a[1][j], x.a[i][0] * y.a[0][j]));
  return r;
}

// einsum("...ij,...j->...i") order on a contiguous row: (p0 + p2) + p1
__device__ __forceinline__ void apply(const mat3 &M, const double *v, double *out) {
  for (int i = 0; i < 3; ++i)
    out[i] = (M.a[i][0] * v[0] + M.a[i][2] * v[2]) + M.a[i][1] * v[1];
}

__device__ __forceinline__ double term(const double *t, double tau) {
  return t[0] * cos(t[1] + tau * t[2]);
}

// numpy's pairwise sum of n <= 128 terms A cos(B + C tau)
__device__ double series_sum(const double *t, int n, double tau) {
  if (n < 8) {
    double res = 0.0;
    for (int i = 0; i < n; ++i) res = res + term(t + 3 * i, tau);
    return res;
  }
  double r[8];
  for (int j = 0; j < 8; ++j) r[j] = term(t + 3 * j, tau);
  const int m = n - n % 8;
  int i = 8;
  for (; i < m; i += 8)
    for (int j = 0; j < 8; ++j) r[j] = r[j] + term(t + 3 * (i + j), tau);
  double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; ++i) res = res + term(t + 3 * i, tau);
  return res;
}

// sum_k tau^k (series k), times 1e-8 (vsop87._eval)
__device__ double vsop_eval(const ctx &c, int body, int coord, double tau) {
  double out = 0.0;
  for (int k = 0; k < 6; ++k) {
    const int *e = c.lay + ((body * 3 + coord) * 6 + k) * 2;
    if (e[1] == 0) break;
    const double s = series_sum(c.tab + 3 * e[0], e[1], tau);
    double tk;
    switch (k) {
      case 0: tk = 1.0; break;
      case 1: tk = tau; break;
      case 2: tk = tau * tau; break;
      case 3: tk = tau * tau * tau; break;
      default: tk = pow(tau, (double)k);
    }
    out = out + s * tk;
  }
  return out * 1e-8;
}

// heliocentric rectangular [AU], ecliptic of date (vsop87.lbr_date + lbr_to_xyz)
__device__ void vsop_xyz(const ctx &c, int body, double T, double *x) {
  const double tau = T / 10.0;
  const double L = pymod(vsop_eval(c, body, 0, tau), c.k[2]);
  const double B = vsop_eval(c, body, 1, tau);
  const double R = vsop_eval(c, body, 2, tau);
  const double cb = cos(B);
  x[0] = R * cb * cos(L);
  x[1] = R * cb * sin(L);
  x[2] = R * sin(B);
}

// heliocentric ecliptic-J2000 [AU] from mean elements (ephemeris.helio_ecliptic)
__device__ void kepler_xyz(const ctx &c, int j, double T, double *x) {
  const double *el0 = c.tab + c.lay[LAYOUT_LEN - 3] + 12 * j;
  const double *rate = el0 + 6;
  const double DEG = c.k[1];
  const double a = el0[0] + rate[0] * T;
  const double e = el0[1] + rate[1] * T;
  const double inc = (el0[2] + rate[2] * T) * DEG;
  const double L = (el0[3] + rate[3] * T) * DEG;
  const double lperi = (el0[4] + rate[4] * T) * DEG;
  const double lnode = (el0[5] + rate[5] * T) * DEG;
  const double M = pymod(L - lperi, c.k[2]);
  const double w = lperi - lnode;
  double E = M + e * sin(M);
  for (int it = 0; it < 10; ++it) E = E - (E - e * sin(E) - M) / (1.0 - e * cos(E));
  const double px = a * (cos(E) - e);
  const double py = a * sqrt(1 - e * e) * sin(E);
  const double cw = cos(w), sw = sin(w), cO = cos(lnode), sO = sin(lnode);
  const double ci = cos(inc), si = sin(inc);
  x[0] = (cw * cO - sw * sO * ci) * px + (-sw * cO - cw * sO * ci) * py;
  x[1] = (cw * sO + sw * cO * ci) * px + (-sw * sO + cw * cO * ci) * py;
  x[2] = (sw * si) * px + (cw * si) * py;
}

__device__ __forceinline__ double efac(double m, double E) {
  const double am = fabs(m);
  return am == 1.0 ? E : (am == 2.0 ? E * E : 1.0);
}

// geocentric ecliptic-of-date Moon [m] (ephemeris.moon_geocentric_ecliptic_date)
__device__ void moon_xyz(const ctx &c, double T, double *x) {
  const double DEG = c.k[1];
  const double T2 = T * T, T3 = T * T * T;
  const double Lp = (218.3164477 + 481267.88123421 * T - 0.0015786 * T2 + T3 / 538841.0) * DEG;
  const double D = (297.8501921 + 445267.1114034 * T - 0.0018819 * T2 + T3 / 545868.0) * DEG;
  const double M = (357.5291092 + 35999.0502909 * T - 0.0001536 * T2) * DEG;
  const double Mp = (134.9633964 + 477198.8675055 * T + 0.0087414 * T2 + T3 / 69699.0) * DEG;
  const double F = (93.2720950 + 483202.0175233 * T - 0.0036539 * T2 - T3 / 3526000.0) * DEG;
  const double E = 1.0 - 0.002516 * T - 0.0000074 * T2;
  const int *tl = c.lay + LAYOUT_LEN - 7;
  double suml = 0.0, sumr = 0.0, sumb = 0.0;
  for (int r = 0; r < tl[1]; ++r) {
    const double *row = c.tab + tl[0] + 6 * r;
    const double arg = row[0] * D + row[1] * M + row[2] * Mp + row[3] * F;
    const double ef = efac(row[1], E);
    suml = suml + row[4] * ef * sin(arg);
    sumr = sumr + row[5] * ef * cos(arg);
  }
  for (int r = 0; r < tl[3]; ++r) {
    const double *row = c.tab + tl[2] + 5 * r;
    const double arg = row[0] * D + row[1] * M + row[2] * Mp + row[3] * F;
    sumb = sumb + row[4] * efac(row[1], E) * sin(arg);
  }
  const double A1 = (119.75 + 131.849 * T) * DEG;
  const double A2 = (53.09 + 479264.290 * T) * DEG;
  const double A3 = (313.45 + 481266.484 * T) * DEG;
  suml = suml + 3958 * sin(A1) + 1962 * sin(Lp - F) + 318 * sin(A2);
  sumb = sumb - 2235 * sin(Lp) + 382 * sin(A3) + 175 * sin(A1 - F) + 175 * sin(A1 + F) +
         127 * sin(Lp - Mp) - 115 * sin(Lp + Mp);
  const double lam = Lp + suml * 1e-6 * DEG;
  const double beta = sumb * 1e-6 * DEG;
  const double rr = (385000.56 + sumr * 1e-3) * 1e3;
  const double cb = cos(beta);
  x[0] = rr * cb * cos(lam);
  x[1] = rr * cb * sin(lam);
  x[2] = rr * sin(beta);
}

__global__ void analytic_ephemeris_kernel(const double *__restrict__ tdb_jcent,
                                          const double *__restrict__ table,
                                          const int *__restrict__ layout,
                                          const int *__restrict__ codes, int nb, double dT,
                                          double *__restrict__ pos, double *__restrict__ scratch,
                                          long long n) {
  extern __shared__ double sh[];
  const int ntab = layout[LAYOUT_LEN - 1];
  int *shl = reinterpret_cast<int *>(sh + ntab);
  for (int k = threadIdx.x; k < ntab; k += blockDim.x) sh[k] = table[k];
  for (int k = threadIdx.x; k < LAYOUT_LEN; k += blockDim.x) shl[k] = layout[k];
  __syncthreads();
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const ctx c{sh, shl, sh + shl[LAYOUT_LEN - 2]};
  const int off = blockIdx.y;  // 0: T - dT, 1: T, 2: T + dT
  const double T = off == 0 ? tdb_jcent[i] - dT : (off == 2 ? tdb_jcent[i] + dT : tdb_jcent[i]);
  double *out = off == 1 ? pos : scratch + (off / 2) * (long long)nb * n * 3;
  int slot[NBODY];
  for (int b = 0; b < NBODY; ++b) slot[b] = -1;
  for (int s = 0; s < nb; ++s) slot[codes[s]] = s;
#define OUT(s) (out + ((long long)(s) * n + i) * 3)

  const double ARCSEC = c.k[0], AU_M = c.k[3];
  const mat3 Mfw = mul(mul(rz(-(poly6(c.k + 23, T) * ARCSEC)), rx(-(poly6(c.k + 29, T) * ARCSEC))),
                       rz(poly6(c.k + 35, T) * ARCSEC));

  // the planets and the EMB, heliocentric ICRS [m], summed into the Sun
  double acc[3] = {0.0, 0.0, 0.0};
  for (int b = 0; b < 8; ++b) {
    double x[3], h[3];
    const int src = ELEMENT_SRC[b];
    if (src >= 0) {
      vsop_xyz(c, src, T, x);
      for (int k = 0; k < 3; ++k) x[k] = x[k] * AU_M;
      apply(Mfw, x, h);
    } else {
      kepler_xyz(c, -1 - src, T, x);
      for (int k = 0; k < 3; ++k) x[k] = x[k] * AU_M;
      const double *E = c.k + 14;  // ECL2EQU, row-major
      for (int k = 0; k < 3; ++k)
        h[k] = __fma_rn(x[2], E[3 * k + 2], __fma_rn(x[1], E[3 * k + 1], x[0] * E[3 * k]));
    }
    const double gm = c.k[6 + b];
    for (int k = 0; k < 3; ++k) acc[k] = acc[k] + gm * h[k];
    const int s = ELEMENT_CODE[b] >= 0 ? slot[ELEMENT_CODE[b]] : -1;
    if (s >= 0)
      for (int k = 0; k < 3; ++k) OUT(s)[k] = h[k];
  }
  double sun[3];
  for (int k = 0; k < 3; ++k) sun[k] = -acc[k] / c.k[4];
  for (int b = 0; b < 8; ++b) {
    const int s = ELEMENT_CODE[b] >= 0 ? slot[ELEMENT_CODE[b]] : -1;
    if (s >= 0)
      for (int k = 0; k < 3; ++k) OUT(s)[k] = sun[k] + OUT(s)[k];
  }
  if (slot[0] >= 0)
    for (int k = 0; k < 3; ++k) OUT(slot[0])[k] = sun[k];

  // Earth, Moon, EMB
  if (slot[3] >= 0 || slot[4] >= 0 || slot[10] >= 0) {
    double x[3], g[3], earth[3];
    vsop_xyz(c, 0, T, x);
    for (int k = 0; k < 3; ++k) x[k] = x[k] * AU_M;
    apply(Mfw, x, g);
    for (int k = 0; k < 3; ++k) earth[k] = sun[k] + g[k];
    if (slot[3] >= 0)
      for (int k = 0; k < 3; ++k) OUT(slot[3])[k] = earth[k];
    if (slot[4] >= 0 || slot[10] >= 0) {
      double m[3], mg[3];
      moon_xyz(c, T, m);
      apply(Mfw, m, mg);
      if (slot[4] >= 0)
        for (int k = 0; k < 3; ++k) OUT(slot[4])[k] = earth[k] + mg[k];
      if (slot[10] >= 0)
        for (int k = 0; k < 3; ++k) OUT(slot[10])[k] = earth[k] + mg[k] / c.k[5];
    }
  }
#undef OUT
}

// vel = (p(T + dT) - p(T - dT)) / (2 dt_s)
__global__ void central_difference_kernel(const double *__restrict__ scratch, double two_dt,
                                          double *__restrict__ vel, long long m) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < m;
       j += (long long)gridDim.x * blockDim.x)
    vel[j] = (scratch[m + j] - scratch[j]) / two_dt;
}

}  // namespace

extern "C" int analytic_ephemeris(const double *tdb_jcent, const double *table,
                                  const int *layout, int table_len, const int *codes, int nb,
                                  double dT, double two_dt, double *pos, double *vel,
                                  double *scratch, long long n, void *stream) {
  if (nb <= 0 || nb > NBODY) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t shmem = sizeof(double) * table_len + sizeof(int) * LAYOUT_LEN;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        analytic_ephemeris_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = 128;
  const dim3 grid((unsigned)((n + threads - 1) / threads), 3);
  analytic_ephemeris_kernel<<<grid, threads, shmem, st>>>(tdb_jcent, table, layout, codes, nb, dT,
                                                          pos, scratch, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long m = (long long)nb * n * 3;
  long long blocks = (m + 255) / 256;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  central_difference_kernel<<<(unsigned)blocks, 256, 0, st>>>(scratch, two_dt, vel, m);
  return static_cast<int>(cudaGetLastError());
}

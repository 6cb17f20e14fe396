// K1 resid_tangent: the per-TOA timing forward pass with forward-mode tangents.
//
// Replaces: the `resid` program (pint_tpu/residuals.py get_resid_fn:
// TimingModel.phase_and_freq + phase_residual_frac), and the design matrix
// of the nonlinear parameters that pint_tpu forms with jax.linearize + vmap
// (fitting/wls.py get_step_fn.design, gridutils.py _point_kernel.gn_step).
//
// One thread per TOA row and parameter set (grid: rows x batch). Per row, in
// the order of the Python twin (models/*.py, a term at a time):
//   pulsar direction n with proper motion  (astrometry.py)
//   Roemer -r.n and parallax                (astrometry.py)
//   solar Shapiro -2 T ln((|s| - s.n)/AU)   (solar_system_shapiro.py)
//   DM delay DMconst DM(t) / f_bary^2, f_bary = f (1 - v.n)  (dispersion.py)
//   spindown phase: dd Horner of F_k over t - delay - PEPOCH (spindown.py)
//   spin frequency f(t)                     (spindown.py)
//   minus the TZR row's phase, then dd rint (timing_model.py, residuals.py)
// and writes the pulse number, the fractional phase (hi + lo) and f.
//
// Tangents: beside every value the thread carries K dual lanes, one per
// nonlinear free parameter (lane codes: 0 RAJ 1 DECJ 2 PMRA 3 PMDEC 4 PX,
// 16 + k for F_k). A double-double value carries one float64 tangent: the
// derivative needs float64 precision only, as jax's tangents through the
// float64 carriers do. Outputs d(frac)/dp and d(f)/dp per lane; the caller
// forms d(r/f) (fitting/wls.py, gridutils.py).
//
// TZR row: every block's thread 0 evaluates the fiducial row (the tensor's
// last) into shared memory before the block's rows subtract it, so one launch
// does the whole pass and nothing crosses blocks.
//
// Bound: double-precision operations. Per row the dd Horner, the transcen-
// dentals (cos, sin, log) and the K lanes cost several hundred float64
// operations against 96 bytes of row input and (3 + 2K) doubles of output:
// far above the ~10 flop/byte ridge of an H100 in float64.
#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

using namespace pint;

constexpr int KMAX = 8;
constexpr int THREADS = 256;

// parameter row layout, shared with pint_tpu_torch/residuals.py _pack_params
enum : int {
  P_RAJ = 0, P_DECJ, P_PMRA, P_PMDEC, P_PX, P_POSEPOCH, P_DMEPOCH,
  P_PEPOCH_HI, P_PEPOCH_LO, P_DM0  // then nd DM coefficients, then nf (hi, lo) F pairs
};
enum : int { L_RAJ = 0, L_DECJ = 1, L_PMRA = 2, L_PMDEC = 3, L_PX = 4, L_F0 = 16 };

struct Config {
  int n_rows;   // tensor rows, the TZR row included
  int n_out;    // data rows written
  int has_tzr;  // AbsPhase: subtract the last row's phase
  int has_ast;  // astrometry (and with it the solar Shapiro delay)
  int nd;       // DM Taylor terms (0: no dispersion component)
  int nf;       // spin terms F0..F(nf-1)
  int n_par;    // parameter row length
  int lane[KMAX];
  double au_ls, dmconst, tsun;
};

struct Rows {
  const double *t_hi, *t_lo, *freq, *pos, *vel, *sun;
};

template <int K>
struct Dual {
  double v;
  double d[K > 0 ? K : 1];
};

template <int K>
__device__ __forceinline__ Dual<K> dconst(double v) {
  Dual<K> r;
  r.v = v;
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = 0.0;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dseed(double v, const Config &c, int code) {
  Dual<K> r;
  r.v = v;
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = (c.lane[j] == code) ? 1.0 : 0.0;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dadd(const Dual<K> &a, const Dual<K> &b) {
  Dual<K> r;
  r.v = __dadd_rn(a.v, b.v);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] + b.d[j];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dsub(const Dual<K> &a, const Dual<K> &b) {
  Dual<K> r;
  r.v = __dsub_rn(a.v, b.v);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] - b.d[j];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dmul(const Dual<K> &a, const Dual<K> &b) {
  Dual<K> r;
  r.v = __dmul_rn(a.v, b.v);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] * b.v + a.v * b.d[j];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dmulc(const Dual<K> &a, double s) {
  Dual<K> r;
  r.v = __dmul_rn(a.v, s);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] * s;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> ddiv(const Dual<K> &a, const Dual<K> &b) {
  Dual<K> r;
  r.v = __ddiv_rn(a.v, b.v);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = (a.d[j] - r.v * b.d[j]) / b.v;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> ddivc(const Dual<K> &a, double s) {
  Dual<K> r;
  r.v = __ddiv_rn(a.v, s);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] / s;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dneg(const Dual<K> &a) {
  Dual<K> r;
  r.v = -a.v;
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = -a.d[j];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dcos(const Dual<K> &a) {
  Dual<K> r;
  r.v = cos(a.v);
  const double s = -sin(a.v);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = s * a.d[j];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dsin(const Dual<K> &a) {
  Dual<K> r;
  r.v = sin(a.v);
  const double cs = cos(a.v);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = cs * a.d[j];
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dlog(const Dual<K> &a) {
  Dual<K> r;
  r.v = log(a.v);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] / a.v;
  return r;
}

// ((x0 y0 + x1 y1) + x2 y2) with constant x: the twin's dot3 order
template <int K>
__device__ __forceinline__ Dual<K> ddot3(const double *x, const Dual<K> *y) {
  return dadd(dadd(dmulc(y[0], x[0]), dmulc(y[1], x[1])), dmulc(y[2], x[2]));
}

__device__ __forceinline__ double dot3c(const double *x, const double *y) {
  return __dadd_rn(__dadd_rn(__dmul_rn(x[0], y[0]), __dmul_rn(x[1], y[1])),
                   __dmul_rn(x[2], y[2]));
}

// A double-double value with one float64 tangent per lane.
template <int K>
struct DDual {
  dd x;
  double d[K > 0 ? K : 1];
};

template <int K>
__device__ __forceinline__ DDual<K> ddadd(const DDual<K> &a, const DDual<K> &b) {
  DDual<K> r;
  r.x = dd_add(a.x, b.x);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] + b.d[j];
  return r;
}

template <int K>
__device__ __forceinline__ DDual<K> ddmul(const DDual<K> &a, const DDual<K> &b) {
  DDual<K> r;
  r.x = dd_mul(a.x, b.x);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] * b.x.hi + a.x.hi * b.d[j];
  return r;
}

template <int K>
__device__ __forceinline__ DDual<K> ddmulc(const DDual<K> &a, double s) {
  DDual<K> r;
  r.x = dd_mul_fp(a.x, s);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] * s;
  return r;
}

// one row's TZR-relative quantities before the subtraction
template <int K>
struct RowPhase {
  DDual<K> ph;
  Dual<K> f;
};

__device__ __forceinline__ double inv_fact(int n) {
  double f = 1.0;
  for (int i = 1; i <= n; ++i) f = __dmul_rn(f, (double)i);
  return __ddiv_rn(1.0, f);
}

__device__ __forceinline__ double fact(int n) {
  double f = 1.0;
  for (int i = 1; i <= n; ++i) f = __dmul_rn(f, (double)i);
  return f;
}

template <int K>
__device__ RowPhase<K> eval_row(int i, const Rows &rows, const double *__restrict__ P,
                                const Config &c) {
  const double t_hi = rows.t_hi[i], t_lo = rows.t_lo[i];
  Dual<K> total = dconst<K>(0.0);
  Dual<K> n[3];
  if (c.has_ast) {
    // pulsar direction with proper motion (astrometry.py pulsar_direction)
    const double dt = __dadd_rn(__dsub_rn(t_hi, P[P_POSEPOCH]), t_lo);
    const Dual<K> dec0 = dseed<K>(P[P_DECJ], c, L_DECJ);
    const Dual<K> ra = dadd(dseed<K>(P[P_RAJ], c, L_RAJ),
                            ddiv(dmulc(dseed<K>(P[P_PMRA], c, L_PMRA), dt), dcos(dec0)));
    const Dual<K> dec = dadd(dec0, dmulc(dseed<K>(P[P_PMDEC], c, L_PMDEC), dt));
    const Dual<K> cl = dcos(dec);
    n[0] = dmul(cl, dcos(ra));
    n[1] = dmul(cl, dsin(ra));
    n[2] = dsin(dec);
    // Roemer + parallax (AstrometryBase.delay)
    const double *r = rows.pos + 3 * i;
    const Dual<K> rn = ddot3(r, n);
    const double r2 = dot3c(r, r);
    const Dual<K> px = dseed<K>(P[P_PX], c, L_PX);
    const Dual<K> px_delay =
        ddivc(dmul(dmulc(px, 0.5), dsub(dconst<K>(r2), dmul(rn, rn))), c.au_ls);
    total = dadd(total, dadd(dneg(rn), px_delay));
    // solar Shapiro delay
    const double *s = rows.sun + 3 * i;
    const double rs = __dsqrt_rn(dot3c(s, s));
    const Dual<K> rcos = ddot3(s, n);
    const Dual<K> shap =
        dmulc(dlog(ddivc(dsub(dconst<K>(rs), rcos), c.au_ls)), -2.0 * c.tsun);
    total = dadd(total, shap);
  }
  if (c.nd > 0) {
    // DM(t): plain Taylor polynomial about DMEPOCH (dispersion.py base_dm)
    double dm;
    if (c.nd == 1) {
      dm = __dmul_rn(P[P_DM0], 1.0);
    } else {
      const double dtd = __dadd_rn(__dsub_rn(t_hi, P[P_DMEPOCH]), t_lo);
      dm = __ddiv_rn(P[P_DM0 + c.nd - 1], fact(c.nd - 1));
      for (int k = c.nd - 2; k >= 0; --k)
        dm = __dadd_rn(__dmul_rn(dm, dtd), __ddiv_rn(P[P_DM0 + k], fact(k)));
    }
    Dual<K> fb = dconst<K>(rows.freq[i]);
    if (c.has_ast) {
      const Dual<K> beta = ddot3(rows.vel + 3 * i, n);
      fb = dmulc(dsub(dconst<K>(1.0), beta), rows.freq[i]);
    }
    Dual<K> dmd = dconst<K>(0.0);
    if (isfinite(fb.v)) dmd = ddiv(dconst<K>(__dmul_rn(c.dmconst, dm)), dmul(fb, fb));
    total = dadd(total, dmd);
  }
  // spindown (spindown.py): dt = (t - delay) - PEPOCH in dd
  const int f_base = P_DM0 + c.nd;
  DDual<K> dt;
  dt.x = dd_sub(dd_add_fp(dd{t_hi, t_lo}, -total.v), dd{P[P_PEPOCH_HI], P[P_PEPOCH_LO]});
#pragma unroll
  for (int j = 0; j < K; ++j) dt.d[j] = -total.d[j];
  // phase: dd Horner over [0, F0, ..., F(nf-1)] (ops/taylor.py taylor_horner_x)
  auto coeff = [&](int k) {  // F_k as a DD with its lane seed
    DDual<K> r;
    r.x = dd{P[f_base + 2 * k], P[f_base + 2 * k + 1]};
#pragma unroll
    for (int j = 0; j < K; ++j) r.d[j] = (c.lane[j] == L_F0 + k) ? 1.0 : 0.0;
    return r;
  };
  DDual<K> acc = ddmulc(coeff(c.nf - 1), inv_fact(c.nf));
  for (int k = c.nf - 1; k >= 0; --k) {
    acc = ddmul(acc, dt);
    DDual<K> term;
    if (k == 0) {
      term.x = dd_mul_fp(dd{0.0, 0.0}, inv_fact(0));
#pragma unroll
      for (int j = 0; j < K; ++j) term.d[j] = 0.0;
    } else {
      term = ddmulc(coeff(k - 1), inv_fact(k));
    }
    acc = ddadd(acc, term);
  }
  RowPhase<K> out;
  DDual<K> zero;
  zero.x = dd{0.0, 0.0};
#pragma unroll
  for (int j = 0; j < K; ++j) zero.d[j] = 0.0;
  out.ph = ddadd(zero, acc);                  // phase components: Spindown ...
  if (c.has_tzr) out.ph = ddadd(out.ph, zero);  // ... then AbsPhase (zero)
  // spin frequency: float64 Horner of [F0, F1, ...] at dt (taylor_horner_deriv)
  Dual<K> dtf;
  dtf.v = dd_to_float(dt.x);
#pragma unroll
  for (int j = 0; j < K; ++j) dtf.d[j] = dt.d[j];
  auto fcoeff = [&](int k) {
    return dseed<K>(__dadd_rn(P[f_base + 2 * k], P[f_base + 2 * k + 1]), c, L_F0 + k);
  };
  Dual<K> fq = ddivc(fcoeff(c.nf - 1), fact(c.nf - 1));
  for (int k = c.nf - 2; k >= 0; --k) fq = dadd(dmul(fq, dtf), ddivc(fcoeff(k), fact(k)));
  out.f = fq;
  return out;
}

template <int K>
__global__ void __launch_bounds__(THREADS)
resid_tangent_kernel(Rows rows, const double *__restrict__ params, Config c,
                     double *__restrict__ pn, double *__restrict__ frac,
                     double *__restrict__ freq_out, double *__restrict__ dfrac,
                     double *__restrict__ dfreq) {
  const int b = blockIdx.y;
  const double *P = params + (size_t)b * c.n_par;
  __shared__ double tz_hi, tz_lo;
  __shared__ double tz_d[K > 0 ? K : 1];
  if (c.has_tzr && threadIdx.x == 0) {
    const RowPhase<K> tz = eval_row<K>(c.n_rows - 1, rows, P, c);
    tz_hi = tz.ph.x.hi;
    tz_lo = tz.ph.x.lo;
#pragma unroll
    for (int j = 0; j < K; ++j) tz_d[j] = tz.ph.d[j];
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  RowPhase<K> r;
  if (i < c.n_out) r = eval_row<K>(i, rows, P, c);
  __syncthreads();
  if (i >= c.n_out) return;
  DDual<K> ph = r.ph;
  if (c.has_tzr) {
    ph.x = dd_add(ph.x, dd_neg(dd{tz_hi, tz_lo}));
#pragma unroll
    for (int j = 0; j < K; ++j) ph.d[j] = ph.d[j] - tz_d[j];
  }
  double k;
  const dd rem = dd_rint(ph.x, k);
  const size_t o = (size_t)b * c.n_out + i;
  pn[o] = k;
  frac[o] = dd_to_float(rem);
  freq_out[o] = r.f.v;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const size_t oj = ((size_t)b * K + j) * c.n_out + i;
    dfrac[oj] = ph.d[j];
    dfreq[oj] = r.f.d[j];
  }
}

template <int K>
cudaError_t launch(const Rows &rows, const double *params, const Config &c, int n_batch,
                   double *pn, double *frac, double *f, double *dfrac, double *df,
                   cudaStream_t stream) {
  const dim3 grid((c.n_out + THREADS - 1) / THREADS, n_batch);
  resid_tangent_kernel<K><<<grid, THREADS, 0, stream>>>(rows, params, c, pn, frac, f,
                                                        dfrac, df);
  return cudaGetLastError();
}

}  // namespace

// ints: n_rows n_out has_tzr has_ast nd nf n_par k lane[0..k)
// consts: au_ls dmconst tsun
extern "C" int resid_tangent(const double *t_hi, const double *t_lo, const double *freq,
                             const double *pos, const double *vel, const double *sun,
                             const double *params, int n_batch, const int *ints,
                             const double *consts, double *pn, double *frac, double *f,
                             double *dfrac, double *df, void *stream) {
  Config c;
  c.n_rows = ints[0];
  c.n_out = ints[1];
  c.has_tzr = ints[2];
  c.has_ast = ints[3];
  c.nd = ints[4];
  c.nf = ints[5];
  c.n_par = ints[6];
  const int k = ints[7];
  if (k < 0 || k > KMAX || c.nf < 1 || c.n_out < 0 || n_batch < 1 || n_batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < KMAX; ++j) c.lane[j] = j < k ? ints[8 + j] : -1;
  c.au_ls = consts[0];
  c.dmconst = consts[1];
  c.tsun = consts[2];
  if (c.n_out == 0) return 0;
  const Rows rows{t_hi, t_lo, freq, pos, vel, sun};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (k) {
    case 0: e = launch<0>(rows, params, c, n_batch, pn, frac, f, dfrac, df, s); break;
    case 1: case 2: e = launch<2>(rows, params, c, n_batch, pn, frac, f, dfrac, df, s); break;
    case 3: case 4: e = launch<4>(rows, params, c, n_batch, pn, frac, f, dfrac, df, s); break;
    default: e = launch<8>(rows, params, c, n_batch, pn, frac, f, dfrac, df, s); break;
  }
  return static_cast<int>(e);
}

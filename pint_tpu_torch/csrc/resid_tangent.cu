// K1 resid_tangent: the per-TOA timing forward pass with forward-mode tangents.
//
// Replaces: the `resid` program (pint_tpu/residuals.py get_resid_fn:
// TimingModel.phase_and_freq + phase_residual_frac), and the design matrix
// of the nonlinear parameters that pint_tpu forms with jax.linearize + vmap
// (fitting/wls.py get_step_fn.design, gridutils.py _point_kernel.gn_step).
//
// One thread per TOA row and parameter set (grid: rows x batch). Per row, in
// the order of the Python twin (models/*.py, a term at a time):
//   pulsar direction n with proper motion  (astrometry.py; an ecliptic
//     direction is rotated to ICRS by the obliquity)
//   Roemer -r.n and parallax                (astrometry.py)
//   solar Shapiro -2 T ln((|s| - s.n)/AU)   (solar_system_shapiro.py)
//   DM delay DMconst DM(t) / f_bary^2, f_bary = f (1 - v.n)  (dispersion.py)
//   DMX delay DMconst DMX(row) / f_bary^2    (dispersion.py DispersionDMX)
//   FD delay, Horner over log(f_bary / 1 GHz) (frequency_dependent.py)
//   binary delay at t - delay so far        (binary.py, binaries/engines.py):
//     the orbit (one function for every binary): dd orbital phase
//     norb0 = rint(dt/PB), rem = dt - PB norb0 in dd, the PBDOT term; or,
//     in the FB form, the dd product dt FB0, rint, and the float64 Taylor
//     tail in FB1 .. FB7 (pb = 1 / (FB0 + FB1 dt + ...)); then
//     phi = 2 pi (frac - rint(frac)), from the epoch TASC or T0; then
//     the ELL1 family: ELL1's third-order Roemer expansion and its two phi
//     derivatives (sin/cos of phi .. 4 phi), or ELL1K's first-order one
//     with its rotating, growing eccentricity vector; the inverse-timing
//     expansion; and -2 TSUN M2 log(1 - SINI sin phi), or ELL1H's
//     orthometric Shapiro delay (the harmonic series over k = 3..NHARMS,
//     sin and cos of each k phi, stigma 0 or H4/H3; or the exact log form
//     in STIGMA); or
//     a Kepler orbit (binaries/kepler.py, engines.py bt_delay, _dd_core):
//     E from Danby's start and 10 Newton steps on the primal doubles, one
//     dual value from the implicit rule dE = (dM + sin E de)/(1 - e cos E);
//     BT's closed form, or DD's true anomaly (atan2 on the centred branch),
//     omega = OM + k nu, the inverse timing with its e sin E term, the
//     Shapiro log and the aberration terms (DDS: DD with the host's
//     SINI = 1 - exp(-SHAPMAX); DDGR: DD with the host's GR-derived OMDOT,
//     GAMMA, PBDOT, SINI, DR, DTH, each seeded by its row of their Jacobian
//     in MTOT, M2, ECC, A1, PB, XOMDOT; DDK: DD with A1, OM and SINI moved
//     per row by the Kopeikin terms of KIN, KOM, the proper motion and the
//     parallax in the (east, north) basis at the pulsar)
//   spindown phase: dd Horner of F_k over t - delay - PEPOCH (spindown.py)
//   spin frequency f(t)                     (spindown.py)
//   phase JUMPs F0 * sum(mask * JUMP)       (phase_misc.py PhaseJump)
//   minus the TZR row's phase, plus the row's pulse offset (-padd, -phase
//     flags), then dd rint, or under TRACK -2 minus the row's -pn pulse
//     number (timing_model.py, residuals.py phase_residual_frac)
// and writes the pulse number, the fractional phase (hi + lo), f, and the
// barycentric frequency f_bary of every row, the TZR row included (kernel
// K8 reads it).
//
// The ecliptic frame, DMX, FD and the phase JUMPs are NANOGrav's terms: a
// template flag (NG) compiles them only into the instances that need them,
// so the other instances keep their registers. The DMX DM of each row and
// its jump seconds arrive as per-set row columns (the one-hot product and
// the mask sums, formed by the wrapper as the twin forms them); a DMX lane
// is seeded with the row's one-hot entry, a JUMP lane with its mask.
//
// Tangents: beside every value the thread carries K dual lanes, one per
// free parameter (lane codes: the L_* enum below, the table LANE_CODES of
// residuals.py: 0-4 astrometry, 5-9 PB A1 TASC EPS1 EPS2, 16 + k for F_k,
// 32 + k for DM_k, 48-62 the Kepler-orbit and shared binary lanes, 64 + k
// for FD_k, 80 + m for the m-th JUMP, 128 + j for the DMX of window j,
// 256 + k for FB_k, 264-272 H3 H4 STIGMA LNEDOT KIN KOM MTOT XOMDOT XPBDOT). A double-double
// value carries one float64 tangent: the derivative needs float64 precision
// only, as jax's tangents through the float64 carriers do. Outputs d(frac)/dp
// and d(f)/dp per lane; the caller forms d(r/f) (fitting/wls.py, gls.py,
// gridutils.py). A block carries at most KCHUNK = 8 lanes (registers: every
// dual value holds K + 1 doubles); more lanes are more blocks of the same
// launch (blockIdx.z picks the chunk), each recomputing the primal, and
// chunk 0 alone writes the primal outputs. The binary kind is a template
// parameter (BIN: 0 none, 1 ELL1, 2 Kepler): a model runs an instance that
// carries only its own binary's code and registers. The models of a kind
// are a run-time switch (Config::bin_model: ELL1, ELL1H, ELL1K; BT, DD and
// DDS, DDGR, DDK), as are ELL1H's mode and harmonics and the FB form, so
// the 24 instances stay 24.
//
// TZR row: every block's thread 0 evaluates the fiducial row (the tensor's
// last) into shared memory before the block's rows subtract it, so one launch
// does the whole pass and nothing crosses blocks.
//
// Bound: double-precision operations. Per row the dd Horner, the transcen-
// dentals (cos, sin, log; the Kepler term ~40 more) and the K lanes cost several hundred float64
// operations against 96 bytes of row input and (3 + 2K) doubles of output:
// far above the ~10 flop/byte ridge of an H100 in float64.
#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

using namespace pint;

constexpr int KCHUNK = 8;  // lanes per block
constexpr int LMAX = 128;  // lanes per launch
constexpr int THREADS = 256;
constexpr double TWO_PI = 6.283185307179586;  // 2.0 * math.pi
constexpr int NEWTON_ITERS = 10;               // binaries/kepler.py
constexpr int BIN_NONE = 0, BIN_ELL1 = 1, BIN_KEPLER = 2;
// Config::bin_model of the Kepler kind (DDS runs as DD) and of the ELL1 kind
constexpr int KEPLER_BT = 0, KEPLER_DDGR = 2, KEPLER_DDK = 3;  // 1 is DD (and DDS)
constexpr int ELL1_H = 1, ELL1_K = 2;                            // 0 is ELL1
constexpr int H_H3 = 0, H_H4 = 1, H_STIGMA = 2;  // Config::h_mode (ELL1H)
constexpr int MAX_FB = 8;                        // FB0 .. FB7
constexpr int MAX_NHARMS = 20;
// the light-seconds per AU of pint_tpu's DDK parallax term (its literal)
constexpr double DDK_AU_LS = 499.00478384;

// parameter row layout, shared with pint_tpu_torch/residuals.py _pack_params
enum : int {
  P_RAJ = 0, P_DECJ, P_PMRA, P_PMDEC, P_PX, P_POSEPOCH, P_DMEPOCH,
  P_PEPOCH_HI, P_PEPOCH_LO,
  // the binary block (zeros without a binary); the epoch is TASC or T0
  P_PB_HI, P_PB_LO, P_EPOCH_HI, P_EPOCH_LO, P_A1, P_A1DOT, P_EPS1, P_EPS2,
  P_EPS1DOT, P_EPS2DOT, P_PBDOT, P_XPBDOT, P_M2, P_SINI,
  // the Kepler block; DSINI is d SINI / d SHAPMAX (DDS), the SHAPMAX seed
  P_ECC, P_EDOT, P_OM, P_OMDOT, P_GAMMA, P_DR, P_DTH, P_A0, P_B0, P_DSINI,
  // the FB form (FB0 a dd pair), ELL1H, ELL1K and DDK's parameters, and
  // DDGR's Jacobian: 6 rows (OMDOT GAMMA PBDOT SINI DR DTH) of 6 columns
  // (d/d MTOT M2 ECC A1 PB XOMDOT)
  P_FB0_HI, P_FB0_LO, P_FB1, P_H3 = P_FB1 + MAX_FB - 1, P_H4, P_STIGMA, P_LNEDOT, P_KIN,
  P_KOM, P_JAC,
  P_DM0 = P_JAC + 36  // then nd DM coefficients, nf (hi, lo) F pairs, n_fd FD coefficients
};
// DDGR's Jacobian rows (the derived values' order in P_JAC)
constexpr int J_OMDOT = 0, J_GAMMA = 1, J_PBDOT = 2, J_SINI = 3, J_DR = 4, J_DTH = 5;
// lane codes: residuals.py LANE_CODES holds the same list
enum : int {
  L_RAJ = 0, L_DECJ = 1, L_PMRA = 2, L_PMDEC = 3, L_PX = 4,
  L_PB = 5, L_A1 = 6, L_TASC = 7, L_EPS1 = 8, L_EPS2 = 9, L_F0 = 16, L_DM0 = 32,
  L_T0 = 48, L_ECC, L_OM, L_OMDOT, L_EDOT, L_GAMMA, L_PBDOT, L_A1DOT, L_M2, L_SINI,
  L_SHAPMAX, L_DR, L_DTH, L_A0, L_B0,
  L_FD0 = 64, L_JUMP0 = 80, L_DMX0 = 128,
  L_FB0 = 256, L_H3 = L_FB0 + MAX_FB, L_H4, L_STIGMA, L_LNEDOT, L_KIN, L_KOM, L_MTOT, L_XOMDOT,
  L_XPBDOT
};
constexpr int MAX_FD = 15;

struct Config {
  int n_rows;   // tensor rows, the TZR row included
  int n_out;    // data rows written
  int has_tzr;  // AbsPhase: subtract the last row's phase
  int has_ast;  // astrometry (and with it the solar Shapiro delay)
  int nd;       // DM Taylor terms (0: no dispersion component)
  int nf;       // spin terms F0..F(nf-1)
  int n_par;    // parameter row length
  int n_lane;   // lanes of this launch
  int bin_model;  // the kind's model: KEPLER_* or ELL1_*
  int ecliptic;   // the astrometry angles are ecliptic (NG instances)
  int n_dmx, n_fd, n_jump;  // DMX windows, FD terms, JUMPs (NG instances)
  int n_fb;       // FB terms (0: the PB form)
  int h_mode, nharms;  // ELL1H: H_* and the harmonics of its Shapiro series
  int has_dpn;    // add the rows' pulse offsets (-padd, -phase) before the rint
  int has_track;  // TRACK -2: subtract the rows' pulse numbers, no rint
  int lane[LMAX];
  double au_ls, dmconst, tsun, cos_obl, sin_obl;
};

// the tensor's rows; dmx and jump are one parameter set's row columns
struct Rows {
  const double *t_hi, *t_lo, *freq, *pos, *vel, *sun;
  const double *dmx, *jump, *onehot, *masks;
  const double *dpn, *track;  // data rows' pulse offsets and tracked pulse numbers
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

// the lane codes of one block's chunk, in registers
template <int K>
struct Lanes {
  int code[K > 0 ? K : 1];
};

// `v` seeded with 1 on the lane of this block's chunk that carries `code`
template <int K>
__device__ __forceinline__ Dual<K> dseed(double v, const Lanes<K> &lane, int code) {
  Dual<K> r;
  r.v = v;
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = (lane.code[j] == code) ? 1.0 : 0.0;
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
__device__ __forceinline__ Dual<K> dsqrt(const Dual<K> &a) {
  Dual<K> r;
  r.v = __dsqrt_rn(a.v);
  const double two_r = __dmul_rn(2.0, r.v);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] / two_r;
  return r;
}

// atan2(y, x), tangent y' x / (y^2 + x^2) - x' y / (y^2 + x^2)
template <int K>
__device__ __forceinline__ Dual<K> datan2(const Dual<K> &y, const Dual<K> &x) {
  Dual<K> r;
  r.v = atan2(y.v, x.v);
  const double den = __dadd_rn(__dmul_rn(y.v, y.v), __dmul_rn(x.v, x.v));
  const double gy = __ddiv_rn(x.v, den), gx = __ddiv_rn(-y.v, den);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = y.d[j] * gy + x.d[j] * gx;
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

__device__ __forceinline__ double dot3c(const double *x, double y0, double y1, double y2) {
  return __dadd_rn(__dadd_rn(__dmul_rn(x[0], y0), __dmul_rn(x[1], y1)), __dmul_rn(x[2], y2));
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

// a dd product whose tangent is the product rule on the collapsed values
// (hi + lo), the FB form's lead dt FB0 (binary.py _DDMulTangent): FB0's low
// word is ~6e-13 of its high one, past the precision of the lanes
template <int K>
__device__ __forceinline__ DDual<K> ddmul_full(const DDual<K> &a, const DDual<K> &b) {
  DDual<K> r;
  r.x = dd_mul(a.x, b.x);
  const double av = __dadd_rn(a.x.hi, a.x.lo), bv = __dadd_rn(b.x.hi, b.x.lo);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] * bv + av * b.d[j];
  return r;
}

// one row's TZR-relative quantities before the subtraction
template <int K>
struct RowPhase {
  DDual<K> ph;
  Dual<K> f;
};

// a row column whose tangent on lane code `base + m` is tab(m)
template <int K, typename Tab>
__device__ __forceinline__ Dual<K> dcolumn(double v, const Lanes<K> &lane, int base, int count,
                                           Tab tab) {
  Dual<K> r;
  r.v = v;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int m = lane.code[j] - base;
    r.d[j] = (m >= 0 && m < count) ? tab(m) : 0.0;
  }
  return r;
}

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

// ELL1 Roemer delay / a1 to third order in eccentricity and its first two
// phi derivatives (binaries/engines.py _ell1_dre_da1, _ell1_dre_dphi_da1,
// _ell1_dre_dphi2_da1), term by term in the twin's order
template <int K>
struct Ell1Harmonics {
  Dual<K> s1, c1, s2, c2, s3, c3, s4, c4;
};

// a * x * y * ... for a constant a, left to right as Python evaluates it
template <int K>
__device__ __forceinline__ Dual<K> t2(double a, const Dual<K> &x, const Dual<K> &y) {
  return dmul(dmulc(x, a), y);
}
template <int K>
__device__ __forceinline__ Dual<K> t3(double a, const Dual<K> &x, const Dual<K> &y,
                                      const Dual<K> &z) {
  return dmul(dmul(dmulc(x, a), y), z);
}

template <int K>
__device__ Dual<K> ell1_dre(const Ell1Harmonics<K> &h, const Dual<K> &e1, const Dual<K> &e2,
                            const Dual<K> &e1sq, const Dual<K> &e2sq, const Dual<K> &e1cu,
                            const Dual<K> &e2cu) {
  Dual<K> a = dsub(dmul(e2, h.s2), dmul(e1, h.c2));
  Dual<K> b = dsub(t2(5.0, e2sq, h.s1), t2(3.0, e2sq, h.s3));
  b = dsub(b, t3(2.0, e2, e1, h.c1));
  b = dadd(b, t3(6.0, e2, e1, h.c3));
  b = dadd(b, t2(3.0, e1sq, h.s1));
  b = dadd(b, t2(3.0, e1sq, h.s3));
  Dual<K> q = t2(5.0, e2cu, h.s2);
  q = dadd(q, t3(3.0, e1sq, e2, h.s2));
  q = dsub(q, t3(6.0, e1, e2sq, h.c2));
  q = dsub(q, t2(4.0, e1cu, h.c2));
  q = dsub(q, t2(4.0, e2cu, h.s4));
  q = dadd(q, t3(12.0, e1sq, e2, h.s4));
  q = dadd(q, t3(12.0, e1, e2sq, h.c4));
  q = dsub(q, t2(4.0, e1cu, h.c4));
  Dual<K> r = dadd(h.s1, dmulc(a, 0.5));
  r = dsub(r, dmulc(b, 0.125));
  return dsub(r, dmulc(q, 1.0 / 12));
}

template <int K>
__device__ Dual<K> ell1_drep(const Ell1Harmonics<K> &h, const Dual<K> &e1, const Dual<K> &e2,
                             const Dual<K> &e1sq, const Dual<K> &e2sq, const Dual<K> &e1cu,
                             const Dual<K> &e2cu) {
  Dual<K> b = dsub(t2(5.0, e2sq, h.c1), t2(9.0, e2sq, h.c3));
  b = dadd(b, t3(2.0, e1, e2, h.s1));
  b = dsub(b, t3(18.0, e1, e2, h.s3));
  b = dadd(b, t2(3.0, e1sq, h.c1));
  b = dadd(b, t2(9.0, e1sq, h.c3));
  Dual<K> q = t2(10.0, e2cu, h.c2);
  q = dadd(q, t3(6.0, e1sq, e2, h.c2));
  q = dadd(q, t3(12.0, e1, e2sq, h.s2));
  q = dadd(q, t2(8.0, e1cu, h.s2));
  q = dsub(q, t2(16.0, e2cu, h.c4));
  q = dadd(q, t3(48.0, e1sq, e2, h.c4));
  q = dsub(q, t3(48.0, e1, e2sq, h.s4));
  q = dadd(q, t2(16.0, e1cu, h.s4));
  Dual<K> r = dadd(dadd(h.c1, dmul(e1, h.s2)), dmul(e2, h.c2));
  r = dsub(r, dmulc(b, 0.125));
  return dsub(r, dmulc(q, 1.0 / 12));
}

template <int K>
__device__ Dual<K> ell1_drepp(const Ell1Harmonics<K> &h, const Dual<K> &e1, const Dual<K> &e2,
                              const Dual<K> &e1sq, const Dual<K> &e2sq, const Dual<K> &e1cu,
                              const Dual<K> &e2cu) {
  Dual<K> b = dadd(t2(-5.0, e2sq, h.s1), t2(27.0, e2sq, h.s3));
  b = dadd(b, t3(2.0, e1, e2, h.c1));
  b = dsub(b, t3(54.0, e1, e2, h.c3));
  b = dsub(b, t2(3.0, e1sq, h.s1));
  b = dsub(b, t2(27.0, e1sq, h.s3));
  Dual<K> q = t2(-20.0, e2cu, h.s2);
  q = dsub(q, t3(12.0, e1sq, e2, h.s2));
  q = dadd(q, t3(24.0, e1, e2sq, h.c2));
  q = dadd(q, t2(16.0, e1cu, h.c2));
  q = dadd(q, t2(64.0, e2cu, h.s4));
  q = dsub(q, t3(192.0, e1sq, e2, h.s4));
  q = dsub(q, t3(192.0, e1, e2sq, h.c4));
  q = dadd(q, t2(64.0, e1cu, h.c4));
  Dual<K> r = dadd(dneg(h.s1), t2(2.0, e1, h.c2));
  r = dsub(r, t2(2.0, e2, h.s2));
  r = dsub(r, dmulc(b, 0.125));
  return dsub(r, dmulc(q, 1.0 / 12));
}

// `v` seeded with 1 on the lane `code` and with `d2` on the lane `code2`
template <int K>
__device__ __forceinline__ Dual<K> dseed2(double v, const Lanes<K> &lane, int code, int code2,
                                          double d2) {
  Dual<K> r;
  r.v = v;
#pragma unroll
  for (int j = 0; j < K; ++j)
    r.d[j] = (lane.code[j] == code) ? 1.0 : (lane.code[j] == code2) ? d2 : 0.0;
  return r;
}

// DDGR: a GR-derived value seeded with its Jacobian row `jrow` in
// (MTOT, M2, ECC, A1, PB, XOMDOT), the host's forward-mode derivatives
template <int K>
__device__ __forceinline__ Dual<K> djac(double v, const Lanes<K> &lane, const double *jrow) {
  Dual<K> r;
  r.v = v;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int code = lane.code[j];
    r.d[j] = code == L_MTOT ? jrow[0] : code == L_M2 ? jrow[1] : code == L_ECC ? jrow[2]
           : code == L_A1 ? jrow[3] : code == L_PB ? jrow[4] : code == L_XOMDOT ? jrow[5]
           : 0.0;
  }
  return r;
}

// a post-Keplerian parameter: DDGR's derived one (`jac` given: its row
// `row` of P_JAC), else the plain parameter on its own lane
template <int K>
__device__ __forceinline__ Dual<K> dpk(const double *__restrict__ P, int slot, const Lanes<K> &lane,
                                       int code, const double *jac, int row) {
  return jac != nullptr ? djac<K>(P[slot], lane, jac + 6 * row) : dseed<K>(P[slot], lane, code);
}

// a / b with jax's tangent rule for division, ta / b + ((-tb) a) (1 / (b b))
// (engines.py _JaxDiv): DDK's A1 sin(kin) / sin(KIN) cancels in the KIN
// lane to ~1e-7 of its terms, where another rule's last bits show
template <int K>
__device__ __forceinline__ Dual<K> ddiv_jax(const Dual<K> &a, const Dual<K> &b) {
  Dual<K> r;
  r.v = __ddiv_rn(a.v, b.v);
  const double inv_b2 = __ddiv_rn(1.0, __dmul_rn(b.v, b.v));
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] / b.v + ((-b.d[j]) * a.v) * inv_b2;
  return r;
}

// x^y for an integer y >= 0 as jax's integer_pow: repeated squaring, the
// result multiplied on the left (engines.py ipow); y = 0 is a constant 1
template <int K>
__device__ Dual<K> dipow(Dual<K> x, int y) {
  if (y == 0) return dconst<K>(1.0);
  Dual<K> acc = x;
  bool have = false;
  while (y > 0) {
    if (y & 1) {
      acc = have ? dmul(acc, x) : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = dmul(x, x);
  }
  return acc;
}

// The orbit at the time t - delay_so_far (binary.py PulsarBinary._orbits),
// shared by every binary term: dt since the epoch, the orbital phase phi on
// the centred branch, the orbit count and the period pb: PB + PBDOT dt, or
// 1 / (FB0 + FB1 dt + ...) in the FB form. `jac`: DDGR's Jacobian (its
// PBDOT is derived), else null.
template <int K>
struct Orbit {
  Dual<K> dt, phi, pb;
  double norb;
};

template <int K>
__device__ Orbit<K> orbit(double t_hi, double t_lo, const Dual<K> &dsf,
                          const double *__restrict__ P, const Lanes<K> &lane, int epoch_lane,
                          int n_fb, const double *jac) {
  // dt = (t - epoch) - delay in dd; the epoch's lane enters with -1
  DDual<K> dtx;
  dtx.x = dd_add_fp(dd_sub(dd{t_hi, t_lo}, dd{P[P_EPOCH_HI], P[P_EPOCH_LO]}), -dsf.v);
#pragma unroll
  for (int j = 0; j < K; ++j)
    dtx.d[j] = (0.0 - (lane.code[j] == epoch_lane ? 1.0 : 0.0)) - dsf.d[j];
  Orbit<K> o;
  o.dt.v = dd_to_float(dtx.x);
#pragma unroll
  for (int j = 0; j < K; ++j) o.dt.d[j] = dtx.d[j];
  double norb0;
  Dual<K> frac;
  if (n_fb > 0) {
    // FB form: the lead dt FB0 in dd, rint, then the float64 tail
    // taylor_horner(dt, [0, 0, FB1, ...]); pb = 1 / taylor_horner(dt, [FB0, FB1, ...])
    DDual<K> fb0;
    fb0.x = dd{P[P_FB0_HI], P[P_FB0_LO]};
#pragma unroll
    for (int j = 0; j < K; ++j) fb0.d[j] = (lane.code[j] == L_FB0) ? 1.0 : 0.0;
    const DDual<K> lead = ddmul_full(dtx, fb0);
    norb0 = rint(dd_to_float(lead.x));
    frac.v = dd_to_float(dd_add_fp(lead.x, -norb0));
#pragma unroll
    for (int j = 0; j < K; ++j) frac.d[j] = lead.d[j];
    // FB_k as float64 (FB0 as hi + lo) on its lane
    auto fbk = [&](int k) {
      return dseed<K>(k == 0 ? __dadd_rn(P[P_FB0_HI], P[P_FB0_LO]) : P[P_FB1 + k - 1], lane,
                      L_FB0 + k);
    };
    if (n_fb > 1) {
      Dual<K> acc = ddivc(fbk(n_fb - 1), fact(n_fb));
      for (int i = n_fb - 1; i >= 0; --i)
        acc = dadd(dmul(acc, o.dt), i >= 2 ? ddivc(fbk(i - 1), fact(i)) : dconst<K>(0.0));
      frac = dadd(frac, acc);
    }
    Dual<K> h = ddivc(fbk(n_fb - 1), fact(n_fb - 1));
    for (int i = n_fb - 2; i >= 0; --i) h = dadd(dmul(h, o.dt), ddivc(fbk(i), fact(i)));
    o.pb = ddiv(dconst<K>(1.0), h);
  } else {
    const Dual<K> pb0 = dseed<K>(__dadd_rn(P[P_PB_HI], P[P_PB_LO]), lane, L_PB);
    // which orbit to measure from: rint carries no tangent
    norb0 = rint(__ddiv_rn(o.dt.v, pb0.v));
    Dual<K> rem;
    rem.v = dd_to_float(dd_sub(dtx.x, dd_mul_fp(dd{P[P_PB_HI], P[P_PB_LO]}, norb0)));
#pragma unroll
    for (int j = 0; j < K; ++j) rem.d[j] = dtx.d[j] - pb0.d[j] * norb0;
    frac = ddiv(rem, pb0);
    const Dual<K> u = dadd(dconst<K>(norb0), frac);
    const Dual<K> pbdot = dpk<K>(P, P_PBDOT, lane, L_PBDOT, jac, J_PBDOT);
    const Dual<K> pbdot_eff = dadd(pbdot, dseed<K>(P[P_XPBDOT], lane, L_XPBDOT));
    frac = dsub(frac, dmul(dmul(dmulc(pbdot_eff, 0.5), u), u));
    o.pb = dadd(pb0, dmul(pbdot, o.dt));
  }
  const double n2 = rint(frac.v);
  o.phi = dmulc(dsub(frac, dconst<K>(n2)), TWO_PI);
  o.norb = __dadd_rn(norb0, n2);
  return o;
}

// a1 = A1 + A1DOT dt (engines.py _a1)
template <int K>
__device__ __forceinline__ Dual<K> secular_a1(const Orbit<K> &o, const double *__restrict__ P,
                                              const Lanes<K> &lane) {
  return dadd(dseed<K>(P[P_A1], lane, L_A1), dmul(dseed<K>(P[P_A1DOT], lane, L_A1DOT), o.dt));
}

// ELL1H's orthometric Shapiro delay (engines.py ell1h_delay, ell1h_shapiro):
// the exact log form in STIGMA, or the harmonic series k = 3..nharms with
// stigma = H4 / H3 (h4) or 0 (h3), each sin(k phi) or cos(k phi) its own
template <int K>
__device__ Dual<K> ell1h_shapiro(const Dual<K> &phi, const Dual<K> &s1,
                                 const double *__restrict__ P, const Lanes<K> &lane,
                                 const Config &c) {
  const Dual<K> h3 = dseed<K>(P[P_H3], lane, L_H3);
  if (c.h_mode == H_STIGMA) {
    // -2 H3 / stigma^3 log(1 + stigma^2 - 2 stigma sin phi)
    const Dual<K> sg = dseed<K>(P[P_STIGMA], lane, L_STIGMA);
    const Dual<K> lognum = dsub(dadd(dconst<K>(1.0), dmul(sg, sg)), dmul(dmulc(sg, 2.0), s1));
    return dmul(ddiv(dmulc(h3, -2.0), dmul(sg, dmul(sg, sg))), dlog(lognum));
  }
  Dual<K> sg = dconst<K>(0.0);
  if (c.h_mode == H_H4)
    sg = ddiv(dseed<K>(P[P_H4], lane, L_H4), h3.v == 0.0 ? dconst<K>(1.0) : h3);
  Dual<K> total = dconst<K>(0.0);
  for (int k = 3; k <= c.nharms; ++k) {
    // (-1)^pwr (2 / k) stigma^(k - 3) basis(k phi)
    const bool even = (k % 2) == 0;
    const int pwr = even ? (k + 2) / 2 : (k + 1) / 2;
    const double coef = ((pwr & 1) ? -1.0 : 1.0) * __ddiv_rn(2.0, (double)k);
    const Dual<K> kphi = dmulc(phi, (double)k);
    const Dual<K> basis = even ? dcos(kphi) : dsin(kphi);
    total = dadd(total, dmul(dmulc(dipow(sg, k - 3), coef), basis));
  }
  return dmul(dmulc(h3, -2.0), total);
}

// The ELL1 family (binaries/engines.py ell1_delay, ell1h_delay, ell1k_delay)
// on the orbit `o`.
template <int K>
__device__ Dual<K> ell1_term(const Orbit<K> &o, const double *__restrict__ P,
                             const Lanes<K> &lane, const Config &c) {
  const Dual<K> &phi = o.phi, &dt = o.dt;
  // engine: secular A1 and the Roemer delay / a1 with its two phi derivatives
  const Dual<K> a1 = secular_a1(o, P, lane);
  Dual<K> dre, drep, drepp, s1;
  if (c.bin_model == ELL1_K) {
    // the eccentricity vector turns at OMDOT and grows at LNEDOT; the
    // first-order expansion with ELL1K's extra -3 eps1 / 2
    const Dual<K> omdot = dseed<K>(P[P_OMDOT], lane, L_OMDOT);
    const Dual<K> lnedot = dseed<K>(P[P_LNEDOT], lane, L_LNEDOT);
    const Dual<K> e10 = dseed<K>(P[P_EPS1], lane, L_EPS1), e20 = dseed<K>(P[P_EPS2], lane, L_EPS2);
    const Dual<K> wdt = dmul(omdot, dt);
    const Dual<K> cw = dcos(wdt), sw = dsin(wdt);
    const Dual<K> growth = dadd(dconst<K>(1.0), dmul(lnedot, dt));
    const Dual<K> e1 = dmul(growth, dadd(dmul(e10, cw), dmul(e20, sw)));
    const Dual<K> e2 = dmul(growth, dsub(dmul(e20, cw), dmul(e10, sw)));
    s1 = dsin(phi);
    const Dual<K> p2 = dmulc(phi, 2.0);
    const Dual<K> s2 = dsin(p2), c2 = dcos(p2);
    dre = dadd(s1, dmulc(dsub(dmul(e2, s2), dmul(e1, dadd(c2, dconst<K>(3.0)))), 0.5));
    drep = dadd(dadd(dcos(phi), dmul(e2, c2)), dmul(e1, s2));
    drepp = dadd(dsub(dneg(s1), t2(2.0, e2, s2)), t2(2.0, e1, c2));
  } else {
    // secular EPS1, EPS2 and ELL1's third-order expansion
    const Dual<K> e1 = dadd(dseed<K>(P[P_EPS1], lane, L_EPS1), dmulc(dt, P[P_EPS1DOT]));
    const Dual<K> e2 = dadd(dseed<K>(P[P_EPS2], lane, L_EPS2), dmulc(dt, P[P_EPS2DOT]));
    Ell1Harmonics<K> h;
    h.s1 = dsin(phi);
    h.c1 = dcos(phi);
    const Dual<K> p2 = dmulc(phi, 2.0), p3 = dmulc(phi, 3.0), p4 = dmulc(phi, 4.0);
    h.s2 = dsin(p2);
    h.c2 = dcos(p2);
    h.s3 = dsin(p3);
    h.c3 = dcos(p3);
    h.s4 = dsin(p4);
    h.c4 = dcos(p4);
    const Dual<K> e1sq = dmul(e1, e1), e2sq = dmul(e2, e2);
    const Dual<K> e1cu = dmul(e1sq, e1), e2cu = dmul(e2sq, e2);
    dre = ell1_dre(h, e1, e2, e1sq, e2sq, e1cu, e2cu);
    drep = ell1_drep(h, e1, e2, e1sq, e2sq, e1cu, e2cu);
    drepp = ell1_drepp(h, e1, e2, e1sq, e2sq, e1cu, e2cu);
    s1 = h.s1;
  }
  const Dual<K> Dre = dmul(a1, dre), Drep = dmul(a1, drep), Drepp = dmul(a1, drepp);
  // inverse timing: Dre (1 - x + x^2 + 0.5 nhat^2 Dre Drepp), x = nhat Drep
  const Dual<K> nhat = ddiv(dconst<K>(TWO_PI), o.pb);
  const Dual<K> x = dmul(nhat, Drep);
  Dual<K> g = dadd(dsub(dconst<K>(1.0), x), dmul(x, x));
  g = dadd(g, dmul(dmul(dmulc(dmul(nhat, nhat), 0.5), Dre), Drepp));
  const Dual<K> delay_i = dmul(Dre, g);
  if (c.bin_model == ELL1_H) return dadd(delay_i, ell1h_shapiro<K>(phi, s1, P, lane, c));
  // Shapiro: -2 TSUN M2 log(1 - SINI sin phi)
  const Dual<K> tm2 = dmulc(dseed<K>(P[P_M2], lane, L_M2), c.tsun);
  const Dual<K> sini = dseed<K>(P[P_SINI], lane, L_SINI);
  const Dual<K> delay_s = dmul(dmulc(tm2, -2.0), dlog(dsub(dconst<K>(1.0), dmul(sini, s1))));
  return dadd(delay_i, delay_s);
}

// Kepler's equation E - e sin E = M (binaries/kepler.py kepler_E): Danby's
// start and NEWTON_ITERS Newton steps on the primal doubles, in the twin's
// order (sign(0) = 0, as jnp.sign), then one dual value from the implicit
// rule dE = (dM + sin E de) / (1 - e cos E), so no lane rides the loop.
// sin E and cos E come back as duals from the rule's own sine and cosine.
template <int K>
__device__ Dual<K> kepler_E(const Dual<K> &M, const Dual<K> &e, Dual<K> &sinE, Dual<K> &cosE) {
  const double m = M.v, ev = e.v;
  const double sm = sin(m);
  const double sg = sm > 0.0 ? 1.0 : sm < 0.0 ? -1.0 : sm;
  double E = __dadd_rn(m, __dmul_rn(__dmul_rn(0.85, ev), sg));
  for (int it = 0; it < NEWTON_ITERS; ++it) {
    const double f = __dsub_rn(__dsub_rn(E, __dmul_rn(ev, sin(E))), m);
    const double fp = __dsub_rn(1.0, __dmul_rn(ev, cos(E)));
    E = __dsub_rn(E, __ddiv_rn(f, fp));
  }
  Dual<K> r;
  r.v = E;
  const double sE = sin(E), cE = cos(E);
  const double denom = __dsub_rn(1.0, __dmul_rn(ev, cE));
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = (M.d[j] + sE * e.d[j]) / denom;
  // dsin(r) and dcos(r), without a second sine and cosine
  sinE.v = sE;
  cosE.v = cE;
  const double msE = -sE;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    sinE.d[j] = cE * r.d[j];
    cosE.d[j] = msE * r.d[j];
  }
  return r;
}

// True anomaly on E's branch (kepler.py true_anomaly): the centred branch
// Ec = E - 2 pi rint(E / 2 pi), 2 atan2(sqrt(1+e) sin(Ec/2), sqrt(1-e) cos(Ec/2)),
// re-attached
template <int K>
__device__ Dual<K> true_anomaly(const Dual<K> &E, const Dual<K> &e) {
  const double n = rint(__ddiv_rn(E.v, TWO_PI));
  const double two_pi_n = __dmul_rn(TWO_PI, n);
  const Dual<K> Ec = dsub(E, dconst<K>(two_pi_n));
  const Dual<K> half = dmulc(Ec, 0.5);
  const Dual<K> y = dmul(dsqrt(dadd(dconst<K>(1.0), e)), dsin(half));
  const Dual<K> x = dmul(dsqrt(dsub(dconst<K>(1.0), e)), dcos(half));
  return dadd(dmulc(datan2(y, x), 2.0), dconst<K>(two_pi_n));
}

// DDK's per-row A1, OM and SINI (engines.py ddk_corrections): the proper
// motion drifts the inclination and turns the node over dt = t_hi - T0
// (plain float64, as pint_tpu); with astrometry, the parallax adds the
// site's position r in the (east, north) basis at the pulsar direction n,
// east = zhat x n / |zhat x n| and north = n x east (jnp.cross's order),
// over pint_tpu's literal DDK_AU_LS. out: A1, OM, SINI.
template <int K>
__device__ void ddk_corrections(double t_hi, const Dual<K> *n, bool has_ast, const double *r,
                                const double *__restrict__ P, const Lanes<K> &lane,
                                Dual<K> *out) {
  const Dual<K> kin0 = dseed<K>(P[P_KIN], lane, L_KIN), kom = dseed<K>(P[P_KOM], lane, L_KOM);
  const Dual<K> skom = dsin(kom), ckom = dcos(kom);
  const Dual<K> dt =
      dsub(dconst<K>(t_hi), dseed<K>(__dadd_rn(P[P_EPOCH_HI], P[P_EPOCH_LO]), lane, L_T0));
  const Dual<K> pmra = dseed<K>(P[P_PMRA], lane, L_PMRA);
  const Dual<K> pmdec = dseed<K>(P[P_PMDEC], lane, L_PMDEC);
  Dual<K> d_kin = dmul(dadd(dmul(dneg(pmra), skom), dmul(pmdec, ckom)), dt);
  const Dual<K> skin0 = dsin(kin0);
  Dual<K> dom = ddiv(dmul(dadd(dmul(pmra, ckom), dmul(pmdec, skom)), dt), skin0);
  if (has_ast) {
    // east = zhat x n: (0 n2 - 1 n1, 1 n0 - 0 n2, 0 n1 - 0 n0), normalized
    Dual<K> e[3] = {dsub(dmulc(n[2], 0.0), dmulc(n[1], 1.0)),
                    dsub(dmulc(n[0], 1.0), dmulc(n[2], 0.0)),
                    dsub(dmulc(n[1], 0.0), dmulc(n[0], 0.0))};
    const Dual<K> norm = dsqrt(dadd(dadd(dmul(e[0], e[0]), dmul(e[1], e[1])), dmul(e[2], e[2])));
#pragma unroll
    for (int k = 0; k < 3; ++k) e[k] = ddiv(e[k], norm);
    // north = n x east
    const Dual<K> no[3] = {dsub(dmul(n[1], e[2]), dmul(n[2], e[1])),
                           dsub(dmul(n[2], e[0]), dmul(n[0], e[2])),
                           dsub(dmul(n[0], e[1]), dmul(n[1], e[0]))};
    const Dual<K> r_e = ddot3(r, e), r_n = ddot3(r, no);
    const Dual<K> inv_d = ddivc(dseed<K>(P[P_PX], lane, L_PX), DDK_AU_LS);
    d_kin = dsub(d_kin, dmul(inv_d, dsub(dmul(r_e, skom), dmul(r_n, ckom))));
    dom = dsub(dom, ddiv(dmul(inv_d, dadd(dmul(r_e, ckom), dmul(r_n, skom))), skin0));
  }
  const Dual<K> kin_t = dadd(kin0, d_kin);
  const Dual<K> skin_t = dsin(kin_t);
  out[0] = ddiv_jax(dmul(dseed<K>(P[P_A1], lane, L_A1), skin_t), skin0);
  out[1] = dadd(dseed<K>(P[P_OM], lane, L_OM), dom);
  out[2] = skin_t;
}

// BT (engines.py bt_delay) and DD (engines.py _dd_core) on the orbit `o`:
// DDS is DD with the host's SINI and its SHAPMAX seed; DDGR (`jac` given)
// DD with the host's derived values seeded by their Jacobian rows; DDK
// (`kop` given) DD with its per-row A1, OM and SINI.
template <int K>
__device__ Dual<K> kepler_term(const Orbit<K> &o, const double *__restrict__ P,
                               const Lanes<K> &lane, int model, double tsun, const double *jac,
                               const Dual<K> *kop) {
  const Dual<K> one = dconst<K>(1.0);
  const Dual<K> e = dadd(dseed<K>(P[P_ECC], lane, L_ECC),
                         dmul(dseed<K>(P[P_EDOT], lane, L_EDOT), o.dt));
  const Dual<K> a1 = kop != nullptr
                         ? dadd(kop[0], dmul(dseed<K>(P[P_A1DOT], lane, L_A1DOT), o.dt))
                         : secular_a1(o, P, lane);
  const Dual<K> gamma = dpk<K>(P, P_GAMMA, lane, L_GAMMA, jac, J_GAMMA);
  const Dual<K> om = kop != nullptr ? kop[1] : dseed<K>(P[P_OM], lane, L_OM);
  const Dual<K> omdot = dpk<K>(P, P_OMDOT, lane, L_OMDOT, jac, J_OMDOT);
  Dual<K> sinE, cosE;
  const Dual<K> E = kepler_E(o.phi, e, sinE, cosE);
  if (model == KEPLER_BT) {
    const Dual<K> omega = dadd(om, dmul(omdot, o.dt));
    const Dual<K> sw = dsin(omega), cw = dcos(omega);
    const Dual<K> root = dsqrt(dsub(one, dmul(e, e)));
    const Dual<K> a1sw = dmul(a1, sw), a1cwr = dmul(dmul(a1, cw), root);
    const Dual<K> L1 = dmul(a1sw, dsub(cosE, e));
    const Dual<K> L2 = dmul(dadd(a1cwr, gamma), sinE);
    const Dual<K> num = dsub(dmul(a1cwr, cosE), dmul(a1sw, sinE));
    const Dual<K> D =
        dsub(one, ddiv(dmulc(num, TWO_PI), dmul(dsub(one, dmul(e, cosE)), o.pb)));
    return dmul(dadd(L1, L2), D);
  }
  const Dual<K> nu = true_anomaly(E, e);
  const Dual<K> nu_full = dadd(nu, dconst<K>(__dmul_rn(TWO_PI, o.norb)));
  // omega = OM + k nu, k = OMDOT pb / 2 pi
  const Dual<K> k = ddivc(dmul(omdot, o.pb), TWO_PI);
  const Dual<K> omega = dadd(om, dmul(k, nu_full));
  const Dual<K> sw = dsin(omega), cw = dcos(omega);
  const Dual<K> er = dmul(e, dadd(one, dpk<K>(P, P_DR, lane, L_DR, jac, J_DR)));
  const Dual<K> eth = dmul(e, dadd(one, dpk<K>(P, P_DTH, lane, L_DTH, jac, J_DTH)));
  const Dual<K> alpha = dmul(a1, sw);
  const Dual<K> beta = dmul(dmul(a1, dsqrt(dsub(one, dmul(eth, eth)))), cw);
  const Dual<K> bg = dadd(beta, gamma);
  // Dre = Roemer + Einstein in proper time, and its two derivatives
  const Dual<K> Dre = dadd(dmul(alpha, dsub(cosE, er)), dmul(bg, sinE));
  const Dual<K> Drep = dadd(dmul(dneg(alpha), sinE), dmul(bg, cosE));
  const Dual<K> Drepp = dsub(dmul(dneg(alpha), cosE), dmul(bg, sinE));
  const Dual<K> one_m_ecosE = dsub(one, dmul(e, cosE));
  const Dual<K> nhat = ddiv(ddiv(dconst<K>(TWO_PI), o.pb), one_m_ecosE);
  // inverse timing with the e sin E term
  const Dual<K> nD = dmul(nhat, Drep);
  const Dual<K> nhat2 = dmul(nhat, nhat);
  Dual<K> g = dadd(dsub(one, nD), dmul(nD, nD));
  g = dadd(g, dmul(dmul(dmulc(nhat2, 0.5), Dre), Drepp));
  const Dual<K> esin = ddiv(dmul(dmulc(e, 0.5), sinE), one_m_ecosE);
  g = dsub(g, dmul(dmul(dmul(esin, nhat2), Dre), Drep));
  const Dual<K> delay_i = dmul(Dre, g);
  // Shapiro: -2 TSUN M2 log(1 - e cos E - SINI (sin w (cos E - e) + sqrt(1 - e^2) cos w sin E))
  const Dual<K> tm2 = dmulc(dseed<K>(P[P_M2], lane, L_M2), tsun);
  const Dual<K> sini = kop != nullptr ? kop[2]
                       : jac != nullptr ? djac<K>(P[P_SINI], lane, jac + 6 * J_SINI)
                                        : dseed2<K>(P[P_SINI], lane, L_SINI, L_SHAPMAX, P[P_DSINI]);
  const Dual<K> orbit_s = dadd(dmul(sw, dsub(cosE, e)),
                               dmul(dmul(dsqrt(dsub(one, dmul(e, e))), cw), sinE));
  const Dual<K> arg = dsub(one_m_ecosE, dmul(sini, orbit_s));
  const Dual<K> delay_s = dmul(dmulc(tm2, -2.0), dlog(arg));
  // aberration: A0 (sin(w + nu) + e sin w) + B0 (cos(w + nu) + e cos w)
  const Dual<K> wpnu = dadd(omega, nu_full);
  const Dual<K> delay_a =
      dadd(dmul(dseed<K>(P[P_A0], lane, L_A0), dadd(dsin(wpnu), dmul(e, sw))),
           dmul(dseed<K>(P[P_B0], lane, L_B0), dadd(dcos(wpnu), dmul(e, cw))));
  return dadd(dadd(delay_i, delay_s), delay_a);
}

// row i's phase and frequency; f_bary is stored to *fb_out when given (as
// soon as it is known, so that it holds no register through the row)
template <int K, int BIN, bool NG>
__device__ RowPhase<K> eval_row(int i, const Rows &rows, const double *__restrict__ P,
                                const Config &c, const Lanes<K> &lane, double *fb_out) {
  const double t_hi = rows.t_hi[i], t_lo = rows.t_lo[i];
  Dual<K> total = dconst<K>(0.0);
  Dual<K> n[3];
  if (c.has_ast) {
    // pulsar direction with proper motion (astrometry.py pulsar_direction)
    const double dt = __dadd_rn(__dsub_rn(t_hi, P[P_POSEPOCH]), t_lo);
    const Dual<K> dec0 = dseed<K>(P[P_DECJ], lane, L_DECJ);
    const Dual<K> ra = dadd(dseed<K>(P[P_RAJ], lane, L_RAJ),
                            ddiv(dmulc(dseed<K>(P[P_PMRA], lane, L_PMRA), dt), dcos(dec0)));
    const Dual<K> dec = dadd(dec0, dmulc(dseed<K>(P[P_PMDEC], lane, L_PMDEC), dt));
    const Dual<K> cl = dcos(dec);
    n[0] = dmul(cl, dcos(ra));
    n[1] = dmul(cl, dsin(ra));
    n[2] = dsin(dec);
    if constexpr (NG) {
      if (c.ecliptic) {  // ecliptic of J2000 -> ICRS (astrometry.py ecliptic_to_icrs)
        const Dual<K> y = n[1], z = n[2];
        n[1] = dsub(dmulc(y, c.cos_obl), dmulc(z, c.sin_obl));
        n[2] = dadd(dmulc(y, c.sin_obl), dmulc(z, c.cos_obl));
      }
    }
    // Roemer + parallax (AstrometryBase.delay)
    const double *r = rows.pos + 3 * i;
    const Dual<K> rn = ddot3(r, n);
    const double r2 = dot3c(r, r);
    const Dual<K> px = dseed<K>(P[P_PX], lane, L_PX);
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
  // f_bary = f (1 - v.n) (dispersion.py barycentric_radio_freq)
  Dual<K> fb = dconst<K>(rows.freq[i]);
  const bool dispersive = c.nd > 0 || (NG && (c.n_dmx > 0 || c.n_fd > 0));
  if (c.has_ast && dispersive) {
    const Dual<K> beta = ddot3(rows.vel + 3 * i, n);
    fb = dmulc(dsub(dconst<K>(1.0), beta), rows.freq[i]);
  } else if (c.has_ast) {
    fb.v = __dmul_rn(__dsub_rn(1.0, dot3c(rows.vel + 3 * i, n[0].v, n[1].v, n[2].v)),
                     rows.freq[i]);
  }
  if (fb_out != nullptr) *fb_out = fb.v;
  if (c.nd > 0) {
    // DM(t): Taylor polynomial about DMEPOCH (dispersion.py base_dm)
    Dual<K> dm;
    if (c.nd == 1) {
      dm = dmulc(dseed<K>(P[P_DM0], lane, L_DM0), 1.0);
    } else {
      const double dtd = __dadd_rn(__dsub_rn(t_hi, P[P_DMEPOCH]), t_lo);
      dm = ddivc(dseed<K>(P[P_DM0 + c.nd - 1], lane, L_DM0 + c.nd - 1), fact(c.nd - 1));
      for (int k = c.nd - 2; k >= 0; --k)
        dm = dadd(dmulc(dm, dtd), ddivc(dseed<K>(P[P_DM0 + k], lane, L_DM0 + k), fact(k)));
    }
    Dual<K> dmd = dconst<K>(0.0);
    if (isfinite(fb.v)) dmd = ddiv(dmulc(dm, c.dmconst), dmul(fb, fb));
    total = dadd(total, dmd);
  }
  if constexpr (NG) {
    if (c.n_dmx > 0) {
      // DMX: this set's window DM of the row; lane 128 + j seeds onehot[i, j]
      const double *oh = rows.onehot + (size_t)i * c.n_dmx;
      const Dual<K> dmx = dcolumn<K>(rows.dmx[i], lane, L_DMX0, c.n_dmx,
                                     [&](int m) { return oh[m]; });
      Dual<K> dmd = dconst<K>(0.0);
      if (isfinite(fb.v)) dmd = ddiv(dmulc(dmx, c.dmconst), dmul(fb, fb));
      total = dadd(total, dmd);
    }
    if (c.n_fd > 0) {
      // FD: Horner of FD_n .. FD_1 over log(f_bary / 1 GHz), zero where that
      // is not finite and positive
      const Dual<K> fg = ddivc(fb, 1e3);
      const bool finite = isfinite(fg.v) && fg.v > 0.0;
      const Dual<K> lf = finite ? dlog(fg) : dconst<K>(0.0);
      const int fd_base = P_DM0 + c.nd + 2 * c.nf;
      Dual<K> fd = dconst<K>(0.0);
      for (int k = c.n_fd; k >= 1; --k)
        fd = dmul(dadd(fd, dseed<K>(P[fd_base + k - 1], lane, L_FD0 + k)), lf);
      total = dadd(total, finite ? fd : dconst<K>(0.0));
    }
  }
  if constexpr (BIN == BIN_ELL1) {
    const Orbit<K> o = orbit<K>(t_hi, t_lo, total, P, lane, L_TASC, c.n_fb, nullptr);
    total = dadd(total, ell1_term<K>(o, P, lane, c));
  } else if constexpr (BIN == BIN_KEPLER) {
    const double *jac = c.bin_model == KEPLER_DDGR ? P + P_JAC : nullptr;
    const Orbit<K> o = orbit<K>(t_hi, t_lo, total, P, lane, L_T0, c.n_fb, jac);
    if (c.bin_model == KEPLER_DDK) {
      Dual<K> kop[3];
      ddk_corrections<K>(t_hi, n, c.has_ast, rows.pos + 3 * i, P, lane, kop);
      total = dadd(total, kepler_term<K>(o, P, lane, c.bin_model, c.tsun, nullptr, kop));
    } else {
      total = dadd(total, kepler_term<K>(o, P, lane, c.bin_model, c.tsun, jac, nullptr));
    }
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
    for (int j = 0; j < K; ++j) r.d[j] = (lane.code[j] == L_F0 + k) ? 1.0 : 0.0;
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
  if constexpr (NG) {
    if (c.n_jump > 0) {  // ... PhaseJump: F0 * jump seconds, a dd with lo = 0 ...
      const Dual<K> jp = dcolumn<K>(rows.jump[i], lane, L_JUMP0, c.n_jump,
                                    [&](int m) { return rows.masks[(size_t)m * c.n_rows + i]; });
      const Dual<K> f0 = dseed<K>(__dadd_rn(P[f_base], P[f_base + 1]), lane, L_F0);
      const Dual<K> jph = dmul(jp, f0);
      DDual<K> x;
      x.x = dd{jph.v, 0.0};
#pragma unroll
      for (int j = 0; j < K; ++j) x.d[j] = jph.d[j];
      out.ph = ddadd(out.ph, x);
    }
  }
  if (c.has_tzr) out.ph = ddadd(out.ph, zero);  // ... then AbsPhase (zero)
  // spin frequency: float64 Horner of [F0, F1, ...] at dt (taylor_horner_deriv)
  Dual<K> dtf;
  dtf.v = dd_to_float(dt.x);
#pragma unroll
  for (int j = 0; j < K; ++j) dtf.d[j] = dt.d[j];
  auto fcoeff = [&](int k) {
    return dseed<K>(__dadd_rn(P[f_base + 2 * k], P[f_base + 2 * k + 1]), lane, L_F0 + k);
  };
  Dual<K> fq = ddivc(fcoeff(c.nf - 1), fact(c.nf - 1));
  for (int k = c.nf - 2; k >= 0; --k) fq = dadd(dmul(fq, dtf), ddivc(fcoeff(k), fact(k)));
  out.f = fq;
  return out;
}

// grid: (row blocks, parameter sets, lane chunks of K)
template <int K, int BIN, bool NG>
__global__ void __launch_bounds__(THREADS)
resid_tangent_kernel(Rows rows, const double *__restrict__ params, Config c,
                     double *__restrict__ pn, double *__restrict__ frac,
                     double *__restrict__ freq_out, double *__restrict__ dfrac,
                     double *__restrict__ dfreq, double *__restrict__ fb_out) {
  const int b = blockIdx.y;
  if constexpr (NG) {  // this set's row columns
    if (c.n_dmx > 0) rows.dmx += (size_t)b * c.n_rows;
    if (c.n_jump > 0) rows.jump += (size_t)b * c.n_rows;
  }
  const int lb = blockIdx.z * K;  // first lane of this block's chunk
  const int slots = gridDim.z * K;
  Lanes<K> lane;
#pragma unroll
  for (int j = 0; j < K; ++j) lane.code[j] = c.lane[lb + j];
  const double *P = params + (size_t)b * c.n_par;
  __shared__ double tz_hi, tz_lo;
  __shared__ double tz_d[K > 0 ? K : 1];
  if (c.has_tzr && threadIdx.x == 0) {
    const bool first = blockIdx.x == 0 && blockIdx.z == 0;
    double *tz_fb = first ? fb_out + (size_t)b * c.n_rows + c.n_rows - 1 : nullptr;
    const RowPhase<K> tz = eval_row<K, BIN, NG>(c.n_rows - 1, rows, P, c, lane, tz_fb);
    tz_hi = tz.ph.x.hi;
    tz_lo = tz.ph.x.lo;
#pragma unroll
    for (int j = 0; j < K; ++j) tz_d[j] = tz.ph.d[j];
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  RowPhase<K> r;
  if (i < c.n_out)
    r = eval_row<K, BIN, NG>(i, rows, P, c, lane,
                             blockIdx.z == 0 ? fb_out + (size_t)b * c.n_rows + i : nullptr);
  __syncthreads();
  if (i >= c.n_out) return;
  DDual<K> ph = r.ph;
  if (c.has_tzr) {
    ph.x = dd_add(ph.x, dd_neg(dd{tz_hi, tz_lo}));
#pragma unroll
    for (int j = 0; j < K; ++j) ph.d[j] = ph.d[j] - tz_d[j];
  }
  if (blockIdx.z == 0) {
    // pint_tpu's phase_residual_frac: the offsets added (xp.add_f), then
    // the tracked pulse numbers subtracted, or the nearest pulse taken
    const dd x = c.has_dpn ? dd_add_fp(ph.x, rows.dpn[i]) : ph.x;
    double k;
    dd rem;
    if (c.has_track) {
      k = rows.track[i];
      rem = dd_add_fp(x, -k);
    } else {
      rem = dd_rint(x, k);
    }
    const size_t o = (size_t)b * c.n_out + i;
    pn[o] = k;
    frac[o] = dd_to_float(rem);
    freq_out[o] = r.f.v;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const size_t oj = ((size_t)b * slots + lb + j) * c.n_out + i;
    dfrac[oj] = ph.d[j];
    dfreq[oj] = r.f.d[j];
  }
}

struct Out {
  double *pn, *frac, *f, *dfrac, *df, *fb;
};

template <int K, int BIN, bool NG>
cudaError_t launch(const Rows &rows, const double *params, const Config &c, int n_batch,
                   const Out &o, cudaStream_t stream) {
  const int chunks = K > 0 ? (c.n_lane + K - 1) / K : 1;
  const dim3 grid((c.n_out + THREADS - 1) / THREADS, n_batch, chunks);
  resid_tangent_kernel<K, BIN, NG><<<grid, THREADS, 0, stream>>>(rows, params, c, o.pn, o.frac,
                                                                 o.f, o.dfrac, o.df, o.fb);
  return cudaGetLastError();
}

// the narrowest instance that holds k lanes (a chunk of KCHUNK past 4)
template <int BIN, bool NG>
cudaError_t launch_lanes(int k, const Rows &rows, const double *params, const Config &c,
                         int n_batch, const Out &o, cudaStream_t s) {
  if (k == 0) return launch<0, BIN, NG>(rows, params, c, n_batch, o, s);
  if (k <= 2) return launch<2, BIN, NG>(rows, params, c, n_batch, o, s);
  if (k <= 4) return launch<4, BIN, NG>(rows, params, c, n_batch, o, s);
  return launch<KCHUNK, BIN, NG>(rows, params, c, n_batch, o, s);
}

template <int BIN>
cudaError_t launch_kind(bool ng, int k, const Rows &rows, const double *params, const Config &c,
                        int n_batch, const Out &o, cudaStream_t s) {
  return ng ? launch_lanes<BIN, true>(k, rows, params, c, n_batch, o, s)
            : launch_lanes<BIN, false>(k, rows, params, c, n_batch, o, s);
}

}  // namespace

// ints: n_rows n_out has_tzr has_ast nd nf n_par k bin_kind bin_model ecliptic
// n_dmx n_fd n_jump n_fb h_mode nharms lane[0..LMAX) has_dpn has_track
// (bin_kind: 0 none, 1 ELL1, 2 Kepler; bin_model: ELL1_* or KEPLER_*; n_fb: 0
// for the PB form)
// consts: au_ls dmconst tsun cos_obl sin_obl
// dmx, jump (n_batch, n_rows): each set's DMX DM and jump seconds per row;
// onehot (n_rows, n_dmx), masks (n_jump, n_rows): the DMX and JUMP lanes'
// seeds (each a single zero when its term is absent); dpn, track (n_out,):
// the data rows' pulse offsets and TRACK -2 pulse numbers (read only when
// has_dpn, has_track)
// dfrac, df: (n_batch, slots, n_out) with slots = k rounded up to whole
// chunks of the lane width (2 for k <= 2, 4 for k <= 4, else 8); fb (n_batch,
// n_rows)
extern "C" int resid_tangent(const double *t_hi, const double *t_lo, const double *freq,
                             const double *pos, const double *vel, const double *sun,
                             const double *dmx, const double *jump, const double *onehot,
                             const double *masks, const double *dpn, const double *track,
                             const double *params, int n_batch,
                             const int *ints, const double *consts, double *pn, double *frac,
                             double *f, double *dfrac, double *df, double *fb, void *stream) {
  Config c;
  c.n_rows = ints[0];
  c.n_out = ints[1];
  c.has_tzr = ints[2];
  c.has_ast = ints[3];
  c.nd = ints[4];
  c.nf = ints[5];
  c.n_par = ints[6];
  const int k = ints[7];
  c.n_lane = k;
  const int bin_kind = ints[8];
  c.bin_model = ints[9];
  c.ecliptic = ints[10];
  c.n_dmx = ints[11];
  c.n_fd = ints[12];
  c.n_jump = ints[13];
  c.n_fb = ints[14];
  c.h_mode = ints[15];
  c.nharms = ints[16];
  const int n_models = bin_kind == BIN_ELL1 ? 3 : bin_kind == BIN_KEPLER ? 4 : 1;
  if (k < 0 || k > LMAX || c.nf < 1 || c.nd < 0 || c.nd > 16 || c.n_out < 0 ||
      n_batch < 1 || n_batch > 65535 || c.n_fd < 0 || c.n_fd > MAX_FD || c.n_dmx < 0 ||
      c.n_jump < 0 || c.n_par != P_DM0 + c.nd + 2 * c.nf + c.n_fd ||
      bin_kind < BIN_NONE || bin_kind > BIN_KEPLER || c.bin_model < 0 ||
      c.bin_model >= n_models || c.n_fb < 0 || c.n_fb > MAX_FB || c.h_mode < H_H3 ||
      c.h_mode > H_STIGMA || c.nharms < 0 || c.nharms > MAX_NHARMS ||
      (c.bin_model == KEPLER_DDK && bin_kind == BIN_KEPLER && c.ecliptic))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < LMAX; ++j) c.lane[j] = j < k ? ints[17 + j] : -1;
  c.has_dpn = ints[17 + LMAX];
  c.has_track = ints[18 + LMAX];
  for (int j = 0; j < k; ++j) {  // a DMX or JUMP lane names an existing column
    const int m = c.lane[j];
    if ((m >= L_DMX0 && m < L_FB0 && m - L_DMX0 >= c.n_dmx) ||
        (m >= L_JUMP0 && m < L_DMX0 && m - L_JUMP0 >= c.n_jump))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  c.au_ls = consts[0];
  c.dmconst = consts[1];
  c.tsun = consts[2];
  c.cos_obl = consts[3];
  c.sin_obl = consts[4];
  if (c.n_out == 0) return 0;
  const Rows rows{t_hi, t_lo, freq, pos, vel, sun, dmx, jump, onehot, masks, dpn, track};
  const Out o{pn, frac, f, dfrac, df, fb};
  const bool ng = c.ecliptic || c.n_dmx > 0 || c.n_fd > 0 || c.n_jump > 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bin_kind == BIN_ELL1)
    e = launch_kind<BIN_ELL1>(ng, k, rows, params, c, n_batch, o, s);
  else if (bin_kind == BIN_KEPLER)
    e = launch_kind<BIN_KEPLER>(ng, k, rows, params, c, n_batch, o, s);
  else
    e = launch_kind<BIN_NONE>(ng, k, rows, params, c, n_batch, o, s);
  return static_cast<int>(e);
}

// K1 resid_tangent: the per-TOA timing forward pass with forward-mode tangents.
//
// Replaces: the `resid` program (pint_tpu/residuals.py get_resid_fn:
// TimingModel.phase_and_freq + phase_residual_frac), and the design matrix
// of the nonlinear parameters that pint_tpu forms with jax.linearize + vmap
// (fitting/wls.py get_step_fn.design, gridutils.py _point_kernel.gn_step).
//
// The chain, per row, in the order of the Python twin (models/*.py, a term
// at a time):
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
// It writes the pulse number, the fractional phase (hi + lo), f, and the
// barycentric frequency f_bary of every row, the TZR row included (kernel
// K8 reads it), and d(frac)/dp and d(f)/dp per lane; the caller forms
// d(r/f) (fitting/wls.py, gls.py, gridutils.py).
//
// The ecliptic frame, DMX, FD and the phase JUMPs are NANOGrav's terms: a
// template flag (NG) compiles them only into the instances that need them.
// The DMX DM of each row and its jump seconds arrive as per-set row columns
// (the one-hot product and the mask sums, formed by the wrapper as the twin
// forms them). The binary kind is a template parameter (BIN: 0 none, 1
// ELL1, 2 Kepler); the models of a kind are a run-time switch
// (Config::bin_model: ELL1, ELL1H, ELL1K; BT, DD and DDS, DDGR, DDK), as are
// ELL1H's mode and harmonics and the FB form.
//
// Tangents: beside every value a thread carries K dual lanes, one per free
// parameter (lane codes: the L_* enum below, the table LANE_CODES of
// residuals.py: 0-4 astrometry, 5-9 PB A1 TASC EPS1 EPS2, 16 + k for F_k,
// 32 + k for DM_k, 48-62 the Kepler-orbit and shared binary lanes, 64 + k
// for FD_k, 80 + m for the m-th JUMP, 128 + j for the DMX of window j,
// 256 + k for FB_k, 264-272 H3 H4 STIGMA LNEDOT KIN KOM MTOT XOMDOT XPBDOT). A
// double-double value carries one float64 tangent: the derivative needs
// float64 precision only, as jax's tangents through the float64 carriers do.
//
// Passes (the plan, csrc/k1_plan.h, splits the lanes and sizes the scratch):
//   1. resid_primal, one thread per row and set (the TZR row included): the
//      chain without lanes. Every transcendental it meets (sine and cosine
//      of an angle, in one sincos; log; square root; atan2; Kepler's E with
//      sin E and cos E after the Newton steps) is stored in the row's tape,
//      a scratch laid out (set, slot, row) so that a warp's rows read one
//      slot coalesced; so are the row's phase (hi, lo). It writes f and
//      f_bary.
//   2. resid_tzr, one thread per set and kernel lane: the TZR row's tangent
//      of each lane (its d frac before the subtraction).
//   3. resid_lanes, one thread per row, set and group of K lanes: the chain
//      again with its lanes, reading every transcendental back from the tape
//      (no sine, log or Newton step runs twice for a row and set) and
//      redoing the cheap primal arithmetic (adds, multiplies, divisions, the
//      dd steps) in the same order; minus the TZR row's tangents; each lane
//      to its column. It is a programmatic dependent launch of pass 2, so
//      its chains run beside the TZR row's. The first group also forms the pulse number and
//      fractional phase from the tape's phases, and the JUMP columns in
//      closed form. With no kernel lane, resid_finalize does that alone.
// Each lane's arithmetic reads only the primal values and its own seed, and
// the build keeps every operation's rounding (--fmad=false, __d*_rn): so the
// lanes' grouping into threads, and the primal values' source (recomputed or
// read back), change no bit of any output.
//
// The DMX lanes are one kernel lane (k1_plan.h): seeded 1 on every row, its
// tangent g_i is what a lane seeded with onehot[i, j] = 1 gives, and the
// lane of a row outside window j is zero throughout. The lane pass writes
// window j's column as (onehot[i, j] ? g_i : 0) - (onehot[tzr, j] ? g_tzr : 0).
// The JUMP lanes are F0 mask in closed form: (mask_i ? F0 : 0) - (mask_tzr ?
// F0 : 0) on d frac and 0 on d f. Both need one-hot and mask entries of 0
// and 1, as the models build them (exact comparisons and flag masks).
//
// Bound: double-precision operations. Per row and set the dd Horner, the
// transcendentals (cos, sin, log; the Kepler term ~40 more) and the lanes
// cost several hundred float64 operations against 96 bytes of row input and
// (3 + 2k) doubles of output: far above the ~10 flop/byte ridge of an H100
// in float64. The tape costs (n_slots) doubles a row and set, written once
// and read once per lane group.
#include "dd.cuh"
#include "k1_plan.h"

PINT_EXPORT_ERROR_STRING
PINT_EXPORT_K1_PLAN

namespace {

using namespace pint;

static_assert(k1::INVALID == static_cast<int>(cudaErrorInvalidValue), "the plan's refusal");
constexpr int LMAX = k1::LMAX;
constexpr int THREADS = 128;     // rows a block (primal, lane and finalize passes)
constexpr int TZR_THREADS = 64;  // (set, lane) pairs a block of the TZR pass
constexpr double TWO_PI = 6.283185307179586;  // 2.0 * math.pi
constexpr int NEWTON_ITERS = 10;               // binaries/kepler.py
constexpr int BIN_NONE = 0, BIN_ELL1 = 1, BIN_KEPLER = 2;
// Config::bin_model of the Kepler kind (DDS runs as DD) and of the ELL1 kind
constexpr int KEPLER_BT = 0, KEPLER_DDGR = 2, KEPLER_DDK = 3;  // 1 is DD (and DDS)
constexpr int ELL1_H = 1, ELL1_K = 2;                            // 0 is ELL1
constexpr int H_H3 = 0, H_H4 = 1, H_STIGMA = 2;  // Config::h_mode (ELL1H)
constexpr int MAX_FB = 8;                        // FB0 .. FB7
// the light-seconds per AU of pint_tpu's DDK parallax term (its literal)
constexpr double DDK_AU_LS = 499.00478384;
// tape slots before the chain's own: the row's phase (hi, lo)
constexpr int PHASE_SLOTS = 2;

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
// lane codes: residuals.py LANE_CODES holds the same list; L_DMX is the
// kernel lane of every DMX window (k1_plan.h)
enum : int {
  L_RAJ = 0, L_DECJ = 1, L_PMRA = 2, L_PMDEC = 3, L_PX = 4,
  L_PB = 5, L_A1 = 6, L_TASC = 7, L_EPS1 = 8, L_EPS2 = 9, L_F0 = 16, L_DM0 = 32,
  L_T0 = 48, L_ECC, L_OM, L_OMDOT, L_EDOT, L_GAMMA, L_PBDOT, L_A1DOT, L_M2, L_SINI,
  L_SHAPMAX, L_DR, L_DTH, L_A0, L_B0,
  L_FD0 = 64, L_JUMP0 = k1::L_JUMP0, L_DMX0 = k1::L_DMX0,
  L_FB0 = k1::L_FB0, L_H3 = L_FB0 + MAX_FB, L_H4, L_STIGMA, L_LNEDOT, L_KIN, L_KOM, L_MTOT,
  L_XOMDOT, L_XPBDOT, L_DMX = k1::L_DMX
};

struct Config {
  int n_rows;   // tensor rows, the TZR row included
  int n_out;    // data rows written
  int n_batch;  // parameter sets
  int has_tzr;  // AbsPhase: subtract the last row's phase
  int has_ast;  // astrometry (and with it the solar Shapiro delay)
  int nd;       // DM Taylor terms (0: no dispersion component)
  int nf;       // spin terms F0..F(nf-1)
  int n_par;    // parameter row length
  int n_lane;   // the caller's lanes (rows of dfrac and df)
  int bin_model;  // the kind's model: KEPLER_* or ELL1_*
  int ecliptic;   // the astrometry angles are ecliptic (NG instances)
  int n_dmx, n_fd, n_jump;  // DMX windows, FD terms, JUMPs (NG instances)
  int n_fb;       // FB terms (0: the PB form)
  int h_mode, nharms;  // ELL1H: H_* and the harmonics of its Shapiro series
  int has_dpn;    // add the rows' pulse offsets (-padd, -phase) before the rint
  int has_track;  // TRACK -2: subtract the rows' pulse numbers, no rint
  int n_klane, dmx_lane, n_slots;  // the plan's kernel lanes, L_DMX's index, tape slots
  int code[LMAX];                  // the kernel lanes' codes (-1 past n_klane)
  int pos[LMAX];                   // and their rows of dfrac and df
  int dmx_pos[k1::MAX_DMX];        // window j's row, or -1
  int jump_pos[k1::MAX_JUMP];      // the m-th JUMP's row, or -1
  double au_ls, dmconst, tsun, cos_obl, sin_obl;
};

// the tensor's rows; dmx and jump are one parameter set's row columns
struct Rows {
  const double *t_hi, *t_lo, *freq, *pos, *vel, *sun;
  const double *dmx, *jump, *onehot, *masks;
  const double *dpn, *track;  // data rows' pulse offsets and tracked pulse numbers
};

struct Out {
  double *pn, *frac, *f, *dfrac, *df, *fb;
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

// the lane codes of one thread's group, in registers
template <int K>
struct Lanes {
  int code[K > 0 ? K : 1];
};

// A row's tape: its expensive primal values, one slot each, `stride` (the
// tensor's rows) apart. K = 0, the primal pass, computes each value and
// stores it; K > 0, a lane pass, reads it back. Both meet the values in the
// same order: the chain's control flow depends on primal values only.
template <int K>
struct Tape {
  double *p;
  int stride;
  int slot;
};

// f() stored (K = 0) or read back (K > 0) through the read-only data path:
// the tape is complete before a pass that reads it starts, so ptxas may
// load a value again where it would otherwise hold or spill it
template <int K, typename F>
__device__ __forceinline__ double taped(Tape<K> &t, F f) {
  double *q = t.p + (size_t)t.slot++ * t.stride;
  if constexpr (K == 0) {
    const double v = f();
    *q = v;
    return v;
  } else {
    return __ldg(q);
  }
}

// sin x and cos x, two slots
template <int K>
__device__ __forceinline__ void taped_sincos(Tape<K> &t, double x, double &s, double &c) {
  double *q = t.p + (size_t)t.slot * t.stride;
  t.slot += 2;
  if constexpr (K == 0) {
    sincos(x, &s, &c);
    q[0] = s;
    q[t.stride] = c;
  } else {
    s = __ldg(q);
    c = __ldg(q + t.stride);
  }
}

// `v` seeded with 1 on the lane of this thread's group that carries `code`
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

// sin a and cos a from one taped pair: tangents cos(a) a' and -sin(a) a'
template <int K>
__device__ __forceinline__ void dsincos(Tape<K> &t, const Dual<K> &a, Dual<K> &s, Dual<K> &c) {
  double sv, cv;
  taped_sincos(t, a.v, sv, cv);
  s.v = sv;
  c.v = cv;
  const double msv = -sv;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    s.d[j] = cv * a.d[j];
    c.d[j] = msv * a.d[j];
  }
}

template <int K>
__device__ __forceinline__ Dual<K> dcos(Tape<K> &t, const Dual<K> &a) {
  Dual<K> s, c;
  dsincos(t, a, s, c);
  return c;
}

template <int K>
__device__ __forceinline__ Dual<K> dsin(Tape<K> &t, const Dual<K> &a) {
  Dual<K> s, c;
  dsincos(t, a, s, c);
  return s;
}

template <int K>
__device__ __forceinline__ Dual<K> dsqrt(Tape<K> &t, const Dual<K> &a) {
  Dual<K> r;
  r.v = taped(t, [&] { return __dsqrt_rn(a.v); });
  const double two_r = __dmul_rn(2.0, r.v);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = a.d[j] / two_r;
  return r;
}

// atan2(y, x), tangent y' x / (y^2 + x^2) - x' y / (y^2 + x^2)
template <int K>
__device__ __forceinline__ Dual<K> datan2(Tape<K> &t, const Dual<K> &y, const Dual<K> &x) {
  Dual<K> r;
  r.v = taped(t, [&] { return atan2(y.v, x.v); });
  const double den = __dadd_rn(__dmul_rn(y.v, y.v), __dmul_rn(x.v, x.v));
  const double gy = __ddiv_rn(x.v, den), gx = __ddiv_rn(-y.v, den);
#pragma unroll
  for (int j = 0; j < K; ++j) r.d[j] = y.d[j] * gy + x.d[j] * gx;
  return r;
}

template <int K>
__device__ __forceinline__ Dual<K> dlog(Tape<K> &t, const Dual<K> &a) {
  Dual<K> r;
  r.v = taped(t, [&] { return log(a.v); });
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
__device__ __forceinline__ Dual<K> ell1_dre(const Ell1Harmonics<K> &h, const Dual<K> &e1,
                                            const Dual<K> &e2, const Dual<K> &e1sq,
                                            const Dual<K> &e2sq, const Dual<K> &e1cu,
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
__device__ __forceinline__ Dual<K> ell1_drep(const Ell1Harmonics<K> &h, const Dual<K> &e1,
                                             const Dual<K> &e2, const Dual<K> &e1sq,
                                             const Dual<K> &e2sq, const Dual<K> &e1cu,
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
__device__ __forceinline__ Dual<K> ell1_drepp(const Ell1Harmonics<K> &h, const Dual<K> &e1,
                                              const Dual<K> &e2, const Dual<K> &e1sq,
                                              const Dual<K> &e2sq, const Dual<K> &e1cu,
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
__device__ __forceinline__ Dual<K> dipow(Dual<K> x, int y) {
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
__device__ __forceinline__ Orbit<K> orbit(double t_hi, double t_lo, const Dual<K> &dsf,
                                          const double *__restrict__ P, const Lanes<K> &lane,
                                          int epoch_lane, int n_fb, const double *jac) {
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
__device__ __forceinline__ Dual<K> ell1h_shapiro(Tape<K> &t, const Dual<K> &phi,
                                                 const Dual<K> &s1, const double *__restrict__ P,
                                                 const Lanes<K> &lane, const Config &c) {
  const Dual<K> h3 = dseed<K>(P[P_H3], lane, L_H3);
  if (c.h_mode == H_STIGMA) {
    // -2 H3 / stigma^3 log(1 + stigma^2 - 2 stigma sin phi)
    const Dual<K> sg = dseed<K>(P[P_STIGMA], lane, L_STIGMA);
    const Dual<K> lognum = dsub(dadd(dconst<K>(1.0), dmul(sg, sg)), dmul(dmulc(sg, 2.0), s1));
    const Dual<K> lg = dlog(t, lognum);
    return dmul(ddiv(dmulc(h3, -2.0), dmul(sg, dmul(sg, sg))), lg);
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
    Dual<K> sk, ck;
    dsincos(t, kphi, sk, ck);
    const Dual<K> basis = even ? ck : sk;
    total = dadd(total, dmul(dmulc(dipow(sg, k - 3), coef), basis));
  }
  return dmul(dmulc(h3, -2.0), total);
}

// The ELL1 family (binaries/engines.py ell1_delay, ell1h_delay, ell1k_delay)
// on the orbit `o`.
template <int K>
__device__ __forceinline__ Dual<K> ell1_term(Tape<K> &t, const Orbit<K> &o,
                                             const double *__restrict__ P, const Lanes<K> &lane,
                                             const Config &c) {
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
    Dual<K> sw, cw;
    dsincos(t, wdt, sw, cw);
    const Dual<K> growth = dadd(dconst<K>(1.0), dmul(lnedot, dt));
    const Dual<K> e1 = dmul(growth, dadd(dmul(e10, cw), dmul(e20, sw)));
    const Dual<K> e2 = dmul(growth, dsub(dmul(e20, cw), dmul(e10, sw)));
    Dual<K> c1;
    dsincos(t, phi, s1, c1);
    const Dual<K> p2 = dmulc(phi, 2.0);
    Dual<K> s2, c2;
    dsincos(t, p2, s2, c2);
    dre = dadd(s1, dmulc(dsub(dmul(e2, s2), dmul(e1, dadd(c2, dconst<K>(3.0)))), 0.5));
    drep = dadd(dadd(c1, dmul(e2, c2)), dmul(e1, s2));
    drepp = dadd(dsub(dneg(s1), t2(2.0, e2, s2)), t2(2.0, e1, c2));
  } else {
    // secular EPS1, EPS2 and ELL1's third-order expansion
    const Dual<K> e1 = dadd(dseed<K>(P[P_EPS1], lane, L_EPS1), dmulc(dt, P[P_EPS1DOT]));
    const Dual<K> e2 = dadd(dseed<K>(P[P_EPS2], lane, L_EPS2), dmulc(dt, P[P_EPS2DOT]));
    Ell1Harmonics<K> h;
    dsincos(t, phi, h.s1, h.c1);
    const Dual<K> p2 = dmulc(phi, 2.0), p3 = dmulc(phi, 3.0), p4 = dmulc(phi, 4.0);
    dsincos(t, p2, h.s2, h.c2);
    dsincos(t, p3, h.s3, h.c3);
    dsincos(t, p4, h.s4, h.c4);
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
  if (c.bin_model == ELL1_H) return dadd(delay_i, ell1h_shapiro<K>(t, phi, s1, P, lane, c));
  // Shapiro: -2 TSUN M2 log(1 - SINI sin phi)
  const Dual<K> tm2 = dmulc(dseed<K>(P[P_M2], lane, L_M2), c.tsun);
  const Dual<K> sini = dseed<K>(P[P_SINI], lane, L_SINI);
  const Dual<K> lg = dlog(t, dsub(dconst<K>(1.0), dmul(sini, s1)));
  const Dual<K> delay_s = dmul(dmulc(tm2, -2.0), lg);
  return dadd(delay_i, delay_s);
}

// Kepler's equation E - e sin E = M (binaries/kepler.py kepler_E): Danby's
// start and NEWTON_ITERS Newton steps on the primal doubles, in the twin's
// order (sign(0) = 0, as jnp.sign), in the primal pass alone; then one dual
// value from the implicit rule dE = (dM + sin E de) / (1 - e cos E), so no
// lane rides the loop. sin E and cos E come back as duals from the rule's
// own sine and cosine. E, sin E and cos E are three slots of the tape.
template <int K>
__device__ __forceinline__ Dual<K> kepler_E(Tape<K> &t, const Dual<K> &M, const Dual<K> &e,
                                            Dual<K> &sinE, Dual<K> &cosE) {
  const double ev = e.v;
  double E = 0.0, sE = 0.0, cE = 0.0;
  if constexpr (K == 0) {
    const double m = M.v;
    const double sm = sin(m);
    const double sg = sm > 0.0 ? 1.0 : sm < 0.0 ? -1.0 : sm;
    E = __dadd_rn(m, __dmul_rn(__dmul_rn(0.85, ev), sg));
    for (int it = 0; it < NEWTON_ITERS; ++it) {
      double s, c;
      sincos(E, &s, &c);
      const double f = __dsub_rn(__dsub_rn(E, __dmul_rn(ev, s)), m);
      const double fp = __dsub_rn(1.0, __dmul_rn(ev, c));
      E = __dsub_rn(E, __ddiv_rn(f, fp));
    }
    sincos(E, &sE, &cE);
  }
  E = taped(t, [&] { return E; });
  sE = taped(t, [&] { return sE; });
  cE = taped(t, [&] { return cE; });
  Dual<K> r;
  r.v = E;
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
__device__ __forceinline__ Dual<K> true_anomaly(Tape<K> &t, const Dual<K> &E, const Dual<K> &e) {
  const double n = rint(__ddiv_rn(E.v, TWO_PI));
  const double two_pi_n = __dmul_rn(TWO_PI, n);
  const Dual<K> Ec = dsub(E, dconst<K>(two_pi_n));
  const Dual<K> half = dmulc(Ec, 0.5);
  const Dual<K> rp = dsqrt(t, dadd(dconst<K>(1.0), e));
  Dual<K> sh, ch;
  dsincos(t, half, sh, ch);
  const Dual<K> y = dmul(rp, sh);
  const Dual<K> rm = dsqrt(t, dsub(dconst<K>(1.0), e));
  const Dual<K> x = dmul(rm, ch);
  const Dual<K> at = datan2(t, y, x);
  return dadd(dmulc(at, 2.0), dconst<K>(two_pi_n));
}

// DDK's per-row A1, OM and SINI (engines.py ddk_corrections): the proper
// motion drifts the inclination and turns the node over dt = t_hi - T0
// (plain float64, as pint_tpu); with astrometry, the parallax adds the
// site's position r in the (east, north) basis at the pulsar direction n,
// east = zhat x n / |zhat x n| and north = n x east (jnp.cross's order),
// over pint_tpu's literal DDK_AU_LS. out: A1, OM, SINI.
template <int K>
__device__ __forceinline__ void ddk_corrections(Tape<K> &t, double t_hi, const Dual<K> *n,
                                                bool has_ast, const double *r,
                                                const double *__restrict__ P,
                                                const Lanes<K> &lane, Dual<K> *out) {
  const Dual<K> kin0 = dseed<K>(P[P_KIN], lane, L_KIN), kom = dseed<K>(P[P_KOM], lane, L_KOM);
  Dual<K> skom, ckom;
  dsincos(t, kom, skom, ckom);
  const Dual<K> dt =
      dsub(dconst<K>(t_hi), dseed<K>(__dadd_rn(P[P_EPOCH_HI], P[P_EPOCH_LO]), lane, L_T0));
  const Dual<K> pmra = dseed<K>(P[P_PMRA], lane, L_PMRA);
  const Dual<K> pmdec = dseed<K>(P[P_PMDEC], lane, L_PMDEC);
  Dual<K> d_kin = dmul(dadd(dmul(dneg(pmra), skom), dmul(pmdec, ckom)), dt);
  const Dual<K> skin0 = dsin(t, kin0);
  Dual<K> dom = ddiv(dmul(dadd(dmul(pmra, ckom), dmul(pmdec, skom)), dt), skin0);
  if (has_ast) {
    // east = zhat x n: (0 n2 - 1 n1, 1 n0 - 0 n2, 0 n1 - 0 n0), normalized
    Dual<K> e[3] = {dsub(dmulc(n[2], 0.0), dmulc(n[1], 1.0)),
                    dsub(dmulc(n[0], 1.0), dmulc(n[2], 0.0)),
                    dsub(dmulc(n[1], 0.0), dmulc(n[0], 0.0))};
    const Dual<K> norm =
        dsqrt(t, dadd(dadd(dmul(e[0], e[0]), dmul(e[1], e[1])), dmul(e[2], e[2])));
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
  const Dual<K> skin_t = dsin(t, kin_t);
  out[0] = ddiv_jax(dmul(dseed<K>(P[P_A1], lane, L_A1), skin_t), skin0);
  out[1] = dadd(dseed<K>(P[P_OM], lane, L_OM), dom);
  out[2] = skin_t;
}

// BT (engines.py bt_delay) and DD (engines.py _dd_core) on the orbit `o`:
// DDS is DD with the host's SINI and its SHAPMAX seed; DDGR (`jac` given)
// DD with the host's derived values seeded by their Jacobian rows; DDK
// (`kop` given) DD with its per-row A1, OM and SINI.
template <int K>
__device__ __forceinline__ Dual<K> kepler_term(Tape<K> &t, const Orbit<K> &o,
                                               const double *__restrict__ P,
                                               const Lanes<K> &lane, int model, double tsun,
                                               const double *jac, const Dual<K> *kop) {
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
  const Dual<K> E = kepler_E(t, o.phi, e, sinE, cosE);
  if (model == KEPLER_BT) {
    const Dual<K> omega = dadd(om, dmul(omdot, o.dt));
    Dual<K> sw, cw;
    dsincos(t, omega, sw, cw);
    const Dual<K> root = dsqrt(t, dsub(one, dmul(e, e)));
    const Dual<K> a1sw = dmul(a1, sw), a1cwr = dmul(dmul(a1, cw), root);
    const Dual<K> L1 = dmul(a1sw, dsub(cosE, e));
    const Dual<K> L2 = dmul(dadd(a1cwr, gamma), sinE);
    const Dual<K> num = dsub(dmul(a1cwr, cosE), dmul(a1sw, sinE));
    const Dual<K> D =
        dsub(one, ddiv(dmulc(num, TWO_PI), dmul(dsub(one, dmul(e, cosE)), o.pb)));
    return dmul(dadd(L1, L2), D);
  }
  const Dual<K> nu = true_anomaly(t, E, e);
  const Dual<K> nu_full = dadd(nu, dconst<K>(__dmul_rn(TWO_PI, o.norb)));
  // omega = OM + k nu, k = OMDOT pb / 2 pi
  const Dual<K> k = ddivc(dmul(omdot, o.pb), TWO_PI);
  const Dual<K> omega = dadd(om, dmul(k, nu_full));
  Dual<K> sw, cw;
  dsincos(t, omega, sw, cw);
  const Dual<K> er = dmul(e, dadd(one, dpk<K>(P, P_DR, lane, L_DR, jac, J_DR)));
  const Dual<K> eth = dmul(e, dadd(one, dpk<K>(P, P_DTH, lane, L_DTH, jac, J_DTH)));
  const Dual<K> alpha = dmul(a1, sw);
  const Dual<K> reth = dsqrt(t, dsub(one, dmul(eth, eth)));
  const Dual<K> beta = dmul(dmul(a1, reth), cw);
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
  const Dual<K> re = dsqrt(t, dsub(one, dmul(e, e)));
  const Dual<K> orbit_s = dadd(dmul(sw, dsub(cosE, e)), dmul(dmul(re, cw), sinE));
  const Dual<K> arg = dsub(one_m_ecosE, dmul(sini, orbit_s));
  const Dual<K> lg = dlog(t, arg);
  const Dual<K> delay_s = dmul(dmulc(tm2, -2.0), lg);
  // aberration: A0 (sin(w + nu) + e sin w) + B0 (cos(w + nu) + e cos w)
  const Dual<K> wpnu = dadd(omega, nu_full);
  Dual<K> swn, cwn;
  dsincos(t, wpnu, swn, cwn);
  const Dual<K> delay_a = dadd(dmul(dseed<K>(P[P_A0], lane, L_A0), dadd(swn, dmul(e, sw))),
                               dmul(dseed<K>(P[P_B0], lane, L_B0), dadd(cwn, dmul(e, cw))));
  return dadd(dadd(delay_i, delay_s), delay_a);
}

// row i's phase and frequency; f_bary is stored to *fb_out when given (as
// soon as it is known, so that it holds no register through the row)
template <int K, int BIN, bool NG>
__device__ __forceinline__ RowPhase<K> eval_row(int i, const Rows &rows,
                                                const double *__restrict__ P, const Config &c,
                                                const Lanes<K> &lane, Tape<K> &t,
                                                double *fb_out) {
  const double t_hi = rows.t_hi[i], t_lo = rows.t_lo[i];
  Dual<K> total = dconst<K>(0.0);
  Dual<K> n[3];
  if (c.has_ast) {
    // pulsar direction with proper motion (astrometry.py pulsar_direction)
    const double dt = __dadd_rn(__dsub_rn(t_hi, P[P_POSEPOCH]), t_lo);
    const Dual<K> dec0 = dseed<K>(P[P_DECJ], lane, L_DECJ);
    const Dual<K> cdec0 = dcos(t, dec0);
    const Dual<K> ra = dadd(dseed<K>(P[P_RAJ], lane, L_RAJ),
                            ddiv(dmulc(dseed<K>(P[P_PMRA], lane, L_PMRA), dt), cdec0));
    const Dual<K> dec = dadd(dec0, dmulc(dseed<K>(P[P_PMDEC], lane, L_PMDEC), dt));
    Dual<K> sra, cra, cl;
    dsincos(t, ra, sra, cra);
    dsincos(t, dec, n[2], cl);
    n[0] = dmul(cl, cra);
    n[1] = dmul(cl, sra);
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
    const double rs = taped(t, [&] { return __dsqrt_rn(dot3c(s, s)); });
    const Dual<K> rcos = ddot3(s, n);
    const Dual<K> lg = dlog(t, ddivc(dsub(dconst<K>(rs), rcos), c.au_ls));
    const Dual<K> shap = dmulc(lg, -2.0 * c.tsun);
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
      // DMX: this set's window DM of the row, on the one lane of every window
      const Dual<K> dmx = dseed<K>(rows.dmx[i], lane, L_DMX);
      Dual<K> dmd = dconst<K>(0.0);
      if (isfinite(fb.v)) dmd = ddiv(dmulc(dmx, c.dmconst), dmul(fb, fb));
      total = dadd(total, dmd);
    }
    if (c.n_fd > 0) {
      // FD: Horner of FD_n .. FD_1 over log(f_bary / 1 GHz), zero where that
      // is not finite and positive
      const Dual<K> fg = ddivc(fb, 1e3);
      const bool finite = isfinite(fg.v) && fg.v > 0.0;
      const Dual<K> lf = finite ? dlog(t, fg) : dconst<K>(0.0);
      const int fd_base = P_DM0 + c.nd + 2 * c.nf;
      Dual<K> fd = dconst<K>(0.0);
      for (int k = c.n_fd; k >= 1; --k)
        fd = dmul(dadd(fd, dseed<K>(P[fd_base + k - 1], lane, L_FD0 + k)), lf);
      total = dadd(total, finite ? fd : dconst<K>(0.0));
    }
  }
  if constexpr (BIN == BIN_ELL1) {
    const Orbit<K> o = orbit<K>(t_hi, t_lo, total, P, lane, L_TASC, c.n_fb, nullptr);
    total = dadd(total, ell1_term<K>(t, o, P, lane, c));
  } else if constexpr (BIN == BIN_KEPLER) {
    const double *jac = c.bin_model == KEPLER_DDGR ? P + P_JAC : nullptr;
    const Orbit<K> o = orbit<K>(t_hi, t_lo, total, P, lane, L_T0, c.n_fb, jac);
    if (c.bin_model == KEPLER_DDK) {
      Dual<K> kop[3];
      ddk_corrections<K>(t, t_hi, n, c.has_ast, rows.pos + 3 * i, P, lane, kop);
      total = dadd(total, kepler_term<K>(t, o, P, lane, c.bin_model, c.tsun, nullptr, kop));
    } else {
      total = dadd(total, kepler_term<K>(t, o, P, lane, c.bin_model, c.tsun, jac, nullptr));
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
      // no kernel lane is a JUMP's: their columns are the closed form of
      // `finalize`
      const Dual<K> jp = dconst<K>(rows.jump[i]);
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

// this set's row columns (the DMX DM and the jump seconds)
__device__ __forceinline__ Rows set_rows(Rows rows, int b, const Config &c) {
  if (c.n_dmx > 0) rows.dmx += (size_t)b * c.n_rows;
  if (c.n_jump > 0) rows.jump += (size_t)b * c.n_rows;
  return rows;
}

// set b's tape: slot s of row i at tape[s * n_rows + i]
__device__ __forceinline__ double *tape_of(double *scratch, int b, const Config &c) {
  return scratch + (size_t)b * c.n_slots * c.n_rows;
}

// data row i of set b: the pulse number and fractional phase from the tape's
// phases (pint_tpu's phase_residual_frac: the TZR row's phase subtracted,
// the offsets added (xp.add_f), then the tracked pulse numbers subtracted,
// or the nearest pulse taken), and the JUMP columns in closed form
__device__ __forceinline__ void finalize(int i, int b, const Rows &rows,
                                         const double *__restrict__ P, const Config &c,
                                         const double *tape, const Out &o) {
  const int z = c.n_rows - 1;
  dd x{tape[i], tape[c.n_rows + i]};
  if (c.has_tzr) x = dd_add(x, dd_neg(dd{tape[z], tape[c.n_rows + z]}));
  if (c.has_dpn) x = dd_add_fp(x, rows.dpn[i]);
  double k;
  dd rem;
  if (c.has_track) {
    k = rows.track[i];
    rem = dd_add_fp(x, -k);
  } else {
    rem = dd_rint(x, k);
  }
  const size_t oi = (size_t)b * c.n_out + i;
  o.pn[oi] = k;
  o.frac[oi] = dd_to_float(rem);
  if (c.n_jump > 0) {
    const int f_base = P_DM0 + c.nd;
    const double f0 = __dadd_rn(P[f_base], P[f_base + 1]);
    for (int m = 0; m < c.n_jump; ++m) {
      const int p = c.jump_pos[m];
      if (p < 0) continue;
      const double *mask = rows.masks + (size_t)m * c.n_rows;
      double v = mask[i] != 0.0 ? f0 : 0.0;
      if (c.has_tzr) v = v - (mask[z] != 0.0 ? f0 : 0.0);
      const size_t oj = ((size_t)b * c.n_lane + p) * c.n_out + i;
      o.dfrac[oj] = v;
      o.df[oj] = 0.0;
    }
  }
}

// every DMX window's column at data row i of set b from the one DMX lane:
// g and gf its d frac and d f at the row, g_tzr its d frac at the TZR row
__device__ __forceinline__ void scatter_dmx(int i, int b, const Rows &rows, const Config &c,
                                            double g, double g_tzr, double gf, const Out &o) {
  const double *oh = rows.onehot + (size_t)i * c.n_dmx;
  const double *oz = rows.onehot + (size_t)(c.n_rows - 1) * c.n_dmx;
  for (int j = 0; j < c.n_dmx; ++j) {
    const int p = c.dmx_pos[j];
    if (p < 0) continue;
    const bool in = oh[j] != 0.0;
    double v = in ? g : 0.0;
    if (c.has_tzr) v = v - (oz[j] != 0.0 ? g_tzr : 0.0);
    const size_t oj = ((size_t)b * c.n_lane + p) * c.n_out + i;
    o.dfrac[oj] = v;
    o.df[oj] = in ? gf : 0.0;
  }
}

// pass 1: grid (row blocks, sets); every row, the TZR row included
template <int BIN, bool NG>
__global__ void __launch_bounds__(THREADS)
resid_primal(Rows rows, const double *__restrict__ params, Config c, double *__restrict__ f_out,
             double *__restrict__ fb_out, double *__restrict__ scratch) {
  const int b = blockIdx.y, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.n_rows) return;
  rows = set_rows(rows, b, c);
  double *tape = tape_of(scratch, b, c) + i;
  Tape<0> t{tape + (size_t)PHASE_SLOTS * c.n_rows, c.n_rows, 0};
  const Lanes<0> lane{};
  const RowPhase<0> r = eval_row<0, BIN, NG>(i, rows, params + (size_t)b * c.n_par, c, lane, t,
                                             fb_out + (size_t)b * c.n_rows + i);
  // k1_plan.h's tape_slots must count every value the chain stores: a chain
  // that stored more has written past its row's tape, and the call fails
  if (PHASE_SLOTS + t.slot > c.n_slots) __trap();
  tape[0] = r.ph.x.hi;
  tape[c.n_rows] = r.ph.x.lo;
  if (i < c.n_out) f_out[(size_t)b * c.n_out + i] = r.f.v;
}

// Programmatic dependent launch (Hopper): the lane pass, launched with
// cudaLaunchAttributeProgrammaticStreamSerialization, starts once every block
// of the TZR pass has called `let_dependents_start`, runs its rows' chains
// beside the TZR pass, and waits for it (`wait_for_primary`: its completion
// and its writes) only before it reads the TZR row's tangents. The tape it
// reads is the primal pass's, complete before the TZR pass started.
__device__ __forceinline__ void let_dependents_start() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.launch_dependents;");
#endif
}

__device__ __forceinline__ void wait_for_primary() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// pass 2: one thread per (set, kernel lane): the TZR row's d frac
template <int BIN, bool NG>
__global__ void __launch_bounds__(TZR_THREADS)
resid_tzr(Rows rows, const double *__restrict__ params, Config c, double *__restrict__ scratch,
          double *__restrict__ tz) {
  let_dependents_start();
  const int id = blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= c.n_batch * c.n_klane) return;
  const int b = id / c.n_klane, l = id % c.n_klane, z = c.n_rows - 1;
  rows = set_rows(rows, b, c);
  Tape<1> t{tape_of(scratch, b, c) + (size_t)PHASE_SLOTS * c.n_rows + z, c.n_rows, 0};
  const Lanes<1> lane{{c.code[l]}};
  tz[id] = eval_row<1, BIN, NG>(z, rows, params + (size_t)b * c.n_par, c, lane, t, nullptr)
               .ph.d[0];
}

// registers a thread of the lane pass may hold: 4 blocks of THREADS (16
// warps) an SM
constexpr int LANE_MIN_BLOCKS = 4;

// pass 3: grid (row blocks, sets, lane groups of K)
template <int K, int BIN, bool NG>
__global__ void __launch_bounds__(THREADS, LANE_MIN_BLOCKS)
resid_lanes(Rows rows, const double *__restrict__ params, Config c, Out o,
            double *__restrict__ scratch, const double *__restrict__ tz) {
  const int b = blockIdx.y, g = blockIdx.z, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.n_out) return;
  rows = set_rows(rows, b, c);
  const double *P = params + (size_t)b * c.n_par;
  double *tape = tape_of(scratch, b, c);
  if (g == 0) finalize(i, b, rows, P, c, tape, o);
  const int lb = g * K;
  Lanes<K> lane;
#pragma unroll
  for (int j = 0; j < K; ++j) lane.code[j] = c.code[lb + j];
  Tape<K> t{tape + (size_t)PHASE_SLOTS * c.n_rows + i, c.n_rows, 0};
  const RowPhase<K> r = eval_row<K, BIN, NG>(i, rows, P, c, lane, t, nullptr);
  wait_for_primary();
  const double *tzb = tz + (size_t)b * c.n_klane;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int l = lb + j;
    if (l >= c.n_klane) break;
    if (l == c.dmx_lane) {
      scatter_dmx(i, b, rows, c, r.ph.d[j], c.has_tzr ? tzb[l] : 0.0, r.f.d[j], o);
      continue;
    }
    const size_t oj = ((size_t)b * c.n_lane + c.pos[l]) * c.n_out + i;
    o.dfrac[oj] = c.has_tzr ? r.ph.d[j] - tzb[l] : r.ph.d[j];
    o.df[oj] = r.f.d[j];
  }
}

// pass 3 without kernel lanes: grid (row blocks, sets)
__global__ void __launch_bounds__(THREADS)
resid_finalize(Rows rows, const double *__restrict__ params, Config c, Out o,
               double *__restrict__ scratch) {
  const int b = blockIdx.y, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.n_out) return;
  rows = set_rows(rows, b, c);
  finalize(i, b, rows, params + (size_t)b * c.n_par, c, tape_of(scratch, b, c), o);
}

template <int BIN, bool NG>
cudaError_t launch(const Rows &rows, const double *params, const Config &c, const k1::Plan &plan,
                   const Out &o, double *scratch, cudaStream_t s) {
  const dim3 primal((c.n_rows + THREADS - 1) / THREADS, c.n_batch);
  resid_primal<BIN, NG><<<primal, THREADS, 0, s>>>(rows, params, c, o.f, o.fb, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 data((c.n_out + THREADS - 1) / THREADS, c.n_batch, plan.groups);
  if (c.n_klane == 0) {
    resid_finalize<<<data, THREADS, 0, s>>>(rows, params, c, o, scratch);
    return cudaGetLastError();
  }
  const double *tz = scratch + (size_t)c.n_batch * c.n_slots * c.n_rows;
  if (c.has_tzr) {
    const int n = c.n_batch * c.n_klane;
    resid_tzr<BIN, NG><<<(n + TZR_THREADS - 1) / TZR_THREADS, TZR_THREADS, 0, s>>>(
        rows, params, c, scratch, scratch + (size_t)c.n_batch * c.n_slots * c.n_rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  // after the TZR pass, a programmatic dependent of it
  cudaLaunchAttribute after_tzr;
  after_tzr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  after_tzr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = data;
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cfg.attrs = &after_tzr;
  cfg.numAttrs = c.has_tzr ? 1 : 0;
  if (plan.width == 1)
    return cudaLaunchKernelEx(&cfg, resid_lanes<1, BIN, NG>, rows, params, c, o, scratch, tz);
  return cudaLaunchKernelEx(&cfg, resid_lanes<k1::DEFAULT_WIDTH, BIN, NG>, rows, params, c, o,
                            scratch, tz);
}

template <int BIN>
cudaError_t launch_kind(bool ng, const Rows &rows, const double *params, const Config &c,
                        const k1::Plan &plan, const Out &o, double *scratch, cudaStream_t s) {
  return ng ? launch<BIN, true>(rows, params, c, plan, o, scratch, s)
            : launch<BIN, false>(rows, params, c, plan, o, scratch, s);
}

}  // namespace

// ints (k1_plan.h I_*): n_rows n_out has_tzr has_ast nd nf n_par k bin_kind
// bin_model ecliptic n_dmx n_fd n_jump n_fb h_mode nharms lane[0..LMAX)
// has_dpn has_track (bin_kind: 0 none, 1 ELL1, 2 Kepler; bin_model: ELL1_*
// or KEPLER_*; n_fb: 0 for the PB form)
// consts: au_ls dmconst tsun cos_obl sin_obl
// dmx, jump (n_batch, n_rows): each set's DMX DM and jump seconds per row;
// onehot (n_rows, n_dmx), masks (n_jump, n_rows): the DMX windows and the
// JUMP masks, entries 0 or 1 (each a single zero when its term is absent);
// dpn, track (n_out,): the data rows' pulse offsets and TRACK -2 pulse
// numbers (read only when has_dpn, has_track)
// dfrac, df: (n_batch, k, n_out), the lanes in the caller's order; fb
// (n_batch, n_rows); scratch: resid_tangent_plan's `scratch` doubles
extern "C" int resid_tangent(const double *t_hi, const double *t_lo, const double *freq,
                             const double *pos, const double *vel, const double *sun,
                             const double *dmx, const double *jump, const double *onehot,
                             const double *masks, const double *dpn, const double *track,
                             const double *params, int n_batch,
                             const int *ints, const double *consts, double *pn, double *frac,
                             double *f, double *dfrac, double *df, double *fb, double *scratch,
                             void *stream) {
  k1::Plan plan;
  if (k1::plan_of(ints, n_batch, plan) != 0) return static_cast<int>(cudaErrorInvalidValue);
  Config c;
  c.n_rows = ints[k1::I_ROWS];
  c.n_out = ints[k1::I_OUT];
  c.n_batch = n_batch;
  c.has_tzr = ints[k1::I_TZR];
  c.has_ast = ints[k1::I_AST];
  c.nd = ints[k1::I_ND];
  c.nf = ints[k1::I_NF];
  c.n_par = ints[k1::I_NPAR];
  c.n_lane = ints[k1::I_K];
  const int bin_kind = ints[k1::I_BIN_KIND];
  c.bin_model = ints[k1::I_BIN_MODEL];
  c.ecliptic = ints[k1::I_ECLIPTIC];
  c.n_dmx = ints[k1::I_DMX];
  c.n_fd = ints[k1::I_FD];
  c.n_jump = ints[k1::I_JUMP];
  c.n_fb = ints[k1::I_FB];
  c.h_mode = ints[k1::I_HMODE];
  c.nharms = ints[k1::I_NHARMS];
  if (c.n_par != P_DM0 + c.nd + 2 * c.nf + c.n_fd || (c.has_tzr && c.n_rows != c.n_out + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  c.has_dpn = ints[k1::I_DPN];
  c.has_track = ints[k1::I_TRACK];
  c.n_klane = plan.n_klane;
  c.dmx_lane = plan.dmx_lane;
  c.n_slots = plan.n_slots;
  for (int l = 0; l < LMAX; ++l) {
    c.code[l] = plan.code[l];
    c.pos[l] = plan.pos[l];
  }
  for (int j = 0; j < k1::MAX_DMX; ++j) c.dmx_pos[j] = plan.dmx_pos[j];
  for (int m = 0; m < k1::MAX_JUMP; ++m) c.jump_pos[m] = plan.jump_pos[m];
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
    e = launch_kind<BIN_ELL1>(ng, rows, params, c, plan, o, scratch, s);
  else if (bin_kind == BIN_KEPLER)
    e = launch_kind<BIN_KEPLER>(ng, rows, params, c, plan, o, scratch, s);
  else
    e = launch_kind<BIN_NONE>(ng, rows, params, c, plan, o, scratch, s);
  return static_cast<int>(e);
}

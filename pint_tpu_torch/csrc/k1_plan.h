// The lane plan of kernel K1 (resid_tangent.cu): how a call's tangent lanes,
// given as lane codes in the caller's order, become the kernel's lanes, where
// each lane's output goes, how many lanes a thread carries, and the scratch a
// call needs. This file is the one owner of those numbers: the kernel launches
// at the plan it gives, and its wrapper (residuals.py) asks it, through the
// exported resid_tangent_plan, for the scratch to allocate. Plain host C++: it
// also compiles without nvcc.
//
// Classes of lanes:
//   dense: every lane but the two below, one kernel lane each;
//   DMX:   the lanes 128 + j. Each is seeded with the row's one-hot entry
//          (0 or 1), and a lane's tangent is linear in its own seed, so lane
//          j's value at row i is onehot[i, j] g_i, with g_i the tangent of one
//          lane seeded 1. All of them are ONE kernel lane (L_DMX), after the
//          dense ones; the kernel writes each window's column from it;
//   JUMP:  the lanes 80 + m, F0 times the row's mask in closed form on
//          d frac (0 on d f), written by the kernel without a lane.
// Every window or JUMP the caller asks for twice is refused.
#pragma once

namespace pint {
namespace k1 {

constexpr int LMAX = 128;      // lanes of one call
constexpr int MAX_DMX = 128;   // DMX windows a lane code can name
constexpr int MAX_JUMP = 48;   // phase JUMPs a lane code can name
constexpr int L_JUMP0 = 80, L_DMX0 = 128, L_FB0 = 256;  // resid_tangent.cu's L_* codes
constexpr int L_DMX = 511;     // the kernel lane of every DMX window
constexpr int INVALID = 1;     // the refusal: cudaErrorInvalidValue
// lanes a thread of the lane pass carries: the plan takes 2, or 1 for a
// single kernel lane, and the kernel has those two instances. Measured on
// the H100 (k1_passes.py --widths, which builds copies of this header with
// another width), 2 lanes at 128 registers, 16 warps an SM, was fastest or
// within a few per cent of the fastest at the main path's grids, where K1
// costs the most; 1 lane does not spill but repeats the lane-free
// arithmetic for every lane, 4 lanes spill more, and 168 or 255 registers
// hold fewer warps.
constexpr int DEFAULT_WIDTH = 2;

// the layout of `ints`, the wrapper's integer arguments
enum : int {
  I_ROWS = 0, I_OUT, I_TZR, I_AST, I_ND, I_NF, I_NPAR, I_K, I_BIN_KIND, I_BIN_MODEL,
  I_ECLIPTIC, I_DMX, I_FD, I_JUMP, I_FB, I_HMODE, I_NHARMS, I_LANE,
  I_DPN = I_LANE + LMAX, I_TRACK, I_COUNT
};

struct Plan {
  int n_klane;             // kernel lanes: the dense ones in the caller's order, then L_DMX
  int width, groups;       // lanes a thread carries; threads a row and set (at least 1)
  int dmx_lane;            // L_DMX's index among the kernel lanes, or -1
  int n_slots;             // doubles of scratch a row and set: the tape
  int code[LMAX];          // kernel lane codes; -1 past n_klane up to groups * width
  int pos[LMAX];           // the caller's index of each kernel lane (L_DMX: -1)
  int dmx_pos[MAX_DMX];    // the caller's index of window j's lane, or -1
  int jump_pos[MAX_JUMP];  // the caller's index of the m-th JUMP's lane, or -1
  long long scratch;       // doubles: the tape (B, n_slots, n_rows), then tz (B, n_klane)
};

// The tape: the doubles the primal pass stores per row and set for the lane
// passes, which read them back instead of computing them (resid_tangent.cu
// Tape): the row's phase (hi, lo), then each sine and cosine pair, log,
// square root, atan2 and Kepler's (E, sin E, cos E) in the order the chain
// meets them, counted here at their most per model.
inline int tape_slots(int has_ast, int n_fd, int bin_kind, int bin_model, int h_mode,
                      int nharms) {
  int n = 2;                      // the phase
  if (has_ast) n += 2 + 2 + 2 + 1 + 1;  // cos dec0, (ra), (dec); Shapiro's log; |s|
  if (n_fd > 0) n += 1;           // log(f_bary / 1 GHz)
  if (bin_kind == 1) {            // the ELL1 family
    if (bin_model == 2) {
      n += 2 + 2 + 2 + 1;         // ELL1K: (omdot dt), (phi), (2 phi); the Shapiro log
    } else {
      n += 8;                     // (phi) .. (4 phi)
      if (bin_model == 0) n += 1;                   // ELL1: the Shapiro log
      else if (h_mode == 2) n += 1;                 // ELL1H's exact form: its log
      else n += 2 * (nharms > 2 ? nharms - 2 : 0);  // ELL1H: (k phi), k = 3 .. nharms
    }
  } else if (bin_kind == 2) {     // a Kepler orbit
    n += 3;                       // E, sin E, cos E
    if (bin_model == 0) {
      n += 2 + 1;                 // BT: (omega), sqrt(1 - e^2)
    } else {
      n += 1 + 2 + 1 + 1;         // the true anomaly: two roots, (E / 2), atan2
      n += 2 + 1 + 1 + 1 + 2;     // (omega), two roots, the Shapiro log, (omega + nu)
      if (bin_model == 3) n += 2 + 2 + 1 + 2;  // DDK: (KOM), (KIN), |east|, (kin)
    }
  }
  return n;
}

// The plan of the call `ints` over n_batch parameter sets: 0, or INVALID for
// arguments the kernel does not take (the checks of resid_tangent()).
inline int plan_of(const int *ints, int n_batch, Plan &p) {
  const int n_rows = ints[I_ROWS], n_out = ints[I_OUT], k = ints[I_K];
  const int bin_kind = ints[I_BIN_KIND], bin_model = ints[I_BIN_MODEL];
  const int n_dmx = ints[I_DMX], n_fd = ints[I_FD], n_jump = ints[I_JUMP];
  const int n_fb = ints[I_FB], h_mode = ints[I_HMODE], nharms = ints[I_NHARMS];
  const int n_models = bin_kind == 1 ? 3 : bin_kind == 2 ? 4 : 1;
  if (k < 0 || k > LMAX || ints[I_NF] < 1 || ints[I_ND] < 0 || ints[I_ND] > 16 || n_out < 0 ||
      n_rows < n_out || n_batch < 1 || n_batch > 65535 || n_fd < 0 || n_fd > 15 || n_dmx < 0 ||
      n_jump < 0 || bin_kind < 0 || bin_kind > 2 || bin_model < 0 || bin_model >= n_models ||
      n_fb < 0 || n_fb > 8 || h_mode < 0 || h_mode > 2 || nharms < 0 || nharms > 20 ||
      (bin_model == 3 && bin_kind == 2 && ints[I_ECLIPTIC]))
    return INVALID;
  for (int j = 0; j < MAX_DMX; ++j) p.dmx_pos[j] = -1;
  for (int m = 0; m < MAX_JUMP; ++m) p.jump_pos[m] = -1;
  p.n_klane = 0;
  p.dmx_lane = -1;
  for (int l = 0; l < k; ++l) {
    const int code = ints[I_LANE + l];
    if (code >= L_DMX0 && code < L_FB0) {  // a window's lane
      const int j = code - L_DMX0;
      if (j >= n_dmx || p.dmx_pos[j] >= 0) return INVALID;
      p.dmx_pos[j] = l;
      p.dmx_lane = 0;
    } else if (code >= L_JUMP0 && code < L_DMX0) {  // a JUMP's lane
      const int m = code - L_JUMP0;
      if (m >= n_jump || p.jump_pos[m] >= 0) return INVALID;
      p.jump_pos[m] = l;
    } else {
      p.code[p.n_klane] = code;
      p.pos[p.n_klane++] = l;
    }
  }
  if (p.dmx_lane == 0) {
    p.dmx_lane = p.n_klane;
    p.code[p.n_klane] = L_DMX;
    p.pos[p.n_klane++] = -1;
  }
  p.width = p.n_klane > 1 ? DEFAULT_WIDTH : 1;
  p.groups = p.n_klane > 0 ? (p.n_klane + p.width - 1) / p.width : 1;
  for (int l = p.n_klane; l < LMAX; ++l) {
    p.code[l] = -1;
    p.pos[l] = -1;
  }
  p.n_slots = tape_slots(ints[I_AST], n_fd, bin_kind, bin_model, h_mode, nharms);
  p.scratch = (long long)n_batch * p.n_slots * n_rows + (long long)n_batch * p.n_klane;
  return 0;
}

}  // namespace k1
}  // namespace pint

// Every library that launches K1 exports its plan; so does the test's host
// build of this header.
#define PINT_EXPORT_K1_PLAN                                                        \
  extern "C" int resid_tangent_plan(const int *ints, int n_batch, pint::k1::Plan *out) { \
    return pint::k1::plan_of(ints, n_batch, *out);                                 \
  }

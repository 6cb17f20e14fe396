// The layout of the backward kernels K9 (noise_grad.cu) and K10 (pta_grad.cu)
// on the design of grad_tiles.cuh: the padded widths, each pass's warps and
// shared memory, the scratch, and the limits of the shapes they take. This
// file is the one owner of those numbers: the kernels launch at the plan it
// gives, and their wrappers (fitting/grad_plan.py) ask it, through the
// exported noise_grad_plan and pta_grad_plan, for the scratch to allocate
// and for the limit a refused shape exceeds. Plain C++: it also compiles
// without nvcc.
#pragma once

#ifdef __CUDACC__
#define PINT_HD __host__ __device__
#else
#define PINT_HD
#endif

namespace pint {
namespace grad {

constexpr int SLOT = 16;    // fragments a ring slot holds (8 KB)
constexpr int STAGES = 4;   // ring slots: a step reads at most 2, 2 more are in flight
constexpr int FRAG = 64;    // doubles of one B fragment
constexpr int MAX_N1T = 12;      // value columns: at most 96 (the instances 3, 6, 12 n tiles)
constexpr int MAX_FACTOR = 120;  // a factor inverted in shared memory: at most 120 square
constexpr long SMEM_MAX = 232448;  // bytes of shared memory a block may use (H100)
constexpr long MAX_SETS = 65535;   // a grid's y extent

PINT_HD constexpr int round8(int x) { return (x + 7) / 8 * 8; }

// The widths of one kernel call. f2: product 2 present (its F2, like F3, is
// upper triangular: the k tiles below the diagonal are zero and skipped).
struct Dims {
  int n1, kd;
  bool f2;
  PINT_HD constexpr int n1p() const { return round8(n1); }
  PINT_HD constexpr int n1t() const { return n1p() / 8; }
  PINT_HD constexpr int kdp() const { return round8(kd); }
  PINT_HD constexpr int k1t() const { return kdp() / 8; }
  PINT_HD constexpr int f1() const { return k1t() * n1t(); }
  PINT_HD constexpr int f2n() const { return f2 ? n1t() * (n1t() + 1) / 2 : 0; }
  PINT_HD constexpr int f3() const { return k1t() * (k1t() + 1) / 2; }
  PINT_HD constexpr int panel() const { return f1() + f2n() + f3(); }
};

// K9: value columns [Mn | r], product 2 (K^-T) when the timing parameters
// are marginalized; K10: the q columns of X = [Mn, G, r], product 2 Gbar.
PINT_HD constexpr Dims noise_dims(int p, int kd, int marg) {
  return Dims{p + 1, kd, marg != 0 && p > 0};
}
PINT_HD constexpr Dims pta_dims(int q, int kd) { return Dims{q, kd, true}; }

// A call's scratch over S sets (doubles, in this order): the panels (S,
// panel, FRAG); F1's plain rows (S, kd, n1p), the dense columns' values in
// pass 2; and, with epochs, per set and epoch (one more, zero, for rows
// without one) the values E (n1p), Bn (kdp) and 1/De.
struct Scratch {
  double *panels, *f1p, *eacc, *bn, *inv;
};

struct ScratchLayout {
  long panels, f1p, eacc, bn, inv, end;
};

PINT_HD inline ScratchLayout scratch_layout(const Dims &d, long S, int ke) {
  ScratchLayout o;
  o.panels = 0;
  o.f1p = o.panels + S * d.panel() * FRAG;
  o.eacc = o.f1p + S * d.kd * d.n1p();
  o.bn = o.eacc + (ke ? S * (ke + 1) * d.n1p() : 0);
  o.inv = o.bn + (ke ? S * (ke + 1) * d.kdp() : 0);
  o.end = o.inv + (ke ? S * (ke + 1) : 0);
  return o;
}

PINT_HD inline Scratch scratch_of(double *base, const Dims &d, long S, int ke) {
  const ScratchLayout o = scratch_layout(d, S, ke);
  return Scratch{base + o.panels, base + o.f1p, base + o.eacc, base + o.bn, base + o.inv};
}

// Shared memory of a tile pass with `warps` warps: the ring, the tile of
// R = 16 warps rows of n1p + kdp columns (column stride R + 2: conflict-free
// fragment loads), and R row scales.
PINT_HD constexpr long tile_smem(const Dims &d, int warps) {
  return 8L * ((long)STAGES * SLOT * FRAG + (d.n1p() + d.kdp()) * (16L * warps + 2) + 16L * warps);
}

// Shared memory of pass 1: L then F (max(kd^2, kd n1p)), L^-1 and 1/L_ii
// (kd^2 + kd); K9 (pk = p when product 2 is present) also K, K^-1 and
// 1/K_ii (2 p^2 + p), in another block.
PINT_HD constexpr long lmax(long a, long b) { return a > b ? a : b; }
PINT_HD constexpr long factor_smem(const Dims &d, int pk) {
  return 8L * lmax(2L * pk * pk + pk, d.kd * lmax(d.kd, d.n1p()) + (long)d.kd * d.kd + d.kd);
}

// At the limits one warp's tile and pass 1 fit: a shape within them never
// runs out of shared memory.
static_assert(tile_smem(Dims{8 * MAX_N1T, MAX_FACTOR, true}, 1) <= SMEM_MAX, "a tile fits");
static_assert(factor_smem(Dims{8 * MAX_N1T, MAX_FACTOR, true}, 8 * MAX_N1T - 1) <= SMEM_MAX,
              "pass 1 fits");
static_assert(2 * MAX_FACTOR <= 256 && 8 * MAX_N1T <= 128, "pass 1's 256 threads: two a column");

// The most warps (8, 4, 2, 1) whose tile fits in shared memory, no more
// than `rows` rows need.
inline int tile_warps(const Dims &d, long rows) {
  const long need = rows > 16 ? (rows + 15) / 16 : 1;
  for (int w = 8; w > 1; w /= 2)
    if (w <= need && tile_smem(d, w) <= SMEM_MAX) return w;
  return 1;
}

// One call's plan.
struct Plan {
  long scratch;  // doubles
  int basis_warps, row_warps;
  long smem_factors, smem_basis, smem_rows;  // bytes
  int panel;                                 // B fragments a set
};
constexpr int PLAN_FIELDS = 7;

// Why a shape is refused (0: it is taken); `why` gets the limit and the
// value that exceeds it.
enum Refusal { TAKEN = 0, NO_ROWS, NEGATIVE, VALUES, FACTOR, SETS, PULSARS };

inline int refuse(Refusal r, long limit, long got, long long *why) {
  why[0] = limit;
  why[1] = got;
  return r;
}

inline int plan_of(const Dims &d, int n, int ke, long S, int pk, Plan &pl, long long *why) {
  if (n < 1) return refuse(NO_ROWS, 1, n, why);
  if (ke < 0 || d.kd < 0 || d.n1 < 1)
    return refuse(NEGATIVE, 0, ke < 0 ? ke : d.kd < 0 ? d.kd : d.n1 - 1, why);
  if (d.n1t() > MAX_N1T) return refuse(VALUES, 8L * MAX_N1T, d.n1, why);
  if (d.kd > MAX_FACTOR) return refuse(FACTOR, MAX_FACTOR, d.kd, why);
  if (S < 1 || S > MAX_SETS) return refuse(SETS, MAX_SETS, S, why);
  pl.basis_warps = tile_warps(d, (long)ke + d.kd);
  pl.row_warps = tile_warps(d, n);
  pl.smem_factors = factor_smem(d, pk);
  pl.smem_basis = tile_smem(d, pl.basis_warps);
  pl.smem_rows = tile_smem(d, pl.row_warps);
  pl.panel = d.panel();
  pl.scratch = scratch_layout(d, S, ke).end;
  return TAKEN;
}

// K9 at n rows, p timing columns, ke epochs, kd dense columns and E weight
// sets.
inline int noise_plan(int n, int p, int ke, int kd, int E, int marg, Plan &pl, long long *why) {
  const Dims d = noise_dims(p, kd, marg);
  return plan_of(d, n, ke, E, d.f2 ? p : 0, pl, why);
}

// K10 at n bucket rows of npsr pulsars, q = p + m + 1 value columns, ke
// epochs and kd dense columns a pulsar, and E points (E npsr sets).
inline int pta_plan(int n, int npsr, int q, int ke, int kd, int E, Plan &pl, long long *why) {
  if (npsr < 1 || npsr > MAX_SETS) return refuse(PULSARS, MAX_SETS, npsr, why);
  return plan_of(pta_dims(q, kd), n, ke, (long)E * npsr, 0, pl, why);
}

inline int plan_out(int rc, const Plan &pl, long long *out) {
  if (rc) return rc;  // out[0], out[1]: the limit and the value
  const long long v[PLAN_FIELDS] = {pl.scratch,      pl.basis_warps, pl.row_warps, pl.smem_factors,
                                    pl.smem_basis,   pl.smem_rows,   pl.panel};
  for (int k = 0; k < PLAN_FIELDS; ++k) out[k] = v[k];
  return 0;
}

}  // namespace grad
}  // namespace pint

// The plans as a library exports them: 0 and out = {scratch doubles, basis
// warps, row warps, shared bytes of passes 1, 2 and 3, fragments a set's
// panel}, or a Refusal with out = {limit, value}.
#define PINT_EXPORT_GRAD_PLANS                                                                 \
  extern "C" int noise_grad_plan(int n, int p, int ke, int kd, int E, int marg,                \
                                 long long *out) {                                             \
    pint::grad::Plan pl;                                                                       \
    return pint::grad::plan_out(pint::grad::noise_plan(n, p, ke, kd, E, marg, pl, out), pl,    \
                                out);                                                          \
  }                                                                                            \
  extern "C" int pta_grad_plan(int n, int npsr, int q, int ke, int kd, int E, long long *out) { \
    pint::grad::Plan pl;                                                                       \
    return pint::grad::plan_out(pint::grad::pta_plan(n, npsr, q, ke, kd, E, pl, out), pl,      \
                                out);                                                          \
  }

// The design shared by the two closed-form backward kernels K9 (noise_grad.cu)
// and K10 (pta_grad.cu): row tiles staged once for every set that shares
// them, their products on the float64 tensor cores, fixed-order sums.
//
// Both gradients are, per row of the data (and per basis column), three small
// matrix products and a few quadratic forms. With N1 "value" columns (K9: Mn
// and r, N1 = p + 1; K10: X = [Mn, G, r], N1 = q) and kd dense basis columns:
//   product 1: P = A F1    (A the row's kd basis values, F1 kd x N1)
//   value:     U = (X - E[epoch]) - P   (a data row), or (X - P) s  (a basis
//              row: an epoch's sums scaled by s = 1/De, or a dense column)
//   product 2: Z = U F2    (F2 N1 x N1, upper: K9's K^-T, K10's Gbar folded)
//              K9 sums Z^2, K10 sums Z . U per row;
//   product 3: Y = H F3    (F3 = L^-T, upper; H = A - Bn[epoch] for a data
//              row, A s for an epoch, the unit vector for a dense column),
//              summed as Y^2.
// The kernels' own .cu files say what F1, F2, X, A and the sums are.
//
// Passes (one stream, in order):
//   1. factors (one block per set and factor group): L^-1 (and K9's K^-1)
//      by substitution in shared memory, K9's g_d = L^-T Wz and ahat_d, K10's
//      Ahat_d = L^-T Wz, then each set's "panel": F1, F2 and F3 cut into
//      m16n8k8 B fragments in the order the warps consume them (64 doubles a
//      fragment, lane l's two values side by side: a warp loads a fragment as
//      one 16-byte load a lane);
//   2. basis (one block per R basis rows of one set): the epochs' and dense
//      columns' rows through the three products, their d/dphi, and the
//      epochs' E, Bn and 1/De rows for pass 3;
//   3. rows (one block per R rows; K10: of one pulsar): the block stages its
//      R rows of [X | A] once in shared memory (column-major, threads on
//      consecutive rows: coalesced loads), then runs every set that shares
//      them (K9's E sets, K10's E sets of its pulsar) through the products,
//      d/dw per row.
// A warp owns 16 rows (one m16 tile) of one set at a time; the block's
// warps run the same sets in step. The sets' panels stream through a ring
// of STAGES slots of SLOT fragments in shared memory (cp.async, 2 slots in
// flight), so a factor of any width passes in pieces: no set's factors need
// to fit whole (K9's K^-T, L^-T and g_d at kd = 120 are 180 KB a set). A
// step (one k tile) loads all its B fragments before its products, which
// run unconditionally (a tile a step does not have gets zero B). The passes
// are bound by the latency of the work around the products rather than by
// the tensor cores, so the narrow instances (3 n tiles) keep to 128
// registers: two blocks an SM.
//
// Fragment order. A product's A operand comes either from the tile or from
// the previous product's accumulators. mma.sync's accumulator layout gives a
// lane the columns 2 ti and 2 ti + 1 of an n tile, its A layout the k
// columns ti and ti + 4; both products therefore use the k order in which A
// slot ti is column 2 ti and slot ti + 4 is column 2 ti + 1, and the panel's
// B fragments follow it: lane (gi, ti) of fragment (kk, jn) holds
// F[8 kk + 2 ti][8 jn + gi], F[8 kk + 2 ti + 1][8 jn + gi]. Then U feeds
// product 2 straight from registers, and every A value a lane loads from
// the tile is two neighbouring columns of its two rows.
//
// Sums. A row's sums run over its columns in a fixed order within each lane
// (n tiles ascending), then over the four lanes of its group by two xor
// shuffles: no atomics, no shared-memory reduction, no __syncwarp per row,
// and two calls on the same inputs are bitwise equal (ROADMAP C3).
#pragma once

#include <cuda_runtime.h>

#include "grad_plan.h"
#include "mma_f64.cuh"

namespace pint {
namespace grad {

constexpr int NG = 4;  // n tiles a group of products 2 and 3 accumulates at once
constexpr int FACTOR_THREADS = 256;

// --- the ring of panel fragments ----------------------------------------------

// A block's stream of fragments: the panels of sets set0 + e stride, e <
// nsets, one after another, P fragments each. `f` is the next fragment a
// step reads, `cur` the last slot made ready.
struct Ring {
  double *buf;
  const double *panels;
  int P, set0, stride, total, cur, f;
};

__device__ __forceinline__ void ring_load(const Ring &r, int c) {
  const int first = c * SLOT, cnt = min(SLOT, r.total - first);
  double *dst = r.buf + (size_t)(c % STAGES) * SLOT * FRAG;
  for (int k = threadIdx.x; k < cnt * 32; k += blockDim.x) {
    const int fi = first + k / 32, e = fi / r.P, j = fi - e * r.P;
    cp_async16(dst + 2 * k,
               r.panels + ((size_t)(r.set0 + e * r.stride) * r.P + j) * FRAG + (k % 32) * 2);
  }
}

__device__ __forceinline__ void ring_start(Ring &r) {
  r.cur = -1;
  r.f = 0;
  for (int c = 0; c < STAGES - 2; ++c) {
    if (c * SLOT < r.total) ring_load(r, c);
    cp_async_commit();
  }
}

// Make fragments [f, f + cnt) readable (cnt <= SLOT): each new slot waits
// for its copies, then a barrier (everyone is done with the slot two back,
// which the copy issued next overwrites). Every thread of the block calls
// it with the same counts.
__device__ __forceinline__ void ring_need(Ring &r, int cnt) {
  while (static_cast<int>(static_cast<unsigned>(r.f + cnt - 1) / SLOT) > r.cur) {
    const int c = ++r.cur;
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    if ((c + STAGES - 2) * SLOT < r.total) ring_load(r, c + STAGES - 2);
    cp_async_commit();
  }
}

// this lane's two values of fragment f + j (the ring holds STAGES x SLOT
// fragments, a power of two: fragment f lives at f mod STAGES SLOT), or
// zeros where `on` is false
static_assert((STAGES * SLOT & (STAGES * SLOT - 1)) == 0, "the ring's size is a power of two");
__device__ __forceinline__ double2 ring_frag(const Ring &r, int j, int lane, bool on) {
  const unsigned fi = static_cast<unsigned>(r.f + j) & (STAGES * SLOT - 1);
  return on ? reinterpret_cast<const double2 *>(r.buf)[fi * (FRAG / 2) + lane]
            : make_double2(0.0, 0.0);
}

// acc += A B with B's lane pair b
__device__ __forceinline__ void mma2(double (&acc)[NACC], const double (&av)[NA], double2 b) {
  const double bv[NB] = {b.x, b.y};
  mma(acc, av, bv);
}

// --- the tile -----------------------------------------------------------------------

// Issue, as one cp.async group, the copies of a tile's R rows x ncols
// columns (column-major, stride ldr; 8 bytes a copy, threads along the
// rows): element (c, k) from src(c, k), a global address, or zero where it
// gives nullptr (`any`: a valid global address such a copy names and does
// not read).
template <typename S>
__device__ __forceinline__ void stage_tile(double *tile, int ldr, int R, int ncols,
                                           const double *any, S src) {
  for (int t = threadIdx.x; t < ncols * R; t += blockDim.x) {
    const int c = t / R, k = t - c * R;
    const double *p = src(c, k);
    cp_async8(tile + (size_t)c * ldr + k, p ? p : any, p != nullptr);
  }
  cp_async_commit();
}

// --- one warp's 16 rows of one set ---------------------------------------------

struct Lane {
  int lane, gi, ti, r0, r1;  // r0, r1: the lane's two rows in the tile
};

__device__ __forceinline__ Lane lane_of() {
  Lane L;
  L.lane = threadIdx.x & 31;
  L.gi = L.lane >> 2;
  L.ti = L.lane & 3;
  L.r0 = 16 * (threadIdx.x >> 5) + L.gi;
  L.r1 = L.r0 + 8;
  return L;
}

// the sum over the lane's group of four (the same bits in each of them)
__device__ __forceinline__ double quad_sum(double x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// the k tiles and the fragments of one step (k tile kk of group g) of a
// grouped product over nt n tiles of an upper-triangular factor
__device__ __forceinline__ int group_kmax(int g, int nt) { return min(nt, (g + 1) * NG); }
__device__ __forceinline__ int group_count(int kk, int g, int nt) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int jn = g * NG + j;
    c += jn < nt && kk <= jn;
  }
  return c;
}

// Product 1: P = A F1, A the tile's columns n1p + 8 kk + (2 ti, 2 ti + 1)
// of the lane's rows, kk-major over F1's fragments.
template <int NT>
__device__ __forceinline__ void product1(Ring &rg, const double *tile, int ldr, const Dims &d,
                                         const Lane &L, double (&P)[NT][NACC]) {
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
#pragma unroll
    for (int h = 0; h < NACC; ++h) P[jn][h] = 0.0;
  const int nt = d.n1t(), kt = d.k1t();
  const double *A = tile + (size_t)d.n1p() * ldr;
  for (int kk = 0; kk < kt; ++kk) {
    ring_need(rg, nt);
    const double *c0 = A + (size_t)(8 * kk + 2 * L.ti) * ldr;
    const double av[NA] = {c0[L.r0], c0[L.r1], c0[ldr + L.r0], c0[ldr + L.r1]};
    // a step's fragments loaded first, then its products (B zero past nt)
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += NG) {
      double2 b[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j) b[j] = ring_frag(rg, j0 + j, L.lane, j0 + j < nt);
#pragma unroll
      for (int j = 0; j < NG; ++j)
        if (j0 + j < NT) mma2(P[j0 + j], av, b[j]);
    }
    rg.f += nt;
  }
}

// Product 2: Z = U F2 in groups of NG n tiles; adds, per row (q0: r0, q1:
// r1), sum_j Z_j^2 (GRAM false) or sum_j Z_j U_j (GRAM true). Unrolled over
// NT, so that U's tiles stay registers named at compile time; U's n tile kk
// is the A operand of k step kk (the k order above).
template <int NT, bool GRAM>
__device__ __forceinline__ void product2(Ring &rg, const Dims &d, const Lane &L,
                                         const double (&U)[NT][NACC], double &q0, double &q1) {
  const int nt = d.n1t();
#pragma unroll
  for (int g = 0; g * NG < NT; ++g) {
    if (g * NG >= nt) break;
    double Z[NG][NACC];
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int h = 0; h < NACC; ++h) Z[j][h] = 0.0;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      if (kk >= group_kmax(g, nt)) break;
      const int cnt = group_count(kk, g, nt);
      ring_need(rg, cnt);
      const double av[NA] = {U[kk][0], U[kk][2], U[kk][1], U[kk][3]};
      // the step's fragments loaded first, then its products (B zero where
      // a tile is absent)
      double2 b[NG];
      int k = 0;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const bool on = g * NG + j < nt && kk <= g * NG + j;
        b[j] = ring_frag(rg, k, L.lane, on);
        k += on;
      }
#pragma unroll
      for (int j = 0; j < NG; ++j)
        if (g * NG + j < NT) mma2(Z[j], av, b[j]);
      rg.f += cnt;
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int jn = g * NG + j;
      if (jn < NT && jn < nt) {
        if (GRAM) {
          q0 += Z[j][0] * U[jn][0];
          q0 += Z[j][1] * U[jn][1];
          q1 += Z[j][2] * U[jn][2];
          q1 += Z[j][3] * U[jn][3];
        } else {
          q0 += Z[j][0] * Z[j][0];
          q0 += Z[j][1] * Z[j][1];
          q1 += Z[j][2] * Z[j][2];
          q1 += Z[j][3] * Z[j][3];
        }
      }
    }
  }
}

// Product 3: Y = H F3 (F3 upper) in groups of NG n tiles; adds sum_j Y_j^2
// per row. hfrag(kk, av, last) gives H's A values of k tile kk (`last`:
// the last group, which visits every k tile once), one step ahead of the
// products that use them.
template <typename HF>
__device__ __forceinline__ void product3(Ring &rg, const Dims &d, const Lane &L, HF hfrag,
                                         double &s0, double &s1) {
  const int kt = d.k1t();
  for (int g = 0; g * NG < kt; ++g) {
    const bool last = (g + 1) * NG >= kt;
    double Y[NG][NACC];
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int h = 0; h < NACC; ++h) Y[j][h] = 0.0;
    const int kmax = group_kmax(g, kt);
    double av[NA], nx[NA];
    hfrag(0, av, last);
    for (int kk = 0; kk < kmax; ++kk) {
      if (kk + 1 < kmax) hfrag(kk + 1, nx, last);  // the next step's loads in flight
      const int cnt = group_count(kk, g, kt);
      ring_need(rg, cnt);
      double2 b[NG];
      int k = 0;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const bool on = g * NG + j < kt && kk <= g * NG + j;
        b[j] = ring_frag(rg, k, L.lane, on);
        k += on;
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) mma2(Y[j], av, b[j]);
      rg.f += cnt;
#pragma unroll
      for (int h = 0; h < NA; ++h) av[h] = nx[h];
    }
#pragma unroll
    for (int j = 0; j < NG; ++j)
      if (g * NG + j < kt) {
        s0 += Y[j][0] * Y[j][0];
        s0 += Y[j][1] * Y[j][1];
        s1 += Y[j][2] * Y[j][2];
        s1 += Y[j][3] * Y[j][3];
      }
  }
}

// --- pass 1: factors --------------------------------------------------------------

// Stage a factor for `invert_lower`: src's lower triangle (m x m, row-major)
// into L (zeros above; cp.async, threads along the rows), X zero, and rinv
// the reciprocals of L's diagonal; every thread of the block takes part.
__device__ __forceinline__ void stage_factor(double *L, double *X, double *rinv,
                                             const double *src, int m) {
  for (int q = threadIdx.x; q < m * m; q += blockDim.x) {
    cp_async8(L + q, src + q, q % m <= q / m);
    X[q] = 0.0;
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < m; i += blockDim.x) rinv[i] = 1.0 / src[(size_t)i * m + i];
  cp_async_wait<0>();
  __syncthreads();
}

// X = L^-1 (lower; m x m row-major in shared memory, 2 m <= blockDim.x, as
// `stage_factor` leaves them). Two threads form column j row by row, X_ij =
// (delta_ij - sum_k L_ik X_kj) rinv_i, each every other k from its warp's
// first column j0 (X_kj = 0 for k < j) in 8 partial sums, then added across
// the pair: a fixed order. A warp runs its rows in step (its lanes read the
// same L_ik), and a column's pair reads only its own stores and L, so the
// rows need no barrier. Ends with one.
__device__ __forceinline__ void invert_lower(const double *L, double *X, const double *rinv,
                                             int m) {
  const int h = threadIdx.x & 1, j = threadIdx.x >> 1, j0 = (threadIdx.x & ~31) >> 1;
  const int jc = j < m ? j : m - 1;
  for (int i = j0; i < m; ++i) {
    const double *Li = L + (size_t)i * m;
    double acc[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    int k = j0 + h;
    for (; k + 14 < i; k += 16)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] += Li[k + 2 * q] * X[(size_t)(k + 2 * q) * m + jc];
    for (; k < i; k += 2) acc[0] += Li[k] * X[(size_t)k * m + jc];
    double sum = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    // both threads of the pair store the same bits: each reads back its own
    if (j <= i && j < m) X[(size_t)i * m + j] = ((j == i ? 1.0 : 0.0) - sum) * rinv[i];
  }
  __syncthreads();
}

// In place, F (kd x ld, row-major in shared memory) becomes L^-T F over its
// first nc columns (nc <= 128): F[i][c] = sum_{k >= i} X[k][i] F[k][c], X =
// L^-1 (lower, kd x kd, shared), rows in ascending order (row i reads only
// rows k >= i), two threads a column (each every other k in 4 partial sums,
// then added across the pair). Every thread of the block takes part.
__device__ __forceinline__ void lt_times(double *F, const double *X, int kd, int ld, int nc) {
  const int c = threadIdx.x >> 1, h = threadIdx.x & 1;
  for (int i = 0; i < kd; ++i) {
    double v[4] = {0.0, 0.0, 0.0, 0.0};
    if (c < nc) {
      int k = i + h;
      for (; k + 6 < kd; k += 8)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] += X[(size_t)(k + 2 * q) * kd + i] * F[(size_t)(k + 2 * q) * ld + c];
      for (; k < kd; k += 2) v[0] += X[(size_t)k * kd + i] * F[(size_t)k * ld + c];
    }
    double x = (v[0] + v[1]) + (v[2] + v[3]);
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    if (c < nc && h == 0) F[(size_t)i * ld + c] = x;
  }
  __syncthreads();
}

// Write the B fragments of one factor F (get(r, c): F[r][c], zero outside
// it) into panel fragments base, base + 1, ... in the order its product
// consumes them: kk-major over kt x nt tiles (F1: grouped false), or, for
// an upper-triangular F2 or F3, in groups of NG n tiles, each group's k
// tiles kk <= jn in order.
template <typename G>
__device__ __forceinline__ void write_frags(double *panel, int base, int kt, int nt, bool grouped,
                                            G get) {
  const int per = blockDim.x / FRAG, me = threadIdx.x / FRAG, e = threadIdx.x % FRAG;
  const int l = e >> 1, h = e & 1, gi = l >> 2, ti = l & 3;
  if (me >= per) return;
  int fi = 0;
  auto put = [&](int kk, int jn) {
    if (fi % per == me) panel[(size_t)(base + fi) * FRAG + e] = get(8 * kk + 2 * ti + h, 8 * jn + gi);
    ++fi;
  };
  if (!grouped) {
    for (int kk = 0; kk < kt; ++kk)
      for (int jn = 0; jn < nt; ++jn) put(kk, jn);
    return;
  }
  for (int g = 0; g * NG < nt; ++g)
    for (int kk = 0; kk < group_kmax(g, nt); ++kk)
      for (int j = 0; j < NG; ++j) {
        const int jn = g * NG + j;
        if (jn < nt && kk <= jn) put(kk, jn);
      }
}

// Zero the "no epoch" row (index ke) of set s's E, Bn and 1/De.
__device__ __forceinline__ void zero_epoch_row(const Scratch &x, const Dims &d, int s, int ke) {
  if (!ke) return;
  for (int c = threadIdx.x; c < d.n1p(); c += blockDim.x)
    x.eacc[((size_t)s * (ke + 1) + ke) * d.n1p() + c] = 0.0;
  for (int c = threadIdx.x; c < d.kdp(); c += blockDim.x)
    x.bn[((size_t)s * (ke + 1) + ke) * d.kdp() + c] = 0.0;
  if (threadIdx.x == 0) x.inv[(size_t)s * (ke + 1) + ke] = 0.0;
}

// Write set s's F1 fragments and F1's plain rows (zero-padded to n1p) from
// F (kd x n1p in shared memory, zero past N1), and its F3 fragments from
// X = L^-1 (kd x kd in shared memory): F3 = L^-T, F3[r][c] = X[c][r].
__device__ __forceinline__ void write_f1_f3(const Scratch &x, const Dims &d, int s,
                                            const double *F, const double *X) {
  const int kd = d.kd, n1p = d.n1p();
  double *panel = x.panels + (size_t)s * d.panel() * FRAG;
  for (int q = threadIdx.x; q < kd * n1p; q += blockDim.x) x.f1p[(size_t)s * kd * n1p + q] = F[q];
  write_frags(panel, 0, d.k1t(), d.n1t(), false,
              [&](int r, int c) { return r < kd ? F[(size_t)r * n1p + c] : 0.0; });
  write_frags(panel, d.f1() + d.f2n(), d.k1t(), d.k1t(), true,
              [&](int r, int c) { return r < kd && c < kd ? X[(size_t)c * kd + r] : 0.0; });
}

}  // namespace grad
}  // namespace pint

// K10 pta_grad: the backward of the per-pulsar blocks of the joint PTA
// likelihood, d/dw per row and d/dphi per basis column, for E x N (point,
// pulsar) sets at once, under a dense cotangent of each set's Gram.
//
// Replaces: the reverse pass that jax.grad builds through pulsar_blocks
// (pint_tpu/fitting/pta_like.py:169-193, under jax.checkpoint) in the TPU
// program pta_loglike_grad (:612) and in the value_and_grad of pta_optimize
// (noise_like.py:367, label pta): the transposes of cinv_inner, woodbury_chi2,
// logdet_C(mask=) and the Cholesky factors of fitting/woodbury.py. Here the
// gradient is written in closed form; the coupling's own reverse pass (the
// Sigma and timing-block Cholesky factors, the ORF) stays torch autograd,
// which hands this kernel its cotangents.
//
// Each set s = e N + a is one pulsar a under point e's weights w and prior
// variances phi: C = diag(1/w) + F phi F^T, F = [U | Fd] (U the ECORR epochs),
// S = phi^-1 + F^T W F, and the forward (kernel K3's stacked mode) gives the
// Gram over X = [Mn, G, r] (q = p + m + 1 columns: the normalized timing
// design, the raw common block, the residuals), X^T C^-1 X, and ln|C|. Given
// their cotangents Gbar (q x q, indefinite) and ldbar, with the amplitudes
// Ahat = S^-1 F^T W X (k x q) and t_i = X_i - F_i Ahat (so (C^-1 X)_i = w_i t_i):
//   d/dw_i   = t_i^T Gbar t_i - ldbar (1/w_i - F_i S^-1 F_i^T),
//   d/dphi_k = -Ahat_k^T Gbar Ahat_k / phi_k^2 + ldbar (1/phi_k - (S^-1)_kk / phi_k^2),
// F_i S^-1 F_i^T = 1/De_e + |L^-1 h_i|^2, h_i = f_i - B_e/De_e, (S^-1)_kk = 1/De_k
// + |L^-1 B_k/De_k|^2 for an epoch and |L^-1 e_k|^2 for a dense column; L is the
// Cholesky factor of the Schur complement Rd - B^T De^-1 B that K3 forms, De_e
// and the epoch sums v_e = sum_{i in e} w_i [X_i, f_i] = [y_e, B_e] are K3's.
// Gbar is indefinite, so t^T Gbar t is a plain sum of products, not a sum of
// squares as in K9. A pad row (w = 0) gets 0.
//
// In the terms of grad_tiles.cuh: N1 = q value columns X, F1 = Ahat_d = L^-T
// Wz (kd x q), F2 = Gbar folded onto its upper triangle (Gs_kj = Gbar_kj +
// Gbar_jk above the diagonal, Gbar_jj on it), F3 = L^-T. A data row's values
// are U = (X_i - Ahat_e) - F_i Ahat_d = t_i, then t_i^T Gbar t_i = sum_j (U
// Gs)_j U_j;
// an epoch's are Ahat_e = (y_e - B_e Ahat_d) / De_e, a dense column's
// Ahat_d's row. Passes:
//   1. pta_grad_factors: blockIdx.x 0 writes Gbar's fragments and zeroes
//      the sets' "no epoch" rows, 1 inverts L and forms Ahat_d and the F1
//      and F3 fragments, one block per set and each;
//   2. pta_grad_basis (ke + kd > 0): the epochs and dense columns, d/dphi,
//      and each epoch's Ahat_e, B_e/De_e and 1/De_e;
//   3. pta_grad_rows: R rows of pulsar blockIdx.y's [Mn | G | r | Fd] staged
//      once, its E sets (s = e N + a) in turn, d/dw.
//
// Bound. Per row and set the three products are q kd + q^2 / 2 + kd^2 / 2
// multiply-adds (~420 at the PTA array's width, q 19, kd 10: a panel of 15
// B fragments, q padded to 24 and kd to 16, issued as 23 m16n8k8 products a
// 16-row tile with the zero tiles a step carries), ~3.4e6 a set,
// against the design's ~1.9 MB a pulsar: at E = 1 the bytes bound it, at
// E = 8 the tensor cores. So a block stages its pulsar's rows once and runs
// all E sets on them: the design (122 MB for 64 pulsars, more than the
// 50 MB L2) is read once a call, not once a point. Products run as mma.sync
// .f64 (DMMA); the rest is built with --fmad=false: every product and sum
// outside the tensor cores rounds on its own.
#include <cuda_runtime.h>

#include "dd.cuh"
#include "grad_tiles.cuh"

PINT_EXPORT_ERROR_STRING
PINT_EXPORT_GRAD_PLANS

namespace {

using namespace pint::grad;
using pint::cp_async_wait;
using pint::NA;
using pint::NACC;

struct Args {
  const double *M, *norm, *Gc, *r, *Fd, *w;  // (N, p, n), (N, p), (N, m, n), (N, n), (N, kd, n), (S, n)
  const int *eidx;                            // (N, n) epoch of each row, -1 for none
  const double *De, *esum, *phi_e, *phi_d;    // (S, ke), (S, ke, q + kd), (S, ke), (S, kd)
  const double *Gbar, *ldbar;                 // (S, q, q), (S,)
  const double *L, *Wz;                       // (S, kd, kd) lower, (S, kd, q)
  int S, npsr, p, m, n, ke, kd;
  Scratch x;
  double *dw, *dphi;  // (S, n), (S, ke + kd)
};

// pass 1: blockIdx.x 0: F2 = Gbar folded; 1: L^-1 -> F3 = L^-T, Ahat_d -> F1
// (fragments and plain rows). Shared (`factor_smem`): L then F (kd x n1p),
// L^-1 and 1/L_ii.
__global__ void __launch_bounds__(FACTOR_THREADS) pta_grad_factors(Args a) {
  extern __shared__ __align__(16) double sm[];
  const int s = blockIdx.y, q = a.p + a.m + 1, kd = a.kd;
  const Dims d = pta_dims(q, kd);
  if (blockIdx.x == 0) {
    zero_epoch_row(a.x, d, s, a.ke);
    // F2: Gbar's form folded onto its upper triangle, G_kj + G_jk above the
    // diagonal (t^T Gbar t takes only Gbar's symmetric part)
    const double *G = a.Gbar + (size_t)s * q * q;
    write_frags(a.x.panels + (size_t)s * d.panel() * FRAG, d.f1(), d.n1t(), d.n1t(), true,
                [&](int rr, int c) {
                  return rr >= q || c >= q || rr > c ? 0.0
                         : rr == c ? G[(size_t)rr * q + c]
                                   : G[(size_t)rr * q + c] + G[(size_t)c * q + rr];
                });
    return;
  }
  if (!kd) return;
  const int n1p = d.n1p();
  double *F = sm, *X = sm + (size_t)kd * (kd > n1p ? kd : n1p), *rinv = X + (size_t)kd * kd;
  stage_factor(F, X, rinv, a.L + (size_t)s * kd * kd, kd);
  invert_lower(F, X, rinv, kd);
  // F (L's place): Wz (zero past q), then Ahat_d = L^-T Wz in place
  const double *Wz = a.Wz + (size_t)s * kd * q;
  for (int t = threadIdx.x; t < kd * n1p; t += blockDim.x) {
    const int i = t / n1p, c = t % n1p;
    F[t] = c < q ? Wz[(size_t)i * q + c] : 0.0;
  }
  __syncthreads();
  lt_times(F, X, kd, n1p, q);
  write_f1_f3(a.x, d, s, F, X);
}

// pass 2: basis rows [blockIdx.x R, + R) of set blockIdx.y: epochs k < ke,
// then the dense columns
template <int NT>
__global__ void __launch_bounds__(256, NT <= 3 ? 2 : 1) pta_grad_basis(Args a) {
  extern __shared__ __align__(16) double sm[];
  const int s = blockIdx.y, q = a.p + a.m + 1, kd = a.kd, ke = a.ke, nb = ke + kd;
  const Dims d = pta_dims(q, kd);
  const int n1p = d.n1p(), kdp = d.kdp(), V = q + kd;
  const int R = blockDim.x / 2, ldr = R + 2, k0 = blockIdx.x * R;
  Ring rg{sm, a.x.panels, d.panel(), s, 1, d.panel(), -1, 0};
  double *tile = sm + (size_t)STAGES * SLOT * FRAG, *scale = tile + (size_t)(n1p + kdp) * ldr;
  // an epoch's [y_e | B_e], a dense column's F1 row | 0
  stage_tile(tile, ldr, R, n1p + kdp, a.w, [&](int c, int r) -> const double * {
    const int k = k0 + r;
    if (k < ke) {
      const double *es = a.esum + ((size_t)s * ke + k) * V;
      return c < q ? es + c : c >= n1p && c - n1p < kd ? es + q + c - n1p : nullptr;
    }
    return k < nb && c < n1p ? a.x.f1p + ((size_t)s * kd + k - ke) * n1p + c : nullptr;
  });
  ring_start(rg);
  for (int k = threadIdx.x; k < R; k += blockDim.x)
    scale[k] = k0 + k < ke ? 1.0 / a.De[(size_t)s * ke + k0 + k] : k0 + k < nb ? 1.0 : 0.0;
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  const Lane L = lane_of();
  const int k_0 = k0 + L.r0, k_1 = k0 + L.r1;
  const double sc0 = scale[L.r0], sc1 = scale[L.r1];
  double U[NT][NACC];
  product1<NT>(rg, tile, ldr, d, L, U);
  // Ahat_e = (y_e - B_e Ahat_d) / De_e; a dense column's Ahat_d row
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
    if (jn < d.n1t()) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * jn + 2 * L.ti + h;
        U[jn][h] = (tile[(size_t)c * ldr + L.r0] - U[jn][h]) * sc0;
        U[jn][2 + h] = (tile[(size_t)c * ldr + L.r1] - U[jn][2 + h]) * sc1;
      }
      const int c = 8 * jn + 2 * L.ti;
      if (k_0 < ke)
        *reinterpret_cast<double2 *>(a.x.eacc + ((size_t)s * (ke + 1) + k_0) * n1p + c) =
            make_double2(U[jn][0], U[jn][1]);
      if (k_1 < ke)
        *reinterpret_cast<double2 *>(a.x.eacc + ((size_t)s * (ke + 1) + k_1) * n1p + c) =
            make_double2(U[jn][2], U[jn][3]);
    }
  double g0 = 0.0, g1 = 0.0, s0 = 0.0, s1 = 0.0;
  product2<NT, true>(rg, d, L, U, g0, g1);
  if (kd) {
    const double *A = tile + (size_t)n1p * ldr;
    product3(rg, d, L, [&](int kk, double (&av)[NA], bool last) {
      const int c = 8 * kk + 2 * L.ti;
      const double *a0 = A + (size_t)c * ldr;
      // H: B_e / De_e for an epoch, the unit vector for a dense column
      av[0] = k_0 < ke ? a0[L.r0] * sc0 : c == k_0 - ke ? 1.0 : 0.0;
      av[1] = k_1 < ke ? a0[L.r1] * sc1 : c == k_1 - ke ? 1.0 : 0.0;
      av[2] = k_0 < ke ? a0[ldr + L.r0] * sc0 : c + 1 == k_0 - ke ? 1.0 : 0.0;
      av[3] = k_1 < ke ? a0[ldr + L.r1] * sc1 : c + 1 == k_1 - ke ? 1.0 : 0.0;
      if (last) {
        if (k_0 < ke)
          *reinterpret_cast<double2 *>(a.x.bn + ((size_t)s * (ke + 1) + k_0) * kdp + c) =
              make_double2(av[0], av[2]);
        if (k_1 < ke)
          *reinterpret_cast<double2 *>(a.x.bn + ((size_t)s * (ke + 1) + k_1) * kdp + c) =
              make_double2(av[1], av[3]);
      }
    }, s0, s1);
  }
  g0 = quad_sum(g0);
  g1 = quad_sum(g1);
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  if (L.ti) return;
  const double ld = a.ldbar[s];
  const int rows[2] = {k_0, k_1};
  const double gs[2] = {g0, g1}, ss[2] = {s0, s1}, scs[2] = {sc0, sc1};
  for (int h = 0; h < 2; ++h) {
    const int k = rows[h];
    if (k >= nb) continue;
    const double phi = k < ke ? a.phi_e[(size_t)s * ke + k] : a.phi_d[(size_t)s * kd + k - ke];
    const double sinv = k < ke ? scs[h] + ss[h] : ss[h];
    const double iphi = 1.0 / phi;
    a.dphi[(size_t)s * nb + k] = -iphi * iphi * gs[h] + ld * (iphi - iphi * iphi * sinv);
    if (k < ke) a.x.inv[(size_t)s * (ke + 1) + k] = scs[h];
  }
}

// pass 3: rows [blockIdx.x R, + R) of pulsar blockIdx.y for each of its sets
template <int NT>
__global__ void __launch_bounds__(256, NT <= 3 ? 2 : 1) pta_grad_rows(Args a) {
  extern __shared__ __align__(16) double sm[];
  const int psr = blockIdx.y, N = a.npsr, p = a.p, m = a.m, kd = a.kd, ke = a.ke, n = a.n;
  const int q = p + m + 1, E = a.S / N;
  const Dims d = pta_dims(q, kd);
  const int n1p = d.n1p(), kdp = d.kdp();
  const int R = blockDim.x / 2, ldr = R + 2, i0 = blockIdx.x * R;
  Ring rg{sm, a.x.panels, d.panel(), psr, N, E * d.panel(), -1, 0};
  double *tile = sm + (size_t)STAGES * SLOT * FRAG;
  // [M | G | r] then Fd, column-major; then M's columns divided by their norms
  const double *M = a.M + (size_t)psr * p * n, *nrm = a.norm + (size_t)psr * p;
  const double *Gc = a.Gc + (size_t)psr * m * n, *Fd = a.Fd + (size_t)psr * kd * n;
  stage_tile(tile, ldr, R, n1p + kdp, a.w, [&](int c, int k) -> const double * {
    const int i = i0 + k;
    if (i >= n) return nullptr;
    return c < p ? M + (size_t)c * n + i : c < p + m ? Gc + (size_t)(c - p) * n + i
           : c == p + m ? a.r + (size_t)psr * n + i
           : c >= n1p && c - n1p < kd ? Fd + (size_t)(c - n1p) * n + i : nullptr;
  });
  ring_start(rg);
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  for (int t = threadIdx.x; t < p * R; t += blockDim.x)
    tile[(size_t)(t / R) * ldr + t % R] /= nrm[t / R];
  __syncthreads();
  const Lane L = lane_of();
  const int i_0 = i0 + L.r0, i_1 = i0 + L.r1;
  const int *eidx = a.eidx + (size_t)psr * n;
  const int ep0 = ke && i_0 < n && eidx[i_0] >= 0 ? eidx[i_0] : ke;
  const int ep1 = ke && i_1 < n && eidx[i_1] >= 0 ? eidx[i_1] : ke;
  const double *A = tile + (size_t)n1p * ldr;
  // a set's row weights, 1/De_e and ldbar, loaded a set ahead of their use
  auto scalars = [&](int e, double (&v)[5]) {
    const int s = e * N + psr;
    v[0] = i_0 < n ? a.w[(size_t)s * n + i_0] : 1.0;
    v[1] = i_1 < n ? a.w[(size_t)s * n + i_1] : 1.0;
    v[2] = ke ? a.x.inv[(size_t)s * (ke + 1) + ep0] : 0.0;
    v[3] = ke ? a.x.inv[(size_t)s * (ke + 1) + ep1] : 0.0;
    v[4] = a.ldbar[s];
  };
  double next[5];
  scalars(0, next);
  for (int e = 0; e < E; ++e) {
    const int s = e * N + psr;
    const size_t e0 = (size_t)s * (ke + 1) + ep0, e1 = (size_t)s * (ke + 1) + ep1;
    const double w0 = next[0], w1 = next[1], inv0 = next[2], inv1 = next[3], ld = next[4];
    if (e + 1 < E) scalars(e + 1, next);
    double U[NT][NACC];
    product1<NT>(rg, tile, ldr, d, L, U);
    // t_i = (X_i - Ahat_e) - F_i Ahat_d
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
      if (jn < d.n1t())
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * jn + 2 * L.ti + h;
          const double g0 = ke ? a.x.eacc[e0 * n1p + c] : 0.0;
          const double g1 = ke ? a.x.eacc[e1 * n1p + c] : 0.0;
          U[jn][h] = (tile[(size_t)c * ldr + L.r0] - g0) - U[jn][h];
          U[jn][2 + h] = (tile[(size_t)c * ldr + L.r1] - g1) - U[jn][2 + h];
        }
    double g0 = 0.0, g1 = 0.0, s0 = 0.0, s1 = 0.0;
    product2<NT, true>(rg, d, L, U, g0, g1);
    if (kd)
      product3(rg, d, L, [&](int kk, double (&av)[NA], bool) {
        // h_i = f_i - B_e / De_e (zero past kd and for rows without an epoch)
        const int c = 8 * kk + 2 * L.ti;
        const double *a0 = A + (size_t)c * ldr;
        const double b00 = ke ? a.x.bn[e0 * kdp + c] : 0.0, b01 = ke ? a.x.bn[e0 * kdp + c + 1] : 0.0;
        const double b10 = ke ? a.x.bn[e1 * kdp + c] : 0.0, b11 = ke ? a.x.bn[e1 * kdp + c + 1] : 0.0;
        av[0] = a0[L.r0] - b00;
        av[1] = a0[L.r1] - b10;
        av[2] = a0[ldr + L.r0] - b01;
        av[3] = a0[ldr + L.r1] - b11;
      }, s0, s1);
    g0 = quad_sum(g0);
    g1 = quad_sum(g1);
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
    if (L.ti == 0 && i_0 < n)
      a.dw[(size_t)s * n + i_0] = w0 == 0.0 ? 0.0 : g0 - ld * (1.0 / w0 - (inv0 + s0));
    if (L.ti == 0 && i_1 < n)
      a.dw[(size_t)s * n + i_1] = w1 == 0.0 ? 0.0 : g1 - ld * (1.0 / w1 - (inv1 + s1));
  }
}

template <int NT>
cudaError_t launch_tiles(const Args &a, const Plan &pl, cudaStream_t st) {
  const long bsm = pl.smem_basis, rsm = pl.smem_rows;
  const int bw = pl.basis_warps, rw = pl.row_warps;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(pta_grad_basis<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bsm)) != cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(pta_grad_rows<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)rsm)) != cudaSuccess)
    return e;
  const int nb = a.ke + a.kd;
  if (nb) {
    pta_grad_basis<NT><<<dim3((nb + 16 * bw - 1) / (16 * bw), a.S), 32 * bw, bsm, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  pta_grad_rows<NT><<<dim3((a.n + 16 * rw - 1) / (16 * rw), a.npsr), 32 * rw, rsm, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The three passes at the plan of grad_plan.h (pta_plan). Shapes as in Args,
// S = E N sets, set s = e N + a; eidx may be a dummy when ke == 0, Fd, L
// and Wz when kd == 0; scratch of the plan's size. Outputs dw (S, n) and
// dphi (S, ke + kd) (epochs first).
extern "C" int pta_grad(const double *M, const double *norm, const double *Gc, const double *r,
                        const double *Fd, const double *w, const int *eidx, const double *De,
                        const double *esum, const double *phi_e, const double *phi_d,
                        const double *Gbar, const double *ldbar, const double *L,
                        const double *Wz, int S, int npsr, int p, int m, int n, int ke, int kd,
                        double *scratch, double *dw, double *dphi, void *stream) {
  Plan pl;
  long long why[2];
  if (npsr < 1 || S % npsr || p < 0 || m < 0 ||
      pta_plan(n, npsr, p + m + 1, ke, kd, S / npsr, pl, why) != TAKEN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = pta_dims(p + m + 1, kd);
  const long fsm = pl.smem_factors;
  Args a{M,    norm,  Gc, r, Fd, w, eidx, De, esum, phi_e, phi_d, Gbar, ldbar,
         L,    Wz,    S,  npsr, p, m, n, ke, kd, scratch_of(scratch, d, S, ke), dw, dphi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(pta_grad_factors, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)fsm)) != cudaSuccess)
    return static_cast<int>(e);
  pta_grad_factors<<<dim3(2, S), FACTOR_THREADS, fsm, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int nt = d.n1t();
  e = nt <= 3   ? launch_tiles<3>(a, pl, st)
      : nt <= 6 ? launch_tiles<6>(a, pl, st)
                : launch_tiles<12>(a, pl, st);
  return static_cast<int>(e);
}

// K9 noise_grad: the backward of the marginalized noise likelihood, d lnL / d w
// per row and d lnL / d phi per basis column, for E sets of weights at once.
//
// Replaces: the reverse pass that jax.grad builds through _loglike_fn
// (pint_tpu/fitting/noise_like.py:141-180) in the TPU programs
// noise_loglike_grad (:811) and noise_optimize (:367, value_and_grad inside
// Adam): the transposes of s_factor, cinv_apply, woodbury_chi2, logdet_C and
// the Cholesky factors of fitting/woodbury.py. Here the gradient is written
// in closed form instead of being taken through the algebra.
//
// With C = diag(1/w) + F phi F^T, F = [U | Fd] (U the ECORR epochs), S =
// phi^-1 + F^T W F, the normalized timing design Mn and A = Mn^T C^-1 Mn +
// ridge I, b = Mn^T C^-1 r, the likelihood is lnL = -(chi2_prof + ln|C| + m
// ln|A| + const) / 2 with chi2_prof = r^T C^-1 r - b^T A^-1 b and m = 1 when
// the timing parameters are marginalized, 0 when profiled. With dhat = A^-1
// b, rt = r - Mn dhat, ahat = S^-1 F^T W rt and g = S^-1 F^T W Mn (k x p):
//   d lnL / d w_i   = -(u_i^2 + q_i + m t_i - 1/w_i) / 2,
//     u_i = rt_i - F_i ahat (the envelope theorem on chi2_prof),
//     q_i = F_i S^-1 F_i^T = 1/De_e + h_i Sigma^-1 h_i^T, h_i = f_i - B_e/De_e,
//     t_i = mt_i A^-1 mt_i^T, mt_i = Mn_i - F_i g;
//   d lnL / d phi_k = -(1/phi_k - (ahat_k^2 + (S^-1)_kk + m g_k A^-1 g_k^T) / phi_k^2) / 2,
//     (S^-1)_kk = 1/De_k + (B_k/De_k) Sigma^-1 (B_k/De_k)^T for an epoch,
//     Sigma^-1_kk for a dense column;
// Sigma = Rd - B^T De^-1 B is the Schur complement K3 factors (L), De_e and
// the epoch sums v_e = sum_{i in e} w_i [Mn_i, r_i, f_i] = [y_e, s_e, B_e]
// are K3's (per-set-weight mode, saved by the forward). Every quadratic form
// x A^-1 x^T is taken as |K^-1 x|^2 (K the Cholesky factor of A), and x
// Sigma^-1 x^T as |L^-1 x|^2: a sum of squares, whose rounding grows with
// cond(K) = sqrt(cond(A)), where the form through A^-1 would cancel at
// cond(A) (~2.4e6 on the NANOGrav par).
//
// In the terms of grad_tiles.cuh: N1 = p + 1 value columns [Mn | r], F1 =
// [g_d | ahat_d] (kd x (p + 1)), g_d = L^-T Wz_M, ahat_d = L^-T Wz_r - g_d
// dhat; F2 = K^-T (upper; zero in row and column p: r's column takes no part
// in t), present when the timing parameters are marginalized; F3 = L^-T. A
// data row's values are U = ([Mn_i, r_i] - [g_e, ahat_e]) - F_i F1, so that
// U's first p columns are mt_i and u_i = U_ip - Mn_i dhat; then t_i = |U
// K^-T|^2 and q_i = 1/De_e + |h_i L^-T|^2. An epoch's are ([y_e, s_e] - B_e
// F1) / De_e: its g_e, and ahat_e = (U_ep - y_e dhat) / De_e; a dense
// column's are F1's row. Passes:
//   1. noise_grad_factors: blockIdx.x 0 inverts K into K^-T's fragments
//      and zeroes the sets' "no epoch" rows, 1 inverts L and forms g_d,
//      ahat_d and the F1 and F3 fragments, one block per set and each;
//   2. noise_grad_basis (ke + kd > 0): the epochs and dense columns, d/dphi,
//      and each epoch's g_e | ahat_e, B_e/De_e and 1/De_e;
//   3. noise_grad_rows: R rows of [Mn | r | Fd] staged once, the E sets in
//      turn, d/dw.
//
// Bound: float64 operations on the tensor cores. Per row and set the three
// products are ~p kd + p^2 / 2 + kd^2 / 2 multiply-adds (~8,700 at the
// NANOGrav width, p 81, kd 60: a panel of 190 B fragments, issued as 236
// m16n8k8 products a 16-row tile with the zero tiles a step carries), ~1.5e8
// a set over 16,384 rows, against ~19 MB of design read once for all E
// sets. Products run as mma.sync .f64 (DMMA), their B operands stream from
// each set's panel in L2 through shared memory, the design is staged once a
// block; the rest is built with --fmad=false: every product and sum outside
// the tensor cores rounds on its own.
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
  const double *M, *norm, *r, *Fd, *w;         // (p, n), (p,), (n,), (kd, n), (E, n)
  const int *eidx;                             // (n,) epoch of each row, -1 for none
  const double *De, *esum, *phi_e, *phi_d;     // (E, ke), (E, ke, p + 1 + kd), (E, ke), (E, kd)
  const double *K, *L, *Wz, *ad, *delta;       // (E, p, p), (E, kd, kd), (E, kd, p + 1), (E, kd), (E, p)
  int E, p, n, ke, kd, marg;
  Scratch x;
  double *dw, *dphi;  // (E, n), (E, ke + kd)
};

// pass 1: blockIdx.x 0: K^-1 -> F2 = K^-T; 1: L^-1 -> F3 = L^-T, g_d and
// ahat_d -> F1 (fragments and plain rows). Shared (`factor_smem`): K, K^-1
// and 1/K_ii; or L then F (kd x n1p), L^-1 and 1/L_ii.
__global__ void __launch_bounds__(FACTOR_THREADS) noise_grad_factors(Args a) {
  extern __shared__ __align__(16) double sm[];
  const int s = blockIdx.y, p = a.p, kd = a.kd;
  const Dims d = noise_dims(p, kd, a.marg);
  double *panel = a.x.panels + (size_t)s * d.panel() * FRAG;
  if (blockIdx.x == 0) {
    zero_epoch_row(a.x, d, s, a.ke);
    if (!d.f2) return;
    double *X = sm + (size_t)p * p, *rinv = X + (size_t)p * p;
    stage_factor(sm, X, rinv, a.K + (size_t)s * p * p, p);
    invert_lower(sm, X, rinv, p);
    write_frags(panel, d.f1(), d.n1t(), d.n1t(), true,
                [&](int rr, int c) { return rr < p && c < p ? X[(size_t)c * p + rr] : 0.0; });
    return;
  }
  if (!kd) return;
  const int n1p = d.n1p();
  double *F = sm, *X = sm + (size_t)kd * (kd > n1p ? kd : n1p), *rinv = X + (size_t)kd * kd;
  stage_factor(F, X, rinv, a.L + (size_t)s * kd * kd, kd);
  invert_lower(F, X, rinv, kd);
  // F (L's place): Wz_M (zero past p), then g_d = L^-T Wz_M in place; its
  // column p: ahat_d
  const double *Wz = a.Wz + (size_t)s * kd * (p + 1);
  for (int q = threadIdx.x; q < kd * n1p; q += blockDim.x) {
    const int i = q / n1p, c = q % n1p;
    F[q] = c < p ? Wz[(size_t)i * (p + 1) + c] : 0.0;
  }
  __syncthreads();
  lt_times(F, X, kd, n1p, p);
  if (threadIdx.x < kd) {
    const int i = threadIdx.x;
    const double *dl = a.delta + (size_t)s * p;
    double v = 0.0;
    for (int c = 0; c < p; ++c) v += F[(size_t)i * n1p + c] * dl[c];
    F[(size_t)i * n1p + p] = a.ad[(size_t)s * kd + i] - v;
  }
  __syncthreads();
  write_f1_f3(a.x, d, s, F, X);
}

// pass 2: basis rows [blockIdx.x R, + R) of set blockIdx.y: epochs k < ke,
// then the dense columns
template <int NT>
__global__ void __launch_bounds__(256, NT <= 3 ? 2 : 1) noise_grad_basis(Args a) {
  extern __shared__ __align__(16) double sm[];
  const int s = blockIdx.y, p = a.p, kd = a.kd, ke = a.ke, nb = ke + kd;
  const Dims d = noise_dims(p, kd, a.marg);
  const int n1 = d.n1, n1p = d.n1p(), kdp = d.kdp(), V = p + 1 + kd;
  const int R = blockDim.x / 2, ldr = R + 2, k0 = blockIdx.x * R;
  Ring rg{sm, a.x.panels, d.panel(), s, 1, d.panel(), -1, 0};
  double *tile = sm + (size_t)STAGES * SLOT * FRAG, *scale = tile + (size_t)(n1p + kdp) * ldr;
  // an epoch's [y_e, s_e | B_e], a dense column's F1 row | 0
  stage_tile(tile, ldr, R, n1p + kdp, a.w, [&](int c, int r) -> const double * {
    const int k = k0 + r;
    if (k < ke) {
      const double *es = a.esum + ((size_t)s * ke + k) * V;
      return c < n1 ? es + c : c >= n1p && c - n1p < kd ? es + n1 + c - n1p : nullptr;
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
  const double *dl = a.delta + (size_t)s * p;
  double U[NT][NACC];
  product1<NT>(rg, tile, ldr, d, L, U);
  // U = (X - P) / De; dhat's products of the epochs' y; r's column raw
  double dot0 = 0.0, dot1 = 0.0, up0 = 0.0, up1 = 0.0;
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
    if (jn < d.n1t())
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * jn + 2 * L.ti + h;
        const double x0 = tile[(size_t)c * ldr + L.r0], x1 = tile[(size_t)c * ldr + L.r1];
        const double v0 = x0 - U[jn][h], v1 = x1 - U[jn][2 + h];
        U[jn][h] = v0 * sc0;
        U[jn][2 + h] = v1 * sc1;
        if (c < p) {
          if (k_0 < ke) dot0 += x0 * dl[c];
          if (k_1 < ke) dot1 += x1 * dl[c];
        } else if (c == p) {
          up0 = v0;
          up1 = v1;
        }
      }
  dot0 = quad_sum(dot0);
  dot1 = quad_sum(dot1);
  const double ah0 = (quad_sum(up0) - dot0) * sc0, ah1 = (quad_sum(up1) - dot1) * sc1;
  // an epoch's g_e | ahat_e for pass 3
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
    if (jn < d.n1t()) {
      const int c = 8 * jn + 2 * L.ti;
      if (k_0 < ke)
        *reinterpret_cast<double2 *>(a.x.eacc + ((size_t)s * (ke + 1) + k_0) * n1p + c) =
            make_double2(c == p ? ah0 : U[jn][0], c + 1 == p ? ah0 : U[jn][1]);
      if (k_1 < ke)
        *reinterpret_cast<double2 *>(a.x.eacc + ((size_t)s * (ke + 1) + k_1) * n1p + c) =
            make_double2(c == p ? ah1 : U[jn][2], c + 1 == p ? ah1 : U[jn][3]);
    }
  double t0 = 0.0, t1 = 0.0, s0 = 0.0, s1 = 0.0;
  if (d.f2) product2<NT, false>(rg, d, L, U, t0, t1);
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
  t0 = quad_sum(t0);
  t1 = quad_sum(t1);
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  if (L.ti) return;
  const int rows[2] = {k_0, k_1};
  const double ahs[2] = {ah0, ah1}, ts[2] = {t0, t1}, ss[2] = {s0, s1}, scs[2] = {sc0, sc1};
  for (int h = 0; h < 2; ++h) {
    const int k = rows[h];
    if (k >= nb) continue;
    const double phi = k < ke ? a.phi_e[(size_t)s * ke + k] : a.phi_d[(size_t)s * kd + k - ke];
    const double sinv = k < ke ? scs[h] + ss[h] : ss[h];
    const double iphi = 1.0 / phi;
    a.dphi[(size_t)s * nb + k] = -0.5 * (iphi - iphi * iphi * (ahs[h] * ahs[h] + sinv + ts[h]));
    if (k < ke) a.x.inv[(size_t)s * (ke + 1) + k] = scs[h];
  }
}

// pass 3: rows [blockIdx.x R, + R) for every set
template <int NT>
__global__ void __launch_bounds__(256, NT <= 3 ? 2 : 1) noise_grad_rows(Args a) {
  extern __shared__ __align__(16) double sm[];
  const int p = a.p, kd = a.kd, ke = a.ke, n = a.n;
  const Dims d = noise_dims(p, kd, a.marg);
  const int n1p = d.n1p(), kdp = d.kdp();
  const int R = blockDim.x / 2, ldr = R + 2, i0 = blockIdx.x * R;
  Ring rg{sm, a.x.panels, d.panel(), 0, 1, a.E * d.panel(), -1, 0};
  double *tile = sm + (size_t)STAGES * SLOT * FRAG;
  // [M | r] then Fd, column-major; then M's columns divided by their norms
  stage_tile(tile, ldr, R, n1p + kdp, a.w, [&](int c, int k) -> const double * {
    const int i = i0 + k;
    if (i >= n) return nullptr;
    return c < p ? a.M + (size_t)c * n + i : c == p ? a.r + i
           : c >= n1p && c - n1p < kd ? a.Fd + (size_t)(c - n1p) * n + i : nullptr;
  });
  ring_start(rg);
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  for (int q = threadIdx.x; q < p * R; q += blockDim.x)
    tile[(size_t)(q / R) * ldr + q % R] /= a.norm[q / R];
  __syncthreads();
  const Lane L = lane_of();
  const int i_0 = i0 + L.r0, i_1 = i0 + L.r1;
  const int ep0 = ke && i_0 < n && a.eidx[i_0] >= 0 ? a.eidx[i_0] : ke;
  const int ep1 = ke && i_1 < n && a.eidx[i_1] >= 0 ? a.eidx[i_1] : ke;
  const double *A = tile + (size_t)n1p * ldr;
  // a set's row weights and 1/De_e, loaded a set ahead of their use
  auto scalars = [&](int e, double (&v)[4]) {
    v[0] = i_0 < n ? a.w[(size_t)e * n + i_0] : 1.0;
    v[1] = i_1 < n ? a.w[(size_t)e * n + i_1] : 1.0;
    v[2] = ke ? a.x.inv[(size_t)e * (ke + 1) + ep0] : 0.0;
    v[3] = ke ? a.x.inv[(size_t)e * (ke + 1) + ep1] : 0.0;
  };
  double next[4];
  scalars(0, next);
  for (int e = 0; e < a.E; ++e) {
    const size_t e0 = (size_t)e * (ke + 1) + ep0, e1 = (size_t)e * (ke + 1) + ep1;
    const double *dl = a.delta + (size_t)e * p;
    const double w0 = next[0], w1 = next[1], inv0 = next[2], inv1 = next[3];
    if (e + 1 < a.E) scalars(e + 1, next);
    double U[NT][NACC];
    product1<NT>(rg, tile, ldr, d, L, U);
    // U = ([Mn | r] - [g_e | ahat_e]) - F_i F1; Mn_i dhat; U's column p
    double dot0 = 0.0, dot1 = 0.0, up0 = 0.0, up1 = 0.0;
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
      if (jn < d.n1t())
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * jn + 2 * L.ti + h;
          const double x0 = tile[(size_t)c * ldr + L.r0], x1 = tile[(size_t)c * ldr + L.r1];
          const double g0 = ke ? a.x.eacc[e0 * n1p + c] : 0.0;
          const double g1 = ke ? a.x.eacc[e1 * n1p + c] : 0.0;
          U[jn][h] = (x0 - g0) - U[jn][h];
          U[jn][2 + h] = (x1 - g1) - U[jn][2 + h];
          if (c < p) {
            dot0 += x0 * dl[c];
            dot1 += x1 * dl[c];
          } else if (c == p) {
            up0 = U[jn][h];
            up1 = U[jn][2 + h];
          }
        }
    const double u0 = quad_sum(up0) - quad_sum(dot0), u1 = quad_sum(up1) - quad_sum(dot1);
    double t0 = 0.0, t1 = 0.0, s0 = 0.0, s1 = 0.0;
    if (d.f2) product2<NT, false>(rg, d, L, U, t0, t1);
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
    t0 = quad_sum(t0);
    t1 = quad_sum(t1);
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
    if (L.ti == 0 && i_0 < n)
      a.dw[(size_t)e * n + i_0] = -0.5 * (u0 * u0 + (inv0 + s0) + t0 - 1.0 / w0);
    if (L.ti == 0 && i_1 < n)
      a.dw[(size_t)e * n + i_1] = -0.5 * (u1 * u1 + (inv1 + s1) + t1 - 1.0 / w1);
  }
}

template <int NT>
cudaError_t launch_tiles(const Args &a, const Plan &pl, cudaStream_t st) {
  const long bsm = pl.smem_basis, rsm = pl.smem_rows;
  const int bw = pl.basis_warps, rw = pl.row_warps;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(noise_grad_basis<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bsm)) != cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(noise_grad_rows<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)rsm)) != cudaSuccess)
    return e;
  const int nb = a.ke + a.kd;
  if (nb) {
    noise_grad_basis<NT><<<dim3((nb + 16 * bw - 1) / (16 * bw), a.E), 32 * bw, bsm, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  noise_grad_rows<NT><<<dim3((a.n + 16 * rw - 1) / (16 * rw)), 32 * rw, rsm, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The three passes at the plan of grad_plan.h (noise_plan). Shapes as in
// Args; eidx may be a dummy when ke == 0, Fd, L, Wz and ad when kd == 0, K
// when p == 0; scratch of the plan's size. Outputs dw (E, n) and dphi (E, ke
// + kd) (epochs first).
extern "C" int noise_grad(const double *M, const double *norm, const double *r, const double *Fd,
                          const double *w, const int *eidx, const double *De, const double *esum,
                          const double *phi_e, const double *phi_d, const double *K,
                          const double *L, const double *Wz, const double *ad,
                          const double *delta, int E, int p, int n, int ke, int kd, int marg,
                          double *scratch, double *dw, double *dphi, void *stream) {
  Plan pl;
  long long why[2];
  if (noise_plan(n, p, ke, kd, E, marg, pl, why) != TAKEN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = noise_dims(p, kd, marg);
  const long fsm = pl.smem_factors;
  Args a{M, norm, r, Fd, w, eidx, De, esum, phi_e, phi_d, K, L, Wz, ad, delta,
         E, p,    n, ke, kd, marg, scratch_of(scratch, d, E, ke), dw, dphi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(noise_grad_factors, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)fsm)) != cudaSuccess)
    return static_cast<int>(e);
  noise_grad_factors<<<dim3(2, E), FACTOR_THREADS, fsm, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int nt = d.n1t();
  e = nt <= 3   ? launch_tiles<3>(a, pl, st)
      : nt <= 6 ? launch_tiles<6>(a, pl, st)
                : launch_tiles<12>(a, pl, st);
  return static_cast<int>(e);
}

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
// cond(A) (~2.4e6 on the NANOGrav par). The wrapper forms the small
// factors: K^-1 and L^-1, g_d = L^-T Wz_M and ahat_d = L^-T (Wz_r - Wz_M
// dhat) (torch.linalg.solve_triangular).
//
// Two passes on one stream, E sets on blockIdx.y, 16 warps a block:
//   1. phi_pass: one warp per basis column k (epochs first, then the dense
//      columns): an epoch's g_e = (y_e - B_e g_d)/De_e and ahat_e = (s_e -
//      y_e dhat - B_e ahat_d)/De_e (kept for pass 2), then its phi term;
//   2. row_pass: one warp per row, its w term.
// Each block holds its set's K^-T (p x p) and L^-T (kd x kd) in dynamic
// shared memory, and one p + kd buffer per warp; every sum runs in a fixed
// order, lanes strided, then a shuffle tree (no atomics: run after run
// bitwise the same).
//
// Bound: float64 operations. Per row ~p kd (mt) + p^2 / 2 (t) + kd^2 / 2 (q)
// multiply-adds, ~2.5e8 per set at the NANOGrav width (N 16,384, p 81, kd
// 60), against ~19 MB read (M, Fd, w, r): above the H100's float64 ridge.
// This simple design keeps the small inverse factors in shared memory and reads
// M and Fd with a warp per row (strided across lanes); each inner product runs
// in ACC interleaved partial sums so that a warp has loads in flight; it is
// right first, and fast later. No error-free transforms: built with --fmad=false, every
// product and sum rounds on its own.
#include <cuda_runtime.h>

#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

constexpr int THREADS = 512, WARPS = THREADS / 32;
constexpr int ACC = 4;  // independent partial sums per inner product (latency hiding)
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use (H100)

struct Args {
  const double *M, *norm, *r, *Fd, *w;  // (p, n), (p,), (n,), (kd, n), (E, n)
  const int *eidx;                      // (n,) epoch of each row, -1 for none
  const double *De, *esum, *phi_e, *phi_d;          // (E, ke), (E, ke, V), (E, ke), (E, kd)
  const double *Kt, *Lt, *gd, *ad, *delta;  // K^-T (E, p, p), L^-T (E, kd, kd), (E, kd, p), (E, kd), (E, p)
  int E, p, n, ke, kd, marg;
  double *ge, *ae;    // scratch: (E, ke, p), (E, ke)
  double *dw, *dphi;  // (E, n), (E, ke + kd)
};

// the warp's sum, lane 0's shuffle-tree order, broadcast to every lane
__device__ __forceinline__ double warp_sum(double x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return __shfl_sync(0xffffffffu, x, 0);
}

// sum_{l < len} a[l * stride] b[l] in ACC interleaved partial sums, added in
// a fixed order at the end
__device__ __forceinline__ double dot(const double *a, int stride, const double *b, int len) {
  double s[ACC] = {};
  int l = 0;
  for (; l + ACC <= len; l += ACC)
#pragma unroll
    for (int q = 0; q < ACC; ++q) s[q] += a[(l + q) * stride] * b[l + q];
  for (; l < len; ++l) s[0] += a[l * stride] * b[l];
  double t = s[0];
#pragma unroll
  for (int q = 1; q < ACC; ++q) t += s[q];
  return t;
}

// |U^T x|^2 over the warp: U = X^-T (m x m, upper) in shared memory, so that
// (U^T x)_j = sum_{l <= j} X^-1_jl x_l; x in a warp buffer
__device__ __forceinline__ double norm2(const double *U, const double *x, int m, int lane) {
  double acc = 0.0;
  for (int j = lane; j < m; j += 32) {
    const double z = dot(U + j, m, x, j + 1);
    acc += z * z;
  }
  return warp_sum(acc);
}

// stage set b's K^-T and L^-T into shared memory
__device__ __forceinline__ void stage(const Args &a, int b, double *Kt, double *Lt) {
  const size_t pp = (size_t)a.p * a.p, kk = (size_t)a.kd * a.kd;
  for (size_t q = threadIdx.x; q < pp; q += THREADS) Kt[q] = a.Kt[b * pp + q];
  for (size_t q = threadIdx.x; q < kk; q += THREADS) Lt[q] = a.Lt[b * kk + q];
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) phi_pass(Args a) {
  extern __shared__ double sm[];
  const int b = blockIdx.y, p = a.p, kd = a.kd, ke = a.ke, V = p + 1 + kd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double *Kt = sm, *Lt = Kt + (size_t)p * p;
  double *gbuf = Lt + (size_t)kd * kd + (size_t)warp * (p + kd), *bbuf = gbuf + p;
  stage(a, b, Kt, Lt);
  const double *gd = a.gd + (size_t)b * kd * p, *ad = a.ad + (size_t)b * kd;
  const double *dl = a.delta + (size_t)b * p;
  for (int k = blockIdx.x * WARPS + warp; k < ke + kd; k += gridDim.x * WARPS) {
    double ahat, sinv, phi;
    if (k < ke) {
      const double *es = a.esum + ((size_t)b * ke + k) * V;
      const double inv = 1.0 / a.De[(size_t)b * ke + k];
      double part = 0.0;  // y_e dhat + B_e ahat_d
      for (int l = lane; l < kd; l += 32) {
        const double B = es[p + 1 + l];
        bbuf[l] = B * inv;
        part += B * ad[l];
      }
      for (int j = lane; j < p; j += 32) {
        const double g = (es[j] - dot(gd + j, p, es + p + 1, kd)) * inv;
        gbuf[j] = g;
        a.ge[((size_t)b * ke + k) * p + j] = g;
        part += es[j] * dl[j];
      }
      ahat = (es[p] - warp_sum(part)) * inv;
      if (lane == 0) a.ae[(size_t)b * ke + k] = ahat;
      __syncwarp();
      sinv = inv + norm2(Lt, bbuf, kd, lane);
      phi = a.phi_e[(size_t)b * ke + k];
    } else {
      const int d = k - ke;
      for (int j = lane; j < p; j += 32) gbuf[j] = gd[(size_t)d * p + j];
      __syncwarp();
      ahat = ad[d];
      double col = 0.0;  // (Sigma^-1)_dd = sum_l (L^-1)_ld^2
      for (int l = d + lane; l < kd; l += 32) col += Lt[(size_t)d * kd + l] * Lt[(size_t)d * kd + l];
      sinv = warp_sum(col);
      phi = a.phi_d[(size_t)b * kd + d];
    }
    const double t = a.marg ? norm2(Kt, gbuf, p, lane) : 0.0;
    if (lane == 0) {
      const double iphi = 1.0 / phi;
      a.dphi[(size_t)b * (ke + kd) + k] = -0.5 * (iphi - iphi * iphi * (ahat * ahat + sinv + t));
    }
    __syncwarp();  // the buffers are rewritten by the next column
  }
}

__global__ void __launch_bounds__(THREADS) row_pass(Args a) {
  extern __shared__ double sm[];
  const int b = blockIdx.y, p = a.p, kd = a.kd, ke = a.ke, n = a.n, V = p + 1 + kd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double *Kt = sm, *Lt = Kt + (size_t)p * p;
  double *mbuf = Lt + (size_t)kd * kd + (size_t)warp * (p + kd), *hbuf = mbuf + p;
  stage(a, b, Kt, Lt);
  const double *gd = a.gd + (size_t)b * kd * p, *ad = a.ad + (size_t)b * kd;
  const double *dl = a.delta + (size_t)b * p;
  for (int i = blockIdx.x * WARPS + warp; i < n; i += gridDim.x * WARPS) {
    const int ep = ke > 0 ? a.eidx[i] : -1;
    const double *es = ep >= 0 ? a.esum + ((size_t)b * ke + ep) * V : nullptr;
    const double inv = ep >= 0 ? 1.0 / a.De[(size_t)b * ke + ep] : 0.0;
    const double *ge = ep >= 0 ? a.ge + ((size_t)b * ke + ep) * p : nullptr;
    double fit = 0.0;  // Mn_i dhat + f_i ahat_d
    for (int l = lane; l < kd; l += 32) {
      const double f = a.Fd[(size_t)l * n + i];
      hbuf[l] = f;
      fit += f * ad[l];
    }
    __syncwarp();
    for (int j = lane; j < p; j += 32) {
      const double x = a.M[(size_t)j * n + i] / a.norm[j];
      mbuf[j] = (ep >= 0 ? x - ge[j] : x) - dot(gd + j, p, hbuf, kd);
      fit += x * dl[j];
    }
    __syncwarp();
    if (ep >= 0)
      for (int l = lane; l < kd; l += 32) hbuf[l] -= es[p + 1 + l] * inv;
    __syncwarp();
    const double q = norm2(Lt, hbuf, kd, lane);
    const double t = a.marg ? norm2(Kt, mbuf, p, lane) : 0.0;
    fit = warp_sum(fit);
    if (lane == 0) {
      const double u = ep >= 0 ? a.r[i] - fit - a.ae[(size_t)b * ke + ep] : a.r[i] - fit;
      a.dw[(size_t)b * n + i] = -0.5 * (u * u + (inv + q) + t - 1.0 / a.w[(size_t)b * n + i]);
    }
    __syncwarp();
  }
}

// blocks per set: enough warps for the items, at most 2 resident blocks per SM
// over the card's 132 SMs (~100 KB of shared memory each at the NANOGrav width)
inline int blocks_for(int items) { return items < 264 * WARPS ? (items + WARPS - 1) / WARPS : 264; }

}  // namespace

// Bytes of dynamic shared memory a block needs at (p, kd).
extern "C" long noise_grad_smem(int p, int kd) {
  return 8L * ((long)p * p + (long)kd * kd + (long)WARPS * (p + kd));
}

// Both passes. Shapes as in Args; eidx may be null when ke == 0. Outputs dw
// (E, n) and dphi (E, ke + kd) (epochs first); ge (E, ke, p) and ae (E, ke)
// are scratch.
extern "C" int noise_grad(const double *M, const double *norm, const double *r, const double *Fd,
                          const double *w, const int *eidx, const double *De, const double *esum,
                          const double *phi_e, const double *phi_d, const double *Kt,
                          const double *Lt, const double *gd, const double *ad,
                          const double *delta, int E, int p, int n, int ke, int kd, int marg,
                          double *ge, double *ae, double *dw, double *dphi, void *stream) {
  const long smem = noise_grad_smem(p, kd);
  if (E < 1 || E > 65535 || p < 0 || n < 1 || ke < 0 || kd < 0 || smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{M,  norm,  r, Fd, w, eidx, De,   esum, phi_e, phi_d, Kt, Lt, gd,
               ad, delta, E, p,  n, ke,   kd,   marg, ge,    ae,    dw, dphi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(phi_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaFuncSetAttribute(row_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (ke + kd > 0) {
    phi_pass<<<dim3(blocks_for(ke + kd), E), THREADS, smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  row_pass<<<dim3(blocks_for(n), E), THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

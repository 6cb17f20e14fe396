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
// The wrapper forms L^-T and Ahat_d = L^-T Wz (torch.linalg.solve_triangular);
// the epochs' Ahat_e = (y_e - B_e Ahat_d) / De_e are formed here. A pad row
// (w = 0) gets 0. Gbar is indefinite, so t^T Gbar t is a plain sum of
// products, not a sum of squares as in K9.
//
// Two passes on one stream, the E N sets on blockIdx.y, 16 warps a block:
//   1. pta_phi_pass: one warp per basis column k (epochs first, then the dense
//      columns): an epoch's Ahat_e (kept for pass 2), then its phi term;
//   2. pta_row_pass: one warp per row, its w term.
// Each block holds its set's Gbar, L^-T and Ahat_d in dynamic shared memory,
// and one q + kd buffer per warp; every sum runs in a fixed order, lanes
// strided, then a shuffle tree (no atomics: run after run bitwise the same).
//
// Bound: float64 operations. Per row ~q kd (t) + q^2 (t^T Gbar t) + kd^2 / 2
// multiply-adds, ~1.3e7 per set at the PTA array's width (rows 8,192, q 19,
// kd 10), against ~1.9 MB read (M, G, Fd, w, r). This simple design is right
// first, and fast later. Built with --fmad=false: every product and sum rounds
// on its own.
#include <cuda_runtime.h>

#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

constexpr int THREADS = 512, WARPS = THREADS / 32;
constexpr int ACC = 4;              // independent partial sums per inner product
constexpr int SMEM_MAX = 232448;    // bytes of shared memory a block may use (H100)
constexpr int TARGET_BLOCKS = 1056; // blocks to aim for over all sets: 8 per SM

struct Args {
  const double *M, *norm, *Gc, *r, *Fd, *w;  // (N, p, n), (N, p), (N, m, n), (N, n), (N, kd, n), (S, n)
  const int *eidx;                            // (N, n) epoch of each row, -1 for none
  const double *De, *esum, *phi_e, *phi_d;    // (S, ke), (S, ke, V), (S, ke), (S, kd)
  const double *Gbar, *ldbar;                 // (S, q, q), (S,)
  const double *Lt, *Ad;                      // L^-T (S, kd, kd), Ahat_d (S, kd, q)
  int S, npsr, p, m, n, ke, kd;
  double *Ae;         // scratch: (S, ke, q)
  double *dw, *dphi;  // (S, n), (S, ke + kd)
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

// |U^T x|^2 over the warp: U = L^-T (m x m, upper) in shared memory, so that
// (U^T x)_j = sum_{l <= j} L^-1_jl x_l; x in a warp buffer
__device__ __forceinline__ double norm2(const double *U, const double *x, int m, int lane) {
  double acc = 0.0;
  for (int j = lane; j < m; j += 32) {
    const double z = dot(U + j, m, x, j + 1);
    acc += z * z;
  }
  return warp_sum(acc);
}

// x^T G x over the warp: G (q x q) in shared memory, x in a warp buffer
__device__ __forceinline__ double quad(const double *G, const double *x, int q, int lane) {
  double acc = 0.0;
  for (int j = lane; j < q; j += 32) acc += x[j] * dot(G + (size_t)j * q, 1, x, q);
  return warp_sum(acc);
}

// stage set s's Gbar, L^-T and Ahat_d into shared memory
__device__ __forceinline__ void stage(const Args &a, int s, int q, double *G, double *Lt,
                                      double *Ad) {
  const size_t qq = (size_t)q * q, kk = (size_t)a.kd * a.kd, kq = (size_t)a.kd * q;
  for (size_t i = threadIdx.x; i < qq; i += THREADS) G[i] = a.Gbar[s * qq + i];
  for (size_t i = threadIdx.x; i < kk; i += THREADS) Lt[i] = a.Lt[s * kk + i];
  for (size_t i = threadIdx.x; i < kq; i += THREADS) Ad[i] = a.Ad[s * kq + i];
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) pta_phi_pass(Args a) {
  extern __shared__ double sm[];
  const int s = blockIdx.y, kd = a.kd, ke = a.ke, q = a.p + a.m + 1, V = q + kd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double *G = sm, *Lt = G + (size_t)q * q, *Ad = Lt + (size_t)kd * kd;
  double *abuf = Ad + (size_t)kd * q + (size_t)warp * (q + kd), *bbuf = abuf + q;
  stage(a, s, q, G, Lt, Ad);
  const double ld = a.ldbar[s];
  for (int k = blockIdx.x * WARPS + warp; k < ke + kd; k += gridDim.x * WARPS) {
    double sinv, phi;
    if (k < ke) {
      const double *es = a.esum + ((size_t)s * ke + k) * V;
      const double inv = 1.0 / a.De[(size_t)s * ke + k];
      for (int l = lane; l < kd; l += 32) bbuf[l] = es[q + l] * inv;
      for (int j = lane; j < q; j += 32) {
        const double ae = (es[j] - dot(Ad + j, q, es + q, kd)) * inv;
        abuf[j] = ae;
        a.Ae[((size_t)s * ke + k) * q + j] = ae;
      }
      __syncwarp();
      sinv = inv + norm2(Lt, bbuf, kd, lane);
      phi = a.phi_e[(size_t)s * ke + k];
    } else {
      const int d = k - ke;
      for (int j = lane; j < q; j += 32) abuf[j] = Ad[(size_t)d * q + j];
      __syncwarp();
      double col = 0.0;  // (Sigma^-1)_dd = sum_l (L^-1)_ld^2
      for (int l = d + lane; l < kd; l += 32) col += Lt[(size_t)d * kd + l] * Lt[(size_t)d * kd + l];
      sinv = warp_sum(col);
      phi = a.phi_d[(size_t)s * kd + d];
    }
    const double g = quad(G, abuf, q, lane);
    if (lane == 0) {
      const double iphi = 1.0 / phi, iphi2 = iphi * iphi;
      a.dphi[(size_t)s * (ke + kd) + k] = -iphi2 * g + ld * (iphi - iphi2 * sinv);
    }
    __syncwarp();  // the buffers are rewritten by the next column
  }
}

__global__ void __launch_bounds__(THREADS) pta_row_pass(Args a) {
  extern __shared__ double sm[];
  const int s = blockIdx.y, psr = s % a.npsr, p = a.p, m = a.m, kd = a.kd, ke = a.ke, n = a.n;
  const int q = p + m + 1, V = q + kd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double *G = sm, *Lt = G + (size_t)q * q, *Ad = Lt + (size_t)kd * kd;
  double *tbuf = Ad + (size_t)kd * q + (size_t)warp * (q + kd), *hbuf = tbuf + q;
  stage(a, s, q, G, Lt, Ad);
  const double ld = a.ldbar[s];
  const double *M = a.M + (size_t)psr * p * n, *nrm = a.norm + (size_t)psr * p;
  const double *Gc = a.Gc + (size_t)psr * m * n, *Fd = a.Fd + (size_t)psr * kd * n;
  const double *r = a.r + (size_t)psr * n, *w = a.w + (size_t)s * n;
  for (int i = blockIdx.x * WARPS + warp; i < n; i += gridDim.x * WARPS) {
    const double wi = w[i];
    if (wi == 0.0) {  // a pad row of the bucket
      if (lane == 0) a.dw[(size_t)s * n + i] = 0.0;
      continue;
    }
    const int ep = ke > 0 ? a.eidx[(size_t)psr * n + i] : -1;
    const double *es = ep >= 0 ? a.esum + ((size_t)s * ke + ep) * V : nullptr;
    const double inv = ep >= 0 ? 1.0 / a.De[(size_t)s * ke + ep] : 0.0;
    const double *ae = ep >= 0 ? a.Ae + ((size_t)s * ke + ep) * q : nullptr;
    for (int l = lane; l < kd; l += 32) hbuf[l] = Fd[(size_t)l * n + i];
    __syncwarp();
    for (int j = lane; j < q; j += 32) {
      const double x = j < p ? M[(size_t)j * n + i] / nrm[j]
                             : j < p + m ? Gc[(size_t)(j - p) * n + i] : r[i];
      tbuf[j] = (ep >= 0 ? x - ae[j] : x) - dot(Ad + j, q, hbuf, kd);
    }
    __syncwarp();
    if (ep >= 0)
      for (int l = lane; l < kd; l += 32) hbuf[l] -= es[q + l] * inv;
    __syncwarp();
    const double fsf = inv + norm2(Lt, hbuf, kd, lane);
    const double g = quad(G, tbuf, q, lane);
    if (lane == 0) a.dw[(size_t)s * n + i] = g - ld * (1.0 / wi - fsf);
    __syncwarp();
  }
}

// blocks per set: enough warps for the items, about TARGET_BLOCKS in all
inline int blocks_for(int items, int sets) {
  const int want = (TARGET_BLOCKS + sets - 1) / sets, most = (items + WARPS - 1) / WARPS;
  return want < most ? want : most;
}

}  // namespace

// Bytes of dynamic shared memory a block needs at (q, kd).
extern "C" long pta_grad_smem(int q, int kd) {
  return 8L * ((long)q * q + (long)kd * kd + (long)kd * q + (long)WARPS * (q + kd));
}

// Both passes. Shapes as in Args, S = E N sets, set s = e N + a; eidx may be
// a dummy when ke == 0, Fd, Lt and Ad when kd == 0. Outputs dw (S, n) and
// dphi (S, ke + kd) (epochs first); Ae (S, ke, q) is scratch.
extern "C" int pta_grad(const double *M, const double *norm, const double *Gc, const double *r,
                        const double *Fd, const double *w, const int *eidx, const double *De,
                        const double *esum, const double *phi_e, const double *phi_d,
                        const double *Gbar, const double *ldbar, const double *Lt,
                        const double *Ad, int S, int npsr, int p, int m, int n, int ke, int kd,
                        double *Ae, double *dw, double *dphi, void *stream) {
  const long smem = pta_grad_smem(p + m + 1, kd);
  if (S < 1 || S > 65535 || npsr < 1 || S % npsr || p < 0 || m < 0 || n < 1 || ke < 0 ||
      kd < 0 || smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{M,  norm, Gc,   r, Fd, w, eidx, De, esum, phi_e, phi_d, Gbar, ldbar,
               Lt, Ad,   S,    npsr, p,  m, n,    ke, kd,   Ae,    dw,    dphi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(pta_phi_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaFuncSetAttribute(pta_row_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (ke + kd > 0) {
    pta_phi_pass<<<dim3(blocks_for(ke + kd, S), S), THREADS, smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  pta_row_pass<<<dim3(blocks_for(n, S), S), THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

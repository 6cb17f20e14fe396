// K3 ecorr_normal_eq: the Woodbury normal equations of the GLS fit and of
// the correlated chi^2 grid, with the ECORR epochs kept implicit and a dense
// (Fourier) noise basis beside them.
//
// Replaces: the Woodbury algebra of pint_tpu/fitting/woodbury.py (seg_sum,
// s_factor, s_solve, cinv_apply, woodbury_chi2, basis_rmatvec) as XLA fused
// it into the TPU programs gls_step (fitting/gls.py:77), gls_chi2
// (gls.py:193) and the correlated branch of grid (gridutils.py:112-170),
// with the step inputs those programs form first:
//   centre (the grid): r and every column lose their weighted mean
//     sum(w x)/sum(w) (gridutils.py:103-107, 132-134);
//   norm_j = sqrt(sum w M_j^2) (weighted, the grid, gridutils.py:135-137)
//     or sqrt(sum M_j^2) (the GLS step, gls.py:109-111), 1 where the sum
//     is 0; Mn = M / norm.
// The covariance is diag(1/w) + U phi_e U^T + Fd phi_d Fd^T, U the epoch
// membership. With the augmented row vector V_i = [Mn_i, r_i, Fd_i] (p + 1
// + kd values) and the epoch sums v_e = sum_{i in e} w_i V_i = [y_e, s_e,
// B_e], eliminating the epochs gives, per parameter set b,
//   De_e = 1/phi_e + sum_{i in e} w_i
//   S1   = sum_i w_i V_i V_i^T - sum_e v_e v_e^T / De_e
// whose blocks are Mn^T W Mn - sum y y^T/De, Mn^T W r - sum y s/De, the
// same for r^T W r; Z = Fd^T W Mn - B^T De^-1 Y; z = Fd^T W r - B^T De^-1 s;
// and Fd^T W Fd - B^T De^-1 B. Then Rd = diag(1/phi_d) + that last block,
// its Cholesky factor L (torch.linalg.cholesky, a kd x kd matrix, once per
// call: it depends on w and Fd alone), Wz = L^-1 [Z | z] (a triangular
// solve), and
//   G    = [S1]_MM - Wz_M^T Wz_M + ridge I
//   c    = -([S1]_Mr - Wz_M^T Wz_r)
//   chi2 = [S1]_rr - Wz_r^T Wz_r
//   ahat = [(s_e - B_e ahat_d) / De_e ; ahat_d = L^-T Wz_r]   (cat_ahat)
// M (B, p, N) is the raw design, column before row; w (N,) and Fd (kd, N)
// are shared by the sets; the epochs come as a CSR (offsets (ke + 1), row
// ids). Without a dense basis (kd = 0) the Wz terms vanish; without epochs
// (ke = 0) the epoch sums do.
//
// Determinism (ROADMAP C3): no atomics, every sum in a fixed order, so a
// result is bitwise the same run after run. Passes on one stream:
//   1. mean_pass (centre only): one block per (value, set) sums w and w x
//      over the rows in a fixed strided order and a fixed block reduction;
//   2. norm_pass (p > 0): one block per (column, set), the same for the
//      sums of w (M_j - m_j)^2 or (M_j - m_j)^2;
//   3. epoch_pass (ke > 0): one thread per (epoch, value, set) adds its
//      epoch's rows in CSR order (the order of the twin's seg_sum), each
//      value centred and divided as it is read: y, s and, for set 0, B and
//      De;
//   4. gram_pass: one 16 x 16 block per tile of the upper triangle of S1,
//      per set and per segment of the rows (or of the epochs, weights
//      1/De): the block stages 64 rows of its two column slabs at a time in
//      shared memory (centred and divided as they are staged), each thread
//      sums its entry over the chunk in row order and adds the chunk's sum
//      to its segment's partial; the set-independent Fd block only for set
//      0. Segments are as long as it takes to give the card ~4 blocks per
//      SM, so a narrow Gram (the flagship's p = 14) still fills it;
//   5. s1_pass: one thread per entry and set folds the segments' partials
//      in order, rows minus epochs, into S1 (symmetric);
//   (the host factors Rd and solves for Wz and ahat_d)
//   6. fold_pass: one block per set writes G (symmetric), c and chi2;
//   7. ahat_pass (ke > 0): one thread per (epoch, set).
//
// The per-set-weight mode (ecorr_gram_sets, ecorr_fold_sets) turns the sets
// around: ONE (r, M) and E sets of weights w (E, N) and prior variances
// phi_e (E, ke), phi_d (E, kd), the form of pint_tpu's marginalized noise
// likelihood (fitting/noise_like.py:141-180 _loglike_fn, in the TPU programs
// noise_loglike, noise_loglike_batch and noise_loglike_grad). The same
// passes run with set stride 0 on r, M and the norms and set stride N on w;
// De, the epoch sums and the Fd blocks (which depend on w) are then per set.
// No centring, unweighted norms (the noise design's Mnorm,
// noise_like.py:685-687). One more pass, logw_pass, adds sum_i ln w_i per
// set for the white term of ln|C|. Set 0's arithmetic in the shared-weight
// mode is exactly what it was before the mode existed.
//
// The stacked mode (ecorr_gram_stacked; its fold is ecorr_fold_sets) runs the per-set
// passes over the E x N (point, pulsar) sets of pint_tpu's joint PTA
// likelihood (fitting/pta_like.py:169-193 pulsar_blocks: cinv_inner,
// woodbury_chi2 and logdet_C(mask=) per pulsar, in the TPU programs
// pta_loglike, pta_loglike_batch, the forward of pta_loglike_grad,
// pta_detection_stat and pta_gwb_blocks). Set s = e N + a reads pulsar a's r,
// M, norms, Fd and CSR by stride (shared by the E points) and point e's w and
// phi. Its design is X = [Mn, G]: the p columns of M divided by their
// unweighted norms, then the m columns of the common block G, raw (no norm,
// no ridge); so the fold's "G" is X^T C^-1 X = [[A, W], [W^T, V]] and its c
// is -[b; u]. The bucket's pad rows carry w = 0: they add nothing to a sum,
// and logw_pass skips them (pint_tpu's logdet_C(mask=)).
//
// Bound: float64 operations. The Gram is ~N (p + 1 + kd)^2 / 2 multiply-
// adds per set (about 1e9 at the NANOGrav grid's B = 9, p = 80, kd = 60),
// against N (p + 1) doubles read per set: far above the H100's float64
// ridge at that width (the flagship's p = 14 is below it, bound by bytes).
// The tiles keep each staged value in shared memory for 16 products, one
// entry per thread; this simple design is right first, and fast later.
#include "block_sum.cuh"
#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

using pint::block_sum;

constexpr int THREADS = 256;
constexpr int T = 16;    // gram_pass tile edge (T x T threads)
constexpr int CH = 64;   // rows, or epochs, staged per gram_pass chunk
constexpr int PMAX = 256, KDMAX = 512;
constexpr int TARGET_BLOCKS = 528;  // gram_pass blocks to aim for: 4 per SM

struct Args {
  const double *r, *M, *w, *Fd;
  const int *offsets, *rows;
  const double *ephi;
  int B, p, n, ke, kd, centre, weighted;
  int seg_len, row_segs, n_segs;  // gram_pass segments: rows, then epochs
  double *mean, *norm, *esum, *De, *part, *S1;
  int ws;        // 1: one (r, M), B sets of weights and prior variances; 2: stacked
  double *logw;  // ws: sum_i ln w_i per set (B,)
  // stacked mode: the design's first pn columns are M's (normalized), the
  // other p - pn the raw common block Gc (npsr, p - pn, n); each pulsar's
  // CSR has ke + 1 offsets and nnz row ids
  const double *Gc;
  int pn, npsr, nnz;
};

// the (r, M) set that weight set b reads, and the offsets of set b's
// weights and of its per-epoch values (De, phi_e)
__device__ __forceinline__ int design_set(const Args &a, int b) {
  return a.ws == 2 ? b % a.npsr : a.ws ? 0 : b;
}
__device__ __forceinline__ size_t w_off(const Args &a, int b) { return a.ws ? (size_t)b * a.n : 0; }
__device__ __forceinline__ size_t e_off(const Args &a, int b) { return a.ws ? (size_t)b * a.ke : 0; }

__host__ __device__ inline int tiles_of(int V) { return (V + T - 1) / T; }

// rows (and epochs) per gram_pass segment: whole chunks, enough segments
// for TARGET_BLOCKS blocks
inline int segment_length(int n, int ke, int V, int B) {
  const long pairs = (long)tiles_of(V) * (tiles_of(V) + 1) / 2 * B;
  const long want = (n + ke) * pairs / TARGET_BLOCKS + 1;
  return (int)(((want + CH - 1) / CH) * CH);
}

// value x of the augmented row vector [Mn_0 .. Mn_{p-1}, r, Fd_0 ..] of set
// b at row i, centred and divided as the twin forms it
__device__ __forceinline__ double row_value(const Args &a, int b, int x, int i) {
  b = design_set(a, b);
  if (x < a.pn)
    return __ddiv_rn(__dsub_rn(a.M[((size_t)b * a.pn + x) * a.n + i], a.mean[(size_t)b * (a.p + 1) + 1 + x]),
                     a.norm[(size_t)b * a.pn + x]);
  if (x < a.p) return a.Gc[((size_t)b * (a.p - a.pn) + x - a.pn) * a.n + i];
  if (x == a.p) return __dsub_rn(a.r[(size_t)b * a.n + i], a.mean[(size_t)b * (a.p + 1)]);
  return a.Fd[(a.ws == 2 ? (size_t)b * a.kd * a.n : 0) + (size_t)(x - a.p - 1) * a.n + i];
}

// pass 1: set b's weighted mean of value x (0: r, 1 + j: M_j)
__global__ void __launch_bounds__(THREADS) mean_pass(Args a) {
  const int x = blockIdx.x, b = blockIdx.y;
  const double *v = x == 0 ? a.r + (size_t)b * a.n : a.M + ((size_t)b * a.p + x - 1) * a.n;
  double acc[2] = {0.0, 0.0};
  for (int i = threadIdx.x; i < a.n; i += THREADS) {
    acc[0] = __dadd_rn(acc[0], a.w[i]);
    acc[1] = __dadd_rn(acc[1], __dmul_rn(a.w[i], v[i]));
  }
  __shared__ double tot[2];
  block_sum<THREADS, 2>(acc, tot);
  if (threadIdx.x == 0) a.mean[(size_t)b * (a.p + 1) + x] = __ddiv_rn(tot[1], tot[0]);
}

// pass 2: set b's norm of column j
__global__ void __launch_bounds__(THREADS) norm_pass(Args a) {
  const int j = blockIdx.x, b = blockIdx.y;
  const double *v = a.M + ((size_t)b * a.pn + j) * a.n;
  const double m = a.mean[(size_t)b * (a.p + 1) + 1 + j];
  double acc[1] = {0.0};
  for (int i = threadIdx.x; i < a.n; i += THREADS) {
    const double x = __dsub_rn(v[i], m);
    acc[0] = __dadd_rn(acc[0], a.weighted ? __dmul_rn(__dmul_rn(a.w[i], x), x) : __dmul_rn(x, x));
  }
  __shared__ double tot[1];
  block_sum<THREADS, 1>(acc, tot);
  if (threadIdx.x == 0) a.norm[(size_t)b * a.pn + j] = tot[0] == 0.0 ? 1.0 : __dsqrt_rn(tot[0]);
}

// pass 3: epoch sums of w V (value x < V) and, for x == V, De (set 0)
__global__ void __launch_bounds__(THREADS) epoch_pass(Args a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x, x = blockIdx.y, b = blockIdx.z;
  const int V = a.p + 1 + a.kd;
  if (e >= a.ke || (!a.ws && b > 0 && x > a.p)) return;
  const double *w = a.w + w_off(a, b);
  const size_t psr = a.ws == 2 ? (size_t)design_set(a, b) : 0;  // the stacked mode's pulsar
  const int *offsets = a.offsets + psr * (a.ke + 1), *rows = a.rows + psr * a.nnz;
  double acc = 0.0;
  for (int k = offsets[e]; k < offsets[e + 1]; ++k) {
    const int i = rows[k];
    acc = __dadd_rn(acc, x < V ? __dmul_rn(w[i], row_value(a, b, x, i)) : w[i]);
  }
  if (x < V) a.esum[((size_t)b * a.ke + e) * V + x] = acc;
  else a.De[e_off(a, b) + e] = __dadd_rn(__ddiv_rn(1.0, a.ephi[e_off(a, b) + e]), acc);
}

// pass 4: one T x T tile (ta <= tc) of set b's partial over one segment
__global__ void __launch_bounds__(T * T) gram_pass(Args a) {
  const int V = a.p + 1 + a.kd, nt = tiles_of(V);
  int ta = 0, rest = blockIdx.x;  // the blockIdx.x-th tile of the upper triangle
  while (rest >= nt - ta) {
    rest -= nt - ta;
    ++ta;
  }
  const int tc = ta + rest, b = blockIdx.y, seg = blockIdx.z;
  if (!a.ws && b > 0 && ta * T > a.p) return;  // the Fd block: set 0's, where w is shared
  const int fb = a.ws ? b : 0;  // the set whose Fd block and epoch sums of Fd are read
  const double *w = a.w + w_off(a, b), *De = a.De + e_off(a, b);
  const bool epochs = seg >= a.row_segs;
  const int count = epochs ? a.ke : a.n;
  const int lo = (epochs ? seg - a.row_segs : seg) * a.seg_len;
  const int hi = min(count, lo + a.seg_len);
  __shared__ double sa[CH][T + 1], sc[CH][T + 1], sw[CH];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * T + tx;
  const int A = ta * T + ty, C = tc * T + tx;
  double total = 0.0;
  for (int first = lo; first < hi; first += CH) {
    for (int q = tid; q < CH * T; q += T * T) {
      const int k = q / T, col = q % T, i = first + k;
      double va = 0.0, vc = 0.0;
      if (i < hi) {
        const int xa = ta * T + col, xc = tc * T + col;
        if (!epochs) {
          if (xa < V) va = row_value(a, b, xa, i);
          if (xc < V) vc = row_value(a, b, xc, i);
        } else {
          if (xa < V) va = a.esum[((size_t)(xa > a.p ? fb : b) * a.ke + i) * V + xa];
          if (xc < V) vc = a.esum[((size_t)(xc > a.p ? fb : b) * a.ke + i) * V + xc];
        }
      }
      sa[k][col] = va;
      sc[k][col] = vc;
    }
    for (int k = tid; k < CH; k += T * T) {
      const int i = first + k;
      sw[k] = i >= hi ? 0.0 : !epochs ? w[i] : __ddiv_rn(1.0, De[i]);
    }
    __syncthreads();
    double acc = 0.0;
    const int m = min(CH, hi - first);
    for (int k = 0; k < m; ++k) acc = __dadd_rn(acc, __dmul_rn(__dmul_rn(sw[k], sa[k][ty]), sc[k][tx]));
    total = __dadd_rn(total, acc);
    __syncthreads();
  }
  if (A < V && C < V && A <= C) a.part[(((size_t)b * a.n_segs + seg) * V + A) * V + C] = total;
}

// pass 5: S1 = the rows' partials minus the epochs', in segment order
__global__ void __launch_bounds__(THREADS) s1_pass(Args a) {
  const int V = a.p + 1 + a.kd, b = blockIdx.y;
  const long q = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long)V * V) return;
  const int A = (int)(q / V), C = (int)(q % V);
  if (A > C || (!a.ws && b > 0 && A > a.p)) return;
  double rows = 0.0, epochs = 0.0;
  for (int s = 0; s < a.n_segs; ++s) {
    const double v = a.part[(((size_t)b * a.n_segs + s) * V + A) * V + C];
    if (s < a.row_segs) rows = __dadd_rn(rows, v);
    else epochs = __dadd_rn(epochs, v);
  }
  const double S = __dsub_rn(rows, epochs);
  a.S1[((size_t)b * V + A) * V + C] = S;
  a.S1[((size_t)b * V + C) * V + A] = S;
}

// pass 6: G, c, chi2 of set b from S1 and Wz (kd, p + 1)
__global__ void __launch_bounds__(THREADS)
fold_pass(const double *__restrict__ S1, const double *__restrict__ Wz, int p, int kd,
          double ridge, double *__restrict__ G, double *__restrict__ cvec,
          double *__restrict__ chi2) {
  const int b = blockIdx.x, V = p + 1 + kd, Q = (p + 1) * (p + 2) / 2;
  for (int q = threadIdx.x; q < Q; q += THREADS) {
    int i = 0, rest = q;  // entry q of the (p + 1) x (p + 1) upper triangle
    while (rest >= p + 1 - i) {
      rest -= p + 1 - i;
      ++i;
    }
    const int j = i + rest;
    double corr = 0.0;
    for (int k = 0; k < kd; ++k) {
      const double *wk = Wz + ((size_t)b * kd + k) * (p + 1);
      corr = __dadd_rn(corr, __dmul_rn(wk[i], wk[j]));
    }
    const double S = __dsub_rn(S1[((size_t)b * V + i) * V + j], corr);
    if (j < p) {
      const double g = i == j ? __dadd_rn(S, ridge) : S;
      G[((size_t)b * p + i) * p + j] = g;
      G[((size_t)b * p + j) * p + i] = g;
    } else if (i < p) {
      cvec[(size_t)b * p + i] = -S;
    } else {
      chi2[b] = S;
    }
  }
}

// pass 7: the epoch amplitudes (s_e - B_e ahat_d) / De_e (ws: B_e and De
// of set b)
__global__ void __launch_bounds__(THREADS)
ahat_pass(const double *__restrict__ esum, const double *__restrict__ De,
          const double *__restrict__ ad, int p, int ke, int kd, int ws, double *__restrict__ ahat) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y, V = p + 1 + kd;
  if (e >= ke) return;
  const size_t fe = (size_t)(ws ? b : 0) * ke + e;
  double bz = 0.0;
  for (int k = 0; k < kd; ++k)
    bz = __dadd_rn(bz, __dmul_rn(esum[fe * V + p + 1 + k], ad[(size_t)b * kd + k]));
  const double s = esum[((size_t)b * ke + e) * V + p];
  ahat[(size_t)b * (ke + kd) + e] = __ddiv_rn(kd > 0 ? __dsub_rn(s, bz) : s, De[ws ? fe : e]);
}

// ws: sum_i ln w_i of set b, in a fixed order
__global__ void __launch_bounds__(THREADS) logw_pass(Args a) {
  const int b = blockIdx.x;
  const double *w = a.w + (size_t)b * a.n;
  double acc[1] = {0.0};
  for (int i = threadIdx.x; i < a.n; i += THREADS)
    if (a.ws != 2 || w[i] != 0.0) acc[0] = __dadd_rn(acc[0], log(w[i]));  // stacked: no pad rows
  __shared__ double tot[1];
  block_sum<THREADS, 1>(acc, tot);
  if (threadIdx.x == 0) a.logw[b] = tot[0];
}

}  // namespace

// Passes 1-5. r (B, n), M (B, p, n), w (n,), Fd (kd, n), offsets (ke + 1,)
// int32, rows (offsets[ke],) int32, ephi (ke,); centre, weighted: 0 or 1.
// Outputs mean (B, p + 1) (r first), norm (B, p), esum (B, ke, V) and De
// (ke,) (scratch for passes 6-7), S1 (B, V, V), V = p + 1 + kd (the Fd
// block of sets b > 0 unwritten); part is scratch of
// ecorr_gram_part_size(B, p, n, ke, kd) doubles.
extern "C" long ecorr_gram_part_size(int B, int p, int n, int ke, int kd) {
  const int V = p + 1 + kd, len = segment_length(n, ke, V, B);
  const long segs = (n + len - 1) / len + (ke + len - 1) / len;
  return (long)B * segs * V * V;
}

namespace {

int launch_gram(const Args &a, cudaStream_t s) {
  const int B = a.B, p = a.p, V = p + 1 + a.kd, nt = tiles_of(V), ke = a.ke;
  const int mb = a.ws == 2 ? a.npsr : a.ws ? 1 : B;  // the (r, M) sets
  cudaError_t e;
  if (a.centre) {
    mean_pass<<<dim3(p + 1, mb), THREADS, 0, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  } else {
    if ((e = cudaMemsetAsync(a.mean, 0, sizeof(double) * mb * (p + 1), s)) != cudaSuccess)
      return e;
  }
  if (a.pn > 0) {
    norm_pass<<<dim3(a.pn, mb), THREADS, 0, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (a.ws) {
    logw_pass<<<B, THREADS, 0, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (ke > 0) {
    epoch_pass<<<dim3((ke + THREADS - 1) / THREADS, V + 1, B), THREADS, 0, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  gram_pass<<<dim3(nt * (nt + 1) / 2, B, a.n_segs), dim3(T, T), 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  s1_pass<<<dim3((V * V + THREADS - 1) / THREADS, B), THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const double *r, const double *M, const double *w, const double *Fd,
               const int *offsets, const int *rows, const double *ephi, int B, int p, int n,
               int ke, int kd, int centre, int weighted, double *mean, double *norm,
               double *esum, double *De, double *part, double *S1, int ws, double *logw,
               const double *Gc = nullptr, int pn = -1, int npsr = 1, int nnz = 0) {
  const int V = p + 1 + kd, len = segment_length(n, ke, V, B);
  const int row_segs = (n + len - 1) / len, n_segs = row_segs + (ke + len - 1) / len;
  return Args{r,        M,   w,        Fd,     offsets, rows, ephi, B,  p,    n,  ke, kd, centre,
              weighted, len, row_segs, n_segs, mean,    norm, esum, De, part, S1, ws, logw,
              Gc,       pn < 0 ? p : pn,       npsr,    nnz};
}

}  // namespace

extern "C" int ecorr_gram(const double *r, const double *M, const double *w, const double *Fd,
                          const int *offsets, const int *rows, const double *ephi, int B,
                          int p, int n, int ke, int kd, int centre, int weighted, double *mean,
                          double *norm, double *esum, double *De, double *part, double *S1,
                          void *stream) {
  if (p < 0 || p > PMAX || kd < 0 || kd > KDMAX || B < 1 || B > 65535 || n < 1 || ke < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_gram(make_args(r, M, w, Fd, offsets, rows, ephi, B, p, n, ke, kd, centre,
                               weighted, mean, norm, esum, De, part, S1, 0, nullptr),
                     static_cast<cudaStream_t>(stream));
}

// Passes 2-5 of the per-set-weight mode, and logw_pass. r (n,), M (p, n), w
// (E, n), Fd (kd, n), the CSR as above, ephi (E, ke). Outputs mean (p + 1,)
// zeros (no centring), norm (p,) unweighted, logw (E,) = sum_i ln w_i, esum
// (E, ke, V) and De (E, ke), S1 (E, V, V) whole; part is scratch of
// ecorr_gram_part_size(E, p, n, ke, kd) doubles.
extern "C" int ecorr_gram_sets(const double *r, const double *M, const double *w,
                               const double *Fd, const int *offsets, const int *rows,
                               const double *ephi, int E, int p, int n, int ke, int kd,
                               double *mean, double *norm, double *logw, double *esum,
                               double *De, double *part, double *S1, void *stream) {
  if (p < 0 || p > PMAX || kd < 0 || kd > KDMAX || E < 1 || E > 65535 || n < 1 || ke < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_gram(make_args(r, M, w, Fd, offsets, rows, ephi, E, p, n, ke, kd, 0, 0, mean,
                               norm, esum, De, part, S1, 1, logw),
                     static_cast<cudaStream_t>(stream));
}

// Passes 2-5 of the stacked mode, and logw_pass, over the E N sets s = e N +
// a. r (N, n), M (N, p, n), Gc (N, m, n), w (E, N, n), Fd (N, kd, n), offsets
// (N, ke + 1) and rows (N, nnz) int32 (each pulsar's CSR), ephi (E, N, ke).
// Outputs mean (N, p + m + 1) zeros, norm (N, p) unweighted, logw (E N,) =
// the sum of ln w_i over the rows with w_i > 0, esum (E N, ke, V), De (E N,
// ke), S1 (E N, V, V), V = p + m + 1 + kd; part is scratch of
// ecorr_gram_part_size(E N, p + m, n, ke, kd) doubles.
extern "C" int ecorr_gram_stacked(const double *r, const double *M, const double *Gc,
                                  const double *w, const double *Fd, const int *offsets,
                                  const int *rows, const double *ephi, int E, int N, int p, int m,
                                  int n, int ke, int kd, int nnz, double *mean, double *norm,
                                  double *logw, double *esum, double *De, double *part,
                                  double *S1, void *stream) {
  const long B = (long)E * N;
  if (p < 0 || m < 0 || p + m > PMAX || kd < 0 || kd > KDMAX || E < 1 || N < 1 || B > 65535 ||
      n < 1 || ke < 0 || nnz < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_gram(make_args(r, M, w, Fd, offsets, rows, ephi, (int)B, p + m, n, ke, kd, 0, 0,
                               mean, norm, esum, De, part, S1, 2, logw, Gc, p, N, nnz),
                     static_cast<cudaStream_t>(stream));
}

namespace {

int launch_fold(const double *S1, const double *Wz, const double *esum, const double *De,
                const double *ad, int B, int p, int ke, int kd, double ridge, int ws, double *G,
                double *c, double *chi2, double *ahat, cudaStream_t s) {
  if (p < 0 || p > PMAX || kd < 0 || kd > KDMAX || B < 1 || B > 65535 || ke < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fold_pass<<<B, THREADS, 0, s>>>(S1, Wz, p, kd, ridge, G, c, chi2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ke == 0) return static_cast<int>(e);
  ahat_pass<<<dim3((ke + THREADS - 1) / THREADS, B), THREADS, 0, s>>>(esum, De, ad, p, ke, kd,
                                                                      ws, ahat);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Passes 6-7. Wz (B, kd, p + 1), ad (B, kd); outputs G (B, p, p), c (B, p),
// chi2 (B,), and the epoch part of ahat (B, ke + kd).
extern "C" int ecorr_fold(const double *S1, const double *Wz, const double *esum,
                          const double *De, const double *ad, int B, int p, int ke, int kd,
                          double ridge, double *G, double *c, double *chi2, double *ahat,
                          void *stream) {
  return launch_fold(S1, Wz, esum, De, ad, B, p, ke, kd, ridge, 0, G, c, chi2, ahat,
                     static_cast<cudaStream_t>(stream));
}

// Passes 6-7 of the per-set-weight mode: the same outputs per weight set, B
// and De of set b (esum (E, ke, V), De (E, ke)).
extern "C" int ecorr_fold_sets(const double *S1, const double *Wz, const double *esum,
                               const double *De, const double *ad, int E, int p, int ke, int kd,
                               double ridge, double *G, double *c, double *chi2, double *ahat,
                               void *stream) {
  return launch_fold(S1, Wz, esum, De, ad, E, p, ke, kd, ridge, 1, G, c, chi2, ahat,
                     static_cast<cudaStream_t>(stream));
}

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
//   3. stage_pass: each (r, M) set's augmented rows X = [Mn, r, Fd] written
//      once into scratch, each value centred and divided as the twin forms
//      it, in column tiles of TW values (X[set][tile][row][TW], rows padded
//      to whole chunks and columns to whole tiles with zeros), so that every
//      later pass reads dense 16-byte rows and never divides again;
//   4. epoch_pass (ke > 0): a block stages its epochs' rows of X in shared
//      memory once, then one thread per (epoch, value) adds w X in CSR
//      order (the order of the twin's seg_sum) for each of up to EP_SETS
//      weight sets that share the (r, M) set: y, s and B, also staged in
//      X's tile layout, and, for set 0 (every set with per-set weights), De
//      and 1/De;
//   5. gram_pass: S1's upper triangle of TW x TW tile pairs on the float64
//      tensor cores (mma.sync .f64): one block per tile pair, group of
//      weight sets and segment of the rows (or of the epochs, weights
//      1/De); each warp owns a 32 x 32 register tile of one set, A = w X
//      formed once per staged value, B = X (only the fragments that hold
//      an entry of the upper triangle inside V), over chunks of CH rows that a
//      ring of STAGES shared-memory buffers receives by cp.async while the
//      previous chunk's products run; each segment's partial is written
//      whole; the set-independent Fd block only for set 0. Segments are as
//      long as it takes to give the card TARGET_WARPS warps;
//   6. s1_pass: one thread (or, past S1_WARP_SEGS segments, one warp) per
//      entry and set folds the segments' partials in a fixed order, rows
//      minus epochs, into S1 (symmetric);
//   (the host factors Rd and solves for Wz and ahat_d)
//   7. fold_pass: one block per set writes G (symmetric), c and chi2;
//   8. ahat_pass (ke > 0): one thread per (epoch, set).
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
// set for the white term of ln|C|. A set's arithmetic does not depend on
// how many sets share its block, so the mode at E = 1 is bitwise the
// shared-weight mode at B = 1.
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
// Bound, and what the design does about it. The Gram is ~(N + ke) V^2 / 2
// multiply-adds per weight set (V = p + 1 + kd: 142 for the noise likelihood
// and the wideband and NANOGrav fits, 29 for the PTA's pulsars, 15 for the
// flagship), against N V doubles of X and N of w: with many sets (the noise
// and PTA likelihoods at E >= 8, the grids) the float64 tensor cores' rate
// bounds it; at one set and V ~ 15-30 the bytes, and there the passes'
// launches and the fold dominate. So the Gram runs on the tensor cores
// (mma.sync m16n8k8 .f64) and not on the vector pipe, computing only the fragments that hold an entry of
// the upper triangle; X is staged once, not centred and divided again for
// every tile that reads it; one block reads each chunk of X once for its
// whole group of up to 8 weight sets (the per-set and stacked modes), and
// the epoch pass reads each epoch's rows once for up to EP_SETS sets, so
// X's bytes are paid once per group and not once per set; and a ring of
// cp.async chunk loads overlaps the products. Tiles are 32 wide where V
// fits one or the blocks group several sets (V = 142 pads to 160), else 64
// (four warps share each staged chunk; V = 142 pads to 192).
#include <algorithm>

#include "block_sum.cuh"
#include "dd.cuh"
#include "mma_f64.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

using pint::block_sum;

constexpr int THREADS = 256;
constexpr int RED = 1024;   // threads of the row reductions (mean, norm, ln w)
constexpr int CH = 32;      // rows (or epochs) per staged chunk
constexpr int STAGES = 3;   // chunk buffers in the cp.async ring
constexpr int PAD = 8;      // shared row stride TW + PAD: conflict-free fragment loads
constexpr int GRAM_WARPS = 8;  // a gram block's warps when a group fills it
constexpr int PMAX = 256, KDMAX = 512;
constexpr long TARGET_WARPS = 2112;  // gram_pass warps to aim for: 16 per SM
constexpr int MIN_SEG = 4 * CH;      // the shortest segment
constexpr int S1_WARP_SEGS = 32;     // s1_pass folds more segments a warp per entry
constexpr int EP_SETS = 32;      // weight sets one epoch_pass block sums
constexpr int EP_VALUES = 4096;  // X values (its epochs' rows x tile) an epoch_pass block stages

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
  // the staged values X (mb, nt, nP, tw) of the (r, M) sets and the epoch
  // sums Es (B, nt, keP, tw), zero past n (ke) and V; 1/De (B, keP; set 0's
  // alone where w is shared)
  int tw, nt, nP, keP, mb;
  double *X, *Es, *iDe;
};

// the offsets of set b's weights and of its per-epoch values (De, phi_e)
__device__ __forceinline__ size_t w_off(const Args &a, int b) { return a.ws ? (size_t)b * a.n : 0; }
__device__ __forceinline__ size_t e_off(const Args &a, int b) { return a.ws ? (size_t)b * a.ke : 0; }

// the tile width: 32 where V fits one tile or where blocks group several
// weight sets (more sets share a block's staged X, and a 142-wide Gram pads
// to 160, not 192), else 64 (four warps share each staged chunk). `pts`:
// the weight sets of each (r, M) set, so one set alone tiles alike in every
// mode
__host__ __device__ inline int tile_width(int V, int pts) {
  return V <= 32 || pts > 1 ? 32 : 64;
}
__host__ __device__ inline int round_up(long x, int m) { return (int)((x + m - 1) / m * m); }

// rows (and epochs) per gram_pass segment: whole chunks, enough segments
// for TARGET_WARPS warps over the B sets' tile pairs
inline int segment_length(int n, int ke, int V, int B, int pts) {
  const int tw = tile_width(V, pts), nt = (V + tw - 1) / tw, wps = (tw / 32) * (tw / 32);
  const long warps = (long)nt * (nt + 1) / 2 * B * wps;
  return round_up(std::max<long>((n + ke) * warps / TARGET_WARPS + 1, MIN_SEG), CH);
}

// value x of the augmented row vector [Mn_0 .. Mn_{p-1}, r, Fd_0 ..] of the
// (r, M) set d at row i, centred and divided as the twin forms it
__device__ __forceinline__ double row_value(const Args &a, int d, int x, int i) {
  if (x < a.pn)
    return __ddiv_rn(__dsub_rn(a.M[((size_t)d * a.pn + x) * a.n + i], a.mean[(size_t)d * (a.p + 1) + 1 + x]),
                     a.norm[(size_t)d * a.pn + x]);
  if (x < a.p) return a.Gc[((size_t)d * (a.p - a.pn) + x - a.pn) * a.n + i];
  if (x == a.p) return __dsub_rn(a.r[(size_t)d * a.n + i], a.mean[(size_t)d * (a.p + 1)]);
  return a.Fd[(a.ws == 2 ? (size_t)d * a.kd * a.n : 0) + (size_t)(x - a.p - 1) * a.n + i];
}

// pass 1: set b's weighted mean of value x (0: r, 1 + j: M_j)
__global__ void __launch_bounds__(RED) mean_pass(Args a) {
  const int x = blockIdx.x, b = blockIdx.y;
  const double *v = x == 0 ? a.r + (size_t)b * a.n : a.M + ((size_t)b * a.p + x - 1) * a.n;
  double acc[2] = {0.0, 0.0};
  for (int i = threadIdx.x; i < a.n; i += RED) {
    acc[0] = __dadd_rn(acc[0], a.w[i]);
    acc[1] = __dadd_rn(acc[1], __dmul_rn(a.w[i], v[i]));
  }
  __shared__ double tot[2];
  block_sum<RED, 2>(acc, tot);
  if (threadIdx.x == 0) a.mean[(size_t)b * (a.p + 1) + x] = __ddiv_rn(tot[1], tot[0]);
}

// pass 2: set b's norm of column j
__global__ void __launch_bounds__(RED) norm_pass(Args a) {
  const int j = blockIdx.x, b = blockIdx.y;
  const double *v = a.M + ((size_t)b * a.pn + j) * a.n;
  const double m = a.mean[(size_t)b * (a.p + 1) + 1 + j];
  double acc[1] = {0.0};
  for (int i = threadIdx.x; i < a.n; i += RED) {
    const double x = __dsub_rn(v[i], m);
    acc[0] = __dadd_rn(acc[0], a.weighted ? __dmul_rn(__dmul_rn(a.w[i], x), x) : __dmul_rn(x, x));
  }
  __shared__ double tot[1];
  block_sum<RED, 1>(acc, tot);
  if (threadIdx.x == 0) a.norm[(size_t)b * a.pn + j] = tot[0] == 0.0 ? 1.0 : __dsqrt_rn(tot[0]);
}

constexpr int STAGE_ROWS = 32;  // stage_pass rows per block

// pass 3: rows [i0, i0 + 32) of column tile `tile` of (r, M) set d, read
// along the rows and written along the tile through shared memory
__global__ void __launch_bounds__(THREADS) stage_pass(Args a) {
  const int i0 = blockIdx.x * STAGE_ROWS, tile = blockIdx.y, d = blockIdx.z;
  const int tw = a.tw, V = a.p + 1 + a.kd;
  __shared__ double sm[STAGE_ROWS][64 + 1];
  for (int q = threadIdx.x; q < tw * STAGE_ROWS; q += THREADS) {
    const int c = q / STAGE_ROWS, k = q % STAGE_ROWS, x = tile * tw + c, i = i0 + k;
    sm[k][c] = x < V && i < a.n ? row_value(a, d, x, i) : 0.0;
  }
  __syncthreads();
  double *out = a.X + ((size_t)d * a.nt + tile) * a.nP * tw;
  for (int q = threadIdx.x; q < tw * STAGE_ROWS; q += THREADS) {
    const int k = q / tw, c = q % tw;
    if (i0 + k < a.nP) out[(size_t)(i0 + k) * tw + c] = sm[k][c];
  }
}

// pass 4: the epoch sums of w X over tile `tile` for a group of up to
// EP_SETS weight sets of one (r, M) set q (blockIdx.z: q, sets e0 + g as in
// gram_pass): where it sums several sets, the block stages its epochs' rows
// of X and their row ids in shared memory once (if they fit in EP_VALUES);
// then one thread per (epoch, value) adds w X over its epoch's rows in CSR
// order (the order of the twin's seg_sum) for each set in turn: into esum
// and, in X's tile layout, Es; the first value's thread also forms De and
// 1/De (set 0 only where the weights are shared)
__global__ void __launch_bounds__(THREADS) epoch_pass(Args a) {
  const int tw = a.tw, c = threadIdx.x % tw, per = THREADS / tw, tile = blockIdx.y;
  const int e = blockIdx.x * per + threadIdx.x / tw;
  const int np = a.ws == 2 ? a.npsr : a.ws ? 1 : a.B, q = blockIdx.z % np;
  const int e0 = blockIdx.z / np * EP_SETS, ng = min(EP_SETS, a.B / np - e0);
  const int V = a.p + 1 + a.kd, x = tile * tw + c;
  const size_t psr = a.ws == 2 ? (size_t)q : 0;  // the stacked mode's pulsar
  const int *offsets = a.offsets + psr * (a.ke + 1), *rows = a.rows + psr * a.nnz;
  const double *col = a.X + ((size_t)q * a.nt + tile) * a.nP * tw;
  const int ea = min(blockIdx.x * per, a.ke), eb = min(ea + per, a.ke);
  const int r0 = offsets[ea], nr = offsets[eb] - r0;
  const bool staged = ng > 1 && nr * tw <= EP_VALUES;  // the same for the whole block
  __shared__ double sx[EP_VALUES];
  __shared__ int sr[EP_VALUES / 32];
  if (staged) {
    for (int k = threadIdx.x; k < nr; k += THREADS) sr[k] = rows[r0 + k];
    __syncthreads();
    for (int k = threadIdx.x; k < nr * tw; k += THREADS)
      sx[k] = col[(size_t)sr[k / tw] * tw + k % tw];
  }
  __syncthreads();
  if (e >= a.keP) return;
  const bool pad = e >= a.ke;  // the pad epochs of the last chunk: zero sums, zero weight
  const int k0 = pad ? 0 : offsets[e] - r0, k1 = pad ? 0 : offsets[e + 1] - r0;
  for (int g = 0; g < ng; ++g) {
    const int s = (e0 + g) * np + q;
    const double *w = a.w + w_off(a, s);
    double acc = 0.0, accw = 0.0;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const int i = staged ? sr[k] : rows[r0 + k];
      const double xv = staged ? sx[k * tw + c] : col[(size_t)i * tw + c];
      acc = __dadd_rn(acc, __dmul_rn(w[i], xv));
      accw = __dadd_rn(accw, w[i]);
    }
    a.Es[(((size_t)s * a.nt + tile) * a.keP + e) * tw + c] = acc;
    if (!pad && x < V) a.esum[((size_t)s * a.ke + e) * V + x] = acc;
    if (x == 0 && (a.ws || s == 0)) {
      double *ide = a.iDe + (a.ws ? (size_t)s * a.keP : 0) + e;
      if (pad) {
        *ide = 0.0;
      } else {
        const double D = __dadd_rn(__ddiv_rn(1.0, a.ephi[e_off(a, s) + e]), accw);
        a.De[e_off(a, s) + e] = D;
        *ide = __ddiv_rn(1.0, D);
      }
    }
  }
}

// --- pass 5 on the tensor cores -------------------------------------------------

// the cp.async and mma.sync helpers (mma_f64.cuh); a warp's 32 x 32 tile of
// one set as m16n8k8 fragments: MI blocks of MR rows (the Gram's row index)
// by 4 blocks of 8 columns, KS products deep
using pint::cp_async16;
using pint::cp_async8;
using pint::cp_async_commit;
using pint::cp_async_wait;
using pint::KS;
using pint::mma;
using pint::MR;
using pint::NA;
using pint::NACC;
using pint::NB;
constexpr int MI = 32 / MR;

// the smem doubles of one ring stage: the two tiles' chunks, then gs
// weight vectors
template <int TW>
__host__ __device__ constexpr int stage_doubles(int gs) {
  return 2 * CH * (TW + PAD) + gs * CH;
}

// pass 5: tile pair blockIdx.x of the upper triangle, group blockIdx.y of
// gs weight sets, segment seg0 + blockIdx.z. Group y's sets: s = (e0 + g)
// np + q for g < gs with e0 + g < B / np, where q = y % np is the (r, M) set
// (np: 1 per-set, npsr stacked, B shared-weight) and e0 = (y / np) gs. Warp
// k works for set g = k / wps on quadrant k % wps of the tile pair. Rows
// read the (r, M) set's staged X, with w; epochs (gs = 1) the set's staged
// epoch sums, with 1/De; 16 bytes a copy.
template <int TW>
__global__ void __launch_bounds__(GRAM_WARPS * 32) gram_pass(Args a, int gs, int seg0) {
  constexpr int WPS = (TW / 32) * (TW / 32), LD = TW + PAD;
  const int V = a.p + 1 + a.kd, nt = a.nt, tid = threadIdx.x, warp = tid >> 5;
  int ta = 0, rest = blockIdx.x;  // the blockIdx.x-th tile pair of the upper triangle
  while (rest >= nt - ta) {
    rest -= nt - ta;
    ++ta;
  }
  const int tc = ta + rest, seg = seg0 + blockIdx.z;
  const int np = a.ws == 2 ? a.npsr : a.ws ? 1 : a.B, q = blockIdx.y % np;
  const int e0 = blockIdx.y / np * gs, n_pts = a.B / np;
  if (!a.ws && q > 0 && ta * TW > a.p) return;  // the Fd block: set 0's, where w is shared
  const bool epochs = seg >= a.row_segs;
  const int count = epochs ? a.ke : a.n;
  const int lo = (epochs ? seg - a.row_segs : seg) * a.seg_len;
  const int hi = min(count, lo + a.seg_len);
  // this block's source tiles: the (r, M) set's staged X for rows, the
  // (only) set's staged epoch sums for epochs; slot 0 holds tile ta, slot 1
  // tile tc where it differs
  const int s0 = e0 * np + q;  // the group's first set
  const double *src = epochs ? a.Es + (size_t)s0 * nt * a.keP * TW
                             : a.X + (size_t)q * nt * a.nP * TW;
  const size_t tile_len = (size_t)(epochs ? a.keP : a.nP) * TW;
  const bool diag = ta == tc;
  extern __shared__ __align__(16) double smem[];
  const int stage = stage_doubles<TW>(gs);
  const int nthr = blockDim.x;
  auto load = [&](int first, int st) {
    double *sA = smem + (size_t)st * stage, *sw = sA + 2 * CH * LD;
    for (int k = tid; k < (diag ? 1 : 2) * CH * TW / 2; k += nthr) {
      const int slot = k / (CH * TW / 2), r = k % (CH * TW / 2);
      const int row = r / (TW / 2), col = (r % (TW / 2)) * 2;
      cp_async16(sA + (slot * CH + row) * LD + col,
                 src + (slot ? tc : ta) * tile_len + (size_t)(first + row) * TW + col);
    }
    for (int k = tid; k < gs * CH; k += nthr) {
      const int g = k / CH, row = k % CH, i = first + row;
      const bool valid = i < hi && e0 + g < n_pts;
      const int ic = valid ? i : lo;  // a valid address where nothing is read
      const int s = (e0 + (valid ? g : 0)) * np + q;
      const double *src = (epochs ? a.iDe + (a.ws ? (size_t)s * a.keP : 0)
                                  : a.w + (a.ws ? (size_t)s * a.n : 0)) + ic;
      cp_async8(sw + k, src, valid);
    }
  };
  // this warp's set and quadrant; a diagonal pair's lower quadrant is not needed
  const int lane = tid & 31, g = warp / WPS, quad = warp % WPS;
  const int qm = quad / (TW / 32), qn = quad % (TW / 32);
  const bool active = e0 + g < n_pts && !(diag && qm > qn);
  const int gi = lane >> 2, ti = lane & 3;
  const int am = qm * 32, cn = qn * 32;
  // the fragments that hold an entry of S1's upper triangle: the others
  // (below a diagonal tile's diagonal, or past V) are not computed
  bool need[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int A0 = ta * TW + am + i * MR, C0 = tc * TW + cn + j * 8;
      need[i][j] = A0 < V && C0 < V && A0 <= C0 + 7;
    }
  double acc[MI][4][NACC];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < NACC; ++h) acc[i][j][h] = 0.0;
  const int n_chunks = hi > lo ? (hi - lo + CH - 1) / CH : 0;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_chunks) load(lo + st * CH, st);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int nxt = ch + STAGES - 1;
    if (nxt < n_chunks) load(lo + nxt * CH, nxt % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    if (active) {
      const double *sA = smem + (size_t)(ch % STAGES) * stage;
      const double *sC = diag ? sA : sA + CH * LD;
      const double *sw = sA + 2 * CH * LD + g * CH;
#pragma unroll
      for (int k0 = 0; k0 < CH; k0 += KS) {
        double av[MI][NA], bv[4][NB];
#pragma unroll
        for (int kh = 0; kh < KS / 4; ++kh) {  // the lane's rows k0 + ti (+ 4)
          const int k = k0 + ti + 4 * kh;
          const double wk = sw[k];
          const double *ra = sA + k * LD + am + gi, *rc = sC + k * LD + cn + gi;
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int mh = 0; mh < MR / 8; ++mh)
              av[i][kh * (MR / 8) + mh] = __dmul_rn(wk, ra[i * MR + 8 * mh]);
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j][kh] = rc[j * 8];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (need[i][j]) mma(acc[i][j], av[i], bv[j]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (!active) return;
  const int s = (e0 + g) * np + q;
  double *out = a.part + ((size_t)s * a.n_segs + seg) * V * V;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < NACC; ++h) {
        const int A = ta * TW + am + i * MR + gi + 8 * (h >> 1);
        const int C = tc * TW + cn + j * 8 + 2 * ti + (h & 1);
        if (A < V && C < V && A <= C) out[(size_t)A * V + C] = acc[i][j][h];
      }
}

// pass 6: S1 = the rows' partials minus the epochs', in segment order; with
// many segments a warp per entry (LANES = 32): lane l adds segments l, l +
// 32, ... in order, then the lanes' sums fold in a fixed tree
template <int LANES>
__global__ void __launch_bounds__(THREADS) s1_pass(Args a) {
  const int V = a.p + 1 + a.kd, b = blockIdx.y, lane = threadIdx.x % LANES;
  const long q = ((long)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  if (q >= (long)V * V) return;
  const int A = (int)(q / V), C = (int)(q % V);
  if (A > C || (!a.ws && b > 0 && A > a.p)) return;
  const size_t VV = (size_t)V * V;
  const double *part = a.part + (size_t)b * a.n_segs * VV + (size_t)A * V + C;
  double rows = 0.0, epochs = 0.0;
#pragma unroll 4
  for (int s = lane; s < a.row_segs; s += LANES) rows = __dadd_rn(rows, part[s * VV]);
#pragma unroll 4
  for (int s = a.row_segs + lane; s < a.n_segs; s += LANES) epochs = __dadd_rn(epochs, part[s * VV]);
  if (LANES > 1) {
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) {
      rows = __dadd_rn(rows, __shfl_down_sync(0xffffffffu, rows, off));
      epochs = __dadd_rn(epochs, __shfl_down_sync(0xffffffffu, epochs, off));
    }
  }
  if (lane == 0) {
    const double S = __dsub_rn(rows, epochs);
    a.S1[((size_t)b * V + A) * V + C] = S;
    a.S1[((size_t)b * V + C) * V + A] = S;
  }
}

// pass 7: G, c, chi2 of set b from S1 and Wz (kd, p + 1)
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

// pass 8: the epoch amplitudes (s_e - B_e ahat_d) / De_e (ws: B_e and De
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
__global__ void __launch_bounds__(RED) logw_pass(Args a) {
  const int b = blockIdx.x;
  const double *w = a.w + (size_t)b * a.n;
  double acc[1] = {0.0};
  for (int i = threadIdx.x; i < a.n; i += RED)
    if (a.ws != 2 || w[i] != 0.0) acc[0] = __dadd_rn(acc[0], log(w[i]));  // stacked: no pad rows
  __shared__ double tot[1];
  block_sum<RED, 1>(acc, tot);
  if (threadIdx.x == 0) a.logw[b] = tot[0];
}

// the scratch of one gram call, in doubles: the segments' partials, then
// X, Es and 1/De (each a whole number of 16-byte units)
struct Scratch {
  long part, X, Es, iDe;
};

Scratch scratch_of(int B, int mb, int p, int n, int ke, int kd) {
  const int V = p + 1 + kd, pts = B / mb, len = segment_length(n, ke, V, B, pts);
  const int tw = tile_width(V, pts);
  const int nt = (V + tw - 1) / tw;
  const long segs = (n + len - 1) / len + (ke + len - 1) / len;
  return Scratch{round_up((long)B * segs * V * V, 2), (long)mb * nt * round_up(n, CH) * tw,
                 (long)B * nt * round_up(ke, CH) * tw, (long)B * round_up(ke, CH)};
}

}  // namespace

// The scratch (doubles) of a gram call over B weight sets and mb (r, M)
// sets (shared-weight mode: mb = B; per-set mode: 1; stacked: the pulsars,
// p then counting the common block's columns too).
extern "C" long ecorr_gram_scratch_size(int B, int mb, int p, int n, int ke, int kd) {
  const Scratch s = scratch_of(B, mb, p, n, ke, kd);
  return s.part + s.X + s.Es + s.iDe;
}

namespace {

template <int TW>
cudaError_t launch_gram_tiles(const Args &a, int gs, int groups, int seg0, int segs,
                              cudaStream_t s) {
  constexpr int wps = (TW / 32) * (TW / 32);
  const int smem = STAGES * 8 * stage_doubles<TW>(GRAM_WARPS / wps);
  static const cudaError_t configured =  // once: the ring exceeds 48 KB at TW = 64
      cudaFuncSetAttribute(gram_pass<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (configured != cudaSuccess) return configured;
  const int pairs = a.nt * (a.nt + 1) / 2;
  gram_pass<TW><<<dim3(pairs, groups, segs), 32 * wps * gs, smem, s>>>(a, gs, seg0);
  return cudaGetLastError();
}

cudaError_t launch_gram_pass(const Args &a, int gs, int groups, int seg0, int segs,
                             cudaStream_t s) {
  if (segs == 0) return cudaSuccess;
  return a.tw == 32 ? launch_gram_tiles<32>(a, gs, groups, seg0, segs, s)
                    : launch_gram_tiles<64>(a, gs, groups, seg0, segs, s);
}

int launch_gram(const Args &a, cudaStream_t s) {
  const int B = a.B, p = a.p, V = p + 1 + a.kd, ke = a.ke, tw = a.tw, nt = a.nt;
  cudaError_t e;
  if (a.centre) {
    mean_pass<<<dim3(p + 1, a.mb), RED, 0, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  } else {
    if ((e = cudaMemsetAsync(a.mean, 0, sizeof(double) * a.mb * (p + 1), s)) != cudaSuccess)
      return e;
  }
  if (a.pn > 0) {
    norm_pass<<<dim3(a.pn, a.mb), RED, 0, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (a.ws) {
    logw_pass<<<B, RED, 0, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  stage_pass<<<dim3((a.nP + STAGE_ROWS - 1) / STAGE_ROWS, nt, a.mb), THREADS, 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int np = a.ws == 2 ? a.npsr : a.ws ? 1 : B, pts = B / np;
  if (ke > 0) {
    const int per = THREADS / tw, egroups = np * ((pts + EP_SETS - 1) / EP_SETS);
    epoch_pass<<<dim3((a.keP + per - 1) / per, nt, egroups), THREADS, 0, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  // the rows in groups of up to GRAM_WARPS / wps weight sets that share an
  // (r, M) set; the epochs (their sums are per set) one set a block; one
  // launch for both where the groups are single sets
  const int gs = std::min(pts, GRAM_WARPS / ((tw / 32) * (tw / 32)));
  const int groups = np * ((pts + gs - 1) / gs);
  if (gs == 1) {
    e = launch_gram_pass(a, 1, B, 0, a.n_segs, s);
  } else {
    e = launch_gram_pass(a, gs, groups, 0, a.row_segs, s);
    if (e == cudaSuccess) e = launch_gram_pass(a, 1, B, a.row_segs, a.n_segs - a.row_segs, s);
  }
  if (e != cudaSuccess) return e;
  if (a.n_segs > S1_WARP_SEGS)
    s1_pass<32><<<dim3((V * V * 32 + THREADS - 1) / THREADS, B), THREADS, 0, s>>>(a);
  else
    s1_pass<1><<<dim3((V * V + THREADS - 1) / THREADS, B), THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const double *r, const double *M, const double *w, const double *Fd,
               const int *offsets, const int *rows, const double *ephi, int B, int p, int n,
               int ke, int kd, int centre, int weighted, double *mean, double *norm,
               double *esum, double *De, double *scratch, double *S1, int ws, double *logw,
               const double *Gc = nullptr, int pn = -1, int npsr = 1, int nnz = 0) {
  const int mb = ws == 2 ? npsr : ws ? 1 : B;
  const int V = p + 1 + kd, len = segment_length(n, ke, V, B, B / mb);
  const Scratch sc = scratch_of(B, mb, p, n, ke, kd);
  Args a{};
  a.r = r, a.M = M, a.w = w, a.Fd = Fd, a.offsets = offsets, a.rows = rows, a.ephi = ephi;
  a.B = B, a.p = p, a.n = n, a.ke = ke, a.kd = kd, a.centre = centre, a.weighted = weighted;
  a.seg_len = len;
  a.row_segs = (n + len - 1) / len;
  a.n_segs = a.row_segs + (ke + len - 1) / len;
  a.mean = mean, a.norm = norm, a.esum = esum, a.De = De, a.S1 = S1, a.ws = ws, a.logw = logw;
  a.Gc = Gc, a.pn = pn < 0 ? p : pn, a.npsr = npsr, a.nnz = nnz;
  a.tw = tile_width(V, B / mb), a.nt = (V + a.tw - 1) / a.tw, a.nP = round_up(n, CH);
  a.keP = round_up(ke, CH), a.mb = mb;
  a.part = scratch;
  a.X = scratch + sc.part;
  a.Es = a.X + sc.X;
  a.iDe = a.Es + sc.Es;
  return a;
}

}  // namespace

// Passes 1-6. r (B, n), M (B, p, n), w (n,), Fd (kd, n), offsets (ke + 1,)
// int32, rows (offsets[ke],) int32, ephi (ke,); centre, weighted: 0 or 1.
// Outputs mean (B, p + 1) (r first), norm (B, p), esum (B, ke, V) and De
// (ke,) (scratch for passes 7-8), S1 (B, V, V), V = p + 1 + kd (the Fd
// block of sets b > 0 unwritten); scratch of ecorr_gram_scratch_size(B, B,
// p, n, ke, kd) doubles.
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

// Passes 2-6 of the per-set-weight mode, and logw_pass. r (n,), M (p, n), w
// (E, n), Fd (kd, n), the CSR as above, ephi (E, ke). Outputs mean (p + 1,)
// zeros (no centring), norm (p,) unweighted, logw (E,) = sum_i ln w_i, esum
// (E, ke, V) and De (E, ke), S1 (E, V, V) whole; scratch of
// ecorr_gram_scratch_size(E, 1, p, n, ke, kd) doubles.
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

// Passes 2-6 of the stacked mode, and logw_pass, over the E N sets s = e N +
// a. r (N, n), M (N, p, n), Gc (N, m, n), w (E, N, n), Fd (N, kd, n), offsets
// (N, ke + 1) and rows (N, nnz) int32 (each pulsar's CSR), ephi (E, N, ke).
// Outputs mean (N, p + m + 1) zeros, norm (N, p) unweighted, logw (E N,) =
// the sum of ln w_i over the rows with w_i > 0, esum (E N, ke, V), De (E N,
// ke), S1 (E N, V, V), V = p + m + 1 + kd; scratch of
// ecorr_gram_scratch_size(E N, N, p + m, n, ke, kd) doubles.
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

// Passes 7-8. Wz (B, kd, p + 1), ad (B, kd); outputs G (B, p, p), c (B, p),
// chi2 (B,), and the epoch part of ahat (B, ke + kd).
extern "C" int ecorr_fold(const double *S1, const double *Wz, const double *esum,
                          const double *De, const double *ad, int B, int p, int ke, int kd,
                          double ridge, double *G, double *c, double *chi2, double *ahat,
                          void *stream) {
  return launch_fold(S1, Wz, esum, De, ad, B, p, ke, kd, ridge, 0, G, c, chi2, ahat,
                     static_cast<cudaStream_t>(stream));
}

// Passes 7-8 of the per-set-weight mode: the same outputs per weight set, B
// and De of set b (esum (E, ke, V), De (E, ke)).
extern "C" int ecorr_fold_sets(const double *S1, const double *Wz, const double *esum,
                               const double *De, const double *ad, int E, int p, int ke, int kd,
                               double ridge, double *G, double *c, double *chi2, double *ahat,
                               void *stream) {
  return launch_fold(S1, Wz, esum, De, ad, E, p, ke, kd, ridge, 1, G, c, chi2, ahat,
                     static_cast<cudaStream_t>(stream));
}

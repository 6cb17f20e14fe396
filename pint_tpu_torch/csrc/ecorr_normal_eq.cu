// K3 ecorr_normal_eq: the Woodbury normal equations of the GLS fit and of
// the correlated chi^2 grid, with the ECORR epochs kept implicit.
//
// Replaces: the Woodbury algebra of pint_tpu/fitting/woodbury.py (seg_sum,
// s_factor, cinv_apply, woodbury_chi2 with an ECORR-only basis) as XLA
// fused it into the TPU programs gls_step (fitting/gls.py:77), gls_chi2
// (gls.py:193) and the correlated branch of grid (gridutils.py:143-170),
// with the step inputs those programs form first:
//   centre (the grid): r and every column lose their weighted mean
//     sum(w x)/sum(w) (gridutils.py:103-107, 132-134);
//   norm_j = sqrt(sum w M_j^2) (weighted, the grid, gridutils.py:135-137)
//     or sqrt(sum M_j^2) (the GLS step, gls.py:109-111), 1 where the sum
//     is 0; Mn = M / norm.
// Then, in block-Schur form, per parameter set b (a grid point; B = 1 for
// the fit):
//   De_e = 1/phi_e + sum_{i in e} w_i
//   y_e  = sum_{i in e} w_i Mn_i,   s_e = sum_{i in e} w_i r_i
//   G    = Mn^T W Mn - sum_e y_e y_e^T / De_e + ridge I
//   c    = -(Mn^T W r - sum_e y_e s_e / De_e)
//   chi2 = r^T W r - sum_e s_e^2 / De_e,       ahat_e = s_e / De_e
// M (B, p, N) is the raw design, column before row; w (N,) is shared by
// the sets; the epochs come as a CSR (offsets (ke + 1), row ids).
//
// Determinism (ROADMAP C3): no atomics, every sum in a fixed order, so a
// result is bitwise the same run after run. Up to six passes on one stream:
//   1. mean_pass (centre only): per 1024-row tile, block sums of w, w r and
//      w M_j;
//   2. norm_pass (p > 0): every block folds pass 1's partials in tile order
//      into the means, then writes its tile's sums of w (M_j - m_j)^2 or
//      (M_j - m_j)^2;
//   3. stats_pass: one block per set folds both, in tile order, into the
//      means (0 without centring) and the norms;
//   4. epoch_pass: one thread per (epoch, set) adds its rows in CSR order,
//      each value centred and divided by its norm as it is read: De, y, s,
//      ahat (the order of the twin's seg_sum);
//   5. tile_pass: one block per (tile, set): a tile of 64 rows or of 64
//      epochs is staged in shared memory (rows centred and divided as they
//      are staged), and thread q sums entry q of the upper triangle of the
//      augmented Gram [Mn, r]^T W [Mn, r] over the tile (rows), or of
//      sum_e v v^T / De with v = [y, s] (epochs), in order;
//   6. fold_pass: one block per set folds the tiles' partials in tile order,
//      rows minus epochs, and writes G (symmetric), c and chi2.
//
// Instances: P = 0 .. 20 design columns. The fitters take whatever set of
// parameters the user frees (the flagship fit frees 14, and freezing one
// makes 13), so every width up to the register budget of pass 5 must work;
// the instances are small and build in seconds.
//
// Bound: device-memory bytes. The work is ~N (p + 1)(p + 2)/2 multiply-adds
// per set against N (p + 1) + N doubles read, under ~p/2 operations per byte:
// below the H100's float64 ridge (~10 per byte) for p <= 20. Pass 5 re-reads
// each tile once from shared memory per entry, never from device memory.
#include "block_sum.cuh"
#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

using pint::block_sum;

constexpr int THREADS = 256;
constexpr int TILE = 64;            // rows, or epochs, per pass-5 block
constexpr int STILE = THREADS * 4;  // rows per pass-1/2 block
constexpr int PMAX = 20;  // (PMAX + 1)(PMAX + 2)/2 = 231 entries <= THREADS

__host__ __device__ constexpr int n_entries(int p) { return (p + 1) * (p + 2) / 2; }
__host__ __device__ constexpr int at_least_1(int p) { return p > 0 ? p : 1; }

// entry q of the upper triangle of a (p + 1) x (p + 1) matrix, row by row
__device__ __forceinline__ void entry(int p, int q, int &a, int &b) {
  a = 0;
  while (q >= p + 1 - a) {
    q -= p + 1 - a;
    ++a;
  }
  b = a + q;
}

// Set b's weighted means [r, M_0 .. M_{P-1}] into shared `mean`, folded from
// pass 1's partials in tile order (zeros without centring).
template <int P>
__device__ __forceinline__ void fold_means(const double *__restrict__ mpart, int b,
                                           int s_tiles, int centre, double *mean) {
  for (int x = threadIdx.x; x < P + 1; x += THREADS) {
    double m = 0.0;
    if (centre) {
      double sw = 0.0, s = 0.0;
      for (int t = 0; t < s_tiles; ++t) {
        const double *pt = mpart + ((size_t)b * s_tiles + t) * (P + 2);
        sw = __dadd_rn(sw, pt[0]);
        s = __dadd_rn(s, pt[1 + x]);
      }
      m = __ddiv_rn(s, sw);
    }
    mean[x] = m;
  }
  __syncthreads();
}

template <int P>
__global__ void __launch_bounds__(THREADS)
mean_pass(const double *__restrict__ r, const double *__restrict__ M,
          const double *__restrict__ w, int n, double *__restrict__ mpart) {
  constexpr int Q = P + 2;
  const int tile = blockIdx.x, b = blockIdx.y;
  const double *rb = r + (size_t)b * n;
  const double *Mb = M + (size_t)b * P * n;
  double acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0.0;
  for (int i = tile * STILE + threadIdx.x; i < min(n, (tile + 1) * STILE); i += THREADS) {
    const double wi = w[i];
    acc[0] = __dadd_rn(acc[0], wi);
    acc[1] = __dadd_rn(acc[1], __dmul_rn(wi, rb[i]));
#pragma unroll
    for (int j = 0; j < P; ++j) acc[2 + j] = __dadd_rn(acc[2 + j], __dmul_rn(wi, Mb[(size_t)j * n + i]));
  }
  __shared__ double tot[Q];
  block_sum<THREADS, Q>(acc, tot);
  if (threadIdx.x < Q) mpart[((size_t)b * gridDim.x + tile) * Q + threadIdx.x] = tot[threadIdx.x];
}

template <int P>
__global__ void __launch_bounds__(THREADS)
norm_pass(const double *__restrict__ M, const double *__restrict__ w, int n, int centre,
          int weighted, const double *__restrict__ mpart, double *__restrict__ npart) {
  const int tile = blockIdx.x, b = blockIdx.y;
  __shared__ double mean[P + 1];
  fold_means<P>(mpart, b, gridDim.x, centre, mean);
  const double *Mb = M + (size_t)b * P * n;
  double acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) acc[j] = 0.0;
  for (int i = tile * STILE + threadIdx.x; i < min(n, (tile + 1) * STILE); i += THREADS) {
    const double wi = w[i];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const double x = __dsub_rn(Mb[(size_t)j * n + i], mean[1 + j]);
      acc[j] = __dadd_rn(acc[j], weighted ? __dmul_rn(__dmul_rn(wi, x), x) : __dmul_rn(x, x));
    }
  }
  __shared__ double tot[P];
  block_sum<THREADS, P>(acc, tot);
  if (threadIdx.x < P) npart[((size_t)b * gridDim.x + tile) * P + threadIdx.x] = tot[threadIdx.x];
}

template <int P>
__global__ void __launch_bounds__(THREADS)
stats_pass(const double *__restrict__ mpart, const double *__restrict__ npart, int s_tiles,
           int centre, double *__restrict__ mean, double *__restrict__ norm) {
  const int b = blockIdx.x;
  __shared__ double m[P + 1];
  fold_means<P>(mpart, b, s_tiles, centre, m);
  const int x = threadIdx.x;
  if (x < P + 1) mean[(size_t)b * (P + 1) + x] = m[x];
  if (x < P) {
    double s = 0.0;
    for (int t = 0; t < s_tiles; ++t) s = __dadd_rn(s, npart[((size_t)b * s_tiles + t) * P + x]);
    norm[(size_t)b * P + x] = s == 0.0 ? 1.0 : __dsqrt_rn(s);
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS)
epoch_pass(const double *__restrict__ r, const double *__restrict__ M,
           const double *__restrict__ w, const int *__restrict__ offsets,
           const int *__restrict__ rows, const double *__restrict__ phi,
           const double *__restrict__ mean, const double *__restrict__ norm, int n, int ke,
           double *__restrict__ esum, double *__restrict__ ahat) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x, b = blockIdx.y;
  if (e >= ke) return;
  const double *rb = r + (size_t)b * n;
  const double *Mb = M + (size_t)b * P * n;
  const double *mb = mean + (size_t)b * (P + 1);
  const double *nb = norm + (size_t)b * P;
  double sw = 0.0, s = 0.0, y[at_least_1(P)];
#pragma unroll
  for (int j = 0; j < P; ++j) y[j] = 0.0;
  for (int k = offsets[e]; k < offsets[e + 1]; ++k) {
    const int i = rows[k];
    const double wi = w[i];
    sw = __dadd_rn(sw, wi);
    s = __dadd_rn(s, __dmul_rn(wi, __dsub_rn(rb[i], mb[0])));
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const double mn = __ddiv_rn(__dsub_rn(Mb[(size_t)j * n + i], mb[1 + j]), nb[j]);
      y[j] = __dadd_rn(y[j], __dmul_rn(wi, mn));
    }
  }
  const double De = __dadd_rn(__ddiv_rn(1.0, phi[e]), sw);
  double *out = esum + ((size_t)b * ke + e) * (P + 2);
#pragma unroll
  for (int j = 0; j < P; ++j) out[j] = y[j];
  out[P] = s;
  out[P + 1] = De;
  ahat[(size_t)b * ke + e] = __ddiv_rn(s, De);
}

template <int P>
__global__ void __launch_bounds__(THREADS)
tile_pass(const double *__restrict__ r, const double *__restrict__ M,
          const double *__restrict__ w, const double *__restrict__ esum,
          const double *__restrict__ mean, const double *__restrict__ norm, int n, int ke,
          int row_tiles, double *__restrict__ part) {
  constexpr int V = P + 1;  // the augmented vector [Mn_0 .. Mn_{P-1}, r] or [y, s]
  constexpr int Q = n_entries(P);
  __shared__ double v[V][TILE];
  __shared__ double wt[TILE];  // w_i (rows) or 1/De_e (epochs)
  __shared__ double mv[V], nv[at_least_1(P)];  // means [M_0 .. M_{P-1}, r], norms
  const int t = blockIdx.x, b = blockIdx.y;
  const bool rows_tile = t < row_tiles;
  for (int x = threadIdx.x; x < V; x += THREADS)
    mv[x] = mean[(size_t)b * V + (x < P ? 1 + x : 0)];
  for (int x = threadIdx.x; x < P; x += THREADS) nv[x] = norm[(size_t)b * P + x];
  __syncthreads();
  const int first = (rows_tile ? t : t - row_tiles) * TILE;
  const int count = min(TILE, (rows_tile ? n : ke) - first);
  for (int x = threadIdx.x; x < (V + 1) * TILE; x += THREADS) {
    const int a = x / TILE, i = x % TILE;
    if (i >= count) continue;
    double val;
    if (rows_tile) {
      const size_t row = (size_t)first + i;
      if (a < P) val = __ddiv_rn(__dsub_rn(M[((size_t)b * P + a) * n + row], mv[a]), nv[a]);
      else if (a == P) val = __dsub_rn(r[(size_t)b * n + row], mv[P]);
      else val = w[row];
    } else {
      const double *es = esum + ((size_t)b * ke + first + i) * (P + 2);
      val = a < V ? es[a] : __ddiv_rn(1.0, es[P + 1]);
    }
    if (a < V) v[a][i] = val;
    else wt[i] = val;
  }
  __syncthreads();
  const int q = threadIdx.x;
  if (q >= Q) return;
  int a, c;
  entry(P, q, a, c);
  double acc = 0.0;
  for (int i = 0; i < count; ++i)
    acc = __dadd_rn(acc, __dmul_rn(__dmul_rn(wt[i], v[a][i]), v[c][i]));
  part[((size_t)b * gridDim.x + t) * Q + q] = acc;
}

template <int P>
__global__ void __launch_bounds__(THREADS)
fold_pass(const double *__restrict__ part, int row_tiles, int n_parts, double ridge,
          double *__restrict__ G, double *__restrict__ cvec, double *__restrict__ chi2) {
  constexpr int Q = n_entries(P);
  const int b = blockIdx.x, q = threadIdx.x;
  if (q >= Q) return;
  const double *pb = part + (size_t)b * n_parts * Q + q;
  double rows = 0.0, epochs = 0.0;
  for (int t = 0; t < row_tiles; ++t) rows = __dadd_rn(rows, pb[(size_t)t * Q]);
  for (int t = row_tiles; t < n_parts; ++t) epochs = __dadd_rn(epochs, pb[(size_t)t * Q]);
  const double S = __dsub_rn(rows, epochs);
  int a, c;
  entry(P, q, a, c);
  if (c < P) {
    G[((size_t)b * P + a) * P + c] = a == c ? __dadd_rn(S, ridge) : S;
    G[((size_t)b * P + c) * P + a] = a == c ? __dadd_rn(S, ridge) : S;
  } else if (a < P) {
    cvec[(size_t)b * P + a] = -S;
  } else {
    chi2[b] = S;
  }
}

struct Args {
  const double *r, *M, *w;
  const int *offsets, *rows;
  const double *phi;
  int B, n, ke, centre, weighted;
  double ridge;
  double *mpart, *npart, *mean, *esum, *part, *G, *c, *chi2, *ahat, *norm;
};

template <int P>
cudaError_t launch(const Args &a, cudaStream_t s) {
  const int s_tiles = (a.n + STILE - 1) / STILE;
  const int row_tiles = (a.n + TILE - 1) / TILE, epoch_tiles = (a.ke + TILE - 1) / TILE;
  const int n_parts = row_tiles + epoch_tiles;
  cudaError_t e;
  if (a.centre) {
    mean_pass<P><<<dim3(s_tiles, a.B), THREADS, 0, s>>>(a.r, a.M, a.w, a.n, a.mpart);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if constexpr (P > 0) {
    norm_pass<P><<<dim3(s_tiles, a.B), THREADS, 0, s>>>(a.M, a.w, a.n, a.centre, a.weighted,
                                                        a.mpart, a.npart);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  stats_pass<P><<<a.B, THREADS, 0, s>>>(a.mpart, a.npart, s_tiles, a.centre, a.mean, a.norm);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.ke > 0) {
    epoch_pass<P><<<dim3((a.ke + THREADS - 1) / THREADS, a.B), THREADS, 0, s>>>(
        a.r, a.M, a.w, a.offsets, a.rows, a.phi, a.mean, a.norm, a.n, a.ke, a.esum, a.ahat);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  tile_pass<P><<<dim3(n_parts, a.B), THREADS, 0, s>>>(a.r, a.M, a.w, a.esum, a.mean, a.norm,
                                                      a.n, a.ke, row_tiles, a.part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fold_pass<P><<<a.B, THREADS, 0, s>>>(a.part, row_tiles, n_parts, a.ridge, a.G, a.c, a.chi2);
  return cudaGetLastError();
}

}  // namespace

// r (B, n), M (B, p, n), w (n,), offsets (ke + 1,) int32, rows (offsets[ke],)
// int32, phi (ke,); centre, weighted: 0 or 1. Scratch: mpart (B, s_tiles,
// p + 2) and npart (B, s_tiles, p) with s_tiles = ecorr_normal_eq_stat_tiles(n),
// mean (B, p + 1), esum (B, ke, p + 2) and part (B, parts, (p + 1)(p + 2)/2)
// with parts = ecorr_normal_eq_parts(n, ke). Outputs G (B, p, p), c (B, p),
// chi2 (B,), ahat (B, ke), norm (B, p).
extern "C" int ecorr_normal_eq(const double *r, const double *M, const double *w,
                               const int *offsets, const int *rows, const double *phi, int B,
                               int p, int n, int ke, int centre, int weighted, double ridge,
                               double *mpart, double *npart, double *mean, double *esum,
                               double *part, double *G, double *c, double *chi2, double *ahat,
                               double *norm, void *stream) {
  if (p < 0 || p > PMAX || B < 1 || B > 65535 || n < 1 || ke < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r,     M,     w,     offsets, rows, phi,  B, n,    ke,   centre, weighted,
               ridge, mpart, npart, mean,    esum, part, G, c,    chi2, ahat,   norm};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (p) {
#define PINT_CASE(P) \
  case P: e = launch<P>(a, s); break;
    PINT_CASE(0) PINT_CASE(1) PINT_CASE(2) PINT_CASE(3) PINT_CASE(4) PINT_CASE(5)
    PINT_CASE(6) PINT_CASE(7) PINT_CASE(8) PINT_CASE(9) PINT_CASE(10) PINT_CASE(11)
    PINT_CASE(12) PINT_CASE(13) PINT_CASE(14) PINT_CASE(15) PINT_CASE(16) PINT_CASE(17)
    PINT_CASE(18) PINT_CASE(19) PINT_CASE(20)
#undef PINT_CASE
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" int ecorr_normal_eq_parts(int n, int ke) {
  return (n + TILE - 1) / TILE + (ke + TILE - 1) / TILE;
}

extern "C" int ecorr_normal_eq_stat_tiles(int n) { return (n + STILE - 1) / STILE; }

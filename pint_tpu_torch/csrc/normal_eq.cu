// K2 normal_eq: the weighted normal equations of a batch of grid points.
//
// Replaces: the reductions of pint_tpu/gridutils.py _point_kernel.gn_step
// (the weighted mean subtraction of r and of every design column, the
// column norms sqrt(sum w M^2), G = Mn^T W Mn + ridge and c = Mn^T W (-r))
// and the grid point's chi^2 = sum w r^2, which XLA fused into the TPU's
// grid program under vmap.
//
// Per batch element b (a grid point), with rows i and columns j, k < P:
//   rm = r - sum(w r)/sum(w),  Mm_j = M_j - sum(w M_j)/sum(w)   (if centring)
//   S_jk = sum w Mm_j Mm_k,  t_j = sum w Mm_j rm,  chi2 = sum w rm^2
//   norm_j = sqrt(S_jj) (1 where S_jj == 0)
//   G_jk = S_jk / (norm_j norm_k) + ridge [j == k],  c_j = -t_j / norm_j
//
// Determinism: no atomics. Three launches on one stream:
//   1. per-tile partials of sum w, sum w r, sum w M_j        (grid tiles x B)
//   2. every block folds pass 1's partials of its b in tile order into the
//      means, then writes per-tile partials of the centred sums
//   3. one block per b folds pass 2's partials in tile order and forms
//      norm, G, c and chi2
// Within a block the sum runs in a fixed shuffle tree, then in warp order.
//
// Bound: device-memory bytes. A row costs (P + 1) doubles of r and M per
// grid point plus its weight, against ~(P^2 + 5P + 6) double operations:
// below one operation per byte, far under the H100's float64 ridge.
// Tiles of 1024 rows (256 threads x 4 coalesced rows) give 16 x 9 = 144
// blocks at N = 16384, B = 9: about one wave on 132 SMs.
#include "block_sum.cuh"
#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

using pint::block_sum;

constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = 4;
constexpr int TILE = THREADS * ROWS_PER_THREAD;
constexpr int PMAX = 12;  // the DD grid refits 10 parameters

__host__ __device__ constexpr int q1(int p) { return p + 2; }
__host__ __device__ constexpr int q2(int p) { return p * (p + 1) / 2 + p + 1; }

template <int P>
__global__ void __launch_bounds__(THREADS)
pass_means(const double *__restrict__ r, const double *__restrict__ M,
           const double *__restrict__ w, int n, double *__restrict__ part1) {
  constexpr int Q = q1(P);
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  const double *rb = r + (size_t)b * n;
  const double *Mb = M + (size_t)b * P * n;
  double acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0.0;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int i = tile * TILE + k * THREADS + threadIdx.x;
    if (i >= n) break;
    const double wi = w[i];
    acc[0] = __dadd_rn(acc[0], wi);
    acc[1] = __dadd_rn(acc[1], __dmul_rn(wi, rb[i]));
#pragma unroll
    for (int j = 0; j < P; ++j) acc[2 + j] = __dadd_rn(acc[2 + j], __dmul_rn(wi, Mb[(size_t)j * n + i]));
  }
  __shared__ double tot[Q];
  block_sum<THREADS, Q>(acc, tot);
  if (threadIdx.x < Q) part1[((size_t)b * n_tiles + tile) * Q + threadIdx.x] = tot[threadIdx.x];
}

template <int P>
__global__ void __launch_bounds__(THREADS)
pass_centred(const double *__restrict__ r, const double *__restrict__ M,
             const double *__restrict__ w, int n, int centre,
             const double *__restrict__ part1, double *__restrict__ part2) {
  constexpr int Q = q2(P);
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  __shared__ double mean[P + 1];  // mean of r, then of each column
  if (threadIdx.x < P + 1) {
    double m = 0.0;
    if (centre) {
      double sw = 0.0, s = 0.0;
      for (int t = 0; t < n_tiles; ++t) {
        const double *pt = part1 + ((size_t)b * n_tiles + t) * q1(P);
        sw = __dadd_rn(sw, pt[0]);
        s = __dadd_rn(s, pt[1 + threadIdx.x]);
      }
      m = __ddiv_rn(s, sw);
    }
    mean[threadIdx.x] = m;
  }
  __syncthreads();
  const double *rb = r + (size_t)b * n;
  const double *Mb = M + (size_t)b * P * n;
  double acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0.0;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int i = tile * TILE + k * THREADS + threadIdx.x;
    if (i >= n) break;
    const double wi = w[i];
    const double rm = __dsub_rn(rb[i], mean[0]);
    double mm[P > 0 ? P : 1];
#pragma unroll
    for (int j = 0; j < P; ++j) mm[j] = __dsub_rn(Mb[(size_t)j * n + i], mean[1 + j]);
    // layout: S_jk (j <= k, row-major upper triangle), then t_j, then chi2
    int q = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const double wm = __dmul_rn(wi, mm[j]);
#pragma unroll
      for (int kk = j; kk < P; ++kk) { acc[q] = __dadd_rn(acc[q], __dmul_rn(wm, mm[kk])); ++q; }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) acc[q + j] = __dadd_rn(acc[q + j], __dmul_rn(__dmul_rn(wi, mm[j]), rm));
    acc[Q - 1] = __dadd_rn(acc[Q - 1], __dmul_rn(__dmul_rn(wi, rm), rm));
  }
  __shared__ double tot[Q];
  block_sum<THREADS, Q>(acc, tot);
  for (int q = threadIdx.x; q < Q; q += THREADS)
    part2[((size_t)b * n_tiles + tile) * Q + q] = tot[q];
}

template <int P>
__global__ void __launch_bounds__(THREADS)
pass_solve_in(const double *__restrict__ part2, int n_tiles, double ridge,
              double *__restrict__ G, double *__restrict__ c, double *__restrict__ chi2,
              double *__restrict__ norm) {
  constexpr int Q = q2(P);
  const int b = blockIdx.x;
  __shared__ double S[Q];
  for (int q = threadIdx.x; q < Q; q += THREADS) {
    double s = 0.0;
    for (int t = 0; t < n_tiles; ++t) s = __dadd_rn(s, part2[((size_t)b * n_tiles + t) * Q + q]);
    S[q] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  double nrm[P > 0 ? P : 1];
  int q = 0;
  for (int j = 0; j < P; ++j) {
    const double d = S[q];  // S_jj opens row j of the triangle
    nrm[j] = d == 0.0 ? 1.0 : __dsqrt_rn(d);
    q += P - j;
  }
  q = 0;
  for (int j = 0; j < P; ++j) {
    for (int k = j; k < P; ++k) {
      const double g = __ddiv_rn(S[q++], __dmul_rn(nrm[j], nrm[k]));
      G[((size_t)b * P + j) * P + k] = j == k ? __dadd_rn(g, ridge) : g;
      G[((size_t)b * P + k) * P + j] = j == k ? __dadd_rn(g, ridge) : g;
    }
  }
  for (int j = 0; j < P; ++j) {
    c[(size_t)b * P + j] = -__ddiv_rn(S[q + j], nrm[j]);
    norm[(size_t)b * P + j] = nrm[j];
  }
  chi2[b] = S[Q - 1];
}

template <int P>
cudaError_t launch(const double *r, const double *M, const double *w, int B, int n, int centre,
                   double ridge, double *part1, double *part2, double *G, double *c,
                   double *chi2, double *norm, cudaStream_t s) {
  const int n_tiles = (n + TILE - 1) / TILE;
  const dim3 grid(n_tiles, B);
  cudaError_t e;
  if (centre) {
    pass_means<P><<<grid, THREADS, 0, s>>>(r, M, w, n, part1);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  pass_centred<P><<<grid, THREADS, 0, s>>>(r, M, w, n, centre, part1, part2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  pass_solve_in<P><<<B, THREADS, 0, s>>>(part2, n_tiles, ridge, G, c, chi2, norm);
  return cudaGetLastError();
}

}  // namespace

// r (B, n), M (B, p, n), w (n,); scratch part1 (B, tiles, p + 2) and
// part2 (B, tiles, p(p+1)/2 + p + 1), tiles = ceil(n / 1024); outputs
// G (B, p, p), c (B, p), chi2 (B,), norm (B, p).
extern "C" int normal_eq(const double *r, const double *M, const double *w, int B, int p, int n,
                         int centre, double ridge, double *part1, double *part2, double *G,
                         double *c, double *chi2, double *norm, void *stream) {
  if (p < 0 || p > PMAX || B < 1 || B > 65535 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (p) {
#define PINT_CASE(P) \
  case P: e = launch<P>(r, M, w, B, n, centre, ridge, part1, part2, G, c, chi2, norm, s); break;
    PINT_CASE(0) PINT_CASE(1) PINT_CASE(2) PINT_CASE(3) PINT_CASE(4)
    PINT_CASE(5) PINT_CASE(6) PINT_CASE(7) PINT_CASE(8) PINT_CASE(9)
    PINT_CASE(10) PINT_CASE(11) PINT_CASE(12)
#undef PINT_CASE
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" int normal_eq_tiles(int n) { return (n + TILE - 1) / TILE; }

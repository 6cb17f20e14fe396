// K8 linear_columns: the closed-form design columns of the exactly-linear
// timing parameters, and the Fourier columns of the power-law noise bases.
//
// Replaces: pint_tpu/fitting/design.py:48 linear_columns (the components'
// linear_resid_columns: DispersionDM dispersion.py:108-118, DispersionDMX
// dispersion.py:192-200, FD frequency_dependent.py:57-68, PhaseJump
// phase_misc.py:88-93) and pint_tpu/models/noise.py:246-259 fourier_basis
// with the DM-noise row scale of PLDMNoise (noise.py:477-484), as XLA fused
// them into the TPU programs wls_step, grid and gls_step.
//
// linear_columns: one thread per (row, column, parameter set). Column c of
// set b at row i is d(time residual)/d(param), written as the Python twins
// form it (fitting/design.py linear_columns_plain, models/*.py):
//   DM<k>  base (dt^k) / k!, base = -DMCONST / f_b^2 (0 where f_b is not
//          finite), dt = (t_hi - DMEPOCH) + t_lo
//   DMX_j  base * onehot[i, j]
//   FD<k>  -log(f_b / 1 GHz)^k (0 where f_b / 1 GHz is not finite and > 0)
//   JUMP_m mask_m[i] * F0 / f
// f_b is the barycentric frequency K1 wrote (its `fb` output), f the spin
// frequency at the data rows. With a TZR row (the tensor's last), the
// column's value there is subtracted, f at that row being its neighbour's.
// PyTorch computes `c / x` for a scalar c as reciprocal(x) * c and, on the
// card, `x / c` as x * (1 / c): the kernel spells both that way, so that the
// twin on the card reproduces it.
//
// fourier_basis: one thread per (row, frequency): sin and cos of
// (2 pi t_i) f_k into columns 2k and 2k + 1, times scale[i] when given
// ((1400 MHz / f)^2 for DM noise). Output (2 nf, N), columns before rows.
//
// Bound: device-memory bytes. Each output double costs a few operations (a
// log for FD, a sine and cosine per Fourier pair, ~40 operations) against
// 8 bytes written; the column pass reads ~2 doubles per row and set.
#include "dd.cuh"

PINT_EXPORT_ERROR_STRING

namespace {

constexpr int THREADS = 256;
constexpr int LMAX = 256;  // columns per launch
constexpr double TWO_PI = 6.283185307179586;  // 2.0 * math.pi
constexpr int KIND_DM = 0, KIND_DMX = 1, KIND_FD = 2, KIND_JUMP = 3;

struct Codes {
  int kind[LMAX];
  int idx[LMAX];
};

struct In {
  const double *fb, *f, *t_hi, *t_lo, *onehot, *masks, *f0;
  int n_rows, n_out, has_tzr, n_dmx;
  double dmepoch, dmconst;
};

__device__ __forceinline__ double fact(int n) {
  double f = 1.0;
  for (int i = 1; i <= n; ++i) f = __dmul_rn(f, (double)i);
  return f;
}

// the column's value at tensor row `row` of set b (`frow`: the data row
// whose spin frequency it takes)
__device__ double column_value(const In &in, int kind, int idx, int b, int row, int frow) {
  const double fb = in.fb[(size_t)b * in.n_rows + row];
  if (kind == KIND_DM || kind == KIND_DMX) {
    double base = 0.0;
    if (isfinite(fb)) base = __dmul_rn(__ddiv_rn(1.0, __dmul_rn(fb, fb)), -in.dmconst);
    if (kind == KIND_DMX) return __dmul_rn(base, in.onehot[(size_t)row * in.n_dmx + idx]);
    if (idx == 0) return base;
    const double dt = __dadd_rn(__dsub_rn(in.t_hi[row], in.dmepoch), in.t_lo[row]);
    double pw = 1.0;
    for (int k = 0; k < idx; ++k) pw = __dmul_rn(pw, dt);
    return __dmul_rn(__dmul_rn(base, pw), __ddiv_rn(1.0, fact(idx)));
  }
  if (kind == KIND_FD) {
    const double fg = __ddiv_rn(fb, 1e3);
    const bool finite = isfinite(fg) && fg > 0.0;
    const double lf = log(finite ? fg : 1.0);
    double pw = 1.0;
    for (int k = 0; k < idx; ++k) pw = __dmul_rn(pw, lf);
    return finite ? -pw : 0.0;
  }
  // KIND_JUMP
  const double m = in.masks[(size_t)idx * in.n_rows + row];
  return __ddiv_rn(__dmul_rn(m, in.f0[b]), in.f[(size_t)b * in.n_out + frow]);
}

// grid: (row blocks, columns, parameter sets)
__global__ void __launch_bounds__(THREADS)
linear_columns_kernel(In in, Codes codes, double *__restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (i >= in.n_out) return;
  const int kind = codes.kind[c], idx = codes.idx[c];
  double v = column_value(in, kind, idx, b, i, i);
  if (in.has_tzr) v = __dsub_rn(v, column_value(in, kind, idx, b, in.n_rows - 1, in.n_out - 1));
  out[((size_t)b * gridDim.y + c) * in.n_out + i] = v;
}

// grid: (row blocks, frequencies)
__global__ void __launch_bounds__(THREADS)
fourier_basis_kernel(const double *__restrict__ t, const double *__restrict__ freqs,
                     const double *__restrict__ scale, int n, double *__restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (i >= n) return;
  const double arg = __dmul_rn(__dmul_rn(TWO_PI, t[i]), freqs[k]);
  double s = sin(arg), c = cos(arg);
  if (scale != nullptr) {
    s = __dmul_rn(s, scale[i]);
    c = __dmul_rn(c, scale[i]);
  }
  out[(size_t)(2 * k) * n + i] = s;
  out[(size_t)(2 * k + 1) * n + i] = c;
}

}  // namespace

// fb (B, n_rows), f (B, n_out), t_hi and t_lo (n_rows,), onehot (n_rows,
// n_dmx), masks (jumps, n_rows), f0 (B,); codes: L kinds then L indices.
// out (B, L, n_out).
extern "C" int linear_columns(const double *fb, const double *f, const double *t_hi,
                              const double *t_lo, const double *onehot, const double *masks,
                              const double *f0, int B, int n_rows, int n_out, int has_tzr,
                              int n_dmx, int L, const int *codes, double dmepoch,
                              double dmconst, double *out, void *stream) {
  if (B < 1 || B > 65535 || L < 1 || L > LMAX || n_out < 1 || n_rows != n_out + has_tzr ||
      n_dmx < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Codes cc;
  for (int c = 0; c < L; ++c) {
    cc.kind[c] = codes[c];
    cc.idx[c] = codes[L + c];
    if (cc.kind[c] < KIND_DM || cc.kind[c] > KIND_JUMP || cc.idx[c] < 0 ||
        (cc.kind[c] == KIND_DMX && cc.idx[c] >= n_dmx))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const In in{fb, f, t_hi, t_lo, onehot, masks, f0, n_rows, n_out, has_tzr, n_dmx,
              dmepoch, dmconst};
  const dim3 grid((n_out + THREADS - 1) / THREADS, L, B);
  linear_columns_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(in, cc, out);
  return static_cast<int>(cudaGetLastError());
}

// t (n,), freqs (nf,), scale (n,) or null; out (2 nf, n)
extern "C" int fourier_basis(const double *t, const double *freqs, const double *scale, int n,
                             int nf, double *out, void *stream) {
  if (n < 1 || nf < 1 || nf > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + THREADS - 1) / THREADS, nf);
  fourier_basis_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(t, freqs, scale,
                                                                                n, out);
  return static_cast<int>(cudaGetLastError());
}

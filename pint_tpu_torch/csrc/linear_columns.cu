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
// dm_rows (the DM-row pass of the wideband fit): one thread per data row.
// Replaces the DM block of pint_tpu/fitting/wideband.py:40 _weighted_resids
// (models/timing_model.py:264 total_dm over dispersion.py:95 DispersionDM,
// :186 DispersionDMX and :206-225 DispersionJump) and its jax.linearize
// columns, inside the TPU programs wb_step (wideband.py:137) and wb_chi2
// (:216). Per row it forms the model DM in the twins' order (TimingModel.
// total_dm): ((0 + DM(t)) + DMX of the row's window) + (0 - sum of mask_m
// DMJUMP_m), DM(t) the Horner polynomial of ops/taylor.taylor_horner in
// dt = (t_hi - DMEPOCH) + t_lo (the DM value alone with one term); the
// weight sw = 1 / sigma where sigma is finite, else 0; the weighted
// residual (DM - dm_data) sw; and the weighted DM-row column of every fit
// parameter: DM<k> the Horner rule run on the k-th unit vector, DMX_j the
// window's indicator, DMJUMP_m -mask_m, any other parameter 0. Output: DM
// (N,), residual (N,), columns (L, N), columns before rows.
//
// Bound: device-memory bytes. Each output double costs a few operations (a
// log for FD, a sine and cosine per Fourier pair, ~40 operations) against
// 8 bytes written; the column pass reads ~2 doubles per row and set; the
// DM-row pass reads ~(4 + n_dmx + n_jump) doubles per row and writes L + 2.
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

constexpr int DM_KIND_NONE = 0, DM_KIND_DM = 1, DM_KIND_DMX = 2, DM_KIND_DMJUMP = 3;
constexpr int DM_HAS_DM = 1, DM_HAS_DMX = 2, DM_HAS_JUMP = 4;

struct DmIn {
  const double *t_hi, *t_lo, *coeffs, *onehot, *dmx, *masks, *jumps, *data, *sigma;
  int nd, n_dmx, n_jump, n_rows, n_out, parts;
  double dmepoch;
};

// ops/taylor.taylor_horner: acc = c_last / last!; acc = acc dt + c_i / i!,
// with c the coefficients (unit: the k-th unit vector, k >= 0)
__device__ double dm_horner(const DmIn &in, double dt, int unit) {
  const int last = in.nd - 1;
  const double cl = unit < 0 ? in.coeffs[last] : (unit == last ? 1.0 : 0.0);
  double acc = __ddiv_rn(cl, fact(last));
  for (int i = last - 1; i >= 0; --i) {
    const double c = unit < 0 ? in.coeffs[i] : (unit == i ? 1.0 : 0.0);
    acc = __dadd_rn(__dmul_rn(acc, dt), __ddiv_rn(c, fact(i)));
  }
  return acc;
}

// grid: row blocks
__global__ void __launch_bounds__(THREADS)
dm_rows_kernel(DmIn in, Codes codes, int L, double *__restrict__ total,
               double *__restrict__ resid, double *__restrict__ cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= in.n_out) return;
  const double dt = __dadd_rn(__dsub_rn(in.t_hi[i], in.dmepoch), in.t_lo[i]);
  double dm = 0.0;
  if (in.parts & DM_HAS_DM) dm = __dadd_rn(dm, in.nd == 1 ? in.coeffs[0] : dm_horner(in, dt, -1));
  if (in.parts & DM_HAS_DMX) {
    double w = 0.0;
    for (int j = 0; j < in.n_dmx; ++j)
      w = __dadd_rn(w, __dmul_rn(in.onehot[(size_t)i * in.n_dmx + j], in.dmx[j]));
    dm = __dadd_rn(dm, w);
  }
  if (in.parts & DM_HAS_JUMP) {
    double jv = 0.0;
    for (int m = 0; m < in.n_jump; ++m)
      jv = __dsub_rn(jv, __dmul_rn(in.masks[(size_t)m * in.n_rows + i], in.jumps[m]));
    dm = __dadd_rn(dm, jv);
  }
  const double s = in.sigma[i];
  const double sw = isfinite(s) ? __ddiv_rn(1.0, s) : 0.0;
  total[i] = dm;
  resid[i] = __dmul_rn(__dsub_rn(dm, in.data[i]), sw);
  for (int c = 0; c < L; ++c) {
    const int kind = codes.kind[c], idx = codes.idx[c];
    double v = 0.0;
    if (kind == DM_KIND_DM) v = __dmul_rn(in.nd == 1 ? 1.0 : dm_horner(in, dt, idx), sw);
    else if (kind == DM_KIND_DMX) v = __dmul_rn(in.onehot[(size_t)i * in.n_dmx + idx], sw);
    else if (kind == DM_KIND_DMJUMP) v = __dmul_rn(-in.masks[(size_t)idx * in.n_rows + i], sw);
    cols[(size_t)c * in.n_out + i] = v;
  }
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

// t_hi, t_lo (n_rows,); coeffs (nd,) the DM Taylor coefficients (nd >= 1
// with DM_HAS_DM in parts); onehot (n_rows, n_dmx), dmx (n_dmx,); masks
// (n_jump, n_rows), jumps (n_jump,); data, sigma (n_out,) the measured DMs
// and their scaled errors; codes: L kinds then L indices. Outputs total,
// resid (n_out,) and cols (L, n_out).
extern "C" int dm_rows(const double *t_hi, const double *t_lo, const double *coeffs, int nd,
                       double dmepoch, const double *onehot, const double *dmx, int n_dmx,
                       const double *masks, const double *jumps, int n_jump, const double *data,
                       const double *sigma, int n_rows, int n_out, int parts, int L,
                       const int *codes, double *total, double *resid, double *cols,
                       void *stream) {
  if (n_out < 1 || n_rows < n_out || L < 0 || L > LMAX || nd < 0 || n_dmx < 0 || n_jump < 0 ||
      ((parts & DM_HAS_DM) && nd < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Codes cc;
  for (int c = 0; c < L; ++c) {
    cc.kind[c] = codes[c];
    cc.idx[c] = codes[L + c];
    const int k = cc.kind[c], idx = cc.idx[c];
    if (k < DM_KIND_NONE || k > DM_KIND_DMJUMP || idx < 0 ||
        (k == DM_KIND_DM && idx >= nd) || (k == DM_KIND_DMX && idx >= n_dmx) ||
        (k == DM_KIND_DMJUMP && idx >= n_jump))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const DmIn in{t_hi, t_lo, coeffs, onehot, dmx, masks, jumps, data, sigma,
                nd, n_dmx, n_jump, n_rows, n_out, parts, dmepoch};
  dm_rows_kernel<<<(n_out + THREADS - 1) / THREADS, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(in, cc, L, total, resid, cols);
  return static_cast<int>(cudaGetLastError());
}

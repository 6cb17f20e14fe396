"""Chi^2 grid scans (counterpart of ``pint_tpu/gridutils.py``), and kernel K2.

Every grid point fixes the gridded parameters, refits the other free
parameters with `maxiter` Gauss-Newton steps and reports chi^2, as the JAX
package's ``_point_kernel`` does. The statistic follows the fitter, as
there: a GLS fitter on a model with correlated noise grids the Woodbury
chi^2, any other fitter the white one. The grid points are a leading batch
dimension B of the parameter dict, which replaces ``vmap``:

- kernel K1 (``residuals.resid_tangent``) evaluates the B forward chains
  with the tangents of the nonlinear free parameters in one launch, and
  kernel K8 (``fitting/design.linear_columns``) writes the closed-form
  columns of the linear ones (DM, DMX, FD, JUMP);
- white: kernel K2 (`normal_eq`, csrc/normal_eq.cu) reduces them to the
  equilibrated normal equations and chi^2 of every point;
- correlated: kernel K3 (``fitting/woodbury.ecorr_normal_eq``) removes the
  weighted means, equilibrates the columns by sqrt(sum w M^2) and forms the
  Woodbury normal equations and chi^2 of every point;
- the p x p ridge Cholesky solve stays ``torch.linalg``;
- ``fitting/wls.apply_delta`` adds the steps into the parameters; it
  launches kernel K0 only for double-double free parameters, and the
  refitted parameters of an (F0, F1) grid over SMOKE_PAR (RAJ, DECJ, DM)
  are plain float64, so that grid does not launch K0.

Unlike the WLS fitter, the grid divides by f FIRST and subtracts the
weighted mean in SECONDS (pint_tpu gridutils.py:103-107); K2 or K3 does the
subtraction.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pint_tpu_torch.fitting.design import linear_columns, linear_split
from pint_tpu_torch.fitting.wls import apply_delta
from pint_tpu_torch.fitting.woodbury import ecorr_normal_eq
from pint_tpu_torch.ops.dd import DD
from pint_tpu_torch.residuals import phase_resid_tangents

# Levenberg-style damping of the equilibrated normal equations of one grid
# step (pint_tpu _RIDGE): suppresses near-degenerate directions at the
# off-minimum outer grid points.
_RIDGE = 1e-6

#: the most design columns K2 is instantiated for (csrc/normal_eq.cu PMAX)
K2_PMAX = 12


def normal_eq_plain(r: torch.Tensor, M: torch.Tensor, w: torch.Tensor, ridge: float,
                    subtract_mean: bool):
    """Twin of K2, in the operation order of pint_tpu's gn_step.
    r (B, N), M (B, p, N), w (N,) -> (G (B, p, p), c (B, p), chi2 (B,),
    norm (B, p))."""
    if subtract_mean:
        sw = torch.sum(w)
        r = r - torch.sum(w * r, dim=-1, keepdim=True) / sw
        M = M - torch.sum(w * M, dim=-1, keepdim=True) / sw
    col2 = torch.sum(w * M * M, dim=-1)
    norm = torch.sqrt(torch.where(col2 == 0, 1.0, col2))
    Mn = M / norm[..., None]
    CinvM = w * Mn
    p = M.shape[-2]
    G = Mn @ CinvM.transpose(-1, -2) + ridge * torch.eye(p, dtype=torch.float64, device=M.device)
    c = (CinvM @ (-r)[..., None])[..., 0]
    chi2 = torch.sum(w * r * r, dim=-1)
    return G, c, chi2, norm


def normal_eq(r: torch.Tensor, M: torch.Tensor, w: torch.Tensor, ridge: float,
              subtract_mean: bool):
    """K2: the batched normal equations. On a CUDA tensor it launches the
    kernel (and raises if it cannot); on a CPU tensor it takes
    `normal_eq_plain`. Shapes as in the twin. `normal_eq.launches` counts
    calls, `normal_eq.passes` the kernel passes they ran (3 with mean
    subtraction, 2 without)."""
    if r.device.type == "cpu":
        return normal_eq_plain(r, M, w, ridge, subtract_mean)
    B, n = r.shape
    p = M.shape[1]
    if M.shape != (B, p, n) or w.shape != (n,) or p > K2_PMAX:
        raise ValueError(f"normal_eq needs r (B, N), M (B, p <= {K2_PMAX}, N), w (N,); "
                         f"got {tuple(r.shape)}, {tuple(M.shape)}, {tuple(w.shape)}")
    for t in (r, M, w):
        if t.dtype != torch.float64 or t.device != r.device:
            raise ValueError("normal_eq needs float64 tensors on one device")
    r, M, w = r.contiguous(), M.contiguous(), w.contiguous()
    from pint_tpu_torch.ops import build

    lib = build.library("normal_eq", _declare_k2)
    tiles = lib.normal_eq_tiles(n)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float64, device=r.device)

    part1, part2 = empty(B, tiles, p + 2), empty(B, tiles, p * (p + 1) // 2 + p + 1)
    G, c, chi2, norm = empty(B, p, p), empty(B, p), empty(B), empty(B, p)
    build.check(lib, lib.normal_eq(
        r.data_ptr(), M.data_ptr(), w.data_ptr(), B, p, n, int(subtract_mean), ridge,
        part1.data_ptr(), part2.data_ptr(), G.data_ptr(), c.data_ptr(), chi2.data_ptr(),
        norm.data_ptr(), build.stream_of(r)))
    normal_eq.launches += 1
    normal_eq.passes += 3 if subtract_mean else 2
    return G, c, chi2, norm


normal_eq.launches = 0
normal_eq.passes = 0


def _declare_k2(lib) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.normal_eq.argtypes = [p, p, p, i, i, i, i, ctypes.c_double, p, p, p, p, p, p, p]
    lib.normal_eq.restype = ctypes.c_int
    lib.normal_eq_tiles.argtypes = [i]
    lib.normal_eq_tiles.restype = ctypes.c_int


# --- the grid ------------------------------------------------------------------


def _time_resids_design(model, params, tensor, free):
    """(r (B, N), M (B, p, N), columns in `free` order) before mean
    subtraction: r = frac/f, the nonlinear columns are its K1 tangents
    d(r/f) = dfrac/f - frac df/f^2, the linear columns closed forms."""
    nonlin, lin_names, owners = linear_split(model, free)
    out = phase_resid_tangents(model, params, tensor, lanes=nonlin)
    r = out.frac / out.f
    M = out.dfrac / out.f[:, None] + (-out.df * out.frac[:, None]) * out.f[:, None] ** -2
    if lin_names:
        sl = slice(None, -1) if model.has_abs_phase else slice(None)
        p1 = {k: (DD(v.hi[:, None], v.lo[:, None]) if isinstance(v, DD) else v[:, None])
              for k, v in params.items()}
        M_l = linear_columns(model, p1, tensor, out.f, sl, lin_names, owners, out.fb)
        M = torch.cat([M, M_l], dim=1)
    names = nonlin + lin_names
    return r, M[:, [names.index(n) for n in free]]


def grid_point_chi2(model, params: dict, tensor: dict, w: torch.Tensor, free: tuple,
                    subtract_mean: bool, maxiter: int, basis=None) -> torch.Tensor:
    """chi^2 (B,) of a batched parameter dict after `maxiter` Gauss-Newton
    refits of `free` (pint_tpu ``_point_kernel``): the white statistic, or,
    given a noise `basis`, the Woodbury one."""
    correlated = basis is not None
    mean_free = subtract_mean and not model.has_phase_offset
    for _ in range(maxiter if free else 0):
        r, M = _time_resids_design(model, params, tensor, free)
        if correlated:
            G, c, _, _, norm = ecorr_normal_eq(r, M, w, basis, _RIDGE, mean_free,
                                               weighted_norm=True)
        else:
            G, c, _, norm = normal_eq(r, M, w, _RIDGE, mean_free)
        dx = torch.cholesky_solve(c[..., None], torch.linalg.cholesky(G))[..., 0] / norm
        params = apply_delta(params, free, dx)
    out = phase_resid_tangents(model, params, tensor)
    r = out.frac / out.f
    no_cols = r.new_zeros((r.shape[0], 0, r.shape[1]))
    if correlated:
        return ecorr_normal_eq(r, no_cols, w, basis, 0.0, mean_free)[2]
    return normal_eq(r, no_cols, w, 0.0, mean_free)[2]


def grid_chisq(fitter, parnames, parvalues, maxiter: int = 1) -> np.ndarray:
    """chi^2 over a parameter grid, refitting every other free parameter
    (pint_tpu ``grid_chisq``): `parvalues` are 1-D arrays in model-internal
    units; the result has the shape of ``np.meshgrid(*parvalues)``."""
    if len(parnames) != len(parvalues):
        raise ValueError(f"{len(parnames)} parameter names but {len(parvalues)} value arrays")
    grids = np.meshgrid(*[np.asarray(v, np.float64) for v in parvalues])
    pts = np.stack([g.ravel() for g in grids], axis=1)
    return grid_chisq_points(fitter, parnames, pts, maxiter=maxiter).reshape(grids[0].shape)


def grid_chisq_points(fitter, parnames, points, maxiter: int = 1) -> np.ndarray:
    """chi^2 at `points` (npts, len(parnames)), all evaluated as one batch."""
    model = fitter.model
    for n in parnames:
        if n not in model.param_meta:
            raise KeyError(f"unknown parameter {n}")
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] != len(parnames):
        raise ValueError(f"points must be (npts, {len(parnames)}); got shape {pts.shape}")
    free = tuple(n for n in model.free_params if n not in parnames)
    from pint_tpu_torch.fitting.gls import GLSFitter

    basis = None
    if isinstance(fitter, GLSFitter) and model.has_correlated_errors:
        noise = {n for c in model.noise_components for n in c.specs}
        if noise & set(parnames):
            raise NotImplementedError(
                f"gridding noise parameters {sorted(noise & set(parnames))} is not ported")
        basis = model.noise_basis_and_weights(model.params, fitter.tensor)
    dev = fitter.tensor["t_hi"].device
    B = pts.shape[0]

    def batched(v):
        if isinstance(v, DD):
            return DD(v.hi.expand(B).clone(), v.lo.expand(B).clone())
        return v.expand(B).clone()

    params = {k: batched(v) for k, v in model.params.items()}
    vals = torch.as_tensor(pts, dtype=torch.float64, device=dev)
    for i, n in enumerate(parnames):
        params[n] = DD(vals[:, i], torch.zeros_like(vals[:, i])) \
            if isinstance(params[n], DD) else vals[:, i]
    w = 1.0 / fitter.resids.errors_s**2
    chi2 = grid_point_chi2(model, params, fitter.tensor, w, free,
                           fitter.resids.subtract_mean, maxiter, basis)
    return chi2.detach().cpu().numpy()

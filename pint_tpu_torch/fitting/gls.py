"""Generalized least-squares fitting with correlated noise (counterpart of
``pint_tpu/fitting/gls.py``).

The covariance is C = diag(sigma^2) + F phi F^T with F the correlated-noise
basis (ECORR epochs and the power-law Fourier columns, which kernel K8
writes; ``models/noise.py``), sigma the EFAC/EQUAD-scaled uncertainties. One step solves the marginalized normal equations
Mn^T C^-1 Mn dx = -Mn^T C^-1 r, C^-1 applied through the structured
Woodbury algebra of ``fitting/woodbury.py``: kernel K3 on the card, its
plain twin on the CPU. The chi^2 at fixed parameters is the Woodbury
identity r^T C^-1 r = r^T W r - d^T S^-1 d, also K3.

Two choices of the JAX package are kept exactly. The design is the tangent
of the time residual for EVERY free parameter (jax.linearize over all of
them, here K1's lanes; the DM, DMX, FD and JUMP columns are tangents too,
unlike the grid's hybrid design: through the binary's time argument the
DMX and FD tangents differ from the closed forms by ~7e-5 relative for the
NANOGrav par's orbit). The columns are equilibrated by their UNWEIGHTED norm
sqrt(sum M^2), inside K3, and a ridge of 1e-12 I is added.

The p x p solve is one symmetric eigendecomposition per linearization, on
the device (``torch.linalg.eigh``): every damped Levenberg-Marquardt
re-solve of that iteration re-weights its spectrum. The JAX package's host
solve, its fused and mesh loops and ``full_cov`` are not ported: the first
two existed for the TPU's float32-range float64 and its mesh, the third is
an O(N^3) cross-check.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.fitting.wls import (FitResult, WLSFitter, apply_delta, run_lm,
                                        time_resid_design)
from pint_tpu_torch.fitting.woodbury import ecorr_normal_eq
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.residuals import phase_residual_frac

# tiny ridge on the normalized timing block: keeps the solve finite on
# exactly degenerate columns (pint_tpu _RIDGE)
_RIDGE = 1e-12


def gls_step(model: TimingModel, free: tuple, params: dict, tensor: dict,
             weights: torch.Tensor, sigma: torch.Tensor, subtract_mean: bool):
    """One GLS linearization (pint_tpu get_gls_step_fn's `step`):
    -> (r0 (N,), M (N, p), mtcm (p, p), mtcy (p,), norm (p,), chi2_0, ahat)."""
    r0, M = time_resid_design(model, free, params, tensor, weights, subtract_mean,
                              hybrid=False)
    basis = model.noise_basis_and_weights(params, tensor)
    mtcm, mtcy, chi2_0, ahat, norm = ecorr_normal_eq(r0[None], M.T[None], 1.0 / sigma**2,
                                                     basis, _RIDGE)
    return r0, M, mtcm[0], mtcy[0], norm[0], chi2_0[0], ahat[0]


def gls_chi2_at(model: TimingModel, params: dict, tensor: dict, weights: torch.Tensor,
                sigma: torch.Tensor, subtract_mean: bool) -> torch.Tensor:
    """r^T C^-1 r at fixed parameters (pint_tpu get_gls_chi2_fn): K1 with no
    lanes, then K3 with no columns."""
    _, r, f = phase_residual_frac(model, params, tensor, subtract_mean, weights)
    r = r / f
    basis = model.noise_basis_and_weights(params, tensor)
    no_cols = r.new_zeros((r.shape[0], 0, r.shape[1]))
    return ecorr_normal_eq(r, no_cols, 1.0 / sigma**2, basis, 0.0)[2][0]


def gls_chi2(resids) -> float:
    """GLS chi^2 of a Residuals object at its model's current parameters."""
    return float(gls_chi2_at(resids.model, resids.model.params, resids.tensor,
                             resids.weights, resids.errors_s, resids.subtract_mean))


class GLSNormalFactor:
    """One symmetric eigendecomposition of ONE linearization's normalized
    normal matrix, on the device. Every damped re-solve of that iteration is
    a spectral re-weighting dx(lam) = V diag(1/(s + lam s_max)) V^T mtcy /
    norm. Small or negative eigenvalues are zeroed, so the covariance is
    PSD by construction; it always comes from the undamped spectrum. A
    non-finite normal matrix gives NaN steps, which run_lm rejects."""

    def __init__(self, mtcm, mtcy, norm, p: int):
        self.p = p
        self.mtcy = mtcy
        self.norm = norm
        self.q = mtcm.shape[0]
        self.ok = bool(mtcm.numel() == 0 or torch.isfinite(mtcm).all())
        if self.ok:
            self.s, self.V = torch.linalg.eigh((mtcm + mtcm.T) / 2.0)
            self.smax = self.s[-1] if self.s.numel() else torch.ones((), dtype=torch.float64)
        else:
            self.s = torch.full((self.q,), float("nan"), dtype=torch.float64, device=mtcm.device)
            self.V = torch.full((self.q, self.q), float("nan"), dtype=torch.float64,
                                device=mtcm.device)
            self.smax = float("nan")

    def _sinv(self, lam: float):
        s, smax = self.s, self.smax
        good = s > 1e-14 * smax
        damped = s + (lam * smax if lam else 0.0)
        return torch.where(good, 1.0 / torch.where(good, damped, 1.0), 0.0)

    def solve(self, lam: float = 0.0) -> torch.Tensor:
        """Timing-parameter step dx at damping lam (0: Gauss-Newton)."""
        if not self.ok:
            return torch.full((self.p,), float("nan"), dtype=torch.float64, device=self.s.device)
        xhat = self.V @ (self._sinv(lam) * (self.V.T @ self.mtcy))
        return (xhat / self.norm)[: self.p]

    def cov(self) -> torch.Tensor:
        """Undamped timing-parameter covariance (PSD by construction)."""
        p = self.p
        if not self.ok:
            return torch.full((p, p), float("nan"), dtype=torch.float64, device=self.s.device)
        cov_full = (self.V[:p, :] * self._sinv(0.0)) @ self.V[:p, :].T
        return (cov_full / self.norm[:p]).T / self.norm[:p]

    def eig(self):
        """(eigenvalues ascending, V^T)."""
        return self.s, self.V.T


class _FactorSlot:
    """One GLSNormalFactor per linearization, keyed on the identity of its
    pieces tuple (held strongly, so a recycled id cannot alias)."""

    def __init__(self):
        self._pieces = None
        self.factor: GLSNormalFactor | None = None

    def get(self, pieces, mtcm, mtcy, norm, p) -> GLSNormalFactor:
        if self._pieces is not pieces:
            self.factor = GLSNormalFactor(mtcm, mtcy, norm, p)
            self._pieces = pieces
        return self.factor


def gls_solve(mtcm, mtcy, norm, p: int, lam: float = 0.0, return_eig: bool = False):
    """(dx, cov) from the normalized GLS normal equations, one-shot; with
    return_eig also (eigenvalues ascending, V^T)."""
    f = GLSNormalFactor(mtcm, mtcy, norm, p)
    dx, cov = f.solve(lam), f.cov()
    if return_eig:
        return (dx, cov, *f.eig())
    return dx, cov


class GLSFitter(WLSFitter):
    """Iterated linear GLS. `toas` is the prepared TOA tensor dict."""

    def _step(self, params):
        r = self.resids
        return gls_step(self.model, self._free, params, self.tensor, r.weights, r.errors_s,
                        r.subtract_mean)

    def chi2_at(self, params: dict) -> float:
        r = self.resids
        return float(gls_chi2_at(self.model, params, self.tensor, r.weights, r.errors_s,
                                 r.subtract_mean))

    def fit_toas(self, maxiter: int = 1, xtol: float = 1e-2) -> FitResult:
        params = self.model.params
        p = len(self._free)
        it = 0
        converged = False
        for it in range(1, maxiter + 1):
            _, _, mtcm, mtcy, norm, _, ahat = self._step(params)
            dx, cov, es, evt = gls_solve(mtcm, mtcy, norm, p, return_eig=True)
            if not bool(torch.isfinite(dx).all()):
                # no backtracking here: a NaN step must fail loudly
                raise RuntimeError(
                    f"GLS normal equations produced a non-finite step (iteration {it}); "
                    "check the starting parameters or use DownhillGLSFitter")
            params = apply_delta(params, self._free, dx)
            sigma = torch.sqrt(torch.clamp(torch.diag(cov), min=0.0))
            rel = torch.abs(dx) / torch.where(sigma == 0, 1.0, sigma)
            if bool(torch.all(rel < xtol)):
                converged = True
                break
        self.noise_ampls = ahat.detach().cpu().numpy()
        return self._finalize_fit(params, self.chi2_at(params), it, converged, cov,
                                  torch.flip(es, (0,)))


class DownhillGLSFitter(GLSFitter):
    """Levenberg-Marquardt damped GLS (pint_tpu DownhillGLSFitter's host
    loop): one K1 + K3 linearization and one eigh per iteration, every
    damped re-solve from that factorization."""

    def fit_toas(self, maxiter: int = 30, required_chi2_decrease: float = 1e-2,
                 max_rejects: int = 16) -> FitResult:
        p = len(self._free)
        slot = _FactorSlot()
        params, chi2_best, it, converged, pieces = run_lm(
            self.model.params, self.chi2_at(self.model.params),
            compute_pieces=self._step,
            solve=lambda pc, lam: slot.get(pc, pc[2], pc[3], pc[4], p).solve(lam),
            chi2_of=self.chi2_at,
            apply_step=lambda pr, dx: apply_delta(pr, self._free, dx),
            maxiter=maxiter, required_gain=required_chi2_decrease,
            max_rejects=max_rejects, log_label="downhill GLS fit")
        _, _, mtcm, mtcy, norm, _, ahat = pieces
        factor = slot.get(pieces, mtcm, mtcy, norm, p)
        es, _ = factor.eig()
        self.noise_ampls = ahat.detach().cpu().numpy()
        return self._finalize_fit(params, chi2_best, it, converged, factor.cov(),
                                  torch.flip(es, (0,)))

"""Weighted least-squares fitting (counterpart of ``pint_tpu/fitting/wls.py``).

One step linearizes the time residuals at the current parameters:

    step(params) -> (r0, M, dx, cov, s, Vt, chi2_0, utb, norm)

M = d(time residual)/d(free param). Its nonlinear columns come from the
tangent lanes of kernel K1 (``residuals.resid_tangent``), which replaces the
JAX package's ``jax.linearize`` + ``vmap``; its exactly-linear columns (DM,
DMX, FD, JUMP) are closed forms, written by kernel K8 on the card
(``fitting/design.py``). The solve is the equilibrated SVD
of the JAX package, on the device with ``torch.linalg.svd``. Updates are
float64 deltas added into the double-double parameter carriers by kernel K0
(``apply_delta``), so phase precision survives any number of iterations.

The JAX package's host-solve path (``use_host_solve``/``adaptive_fused``)
existed because TPU float64 had float32 range; the H100 has IEEE float64,
so it is not ported.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from pint_tpu_torch.fitting.design import linear_columns, linear_split
from pint_tpu_torch.models.base import leaf_to_f64
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.ops.dd import DD, dd_elementwise
from pint_tpu_torch.ops.xprec import params_to_dd
from pint_tpu_torch.residuals import (Residuals, phase_resid_tangents, phase_residual_frac,
                                      weighted_mean)

log = logging.getLogger("pint_tpu_torch.fitting")

# singular values below this fraction of the largest are degenerate
# directions and are zeroed (pint_tpu SVD_THRESHOLD)
SVD_THRESHOLD = 1e-14


# hard physical domains (pint_tpu _PARAM_DOMAIN): a Gauss-Newton step from
# far off the minimum can propose e.g. SINI > 1, whose log turns every
# residual NaN; every fitter step is projected back onto the boundary
_EPS_DOM = 1e-12
_PARAM_DOMAIN = {
    "ECC": (0.0, 1.0 - _EPS_DOM),
    "SINI": (-1.0 + _EPS_DOM, 1.0 - _EPS_DOM),
    "EPS1": (-0.7, 0.7),
    "EPS2": (-0.7, 0.7),
    "STIGMA": (-1.0 + _EPS_DOM, 1.0 - _EPS_DOM),
    "M2": (0.0, np.inf),
    "MTOT": (0.0, np.inf),
}


def apply_delta(params: dict, free_names: tuple, delta: torch.Tensor) -> dict:
    """params + delta over the free subset, projected onto `_PARAM_DOMAIN`
    (pint_tpu's apply_delta with ``project_domain=True``, the fitters' step).
    `delta` is (..., p): a leading batch dimension updates a batched
    parameter dict (leaves (B,)).

    Every double-double leaf absorbs its float64 step through ONE launch of
    kernel K0 (``add_fp``, the dd_add_fp of ``ops/dd.py``), so the low words
    keep their bits; plain leaves add in float64. A parameter with a domain
    is clamped onto it: a double-double leaf on its high word, its low word
    zeroed where clamped."""
    new = dict(params)
    dd_names = [n for n in free_names if isinstance(params[n], DD)]
    col = {n: delta[..., i] for i, n in enumerate(free_names)}
    if dd_names:
        shape = torch.broadcast_shapes(*(tuple(params[n].hi.shape) for n in dd_names),
                                       tuple(col[dd_names[0]].shape))
        x = DD(torch.stack([params[n].hi.expand(shape) for n in dd_names]),
               torch.stack([params[n].lo.expand(shape) for n in dd_names]))
        y = torch.stack([col[n].expand(shape) for n in dd_names])
        out = dd_elementwise("add_fp", x, y)
        for j, n in enumerate(dd_names):
            new[n] = DD(out.hi[j], out.lo[j])
    for n in free_names:
        if n not in dd_names:
            new[n] = params[n] + col[n]
        dom = _PARAM_DOMAIN.get(n)
        if dom is None:
            continue
        if n in dd_names:
            hi = torch.clamp(new[n].hi, dom[0], dom[1])
            new[n] = DD(hi, torch.where(hi == new[n].hi, new[n].lo, 0.0))
        else:
            new[n] = torch.clamp(new[n], dom[0], dom[1])
    return new


@dataclass
class FitResult:
    chi2: float
    dof: int
    iterations: int
    converged: bool
    uncertainties: dict = field(default_factory=dict)
    covariance: np.ndarray | None = None
    free_params: list = field(default_factory=list)
    singular_values: np.ndarray | None = None

    @property
    def reduced_chi2(self) -> float:
        return self.chi2 / self.dof


def time_resid_design(model: TimingModel, free: tuple, params: dict, tensor: dict,
                      weights: torch.Tensor, subtract_mean: bool, hybrid: bool = True,
                      with_f: bool = False):
    """(r0 (N,), M (N, p)): time residuals and their design matrix in the
    WLS order of the JAX package: the weighted mean is subtracted from the
    phase residual in TURNS, before the division by f. Nonlinear columns
    are the tangents of K1, d(r/f) = dr/f - r df/f^2; linear columns are
    closed forms with their weighted mean removed. ``hybrid=False`` takes
    every column from the tangents, as the JAX package's GLS step does. A
    parameter of the model DM alone (DMJUMP) has an exactly zero column,
    written without a lane. ``with_f`` appends the spin frequency f (N,)."""
    dm_only = set(model.dm_only_params)
    timing = tuple(n for n in free if n not in dm_only)
    if hybrid:
        nonlin, lin_names, owners = linear_split(model, timing)
    else:
        nonlin, lin_names, owners = timing, (), {}
    mean_free = subtract_mean and not model.has_phase_offset
    out = phase_resid_tangents(model, params, tensor, lanes=nonlin)
    r, f = out.frac[0], out.f[0]
    dr = out.dfrac[0]
    if mean_free:
        r = r - weighted_mean(r, weights)[..., 0]
        dr = dr - weighted_mean(dr, weights)
    cols = {}
    for i, n in enumerate(nonlin):
        cols[n] = dr[i] / f + (-out.df[0, i] * r) * f**-2
    if lin_names:
        sl = slice(None, -1) if model.has_abs_phase else slice(None)
        M_l = linear_columns(model, params, tensor, f, sl, lin_names, owners, out.fb[0])
        if mean_free:
            M_l = M_l - weighted_mean(M_l, weights)
        for i, n in enumerate(lin_names):
            cols[n] = M_l[i]
    for n in dm_only & set(free):
        cols[n] = torch.zeros_like(r)
    out = r / f, torch.stack([cols[n] for n in free], dim=1)
    return (*out, f) if with_f else out


def wls_step(model: TimingModel, free: tuple, params: dict, tensor: dict,
             weights: torch.Tensor, errors: torch.Tensor, subtract_mean: bool):
    """One linearization + equilibrated SVD solve (pint_tpu get_step_fn's
    `step`). Returns (r0, M, dx, cov, s, Vt, chi2_0, utb, norm); the last
    four let `lm_step` re-solve at any damping without recomputing."""
    r0, M = time_resid_design(model, free, params, tensor, weights, subtract_mean)
    w = 1.0 / errors
    A = M * w[:, None]
    b = -r0 * w
    norm = torch.linalg.vector_norm(A, dim=0)
    norm = torch.where(norm == 0, 1.0, norm)
    U, s, Vt = torch.linalg.svd(A / norm, full_matrices=False)
    good = s > SVD_THRESHOLD * s[0]
    s_inv = torch.where(good, 1.0 / torch.where(good, s, 1.0), 0.0)
    utb = U.T @ b
    dx = (Vt.T * s_inv) @ utb / norm
    cov = (Vt.T * s_inv**2) @ Vt / torch.outer(norm, norm)
    chi2_0 = torch.sum(b * b)
    return r0, M, dx, cov, s, Vt, chi2_0, utb, norm


def lm_step(s, vt, utb, norm, lam: float) -> torch.Tensor:
    """Damped step from the cached SVD pieces:
    dx = V diag(s/(s^2 + lam s_max^2)) U^T b / norm; lam = 0 is Gauss-Newton."""
    if s.numel() == 0:
        return torch.zeros(0, dtype=torch.float64, device=s.device)
    damp = s / (s * s + lam * s[0] ** 2)
    damp = torch.where(s > SVD_THRESHOLD * s[0], damp, 0.0)
    return (vt.T * damp) @ utb / norm


def run_lm(params, chi2_best, compute_pieces, solve, chi2_of, apply_step,
           maxiter: int, required_gain: float, max_rejects: int, log_label: str):
    """The Levenberg-Marquardt outer loop of pint_tpu ``run_lm``: damping
    restarts from zero each iteration, and a final step whose chi^2 gain is
    below `required_gain` is REVERTED, so the reported parameters and the
    covariance come from the same linearization point.

    Returns (params, chi2_best, iterations, converged, last_pieces)."""
    it = 0
    converged = False
    pieces = None
    for it in range(1, maxiter + 1):
        pieces = compute_pieces(params)
        lam = 0.0
        accepted = False
        gain = 0.0
        base_params, base_chi2 = params, chi2_best
        for _ in range(max_rejects):
            trial = apply_step(params, solve(pieces, lam))
            chi2_trial = chi2_of(trial)
            if np.isfinite(chi2_trial) and chi2_trial <= chi2_best:
                gain = chi2_best - chi2_trial
                params, chi2_best = trial, chi2_trial
                accepted = True
                break
            lam = 1e-8 if lam == 0.0 else lam * 10.0
        if not accepted or gain < required_gain:
            if accepted:
                params, chi2_best = base_params, base_chi2
            converged = True
            break
    else:
        log.warning(f"{log_label} hit maxiter={maxiter}")
    return params, chi2_best, it, converged, pieces


class WLSFitter:
    """Iterated linear WLS (Gauss-Newton without damping). `toas` is the
    prepared TOA tensor dict (``prepared.load_prepared``)."""

    def __init__(self, toas, model: TimingModel, residuals: Residuals | None = None):
        self.toas = toas
        self.model = model
        self.resids = residuals or Residuals(toas, model)
        self.tensor = self.resids.tensor
        self._free = tuple(model.free_params)
        self.result: FitResult | None = None

    def _step(self, params):
        r = self.resids
        return wls_step(self.model, self._free, params, self.tensor, r.weights,
                        r.errors_s, r.subtract_mean)

    def chi2_at(self, params: dict) -> float:
        r = self.resids
        _, rp, f = phase_residual_frac(self.model, params, self.tensor,
                                       r.subtract_mean, r.weights)
        return float(torch.sum((rp[0] / f[0] / r.errors_s) ** 2))

    def fit_toas(self, maxiter: int = 4, xtol: float = 1e-2) -> FitResult:
        """Gauss-Newton; converged when every step is below `xtol` of its
        parameter's uncertainty."""
        params = self.model.params
        converged = False
        it = 0
        for it in range(1, maxiter + 1):
            _, _, dx, cov, s, *_ = self._step(params)
            params = apply_delta(params, self._free, dx)
            sigma = torch.sqrt(torch.diag(cov))
            rel = torch.abs(dx) / torch.where(sigma == 0, 1.0, sigma)
            if bool(torch.all(rel < xtol)):
                converged = True
                break
        return self._finalize_fit(params, self.chi2_at(params), it, converged, cov, s)

    def _finalize_fit(self, params, chi2: float, it: int, converged: bool, cov, s) -> FitResult:
        self.model.params = params_to_dd(params)
        cov = cov.detach().cpu().numpy()
        diag = np.diag(cov).copy()
        if (diag < 0).any():
            bad = [self._free[i] for i in np.flatnonzero(diag < 0)]
            log.warning(f"negative covariance diagonal for {bad}; clamping to 0")
            diag = np.where(diag < 0, 0.0, diag)
        unc = {n: float(u) for n, u in zip(self._free, np.sqrt(diag))}
        for n, u in unc.items():
            self.model.param_meta[n].uncertainty = u
        self.resids = self._rebuild_resids()
        self.result = FitResult(chi2=chi2, dof=self.resids.dof, iterations=it,
                                converged=converged, uncertainties=unc, covariance=cov,
                                free_params=list(self._free),
                                singular_values=s.detach().cpu().numpy())
        return self.result

    def _rebuild_resids(self):
        """Fresh residuals at the model's current parameters, with the
        caller's tracking mode and choice of mean subtraction."""
        return Residuals(self.tensor, self.model, subtract_mean=self.resids.subtract_mean,
                         track_mode=self.resids.track_mode)

    def values(self) -> dict:
        """{free name: float64 value} of the model's current parameters."""
        return {n: float(leaf_to_f64(self.model.params[n])) for n in self._free}


class DownhillWLSFitter(WLSFitter):
    """Levenberg-Marquardt damped Gauss-Newton (pint_tpu DownhillWLSFitter's
    host loop): the damped re-solves reuse one SVD per iteration."""

    def fit_toas(self, maxiter: int = 30, required_chi2_decrease: float = 1e-2,
                 max_rejects: int = 16) -> FitResult:
        def solve(pieces, lam):
            if lam == 0.0:
                return pieces[2]
            return lm_step(pieces[4], pieces[5], pieces[7], pieces[8], lam)

        params, chi2_best, it, converged, pieces = run_lm(
            self.model.params, self.chi2_at(self.model.params),
            compute_pieces=self._step, solve=solve, chi2_of=self.chi2_at,
            apply_step=lambda p, dx: apply_delta(p, self._free, dx),
            maxiter=maxiter, required_gain=required_chi2_decrease,
            max_rejects=max_rejects, log_label="downhill WLS fit")
        return self._finalize_fit(params, chi2_best, it, converged, pieces[3], pieces[4])

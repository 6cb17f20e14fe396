"""Wideband (TOA + DM-measurement) fitting (counterpart of
``pint_tpu/fitting/wideband.py``).

A wideband TOA carries a measured DM (``-pp_dm``, ``-pp_dme``). The fit
works on one combined residual vector over the N_t TOAs and their N_dm = N_t
DM measurements,

    r_aug = [ r_toa / sigma_toa ; (DM_model - dm_data) / sigma_dm ],

and its design over every free parameter: the TOA rows are the tangents of
kernel K1 (every free parameter as a lane, as pint_tpu's jax.linearize takes
them; DMJUMP moves no delay, so its TOA column is zero and takes no lane),
the DM rows the closed forms of K8's DM-row pass (``design.dm_rows``: DM<k>,
DMX and DMJUMP; zero for every other parameter). A row without a DM
measurement has an infinite sigma_dm and weight 0. Correlated TOA noise (red
noise, ECORR) lifts to the combined system with zero DM rows.

pint_tpu forms its normal equations on the pre-whitened rows, with the noise
basis scaled by 1/sigma_toa (``NoiseBasis.row_scale``) and unit weights.
Kernel K3 takes the same system in its own form: the TOA rows unwhitened
with weights 1/sigma_toa^2, the DM rows as K8 whitens them with weight 1 (0
where there is no measurement), the basis zero on the DM rows, the columns
equilibrated by sqrt(sum w M^2) (``weighted_norm``), which is pint_tpu's
norm of the whitened columns. The algebra is the same; the order of the
operations differs where a weight meets a row, at the rounding of one
operation. The TOA block's weighted mean comes off in the TOA residuals
(``time_resid_design``), never off the DM rows, so K3 does not centre.

The p x p solve is `gls.GLSNormalFactor`, one eigendecomposition per
linearization. The fused and mesh loops of the JAX package are not ported
(ROADMAP A11a, A15): asking for them raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.fitting.design import dm_rows, dm_weights
from pint_tpu_torch.fitting.gls import _RIDGE, _FactorSlot
from pint_tpu_torch.fitting.wls import (FitResult, WLSFitter, apply_delta, run_lm,
                                        time_resid_design)
from pint_tpu_torch.fitting.woodbury import NoiseBasis, ecorr_normal_eq, epoch_index
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.residuals import WidebandTOAResiduals, phase_residual_frac


def refuse_unported(mesh=None, fused=None) -> None:
    """The fitters' `mesh` and `fused` options of the JAX package are not
    ported: asking for either raises rather than falling back."""
    if mesh is not None:
        raise NotImplementedError("mesh=: the TOA-sharded fit is not ported yet (ROADMAP A15)")
    if fused:
        raise NotImplementedError(
            "fused=True: the one-dispatch fused fit is not ported yet (ROADMAP A11a)")


def stacked_basis(model: TimingModel, params: dict, tensor: dict, n_dm: int):
    """The model's noise basis over the combined [TOA; DM] rows: the dense
    columns with n_dm zero rows below, the ECORR epochs with the DM rows in
    none (the stacked epoch index built once per tensor); None without
    correlated noise."""
    basis = model.noise_basis_and_weights(params, tensor)
    if basis is None:
        return None
    dense = epochs = None
    if basis.dense is not None:
        dt = basis.dense.T
        dense = torch.cat([dt, dt.new_zeros((dt.shape[0], n_dm))], dim=1).T
    if basis.epochs is not None:
        memo = model.__dict__.get("_wb_epoch_memo")
        if memo is None or memo[0] is not basis.epochs:
            e = basis.epochs.eidx
            stacked = torch.cat([e, torch.full((n_dm,), -1, dtype=e.dtype, device=e.device)])
            memo = model._wb_epoch_memo = (basis.epochs, epoch_index(stacked, basis.ke))
        epochs = memo[1]
    return NoiseBasis(dense=dense, dense_phi=basis.dense_phi, epochs=epochs, ephi=basis.ephi)


def _weights(sigma_t: torch.Tensor, sigma_dm: torch.Tensor) -> torch.Tensor:
    """K3's row weights: 1/sigma_toa^2, then 1 on the measured DM rows."""
    return torch.cat([1.0 / sigma_t**2, (dm_weights(sigma_dm) > 0).to(sigma_t.dtype)])


def wb_step(model: TimingModel, free: tuple, params: dict, tensor: dict, weights: torch.Tensor,
            sigma_t: torch.Tensor, sigma_dm: torch.Tensor, dm_data: torch.Tensor,
            subtract_mean: bool):
    """One wideband linearization (pint_tpu get_wb_step_fn's `step`):
    -> (r_aug (N_t + N_dm,), mtcm (p, p), mtcy (p,), norm (p,), chi2_0,
    ahat). K1 gives the TOA rows, K8's DM-row pass the DM rows, K3 the
    normal equations of the stacked system."""
    r_t, M_t = time_resid_design(model, free, params, tensor, weights, subtract_mean,
                                 hybrid=False)
    _, r_dm, M_dm = dm_rows(model, params, tensor, dm_data, sigma_dm, free)
    r = torch.cat([r_t, r_dm])
    M = torch.cat([M_t.T, M_dm], dim=1)
    basis = stacked_basis(model, params, tensor, r_dm.shape[0])
    mtcm, mtcy, chi2_0, ahat, norm = ecorr_normal_eq(
        r[None], M[None], _weights(sigma_t, sigma_dm), basis, _RIDGE, weighted_norm=True)
    r_aug = torch.cat([r_t * (1.0 / sigma_t), r_dm])
    return r_aug, mtcm[0], mtcy[0], norm[0], chi2_0[0], ahat[0]


def wb_chi2(model: TimingModel, params: dict, tensor: dict, weights: torch.Tensor,
            sigma_t: torch.Tensor, sigma_dm: torch.Tensor, dm_data: torch.Tensor,
            subtract_mean: bool) -> torch.Tensor:
    """r_aug^T C^-1 r_aug at fixed parameters (pint_tpu get_wb_chi2_fn): K1
    with no lanes, K8's DM-row pass with no columns, K3 with no columns."""
    _, r, f = phase_residual_frac(model, params, tensor, subtract_mean, weights)
    _, r_dm, _ = dm_rows(model, params, tensor, dm_data, sigma_dm)
    rr = torch.cat([r[0] / f[0], r_dm])
    basis = stacked_basis(model, params, tensor, r_dm.shape[0])
    no_cols = rr.new_zeros((1, 0, rr.shape[0]))
    return ecorr_normal_eq(rr[None], no_cols, _weights(sigma_t, sigma_dm), basis, 0.0)[2][0]


class WidebandDownhillFitter(WLSFitter):
    """Levenberg-Marquardt wideband fit (pint_tpu WidebandDownhillFitter's
    host loop) on the combined TOA + DM system: one K1 + K8 + K3
    linearization and one eigh per iteration. `toas` is prepared wideband
    TOAs or their tensor dict."""

    def __init__(self, toas, model: TimingModel, residuals: WidebandTOAResiduals | None = None,
                 mesh=None, fused=None):
        refuse_unported(mesh, fused)
        self.toas = toas
        self.model = model
        self.resids = residuals or WidebandTOAResiduals(toas, model)
        self.tensor = self.resids.tensor
        self._free = tuple(model.free_params)
        self.result: FitResult | None = None

    def _inputs(self) -> tuple:
        r = self.resids
        return (r.toa.weights, r.errors_s, r.dm_errors, r.dm_data, r.toa.subtract_mean)

    def _step(self, params):
        return wb_step(self.model, self._free, params, self.tensor, *self._inputs())

    def chi2_at(self, params: dict) -> float:
        return float(wb_chi2(self.model, params, self.tensor, *self._inputs()))

    def _rebuild_resids(self) -> WidebandTOAResiduals:
        return WidebandTOAResiduals(self.tensor, self.model,
                                    subtract_mean=self.resids.toa.subtract_mean,
                                    track_mode=self.resids.toa.track_mode)

    def fit_toas(self, maxiter: int = 30, required_chi2_decrease: float = 1e-2,
                 max_rejects: int = 16) -> FitResult:
        p = len(self._free)
        slot = _FactorSlot()
        params, chi2_best, it, converged, pieces = run_lm(
            self.model.params, self.chi2_at(self.model.params),
            compute_pieces=self._step,
            solve=lambda pc, lam: slot.get(pc, pc[1], pc[2], pc[3], p).solve(lam),
            chi2_of=self.chi2_at,
            apply_step=lambda pr, dx: apply_delta(pr, self._free, dx),
            maxiter=maxiter, required_gain=required_chi2_decrease,
            max_rejects=max_rejects, log_label="wideband fit")
        _, mtcm, mtcy, norm, _, ahat = pieces
        factor = slot.get(pieces, mtcm, mtcy, norm, p)
        es, _ = factor.eig()
        self.noise_ampls = ahat.detach().cpu().numpy()
        return self._finalize_fit(params, chi2_best, it, converged, factor.cov(),
                                  torch.flip(es, (0,)))

    def designmatrix(self) -> np.ndarray:
        """The combined UNWEIGHTED (N_t + N_dm, p) design at the model's
        current parameters: TOA rows d(time residual)/d(param), DM rows
        d(model DM)/d(param), zero where a row has no DM measurement."""
        r = self.resids
        params = self.model.params
        _, M_t = time_resid_design(self.model, self._free, params, self.tensor,
                                   r.toa.weights, r.toa.subtract_mean, hybrid=False)
        e = r.dm_errors
        unit = torch.where(torch.isfinite(e), torch.ones_like(e), torch.full_like(e, np.inf))
        _, _, M_dm = dm_rows(self.model, params, self.tensor, r.dm_data, unit, self._free)
        return torch.cat([M_t, M_dm.T]).detach().cpu().numpy()

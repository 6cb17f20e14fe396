"""Fake TOAs lying on a model, and noise draws (counterpart of
``zero_residuals``, ``_reprepare``, ``make_fake_toas_fromMJDs``,
``add_noise_from_model`` and ``add_gwb_to_arrays`` in
``pint_tpu/simulation.py``).

Every step goes through the port's own TOA prepare (``toas.prepare_arrays``:
K4, K5 on the card) and residuals (K1); the noise bases are K8's. The
normal deviates are drawn in pint_tpu's order (the white noise, then the
ECORR and dense coefficients of each pulsar, then one draw of the common
background over the whole array), so that one seed gives both packages the
same deviates.
"""

from __future__ import annotations

import logging
import os
from dataclasses import replace

import numpy as np
import torch

from pint_tpu_torch.astro import time as ptime
from pint_tpu_torch.astro.observatories import get_observatory
from pint_tpu_torch.residuals import Residuals
from pint_tpu_torch.toas import TOAs, prepare_arrays

log = logging.getLogger("pint_tpu_torch.simulation")


def zero_residuals(toas: TOAs, model, maxiter: int = 10, tolerance_s: float = 1e-9) -> TOAs:
    """Shift the TOAs' (UTC) times until the model's residuals are below
    `tolerance_s`, re-preparing at each pass. A stall within 10x the
    tolerance returns the best pass with a warning; anything worse raises."""
    cur = toas
    best, best_worst = toas, np.inf
    for i in range(maxiter):
        r = Residuals(cur, model, subtract_mean=False,
                      track_mode="nearest").time_resids.cpu().numpy()
        worst = float(np.max(np.abs(r)))
        if worst < tolerance_s:
            log.info(f"zero_residuals converged after {i} passes (worst {worst:.2e} s)")
            return cur
        if worst < best_worst:
            best, best_worst = cur, worst
        cur = _reprepare(cur, -r, device=model.device)
    if best_worst < 10.0 * tolerance_s:
        log.warning(
            f"zero_residuals stalled at {best_worst:.2e} s after {maxiter} passes "
            f"(tolerance {tolerance_s} s); returning best-effort TOAs")
        return best
    raise RuntimeError(
        f"zero_residuals did not reach {tolerance_s} s in {maxiter} passes (worst {best_worst:.2e} s)")


def _reprepare(toas: TOAs, shift_s: np.ndarray, device=None) -> TOAs:
    """Re-prepare with the raw site UTC shifted by `shift_s`, keeping the
    clock-chain settings. A shift whose running total since the last full
    prepare stays within ``PINT_TPU_REPREPARE_REUSE_US`` microseconds (10 by
    default) reuses the clock corrections and the geometry and shifts only
    the time columns: the geometry is then off by at most (v_earth / c) x
    the total, ~1 ns at 10 us (``TOAs.geom_stale_s`` keeps the total)."""
    shift = np.asarray(shift_s, float)
    worst = float(np.max(np.abs(shift))) if shift.size else 0.0
    limit = float(os.environ.get("PINT_TPU_REPREPARE_REUSE_US") or 10) * 1e-6
    stale = toas.geom_stale_s + worst
    if stale <= limit:
        return replace(
            toas,
            utc=toas.utc.add_seconds(shift),
            tdb=toas.tdb.add_seconds(shift),
            utc_raw=None if toas.utc_raw is None else toas.utc_raw.add_seconds(shift),
            geom_stale_s=stale)
    base = toas.utc_raw if toas.utc_raw is not None else toas.utc
    return prepare_arrays(
        base.add_seconds(shift_s), toas.error_us, toas.freq_mhz, toas.obs, flags=toas.flags,
        ephem=toas.ephem, planets=toas.planets, include_gps=toas.include_gps,
        include_bipm=toas.include_bipm, bipm_version=toas.bipm_version, device=device)


def make_fake_toas_fromMJDs(mjds: np.ndarray, model, obs: str = "gbt",
                            freq_mhz: float | np.ndarray = 1400.0,
                            error_us: float | np.ndarray = 1.0,
                            flags: list[dict] | None = None) -> TOAs:
    """Fake TOAs at the given MJDs lying exactly on `model`, prepared on the
    model's device. `flags` (one dict per TOA) bind the mask parameters as
    a .tim file's flags would. Noise is drawn separately
    (`add_noise_from_model`, `add_gwb_to_arrays`)."""
    ntoas = len(mjds)
    utc = ptime.MJDEpoch.from_mjd_float(np.asarray(mjds, float))
    err = np.broadcast_to(np.asarray(error_us, float), (ntoas,)).copy()
    frq = np.broadcast_to(np.asarray(freq_mhz, float), (ntoas,)).copy()
    obs_arr = np.array([get_observatory(obs).name] * ntoas)
    toas = prepare_arrays(utc, err, frq, obs_arr, flags=flags,
                          ephem=model.meta.get("EPHEM") or "auto", planets=False,
                          device=model.device)
    return zero_residuals(toas, model)


def add_noise_from_model(toas: TOAs, model, rng=None, include_common: bool = True) -> TOAs:
    """Shift the TOAs by one draw of the model's noise covariance
    diag(sigma^2) + F phi F^T: white noise of the EFAC/EQUAD-scaled sigmas,
    then normal coefficients of every basis column (ECORR epochs, then the
    dense power-law columns) scaled by sqrt(phi) and mapped through the basis.
    ``include_common=False`` leaves the common background out (an array
    draws it across the pulsars with `add_gwb_to_arrays`)."""
    from pint_tpu_torch.fitting.woodbury import basis_matvec

    rng = rng or np.random.default_rng()
    res = Residuals(toas, model, subtract_mean=False)
    n = len(toas)
    sigma = model.scaled_sigma(model.params, res.tensor)[:n].cpu().numpy()
    shift = rng.standard_normal(n) * sigma
    basis = model.noise_basis_and_weights(model.params, res.tensor, include_common=include_common)
    if basis is not None:
        dev = res.tensor["t_hi"].device
        ae = ad = None
        if basis.ephi is not None:
            ae = torch.as_tensor(rng.standard_normal(basis.ke)
                                 * np.sqrt(basis.ephi.cpu().numpy()), device=dev)
        if basis.dense_phi is not None:
            ad = torch.as_tensor(rng.standard_normal(basis.kd)
                                 * np.sqrt(basis.dense_phi.cpu().numpy()), device=dev)
        shift = shift + basis_matvec(basis, ae, ad)[:n].cpu().numpy()
    return _reprepare(toas, shift, device=model.device)


def add_gwb_to_arrays(toas_list, models, rng=None):
    """Shift an array of N pulsars' TOAs by one Hellings-Downs correlated
    draw of the common background their models carry: normal coefficients
    on the shared Fourier grid (the array's span) scaled by sqrt(phi_gw),
    mixed across pulsars by the Cholesky factor of the ORF, and mapped
    through each pulsar's common block. The pulsars' own noise is not drawn
    here (`add_noise_from_model` with ``include_common=False``). Returns the
    shifted TOAs in order."""
    from pint_tpu_torch.fitting.design import fourier_basis
    from pint_tpu_torch.models.noise import fourier_freqs, orf_matrix, pulsar_position

    rng = rng or np.random.default_rng()
    if len(toas_list) != len(models):
        raise ValueError("toas_list and models must pair up")
    comps = [m.common_noise_component for m in models]
    if any(c is None for c in comps):
        raise ValueError("every model needs a common GWB component "
                         "(TNGWAMP/TNGWGAM) to draw a correlated GWB")
    nf = comps[0].nf
    if any(c.nf != nf for c in comps):
        raise ValueError("array common-process mode counts differ")
    n = len(models)
    L = np.linalg.cholesky(orf_matrix(np.stack([pulsar_position(m) for m in models])))
    # the shared span and each pulsar's times, in the tensor's convention
    # (TDB seconds since the tensor epoch)
    t_cols, lo, hi = [], np.inf, -np.inf
    for t, m in zip(toas_list, models):
        tc = m.build_tensor(t)["t_hi"][: len(t)]
        real = np.asarray(t.error_us) > 0
        tr = tc.cpu().numpy()
        tr = tr[real] if real.any() else tr
        lo, hi = min(lo, tr.min()), max(hi, tr.max())
        t_cols.append(tc)
    tspan = hi - lo
    dev = t_cols[0].device
    freqs = np.repeat(np.linspace(1.0 / tspan, nf / tspan, nf), 2)
    phi = comps[0].weights_at(models[0].params, torch.as_tensor(freqs, device=dev)).cpu().numpy()
    xi = rng.standard_normal((n, 2 * nf)) * np.sqrt(phi)
    coeff = L @ xi  # (N, m): the HD-mixed mode coefficients
    grid = fourier_freqs(nf, torch.tensor(tspan, dtype=torch.float64, device=dev))
    out = []
    for a, (t, m) in enumerate(zip(toas_list, models)):
        G = fourier_basis(t_cols[a], grid).cpu().numpy()
        out.append(_reprepare(t, G @ coeff[a], device=m.device))
    return out

"""Noise models: white-noise rescaling and the ECORR basis (counterpart of
``ScaleToaError``, ``EcorrNoise`` and ``NoiseComponent`` in
``pint_tpu/models/noise.py``).

Noise enters a fit through two surfaces:

- ``scale_sigma(params, tensor, sigma)``: per-TOA uncertainty rescaling
  (EFAC/EQUAD), elementwise over the mask columns of the tensor;
- ``basis_and_weights(params, tensor, sl)``: the correlated-noise basis in
  structured form (``fitting/woodbury.NoiseBasis``). For ECORR it is the
  implicit per-TOA epoch index and the prior variance of each epoch; the
  Woodbury algebra of ``fitting/woodbury.py`` (and kernel K3) never builds
  the (N, k_epoch) membership matrix.

The epoch grouping is host work of ``TimingModel.build_tensor``
(``EcorrNoise.host_columns``, on the prepared TDB); a prepared archive
carries its result (``ecorr_eidx``, ``ecorr_widx``). The power-law
Fourier bases (PLRedNoise, PLDMNoise, PLGWBNoise) are not ported yet
(ROADMAP A9, A12).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from pint_tpu_torch.models.base import Component, leaf_to_f64
from pint_tpu_torch.models.parameter import ParamSpec

log = logging.getLogger("pint_tpu_torch.noise")


def hypot(x, y):
    """jax.numpy.hypot's algorithm, so that scaled sigmas are bitwise those
    of the JAX package: max(|x|, |y|) sqrt(1 + (min/max)^2)."""
    x, y = torch.abs(x), torch.abs(y)
    idx_inf = torch.isposinf(x) | torch.isposinf(y)
    x, y = torch.maximum(x, y), torch.minimum(x, y)
    q = y / torch.where(x == 0, torch.ones_like(x), x)
    h = torch.where(x == 0, x, x * torch.sqrt(1 + q * q))
    return torch.where(idx_inf, torch.full_like(h, float("inf")), h)


class NoiseComponent(Component):
    register = False
    introduces_correlated_errors = False

    def scale_sigma(self, params: dict, tensor: dict, sigma):
        """Rescale per-TOA sigmas (seconds); identity by default."""
        return sigma

    def basis_and_weights(self, params: dict, tensor: dict, sl):
        """``("epoch", eidx (N_data,) int64, phi (ke,))`` for ECORR, or None."""
        return None


class ScaleToaError(NoiseComponent):
    """EFAC/EQUAD rescaling: sigma' = EFAC sqrt(sigma^2 + EQUAD^2) over each
    mask, EQUADs in quadrature first, then EFACs."""

    category = "scale_toa_error"
    register = True

    @classmethod
    def mask_bases(cls):
        return [
            ParamSpec("EFAC", unit="", aliases=("T2EFAC",), description="error scale factor"),
            ParamSpec("EQUAD", scale=1e-6, unit="us", aliases=("T2EQUAD",),
                      description="error added in quadrature"),
        ]

    def scale_sigma(self, params, tensor, sigma):
        for mp in self.mask_params:
            if mp.base != "EQUAD":
                continue
            m = tensor[f"mask_{mp.name}"]
            eq = leaf_to_f64(params[mp.name])
            sigma = torch.where(m > 0, hypot(sigma, eq), sigma)
        for mp in self.mask_params:
            if mp.base != "EFAC":
                continue
            m = tensor[f"mask_{mp.name}"]
            ef = leaf_to_f64(params[mp.name])
            sigma = torch.where(m > 0, ef * sigma, sigma)
        return sigma


def _quantize_epochs(t_s: np.ndarray, dt: float = 1.0, nmin: int = 2) -> list[np.ndarray]:
    """Group times into buckets separated by > dt seconds, keeping buckets
    with >= nmin members (NANOGrav ECORR epochs: simultaneous sub-band TOAs
    within ~1 s)."""
    if len(t_s) == 0:
        return []
    isort = np.argsort(t_s)
    buckets = [[isort[0]]]
    ref = t_s[isort[0]]
    for i in isort[1:]:
        if t_s[i] - ref < dt:
            buckets[-1].append(i)
        else:
            buckets.append([i])
            ref = t_s[i]
    return [np.asarray(b) for b in buckets if len(b) >= nmin]


class EcorrNoise(NoiseComponent):
    """Epoch-correlated white noise: a fully correlated error within each
    observing epoch of a backend. The archive carries the epoch of every
    row (``ecorr_eidx``, float64, -1 for none, the TZR row included) and
    the ECORR parameter of every epoch (``ecorr_widx``, shape (1, ke): the
    leading axis keeps it clear of the row axis)."""

    category = "ecorr_noise"
    register = True
    introduces_correlated_errors = True

    @classmethod
    def mask_bases(cls):
        return [ParamSpec("ECORR", scale=1e-6, unit="us", aliases=("TNECORR",),
                          description="epoch-correlated error")]

    def host_columns(self, toas, params):
        """The mask columns, then each row's epoch (``ecorr_eidx``, -1 for
        none) and each epoch's ECORR parameter (``ecorr_widx``), grouped on
        the prepared TDB. Zero-error rows (the TZR row) join no epoch; where
        two ECORR selections overlap, the first keeps the rows."""
        cols = super().host_columns(toas, params)
        t_s = toas.tdb.mjd_float() * 86400.0
        n = len(toas)
        real = np.asarray(toas.error_us) > 0
        eidx = np.full(n, -1.0)
        widx: list[int] = []
        k = 0
        for pi, mp in enumerate(self.mask_params):
            mask = np.flatnonzero((cols[f"mask_{mp.name}"] > 0) & real)
            for bucket in _quantize_epochs(t_s[mask]):
                rows = mask[bucket]
                taken = eidx[rows] >= 0
                if taken.any():
                    log.warning(f"{int(taken.sum())} TOAs already in an ECORR epoch; "
                                f"{mp.name} keeps only the unclaimed ones")
                    rows = rows[~taken]
                    if len(rows) < 2:
                        continue
                eidx[rows] = k
                widx.append(pi)
                k += 1
        if k == 0:
            log.warning("ECORR present but no epoch has >= 2 selected TOAs")
        cols["ecorr_eidx"] = eidx
        cols["ecorr_widx"] = (np.asarray(widx, np.float64)[None, :] if widx
                              else np.zeros((1, 0)))
        return cols

    def basis_and_weights(self, params, tensor, sl):
        widx_arr = tensor["ecorr_widx"]
        if widx_arr.shape[1] == 0:
            return None
        eidx = tensor["ecorr_eidx"][sl].to(torch.int64)
        widx = widx_arr[0].to(torch.int64)
        vals = torch.stack([leaf_to_f64(params[mp.name]) for mp in self.mask_params])
        phi = vals[widx] ** 2
        return ("epoch", eidx, phi)

"""Dispersion delay DMconst * DM(t) / f_bary^2 (counterpart of
``DispersionDM`` and ``DispersionDMX`` in ``pint_tpu/models/dispersion.py``).

The frequency is Doppler-corrected to the SSB frame, f_bary = f (1 - v.n/c);
DM is a Taylor polynomial about DMEPOCH. The delay is exactly linear in
every DM coefficient, so the fitters build those design columns in closed
form (`linear_resid_columns`, used by ``fitting/design.py``). DMX holds a
piecewise-constant DM per MJD window: the windows become a dense (N, n_dmx)
one-hot host column (``dmx_onehot``), and the window DM of every row is its
product with the DMX values, exact for disjoint windows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch import DMCONST
from pint_tpu_torch.models.astrometry import dot3
from pint_tpu_torch.models.base import DelayComponent, dt_since_epoch_f64, leaf_to_f64
from pint_tpu_torch.models.parameter import PER_YEAR_TO_PER_SEC, ParamSpec, PrefixSpec
from pint_tpu_torch.ops.taylor import taylor_horner


def dispersion_time_delay(dm: torch.Tensor, freq_mhz: torch.Tensor) -> torch.Tensor:
    """DMconst * DM / f^2, zero at infinite frequency."""
    fsq = freq_mhz * freq_mhz
    return torch.where(torch.isfinite(freq_mhz), DMCONST * dm / fsq, 0.0)


def barycentric_radio_freq(tensor: dict) -> torch.Tensor:
    """Observed frequency Doppler-shifted to the SSB frame."""
    if "_psr_dir" not in tensor:
        return tensor["freq_mhz"]
    beta = dot3(tensor["ssb_obs_vel_ls"], tensor["_psr_dir"])
    return tensor["freq_mhz"] * (1.0 - beta)


def _dm_spec(k: int) -> ParamSpec:
    return ParamSpec(
        name=f"DM{k}" if k else "DM",
        scale=PER_YEAR_TO_PER_SEC**k,
        unit=f"pc cm^-3 / yr^{k}" if k else "pc cm^-3",
        description=f"DM Taylor coefficient {k}",
        default=0.0 if k else None,
    )


class DispersionDM(DelayComponent):
    category = "dispersion_constant"
    register = True

    @classmethod
    def param_specs(cls):
        return [_dm_spec(0), ParamSpec("DMEPOCH", kind="epoch", unit="MJD")]

    @classmethod
    def prefix_specs(cls):
        return [PrefixSpec("DM", _dm_spec, start=1)]

    def __init__(self):
        super().__init__()
        self.num_terms = 1

    def add_prefix_param(self, spec):
        super().add_prefix_param(spec)
        k = int(spec.name[2:])
        self.num_terms = max(self.num_terms, k + 1)

    def validate(self, params, meta):
        if "DM" not in params:
            raise ValueError("DispersionDM requires DM")
        if self.num_terms > 1 and "DMEPOCH" not in params:
            raise ValueError("DM derivatives need DMEPOCH")

    def coeff_names(self) -> list[str]:
        return [f"DM{k}" if k else "DM" for k in range(self.num_terms)]

    def base_dm(self, params: dict, tensor: dict) -> torch.Tensor:
        coeffs = [leaf_to_f64(params[n]) for n in self.coeff_names()]
        if self.num_terms == 1:
            return coeffs[0] * torch.ones_like(tensor["t_hi"])
        dt = dt_since_epoch_f64(tensor, params["DMEPOCH"])
        return taylor_horner(dt, coeffs)

    def dm_param_names(self) -> list[str]:
        return self.coeff_names()

    def dm_value(self, params: dict, tensor: dict) -> torch.Tensor:
        return self.base_dm(params, tensor)

    def dm_columns(self, params: dict, tensor: dict) -> dict:
        """d base_dm / d DM<k>: the Horner rule run on the k-th unit vector,
        the tangent pint_tpu's forward mode takes through taylor_horner."""
        if self.num_terms == 1:
            return {"DM": torch.ones_like(tensor["t_hi"])}
        dt = dt_since_epoch_f64(tensor, params["DMEPOCH"])
        names = self.coeff_names()
        return {n: taylor_horner(dt, [float(j == k) for j in range(self.num_terms)])
                for k, n in enumerate(names)}

    def delay(self, params: dict, tensor: dict, delay_so_far, xp):
        return dispersion_time_delay(self.base_dm(params, tensor), barycentric_radio_freq(tensor))

    def linear_param_names(self):
        return self.coeff_names()

    def linear_resid_columns(self, params, tensor, f, sl):
        fb = barycentric_radio_freq(tensor)[..., sl]
        base = torch.where(torch.isfinite(fb), -DMCONST / (fb * fb), 0.0)
        out = {"DM": base}
        if self.num_terms > 1:
            dt = dt_since_epoch_f64(tensor, params["DMEPOCH"])[..., sl]
            pw = torch.ones_like(dt)
            for k in range(1, self.num_terms):
                pw = pw * dt
                out[f"DM{k}"] = base * pw / math.factorial(k)
        return out


def _dmx_value_spec(k: int) -> ParamSpec:
    return ParamSpec(name=f"DMX_{k:04d}", unit="pc cm^-3",
                     description=f"DM offset in window {k}", default=0.0)


class DispersionDMX(DelayComponent):
    """Piecewise-constant DM offsets in MJD windows (DMX_nnnn with its
    DMXR1_nnnn / DMXR2_nnnn range, inclusive, on the TDB MJD)."""

    category = "dispersion_dmx"
    register = True

    @classmethod
    def param_specs(cls):
        return [ParamSpec("DMX", unit="pc cm^-3", default=0.0)]

    def __init__(self):
        super().__init__()
        self.windows: dict[int, tuple[float, float]] = {}

    def add_window(self, idx: int, r1_mjd: float, r2_mjd: float) -> None:
        self.windows[idx] = (r1_mjd, r2_mjd)
        self.specs[f"DMX_{idx:04d}"] = _dmx_value_spec(idx)

    @property
    def sorted_indices(self) -> list[int]:
        return sorted(self.windows)

    def validate(self, params, meta):
        for i in self.sorted_indices:
            r1, r2 = self.windows[i]
            if not (r2 > r1):
                raise ValueError(f"DMX window {i} has DMXR2 <= DMXR1")
            if f"DMX_{i:04d}" not in params:
                raise ValueError(f"DMX window {i} missing DMX_{i:04d}")

    def host_columns(self, toas, params):
        cols = super().host_columns(toas, params)
        mjd = toas.tdb.mjd_float()
        idxs = self.sorted_indices
        onehot = np.zeros((len(toas), len(idxs)))
        for j, i in enumerate(idxs):
            r1, r2 = self.windows[i]
            onehot[:, j] = (mjd >= r1) & (mjd <= r2)
        cols["dmx_onehot"] = onehot
        return cols

    def dmx_values(self, params: dict) -> torch.Tensor:
        """(..., n_dmx) the DMX values in window order."""
        return torch.stack([params[f"DMX_{i:04d}"] for i in self.sorted_indices], dim=-1)

    def dmx_dm(self, params: dict, tensor: dict) -> torch.Tensor:
        return tensor["dmx_onehot"] @ self.dmx_values(params)

    def dm_param_names(self) -> list[str]:
        return self.linear_param_names()

    def dm_value(self, params: dict, tensor: dict) -> torch.Tensor:
        return self.dmx_dm(params, tensor)

    def dm_columns(self, params: dict, tensor: dict) -> dict:
        onehot = tensor["dmx_onehot"]
        return {n: onehot[:, j] for j, n in enumerate(self.linear_param_names())}

    def delay(self, params: dict, tensor: dict, delay_so_far, xp):
        return dispersion_time_delay(self.dmx_dm(params, tensor), barycentric_radio_freq(tensor))

    def linear_param_names(self):
        return [f"DMX_{i:04d}" for i in self.sorted_indices]

    def linear_resid_columns(self, params, tensor, f, sl):
        fb = barycentric_radio_freq(tensor)[..., sl]
        base = torch.where(torch.isfinite(fb), -DMCONST / (fb * fb), 0.0)
        onehot = tensor["dmx_onehot"][sl]
        return {f"DMX_{i:04d}": base * onehot[:, j] for j, i in enumerate(self.sorted_indices)}


class DispersionJump(DelayComponent):
    """DMJUMP: a constant offset of the measured wideband DMs of a selection
    (``DMJUMP -f Rcvr_800_GUPPI 0.001 1``). It enters the model DM with a
    minus sign and no delay (its TOA design column is exactly zero)."""

    category = "dispersion_jump"
    register = True

    @classmethod
    def mask_bases(cls):
        return [ParamSpec("DMJUMP", unit="pc cm^-3", description="DM value offset")]

    def dm_param_names(self) -> list[str]:
        return [mp.name for mp in self.mask_params]

    def dm_value(self, params: dict, tensor: dict) -> torch.Tensor:
        out = torch.zeros_like(tensor["t_hi"])
        for mp in self.mask_params:
            out = out - tensor[f"mask_{mp.name}"] * leaf_to_f64(params[mp.name])
        return out

    def dm_columns(self, params: dict, tensor: dict) -> dict:
        return {mp.name: -tensor[f"mask_{mp.name}"] for mp in self.mask_params}

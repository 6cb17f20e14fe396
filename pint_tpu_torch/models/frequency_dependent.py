"""Frequency-dependent (FD) profile-evolution delay (counterpart of
``pint_tpu/models/frequency_dependent.py``):

    delay = sum_k FD_k log(f_bary / 1 GHz)^k,  k = 1..n

by Horner's rule over log-frequency, zero at a non-finite or non-positive
frequency. The delay is linear in every FD_k, so the fitters build those
columns in closed form (`linear_resid_columns`).
"""

from __future__ import annotations

import torch

from pint_tpu_torch.astro.erot import fdiv
from pint_tpu_torch.models.base import DelayComponent, leaf_to_f64
from pint_tpu_torch.models.dispersion import barycentric_radio_freq
from pint_tpu_torch.models.parameter import ParamSpec, PrefixSpec
from pint_tpu_torch.ops import libm


def _fd_spec(k: int) -> ParamSpec:
    return ParamSpec(f"FD{k}", unit="s", default=0.0,
                     description=f"delay coefficient of log-frequency^{k}")


def log_f_ghz(tensor: dict):
    """(finite, log(f_bary / 1 GHz) with 1 GHz where not finite)."""
    f_ghz = fdiv(barycentric_radio_freq(tensor), 1e3)
    finite = torch.isfinite(f_ghz) & (f_ghz > 0)
    return finite, libm.log(torch.where(finite, f_ghz, 1.0))


class FD(DelayComponent):
    category = "frequency_dependent"
    register = True

    def __init__(self):
        super().__init__()
        self.num_terms = 0

    @classmethod
    def prefix_specs(cls):
        return [PrefixSpec("FD", _fd_spec, start=1)]

    def add_prefix_param(self, spec):
        super().add_prefix_param(spec)
        self.num_terms = max(self.num_terms, int(spec.name[2:]))

    def validate(self, params, meta):
        if self.num_terms == 0:
            raise ValueError("FD component with no FD terms")

    def coeffs(self, params: dict) -> list:
        return [leaf_to_f64(params.get(f"FD{k}", 0.0)) for k in range(1, self.num_terms + 1)]

    def delay(self, params: dict, tensor: dict, delay_so_far, xp):
        finite, logf = log_f_ghz(tensor)
        out = torch.zeros_like(logf)
        for c in reversed(self.coeffs(params)):
            out = (out + c) * logf
        return torch.where(finite, out, 0.0)

    def linear_param_names(self):
        return [f"FD{k}" for k in range(1, self.num_terms + 1)]

    def linear_resid_columns(self, params, tensor, f, sl):
        finite, logf = log_f_ghz(tensor)
        finite, logf = finite[..., sl], logf[..., sl]
        out = {}
        pw = torch.ones_like(logf)
        for k in range(1, self.num_terms + 1):
            pw = pw * logf
            out[f"FD{k}"] = torch.where(finite, -pw, 0.0)
        return out

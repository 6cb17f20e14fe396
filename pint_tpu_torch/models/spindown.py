"""Spindown: Taylor-polynomial pulse phase in F0..Fn about PEPOCH
(counterpart of ``pint_tpu/models/spindown.py``). The Horner runs in
double-double; F0 and F1 are exact-split DD parameters."""

from __future__ import annotations

import torch

from pint_tpu_torch.models.base import PhaseComponent, barycentric_time_x, leaf_to_f64
from pint_tpu_torch.models.parameter import ParamSpec, PrefixSpec
from pint_tpu_torch.ops.taylor import taylor_horner_deriv, taylor_horner_x


def _f_spec(k: int) -> ParamSpec:
    return ParamSpec(
        name=f"F{k}",
        kind="dd" if k <= 1 else "float",
        unit=f"Hz s^-{k}" if k else "Hz",
        description=f"Spin frequency derivative {k}",
    )


class Spindown(PhaseComponent):
    category = "spindown"
    register = True

    @classmethod
    def param_specs(cls):
        return [ParamSpec("PEPOCH", kind="epoch", unit="MJD", description="Spin epoch"),
                _f_spec(0)]

    @classmethod
    def prefix_specs(cls):
        return [PrefixSpec("F", _f_spec, start=0)]

    def __init__(self):
        super().__init__()
        self.num_terms = 1  # highest F index + 1

    def add_prefix_param(self, spec):
        super().add_prefix_param(spec)
        k = int(spec.name[1:])
        self.num_terms = max(self.num_terms, k + 1)

    def validate(self, params, meta):
        if "PEPOCH" not in params:
            raise ValueError("Spindown requires PEPOCH")
        for k in range(self.num_terms):
            if f"F{k}" not in params:
                raise ValueError(f"missing F{k} (F terms must be contiguous)")

    def coeffs(self, params: dict) -> list:
        """[0, F0, F1, ...]: phase = sum F_k dt^(k+1)/(k+1)!."""
        return [0.0] + [params[f"F{k}"] for k in range(self.num_terms)]

    def dt_x(self, params: dict, tensor: dict, total_delay, xp):
        t = barycentric_time_x(xp, params, tensor, total_delay)
        return xp.sub(t, xp.lift(params["PEPOCH"], t.hi))

    def phase(self, params: dict, tensor: dict, total_delay, xp):
        return taylor_horner_x(xp, self.dt_x(params, tensor, total_delay, xp), self.coeffs(params))

    def spin_frequency(self, params: dict, tensor: dict, total_delay, xp) -> torch.Tensor:
        """Instantaneous f(t) in Hz, float64."""
        dt = xp.to_f64(self.dt_x(params, tensor, total_delay, xp))
        coeffs = [leaf_to_f64(c) for c in self.coeffs(params)]
        return taylor_horner_deriv(dt, coeffs, 1)

"""Absolute phase and phase jumps (counterpart of ``AbsPhase`` and
``PhaseJump`` in ``pint_tpu/models/phase_misc.py``).

The TZR fiducial TOA is prepared once on the host and appended as the LAST
row of the TOA tensor; ``TimingModel.phase_and_freq`` subtracts its phase
after all phase terms. TZRMJD/TZRSITE/TZRFRQ configure that row and live in
``model.meta``, not in the fit parameters.

A JUMP (``JUMP -f Rcvr_800_GUPPI 1e-6 1``) is a phase offset F0 * jump
seconds on the TOAs its mask selects; its design column is exactly
mask * F0 / f.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.base import PhaseComponent, leaf_to_f64
from pint_tpu_torch.models.parameter import ParamSpec


class AbsPhase(PhaseComponent):
    category = "absolute_phase"
    register = True

    def validate(self, params, meta):
        if "TZR_DAY" not in meta:
            raise ValueError("AbsPhase requires TZRMJD")

    def phase(self, params, tensor, total_delay, xp):
        return xp.zeros_like(tensor["t_hi"])


class PhaseJump(PhaseComponent):
    """JUMP as a phase offset F0 * jump_seconds on the selected TOAs."""

    category = "phase_jump"
    register = True

    @classmethod
    def mask_bases(cls):
        return [ParamSpec("JUMP", unit="s")]

    def validate(self, params, meta):
        if "F0" not in params:
            raise ValueError("PhaseJump requires a Spindown F0 in the model")

    def jump_seconds(self, params: dict, tensor: dict) -> torch.Tensor:
        """Sum of mask * JUMP over the jumps, in parfile order."""
        total = torch.zeros_like(tensor["t_hi"])
        for mp in self.mask_params:
            total = total + tensor[f"mask_{mp.name}"] * leaf_to_f64(params[mp.name])
        return total

    def phase(self, params, tensor, total_delay, xp):
        return xp.from_f64(self.jump_seconds(params, tensor) * leaf_to_f64(params["F0"]))

    def linear_param_names(self):
        return [mp.name for mp in self.mask_params]

    def linear_resid_columns(self, params, tensor, f, sl):
        f0 = leaf_to_f64(params["F0"])
        return {mp.name: tensor[f"mask_{mp.name}"][sl] * f0 / f for mp in self.mask_params}

"""Absolute phase (counterpart of ``AbsPhase`` in
``pint_tpu/models/phase_misc.py``).

The TZR fiducial TOA is prepared once on the host and appended as the LAST
row of the TOA tensor; ``TimingModel.phase_and_freq`` subtracts its phase
after all phase terms. TZRMJD/TZRSITE/TZRFRQ configure that row and live in
``model.meta``, not in the fit parameters.
"""

from __future__ import annotations

from pint_tpu_torch.models.base import PhaseComponent


class AbsPhase(PhaseComponent):
    category = "absolute_phase"
    register = True

    def validate(self, params, meta):
        if "TZR_DAY" not in meta:
            raise ValueError("AbsPhase requires TZRMJD")

    def phase(self, params, tensor, total_delay, xp):
        return xp.zeros_like(tensor["t_hi"])

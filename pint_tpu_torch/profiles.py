"""Workload profiles (counterpart of ``pint_tpu/profiles.py``): the parfile
of the smoke workload and its default scan grid."""

from __future__ import annotations

import numpy as np

#: minimal single-receiver smoke par (astrometry + spin + DM), the model of
#: the committed prepared-TOA archive (prepared.SMOKE_ARCHIVE)
SMOKE_PAR = """
PSR SMOKE
RAJ 04:37:15.9 1
DECJ -47:15:09.1 1
F0 173.6879489990983 1
F1 -1.728e-15 1
PEPOCH 55000
POSEPOCH 55000
DM 2.64 1
TZRMJD 55000.1
TZRSITE gbt
TZRFRQ 1400
"""


def spin_grid(model, ftr):
    """3x3 (F0, F1) grid around the model values, +-1 sigma when the fitter
    has uncertainties."""
    f0 = float(model.params["F0"].hi)
    f1 = float(model.params["F1"].hi)
    unc = ftr.result.uncertainties if ftr.result is not None else {}
    s0 = unc.get("F0") or 1e-10
    s1 = unc.get("F1") or 1e-18
    return ("F0", "F1"), (
        np.linspace(f0 - s0, f0 + s0, 3),
        np.linspace(f1 - s1, f1 + s1, 3),
    )

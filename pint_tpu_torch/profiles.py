"""Workload profiles (counterpart of ``pint_tpu/profiles.py``): the parfiles
of the smoke and flagship-shaped workloads and their default scan grids."""

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

#: NANOGrav-style receivers: (flag value, sub-band frequencies), the epoch
#: structure that binds the EFAC/EQUAD/ECORR masks of FLAGSHIP_SMOKE_PAR
RECEIVERS = (
    ("Rcvr1_2_GUPPI", np.linspace(1150.0, 1850.0, 8)),
    ("Rcvr_800_GUPPI", np.linspace(722.0, 919.0, 8)),
)

#: flagship-shaped smoke par (J0740-like): astrometry with parallax and
#: proper motion, spin, DM + DM1, an ELL1 binary, and EFAC/EQUAD/ECORR bound
#: to the receiver flags; the model of prepared.FLAGSHIP_ARCHIVE
FLAGSHIP_SMOKE_PAR = """
PSR FLAGSMOKE
RAJ 07:40:45.79 1
DECJ 66:20:33.6 1
PMRA -9.9 1
PMDEC -33.0 1
PX 0.4 1
F0 346.531996 1
F1 -1.46e-15 1
PEPOCH 57000
POSEPOCH 57000
DM 14.96 1
DM1 0.0 1
DMEPOCH 57000
BINARY ELL1
PB 4.766944 1
A1 3.9775561 1
TASC 56999.1 1
EPS1 -5.7e-6 1
EPS2 -1.4e-5 1
M2 0.26
SINI 0.99
EFAC -f Rcvr1_2_GUPPI 1.02
EQUAD -f Rcvr1_2_GUPPI 0.01
ECORR -f Rcvr1_2_GUPPI 0.01
EFAC -f Rcvr_800_GUPPI 1.03
EQUAD -f Rcvr_800_GUPPI 0.01
ECORR -f Rcvr_800_GUPPI 0.01
TZRMJD 57000.1
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


def grid_for(model, ftr):
    """The reference 3x3 (M2, SINI) grid for a binary with M2 and SINI, else
    the spin grid."""
    if "M2" in model.param_meta and "SINI" in model.param_meta:
        return ("M2", "SINI"), (
            np.linspace(0.20, 0.30, 3),
            np.sin(np.deg2rad(np.linspace(86.25, 88.5, 3))),
        )
    return spin_grid(model, ftr)

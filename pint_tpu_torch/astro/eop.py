"""Earth-orientation parameters: UT1-UTC and polar motion from IERS data
(counterpart of ``pint_tpu/astro/eop.py``, host numpy).

By default UT1 = UTC and polar motion
is zero — a <= 1.4 us diurnal site-position effect (erot.py). For
full-accuracy work point ``PINT_TPU_EOP`` at an IERS ``finals2000A``-format
file (the standard 'finals2000A.all'/'finals.all' distribution): this
module parses the fixed-width columns and serves linearly-interpolated
(UT1-UTC [s], xp [rad], yp [rad]) with zero fallback outside the table.
"""

from __future__ import annotations

import logging
import os

import numpy as np

log = logging.getLogger("pint_tpu_torch.eop")

ARCSEC = np.pi / (180.0 * 3600.0)

_table: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None = None
_table_path: str | None = None


def parse_finals2000a(path: str):
    """(mjd, dut1_s, xp_rad, yp_rad) from a finals2000A fixed-width file.

    Columns (1-based, IERS readme.finals2000A): MJD 8-15, PM-x (IERS B or
    prediction) 19-27, PM-y 38-46, UT1-UTC 59-68. Lines without a UT1
    prediction (far future) are dropped.
    """
    mjds, dut1, xp, yp = [], [], [], []
    with open(path) as f:
        for line in f:
            if len(line) < 68:
                continue
            try:
                mjd = float(line[7:15])
                x = float(line[18:27])
                y = float(line[37:46])
                du = float(line[58:68])
            except ValueError:
                continue
            mjds.append(mjd)
            xp.append(x)
            yp.append(y)
            dut1.append(du)
    if not mjds:
        raise ValueError(f"{path}: no parseable finals2000A rows")
    return (
        np.asarray(mjds),
        np.asarray(dut1),
        np.asarray(xp) * ARCSEC,
        np.asarray(yp) * ARCSEC,
    )


def get_eop(utc_mjd: np.ndarray):
    """(dut1_s, xp_rad, yp_rad) at the given UTC MJDs.

    Zeros when PINT_TPU_EOP is unset; linear interpolation inside the
    table, zero-with-warning outside it."""
    global _table, _table_path
    path = os.environ.get("PINT_TPU_EOP")
    utc_mjd = np.asarray(utc_mjd, float)
    if not path:
        z = np.zeros_like(utc_mjd)
        return z, z.copy(), z.copy()
    stamp = (path, os.path.getmtime(path) if os.path.exists(path) else None)
    if _table is None or _table_path != stamp:
        _table = parse_finals2000a(path)
        _table_path = stamp
        log.info(
            f"loaded EOP table {path}: MJD {_table[0][0]:.0f}.."
            f"{_table[0][-1]:.0f} ({len(_table[0])} rows)"
        )
    mjd, dut1, xp, yp = _table
    inside = (utc_mjd >= mjd[0]) & (utc_mjd <= mjd[-1])
    if not inside.all():
        log.warning(
            f"{int((~inside).sum())} epochs outside the EOP table span "
            f"(MJD {mjd[0]:.0f}..{mjd[-1]:.0f}); using UT1=UTC / zero "
            "polar motion there")
    out_d = np.where(inside, np.interp(utc_mjd, mjd, dut1), 0.0)
    out_x = np.where(inside, np.interp(utc_mjd, mjd, xp), 0.0)
    out_y = np.where(inside, np.interp(utc_mjd, mjd, yp), 0.0)
    return out_d, out_x, out_y

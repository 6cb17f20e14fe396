"""Time scales: UTC -> TAI -> TT -> TDB (counterpart of
``pint_tpu/astro/time.py``: host numpy, as there, the same arithmetic
line for line). The chain is explicit:

    UTC  --(leap-second table)-->  TAI  --(+32.184 s)-->  TT
    TT   --(analytic series + topocentric term)-->        TDB

Precision notes:
- Times ride as `MJDEpoch`: integer MJD day + fractional day as an exact
  two-float64 pair, the host analogue of the device DD type (and of the
  reference's pulsar_mjd day/frac convention, pulsar_mjd.py:527).
- The TDB-TT series is the truncated Fairhead-Bretagnon expansion as given in
  USNO Circular 179 (Kaplan 2005) eq. 2.6 plus the diurnal topocentric term;
  absolute accuracy ~10 us against the full 787-term series / ephemeris
  integrations, with sub-ns numerical noise and exact differentiability. The
  ~us-level smooth annual error is absorbed by fitted astrometry at the
  1-ns-residual level; drop a full FB90 table into `_TDB_TERMS` to upgrade.
- The `pulsar_mjd` convention (UTC MJDs where every day has 86400 s, leap
  seconds smeared, matching TEMPO behavior; reference pulsar_mjd.py:84) is the
  default for .tim input.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SECS_PER_DAY = 86400.0
TT_MINUS_TAI = 32.184
MJD_J2000 = 51544.5

# (MJD of 00:00 UTC, TAI-UTC seconds from that date) — IERS leap-second
# history, public data. Dates before 1972 (rubber-second era) are out of scope
# for pulsar data and clamp to the first entry.
_LEAP_TABLE = np.array(
    [
        (41317, 10),  # 1972-01-01
        (41499, 11),  # 1972-07-01
        (41683, 12),  # 1973-01-01
        (42048, 13),  # 1974-01-01
        (42413, 14),  # 1975-01-01
        (42778, 15),  # 1976-01-01
        (43144, 16),  # 1977-01-01
        (43509, 17),  # 1978-01-01
        (43874, 18),  # 1979-01-01
        (44239, 19),  # 1980-01-01
        (44786, 20),  # 1981-07-01
        (45151, 21),  # 1982-07-01
        (45516, 22),  # 1983-07-01
        (46247, 23),  # 1985-07-01
        (47161, 24),  # 1988-01-01
        (47892, 25),  # 1990-01-01
        (48257, 26),  # 1991-01-01
        (48804, 27),  # 1992-07-01
        (49169, 28),  # 1993-07-01
        (49534, 29),  # 1994-07-01
        (50083, 30),  # 1996-01-01
        (50630, 31),  # 1997-07-01
        (51179, 32),  # 1999-01-01
        (53736, 33),  # 2006-01-01
        (54832, 34),  # 2009-01-01
        (56109, 35),  # 2012-07-01
        (57204, 36),  # 2015-07-01
        (57754, 37),  # 2017-01-01
    ],
    dtype=np.float64,
)


def tai_minus_utc(mjd_utc: np.ndarray) -> np.ndarray:
    """TAI-UTC in seconds at the given UTC MJD(s)."""
    idx = np.searchsorted(_LEAP_TABLE[:, 0], np.atleast_1d(mjd_utc), side="right") - 1
    idx = np.clip(idx, 0, len(_LEAP_TABLE) - 1)
    return _LEAP_TABLE[idx, 1]


@dataclass
class MJDEpoch:
    """Vector of epochs: integer day + two-double fractional day.

    frac = frac_hi + frac_lo in [0, 1); all fields are numpy arrays.
    """

    day: np.ndarray  # int64
    frac_hi: np.ndarray  # float64
    frac_lo: np.ndarray  # float64

    @classmethod
    def from_mjd_float(cls, mjd) -> "MJDEpoch":
        mjd = np.atleast_1d(np.asarray(mjd, np.float64))
        day = np.floor(mjd)
        return cls(day.astype(np.int64), mjd - day, np.zeros_like(mjd))

    def mjd_float(self) -> np.ndarray:
        return self.day + (self.frac_hi + self.frac_lo)

    def add_seconds(self, secs: np.ndarray) -> "MJDEpoch":
        """Shift by (possibly per-element) float64 seconds, renormalizing."""
        d = np.asarray(secs, np.float64) / SECS_PER_DAY
        hi, lo = _two_sum_np(self.frac_hi, d)
        lo = lo + self.frac_lo
        day = self.day.copy()
        carry = np.floor(hi)
        day = day + carry.astype(np.int64)
        hi = hi - carry
        hi2, lo2 = _two_sum_np(hi, lo)
        carry2 = np.floor(hi2)
        day = day + carry2.astype(np.int64)
        return MJDEpoch(day, hi2 - carry2, lo2)

    def seconds_since(self, day0: int, frac0_hi: float = 0.0, frac0_lo: float = 0.0):
        """Exact (hi, lo) float64 seconds since a reference (day0, frac0).

        Differences of nearby epochs are the precision-critical quantity; the
        subtraction happens day-int minus day-int and frac-dd minus frac-dd,
        so no catastrophic cancellation occurs.
        """
        ddays = (self.day - np.int64(day0)).astype(np.float64)
        fhi, flo = _two_sum_np(self.frac_hi, -np.float64(frac0_hi))
        flo = flo + self.frac_lo - np.float64(frac0_lo)
        # seconds = (ddays + fhi + flo) * 86400, via exact products
        s1_hi, s1_lo = _two_prod_np(ddays, SECS_PER_DAY)
        s2_hi, s2_lo = _two_prod_np(fhi, SECS_PER_DAY)
        hi, lo = _two_sum_np(s1_hi, s2_hi)
        lo = lo + s1_lo + s2_lo + flo * SECS_PER_DAY
        hi2, lo2 = _two_sum_np(hi, lo)
        return hi2, lo2

    def __len__(self) -> int:
        return len(self.day)


def _two_sum_np(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod_np(a, b):
    p = a * b
    split = 134217729.0
    ta = split * a
    ahi = ta - (ta - a)
    alo = a - ahi
    tb = split * b
    bhi = tb - (tb - b)
    blo = b - bhi
    return p, ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo


# --- UTC -> TT ------------------------------------------------------------------


def pulsar_mjd_utc_to_tt(epoch: MJDEpoch) -> MJDEpoch:
    """UTC (pulsar_mjd convention: uniform 86400-s days) -> TT.

    TT = UTC + (TAI-UTC) + 32.184. Within a leap-second day the pulsar_mjd
    convention smears the extra second (reference pulsar_mjd.py:84-111
    rationale); for real TOAs (never taken *during* a leap second) this agrees
    with proper UTC to < the clock noise.
    """
    dt = tai_minus_utc(epoch.mjd_float()) + TT_MINUS_TAI
    return epoch.add_seconds(dt)


# --- TT -> TDB ------------------------------------------------------------------

# Truncated Fairhead & Bretagnon series (USNO Circular 179, eq 2.6):
# TDB-TT [s] = sum A * sin(B*T + C), T in Julian centuries TT since J2000,
# plus a secular mixed term. Amplitudes in seconds, B in rad/century, C rad.
_TDB_TERMS = np.array(
    [
        (0.001657, 628.3076, 6.2401),
        (0.000022, 575.3385, 4.2970),
        (0.000014, 1256.6152, 6.1969),
        (0.000005, 606.9777, 4.0212),
        (0.000005, 52.9691, 0.4444),
        (0.000002, 21.3299, 5.5431),
    ]
)
_TDB_T_TERM = (0.000010, 628.3076, 4.2490)  # A*T*sin(B*T+C)


def tdb_minus_tt(tt_jcent: np.ndarray) -> np.ndarray:
    """TDB - TT in seconds at the geocenter; tt_jcent: TT Julian centuries
    since J2000.0. The site-dependent term is `topocentric_tdb_correction`."""
    t = np.asarray(tt_jcent, np.float64)
    out = np.zeros_like(t)
    for a, b, c in _TDB_TERMS:
        out = out + a * np.sin(b * t + c)
    a, b, c = _TDB_T_TERM
    out = out + a * t * np.sin(b * t + c)
    return out


def topocentric_tdb_correction(ssb_obs_vel_m_s: np.ndarray,
                               geo_obs_pos_m: np.ndarray) -> np.ndarray:
    """Location-dependent part of TDB-TT: v_geo . r_topo / c^2 (seconds).

    ssb_obs_vel_m_s: (N,3) barycentric velocity of the geocenter, m/s.
    geo_obs_pos_m: (N,3) geocentric observatory position (GCRS), m.
    Amplitude ~2 us * sin(diurnal); keeps the ns-level diurnal signature.
    """
    c = 299792458.0
    return np.sum(ssb_obs_vel_m_s * geo_obs_pos_m, axis=-1) / c**2


def tt_to_tdb(epoch_tt: MJDEpoch, topo_s: np.ndarray | float = 0.0) -> MJDEpoch:
    t = (epoch_tt.mjd_float() - MJD_J2000) / 36525.0
    return epoch_tt.add_seconds(tdb_minus_tt(t) + topo_s)


def mjd_tt_julian_centuries(epoch: MJDEpoch) -> np.ndarray:
    return (epoch.mjd_float() - MJD_J2000) / 36525.0

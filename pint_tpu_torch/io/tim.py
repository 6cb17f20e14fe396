"""Exact MJD string splitting (the part of ``pint_tpu/io/tim.py`` that the
parameter parser needs; .tim parsing itself arrives with the port's TOA
prepare, ROADMAP A18)."""

from __future__ import annotations

from fractions import Fraction

__all__ = ["mjd_string_to_day_frac"]


def mjd_string_to_day_frac(s: str) -> tuple[int, float, float]:
    """Exactly split a decimal MJD string into (day:int, frac_hi, frac_lo),
    frac_hi + frac_lo equal to the printed fractional day to < 1e-32 days."""
    s = s.strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    if "." in s:
        ip, fp = s.split(".", 1)
    else:
        ip, fp = s, ""
    day = int(ip) if ip else 0
    frac = Fraction(int(fp or 0), 10 ** len(fp)) if fp else Fraction(0)
    if neg:
        # represent -x.y as day=-(x+1), frac = 1-y to keep frac in [0,1)
        if frac:
            day = -(day + 1)
            frac = 1 - frac
        else:
            day = -day
    hi = float(frac)
    lo = float(frac - Fraction(hi))
    return day, hi, lo

""".tim parsing and writing (counterpart of ``pint_tpu/io/tim.py``).

The four line formats pint_tpu reads (Tempo2 "FORMAT 1", Princeton,
Parkes and ITOA) and the in-file command language (INCLUDE, TIME, PHASE,
SKIP/NOSKIP, EFAC/EQUAD, EMIN/EMAX, FMIN/FMAX, JUMP pairs, MODE, END,
FORMAT), with pint_tpu's semantics line for line: a line that parses as
no format is logged and skipped.

The MJD column is split exactly into (integer day, fractional day as a
two-float64 pair) with Fraction arithmetic, so a .tim file's printed digits
survive to the femtosecond.
"""

from __future__ import annotations

import logging
import os
import sys
from dataclasses import dataclass, field
from fractions import Fraction

log = logging.getLogger("pint_tpu_torch.tim")

__all__ = ["TOALine", "TimFile", "parse_tim", "write_tim", "mjd_string_to_day_frac"]


def mjd_string_to_day_frac(s: str) -> tuple[int, float, float]:
    """Exactly split a decimal MJD string into (day:int, frac_hi, frac_lo).

    frac_hi + frac_lo equals the printed fractional day to < 1e-32 days; the
    split is the host-side analogue of the reference's str_to_mjds
    (pulsar_mjd.py:486) without longdouble.
    """
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


def day_frac_to_mjd_string(day: int, hi: float, lo: float, ndigits: int = 16) -> str:
    frac = Fraction(hi) + Fraction(lo)
    total = Fraction(day) + frac
    sign = "-" if total < 0 else ""
    total = abs(total)
    ip = int(total)
    fp = total - ip
    digits = int(fp * 10**ndigits + Fraction(1, 2))
    return f"{sign}{ip}.{digits:0{ndigits}d}"


@dataclass
class TOALine:
    """One parsed TOA."""

    name: str
    freq_mhz: float
    mjd_day: int
    mjd_frac_hi: float
    mjd_frac_lo: float
    error_us: float
    obs: str
    flags: dict[str, str] = field(default_factory=dict)
    format: str = "Tempo2"


@dataclass
class TimFile:
    toas: list[TOALine] = field(default_factory=list)
    commands: list[tuple[str, str]] = field(default_factory=list)


_OBS_1CHAR = {
    # tempo single-character site codes (public TEMPO convention)
    "1": "gbt",
    "2": "atca",
    "3": "ao",
    "4": "hobart",
    "5": "nanshan",
    "6": "tid43",
    "7": "pks",
    "8": "jb",
    "9": "vla",
    "a": "gb140",
    "b": "gb853",
    "c": "vla",
    "e": "most",
    "f": "ncy",
    "g": "eff",
    "i": "wsrt",
    "j": "mkiii",
    "k": "tabley",
    "l": "darnhall",
    "m": "knockin",
    "n": "defford",
    "q": "jbdfb",
    "r": "jbroach",
    "s": "srt",
    "t": "lofar",
    "w": "chime",
    "x": "lwa1",
    "y": "lwa1",
    "z": "fast",
    "@": "barycenter",
    "0": "geocenter",
}


def _looks_like_tempo2(line: str) -> bool:
    """Tempo2 lines: free-format 'name freq mjd err site [flags]'."""
    parts = line.split()
    if len(parts) < 5:
        return False
    try:
        float(parts[1])
        float(parts[2])
        float(parts[3])
    except ValueError:
        return False
    return "." in parts[2]


def _parse_tempo2_line(line: str) -> TOALine:
    parts = line.split()
    name, freq, mjd, err, site = parts[:5]
    day, hi, lo = mjd_string_to_day_frac(mjd)
    flags: dict[str, str] = {}
    i = 5
    while i < len(parts):
        tok = parts[i]
        if tok.startswith("-") and not _is_number(tok):
            key = tok.lstrip("-")
            if i + 1 < len(parts):
                flags[key] = parts[i + 1]
                i += 2
            else:
                flags[key] = ""
                i += 1
        else:
            i += 1  # stray token; reference warns and skips
    return TOALine(name, float(freq), day, hi, lo, float(err), site.lower(), flags, "Tempo2")


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _parse_princeton_line(line: str) -> TOALine:
    """Princeton fixed-column format (reference toa.py:458 comments):
    col 0 obs code, 1-13 name, 15-24 freq, 24-44 MJD, 44-53 error,
    68-78 DM correction."""
    obs = _OBS_1CHAR.get(line[0].lower(), line[0])
    name = line[1:14].strip()
    freq = float(line[15:24].strip() or 0.0)
    mjd_s = line[24:44].strip()
    day, hi, lo = mjd_string_to_day_frac(mjd_s)
    err = float(line[44:53].strip() or 0.0)
    flags = {}
    dmc = line[68:78].strip() if len(line) > 68 else ""
    if dmc:
        flags["ddm"] = dmc
    return TOALine(name or "unk", freq, day, hi, lo, err, obs, flags, "Princeton")


def _parse_parkes_line(line: str) -> TOALine:
    """Parkes format: blank col 0, name 1-13, freq 25-34, MJD 34-55,
    phase offset 55-63, error 63-71, obs code col 79."""
    name = line[1:13].strip()
    freq = float(line[25:34].strip() or 0.0)
    day, hi, lo = mjd_string_to_day_frac(line[34:55].strip())
    err = float(line[63:71].strip() or 0.0)
    obs = _OBS_1CHAR.get(line[79].lower(), line[79]) if len(line) > 79 else "unk"
    flags = {}
    ph = line[55:63].strip()
    if ph:
        flags["padd"] = ph
    return TOALine(name or "unk", freq, day, hi, lo, err, obs, flags, "Parkes")


def _parse_itoa_line(line: str) -> TOALine:
    """ITOA: name 0-9, MJD 9-28, error 28-34, freq 34-45, DM corr 45-55,
    obs 57-59."""
    name = line[0:9].strip()
    day, hi, lo = mjd_string_to_day_frac(line[9:28].strip())
    err = float(line[28:34].strip() or 0.0)
    freq = float(line[34:45].strip() or 0.0)
    obs = line[57:59].strip().lower() or "unk"
    return TOALine(name or "unk", freq, day, hi, lo, err, obs, {}, "ITOA")


_COMMANDS = {
    "FORMAT",
    "INCLUDE",
    "TIME",
    "PHASE",
    "SKIP",
    "NOSKIP",
    "END",
    "EFAC",
    "EQUAD",
    "EMIN",
    "EMAX",
    "FMIN",
    "FMAX",
    "INFO",
    "MODE",
    "TRACK",
    "JUMP",
    "NICE",
}


def parse_tim(path: str, _depth: int = 0) -> TimFile:
    """Read a tim file, following INCLUDEs, applying command semantics."""
    if _depth > 10:
        raise RuntimeError(f"INCLUDE recursion too deep at {path}")
    tf = TimFile()
    _read_into(tf, path, _depth, _State())
    return tf


@dataclass
class _State:
    fmt: str = "auto"  # auto-sniff unless FORMAT 1
    skipping: bool = False
    time_offset_s: float = 0.0
    phase_offset: float = 0.0
    efac: float = 1.0
    equad_us: float = 0.0
    emin_us: float = 0.0
    emax_us: float = 0.0
    ended: bool = False
    fmin: float = 0.0
    fmax: float = float("inf")
    jump_depth: int = 0
    jump_count: int = 0
    info: str = ""


def _read_into(tf: TimFile, path: str, depth: int, st: _State) -> None:
    dirname = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            stripped = line.strip()
            if not stripped or stripped.startswith(("#", "C ", "CC ")):
                continue
            parts = stripped.split()
            key = parts[0].upper()
            if key in _COMMANDS:
                tf.commands.append((key, " ".join(parts[1:])))
                if key == "FORMAT":
                    st.fmt = "Tempo2" if parts[1:] and parts[1] == "1" else "auto"
                elif key == "INCLUDE":
                    inc = parts[1]
                    if not os.path.isabs(inc):
                        inc = os.path.join(dirname, inc)
                    # FORMAT does not leak into or out of includes
                    # (reference toa.py:784-796); END inside an include
                    # terminates the whole read (toa.py:759-761)
                    saved_fmt = st.fmt
                    st.fmt = "auto"
                    _read_into(tf, inc, depth + 1, st)
                    st.fmt = saved_fmt
                    if st.ended:
                        return
                elif key == "TIME":
                    st.time_offset_s += float(parts[1]) if len(parts) > 1 else 0.0
                elif key == "PHASE":
                    st.phase_offset += float(parts[1]) if len(parts) > 1 else 0.0
                elif key == "SKIP":
                    st.skipping = True
                elif key == "NOSKIP":
                    st.skipping = False
                elif key == "END":
                    st.ended = True
                    return
                elif key == "EFAC":
                    st.efac = float(parts[1]) if len(parts) > 1 else 1.0
                elif key == "EQUAD":
                    st.equad_us = float(parts[1]) if len(parts) > 1 else 0.0
                elif key == "EMIN":
                    st.emin_us = float(parts[1]) if len(parts) > 1 else 0.0
                elif key == "EMAX":
                    st.emax_us = float(parts[1]) if len(parts) > 1 else 0.0
                elif key == "FMIN":
                    st.fmin = float(parts[1]) if len(parts) > 1 else 0.0
                elif key == "FMAX":
                    st.fmax = float(parts[1]) if len(parts) > 1 else float("inf")
                elif key == "INFO":
                    st.info = parts[1] if len(parts) > 1 else ""
                elif key == "MODE":
                    pass  # error-weighting mode; fitters handle weights
                elif key == "JUMP":
                    if st.jump_depth == 0:
                        st.jump_depth = 1
                        st.jump_count += 1
                    else:
                        st.jump_depth = 0
                continue
            if st.skipping:
                continue
            try:
                toa = _parse_data_line(stripped, line, st.fmt)
            except (ValueError, IndexError):
                toa = None
            if toa is None:
                log.warning(
                    f"skipping unparseable TOA line in {path}: {stripped[:60]!r}"
                )
                continue
            # command side effects (reference toa.py:529-546)
            if st.time_offset_s:
                _apply_time_offset(toa, st.time_offset_s)
            if st.phase_offset:
                toa.flags["padd"] = repr(
                    float(toa.flags.get("padd", 0.0)) + st.phase_offset
                )
            if st.efac != 1.0 or st.equad_us != 0.0:
                # reference order (toa.py:824-825): scale by EFAC first,
                # then add EQUAD in quadrature
                toa.error_us = ((st.efac * toa.error_us) ** 2 + st.equad_us**2) ** 0.5
            if st.emin_us and toa.error_us < st.emin_us:
                continue
            if st.emax_us and toa.error_us > st.emax_us:
                continue
            if not (st.fmin <= toa.freq_mhz <= st.fmax) and toa.freq_mhz != 0.0:
                continue
            if st.jump_depth:
                toa.flags.setdefault("tim_jump", str(st.jump_count))
            if st.info:
                toa.flags.setdefault("info", st.info)
            tf.toas.append(toa)


def _apply_time_offset(toa: TOALine, offset_s: float) -> None:
    frac = Fraction(toa.mjd_frac_hi) + Fraction(toa.mjd_frac_lo) + Fraction(offset_s) / 86400
    day = toa.mjd_day
    while frac >= 1:
        frac -= 1
        day += 1
    while frac < 0:
        frac += 1
        day -= 1
    hi = float(frac)
    toa.mjd_day = day
    toa.mjd_frac_hi = hi
    toa.mjd_frac_lo = float(frac - Fraction(hi))


def _parse_data_line(stripped: str, line: str, fmt: str) -> TOALine | None:
    if fmt == "Tempo2" or _looks_like_tempo2(stripped):
        return _parse_tempo2_line(stripped)
    # fixed-column formats need the untrimmed line
    if len(line) >= 80 and line[79] != " " and line[0] == " ":
        try:
            return _parse_parkes_line(line)
        except (ValueError, IndexError):
            pass
    if line[0:1].lower() in _OBS_1CHAR or (line[0:1].isdigit() and "." in line[24:44]):
        try:
            return _parse_princeton_line(line)
        except (ValueError, IndexError):
            pass
    try:
        return _parse_itoa_line(line)
    except (ValueError, IndexError):
        return None


def write_tim(toas: list[TOALine], path: str) -> None:
    """Write Tempo2-format tim file (reference format_toa_line toa.py:549),
    provenance-stamped with ``C`` comment lines every tim parser skips."""
    from datetime import datetime, timezone

    import pint_tpu_torch

    cmd = " ".join(sys.argv) if sys.argv and sys.argv[0] else "(interactive)"
    stamp = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S+00:00")
    with open(path, "w") as f:
        f.write("FORMAT 1\n")
        for line in (f"Created: {stamp}", f"pint_tpu_torch_version: {pint_tpu_torch.__version__}",
                     f"Command: {cmd}", "Format: tim"):
            f.write(f"C {line}\n")
        for t in toas:
            mjd = day_frac_to_mjd_string(t.mjd_day, t.mjd_frac_hi, t.mjd_frac_lo)
            flags = " ".join(f"-{k} {v}" for k, v in sorted(t.flags.items()))
            f.write(
                f"{t.name} {t.freq_mhz:.6f} {mjd} {t.error_us:.3f} {t.obs} {flags}".rstrip()
                + "\n"
            )

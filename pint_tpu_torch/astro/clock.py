"""Observatory clock-correction chains (counterpart of
``pint_tpu/astro/clock.py``): TEMPO (``time.dat``) and TEMPO2 (``.clk``)
clock files evaluated as piecewise-linear tables, with pint_tpu's discovery
order and its degraded mode.

Discovery: ``PINT_CLOCK_OVERRIDE`` (a directory of clock files), then
``$TEMPO2/clock`` and ``$TEMPO/clock``. With no file for a site the corrections are zero and a
warning is logged, as in pint_tpu.

pint_tpu also searches its global clock-corrections repository cache
(``astro/global_clock.py``, synced from ``PINT_TPU_CLOCK_REPO``). The port
has no such repository yet (ROADMAP A17): when one is configured, or its
cache directory exists, `get_clock_chain` raises NotImplementedError rather
than answer with other corrections than pint_tpu would.

The chain for a topocentric TOA: site clock -> UTC(GPS) -> UTC, and
optionally TAI -> TT(BIPMyyyy).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

log = logging.getLogger("pint_tpu_torch.clock")

_warned: set[tuple[str, str]] = set()


def _warn_once(kind: str, name: str, msg: str) -> None:
    if (kind, name) not in _warned:
        _warned.add((kind, name))
        log.warning(msg)


@dataclass
class ClockFile:
    """Piecewise-linear clock correction table: MJD -> seconds to ADD."""

    mjd: np.ndarray
    corr_s: np.ndarray
    name: str = ""

    def evaluate(self, mjd: np.ndarray) -> np.ndarray:
        mjd = np.asarray(mjd, np.float64)
        if len(self.mjd) == 0:
            return np.zeros_like(mjd)
        late = mjd > self.mjd[-1] + 1e-9
        if np.any(late):  # the last entry holds beyond the table, with a warning
            _warn_once("clock.beyond_table", self.name or "clock",
                       f"clock file {self.name}: {late.sum()} TOAs beyond last entry MJD "
                       f"{self.mjd[-1]:.1f}")
        return np.interp(mjd, self.mjd, self.corr_s)

    @classmethod
    def read_tempo2(cls, path: str) -> "ClockFile":
        """TEMPO2 .clk: header line '<from> <to> <flags>', then 'mjd corr' rows."""
        mjds, corrs = [], []
        with open(path) as f:
            f.readline()
            for line in f:
                line = line.split("#")[0].strip()
                if not line:
                    continue
                parts = line.split()
                try:
                    m, c = float(parts[0]), float(parts[1])
                except (ValueError, IndexError):
                    continue
                mjds.append(m)
                corrs.append(c)
        return cls(np.asarray(mjds), np.asarray(corrs), name=os.path.basename(path))

    @classmethod
    def read_tempo(cls, path: str, site: str | None = None) -> "ClockFile":
        """TEMPO time.dat: 'mjd offset(us) ... site-code' rows; with `site`,
        only the rows of that station code."""
        mjds, corrs = [], []
        with open(path) as f:
            for line in f:
                if line.startswith(("#", "C ", "*")) or not line.strip():
                    continue
                parts = line.split()
                try:
                    m = float(parts[0])
                    c = float(parts[1]) * 1e-6
                except (ValueError, IndexError):
                    continue
                code = parts[-1] if len(parts) > 2 and not _isfloat(parts[-1]) else None
                if site and code and code.lower() != site.lower():
                    continue
                mjds.append(m)
                corrs.append(c)
        return cls(np.asarray(mjds), np.asarray(corrs), name=os.path.basename(path))


def _isfloat(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _find_first(alternatives: list[str], obs_name: str) -> ClockFile | None:
    for d in _candidate_dirs():
        for fname in alternatives:
            p = os.path.join(d, fname)
            if os.path.exists(p):
                try:
                    if p.endswith(".clk"):
                        return ClockFile.read_tempo2(p)
                    return ClockFile.read_tempo(p, site=obs_name)
                except (OSError, ValueError, UnicodeDecodeError) as e:
                    log.warning(f"failed to read clock file {p}: {e}")
    return None


@dataclass
class ClockChain:
    """Resolved chain of clock files for one observatory."""

    files: list[ClockFile] = field(default_factory=list)

    def evaluate(self, mjd: np.ndarray) -> np.ndarray:
        out = np.zeros_like(np.asarray(mjd, np.float64))
        for cf in self.files:
            out = out + cf.evaluate(mjd)
        return out


def _global_clock_cache() -> Path:
    """pint_tpu's clock-repository cache directory (its utils/cache.py root)."""
    root = os.environ.get("PINT_TPU_CACHE_DIR") or os.path.expanduser("~/.cache/pint_tpu")
    return Path(root) / "clock_corrections"


def _candidate_dirs() -> list[str]:
    if os.environ.get("PINT_TPU_CLOCK_REPO") or _global_clock_cache().is_dir():
        raise NotImplementedError(
            "the global clock-corrections repository (PINT_TPU_CLOCK_REPO, or its cache "
            f"{_global_clock_cache()}) is not ported yet: ROADMAP A17")
    dirs = []
    override = os.environ.get("PINT_CLOCK_OVERRIDE")
    if override:
        dirs.append(override)
    for env in ("TEMPO2", "TEMPO"):
        base = os.environ.get(env)
        if base:
            dirs.append(os.path.join(base, "clock"))
    return [d for d in dirs if os.path.isdir(d)]


def get_clock_chain(obs_name: str, include_gps: bool = True, include_bipm: bool = False,
                    bipm_version: str = "BIPM2019") -> ClockChain:
    """The correction chain of a site from the discovered files. Each role
    is filled by the FIRST file found across the directories; a role's
    alternatives are two storage formats of one correction."""
    chain = ClockChain()
    roles: list[list[str]] = [[f"{obs_name}2gps.clk", f"time_{obs_name}.dat", "time.dat"]]
    if include_gps:
        roles.append(["gps2utc.clk"])
    if include_bipm:
        roles.append([f"tai2tt_{bipm_version.lower()}.clk"])
    found = False
    for role in roles:
        cf = _find_first(role, obs_name)
        if cf is not None:
            chain.files.append(cf)
            if role is roles[0]:
                found = True
    if not found:
        _warn_once("clock.zero_corrections", obs_name,
                   f"no clock files found for {obs_name!r} (searched "
                   f"{_candidate_dirs() or 'nothing'}); using zero clock corrections")
    return chain

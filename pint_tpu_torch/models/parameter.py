"""Parameter declarations and exact parfile value conversion (the subset of
``pint_tpu/models/parameter.py`` that the ported components use).

A `ParamSpec` is a static declaration owned by a component class; values
live in a flat ``{name: tensor | DD}`` dict of float64 tensors on the
model's device. Precision-critical values (spin frequencies, epochs) parse
EXACTLY from their decimal strings into (hi, lo) pairs.

Internal units: epochs are DD seconds since ``TENSOR_EPOCH_MJD`` (TDB);
F_k in Hz / s^k (F0/F1 as DD); angles in radians; proper motions in rad/s;
parallax in rad; DM_k in pc cm^-3 / s^k.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Callable

import numpy as np

from pint_tpu_torch import SECS_PER_DAY, SECS_PER_JULIAN_YEAR

MAS_TO_RAD = np.pi / (180.0 * 3600.0 * 1000.0)
DEG_TO_RAD = np.pi / 180.0
MAS_PER_YR_TO_RAD_PER_S = MAS_TO_RAD / SECS_PER_JULIAN_YEAR
PER_YEAR_TO_PER_SEC = 1.0 / SECS_PER_JULIAN_YEAR


def normalize_number(s: str) -> str:
    """Accept Fortran 'D' exponents (tempo heritage, e.g. '-1.181D-15')."""
    return s.replace("D", "e").replace("d", "e")


def str_to_dd(s: str, scale: float = 1.0) -> tuple[float, float]:
    """Exact decimal string (x scale) -> (hi, lo) float64 pair, through
    rational arithmetic: hi+lo equals the written value to the last digit."""
    f = Fraction(normalize_number(s)) * Fraction(scale)
    hi = float(f)
    lo = float(f - Fraction(hi))
    return hi, lo


def parse_hms(s: str) -> float:
    """'hh:mm:ss.s...' (hours) -> radians."""
    sgn = -1.0 if s.strip().startswith("-") else 1.0
    parts = s.strip().lstrip("+-").split(":")
    h = float(parts[0])
    m = float(parts[1]) if len(parts) > 1 else 0.0
    sec = float(parts[2]) if len(parts) > 2 else 0.0
    return sgn * (h + m / 60.0 + sec / 3600.0) * (np.pi / 12.0)


def parse_dms(s: str) -> float:
    """'[+-]dd:mm:ss.s...' (degrees) -> radians."""
    sgn = -1.0 if s.strip().startswith("-") else 1.0
    parts = s.strip().lstrip("+-").split(":")
    d = float(parts[0])
    m = float(parts[1]) if len(parts) > 1 else 0.0
    sec = float(parts[2]) if len(parts) > 2 else 0.0
    return sgn * (d + m / 60.0 + sec / 3600.0) * DEG_TO_RAD


# kinds: "float" (f64, scaled), "dd" (exact pair), "epoch" (dd seconds since
# the tensor epoch), "hms"/"dms"/"deg" (angles -> rad), "bool"/"str"/"int"
# (static config)
KINDS = ("float", "dd", "epoch", "hms", "dms", "deg", "bool", "str", "int")


@dataclass
class ParamSpec:
    name: str
    kind: str = "float"
    scale: float = 1.0  # parfile-unit -> internal-unit multiplier (float/dd)
    description: str = ""
    aliases: tuple[str, ...] = ()
    default: object = None
    unit: str = ""
    # tempo-heritage implicit scaling: values with |v| > unit_scale_threshold
    # are multiplied by unit_scale_factor ("PBDOT -4.3" means -4.3e-12)
    unit_scale: bool = False
    unit_scale_factor: float = 1e-12
    unit_scale_threshold: float = 1e-7

    def _heuristic(self, v: float) -> float:
        if self.unit_scale and abs(v) > self.unit_scale_threshold:
            return v * self.unit_scale_factor
        return v

    def parse(self, token: str):
        """Parfile token -> host value: float, or an exact (hi, lo) pair of
        numpy float64 for dd and epoch kinds."""
        if self.kind == "float":
            return self._heuristic(float(normalize_number(token))) * self.scale
        if self.kind == "dd":
            from pint_tpu_torch.ops.dd import device_split

            hi, lo = device_split(*str_to_dd(token, self.scale))
            return np.float64(hi), np.float64(lo)
        if self.kind == "epoch":
            from pint_tpu_torch.models.base import epoch_dd_from_mjd_string

            return epoch_dd_from_mjd_string(token)
        if self.kind == "hms":
            return parse_hms(token)
        if self.kind == "dms":
            return parse_dms(token)
        if self.kind == "deg":
            return float(token) * DEG_TO_RAD
        if self.kind == "bool":
            return token.upper() in ("1", "Y", "YES", "T", "TRUE")
        if self.kind == "int":
            return int(token)
        return token

    def parse_uncertainty(self, token: str) -> float:
        """Parfile uncertainty token -> internal units (always f64)."""
        token = normalize_number(token)
        if self.kind == "float":
            return self._heuristic(float(token)) * self.scale
        if self.kind == "dd":
            return float(token) * self.scale
        if self.kind == "epoch":
            return float(token) * SECS_PER_DAY
        if self.kind == "hms":
            return float(token) * (np.pi / 12.0) / 3600.0
        if self.kind == "dms":
            return float(token) * DEG_TO_RAD / 3600.0
        if self.kind == "deg":
            return float(token) * DEG_TO_RAD
        return float(token)

    @property
    def is_fittable(self) -> bool:
        return self.kind in ("float", "dd", "epoch", "hms", "dms", "deg")

    @property
    def is_dd(self) -> bool:
        return self.kind in ("dd", "epoch")


@dataclass
class FuncParamSpec:
    """A read-only derived parameter: a named function of other parameters
    (pint_tpu's FuncParamSpec; DDS exposes SINI from SHAPMAX, DDGR its
    GR-derived post-Keplerian set). `func` maps the float64 values of
    `inputs`, in internal units and in order, to the derived value in
    internal units. Evaluated on the host by ``TimingModel.get_derived``;
    never a fit parameter."""

    name: str
    inputs: tuple[str, ...]
    func: Callable[..., float]
    description: str = ""
    unit: str = ""

    def value(self, params: dict) -> float:
        from pint_tpu_torch.models.base import leaf_to_f64

        args = [float(leaf_to_f64(params[n])) for n in self.inputs]
        return float(self.func(*args))


@dataclass
class PrefixSpec:
    """A family of numbered parameters (F0..Fn, DM1..); `make` builds the
    concrete spec for index k."""

    prefix: str
    make: Callable[[int], ParamSpec]
    start: int = 0
    aliases: tuple[str, ...] = ()

    def matches(self, name: str) -> int | None:
        for pfx in (self.prefix, *self.aliases):
            if name.startswith(pfx):
                tail = name[len(pfx):]
                if tail.isdigit():
                    return int(tail)
        return None


@dataclass
class MaskClause:
    """The selection clause of a mask parameter (pint_tpu's MaskClause):
    kind "all", "mjd" (TDB MJD range), "freq" (MHz range), "tel"
    (observatory) or "flag" (``-key value``)."""

    kind: str
    key: str = ""  # flag name for kind == "flag"
    args: tuple = ()

    def select(self, toas) -> np.ndarray:
        """Dense boolean mask over a host TOAs object."""
        n = len(toas)
        if self.kind == "all":
            return np.ones(n, bool)
        if self.kind == "mjd":
            lo, hi = float(self.args[0]), float(self.args[1])
            m = toas.tdb.mjd_float()
            return (m >= lo) & (m <= hi)
        if self.kind == "freq":
            lo, hi = float(self.args[0]), float(self.args[1])
            return (toas.freq_mhz >= lo) & (toas.freq_mhz <= hi)
        if self.kind == "tel":
            from pint_tpu_torch.astro.observatories import get_observatory

            return toas.obs == get_observatory(str(self.args[0])).name
        if self.kind == "flag":
            want = str(self.args[0])
            return np.array([f.get(self.key) == want for f in toas.flags], bool)
        raise ValueError(f"unknown mask clause kind {self.kind}")

    def as_parfile_tokens(self) -> list[str]:
        if self.kind == "mjd":
            return ["MJD", str(self.args[0]), str(self.args[1])]
        if self.kind == "freq":
            return ["FREQ", str(self.args[0]), str(self.args[1])]
        if self.kind == "tel":
            return ["TEL", str(self.args[0])]
        if self.kind == "flag":
            return [f"-{self.key}", str(self.args[0])]
        return []


def parse_mask_clause(tokens: list[str]) -> tuple[MaskClause, list[str]]:
    """Split a mask-parameter line (``EFAC -f Rcvr1_2_GUPPI 1.02``, ``JUMP MJD
    57000 57100 0.1``, ``JUMP FREQ 1000 2000 0.1``, ``JUMP TEL ao 0.1``) into
    its selection clause and the remaining ``value [fit [unc]]`` tokens."""
    if not tokens:
        raise ValueError("empty mask parameter line")
    head = tokens[0].upper()
    if tokens[0].startswith("-"):
        return MaskClause("flag", key=tokens[0][1:], args=(tokens[1],)), tokens[2:]
    if head == "MJD":
        return MaskClause("mjd", args=(float(tokens[1]), float(tokens[2]))), tokens[3:]
    if head == "FREQ":
        return MaskClause("freq", args=(float(tokens[1]), float(tokens[2]))), tokens[3:]
    if head in ("TEL", "T"):
        return MaskClause("tel", args=(tokens[1],)), tokens[2:]
    raise ValueError(f"unrecognized mask selection {tokens[:2]}")


@dataclass
class MaskParamInfo:
    """A numbered mask parameter (EFAC1, EQUAD2, ECORR1, ...): the k-th line
    of its family in parfile order, read by the tensor column
    ``mask_<name>``."""

    name: str
    base: str
    index: int
    clause: MaskClause
    spec: ParamSpec | None = None


@dataclass
class ParamValueMeta:
    """Host-side bookkeeping for one parameter."""

    spec: ParamSpec
    frozen: bool = True
    uncertainty: float | None = None  # internal units
    from_alias: str | None = None

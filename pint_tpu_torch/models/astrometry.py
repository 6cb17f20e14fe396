"""Astrometry: Roemer delay and parallax from the site's SSB position and
the proper-motion-corrected source direction (counterpart of
``AstrometryBase.delay``, ``AstrometryEquatorial`` and
``AstrometryEcliptic`` in ``pint_tpu/models/astrometry.py``).

Positions in light-seconds, ICRS axes:
    n(t)   unit vector SSB->pulsar with linear proper motion in the angles
    roemer = -r . n                      (r = ssb_obs_pos)
    px     = px_rad * (|r|^2 - (r.n)^2) / (2 AU_ls)

Three-term dot products are written out as ((x0 y0 + x1 y1) + x2 y2), the
order the K1 kernel (csrc/resid_tangent.cu) uses, so that kernel and twin
round alike. The ecliptic direction is the equatorial formula in
(ELONG, ELAT) rotated about x by the IERS2010 obliquity (`OBL_RAD`, the
value pint_tpu uses for ECL IERS2010 and IERS2003 alike), with cos and sin
of it from the C library, as XLA's CPU backend evaluates them.
"""

from __future__ import annotations

import math

import torch

from pint_tpu_torch import AU_LS, OBLIQUITY_J2000_ARCSEC
from pint_tpu_torch.models.base import DelayComponent, dt_since_epoch_f64, toa_time_dd
from pint_tpu_torch.models.parameter import MAS_PER_YR_TO_RAD_PER_S, MAS_TO_RAD, ParamSpec
from pint_tpu_torch.ops.dd import dd_to_float
from pint_tpu_torch.ops import libm


# IERS2010/IAU2006 mean obliquity at J2000, and its cosine and sine
OBL_RAD = OBLIQUITY_J2000_ARCSEC * math.pi / (180.0 * 3600.0)
COS_OBL, SIN_OBL = math.cos(OBL_RAD), math.sin(OBL_RAD)


def ecliptic_to_icrs(v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors from ecliptic-of-J2000 to ICRS axes."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x, COS_OBL * y - SIN_OBL * z, SIN_OBL * y + COS_OBL * z], dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (length 3) in a fixed order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def unit_vector(lon: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    cl = libm.cos(lat)
    return torch.stack([cl * libm.cos(lon), cl * libm.sin(lon), libm.sin(lat)], dim=-1)


class AstrometryBase(DelayComponent):
    category = "astrometry"
    register = False

    def dt_posepoch(self, params: dict, tensor: dict) -> torch.Tensor:
        """Seconds since POSEPOCH (PEPOCH when absent), float64."""
        ep = params.get("POSEPOCH", params.get("PEPOCH"))
        if ep is None:
            return dd_to_float(toa_time_dd(tensor))
        return dt_since_epoch_f64(tensor, ep)

    def pulsar_direction(self, params: dict, tensor: dict) -> torch.Tensor:
        """(..., N, 3) ICRS unit vector at each TOA."""
        raise NotImplementedError

    def delay(self, params: dict, tensor: dict, delay_so_far, xp):
        n = tensor["_psr_dir"]
        r = tensor["ssb_obs_pos_ls"]
        rn = dot3(r, n)
        roemer = -rn
        px = params["PX"]
        r2 = dot3(r, r)
        px_delay = 0.5 * px * (r2 - rn * rn) / AU_LS
        return roemer + px_delay


class AstrometryEquatorial(AstrometryBase):
    """RAJ/DECJ/PMRA/PMDEC/PX."""

    register = True

    @classmethod
    def param_specs(cls):
        return [
            ParamSpec("RAJ", kind="hms", unit="H:M:S", description="Right ascension (ICRS)"),
            ParamSpec("DECJ", kind="dms", unit="D:M:S", description="Declination (ICRS)"),
            ParamSpec("PMRA", scale=MAS_PER_YR_TO_RAD_PER_S, unit="mas/yr",
                      description="Proper motion in RA (mu_alpha cos dec)", default=0.0),
            ParamSpec("PMDEC", scale=MAS_PER_YR_TO_RAD_PER_S, unit="mas/yr", default=0.0),
            ParamSpec("PX", scale=MAS_TO_RAD, unit="mas", description="Parallax", default=0.0),
            ParamSpec("POSEPOCH", kind="epoch", unit="MJD"),
        ]

    def validate(self, params, meta):
        for p in ("RAJ", "DECJ"):
            if p not in params:
                raise ValueError(f"AstrometryEquatorial requires {p}")

    def pulsar_direction(self, params: dict, tensor: dict) -> torch.Tensor:
        dt = self.dt_posepoch(params, tensor)
        dec0 = params["DECJ"]
        ra = params["RAJ"] + params["PMRA"] * dt / libm.cos(dec0)
        dec = dec0 + params["PMDEC"] * dt
        return unit_vector(ra, dec)


class AstrometryEcliptic(AstrometryBase):
    """ELONG/ELAT/PMELONG/PMELAT/PX in the IERS2010-obliquity ecliptic frame."""

    register = True

    @classmethod
    def param_specs(cls):
        return [
            ParamSpec("ELONG", kind="deg", unit="deg", aliases=("LAMBDA",)),
            ParamSpec("ELAT", kind="deg", unit="deg", aliases=("BETA",)),
            ParamSpec("PMELONG", scale=MAS_PER_YR_TO_RAD_PER_S, unit="mas/yr",
                      aliases=("PMLAMBDA",), default=0.0),
            ParamSpec("PMELAT", scale=MAS_PER_YR_TO_RAD_PER_S, unit="mas/yr",
                      aliases=("PMBETA",), default=0.0),
            ParamSpec("PX", scale=MAS_TO_RAD, unit="mas", default=0.0),
            ParamSpec("POSEPOCH", kind="epoch", unit="MJD"),
            ParamSpec("ECL", kind="str", unit="", default="IERS2010"),
        ]

    def validate(self, params, meta):
        for p in ("ELONG", "ELAT"):
            if p not in params:
                raise ValueError(f"AstrometryEcliptic requires {p}")
        ecl = meta.get("ECL", "IERS2010")
        if ecl not in ("IERS2010", "IERS2003"):
            raise ValueError(f"unsupported obliquity model ECL {ecl}")

    def pulsar_direction(self, params: dict, tensor: dict) -> torch.Tensor:
        dt = self.dt_posepoch(params, tensor)
        lat0 = params["ELAT"]
        lon = params["ELONG"] + params["PMELONG"] * dt / libm.cos(lat0)
        lat = lat0 + params["PMELAT"] * dt
        return ecliptic_to_icrs(unit_vector(lon, lat))

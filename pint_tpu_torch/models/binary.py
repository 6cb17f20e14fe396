"""PulsarBinary: the binary-orbit delay component (counterpart of
``pint_tpu/models/binary.py``, for ``BINARY`` BT, DD, DDS and ELL1; DDGR,
DDK, ELL1H, ELL1K and the FB orbital-frequency form are ROADMAP A8).

The precision-critical step is the orbital phase: over ~1e4 orbits float64
loses ~1e-10 orbits, right at the ns delay budget. With dt = t - TASC -
delay (double-double) and norb0 = rint(dt/PB), the remainder dt - PB norb0
is formed in double-double and only then collapsed to float64, so the
orbital phase keeps ~1e-15 orbits whatever the time span. PBDOT is a small
correction evaluated in float64. The epoch is T0 for the Kepler-orbit
models and TASC for ELL1. The engine (``binaries/engines.py``) sees
the time t - delay_so_far: the astrometric, solar Shapiro and DM delays
before it in DEFAULT_ORDER.
"""

from __future__ import annotations

import math

import torch

from pint_tpu_torch import SECS_PER_DAY, SECS_PER_JULIAN_YEAR
from pint_tpu_torch.models.base import DelayComponent, leaf_to_f64
from pint_tpu_torch.models.binaries import engines as eng
from pint_tpu_torch.models.parameter import DEG_TO_RAD, ParamSpec

DEG_PER_YEAR_TO_RAD_PER_SEC = DEG_TO_RAD / SECS_PER_JULIAN_YEAR


def _common_specs() -> list[ParamSpec]:
    return [
        ParamSpec("PB", kind="dd", scale=SECS_PER_DAY, unit="day", description="Orbital period"),
        ParamSpec("PBDOT", unit="s/s", default=0.0, unit_scale=True),
        ParamSpec("XPBDOT", unit="s/s", default=0.0, unit_scale=True),
        ParamSpec("A1", unit="ls", description="Projected semi-major axis a sin i / c"),
        ParamSpec("A1DOT", unit="ls/s", default=0.0, unit_scale=True, aliases=("XDOT",)),
        ParamSpec("M2", unit="Msun", default=0.0, description="Companion mass"),
        ParamSpec("SINI", unit="", default=0.0, description="Sine of inclination"),
    ]


def _eccentric_specs() -> list[ParamSpec]:
    return [
        ParamSpec("T0", kind="epoch", unit="MJD", description="Epoch of periastron"),
        ParamSpec("ECC", unit="", default=0.0, aliases=("E",), description="Eccentricity"),
        ParamSpec("EDOT", unit="1/s", default=0.0, unit_scale=True),
        ParamSpec("OM", kind="deg", unit="deg", default=0.0, description="Longitude of periastron"),
        ParamSpec("OMDOT", scale=DEG_PER_YEAR_TO_RAD_PER_SEC, unit="deg/yr", default=0.0,
                  description="Periastron advance"),
        ParamSpec("GAMMA", unit="s", default=0.0, description="Einstein delay amplitude"),
    ]


def _dd_extra_specs() -> list[ParamSpec]:
    return [
        ParamSpec("A0", unit="s", default=0.0, description="Aberration A0"),
        ParamSpec("B0", unit="s", default=0.0, description="Aberration B0"),
        ParamSpec("DR", unit="", default=0.0, description="Relativistic deformation dr"),
        ParamSpec("DTH", unit="", default=0.0, description="Relativistic deformation dth"),
    ]


def _ell1_specs() -> list[ParamSpec]:
    return [
        ParamSpec("TASC", kind="epoch", unit="MJD", description="Epoch of ascending node"),
        ParamSpec("EPS1", unit="", default=0.0, description="ecc * sin(omega) at TASC"),
        ParamSpec("EPS2", unit="", default=0.0, description="ecc * cos(omega) at TASC"),
        ParamSpec("EPS1DOT", unit="1/s", default=0.0, unit_scale=True),
        ParamSpec("EPS2DOT", unit="1/s", default=0.0, unit_scale=True),
    ]


#: the binary models the port evaluates: engine, epoch parameter, extra specs
#: and the common specs a model drops (pint_tpu binary.py BINARY_MODELS)
BINARY_MODELS: dict[str, dict] = {
    "BT": {"engine": eng.bt_delay, "epoch": "T0", "specs": _eccentric_specs},
    "DD": {"engine": eng.dd_delay, "epoch": "T0",
           "specs": lambda: _eccentric_specs() + _dd_extra_specs()},
    "DDS": {"engine": eng.dds_delay, "epoch": "T0",
            "specs": lambda: _eccentric_specs() + _dd_extra_specs() + [
                ParamSpec("SHAPMAX", unit="", default=0.0, description="-ln(1 - sin i)")],
            "drop": ("SINI",)},
    "ELL1": {"engine": eng.ell1_delay, "epoch": "TASC", "specs": _ell1_specs},
}


class PulsarBinary(DelayComponent):
    """Binary orbital delay on the accumulated-delay chain (category
    pulsar_system)."""

    category = "pulsar_system"
    register = True

    def __init__(self, model_name: str = "ELL1"):
        self.model_name = model_name.upper()
        if self.model_name not in BINARY_MODELS:
            raise NotImplementedError(
                f"BINARY {model_name}: pint_tpu_torch evaluates only "
                f"{sorted(BINARY_MODELS)} so far (ROADMAP A8 ports the others)")
        cfg = BINARY_MODELS[self.model_name]
        self.engine = cfg["engine"]
        self.epoch_name = cfg["epoch"]
        drop = set(cfg.get("drop", ()))
        self._spec_list = [s for s in _common_specs() + cfg["specs"]() if s.name not in drop]
        super().__init__()

    def param_specs(self):  # instance-configured; shadows the classmethod
        return self._spec_list

    @property
    def name(self) -> str:
        return f"Binary{self.model_name}"

    def validate(self, params, meta):
        if self.epoch_name not in params:
            raise ValueError(f"BINARY {self.model_name} requires {self.epoch_name}")
        if "PB" not in params:
            raise ValueError(f"BINARY {self.model_name} requires PB")
        checks = {
            "ECC": (lambda v: 0.0 <= v < 1.0, "Eccentricity ECC must be in [0, 1)"),
            "SINI": (lambda v: 0.0 <= v <= 1.0, "SINI must be between zero and one"),
            "A1": (lambda v: v >= 0.0, "Projected semi-major axis A1 cannot be negative"),
            "M2": (lambda v: v >= 0.0, "Companion mass M2 cannot be negative"),
        }
        for pname, (ok, msg) in checks.items():
            v = params.get(pname)
            if v is not None and not ok(float(leaf_to_f64(v))):
                raise ValueError(msg)

    def _orbits(self, params: dict, tensor: dict, delay_so_far, xp):
        """-> (phi rad on the centred branch, norb, dt, pb), all float64.
        rint only picks WHICH orbit boundary to measure from; its tangent
        is zero, as jax's is."""
        t_x = xp.time_from_tensor(tensor)
        dt_x = xp.add_f(xp.sub(t_x, xp.lift(params[self.epoch_name], t_x.hi)), -delay_so_far)
        dt = xp.to_f64(dt_x)
        pb0 = leaf_to_f64(params["PB"])
        norb0 = torch.round(dt / pb0)
        rem_x = xp.sub(dt_x, xp.mul_f(xp.lift(params["PB"], t_x.hi), norb0))
        frac = xp.to_f64(rem_x) / pb0
        u = norb0 + frac
        pbdot_eff = leaf_to_f64(params.get("PBDOT", 0.0)) + leaf_to_f64(
            params.get("XPBDOT", 0.0))
        frac = frac - 0.5 * pbdot_eff * u * u
        pb = pb0 + leaf_to_f64(params.get("PBDOT", 0.0)) * dt
        n2 = torch.round(frac)
        phi = 2.0 * math.pi * (frac - n2)
        return phi, norb0 + n2, dt, pb

    def delay(self, params: dict, tensor: dict, delay_so_far, xp):
        phi, norb, dt, pb = self._orbits(params, tensor, delay_so_far, xp)
        p = {name: leaf_to_f64(params[name]) for name, spec in self.specs.items()
             if name in params and spec.is_fittable}
        return self.engine(p, dt, phi, norb, pb)

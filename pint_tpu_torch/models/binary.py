"""PulsarBinary: the binary-orbit delay component (counterpart of
``pint_tpu/models/binary.py``, for every ``BINARY`` model pint_tpu has: BT,
DD, DDS, DDGR, DDK, ELL1, ELL1H and ELL1K, with PB or the FB
orbital-frequency form).

The precision-critical step is the orbital phase: over ~1e4 orbits float64
loses ~1e-10 orbits, right at the ns delay budget. With dt = t - TASC -
delay (double-double) and norb0 = rint(dt/PB), the remainder dt - PB norb0
is formed in double-double and only then collapsed to float64, so the
orbital phase keeps ~1e-15 orbits whatever the time span. PBDOT is a small
correction evaluated in float64. In the FB form the leading term dt FB0 is
a double-double product, and FB1, FB2, ... a float64 Taylor tail. The
epoch is T0 for the Kepler-orbit models and TASC for the ELL1 family. The
engine (``binaries/engines.py``) sees the time t - delay_so_far: the
astrometric, solar Shapiro and DM delays before it in DEFAULT_ORDER.

DDGR derives its post-Keplerian parameters from (MTOT, M2) inside `delay`,
so GR's PBDOT enters the orbital phase too; DDK replaces A1, OM and SINI by
per-TOA values. Both expose what they derive, and DDS its SINI, as
read-only parameters (`func_param_specs`, ``TimingModel.get_derived``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_tpu_torch import SECS_PER_DAY, SECS_PER_JULIAN_YEAR
from pint_tpu_torch.models.base import DelayComponent, leaf_to_f64
from pint_tpu_torch.models.binaries import engines as eng
from pint_tpu_torch.models.parameter import DEG_TO_RAD, FuncParamSpec, ParamSpec, PrefixSpec
from pint_tpu_torch.ops.dd import DD, dd_mul
from pint_tpu_torch.ops.taylor import taylor_horner, taylor_horner_deriv

DEG_PER_YEAR_TO_RAD_PER_SEC = DEG_TO_RAD / SECS_PER_JULIAN_YEAR


def _fb_spec(k: int) -> ParamSpec:
    return ParamSpec(f"FB{k}", kind="dd" if k == 0 else "float", unit=f"1/s^{k + 1}",
                     description=f"{k}th time derivative of orbital frequency")


class _DDMulTangent(torch.autograd.Function):
    """dd_mul(x, y) (hi, lo) whose tangent is the product rule on the
    collapsed values, (tx_hi + tx_lo)(y_hi + y_lo) + (x_hi + x_lo)(ty_hi +
    ty_lo), on the high word, as kernel K1 forms the FB form's lead
    (resid_tangent.cu ddmul_full): one float64 tangent, exact to rounding,
    where differentiating through Dekker's split (jax's way) leaves rounding
    of its own."""

    generate_vmap_rule = True

    @staticmethod
    def forward(xh, xl, yh, yl):
        r = dd_mul(DD(xh, xl), DD(yh, yl))
        return r.hi, r.lo

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, txh, txl, tyh, tyl):
        xh, xl, yh, yl = ctx.saved_tensors

        def total(a, b):
            if a is None and b is None:
                return torch.zeros_like(xh)
            return b if a is None else a if b is None else a + b

        t = total(txh, txl) * (yh + yl) + (xh + xl) * total(tyh, tyl)
        return t, torch.zeros_like(t)


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


def _eccentric_dd() -> list[ParamSpec]:
    return _eccentric_specs() + _dd_extra_specs()


def _omdot_spec() -> ParamSpec:
    return ParamSpec("OMDOT", scale=DEG_PER_YEAR_TO_RAD_PER_SEC, unit="deg/yr", default=0.0,
                     description="Periastron advance")


#: the binary models: engine, epoch parameter, extra specs, the specs a
#: model drops and what it derives (pint_tpu binary.py BINARY_MODELS)
BINARY_MODELS: dict[str, dict] = {
    "BT": {"engine": eng.bt_delay, "epoch": "T0", "specs": _eccentric_specs},
    "DD": {"engine": eng.dd_delay, "epoch": "T0", "specs": _eccentric_dd},
    "DDS": {"engine": eng.dds_delay, "epoch": "T0",
            "specs": lambda: _eccentric_dd() + [
                ParamSpec("SHAPMAX", unit="", default=0.0, description="-ln(1 - sin i)")],
            "drop": ("SINI",)},
    # every GR-derived post-Keplerian parameter is an output: a par that
    # sets one is refused (make_binary_component)
    "DDGR": {"engine": eng.dd_delay, "epoch": "T0",
             "specs": lambda: _eccentric_dd() + [
                 ParamSpec("MTOT", unit="Msun", description="Total mass"),
                 ParamSpec("XOMDOT", scale=DEG_PER_YEAR_TO_RAD_PER_SEC, unit="deg/yr",
                           default=0.0, description="Excess periastron advance")],
             "drop": eng.DDGR_DERIVED, "derive": "ddgr"},
    "DDK": {"engine": eng.dd_delay, "epoch": "T0",
            "specs": lambda: _eccentric_dd() + [
                ParamSpec("KIN", kind="deg", unit="deg", description="Inclination angle"),
                ParamSpec("KOM", kind="deg", unit="deg", default=0.0,
                          description="Longitude of ascending node")],
            "drop": ("SINI",), "derive": "ddk"},
    "ELL1": {"engine": eng.ell1_delay, "epoch": "TASC", "specs": _ell1_specs},
    "ELL1H": {"engine": eng.ell1h_delay, "epoch": "TASC",
              "specs": lambda: _ell1_specs() + [
                  ParamSpec("H3", unit="s", default=0.0, description="Orthometric Shapiro H3"),
                  ParamSpec("H4", unit="s", description="Orthometric Shapiro H4"),
                  ParamSpec("STIGMA", unit="", aliases=("VARSIGMA",),
                            description="Orthometric ratio"),
                  ParamSpec("NHARMS", kind="int", default=3, unit="")],
              "drop": ("M2", "SINI")},
    "ELL1K": {"engine": eng.ell1k_delay, "epoch": "TASC",
              "specs": lambda: _ell1_specs() + [
                  _omdot_spec(),
                  ParamSpec("LNEDOT", scale=1.0 / SECS_PER_JULIAN_YEAR, unit="1/yr", default=0.0,
                            description="Log-eccentricity derivative")],
              "drop": ("EPS1DOT", "EPS2DOT")},
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
                f"BINARY {model_name} not supported; available: {sorted(BINARY_MODELS)}")
        cfg = BINARY_MODELS[self.model_name]
        self.engine = cfg["engine"]
        self.epoch_name = cfg["epoch"]
        self.derive = cfg.get("derive")
        drop = set(cfg.get("drop", ()))
        self._spec_list = [s for s in _common_specs() + cfg["specs"]() if s.name not in drop]
        super().__init__()
        # ELL1H's static configuration, set by make_binary_component
        self.nharms = 3
        self.h_mode = "h3"

    def param_specs(self):  # instance-configured; shadows the classmethod
        return self._spec_list

    @classmethod
    def prefix_specs(cls):
        return [PrefixSpec("FB", _fb_spec, start=0)]

    @property
    def name(self) -> str:
        return f"Binary{self.model_name}"

    @property
    def fb_terms(self) -> int:
        """Highest FB index + 1 (0 in the PB form)."""
        n = 0
        while f"FB{n}" in self.specs:
            n += 1
        return n

    def func_param_specs(self) -> list:
        """DDS's SINI(SHAPMAX) and DDGR's GR-derived set, read-only (pint_tpu
        PulsarBinary.func_param_specs, the same functions)."""
        if self.model_name == "DDS":
            return [FuncParamSpec("SINI", ("SHAPMAX",), lambda s: 1.0 - np.exp(-s),
                                  description="Sine of inclination (from SHAPMAX)")]
        if self.model_name == "DDGR":
            def derived(key):
                def f(*vals):
                    return eng.ddgr_derived(dict(zip(eng.DDGR_INPUTS, vals)))[key]
                return f

            return [FuncParamSpec(k, eng.DDGR_INPUTS, derived(k),
                                  description=f"GR-derived {k} from (MTOT, M2)")
                    for k in eng.DDGR_DERIVED]
        return []

    def validate(self, params, meta):
        if self.epoch_name not in params:
            raise ValueError(f"BINARY {self.model_name} requires {self.epoch_name}")
        if "PB" not in params and "FB0" not in params:
            raise ValueError(f"BINARY {self.model_name} requires PB or FB0")
        if "PB" in params and "FB0" in params:
            raise ValueError("Model cannot have values for both FB0 and PB")
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
        if self.model_name == "ELL1H" and self.h_mode in ("h4", "stigma"):
            h3 = params.get("H3")
            if h3 is None or float(leaf_to_f64(h3)) == 0.0:
                raise ValueError("To use H4 or STIGMA, H3 must be set and nonzero")
        if self.derive == "ddk" and any(k in params for k in ("ELONG", "PMELONG", "PMELAT")):
            raise NotImplementedError(
                "DDK requires equatorial astrometry (RAJ/DECJ/PMRA/PMDEC)")
        fb = sorted(int(k[2:]) for k in params if k.startswith("FB") and k[2:].isdigit())
        if fb and fb != list(range(len(fb))):
            raise ValueError(f"FB indices must be 0..k without gaps, got {fb}")

    def _orbits(self, params: dict, tensor: dict, delay_so_far, xp):
        """-> (phi rad on the centred branch, norb, dt, pb), all float64.
        rint only picks WHICH orbit boundary to measure from; its tangent
        is zero, as jax's is."""
        t_x = xp.time_from_tensor(tensor)
        dt_x = xp.add_f(xp.sub(t_x, xp.lift(params[self.epoch_name], t_x.hi)), -delay_so_far)
        dt = xp.to_f64(dt_x)
        if "FB0" in params:
            coeffs = [0.0] + [leaf_to_f64(params[f"FB{k}"]) for k in range(self.fb_terms)]
            fb0 = xp.lift(params["FB0"], t_x.hi)
            lead_x = DD(*_DDMulTangent.apply(dt_x.hi, dt_x.lo, fb0.hi, fb0.lo))
            norb0 = torch.round(xp.to_f64(lead_x))
            frac = xp.to_f64(xp.add_f(lead_x, -norb0))
            if self.fb_terms > 1:
                frac = frac + taylor_horner(dt, [0.0, 0.0] + coeffs[2:])
            pb = eng._rdiv(1.0, taylor_horner_deriv(dt, coeffs, 1))
        else:
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
        if self.derive == "ddgr":
            params = {**params, **eng.ddgr_derived(params)}
        phi, norb, dt, pb = self._orbits(params, tensor, delay_so_far, xp)
        p = {name: leaf_to_f64(params[name]) for name, spec in self.specs.items()
             if name in params and spec.is_fittable}
        if self.derive == "ddgr":
            p.update({k: params[k] for k in eng.DDGR_DERIVED})
        elif self.derive == "ddk":
            p.update(eng.ddk_corrections(params, tensor))
        if self.model_name == "ELL1H":
            return self.engine(p, dt, phi, norb, pb, nharms=self.nharms, mode=self.h_mode)
        return self.engine(p, dt, phi, norb, pb)


def make_binary_component(name: str, pf) -> PulsarBinary:
    """The component of a parfile's ``BINARY`` line: DDGR refuses the
    parameters it derives; ELL1H takes NHARMS and its mode from the par (H4:
    at least 7 harmonics; STIGMA: the exact form; H4 with STIGMA refused)."""
    comp = PulsarBinary(name)
    if comp.model_name == "DDGR":
        bad = [k for k in eng.DDGR_DERIVED if k in pf]
        if bad:
            raise ValueError(
                f"BINARY DDGR derives {bad} from (MTOT, M2) under GR; remove "
                "them from the parfile (use XOMDOT/XPBDOT for excesses, or "
                "BINARY DD to set post-Keplerian parameters directly)")
    if comp.model_name == "ELL1H":
        tok = pf.get("NHARMS")
        nharms = int(float(tok)) if tok is not None else 3
        if "H4" in pf and ("STIGMA" in pf or "VARSIGMA" in pf):
            raise ValueError("ELL1H can use H4 or STIGMA but not both")
        if "H4" in pf:
            comp.h_mode = "h4"
            nharms = max(nharms, 7)
        elif "STIGMA" in pf or "VARSIGMA" in pf:
            comp.h_mode = "stigma"
        comp.nharms = nharms
    return comp

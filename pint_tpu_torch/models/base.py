"""Component framework (counterpart of ``pint_tpu/models/base.py``).

`Component` instances are static structure (which parameters exist, how
many Taylor terms); parameter values are a flat dict of float64 tensors
threaded through plain functions; the TOA side is the tensor dict
(``TimingModel.build_tensor`` of prepared TOAs, or a prepared archive) with
the TZR fiducial TOA as its last row.

Delay components return float64 seconds; phase components return DD turns.
Rows are the LAST dimension of every per-TOA tensor, so a parameter dict
whose leaves carry a leading batch dimension of shape (B, 1) evaluates B
parameter sets at once by broadcasting.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch import SECS_PER_DAY, TENSOR_EPOCH_MJD
from pint_tpu_torch.io.tim import mjd_string_to_day_frac
from pint_tpu_torch.models.parameter import MaskParamInfo, ParamSpec, PrefixSpec
from pint_tpu_torch.ops.dd import DD, dd_add_fp, device_split

# Evaluation order of delay categories (pint_tpu DEFAULT_ORDER): each
# component sees the barycentric time implied by the delays before it.
DEFAULT_ORDER = [
    "astrometry",
    "jump_delay",
    "troposphere",
    "solar_system_shapiro",
    "solar_wind",
    "solar_windx",
    "dispersion_constant",
    "dispersion_dmx",
    "dispersion_jump",
    "frequency_dependent",
    "pulsar_system",
    "spindown",
    "glitch",
    "piecewise",
    "ifunc",
    "wave",
    "phase_jump",
    "absolute_phase",
    "phase_offset",
]


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


def epoch_dd_from_mjd_string(s: str) -> tuple[np.float64, np.float64]:
    """Parfile MJD string -> exact (hi, lo) seconds since the tensor epoch
    (the arithmetic of pint_tpu's MJDEpoch.seconds_since)."""
    day, fhi, flo = mjd_string_to_day_frac(s)
    ddays = np.float64(day - TENSOR_EPOCH_MJD)
    fhi, e = _two_sum_np(np.float64(fhi), -np.float64(0.0))
    flo = e + np.float64(flo) - np.float64(0.0)
    s1_hi, s1_lo = _two_prod_np(ddays, SECS_PER_DAY)
    s2_hi, s2_lo = _two_prod_np(fhi, SECS_PER_DAY)
    hi, lo = _two_sum_np(s1_hi, s2_hi)
    lo = lo + s1_lo + s2_lo + flo * SECS_PER_DAY
    hi, lo = _two_sum_np(hi, lo)
    hi, lo = device_split(hi, lo)
    return np.float64(hi), np.float64(lo)


def toa_time_dd(tensor: dict) -> DD:
    """TDB seconds since the tensor epoch for every row, as DD."""
    return DD(tensor["t_hi"], tensor["t_lo"])


def barycentric_time_x(xp, params: dict, tensor: dict, total_delay):
    """t_pulsar-frame = TDB - total_delay in backend precision."""
    return xp.add_f(xp.time_from_tensor(tensor), -total_delay)


def dt_since_epoch_f64(tensor: dict, epoch_leaf) -> torch.Tensor:
    """Seconds since an epoch parameter in plain float64 (delay components
    never need extended precision)."""
    ep = leaf_to_f64(epoch_leaf)
    return (tensor["t_hi"] - ep) + tensor["t_lo"]


def leaf_to_f64(v):
    """Collapse a parameter leaf (DD or plain) to float64."""
    if isinstance(v, DD):
        return v.hi + v.lo
    return torch.as_tensor(v, dtype=torch.float64)


def barycentric_time_dd(params: dict, tensor: dict, total_delay) -> DD:
    """t_pulsar-frame = TDB - total_delay, as DD seconds since the epoch."""
    return dd_add_fp(toa_time_dd(tensor), -total_delay)


class Component:
    """Base class; subclasses with a category register themselves."""

    category: str = ""
    register: bool = True
    component_types: dict[str, type] = {}

    @classmethod
    def param_specs(cls) -> list[ParamSpec]:
        return []

    @classmethod
    def prefix_specs(cls) -> list[PrefixSpec]:
        return []

    @classmethod
    def mask_bases(cls) -> list[ParamSpec]:
        """Specs of repeatable mask-parameter families (EFAC, EQUAD, ...)."""
        return []

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.__dict__.get("register", True) and cls.category:
            Component.component_types[cls.__name__] = cls

    def __init__(self):
        self.specs: dict[str, ParamSpec] = {s.name: s for s in self.param_specs()}
        self.mask_params: list[MaskParamInfo] = []

    @property
    def name(self) -> str:
        return type(self).__name__

    def add_prefix_param(self, spec: ParamSpec) -> None:
        self.specs[spec.name] = spec

    def func_param_specs(self) -> list:
        """The read-only derived parameters this component exposes
        (``parameter.FuncParamSpec``)."""
        return []

    def validate(self, params: dict, meta: dict) -> None:
        """Raise on inconsistent configuration."""

    def host_columns(self, toas, params: dict) -> dict[str, np.ndarray]:
        """Per-TOA host arrays this component needs in the tensor: one
        ``mask_<name>`` column per mask parameter."""
        return {f"mask_{mp.name}": mp.clause.select(toas).astype(np.float64)
                for mp in self.mask_params}

    def delay(self, params: dict, tensor: dict, delay_so_far, xp):
        """Additional delay in seconds (float64) given the accumulated delay."""
        raise NotImplementedError

    def phase(self, params: dict, tensor: dict, total_delay, xp):
        """Additional phase in turns, in the xp extended-precision backend."""
        raise NotImplementedError


class DelayComponent(Component):
    register = False


class PhaseComponent(Component):
    register = False

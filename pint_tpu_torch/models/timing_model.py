"""TimingModel: ordered component chain -> phase and spin frequency
(counterpart of ``pint_tpu/models/timing_model.py``, restricted to the
components of this slice).

``phase_and_freq(params, tensor)`` is the plain-torch forward pass: delays
accumulated in DEFAULT_ORDER, phase summed over the phase components in
double-double, then the TZR fiducial row (the tensor's last) subtracted.
It is the twin of the fused forward of kernel K1 (``residuals.resid_tangent``),
which computes the same chain per TOA on the card.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.base import DEFAULT_ORDER, Component
from pint_tpu_torch.models.parameter import ParamValueMeta
from pint_tpu_torch.ops.xprec import DD64

# params that configure host-side tensor construction and cannot be fitted
UNFITTABLE = {"TZRMJD", "TZRSITE", "TZRFRQ", "PLANET_SHAPIRO"}


class TimingModel:
    def __init__(self, components: list[Component], meta: dict | None = None,
                 device: torch.device | None = None):
        order = {cat: i for i, cat in enumerate(DEFAULT_ORDER)}
        self.components = sorted(components, key=lambda c: order.get(c.category, 99))
        self.meta: dict = meta or {}
        self.params: dict = {}
        self.param_meta: dict[str, ParamValueMeta] = {}
        self.device = device
        self.xprec = DD64

    def __getitem__(self, name: str) -> Component:
        for c in self.components:
            if c.name == name:
                return c
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(c.name == name for c in self.components)

    @property
    def component_names(self) -> list[str]:
        return [c.name for c in self.components]

    @property
    def delay_components(self) -> list[Component]:
        return [c for c in self.components if _overrides(c, "delay")]

    @property
    def phase_components(self) -> list[Component]:
        return [c for c in self.components if _overrides(c, "phase")]

    @property
    def astrometry(self) -> Component | None:
        for c in self.components:
            if c.category == "astrometry":
                return c
        return None

    @property
    def has_abs_phase(self) -> bool:
        return any(c.category == "absolute_phase" for c in self.components)

    @property
    def has_phase_offset(self) -> bool:
        return False  # PhaseOffset (PHOFF) is not ported yet (ROADMAP A9)

    @property
    def free_params(self) -> list[str]:
        return [n for n, m in self.param_meta.items() if not m.frozen]

    def set_free(self, names: list[str]) -> None:
        for n in names:
            if n not in self.param_meta:
                raise KeyError(f"unknown parameter {n}")
            if n in UNFITTABLE:
                raise ValueError(f"{n} configures tensor construction; cannot fit")
        for n, m in self.param_meta.items():
            m.frozen = n not in names

    def validate(self) -> None:
        for c in self.components:
            c.validate(self.params, self.meta)

    # --- the forward pass (plain torch) -------------------------------------------

    def phase_and_freq(self, params: dict, tensor: dict, xp=None):
        """(phase DD turns, spin frequency Hz) sharing one delay chain; with
        AbsPhase the fiducial (last) row is subtracted and dropped."""
        xp = xp or self.xprec
        tensor = self._with_context(params, tensor)
        total_delay = torch.zeros_like(tensor["t_hi"])
        for c in self.delay_components:
            total_delay = total_delay + c.delay(params, tensor, total_delay, xp)
        ph = xp.zeros_like(tensor["t_hi"])
        for c in self.phase_components:
            ph = xp.add(ph, c.phase(params, tensor, total_delay, xp))
        if "Spindown" in self:
            f = self["Spindown"].spin_frequency(params, tensor, total_delay, xp)
        else:
            f = torch.ones_like(tensor["t_hi"])
        if self.has_abs_phase:
            tzr_phase = xp.index(ph, slice(-1, None))
            ph = xp.index(ph, slice(None, -1))
            ph = xp.add(ph, xp.neg(tzr_phase))
            f = f[..., :-1]
        return ph, f

    def _with_context(self, params: dict, tensor: dict) -> dict:
        ast = self.astrometry
        if ast is not None:
            tensor = dict(tensor)
            tensor["_psr_dir"] = ast.pulsar_direction(params, tensor)
        return tensor


def _overrides(c: Component, method: str) -> bool:
    return getattr(type(c), method, None) is not getattr(Component, method, None)

"""Solar-system Shapiro delay (counterpart of
``pint_tpu/models/solar_system_shapiro.py``): for the Sun, with
T = GM/c^3,

    delay = -2 T ln( (r - r.n) / AU )

r the observatory->Sun vector (light-seconds), n the pulsar direction.
The planetary terms (PLANET_SHAPIRO) need the planet columns of the TOA
prepare, which the port does not have yet (ROADMAP A18).
"""

from __future__ import annotations

import torch

from pint_tpu_torch import AU_LS, TSUN_S
from pint_tpu_torch.models.astrometry import dot3
from pint_tpu_torch.models.base import DelayComponent
from pint_tpu_torch.models.parameter import ParamSpec
from pint_tpu_torch.ops import libm


def shapiro_delay(obs_obj_pos_ls: torch.Tensor, psr_dir: torch.Tensor, t_obj_s: float) -> torch.Tensor:
    r = torch.sqrt(dot3(obs_obj_pos_ls, obs_obj_pos_ls))
    rcostheta = dot3(obs_obj_pos_ls, psr_dir)
    return -2.0 * t_obj_s * libm.log((r - rcostheta) / AU_LS)


class SolarSystemShapiro(DelayComponent):
    category = "solar_system_shapiro"
    register = True

    @classmethod
    def param_specs(cls):
        return [ParamSpec("PLANET_SHAPIRO", kind="bool", default=False,
                          description="Include the planets' Shapiro terms")]

    def __init__(self, planet_shapiro: bool = False):
        super().__init__()
        if planet_shapiro:
            raise NotImplementedError(
                "PLANET_SHAPIRO needs the planet positions of the TOA prepare, "
                "which pint_tpu_torch does not port yet (ROADMAP A18)")

    def delay(self, params: dict, tensor: dict, delay_so_far, xp):
        return shapiro_delay(tensor["obs_sun_pos_ls"], tensor["_psr_dir"], TSUN_S)

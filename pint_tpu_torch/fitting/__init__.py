"""Fitting engines (counterpart of ``pint_tpu/fitting``): the WLS, GLS and
wideband fitters, `fit_auto`, which picks one, the noise likelihood
(`NoiseLikelihood`, `noise_param_names`) and the joint likelihood of a pulsar
timing array (`PTALikelihood`)."""

import logging

from pint_tpu_torch.fitting.gls import DownhillGLSFitter, GLSFitter  # noqa: F401
from pint_tpu_torch.fitting.noise_like import NoiseLikelihood, noise_param_names  # noqa: F401
from pint_tpu_torch.fitting.pta_like import PTALikelihood  # noqa: F401
from pint_tpu_torch.fitting.wideband import WidebandDownhillFitter, refuse_unported
from pint_tpu_torch.fitting.wls import DownhillWLSFitter, FitResult, WLSFitter  # noqa: F401


def fit_auto(toas, model, downhill: bool = True, mesh=None, fused=None):
    """The fitter pint_tpu's ``fit_auto`` picks: wideband when the TOAs (or
    their tensor dict) carry -pp_dm DM measurements, else GLS when the model
    has correlated noise, else WLS. The JAX package's `mesh` (ROADMAP A15)
    and `fused` (A11a) fits are not ported: asking for them raises."""
    refuse_unported(mesh, fused)
    wideband = "wb_dm" in toas if isinstance(toas, dict) else toas.is_wideband
    if wideband:
        if not downhill:
            logging.getLogger("pint_tpu_torch.fitting").warning(
                "wideband fitting is always Levenberg-Marquardt; downhill=False ignored")
        return WidebandDownhillFitter(toas, model)
    if model.has_correlated_errors:
        cls = DownhillGLSFitter if downhill else GLSFitter
    else:
        cls = DownhillWLSFitter if downhill else WLSFitter
    return cls(toas, model)

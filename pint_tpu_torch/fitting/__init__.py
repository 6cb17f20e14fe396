"""Fitting engines (counterpart of ``pint_tpu/fitting``): the WLS and GLS
fitters."""

from pint_tpu_torch.fitting.gls import DownhillGLSFitter, GLSFitter  # noqa: F401
from pint_tpu_torch.fitting.wls import DownhillWLSFitter, FitResult, WLSFitter  # noqa: F401

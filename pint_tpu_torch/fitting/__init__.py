"""Fitting engines (counterpart of ``pint_tpu/fitting``): the WLS fitters."""

from pint_tpu_torch.fitting.wls import DownhillWLSFitter, FitResult, WLSFitter  # noqa: F401

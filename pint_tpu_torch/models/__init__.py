"""Timing-model components and the model builder."""

from pint_tpu_torch.models.builder import build_model, get_model, get_model_and_toas  # noqa: F401
from pint_tpu_torch.models.timing_model import TimingModel  # noqa: F401

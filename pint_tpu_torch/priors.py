"""Parameter priors for the noise posterior (counterpart of
``pint_tpu/priors.py``): small frozen dataclasses whose ``logpdf`` is torch,
so that it composes with the likelihood under autograd and over a batch of
points."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class UniformPrior:
    """Flat within [lo, hi] (improper and unbounded where lo or hi is
    infinite): -ln(hi - lo) inside, -inf outside."""

    lo: float = -math.inf
    hi: float = math.inf

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        inside = (x >= self.lo) & (x <= self.hi)
        width = self.hi - self.lo
        norm = -math.log(width) if math.isfinite(width) else 0.0
        return torch.where(inside, torch.full_like(x, norm), torch.full_like(x, -math.inf))


@dataclass(frozen=True)
class NormalPrior:
    mu: float
    sigma: float

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.mu) / self.sigma
        return -0.5 * z * z - math.log(self.sigma) - 0.5 * math.log(2 * math.pi)


def default_prior(value: float, uncertainty: float | None, nsigma: float = 100.0):
    """Uniform, centred on the par file's value, spanning +-nsigma of its
    uncertainty (unbounded when the par file gives none)."""
    if uncertainty is None or uncertainty == 0.0:
        return UniformPrior()
    return UniformPrior(value - nsigma * uncertainty, value + nsigma * uncertainty)

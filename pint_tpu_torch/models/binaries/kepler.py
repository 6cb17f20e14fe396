"""Kepler's equation E - e sin E = M and the true anomaly (counterpart of
``pint_tpu/models/binaries/kepler.py``).

`kepler_E` runs a FIXED number of Newton steps from Danby's starter, in the
reference's operation order, and takes its tangent from the implicit
function theorem instead of differentiating the recurrence:

    dE = (dM + sin E de) / (1 - e cos E)

It is a ``torch.autograd.Function`` with that ``jvp`` and a generated vmap
rule, so ``torch.func.jvp`` under ``vmap`` (the tangent lanes of K1's twin)
goes through the rule and never through the Newton steps. Kernel K1
(csrc/resid_tangent.cu) solves the same way: Newton on the primal doubles,
then one dual value from the same rule.

Spellings that keep the twin on the reference's values: ``torch.sign(0)`` is
0, as ``jnp.sign``'s, so the starter is M where sin M is exactly 0;
``torch.round`` rounds half to even, as ``jnp.round``; a division by a
constant divides by a tensor on the operand's device (``erot.fdiv``), since
PyTorch's CUDA division by a Python scalar multiplies by its reciprocal
(ROADMAP C8).
"""

from __future__ import annotations

import math

import torch

from pint_tpu_torch.astro.erot import fdiv
from pint_tpu_torch.ops import libm

NEWTON_ITERS = 10
TWO_PI = 2.0 * math.pi

def _newton(M: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    # Danby (1987) starter: robust for all e in [0, 1)
    E = M + 0.85 * e * torch.sign(libm.sin(M))
    for _ in range(NEWTON_ITERS):
        f = E - e * libm.sin(E) - M
        fp = 1.0 - e * libm.cos(E)
        E = E - f / fp
    return E


class _KeplerE(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(M, e):
        return _newton(M, e)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[1], output)

    @staticmethod
    def jvp(ctx, dM, de):
        e, E = ctx.saved_tensors
        denom = 1.0 - e * libm.cos(E)
        if dM is None:
            dM = torch.zeros_like(denom)
        num = dM if de is None else dM + libm.sin(E) * de
        return num / denom


def kepler_E(M, e) -> torch.Tensor:
    """Eccentric anomaly for mean anomaly M (rad, any branch), eccentricity
    e; E is on M's branch (E - M is periodic and bounded by e)."""
    M = torch.as_tensor(M, dtype=torch.float64)
    e = torch.as_tensor(e, dtype=torch.float64, device=M.device)
    return _KeplerE.apply(M, e)


def true_anomaly(E, e) -> torch.Tensor:
    """True anomaly on E's branch: 2 atan2(sqrt(1+e) sin(E/2), sqrt(1-e)
    cos(E/2)) on the centred branch, re-attached to E's."""
    n = torch.round(fdiv(E, TWO_PI))
    Ec = E - TWO_PI * n  # centred (-pi, pi]
    nu_c = 2.0 * libm.atan2(
        torch.sqrt(1.0 + e) * libm.sin(0.5 * Ec),
        torch.sqrt(1.0 - e) * libm.cos(0.5 * Ec),
    )
    return nu_c + TWO_PI * n

"""Horner evaluation of factorial-scaled Taylor series (counterpart of
``pint_tpu/ops/taylor.py``).

``taylor_horner(x, [c0, c1, c2, c3])`` = c0 + c1 x + c2 x^2/2! + c3 x^3/3!.
The spindown phase runs the double-double variant: F0*dt with dt ~ 1e9 s
gives ~1e11 turns that must stay exact to ~1e-9 turns.
"""

from __future__ import annotations

from typing import Sequence

import torch

from pint_tpu_torch.ops.dd import DD, dd, dd_add, dd_add_fp, dd_mul, dd_mul_fp

_FACT = [1.0]
for _i in range(1, 40):
    _FACT.append(_FACT[-1] * _i)


def _over_fact(c, i: int) -> torch.Tensor:
    """c / i! as an IEEE division (PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal: ROADMAP C8)."""
    c = torch.as_tensor(c, dtype=torch.float64)
    return c / c.new_full((), _FACT[i])


def taylor_horner(x: torch.Tensor, coeffs: Sequence) -> torch.Tensor:
    """float64 Horner sum_i coeffs[i] * x^i / i!."""
    if len(coeffs) == 0:
        return torch.zeros_like(x)
    acc = _over_fact(coeffs[-1], len(coeffs) - 1)
    for i in range(len(coeffs) - 2, -1, -1):
        acc = acc * x + _over_fact(coeffs[i], i)
    return torch.broadcast_to(acc, torch.broadcast_shapes(acc.shape, x.shape))


def taylor_horner_deriv(x: torch.Tensor, coeffs: Sequence, deriv_order: int = 1) -> torch.Tensor:
    """d^n/dx^n of taylor_horner: the factorial scaling makes it a shift."""
    if deriv_order == 0:
        return taylor_horner(x, coeffs)
    shifted = list(coeffs[deriv_order:])
    if not shifted:
        return torch.zeros_like(x)
    return taylor_horner(x, shifted)


def taylor_horner_x(xp, x, coeffs: Sequence):
    """Backend-generic Horner: x and result in xp's extended precision;
    coefficients may be DD leaves or plain float64."""
    if len(coeffs) == 0:
        return xp.zeros_like(x.hi)
    acc = xp.mul_f(xp.lift(coeffs[-1], x.hi), 1.0 / _FACT[len(coeffs) - 1])
    for i in range(len(coeffs) - 2, -1, -1):
        acc = xp.mul(acc, x)
        acc = xp.add(acc, xp.mul_f(xp.lift(coeffs[i], x.hi), 1.0 / _FACT[i]))
    return acc


def taylor_horner_dd(x: DD, coeffs: Sequence) -> DD:
    """Double-double Horner: x is DD, coefficients float64 or DD; each step
    acc = acc*x + c_i/i! in dd arithmetic."""
    if len(coeffs) == 0:
        return dd(torch.zeros_like(x.hi))
    last = coeffs[-1]
    if isinstance(last, DD):
        acc = dd_mul_fp(last, 1.0 / _FACT[len(coeffs) - 1])
    else:
        acc = dd(torch.as_tensor(last, dtype=torch.float64) / _FACT[len(coeffs) - 1])
    for i in range(len(coeffs) - 2, -1, -1):
        acc = dd_mul(acc, x)
        c = coeffs[i]
        if isinstance(c, DD):
            acc = dd_add(acc, dd_mul_fp(c, 1.0 / _FACT[i]))
        else:
            acc = dd_add_fp(acc, torch.as_tensor(c, dtype=torch.float64) / _FACT[i])
    return acc

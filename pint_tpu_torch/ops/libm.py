"""sin, cos, log, exp, atan2 and pow for the forward chain, the same on
every backend as the reference's.

On a CPU tensor torch evaluates these through SLEEF's vector routines,
which differ from the C library by up to an ulp: on the ~500 s Roemer delay
that is ~3e-14 s, enough to move parameters near zero (PX, DM1) by ~5e-9 of
their value in a fit. XLA's CPU backend, which computes the JAX package's
reference, returns the C library's values for sin, cos, log and atan2. So on
the CPU these functions evaluate the C library (``math``), element by
element; their tangents follow jax's rules (sin' = cos, cos' = -sin,
log' = 1/x, exp' = exp, atan2 as jax's ``atan2_p``) with the same functions.
XLA's CPU exp is its own polynomial, up to 2 ulp from the C library's; the
twin follows the C library there (ROADMAP C7). XLA's CPU pow with a float
exponent is the C library's bitwise (``tests/test_torch_binaries.py``
holds it on DDGR's inputs); its tangent is jax's, y x^(y - 1) from a second
pow. On a CUDA tensor they are
torch's own, which are the CUDA math library's, as in the kernels
(csrc/resid_tangent.cu).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_HOST = {name: np.frompyfunc(getattr(math, name), 1, 1) for name in ("sin", "cos", "log", "exp")}
_ATAN2 = np.frompyfunc(math.atan2, 2, 1)


def _host(name: str, x: torch.Tensor) -> torch.Tensor:
    a = x.detach().numpy()
    out = _HOST[name](a) if a.size else a
    return torch.from_numpy(np.asarray(out, dtype=np.float64).reshape(a.shape))


def _tangent(name: str, x: torch.Tensor, ans: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    # through _Libm again: under vmap, x is a batched tensor
    if name == "sin":
        return t * _Libm.apply(x, "cos")
    if name == "cos":
        return t * -_Libm.apply(x, "sin")
    if name == "exp":
        return t * ans
    return t / x


class _Libm(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, name):
        return _host(name, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, name = inputs
        ctx.name = name
        ctx.save_for_forward(x, output)

    @staticmethod
    def jvp(ctx, tx, _):
        x, ans = ctx.saved_tensors
        return _tangent(ctx.name, x, ans, tx)


class _Atan2(torch.autograd.Function):
    """atan2(y, x) from the C library; tangent as jax's atan2_p:
    ty * (x / (y^2 + x^2)) + tx * (-y / (y^2 + x^2))."""

    generate_vmap_rule = True

    @staticmethod
    def forward(y, x):
        a, b = np.broadcast_arrays(y.detach().numpy(), x.detach().numpy())
        out = _ATAN2(a, b) if a.size else a
        return torch.from_numpy(np.asarray(out, dtype=np.float64).reshape(a.shape))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, ty, tx):
        y, x = ctx.saved_tensors
        den = y * y + x * x
        out = None
        if ty is not None:
            out = ty * (x / den)
        if tx is not None:
            term = tx * (-y / den)
            out = term if out is None else out + term
        return out if out is not None else torch.zeros_like(den)


def _apply(name: str, x: torch.Tensor) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float64)
    if x.device.type != "cpu":
        return getattr(torch, name)(x)
    return _Libm.apply(x, name)


def sin(x):
    return _apply("sin", x)


def cos(x):
    return _apply("cos", x)


def log(x):
    return _apply("log", x)


def exp(x):
    return _apply("exp", x)


def atan2(y, x):
    y = torch.as_tensor(y, dtype=torch.float64)
    x = torch.as_tensor(x, dtype=torch.float64, device=y.device)
    if y.device.type != "cpu":
        return torch.atan2(y, x)
    return _Atan2.apply(y, x)


class _Pow(torch.autograd.Function):
    """x ** y for a constant float y, from the C library; tangent as jax's
    ``pow`` rule: t (y pow(x, y - 1))."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, y):
        a = x.detach().numpy()
        out = _POW(a, y) if a.size else a
        return torch.from_numpy(np.asarray(out, dtype=np.float64).reshape(a.shape))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.y = inputs[1]
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def jvp(ctx, tx, _):
        (x,) = ctx.saved_tensors
        return tx * (ctx.y * _Pow.apply(x, ctx.y - 1.0))


_POW = np.frompyfunc(math.pow, 2, 1)


def pow(x, y: float):  # noqa: A001  (the C library's name)
    """x ** y for a float exponent y (DDGR's n^(5/3), (1 - e^2)^3.5, ...)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    if x.device.type != "cpu":
        return torch.pow(x, y)
    return _Pow.apply(x, float(y))

"""Double-double ("dd") arithmetic in PyTorch, and the K0 elementwise kernel.

Counterpart of ``pint_tpu/ops/dd.py``. A dd value is the unevaluated sum
``hi + lo`` of two float64 tensors with |lo| <= ulp(hi)/2, about 32
significant digits: enough for ~1e11 turns of pulse phase to 1e-9 turns.

The functions below are the plain-torch twins: the same error-free
transforms (Knuth two_sum, Dekker split/two_prod) in the same operation
order as the JAX package, one torch operator per IEEE operation. On the CPU
and, op by op, on CUDA, torch neither reassociates nor contracts a multiply
and an add into an FMA, so the transforms stay exact.

The CUDA side of the same library is ``csrc/dd.cuh``: every other kernel of
the port builds on it. `dd_elementwise` runs it over tensors (kernel K0), so
that the header can be held bitwise against these twins on the card, and it
carries the parameter updates of the fit loops (``fitting/wls.apply_delta``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

# Dekker splitter for binary64: 2^27 + 1
_SPLITTER = 134217729.0


class DD(NamedTuple):
    """A number represented as the unevaluated exact sum ``hi + lo``."""

    hi: torch.Tensor
    lo: torch.Tensor


def dd(hi, lo=0.0) -> DD:
    """DD from float64 parts (not renormalized); `lo` broadcasts to `hi`."""
    hi = torch.as_tensor(hi, dtype=torch.float64)
    lo = torch.as_tensor(lo, dtype=torch.float64, device=hi.device)
    return DD(hi, torch.broadcast_to(lo, hi.shape))


def dd_zeros_like(x: torch.Tensor) -> DD:
    z = torch.zeros_like(x, dtype=torch.float64)
    return DD(z, z)


# --- error-free transformations ------------------------------------------------


def two_sum(a, b):
    """Knuth: s + err == a + b exactly, s = fl(a+b)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Dekker fast path; requires |a| >= |b| (or a == 0)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    t = _SPLITTER * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker: p + err == a*b exactly, p = fl(a*b)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# --- dd arithmetic -------------------------------------------------------------


def dd_normalize(x: DD) -> DD:
    return DD(*quick_two_sum(x.hi, x.lo))


def dd_add(x: DD, y: DD) -> DD:
    # accurate (two two_sum) variant: robust under the heavy cancellation of
    # the phase - TZR-phase subtraction
    s1, s2 = two_sum(x.hi, y.hi)
    t1, t2 = two_sum(x.lo, y.lo)
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return DD(*quick_two_sum(s1, s2))


def dd_add_fp(x: DD, b) -> DD:
    s, e = two_sum(x.hi, b)
    e = e + x.lo
    return DD(*quick_two_sum(s, e))


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_sub(x: DD, y: DD) -> DD:
    return dd_add(x, dd_neg(y))


def dd_mul(x: DD, y: DD) -> DD:
    p, e = two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    return DD(*quick_two_sum(p, e))


def dd_mul_fp(x: DD, b) -> DD:
    p, e = two_prod(x.hi, b)
    e = e + x.lo * b
    return DD(*quick_two_sum(p, e))


def dd_div(x: DD, y: DD) -> DD:
    """Newton-refined division; ~2 ulp of dd precision."""
    q1 = x.hi / y.hi
    r = dd_add(x, dd_neg(dd_mul(y, dd(q1))))
    q2 = r.hi / y.hi
    r = dd_add(r, dd_neg(dd_mul(y, dd(q2))))
    q3 = r.hi / y.hi
    s, e = two_sum(q1, q2)
    return dd_normalize(DD(s, e + q3))


def dd_rint(x: DD):
    """(nearest integer as float64, dd fractional remainder). torch.round
    rounds half to even, like jnp.rint and CUDA's rint."""
    n1 = torch.round(x.hi)
    r = dd_add_fp(x, -n1)
    n2 = torch.round(r.hi)
    r = dd_add_fp(r, -n2)
    return n1 + n2, r


def dd_to_float(x: DD) -> torch.Tensor:
    return x.hi + x.lo


# --- host-side exact splitting (numpy) ------------------------------------------

# pint_tpu keeps the hi word of every dd that crosses to the device to 40
# mantissa bits (its TPU emulated float64 with ~48). The port keeps the same
# value-preserving split so that parameters parse to the same (hi, lo) pairs
# as in the JAX package; on IEEE float64 it is harmless.
DEVICE_SPLIT_BITS = 40


def device_split(hi, lo=None, bits: int = DEVICE_SPLIT_BITS):
    """Re-split hi+lo so hi has at most `bits` mantissa bits (numpy)."""
    hi = np.asarray(hi, np.float64)
    lo_in = 0.0 if lo is None else np.asarray(lo, np.float64)
    _, exp = np.frexp(hi)
    s = np.ldexp(np.ones_like(hi), exp - bits)
    with np.errstate(invalid="ignore"):
        hi2 = np.where(hi == 0.0, 0.0, np.round(hi / np.where(s == 0, 1.0, s)) * s)
    lo2 = (hi - hi2) + lo_in
    return hi2, lo2


# --- K0: the dd library of csrc/dd.cuh over tensors -----------------------------

#: op name -> (code in csrc/dd_elementwise.cu, number of outputs)
_K0_OPS = {"add": (0, 2), "add_fp": (1, 2), "mul": (2, 2), "mul_fp": (3, 2),
           "div": (4, 2), "two_prod": (5, 2), "rint": (6, 3)}


def dd_elementwise_plain(op: str, x: DD, y=None):
    """Plain-torch twin of `dd_elementwise`: the same op on the same inputs.
    ``two_prod`` reads x.hi and y.hi; ``add_fp``/``mul_fp`` take a float64
    tensor `y`; ``rint`` ignores `y` and returns (n, DD)."""
    if op == "add":
        return dd_add(x, y)
    if op == "add_fp":
        return dd_add_fp(x, y)
    if op == "mul":
        return dd_mul(x, y)
    if op == "mul_fp":
        return dd_mul_fp(x, y)
    if op == "div":
        return dd_div(x, y)
    if op == "two_prod":
        return DD(*two_prod(x.hi, y.hi))
    if op == "rint":
        return dd_rint(x)
    raise ValueError(f"unknown dd op {op!r}")


def _k0_operands(op, x, y):
    if op not in _K0_OPS:
        raise ValueError(f"unknown dd op {op!r}")
    parts = [x.hi, x.lo]
    if op in ("add", "mul", "div"):
        parts += [y.hi, y.lo]
    elif op in ("add_fp", "mul_fp"):
        parts += [y, y]
    elif op == "two_prod":
        parts += [y.hi, y.hi]
    else:
        parts += [x.hi, x.hi]
    shape = parts[0].shape
    for t in parts:
        if t.dtype != torch.float64 or t.device != parts[0].device or t.shape != shape:
            raise ValueError(
                f"dd_elementwise({op}) needs float64 tensors of one shape on "
                f"one device; got {[(p.dtype, p.device, tuple(p.shape)) for p in parts]}")
    return [t.contiguous() for t in parts], shape


def dd_elementwise(op: str, x: DD, y=None):
    """K0: one op of csrc/dd.cuh over tensors. On a CUDA tensor it launches
    the kernel (and raises if it cannot); on a CPU tensor it takes the plain
    twin `dd_elementwise_plain`. Returns a DD, or (n, DD) for ``rint``."""
    if x.hi.device.type == "cpu":
        return dd_elementwise_plain(op, x, y)
    parts, shape = _k0_operands(op, x, y)
    code, n_out = _K0_OPS[op]
    outs = [torch.empty(shape, dtype=torch.float64, device=parts[0].device)
            for _ in range(3)]
    from pint_tpu_torch.ops import build

    lib = build.library("dd_elementwise", _declare_k0)
    build.check(lib, lib.dd_elementwise(
        code, *[t.data_ptr() for t in parts], *[o.data_ptr() for o in outs],
        parts[0].numel(), build.stream_of(parts[0])))
    dd_elementwise.launches += 1
    if n_out == 3:
        return outs[0], DD(outs[1], outs[2])
    return DD(outs[0], outs[1])


dd_elementwise.launches = 0


def _declare_k0(lib) -> None:
    p = ctypes.c_void_p
    lib.dd_elementwise.argtypes = [ctypes.c_int, p, p, p, p, p, p, p,
                                   ctypes.c_longlong, p]
    lib.dd_elementwise.restype = ctypes.c_int

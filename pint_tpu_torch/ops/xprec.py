"""Extended-precision backend for the phase value path (counterpart of the
``DD64Prec`` half of ``pint_tpu/ops/xprec.py``).

The JAX package threads a backend ``xp`` through the phase components so
that one model runs in double-double on IEEE float64 and in quad-float32 on
TPUs that emulate float64. The H100 has IEEE float64, so the port carries
only the double-double backend; the qf32 one is not ported (ROADMAP A17).
"""

from __future__ import annotations

import torch

from pint_tpu_torch.ops import dd as ddm
from pint_tpu_torch.ops.dd import DD


class DD64Prec:
    """float64 double-double backend."""

    def time_from_tensor(self, tensor: dict) -> DD:
        return DD(tensor["t_hi"], tensor["t_lo"])

    def from_f64(self, x) -> DD:
        return ddm.dd(torch.as_tensor(x, dtype=torch.float64))

    def zeros_like(self, x: torch.Tensor) -> DD:
        return ddm.dd_zeros_like(x)

    def add(self, x: DD, y: DD) -> DD:
        return ddm.dd_add(x, y)

    def add_f(self, x: DD, f) -> DD:
        return ddm.dd_add_fp(x, f)

    def sub(self, x: DD, y: DD) -> DD:
        return ddm.dd_sub(x, y)

    def neg(self, x: DD) -> DD:
        return ddm.dd_neg(x)

    def mul(self, x: DD, y: DD) -> DD:
        return ddm.dd_mul(x, y)

    def mul_f(self, x: DD, f) -> DD:
        return ddm.dd_mul_fp(x, f)

    def to_f64(self, x: DD) -> torch.Tensor:
        return ddm.dd_to_float(x)

    def index(self, x: DD, idx) -> DD:
        return DD(x.hi[..., idx], x.lo[..., idx])

    def lift(self, v, like: torch.Tensor | None = None):
        """A parameter leaf (DD or plain float) in backend form, on the
        device of `like` when given."""
        if isinstance(v, DD):
            return v
        dev = like.device if like is not None else None
        return self.from_f64(torch.as_tensor(v, dtype=torch.float64, device=dev))


def params_to_dd(params: dict) -> dict:
    """Canonical parameter dict after a fit: DD leaves stay DD pairs (the
    only backend here), plain leaves pass through."""
    return {k: DD(v.hi, v.lo) if isinstance(v, DD) else v for k, v in params.items()}


DD64 = DD64Prec()

"""The plans of the backward kernels K9 (``csrc/noise_grad.cu``) and K10
(``csrc/pta_grad.cu``), as their library gives them.

The layout (padded widths, each pass's warps and shared memory, the
scratch) and the limits of the shapes the kernels take live in one place,
``csrc/grad_plan.h``, which each library exports as ``noise_grad_plan`` and
``pta_grad_plan``. Here a plan is read into a dict, and a shape the library
refuses becomes a ValueError that names the limit.
"""

from __future__ import annotations

import ctypes

#: what a plan holds, in the order of grad_plan.h's `plan_out`
FIELDS = ("scratch", "basis_warps", "row_warps", "smem_factors", "smem_basis", "smem_rows",
          "panel")
#: grad_plan.h's Refusal codes, each with its limit and the value refused
REFUSALS = {
    1: "takes at least {limit} row; got {got}",
    2: "takes no negative width; got {got}",
    3: "takes at most {limit} value columns; got {got}",
    4: "inverts L in shared memory: at most {limit} dense basis columns; got {got}",
    5: "takes 1 to {limit} sets; got {got}",
    6: "takes 1 to {limit} pulsars; got {got}",
}


def declare(lib) -> None:
    """The argtypes of a library's two plan functions."""
    i, out = ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.noise_grad_plan.argtypes = [i] * 6 + [out]
    lib.pta_grad_plan.argtypes = [i] * 6 + [out]


def _plan(fn, kernel: str, *shape: int) -> dict:
    out = (ctypes.c_longlong * len(FIELDS))()
    rc = fn(*(int(x) for x in shape), out)
    if rc:
        raise ValueError(f"kernel {kernel} " + REFUSALS[rc].format(limit=out[0], got=out[1]))
    return dict(zip(FIELDS, out))


def noise_grad_plan(lib, n: int, p: int, ke: int, kd: int, E: int, marginalize: bool) -> dict:
    """K9 at n rows, p timing columns, ke epochs, kd dense columns and E
    weight sets."""
    return _plan(lib.noise_grad_plan, "K9", n, p, ke, kd, E, bool(marginalize))


def pta_grad_plan(lib, n: int, npsr: int, q: int, ke: int, kd: int, E: int) -> dict:
    """K10 at n bucket rows of npsr pulsars, q = p + m + 1 value columns, ke
    epochs and kd dense columns a pulsar, and E points (E x npsr sets)."""
    return _plan(lib.pta_grad_plan, "K10", n, npsr, q, ke, kd, E)

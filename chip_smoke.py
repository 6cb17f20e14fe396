#!/usr/bin/env python3
"""Drive pint_tpu_torch's main path on one NVIDIA GPU and hold every kernel
against its plain-torch twin.

    python3 chip_smoke.py

Phases, in order (any failed check raises and the exit code is non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of ``pint_tpu_torch/csrc`` (nvcc, sm_90a);
3. K0 ``dd_elementwise`` bitwise against the dd twins on 1M random and
   adversarial-cancellation inputs, and at the (2,) shape of the fit's
   parameter update (F0 and F1, the double-double free parameters);
4. K1 ``resid_tangent`` against its twin on the 16,384-TOA archive, at the
   fit's shape (1 parameter set, 4 tangent lanes) and the grid's (9 sets,
   2 lanes): time residuals within 1 ps, pulse numbers equal, f within
   1e-15 relative, tangents within 1e-10 relative;
5. K2 ``normal_eq`` against its twin on the grid's first step: G, c, chi^2
   and the column norms within 1e-12 relative (only the summation order
   differs);
6. the WLS fit: ``DownhillWLSFitter.fit_toas`` from SMOKE_PAR with F0 moved
   by +2e-10 Hz and DM by +1e-3, checked for convergence, chi^2/dof in
   [0.8, 1.2], params within 1e-10 relative and 1e-6 of their uncertainty,
   and uncertainties within 1e-10 relative, of the same fit run through the
   twins on the card;
7. the 3x3 (F0, F1) ``grid_chisq`` around the fit, per point within 1e-10
   relative of the twin path, its minimum at the centre;
8. kernel and twin times; the wall of one warm fit + grid without the
   profiler, then a torch.profiler pass over one more: device time by
   kernel and the device's busy share of the unprofiled wall.

Then the flagship path, on ``pint_tpu_torch/data/flagship_n16384.npz``
(``profiles.FLAGSHIP_SMOKE_PAR``: PM/PX astrometry, DM + DM1, ELL1,
EFAC/EQUAD/ECORR; 16,384 TOAs in 2,048 ECORR epochs, 14 free parameters):

9. K1 with the ELL1 term against its twin at the GLS fit's shape (1 set,
   14 lanes) and the grid's (9 (M2, SINI) sets, 12 lanes): time residuals
   within 1 ps, pulse numbers equal, tangents within 1e-12 relative;
10. K3 ``ecorr_normal_eq`` against its twin (the ``fitting/woodbury.py``
   algebra) on the GLS step's raw design (B = 1, p = 14, unweighted column
   norms) and the grid's first step (B = 9, p = 14: 12 tangent columns and
   the analytic DM, DM1 ones, weighted means removed, weighted norms), and
   on the two chi^2 calls (p = 0): G, c, chi^2, ahat and the norms within
   1e-12 relative (the sums run in another order), and bitwise equal
   across two runs;
11. ``DownhillGLSFitter.fit_toas`` from the flagship par moved by F0
   +2e-10 Hz, DM +1e-3 and EPS1 +1e-7, gated as in phase 6 against the
   same fit through the twins on the card;
12. the 3x3 (M2, SINI) ``grid_chisq`` with the GLS statistic, every point
   finite and within 1e-10 relative of the twin path;
13. kernel times at the flagship shapes, and the warm wall and busy share
   of one flagship fit + grid, as in phase 8.

The launch counters are zeroed just before each ``fit_toas`` and read just
after it, then zeroed and read again around each ``grid_chisq`` (the
fitter and its start shift are built outside the windows; the twin runs do
not count). The SMOKE fit must launch K0 and K1, its grid K1 and K2; the
flagship fit K0, K1 and K3, its grid K0, K1 and K3. K2's and K3's counts
are of calls; K2 runs 2 or 3 kernel passes (counted apart), K3 3 to 6. At the
shapes of the main path, ``ms`` is a kernel's
device time per call from torch.profiler (``plain_ms``, ``library_ms``: all
the kernels the twin or the library call runs), and ``call_ms`` the
CUDA-event time per call, which includes the host's time to enqueue it.
``bound_ms`` is the larger of the bytes the function must move over
3.35 TB/s and its float64 operations over 34 TFLOP/s (H100 SXM, NVIDIA data
sheet, float64 outside the tensor cores). The output ends with the
``kernels`` record, the card's name and power limit, and the result line.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
START_SHIFT = {"F0": 2e-10, "DM": 1e-3}
FLAGSHIP_SHIFT = {"F0": 2e-10, "DM": 1e-3, "EPS1": 1e-7}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP64_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def timed_ms(fn, device, reps: int) -> float:
    """Mean milliseconds of one call: CUDA events around `reps` calls after
    a warm-up call (host clock with a final synchronize on the CPU)."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(fn, device, reps: int, kernel: str | None = None) -> tuple:
    """(device ms, call ms) of one call of `fn`. Device ms is the summed time
    of the kernels the call runs, from torch.profiler's CUDA activity (only
    kernels whose name holds `kernel`, when given); call ms is `timed_ms`,
    which includes the host's time to enqueue the call and bounds the rate of
    back-to-back calls. On the CPU the device time is None."""
    call = timed_ms(fn, device, reps)
    if device.type != "cuda":
        return None, call
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.key))
    return us / 1e3 / reps, call


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (0 when both are all zero)."""
    import torch

    scale = float(torch.max(torch.abs(want))) if want.numel() else 0.0
    diff = float(torch.max(torch.abs(got - want))) if want.numel() else 0.0
    return diff / scale if scale else diff


@contextlib.contextmanager
def twins():
    """Route the main path through the plain-torch twins, on the card."""
    from pint_tpu_torch import gridutils, residuals
    from pint_tpu_torch.fitting import gls, wls, woodbury
    from pint_tpu_torch.ops import dd

    saved = (residuals.resid_tangent, wls.dd_elementwise, gridutils.normal_eq,
             gls.ecorr_normal_eq, gridutils.ecorr_normal_eq)
    residuals.resid_tangent = residuals.resid_tangent_plain
    wls.dd_elementwise = dd.dd_elementwise_plain
    gridutils.normal_eq = gridutils.normal_eq_plain
    gls.ecorr_normal_eq = gridutils.ecorr_normal_eq = woodbury.ecorr_normal_eq_plain
    try:
        yield
    finally:
        (residuals.resid_tangent, wls.dd_elementwise, gridutils.normal_eq,
         gls.ecorr_normal_eq, gridutils.ecorr_normal_eq) = saved


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --- phase 3: K0 ------------------------------------------------------------------


def dd_inputs(n: int, seed: int, device):
    """Normalized dd pairs: random magnitudes 1e-140..1e15 of both signs, and
    y built to cancel x (y ~ -x with a perturbed low word) on a third of
    the rows; rint inputs are ~1e11-turn phases with exact halves."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-140, 15, (2, n)) * rng.choice([-1.0, 1.0], (2, n))
    lo = mag * rng.uniform(-1, 1, (2, n)) * 2.0**-54
    hi = mag.copy()
    third = n // 3
    hi[1, :third] = -hi[0, :third]
    lo[1, :third] = -lo[0, :third] * (1 + rng.uniform(-1e-3, 1e-3, third))
    s = hi + lo
    lo = (hi - s) + lo  # renormalize: |lo| <= ulp(hi)/2
    hi = s
    ph = rng.uniform(-2e11, 2e11, n)
    ph[: n // 4] = np.round(ph[: n // 4]) + 0.5
    ph_lo = rng.uniform(-1, 1, n) * 2.0**-60 * np.abs(ph)
    ph_lo[: n // 8] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    return t(hi[0]), t(lo[0]), t(hi[1]), t(lo[1]), t(ph), t(ph_lo)


def phase_k0(device, n: int = 1 << 20) -> None:
    """Every op on `n` inputs, then on the (2,) shape of the fit's parameter
    update (F0 and F1; the grid's refitted parameters are plain float64)."""
    import torch

    from pint_tpu_torch.ops.dd import DD, _K0_OPS, dd_elementwise, dd_elementwise_plain

    for shape in ((n,), (2,)):
        xh, xl, yh, yl, ph, phl = (t.reshape(shape)
                                   for t in dd_inputs(math.prod(shape), 7, device))
        x, y = DD(xh, xl), DD(yh, yl)
        for op in _K0_OPS:
            if op == "rint":
                args = (DD(ph, phl), None)
            elif op in ("add_fp", "mul_fp"):
                args = (x, yh)
            else:
                args = (x, y)
            got, want = dd_elementwise(op, *args), dd_elementwise_plain(op, *args)
            if op == "rint":
                got, want = (got[0], *got[1]), (want[0], *want[1])
            sync(device)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            check(same, f"K0 {op} bitwise equal to the twin on {shape} inputs")


# --- phases 4-5: K1, K2 ------------------------------------------------------------


def grid_params(model, ftr):
    """The batched parameter dict of the model's 3x3 grid (``grid_for``: the
    spin grid for SMOKE_PAR, (M2, SINI) for the flagship)."""
    import numpy as np
    import torch

    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.profiles import grid_for

    names, vals = grid_for(model, ftr)
    pts = np.stack([g.ravel() for g in np.meshgrid(*vals)], axis=1)
    B = pts.shape[0]
    params = {k: (DD(v.hi.expand(B).clone(), v.lo.expand(B).clone()) if isinstance(v, DD)
                  else v.expand(B).clone()) for k, v in model.params.items()}
    dev = model.params["F0"].hi.device
    for i, n in enumerate(names):
        col = torch.as_tensor(pts[:, i], dtype=torch.float64, device=dev)
        params[n] = DD(col, torch.zeros_like(col)) if isinstance(params[n], DD) else col
    return names, vals, params


def phase_k1(model, tensor, params_b, fit_lanes, grid_lanes, device, tan_tol: float,
             label: str = "") -> dict:
    import torch

    from pint_tpu_torch.residuals import resid_tangent, resid_tangent_plain

    stats = {}
    for shape, params, lanes in (("fit", model.params, fit_lanes),
                                 ("grid", params_b, grid_lanes)):
        got = resid_tangent(model, params, tensor, lanes)
        want = resid_tangent_plain(model, params, tensor, lanes)
        sync(device)
        tag = f"K1 {label}{shape} ({len(lanes)} lanes)"
        dt = float(torch.max(torch.abs(got.frac / got.f - want.frac / want.f)))
        check(dt <= 1e-12, f"{tag}: time residuals within 1 ps of the twin ({dt:.3g} s)")
        check(torch.equal(got.pn, want.pn), f"{tag}: pulse numbers equal")
        check(rel_err(got.f, want.f) <= 1e-15, f"{tag}: f within 1e-15 relative")
        worst = max(max(rel_err(got.dfrac[:, j], want.dfrac[:, j]),
                        rel_err(got.df[:, j], want.df[:, j])) for j in range(len(lanes)))
        check(worst <= tan_tol, f"{tag}: tangents within {tan_tol:g} relative ({worst:.3g})")
        stats[shape] = {"max_abs_err": dt, "tangent_rel_err": worst}
    return stats


def phase_k2(model, tensor, params_b, free, w, device):
    import torch

    from pint_tpu_torch.gridutils import _RIDGE, _time_resids_design, normal_eq, normal_eq_plain

    r, M = _time_resids_design(model, params_b, tensor, free)
    got = normal_eq(r, M, w, _RIDGE, True)
    want = normal_eq_plain(r, M, w, _RIDGE, True)
    sync(device)
    errs = {}
    for name, g, wv in zip(("G", "c", "chi2", "norm"), got, want):
        errs[name] = max(rel_err(g[b], wv[b]) for b in range(r.shape[0]))
        check(errs[name] <= 1e-12, f"K2 {name} within 1e-12 relative per point ({errs[name]:.3g})")
    chi_abs = float(torch.max(torch.abs(got[2] - want[2])))
    return r, M, chi_abs


# --- phases 6-7: the main path -------------------------------------------------------


def fresh_fitter(tensor, device, flagship: bool = False):
    """A fitter on `tensor`, its model moved off the solution by the start
    shift: DownhillWLSFitter on SMOKE_PAR, or DownhillGLSFitter on the
    flagship par."""
    import torch

    from pint_tpu_torch.fitting import DownhillGLSFitter, DownhillWLSFitter
    from pint_tpu_torch.fitting.wls import apply_delta
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import FLAGSHIP_SMOKE_PAR, SMOKE_PAR

    par, cls, shift = ((FLAGSHIP_SMOKE_PAR, DownhillGLSFitter, FLAGSHIP_SHIFT) if flagship
                       else (SMOKE_PAR, DownhillWLSFitter, START_SHIFT))
    model = get_model(par, from_text=True, device=device)
    free = tuple(model.free_params)
    delta = torch.tensor([shift.get(n, 0.0) for n in free], dtype=torch.float64,
                         device=device)
    model.params = apply_delta(model.params, free, delta)
    return cls(tensor, model)


def counters():
    from pint_tpu_torch.fitting.woodbury import ecorr_normal_eq
    from pint_tpu_torch.gridutils import normal_eq
    from pint_tpu_torch.ops.dd import dd_elementwise
    from pint_tpu_torch.residuals import resid_tangent

    return {"dd_elementwise": dd_elementwise, "resid_tangent": resid_tangent,
            "normal_eq": normal_eq, "ecorr_normal_eq": ecorr_normal_eq}


@contextlib.contextmanager
def counted(into: dict):
    """Zero every launch counter (and K2's pass counter), run the block, and
    store the counts in `into`."""
    from pint_tpu_torch.gridutils import normal_eq

    for fn in counters().values():
        fn.launches = 0
    normal_eq.passes = 0
    yield
    into.update({k: fn.launches for k, fn in counters().items()})
    into["normal_eq_passes"] = normal_eq.passes


def run_main_path(ftr, device) -> dict:
    """Fit `ftr` (a fitter built beforehand), then the model's 3x3 grid
    around the fit (``grid_for``). Each of the two is timed on the host
    clock, ending in a synchronize, and its launch counts are read from a
    window of its own."""
    from pint_tpu_torch.gridutils import grid_chisq
    from pint_tpu_torch.profiles import grid_for

    out = {"fitter": ftr, "fit_launches": {}, "grid_launches": {}}
    with counted(out["fit_launches"]):
        t0 = time.perf_counter()
        ftr.fit_toas()
        sync(device)
        out["fit_s"] = time.perf_counter() - t0
    names, vals = grid_for(ftr.model, ftr)
    with counted(out["grid_launches"]):
        t0 = time.perf_counter()
        out["chi2"] = grid_chisq(ftr, names, vals)
        sync(device)
        out["grid_s"] = time.perf_counter() - t0
    return out


def check_fit(main: dict, twin: dict, label: str) -> None:
    """The fit gates: converged, chi^2/dof in [0.8, 1.2], params within
    1e-10 relative and 1e-6 of their uncertainty of the twin path's fit,
    uncertainties within 1e-10 relative."""
    ftr, ref = main["fitter"], twin["fitter"]
    res = ftr.result
    check(res.converged, f"{label} fit converged in {res.iterations} iterations")
    check(0.8 <= res.reduced_chi2 <= 1.2, f"{label} chi2/dof = {res.reduced_chi2:.6f} in [0.8, 1.2]")
    vals, ref_vals = ftr.values(), ref.values()
    ref_unc = ref.result.uncertainties
    worst_p = max(abs(vals[n] - ref_vals[n]) / abs(ref_vals[n]) for n in vals)
    worst_s = max(abs(vals[n] - ref_vals[n]) / ref_unc[n] for n in vals)
    worst_u = max(abs(res.uncertainties[n] - ref_unc[n]) / ref_unc[n] for n in vals)
    check(worst_p <= 1e-10, f"{label} fit params within 1e-10 relative of the twin fit "
                            f"({worst_p:.3g})")
    check(worst_s <= 1e-6, f"{label} fit params within 1e-6 of their uncertainty of the twin "
                           f"fit ({worst_s:.3g} sigma)")
    check(worst_u <= 1e-10, f"{label} uncertainties within 1e-10 relative ({worst_u:.3g})")


def check_grid(main: dict, twin: dict, label: str) -> float:
    import numpy as np

    chi2, ref_chi2 = main["chi2"], twin["chi2"]
    check(chi2.shape == (3, 3) and bool(np.all(np.isfinite(chi2))), f"{label} grid chi2 finite, 3x3")
    worst_g = float(np.max(np.abs(chi2 - ref_chi2) / np.abs(ref_chi2)))
    check(worst_g <= 1e-10, f"{label} grid chi2 within 1e-10 relative of the twin path "
                            f"({worst_g:.3g})")
    return worst_g


def profile_main_path(tensor, device, flagship: bool = False) -> dict:
    """The wall of one warm fit + grid without the profiler, then device time
    by kernel over one more under torch.profiler (CUDA activity only).
    `busy_share` is that summed kernel time over the unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plain = run_main_path(fresh_fitter(tensor, device, flagship), device)
    wall = plain["fit_s"] + plain["grid_s"]
    ftr = fresh_fitter(tensor, device, flagship)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_main_path(ftr, device)
        profiled_wall = time.perf_counter() - t0
    kern = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(us for _, us, _ in kern) / 1e6
    return {"warm_fit_s": plain["fit_s"], "warm_grid_s": plain["grid_s"], "wall_s": wall,
            "warm_fit_launches": plain["fit_launches"],
            "warm_grid_launches": plain["grid_launches"],
            "profiled_wall_s": profiled_wall, "device_busy_s": busy, "busy_share": busy / wall,
            "kernel_s": {k: sum(us for name, us, _ in kern if pat in name) / 1e6
                         for k, pat in KERNEL_PATTERNS.items()},
            "top": [[name[:70], us / 1e6, n] for name, us, n in sorted(kern, key=lambda r: -r[1])[:8]]}


# --- the kernels record ----------------------------------------------------------------

# substrings of the kernels' names in a profile (K2 and K3 are three passes)
K0_KERNEL, K1_KERNEL, K2_KERNEL, K3_KERNEL = ("dd_elementwise_kernel", "resid_tangent_kernel",
                                              "pass_", "_pass<")
KERNEL_PATTERNS = {"dd_elementwise": K0_KERNEL, "resid_tangent": K1_KERNEL,
                   "normal_eq": K2_KERNEL, "ecorr_normal_eq": K3_KERNEL}


def k0_record(model, device) -> dict:
    """K0 at the fit's parameter update: add_fp of a float64 step into the
    (F0, F1) dd pair, shape (2,)."""
    import torch

    from pint_tpu_torch.ops.dd import DD, dd_elementwise, dd_elementwise_plain

    dd_free = [n for n in model.free_params if isinstance(model.params[n], DD)]
    x = DD(torch.stack([model.params[n].hi for n in dd_free]),
           torch.stack([model.params[n].lo for n in dd_free]))
    y = torch.tensor([START_SHIFT.get(n, 1e-20) for n in dd_free], dtype=torch.float64,
                     device=device)
    ms, call = measure(lambda: dd_elementwise("add_fp", x, y), device, 200, K0_KERNEL)
    plain, plain_call = measure(lambda: dd_elementwise_plain("add_fp", x, y), device, 200)
    m = len(dd_free)
    # per value: read hi, lo and the step, write hi and lo; two_sum (6),
    # two adds and quick_two_sum (3): 11 float64 operations
    b, how = bound_ms(m * 5 * 8, m * 11)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": None,
            "call_ms": call, "plain_call_ms": plain_call,
            "shape": f"add_fp over ({m},): {', '.join(dd_free)}"}


# K1's float64 operations per row, counted from csrc/resid_tangent.cu with
# a sin, cos or log as ~35 operations and a division as ~15: 10 sin/cos,
# 1 log, 1 sqrt and ~7 divisions (~500), the dd Horner, TZR subtraction and
# rint (~200), dot products and the rest (~50); each tangent lane adds ~80.
# The ELL1 term adds 8 sin/cos and 1 log (~315), the dd orbital phase (~60)
# and ~120 dual operations of the three Roemer polynomials, the inverse
# expansion and the Shapiro term (~120 on the value, ~300 per lane).
K1_OPS_PER_ROW = 750
K1_OPS_PER_LANE = 80
K1_BIN_OPS_PER_ROW = 500
K1_BIN_OPS_PER_LANE = 300


def k1_record(model, tensor, params, lanes, device, reps: int) -> dict:
    from pint_tpu_torch.residuals import resid_tangent, resid_tangent_plain

    B = params["F0"].hi.shape[0] if params["F0"].hi.dim() else 1
    rows = tensor["t_hi"].shape[0]
    n = rows - 1
    ms, call = measure(lambda: resid_tangent(model, params, tensor, lanes), device, reps,
                       K1_KERNEL)
    plain, plain_call = measure(lambda: resid_tangent_plain(model, params, tensor, lanes),
                                device, max(1, reps // 20))
    k = len(lanes)
    binary = "BinaryELL1" in model
    n_bytes = rows * 12 * 8 + B * (P_ROW_LEN + 2 * model["Spindown"].num_terms) * 8 \
        + B * n * (3 + 2 * k) * 8
    # the N TOA rows and the TZR row once per parameter set (the kernel's
    # per-block recompute of the TZR row and each lane chunk's recompute of
    # the primal are its own cost, not needed work)
    per_row = K1_OPS_PER_ROW + (K1_BIN_OPS_PER_ROW if binary else 0)
    per_lane = K1_OPS_PER_LANE + (K1_BIN_OPS_PER_LANE if binary else 0)
    n_ops = B * rows * (per_row + per_lane * k)
    b, how = bound_ms(n_bytes, n_ops)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": None,
            "call_ms": call, "plain_call_ms": plain_call,
            "shape": f"B={B} N={n} lanes={len(lanes)}"}


def k2_record(r, M, w, device) -> dict:
    import torch

    from pint_tpu_torch.gridutils import _RIDGE, normal_eq, normal_eq_plain

    B, p, n = M.shape
    ms, call = measure(lambda: normal_eq(r, M, w, _RIDGE, True), device, 200, K2_KERNEL)
    plain, plain_call = measure(lambda: normal_eq_plain(r, M, w, _RIDGE, True), device, 50)
    A = (M * torch.sqrt(w)).transpose(-1, -2).contiguous()  # (B, N, p)
    lib, lib_call = measure(lambda: torch.matmul(A.transpose(-1, -2), A), device, 200)
    n_bytes = (B * n * (p + 1) + n) * 8 + B * (p * p + 2 * p + 1) * 8
    n_ops = B * n * (p * p + 8 * p + 7)
    b, how = bound_ms(n_bytes, n_ops)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": lib,
            "call_ms": call, "plain_call_ms": plain_call, "library_call_ms": lib_call,
            "shape": f"B={B} N={n} p={p}"}


# parameter row of K1 before the DM and F terms (resid_tangent.cu P_DM0)
P_ROW_LEN = 25


def k3_record(r, M, w, basis, ridge, centre, weighted_norm, device) -> dict:
    """K3 at one of the flagship shapes; the library yardstick is the batched
    cuBLAS Gram (Mn sqrt(w)) (Mn sqrt(w))^T alone, on the twin's Mn."""
    import torch

    from pint_tpu_torch.fitting.woodbury import (_step_inputs, ecorr_normal_eq,
                                                 ecorr_normal_eq_plain)

    args = (r, M, w, basis, ridge, centre, weighted_norm)
    B, p, n = M.shape
    ms, call = measure(lambda: ecorr_normal_eq(*args), device, 200, K3_KERNEL)
    plain, plain_call = measure(lambda: ecorr_normal_eq_plain(*args), device, 10)
    A = (_step_inputs(r, M, w, centre, weighted_norm)[1] * torch.sqrt(w)).contiguous()
    lib, lib_call = measure(lambda: torch.matmul(A, A.transpose(-1, -2)), device, 200)
    ke, nnz = basis.ke, basis.epochs.rows.shape[0]
    q = (p + 1) * (p + 2) // 2
    # read r, M, w, phi and the CSR once; write G, c, chi2, ahat, norm
    n_bytes = (B * n * (p + 1) + n + ke) * 8 + (ke + 1 + nnz) * 4 \
        + B * (p * p + 2 * p + 1 + ke) * 8
    # the step inputs: the weighted means (2 per value of r and M, when
    # centring), the column norms (3 per value of M), each value centred and
    # divided (2); then the augmented Gram over rows (2 multiplies, 1 add per
    # entry), the epoch sums (2 per column and row), the epoch correction (2
    # multiplies, 1 add and 1 division per entry) and 1/phi, De and ahat
    n_ops = B * (n * (p + 1) * (2 * int(centre) + 2) + n * p * 3 + n * 3 * q
                 + nnz * 2 * (p + 2) + ke * (4 * q + 3))
    b, how = bound_ms(n_bytes, n_ops)
    return {"ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": how, "library_ms": lib,
            "call_ms": call, "plain_call_ms": plain_call, "library_call_ms": lib_call,
            "shape": f"B={B} N={n} p={p} ke={ke}"}


def phase_k3(model, tensor, ftr, params_b, grid_free, device) -> dict:
    """K3 against its twin on the GLS step's raw design (B = 1) and the
    grid's first step (B = 9), and on the chi^2 calls of each (no columns),
    and bitwise against itself on a second run."""
    import torch

    from pint_tpu_torch.fitting.gls import _RIDGE as GLS_RIDGE
    from pint_tpu_torch.fitting.wls import time_resid_design
    from pint_tpu_torch.fitting.woodbury import ecorr_normal_eq, ecorr_normal_eq_plain
    from pint_tpu_torch.gridutils import _RIDGE, _time_resids_design

    res = ftr.resids
    basis = model.noise_basis_and_weights(model.params, tensor)
    w = 1.0 / res.errors_s**2
    r0, M = time_resid_design(model, tuple(model.free_params), model.params, tensor,
                              res.weights, True, hybrid=False)
    r, Mg = _time_resids_design(model, params_b, tensor, grid_free)
    inputs = {"fit": (r0[None], M.T[None].contiguous(), w, basis, GLS_RIDGE, False, False),
              "grid": (r, Mg, w, basis, _RIDGE, True, True),
              "fit chi2": (r0[None], r0.new_zeros((1, 0, r0.shape[0])), w, basis, 0.0, False,
                           False),
              "grid chi2": (r, r.new_zeros((r.shape[0], 0, r.shape[1])), w, basis, 0.0, True,
                            False)}
    out = {}
    for label, args in inputs.items():
        got = ecorr_normal_eq(*args)
        again = ecorr_normal_eq(*args)
        want = ecorr_normal_eq_plain(*args)
        sync(device)
        B, p = args[1].shape[:2]
        tag = f"K3 {label} (B={B}, p={p})"
        for name, g, wv in zip(("G", "c", "chi2", "ahat", "norm"), got, want):
            err = max(rel_err(g[b], wv[b]) for b in range(B))
            check(err <= 1e-12, f"{tag}: {name} within 1e-12 relative per set ({err:.3g})")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{tag}: bitwise equal across two runs")
        out[label] = {"args": args, "chi2_abs_err": float(torch.max(torch.abs(got[2] - want[2])))}
    return out


KERNELS = (
    ("dd_elementwise", "pint_tpu_torch/csrc/dd_elementwise.cu",
     "pint_tpu/ops/dd.py:142 (dd_add..dd_rint, inlined in every TPU program)"),
    ("resid_tangent", "pint_tpu_torch/csrc/resid_tangent.cu",
     "pint_tpu/residuals.py:90 (resid) + pint_tpu/fitting/wls.py:180 (design jvp)"),
    ("normal_eq", "pint_tpu_torch/csrc/normal_eq.cu",
     "pint_tpu/gridutils.py:132 (gn_step normal equations, grid program)"),
    ("ecorr_normal_eq", "pint_tpu_torch/csrc/ecorr_normal_eq.cu",
     "pint_tpu/fitting/gls.py:77 (gls_step Woodbury pieces) + gls.py:193 (gls_chi2) + "
     "pint_tpu/gridutils.py:132-170 (correlated grid step: centring, equilibration, Woodbury "
     "normal equations, chi2), algebra of fitting/woodbury.py:79-218"),
)


def smoke_phases(device, summary: dict) -> dict:
    """Phases 3-8 (SMOKE_PAR, the WLS path); returns the kernel records and
    the launch counts of its fit and grid windows."""
    from pint_tpu_torch.fitting.design import linear_split
    from pint_tpu_torch.prepared import load_prepared

    print("phase 3: K0 dd_elementwise against the dd twins")
    phase_k0(device)

    print("phase 4: K1 resid_tangent against its twin")
    tensor = load_prepared(device=device)
    start = fresh_fitter(tensor, device)
    model = start.model
    fit_lanes = linear_split(model, tuple(model.free_params))[0]
    names, _, params_b = grid_params(model, start)
    grid_free = tuple(n for n in model.free_params if n not in names)
    grid_lanes = linear_split(model, grid_free)[0]
    k1_stats = phase_k1(model, tensor, params_b, fit_lanes, grid_lanes, device, 1e-10)

    print("phase 5: K2 normal_eq against its twin")
    w = 1.0 / start.resids.errors_s**2
    r, M, k2_err = phase_k2(model, tensor, params_b, grid_free, w, device)

    print("phase 6: DownhillWLSFitter.fit_toas")
    main = run_main_path(fresh_fitter(tensor, device), device)
    fit_l, grid_l = main["fit_launches"], main["grid_launches"]
    for name in ("dd_elementwise", "resid_tangent"):
        check(fit_l[name] > 0, f"{name} launched {fit_l[name]} times by fit_toas")
    with twins():
        twin = run_main_path(fresh_fitter(tensor, device), device)
    check_fit(main, twin, "SMOKE")

    print("phase 7: grid_chisq 3x3 (F0, F1)")
    import numpy as np

    check_grid(main, twin, "SMOKE")
    check(int(np.argmin(main["chi2"])) == 4, "SMOKE grid chi2 minimum at the centre point")
    for name in ("resid_tangent", "normal_eq"):
        check(grid_l[name] > 0, f"{name} launched {grid_l[name]} times by grid_chisq")
    print(f"  grid_chisq launched dd_elementwise {grid_l['dd_elementwise']} times "
          "(its refitted parameters are plain float64)")

    print("timing kernels against their twins")
    recs = {
        "dd_elementwise": k0_record(model, device),
        "resid_tangent": k1_record(model, tensor, params_b, grid_lanes, device, 50),
        "normal_eq": k2_record(r, M, w, device),
    }
    fit_shape = k1_record(model, tensor, model.params, fit_lanes, device, 50)
    recs["resid_tangent"].update({f"fit_{k}": v for k, v in fit_shape.items()
                                  if k in ("ms", "call_ms", "plain_ms", "bound_ms", "shape")})
    recs["normal_eq"].update(kernel_passes_fit=fit_l["normal_eq_passes"],
                             kernel_passes_grid=grid_l["normal_eq_passes"])
    if device.type == "cuda":
        print("phase 8: where the time goes (one warm fit + grid, then torch.profiler)")
        summary["profile"] = profile_main_path(tensor, device)
    res = main["fitter"].result
    summary.update({"fit_wall_s": main["fit_s"], "grid_wall_s": main["grid_s"],
                    "fit_iterations": res.iterations, "fit_chi2_reduced": res.reduced_chi2,
                    "grid_chi2": main["chi2"].tolist(),
                    "ntoas": int(tensor["t_hi"].shape[0] - 1)})
    errs = {"dd_elementwise": 0.0, "resid_tangent": k1_stats["grid"]["max_abs_err"],
            "normal_eq": k2_err}
    return {"recs": recs, "errs": errs, "fit": fit_l, "grid": grid_l}


def flagship_phases(device, summary: dict) -> dict:
    """Phases 9-13 (the flagship par, the GLS path)."""
    import numpy as np

    from pint_tpu_torch.fitting.design import linear_split
    from pint_tpu_torch.prepared import FLAGSHIP_ARCHIVE, load_prepared

    print("phase 9: K1 with the ELL1 term against its twin (flagship)")
    tensor = load_prepared(FLAGSHIP_ARCHIVE, device=device)
    start = fresh_fitter(tensor, device, flagship=True)
    model = start.model
    free = tuple(model.free_params)
    names, _, params_b = grid_params(model, start)
    grid_free = tuple(n for n in free if n not in names)
    grid_lanes = linear_split(model, grid_free)[0]
    check(len(free) == 14 and len(grid_lanes) == 12,
          f"flagship: {len(free)} free parameters, {len(grid_lanes)} grid lanes")
    k1_stats = phase_k1(model, tensor, params_b, free, grid_lanes, device, 1e-12, "flagship ")

    print("phase 10: K3 ecorr_normal_eq against its twin")
    k3 = phase_k3(model, tensor, start, params_b, grid_free, device)

    print("phase 11: DownhillGLSFitter.fit_toas (flagship)")
    main = run_main_path(fresh_fitter(tensor, device, flagship=True), device)
    fit_l, grid_l = main["fit_launches"], main["grid_launches"]
    for name in ("dd_elementwise", "resid_tangent", "ecorr_normal_eq"):
        check(fit_l[name] > 0, f"{name} launched {fit_l[name]} times by the GLS fit_toas")
    with twins():
        twin = run_main_path(fresh_fitter(tensor, device, flagship=True), device)
    check_fit(main, twin, "flagship GLS")

    print("phase 12: grid_chisq 3x3 (M2, SINI), GLS statistic")
    worst_g = check_grid(main, twin, "flagship")
    for name in ("dd_elementwise", "resid_tangent", "ecorr_normal_eq"):
        check(grid_l[name] > 0, f"{name} launched {grid_l[name]} times by the GLS grid_chisq")

    print("phase 13: flagship kernel times, warm wall and busy share")
    recs = {
        "resid_tangent": {
            f"flagship_{shape}_{k}": v
            for shape, params, lanes in (("fit", model.params, free),
                                         ("grid", params_b, grid_lanes))
            for k, v in k1_record(model, tensor, params, lanes, device, 20).items()
            if k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "shape")},
        "ecorr_normal_eq": k3_record(*k3["grid"]["args"], device),
    }
    fit3 = k3_record(*k3["fit"]["args"], device)
    recs["ecorr_normal_eq"].update({f"fit_{k}": v for k, v in fit3.items()
                                    if k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "shape")})
    if device.type == "cuda":
        summary["flagship_profile"] = profile_main_path(tensor, device, flagship=True)
    res = main["fitter"].result
    summary["flagship"] = {
        "fit_wall_s": main["fit_s"], "grid_wall_s": main["grid_s"],
        "fit_iterations": res.iterations, "fit_chi2_reduced": res.reduced_chi2,
        "grid_chi2": main["chi2"].tolist(), "grid_rel_err": worst_g,
        "ntoas": int(tensor["t_hi"].shape[0] - 1),
        "epochs": int(model.noise_basis_and_weights(model.params, tensor).ke),
        "free": list(free)}
    errs = {"resid_tangent": max(s["max_abs_err"] for s in k1_stats.values()),
            "ecorr_normal_eq": max(v["chi2_abs_err"] for v in k3.values())}
    return {"recs": recs, "errs": errs, "fit": fit_l, "grid": grid_l}


def phases(device_name: str = "cuda") -> dict:
    """Phases 2-13 on `device_name`; returns the summary record."""
    from pint_tpu_torch.device import resolve_device
    from pint_tpu_torch.ops import build

    device = resolve_device(device_name)
    summary = {}
    if device.type == "cuda":
        print("phase 2: build kernels")
        summary["build_s"] = build.build_all()
        print(f"  built in {summary['build_s']:.2f} s into {build.build_dir()}")
        summary["ptxas"], summary["ptxas_instances"] = {}, {}
        for name in build.SOURCES:
            summary["ptxas"][name] = build.ptxas_summary(name)
            summary["ptxas_instances"][name] = build.ptxas_report(name)
            print(f"  {name}: {summary['ptxas'][name]}")
        for fn, (regs, spill) in summary["ptxas_instances"]["resid_tangent"].items():
            print(f"    {fn}: {regs} registers, {spill} bytes of spill stores")
    smoke = smoke_phases(device, summary)
    flag = flagship_phases(device, summary)
    windows = {"smoke_fit": smoke["fit"], "smoke_grid": smoke["grid"],
               "flagship_fit": flag["fit"], "flagship_grid": flag["grid"]}
    kernels = []
    for name, src, replaces in KERNELS:
        rec = {**smoke["recs"].get(name, {}), **flag["recs"].get(name, {})}
        err = max(smoke["errs"].get(name, 0.0), flag["errs"].get(name, 0.0))
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(w[name] for w in windows.values()),
                        **{f"launches_{k}": w[name] for k, w in windows.items()},
                        "max_abs_err": err, **rec})
    summary["kernels"] = kernels
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "pint_tpu_torch").is_dir():
        print(f"chip_smoke: {REPO} holds no pint_tpu_torch package", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    print("phase 1: device")
    dev_line = device_line()
    print(dev_line)
    summary = phases("cuda")
    kernels = summary.pop("kernels")
    print(json.dumps({"summary": summary}))
    print(json.dumps({"kernels": kernels}))
    print(dev_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

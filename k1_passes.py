#!/usr/bin/env python3
"""Kernel K1 (``pint_tpu_torch/csrc/resid_tangent.cu``) pass by pass on one
card, and beside an earlier K1 source.

    python3 k1_passes.py [--old SRC] [--reps N] [--shapes a,b,...] [--widths 1,2,4]
                         [--min-blocks 3,2] [--old-bounds 1,none] [--logs DIR]

Builds the port's kernels as the port builds them (``ops.build``: K1, and K4
and K5 for the prepares) and, with ``--old``, another ``resid_tangent.cu``
(an earlier version with one pass and its lanes in chunks of 8, whose
outputs are (B, slots, N)) with the port's nvcc flags; prints each K1
library's ptxas registers and spill bytes per instance and nvcc's seconds.
Then, at the main path's K1 shapes from the in-repo fixtures (SMOKE fit and
grid, the flagship's, DD's, NANOGrav's and the slice-7 forms' fits and
grids, the wideband fit, the noise design's 80 lanes at the fitted point)
and a NANOGrav-shaped case whose one-hot puts one row in two windows, one in
none and the TZR row in a window, it holds every output of the port's K1
against the old one's (``torch.equal``) and against a second call of itself
(bitwise), and times, in turn (new, old, old, new), each pass
(torch.profiler, one call a profile, the median), the whole call by CUDA
events behind a busy queue (``chip_smoke.queued_ms``) and back to back, the
host's enqueue included (``chip_smoke.timed_ms``). Copies of the port's
source built beside it are also timed and held bitwise to the old: with
``--widths``, one per lane width, its ``k1_plan.h`` taking that many lanes
a thread (``DEFAULT_WIDTH``); with ``--min-blocks``, one per minimum of
blocks an SM of its lane pass (``LANE_MIN_BLOCKS``: 4 is 128 registers a
thread, 3 is 168, 2 is 255). With ``--old-bounds`` copies
of the old source are built for their ptxas report alone: its kernel's
``__launch_bounds__(THREADS)`` given a minimum of v blocks an SM, or taken
out (``none``). ``--logs DIR`` keeps every build's nvcc log there. One JSON
line per shape. Needs a CUDA card.

    python3 k1_passes.py --tape-guard

builds, alone, a copy of the port's source whose ``k1_plan.h`` counts one
tape slot fewer than the chain stores and calls it at the SMOKE fit: the
primal pass's check of the count must fail the call. It prints one JSON line
and exits 0 when the call failed. The failure ends the process's CUDA
context, so it runs in a process of its own.

    git show <commit>:pint_tpu_torch/csrc/resid_tangent.cu > old/resid_tangent.cu
    python3 k1_passes.py --old old/resid_tangent.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

#: the passes' names in a profile
PATTERNS = {"new": ("resid_primal", "resid_tzr", "resid_lanes", "resid_finalize"),
            "old": ("resid_tangent_kernel",)}


def load_old(path: Path):
    """An earlier K1 library: one pass, no scratch, its tangents in whole
    chunks of its lane width."""
    lib = ctypes.CDLL(str(path))
    lib.pint_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pint_cuda_error_string.restype = ctypes.c_char_p
    p = ctypes.c_void_p
    lib.resid_tangent.argtypes = [p] * 13 + [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                             ctypes.POINTER(ctypes.c_double)] + [p] * 7
    lib.resid_tangent.restype = ctypes.c_int
    return lib


def old_slots(k: int) -> int:
    """The earlier K1's tangent rows: k rounded up to whole chunks of 2 (k
    <= 2), 4 (k <= 4) or 8."""
    w = 0 if k == 0 else 2 if k <= 2 else 4 if k <= 4 else 8
    return w * -(-k // w) if w else 0


def old_call(lib, model, params, tensor, lanes):
    """The earlier K1 on the same inputs as ``residuals._launch_k1``, with
    the port's integer arguments."""
    import torch

    from pint_tpu_torch import AU_LS, DMCONST, TSUN_S
    from pint_tpu_torch import residuals as rs
    from pint_tpu_torch.models.astrometry import COS_OBL, SIN_OBL
    from pint_tpu_torch.ops import build

    dev = tensor["t_hi"].device
    setup = rs._k1_setup(model, tuple(lanes))
    st, k = setup.st, len(lanes)
    rows = [tensor[key].contiguous() for key in rs._ROW_KEYS]
    n_rows = rows[0].shape[0]
    has_tzr = model.has_abs_phase
    n_out = n_rows - int(has_tzr)
    B = rs.batch_size(params)
    P = rs._pack_params(model, params, B, st, dev)
    ng = rs._nanograv_columns(model, params, tensor, B, st, setup)
    dpn, track = rs.pulse_columns(model, tensor)
    none = torch.zeros(1, dtype=torch.float64, device=dev)
    pulse = [none if t is None else t.contiguous() for t in (dpn, track)]
    ints = rs._k1_ints(st, setup.codes, n_rows, n_out, has_tzr, dpn is not None,
                       track is not None)
    slots = old_slots(k)
    out = [torch.empty((B, n_out), dtype=torch.float64, device=dev) for _ in range(3)]
    tan = [torch.empty((B, slots, n_out), dtype=torch.float64, device=dev) for _ in range(2)]
    fb = torch.empty((B, n_rows), dtype=torch.float64, device=dev)
    consts = (ctypes.c_double * 5)(AU_LS, DMCONST, TSUN_S, COS_OBL, SIN_OBL)
    build.check(lib, lib.resid_tangent(
        *[t.data_ptr() for t in rows], *[t.data_ptr() for t in ng],
        *[t.data_ptr() for t in pulse], P.data_ptr(), B, ints, consts,
        *[o.data_ptr() for o in out], *[t.data_ptr() for t in tan], fb.data_ptr(),
        build.stream_of(P)))
    return rs.ResidTangent(*out, tan[0][:, :k], tan[1][:, :k], fb)


MIN_BLOCKS = "constexpr int LANE_MIN_BLOCKS = 4;"
WIDTH = "constexpr int DEFAULT_WIDTH = 2;"
#: k1_plan.h's first tape count, the row's phase
TAPE_PHASE = "int n = 2;                      // the phase"
#: the old kernel's launch bounds
OLD_BOUNDS = "__launch_bounds__(THREADS)\nresid_tangent_kernel"


def load_port(path: Path):
    """A library with the port's K1 interface."""
    from pint_tpu_torch import residuals as rs

    lib = ctypes.CDLL(str(path))
    lib.pint_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pint_cuda_error_string.restype = ctypes.c_char_p
    rs._declare_k1(lib)
    return lib


def variant(texts: dict, name: str, find: str, put: str, tag: str) -> Path:
    """Copies of the sources `texts` ({file name: text}) under
    build/k1_passes/<tag>/, file `name`'s with `find` replaced by `put`;
    the copy of resid_tangent.cu. Its quoted includes find the copies
    first."""
    if find not in texts[name]:
        raise SystemExit(f"{name} holds no `{find}`")
    out = REPO / "build" / "k1_passes" / tag
    out.mkdir(parents=True, exist_ok=True)
    for file, text in texts.items():
        (out / file).write_text(text.replace(find, put) if file == name else text)
    return out / "resid_tangent.cu"


def build_all(old: str | None, min_blocks=(), widths=(), old_bounds=(),
              logs: str | None = None) -> dict:
    """{tag: library}: "new", the port's K1 (with every other source of
    ``ops.build``, which the prepares need), "old", `old` built with the
    port's nvcc flags, "min_blocks=v" for each v of `min_blocks`, the
    port's source with its lane pass's LANE_MIN_BLOCKS set to v, "width=w"
    for each w of `widths`, the port's source with k1_plan.h's DEFAULT_WIDTH
    set to w, and "old bounds=v" for each v of `old_bounds`, all in
    parallel; prints each K1 library's ptxas report and the seconds of the
    builds (nvcc's for the port's K1 alone among them)."""
    import shutil

    import k3_passes as kp
    from pint_tpu_torch import residuals as rs
    from pint_tpu_torch.ops import build

    t0 = time.perf_counter()
    jobs = {"old": (Path(old), load_old, *kp.start_build(old, "k1_old"))} if old else {}
    port = {f: (build.CSRC / f).read_text() for f in ("resid_tangent.cu", "k1_plan.h")}
    for v in min_blocks:
        path = variant(port, "resid_tangent.cu", MIN_BLOCKS,
                       f"constexpr int LANE_MIN_BLOCKS = {v};", f"mb{v}")
        jobs[f"min_blocks={v}"] = (path, load_port, *kp.start_build(path, f"k1_mb{v}"))
    for w in widths:
        path = variant(port, "k1_plan.h", WIDTH, f"constexpr int DEFAULT_WIDTH = {w};", f"w{w}")
        jobs[f"width={w}"] = (path, load_port, *kp.start_build(path, f"k1_w{w}"))
    for v in old_bounds if old else ():
        put = "resid_tangent_kernel" if v == "none" else \
            f"__launch_bounds__(THREADS, {int(v)})\nresid_tangent_kernel"
        path = variant({"resid_tangent.cu": Path(old).read_text()}, "resid_tangent.cu",
                       OLD_BOUNDS, put, f"old_bounds_{v}")
        jobs[f"old bounds={v}"] = (path, None, *kp.start_build(path, f"k1_old_bounds_{v}"))
    port_s = build.build_all()
    libs = {"new": build.library("resid_tangent", rs._declare_k1)}
    reports = {"new": build.ptxas_report("resid_tangent")}
    logs_of = {"new": build.build_dir() / "resid_tangent.log"}
    for tag, (path, load, proc, lib, log) in jobs.items():
        kp.finish_build(proc, path, log)
        if load is not None:
            libs[tag] = load(lib)
        reports[tag] = build.ptxas_report("resid_tangent", log)
        logs_of[tag] = log
    if logs:
        Path(logs).mkdir(parents=True, exist_ok=True)
        for tag, log in logs_of.items():
            shutil.copy(log, Path(logs) / f"{tag.replace(' ', '_').replace('=', '')}.log")
    print(json.dumps({"build_s": {"port_all_sources": port_s,
                                  "port_k1_nvcc": build.NVCC_SECONDS.get("resid_tangent"),
                                  "with_others": time.perf_counter() - t0}}))
    for tag, rep in reports.items():
        print(json.dumps({"ptxas": tag, "instances": {f: {"registers": r, "spill_bytes": s}
                                                      for f, (r, s) in sorted(rep.items())}}))
    return libs


def tape_guard(device) -> int:
    """`--tape-guard`: 0 when a K1 whose plan counts one tape slot fewer than
    its chain stores fails its call at the SMOKE fit."""
    import torch

    import chip_smoke as cs
    import k3_passes as kp
    from pint_tpu_torch import prepared
    from pint_tpu_torch import residuals as rs
    from pint_tpu_torch.fitting.design import linear_split
    from pint_tpu_torch.ops import build

    port = {f: (build.CSRC / f).read_text() for f in ("resid_tangent.cu", "k1_plan.h")}
    path = variant(port, "k1_plan.h", TAPE_PHASE, TAPE_PHASE.replace("n = 2", "n = 1"),
                   "tape_guard")
    proc, lib, log = kp.start_build(path, "k1_tape_guard")
    kp.finish_build(proc, path, log)
    short = load_port(lib)
    tensor = prepared.load_prepared(device=device)
    model = cs.fresh_fitter(tensor, device).model
    lanes = linear_split(model, tuple(model.free_params))[0]
    build.library = lambda name, declare: short
    try:
        rs._launch_k1(model, model.params, tensor, lanes)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(json.dumps({"tape_guard": "the call failed", "error": str(e).splitlines()[0]}))
        return 0
    print(json.dumps({"tape_guard": "the call returned"}))
    return 1


def overlap_tensor(tensor):
    """A copy of a NANOGrav tensor whose one-hot puts row 3 also in window
    5, row 7 in no window and the TZR row (the last) in window 0."""
    oh = tensor["dmx_onehot"].clone()
    oh[3, 5] = 1.0
    oh[7] = 0.0
    oh[-1] = 0.0
    oh[-1, 0] = 1.0
    return {**tensor, "dmx_onehot": oh}


def shapes(device, names, tmp: Path):
    """(label, model, params, tensor, lanes) of the main path's K1 calls on
    the in-repo fixtures, as ``chip_smoke.py`` makes them (the fits from
    their shifted starts, the grids at their 9 points)."""
    import chip_smoke as cs
    from pint_tpu_torch import prepared
    from pint_tpu_torch import profiles as pr
    from pint_tpu_torch.fitting.design import linear_split
    from pint_tpu_torch.residuals import lane_names

    def want(label):
        return not names or any(nm in label for nm in names)

    def fit_and_grid(tag, tensor, key, par=None, lanes_of=None):
        start = cs.fresh_fitter(tensor, device, key, par)
        model = start.model
        free = tuple(model.free_params)
        names_g, _, params_b = cs.grid_params(model, start) if key != "wideband" else (
            (), None, None)
        fit_lanes = lanes_of(model, free) if lanes_of else linear_split(model, free)[0]
        out = [(f"{tag} fit", model, model.params, tensor, fit_lanes)]
        if params_b is not None:
            grid_lanes = linear_split(model, tuple(n for n in free if n not in names_g))[0]
            out.append((f"{tag} grid", model, params_b, tensor, grid_lanes))
        return out

    def every(model, free):
        return lane_names(free, model)

    table = [("smoke", lambda: fit_and_grid("smoke", prepared.load_prepared(device=device),
                                            "smoke")),
             ("flagship", lambda: fit_and_grid(
                 "flagship", prepared.load_prepared(prepared.FLAGSHIP_ARCHIVE, device=device),
                 "flagship", lanes_of=every))]
    tims = [("dd", prepared.DD_TIM, pr.DD_SMOKE_PAR, "dd", None),
            ("nanograv", prepared.NANOGRAV_TIM, pr.NANOGRAV_SMOKE_PAR, "nanograv", every),
            ("wideband", prepared.WIDEBAND_TIM, pr.WIDEBAND_SMOKE_PAR, "wideband", every)]
    tims += [(form, tim, par, key or "ell1h", None)
             for form, (tim, par, key) in cs.binary_forms().items()]
    for tag, tim, par, key, lanes_of in tims:
        table.append((tag, lambda tim=tim, par=par, tag=tag, key=key, lanes_of=lanes_of:
                      fit_and_grid(tag, cs.flagship_tim_path(device, tmp, tim, par)["tensor"],
                                   key, par, lanes_of)))
    for tag, make in table:
        if not any(want(f"{tag} {s}") for s in ("fit", "grid", "noise", "overlap")):
            continue
        with cs.knobs(PINT_TPU_NBODY="0", PINT_TPU_EPHEM=None, PINT_TPU_KERNEL_EPHEM=None):
            calls = make()
        for label, model, params, tensor, lanes in calls:
            if want(label):
                yield label, model, params, tensor, lanes
        if tag == "nanograv":
            _, model, _, tensor, lanes = calls[0]
            free = every(model, tuple(model.free_params))
            from pint_tpu_torch.models import get_model

            fitted = get_model(pr.NANOGRAV_SMOKE_PAR, from_text=True, device=device)
            if want("nanograv noise design"):
                yield "nanograv noise design", fitted, fitted.params, tensor, free
            if want("nanograv overlap"):
                yield "nanograv overlap fit", fitted, fitted.params, overlap_tensor(tensor), free


def outputs(rt):
    return tuple(getattr(rt, f) for f in rt._fields)


def same(a, b) -> bool:
    return all(x.shape == y.shape and torch_equal(x, y) for x, y in zip(a, b))


def torch_equal(x, y) -> bool:
    import torch

    return bool(torch.equal(x, y))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="an earlier resid_tangent.cu to build and time beside")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", default="", help="comma-separated substrings of shape labels")
    ap.add_argument("--widths", default="",
                    help="comma-separated lane widths of source copies to time too")
    ap.add_argument("--min-blocks", default="",
                    help="comma-separated LANE_MIN_BLOCKS of source copies to time too")
    ap.add_argument("--old-bounds", default="",
                    help="comma-separated minimum blocks (or none) of the old kernel's bounds "
                         "in copies built for their ptxas report")
    ap.add_argument("--logs", help="a directory for the builds' nvcc logs")
    ap.add_argument("--tape-guard", action="store_true",
                    help="check, alone, that a tape count short by one fails the call")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_passes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if opt.tape_guard:
        return tape_guard(torch.device("cuda:0"))
    import chip_smoke as cs
    from pint_tpu_torch import residuals as rs
    from pint_tpu_torch.ops import build

    print(cs.device_line())
    min_blocks = [int(v) for v in opt.min_blocks.split(",") if v]
    widths = [int(w) for w in opt.widths.split(",") if w]
    libs = build_all(opt.old, min_blocks, widths, [v for v in opt.old_bounds.split(",") if v],
                     opt.logs)
    variants = [f"min_blocks={v}" for v in min_blocks] + [f"width={w}" for w in widths]
    order = [t for t in ("new", "old") if t in libs]
    device = torch.device("cuda:0")
    port_library = build.library
    names = [s for s in opt.shapes.split(",") if s]
    with tempfile.TemporaryDirectory() as tmpname:
        for label, model, params, tensor, lanes in shapes(device, names, Path(tmpname)):
            makers = {"new": lambda: (lambda: rs._launch_k1(model, params, tensor, lanes)),
                      "old": lambda: (lambda: old_call(libs["old"], model, params, tensor,
                                                       lanes))}
            setup = rs._k1_setup(model, tuple(lanes))
            n_rows = tensor["t_hi"].shape[0]
            B = rs.batch_size(params)
            _, plan = setup.call(libs["new"], n_rows, n_rows - int(model.has_abs_phase),
                                 model.has_abs_phase, "delta_pn" in tensor,
                                 "track_pn" in tensor, B)
            rec = {"shape": label, "B": B, "rows": n_rows, "lanes": len(lanes),
                   "plan": {"kernel_lanes": plan.n_klane, "width": plan.width,
                            "groups": plan.groups, "tape_slots": plan.n_slots,
                            "scratch_bytes": plan.scratch * 8}}
            first = {}
            for tag in order + order[::-1]:
                call = makers[tag]()
                got, again = outputs(call()), outputs(call())
                torch.cuda.synchronize()
                first.setdefault(tag, got)
                r = rec.setdefault(tag, {"repeat_bitwise": True, "passes_ms": [],
                                         "queued_ms": [], "call_ms": []})
                r["repeat_bitwise"] = r["repeat_bitwise"] and same(got, again)
                r["passes_ms"].append(cs.by_kernel(call, opt.reps, PATTERNS[tag]))
                r["queued_ms"].append(cs.queued_ms(call, opt.reps))
                r["call_ms"].append(cs.timed_ms(call, device, opt.reps))
            if "old" in first:
                rec["new_bitwise_old"] = same(first["new"], first["old"])
            for tag in variants:
                build.library = lambda name, declare, lib=libs[tag]: lib
                try:
                    call = makers["new"]()
                    got = outputs(call())
                    torch.cuda.synchronize()
                    rec[tag] = {
                        "bitwise_old": same(got, first["old"]) if "old" in first else None,
                        "passes_ms": cs.by_kernel(call, opt.reps, PATTERNS["new"]),
                        "queued_ms": cs.queued_ms(call, opt.reps)}
                finally:
                    build.library = port_library
            print(json.dumps(rec), flush=True)
    print(cs.device_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Kernels K9 (``pint_tpu_torch/csrc/noise_grad.cu``) and K10
(``pint_tpu_torch/csrc/pta_grad.cu``) pass by pass on one card, and beside
their earlier sources.

    python3 grad_passes.py [--old DIR] [--reps N] [--shapes a,b,...]

Builds the port's K9 and K10 as the port builds them (``ops.build``) and,
with ``--old``, the ``noise_grad.cu`` and ``pta_grad.cu`` in DIR (an earlier
version of each, with its two passes and its wrapper's small factors formed
by ``torch.linalg``: ``_grad_prep``) with the port's nvcc flags; prints
each library's ptxas registers and spills and the count of ``DMMA``
instructions in its SASS. Then, at the main path's shapes on random inputs
drawn from a seed (``chip_smoke.k9_random``, ``k10_random``: the NANOGrav
noise likelihood's at E = 1 and 8, its DM-noise variant's at E = 8, array
A's at E = 1 and 8), holds each version's outputs against the twin (the
largest error relative to each set's largest entry) and against a second
call of itself (bitwise), and times, in turn (new, old, old, new), the
device time of each pass (torch.profiler, one call a profile, the median)
and of the whole call by CUDA events behind a busy queue
(``chip_smoke.queued_ms``: the old version's call includes its
``torch.linalg`` factors). One JSON line per shape. Needs a CUDA card.

    git show <commit>:pint_tpu_torch/csrc/noise_grad.cu > old/noise_grad.cu
    git show <commit>:pint_tpu_torch/csrc/pta_grad.cu > old/pta_grad.cu
    python3 grad_passes.py --old old
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent

#: (label, kernel, random-input arguments): the main path's shapes
SHAPES = (
    ("nanograv E=1", "k9", (16384, 81, 2048, 60, 1, True)),
    ("nanograv E=8", "k9", (16384, 81, 2048, 60, 8, True)),
    ("dm-noise E=8", "k9", (16384, 81, 2048, 120, 8, True)),
    ("array A E=1", "k10", (8192, 64, 6, 12, 0, 10, 1)),
    ("array A E=8", "k10", (8192, 64, 6, 12, 0, 10, 8)),
)
#: the kernels' names in a profile
PATTERNS = {"new": {"k9": ("noise_grad_",), "k10": ("pta_grad_",)},
            "old": {"k9": ("phi_pass", "row_pass"), "k10": ("pta_phi_pass", "pta_row_pass")}}


def load_old(path: Path, kernel: str):
    """An earlier K9 or K10 library: its C interface before the factor pass."""
    lib = ctypes.CDLL(str(path))
    lib.pint_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pint_cuda_error_string.restype = ctypes.c_char_p
    p, i = ctypes.c_void_p, ctypes.c_int
    if kernel == "k9":
        lib.noise_grad.argtypes = [p] * 15 + [i] * 6 + [p] * 5
    else:
        lib.pta_grad.argtypes = [p] * 15 + [i] * 7 + [p] * 4
    return lib


def old_k9(lib, core, st):
    """The earlier K9 call: its wrapper's factors (`_grad_prep`), then its
    two passes."""
    import torch

    from pint_tpu_torch.fitting.noise_like import _grad_prep
    from pint_tpu_torch.ops import build

    E, n = st.w.shape
    p, ke, kd = core.M.shape[0], st.phi_e.shape[1], st.phi_d.shape[1]
    Kt, Lt, gd, ahd = _grad_prep(st, p)
    dev = st.w.device
    ts = [core.M, st.norm, core.r0, core.Fd if kd else st.w, st.w, core.eidx, st.De, st.esum,
          st.phi_e, st.phi_d, Kt, Lt, gd, ahd, st.delta]
    ts = [t.contiguous() for t in ts]
    ge = torch.empty((E, max(ke, 1), max(p, 1)), dtype=torch.float64, device=dev)
    ae = torch.empty((E, max(ke, 1)), dtype=torch.float64, device=dev)
    dw = torch.empty((E, n), dtype=torch.float64, device=dev)
    dphi = torch.empty((E, max(ke + kd, 1)), dtype=torch.float64, device=dev)
    build.check(lib, lib.noise_grad(*(t.data_ptr() for t in ts), E, p, n, ke, kd,
                                    int(core.marginalize), ge.data_ptr(), ae.data_ptr(),
                                    dw.data_ptr(), dphi.data_ptr(), build.stream_of(st.w)))
    return dw, dphi[:, :ke + kd]


def old_k10(lib, core, st, gbar, ldbar):
    """The earlier K10 call: its wrapper's factors (`_grad_prep`), then its
    two passes."""
    import torch

    from pint_tpu_torch.fitting.pta_like import _grad_prep
    from pint_tpu_torch.ops import build

    E, N, n = st.w.shape
    S = E * N
    p, m = core.M.shape[1], core.G.shape[1]
    q, ke, kd = p + m + 1, st.phi_e.shape[-1], st.phi_d.shape[-1]
    Lt, Ad = _grad_prep(st)
    dev = st.w.device
    ts = [core.M, st.norm, core.G, core.r, core.Fd if kd else st.w, st.w, core.eidx, st.De,
          st.esum, st.phi_e, st.phi_d, gbar, ldbar, Lt, Ad]
    ts = [t.contiguous() for t in ts]
    Ae = torch.empty((S, max(ke, 1), q), dtype=torch.float64, device=dev)
    dw = torch.empty((S, n), dtype=torch.float64, device=dev)
    dphi = torch.empty((S, max(ke + kd, 1)), dtype=torch.float64, device=dev)
    build.check(lib, lib.pta_grad(*(t.data_ptr() for t in ts), S, N, p, m, n, ke, kd,
                                  Ae.data_ptr(), dw.data_ptr(), dphi.data_ptr(),
                                  build.stream_of(st.w)))
    return dw.reshape(E, N, n), dphi[:, :ke + kd].reshape(E, N, ke + kd)


def build_all(old: str | None) -> dict:
    """{tag: {kernel: library}}: "new", the port's K9 and K10 from
    ``ops.build``, and "old", DIR's sources built with the port's nvcc flags
    (in parallel with each other)."""
    import k3_passes as kp
    from pint_tpu_torch.fitting import noise_like, pta_like
    from pint_tpu_torch.ops import build

    jobs = {}
    if old:
        for k, name in (("k9", "noise_grad"), ("k10", "pta_grad")):
            src = Path(old) / f"{name}.cu"
            jobs[k] = (src, name, *kp.start_build(src, f"{name}_old"))
    libs = {"new": {"k9": build.library("noise_grad", noise_like._declare_k9),
                    "k10": build.library("pta_grad", pta_like._declare_k10)}}
    for name in ("noise_grad", "pta_grad"):
        print(f"new {name}: " + json.dumps(kp.build_report(name, build.build_dir() / f"lib{name}.so")))
    if jobs:
        libs["old"] = {}
        for k, (src, name, proc, lib, log) in jobs.items():
            kp.finish_build(proc, src, log)
            print(f"old {name}: " + json.dumps(kp.build_report(name, lib, log)))
            libs["old"][k] = load_old(lib, k)
    return libs


def calls(kernel: str, args, device):
    """(inputs, twin call, {tag: call(lib)}) of one shape on random inputs."""
    import chip_smoke as cs
    from pint_tpu_torch.fitting import noise_like as nl
    from pint_tpu_torch.fitting import pta_like as pl

    if kernel == "k9":
        core, st = cs.k9_random(*args, 12, device)
        return ((lambda: nl.noise_grad_plain(core, st)),
                {"new": lambda lib: (lambda: nl._launch_k9(core, st)),
                 "old": lambda lib: (lambda: old_k9(lib, core, st))})
    core, st, gbar, ldbar = cs.k10_random(*args, 13, device)
    return ((lambda: pl.pta_grad_plain(core, st, gbar, ldbar)),
            {"new": lambda lib: (lambda: pl._launch_k10(core, st, gbar, ldbar)),
             "old": lambda lib: (lambda: old_k10(lib, core, st, gbar, ldbar))})


def set_err(got, want) -> float:
    """The largest over the leading sets of max |got - want| / max |want|."""
    import chip_smoke as cs

    return cs.per_set_err(got.reshape(got.shape[0], 1, -1), want.reshape(want.shape[0], 1, -1))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="a directory holding earlier noise_grad.cu and pta_grad.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", default="", help="comma-separated substrings of shape labels")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_passes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    print(cs.device_line())
    libs = build_all(opt.old)
    order = list(libs)
    device = torch.device("cuda:0")
    names = [s for s in opt.shapes.split(",") if s]
    for label, kernel, args in SHAPES:
        if names and not any(nm in label for nm in names):
            continue
        twin, makers = calls(kernel, args, device)
        want = twin()
        rec = {"shape": label, "kernel": kernel, "args": args}
        outs = {}
        for tag in order + order[::-1]:
            call = makers[tag](libs[tag][kernel])
            got, again = call(), call()
            torch.cuda.synchronize()
            outs[tag] = got
            r = rec.setdefault(tag, {"err": 0.0, "repeat_bitwise": True, "passes_ms": [],
                                     "kernel_ms": [], "queued_ms": []})
            r["err"] = max(r["err"], *(set_err(g, w) for g, w in zip(got, want) if w.numel()))
            r["repeat_bitwise"] = r["repeat_bitwise"] and all(
                torch.equal(a, b) for a, b in zip(got, again))
            passes = cs.by_kernel(call, opt.reps, PATTERNS[tag][kernel])
            r["passes_ms"].append(passes)
            r["kernel_ms"].append(sum(ms for _, ms, _ in passes))
            r["queued_ms"].append(cs.queued_ms(call, opt.reps))
        if "old" in outs:
            rec["err_new_vs_old"] = max(set_err(g, w) for g, w in zip(outs["new"], outs["old"])
                                        if w.numel())
        print(json.dumps(rec), flush=True)
        del twin, makers, want, outs
    print(cs.device_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

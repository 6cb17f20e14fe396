#!/usr/bin/env python3
"""Kernel K3 (``pint_tpu_torch/csrc/ecorr_normal_eq.cu``) pass by pass on
one card, and beside an earlier K3 source.

    python3 k3_passes.py [--old SRC] [--reps N] [--shapes a,b,...]

Builds the port's K3 as the port builds it (``ops.build``) and, with
``--old``, another K3 source (an earlier version, with its
``ecorr_gram_part_size``) with the port's nvcc flags; prints each
library's ptxas registers and spills and the count of ``DMMA``
instructions in its SASS (``cuobjdump -sass``). Then, at the main path's
K3 shapes with random inputs drawn from a seed (the flagship's and
NANOGrav's fits and grids, the wideband fit, the per-set mode at E = 1, 8,
256 and the stacked mode at E = 1, 8, 256 over 64 pulsars), holds every
library's outputs against the twins (the largest error relative to each
output's largest value), against a second call of itself (bitwise) and,
with ``--old``, the port's against the other library's (bitwise), and
times the device time of a call (torch.profiler, as ``chip_smoke.measure``;
the libraries in turn and then in reverse order) and of each of its passes.
One JSON line per shape. With ``--alternate ROUNDS`` it instead times the
port's K3 and its library yardstick in turn, ROUNDS rounds a shape, and
reads the card's SM clock, power draw and clock-event reasons (nvidia-smi)
after each: one JSON line a round. Needs a CUDA card.

    python3 k3_passes.py --alternate 12 --shapes "sets E=256"
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def start_build(src, stem: str):
    """Start nvcc on `src` with the port's flags into
    build/k3_passes/<key>/lib<stem>.so; returns (process, library, log)."""
    from pint_tpu_torch.ops import build

    out = REPO / "build" / "k3_passes" / build.build_key()
    out.mkdir(parents=True, exist_ok=True)
    lib, log = out / f"lib{stem}.so", out / f"{stem}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                                 "-o", str(lib), str(src)], stdout=f, stderr=subprocess.STDOUT)
    return proc, lib, log


def finish_build(proc, src, log) -> None:
    """Wait for `start_build`'s nvcc; raise with its log if it failed."""
    if proc.wait() != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{Path(log).read_text()[-4000:]}")


def build_report(name: str, path, log=None) -> dict:
    """The ptxas registers and spills of library `path` (the report of the
    port's library `name`, or of the nvcc log `log`) and the count of DMMA
    instructions in its SASS."""
    from pint_tpu_torch.ops import build

    sass = subprocess.run([str(Path(build._nvcc()).parent / "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True).stdout
    return {"ptxas": build.ptxas_report(name, log), "dmma": len(re.findall(r"\bDMMA\b", sass))}


def build_all(old: str | None) -> dict:
    """{tag: library}: "new", the port's K3 from ``ops.build``, and "old",
    `old` built with the port's nvcc flags (the two builds in parallel)."""
    from pint_tpu_torch.fitting import woodbury as wb
    from pint_tpu_torch.ops import build

    job = start_build(old, "k3_old") if old else None
    paths = {"new": (build.library("ecorr_normal_eq", wb._declare_k3),
                     build.build_dir() / "libecorr_normal_eq.so", None)}
    if job is not None:
        proc, lib, log = job
        finish_build(proc, old, log)
        paths["old"] = (load_old(lib), lib, log)
    libs = {}
    for tag, (handle, path, log) in paths.items():
        info = build_report("ecorr_normal_eq", path, log)
        print(f"{tag}: " + json.dumps(info))
        libs[tag] = handle
    return libs


def load_old(path: Path):
    """An earlier K3 source's library: one with the port's C interface as
    it is, or an older one whose scratch is the segments' partials alone."""
    from pint_tpu_torch.fitting import woodbury as wb

    lib = ctypes.CDLL(str(path))
    lib.pint_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pint_cuda_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "ecorr_gram_scratch_size"):
        wb._declare_k3(lib)
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ecorr_gram.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, p, p, p]
    lib.ecorr_gram_part_size.argtypes = [i, i, i, i, i]
    lib.ecorr_gram_part_size.restype = ctypes.c_long
    lib.ecorr_fold.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_double, p, p, p, p, p]
    lib.ecorr_gram_sets.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p, p, p, p, p, p, p, p]
    lib.ecorr_fold_sets.argtypes = lib.ecorr_fold.argtypes
    lib.ecorr_gram_stacked.argtypes = [p] * 8 + [i] * 8 + [p] * 7 + [p]

    class Old:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def ecorr_gram_scratch_size(B, mb, pp, n, ke, kd):
            return lib.ecorr_gram_part_size(B, pp, n, ke, kd)

    return Old()


def shapes(device, names):
    """{label: (call, twin, library)}: the K3 calls of the main path's
    shapes on random inputs (numpy, seed 11), their twins, and the library
    yardstick of ``chip_smoke``'s K3 records (the batched cuBLAS Gram
    X W Xᵀ of the augmented rows alone)."""
    import numpy as np
    import torch

    from pint_tpu_torch.fitting import woodbury as wb

    rng = np.random.default_rng(11)

    def t(x):
        return torch.tensor(x, dtype=torch.float64, device=device)

    def epochs(n, ke, width=8):
        e = np.repeat(np.arange(ke), width)[:n]
        return np.concatenate([e, -np.ones(n - e.size, int)])

    def shared(B, p, n, ke, kd, centre):
        r, M, w = t(rng.standard_normal((B, n))), t(rng.standard_normal((B, p, n))), \
            t(rng.uniform(0.5, 2.0, n))
        basis = wb.NoiseBasis(
            dense=t(rng.standard_normal((n, kd))) if kd else None,
            dense_phi=t(rng.uniform(0.5, 2.0, kd)) if kd else None,
            epochs=wb.epoch_index(torch.tensor(epochs(n, ke), device=device), ke) if ke else None,
            ephi=t(rng.uniform(0.5, 2.0, ke)) if ke else None)
        args = (r, M, w, basis, 1e-12, centre, centre)
        parts = [M, r[:, None]] + ([basis.dense.T.expand(B, kd, n)] if kd else [])
        X = (torch.cat(parts, dim=1) * torch.sqrt(w)).contiguous()
        return (lambda: wb._launch_k3(*args)), (lambda: wb.ecorr_normal_eq_plain(*args)), \
            (lambda: torch.matmul(X, X.mT))

    def sets(E, p=81, n=16384, ke=2048, kd=60):
        r, M = t(rng.standard_normal(n)), t(rng.standard_normal((p, n)))
        args = (r, M, t(rng.uniform(0.5, 2.0, (E, n))), t(rng.standard_normal((kd, n))),
                wb.epoch_index(torch.tensor(epochs(n, ke), device=device), ke),
                t(rng.uniform(0.5, 2.0, (E, ke))), t(rng.uniform(0.5, 2.0, (E, kd))), 1e-12)
        X = torch.cat([M, r[None], args[3]])
        Xw = (X[None] * torch.sqrt(args[2])[:, None, :]).contiguous()
        return (lambda: wb._launch_k3_sets(*args)), (lambda: wb.ecorr_normal_eq_sets_plain(*args)), \
            (lambda: torch.matmul(Xw, Xw.mT))

    def stacked(E, N=64, n=8192, p=6, m=12, kd=10):
        w = rng.uniform(0.5, 2.0, (E, N, n))
        w[:, :, n - 64:] = 0.0  # the bucket's pad rows
        args = (t(rng.standard_normal((N, n))), t(rng.standard_normal((N, p, n))),
                t(rng.standard_normal((N, m, n))), t(w), t(rng.standard_normal((N, kd, n))),
                None, None, t(rng.uniform(0.5, 2.0, (E, N, kd))))
        X = torch.cat([args[1], args[2], args[0][:, None], args[4]], dim=1)  # (N, V, n)
        chunk = max(1, 1024 // N)

        def library():  # as chip_smoke's k3_stacked_record: at most 1,024 sets a call
            for e0 in range(0, E, chunk):
                Xw = X[None] * torch.sqrt(args[3][e0:e0 + chunk])[:, :, None, :]
                torch.matmul(Xw, Xw.mT)

        return (lambda: wb._launch_k3_stacked(*args)), \
            (lambda: wb.ecorr_normal_eq_stacked_plain(*args)), library

    table = {
        "flagship fit B=1 p=14": lambda: shared(1, 14, 16384, 2048, 0, False),
        "flagship grid B=9 p=14": lambda: shared(9, 14, 16384, 2048, 0, True),
        "nanograv fit B=1 p=80 kd=60": lambda: shared(1, 80, 16384, 2048, 60, False),
        "nanograv grid B=9 p=80 kd=60": lambda: shared(9, 80, 16384, 2048, 60, True),
        "wideband fit n=32768 p=81 kd=60": lambda: shared(1, 81, 32768, 0, 60, False),
        "sets E=1": lambda: sets(1), "sets E=8": lambda: sets(8), "sets E=256": lambda: sets(256),
        "stacked E=1": lambda: stacked(1), "stacked E=8": lambda: stacked(8),
        "stacked E=256": lambda: stacked(256),
    }
    for label, make in table.items():
        if not names or any(nm in label for nm in names):
            yield label, make()


def card_state() -> dict:
    """The card's SM clock (MHz), power draw (W), temperature (C) and
    active clock-event reasons (a bit mask), from nvidia-smi."""
    for reasons in ("clocks_event_reasons.active", "clocks_throttle_reasons.active"):
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu,"
                              + reasons, "--format=csv,noheader,nounits"],
                             capture_output=True, text=True)
        if out.returncode == 0:
            sm, power, temp, active = (v.strip() for v in out.stdout.splitlines()[0].split(","))
            return {"sm_mhz": sm, "power_w": power, "temp_c": temp, "reasons": active}
    return {"nvidia_smi": out.stderr.strip()[-200:]}


def alternate(call, library, device, rounds: int, reps: int) -> None:
    """K3's device ms (its own passes, from the profiler; its whole call,
    from CUDA events behind a busy queue) and its library yardstick's (both
    ways), in turn for `rounds` rounds of `reps` calls each, with the card's
    state read after each: one JSON line a round."""
    import chip_smoke as cs

    for k in range(rounds):
        ms, _ = cs.measure(call, device, reps, cs.K3_KERNEL)
        queued = cs.queued_ms(call, reps)
        after_k3 = card_state()
        lib, _ = cs.measure(library, device, reps)
        lib_queued = cs.queued_ms(library, reps)
        print(json.dumps({"round": k, "k3_ms": ms, "k3_queued_ms": queued,
                          "card_after_k3": after_k3, "library_ms": lib,
                          "library_queued_ms": lib_queued, "card_after_library": card_state()}),
              flush=True)


def outputs(x):
    return tuple(x) if isinstance(x, tuple) else tuple(getattr(x, f) for f in x._fields)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="an earlier ecorr_normal_eq.cu to build and time beside")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", default="", help="comma-separated substrings of shape labels")
    ap.add_argument("--alternate", type=int, default=0, metavar="ROUNDS",
                    help="instead: time K3 and its library Gram in turn, ROUNDS rounds a shape")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_passes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from pint_tpu_torch.ops import build

    print(cs.device_line())
    libs = build_all(opt.old)
    order = list(libs)
    device = torch.device("cuda:0")
    for label, (call, twin, library) in shapes(device, [s for s in opt.shapes.split(",") if s]):
        if opt.alternate:
            print(json.dumps({"shape": label, "card": card_state()}), flush=True)
            alternate(call, library, device, opt.alternate, max(2, opt.reps // (20 if "256" in label else 1)))
            continue
        want = outputs(twin())
        rec = {"shape": label}
        first = {}
        for tag in order + order[::-1]:
            build.library = lambda name, declare, lib=libs[tag]: lib
            got, again = outputs(call()), outputs(call())
            torch.cuda.synchronize()
            first.setdefault(tag, got)
            err = max((cs.rel_err(g, w) for g, w in zip(got, want)
                       if w is not None and w.numel()), default=0.0)
            same = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
            reps = max(2, opt.reps // (20 if "256" in label else 1))
            ms, _ = cs.measure(call, device, reps, cs.K3_KERNEL)
            if tag not in rec:
                rec.setdefault("by_kernel", {})[tag] = cs.by_kernel(call, reps, cs.K3_KERNEL)
            r = rec.setdefault(tag, {"err": err, "repeat_bitwise": same, "ms": []})
            r["ms"].append(ms)
            r["err"] = max(r["err"], err)
            r["repeat_bitwise"] = r["repeat_bitwise"] and same
        if "old" in first:
            rec["new_bitwise_old"] = all(torch.equal(a, b) for a, b in zip(first["new"], first["old"])
                                         if a is not None)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

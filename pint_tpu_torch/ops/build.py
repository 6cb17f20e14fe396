"""Build and load the port's CUDA kernels (``pint_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library with
a plain C interface, loaded with ctypes: no PyTorch headers, so a build
takes seconds. The libraries go under ``build/pint_tpu_torch/<key>/`` beside
the package, where ``<key>`` hashes the sources, the headers and the flags:
an edited source builds anew, an unchanged one is reused. All sources build
in parallel, one nvcc process each (``build_all`` does it up front and
reports the seconds, each source's in ``NVCC_SECONDS``); a library missing
at its first use is built alone.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` so that no multiply and add are
contracted into an FMA behind the double-double library's back (the header
also spells every such operation with an explicit ``__d*_rn`` intrinsic),
and ``-Xptxas -v`` so that the build log records registers and spills.

A C function returns ``cudaGetLastError()`` after its launch; `check`
raises on anything but success, since a refused launch never runs and
``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("dd_elementwise", "resid_tangent", "normal_eq", "ecorr_normal_eq",
           "site_geometry", "analytic_ephemeris", "nbody_serve", "chebyshev_eval",
           "linear_columns", "noise_grad", "pta_grad")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}
#: seconds from the start of `build_all` to each library's nvcc finishing
NVCC_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and /usr/local/cuda/bin): "
                           "the port's CUDA kernels cannot be built")
    return path


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted([*CSRC.glob("*.cu*"), *CSRC.glob("*.h")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return CSRC.parent.parent / "build" / "pint_tpu_torch" / build_key()


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library of `names` (all by default) in
    parallel; returns wall seconds. Raises with nvcc's output if any build
    fails."""
    t0 = time.perf_counter()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out / f"lib{n}.so.{os.getpid()}.tmp"
        log = open(out / f"{n}.log", "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    while procs:
        for n, (proc, tmp, log) in list(procs.items()):
            if proc.poll() is None:
                continue
            del procs[n]
            log.close()
            if proc.returncode == 0:
                os.replace(tmp, _lib_path(n))
                NVCC_SECONDS[n] = time.perf_counter() - t0
            else:
                failed.append(n)
        if procs:
            time.sleep(0.05)
    if failed:
        logs = "\n".join(f"--- {n} ---\n{(out / f'{n}.log').read_text()}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - t0


def _kernel_name(mangled: str) -> str:
    """'_ZN12_GLOBAL__N_120resid_tangent_kernelILi8EEEv...' ->
    'resid_tangent_kernel<8>': the last component of the nested name and
    its integer and bool template arguments (bool as 0 or 1)."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled.lstrip("_Z")
    name, args, i = mangled, [], 0
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        n = int(s[i:j])
        name, args, i = s[j:j + n], [], j + n
        if s[i:i + 1] == "I":
            m = re.match(r"I((?:L[ib]-?\d+E)+)E", s[i:])
            if m:
                args = re.findall(r"L[ib](-?\d+)E", m.group(1))
                i += m.end()
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_report(name: str, log: Path | None = None) -> dict:
    """{function: (registers, spill store bytes)} from the ptxas report in
    the build log of library `name` (or the nvcc log at `log`): every kernel
    instance, and every device function ptxas kept as a call with a stack
    frame of its own (its registers count toward its caller's, so they read
    0 here)."""
    p = log or build_dir() / f"{name}.log"
    out, entry, props = {}, None, None
    for line in (p.read_text() if p.exists() else "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = _kernel_name(m.group(1))
            out.setdefault(entry, (0, 0))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = _kernel_name(m.group(1))
            out.setdefault(props, (0, 0))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and props is not None:
            out[props] = (out[props][0], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry] = (int(m.group(1)), out[entry][1])
    return out


def ptxas_summary(name: str) -> str:
    """One line from the ptxas report of library `name`: its functions, their
    most registers and their most spill bytes."""
    rep = ptxas_report(name)
    if not rep:
        return "no ptxas report"
    return (f"{len(rep)} functions, at most {max(r for r, _ in rep.values())} registers, "
            f"at most {max(s for _, s in rep.values())} bytes of spill stores")


def library(name: str, declare) -> ctypes.CDLL:
    """The loaded library `name`, built if needed; `declare(lib)` sets the
    argtypes/restype of its functions once."""
    lib = _loaded.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.pint_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pint_cuda_error_string.restype = ctypes.c_char_p
        declare(lib)
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch failed: {lib.pint_cuda_error_string(rc).decode()} ({rc})")


def stream_of(t) -> int:
    """PyTorch's current stream on the tensor's device, as a handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream

"""The plans of the backward kernels K9 and K10 (``csrc/grad_plan.h``, read by
``pint_tpu_torch/fitting/grad_plan.py``), on the CPU.

The header is plain C++: here it is built with the host's C++ compiler into
a library that exports the same ``noise_grad_plan`` and ``pta_grad_plan``
as the kernels' libraries. The plan must take every width the noise and PTA
likelihoods and the card's random-input sweep run, within the H100's
shared memory, and refuse, naming the limit, a width beyond it; its scratch
and shared bytes must hold what the kernels' passes lay out there, counted
here from the sources' own description.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

from pint_tpu_torch.fitting import grad_plan

CSRC = Path(grad_plan.__file__).resolve().parent.parent / "csrc"
#: shared memory a block may use on the H100 (bytes)
H100_SMEM = 232448

#: (n, p, ke, kd, E, marginalized): the noise likelihood's widths (NANOGrav,
#: its DM-noise variant), p = 0, ke = 0, kd = 0, and the card's sweep
#: (`chip_smoke.K9_SWEEP`)
K9_WIDTHS = [(16384, 81, 2048, kd, E, marg) for kd in (60, 120) for E in (1, 8)
             for marg in (True, False)] + [
    (16384, 0, 2048, 60, 1, True), (16384, 81, 0, 60, 1, True), (16384, 81, 2048, 0, 8, True),
    (1000, 0, 0, 0, 1, True), (3001, 7, 40, 3, 3, True), (3001, 7, 40, 3, 3, False),
    (2000, 0, 50, 0, 3, True), (2000, 12, 0, 20, 3, True), (2048, 30, 64, 10, 3, True),
    (2048, 30, 64, 10, 3, False)]
#: (n, N, q, ke, kd, E): arrays A (no epochs), B (4,096 epochs) and C (ragged
#: pulsars in buckets of 8,192), ke = 0, kd = 0, and the card's sweep
#: (`chip_smoke.K10_SWEEP`, q = p + m + 1)
K10_WIDTHS = [(8192, 64, 19, 0, 10, E) for E in (1, 8)] + [
    (8192, 8, 19, 4096, 10, E) for E in (1, 8)] + [
    (8192, 8, 13, 0, 8, 8), (2048, 4, 6, 0, 0, 1), (1000, 3, 10, 40, 3, 3),
    (8192, 8, 19, 0, 10, 3), (2048, 4, 6, 0, 0, 3), (4096, 8, 12, 2048, 0, 2),
    (2048, 4, 40, 64, 10, 3), (2048, 4, 90, 64, 10, 3)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """grad_plan.h built for the host, with its two plans exported."""
    out = tmp_path_factory.mktemp("grad_plan")
    src = out / "grad_plan.cc"
    src.write_text('#include "grad_plan.h"\nPINT_EXPORT_GRAD_PLANS\n')
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "no host C++ compiler"
    subprocess.run([cxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared", "-fPIC", "-I",
                    str(CSRC), str(src), "-o", str(out / "libgrad_plan.so")], check=True)
    lib = ctypes.CDLL(str(out / "libgrad_plan.so"))
    grad_plan.declare(lib)
    return lib


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def expected(n1: int, kd: int, f2: bool, sets: int, ke: int) -> tuple:
    """(panel, scratch doubles) as the kernels lay them out: per set a panel
    of m16n8k8 B fragments (64 doubles each: F1 kd x n1 whole, F2 and F3
    upper triangular over n and k tiles of 8), F1's plain rows (kd x n1p),
    and with epochs, per set and epoch and one more, E (n1p), Bn (kdp) and
    1/De."""
    nt, kt = _round8(n1) // 8, _round8(kd) // 8
    panel = kt * nt + (nt * (nt + 1) // 2 if f2 else 0) + kt * (kt + 1) // 2
    scratch = sets * panel * 64 + sets * kd * 8 * nt
    if ke:
        scratch += sets * (ke + 1) * (8 * nt + 8 * kt + 1)
    return panel, scratch


def tile_bytes(n1: int, kd: int, warps: int) -> int:
    """A tile pass's shared bytes: the ring (4 slots of 16 fragments), R = 16
    warps rows of the padded columns at stride R + 2, and R row scales."""
    R = 16 * warps
    return 8 * (4 * 16 * 64 + (_round8(n1) + _round8(kd)) * (R + 2) + R)


def check_plan(plan: dict, n1: int, kd: int, f2: bool, sets: int, n: int, ke: int) -> None:
    panel, scratch = expected(n1, kd, f2, sets, ke)
    assert plan["panel"] == panel and plan["scratch"] == scratch
    for key, rows in (("row_warps", n), ("basis_warps", ke + kd)):
        w, need = plan[key], max(1, -(-rows // 16))  # warps of 16 rows
        assert w in (1, 2, 4, 8) and w <= need
        # the most warps that fit: twice as many would not, or would idle
        assert w == 8 or 2 * w > need or tile_bytes(n1, kd, 2 * w) > H100_SMEM
    assert plan["smem_rows"] == tile_bytes(n1, kd, plan["row_warps"])
    assert plan["smem_basis"] == tile_bytes(n1, kd, plan["basis_warps"])
    for key in ("smem_factors", "smem_basis", "smem_rows"):
        assert 0 <= plan[key] <= H100_SMEM


@pytest.mark.parametrize("width", K9_WIDTHS, ids=str)
def test_k9_plan_takes_the_paths_widths(lib, width):
    n, p, ke, kd, E, marg = width
    plan = grad_plan.noise_grad_plan(lib, *width)
    check_plan(plan, p + 1, kd, bool(marg and p), E, n, ke)
    # pass 1: K, K^-1 and 1/K_ii in one block, L then F (kd x n1p), L^-1
    # and 1/L_ii in the other
    k = 2 * p * p + p if marg and p else 0
    assert plan["smem_factors"] == 8 * max(k, kd * max(kd, _round8(p + 1)) + kd * kd + kd)
    if (n, p, kd) == (16384, 81, 60):  # the NANOGrav width: 8 warps, tiles of 128 rows
        assert plan["row_warps"] == 8 and plan["panel"] == (190 if marg else 124)
    if (n, p, kd) == (16384, 81, 120):  # the DM-noise width: 4 warps, factors streamed
        assert plan["row_warps"] == 4 and plan["panel"] * 512 + plan["smem_rows"] > H100_SMEM


@pytest.mark.parametrize("width", K10_WIDTHS, ids=str)
def test_k10_plan_takes_the_paths_widths(lib, width):
    n, N, q, ke, kd, E = width
    plan = grad_plan.pta_grad_plan(lib, *width)
    check_plan(plan, q, kd, True, E * N, n, ke)
    assert plan["smem_factors"] == 8 * (kd * max(kd, _round8(q)) + kd * kd + kd)
    if (q, kd) == (19, 10):  # array A's width: 15 fragments a set, 8 warps
        assert plan["panel"] == 15 and plan["row_warps"] == 8


@pytest.mark.parametrize("call, limit", [
    (lambda lib: grad_plan.noise_grad_plan(lib, 16384, 96, 2048, 60, 1, True), "96 value"),
    (lambda lib: grad_plan.noise_grad_plan(lib, 16384, 81, 2048, 121, 1, True), "120 dense"),
    (lambda lib: grad_plan.noise_grad_plan(lib, 16384, 81, 2048, 60, 65536, True), "65535 sets"),
    (lambda lib: grad_plan.noise_grad_plan(lib, 0, 81, 2048, 60, 1, True), "1 row"),
    (lambda lib: grad_plan.noise_grad_plan(lib, 16384, 81, -1, 60, 1, True), "negative"),
    (lambda lib: grad_plan.pta_grad_plan(lib, 8192, 64, 97, 0, 10, 1), "96 value"),
    (lambda lib: grad_plan.pta_grad_plan(lib, 8192, 64, 19, 0, 121, 1), "120 dense"),
    (lambda lib: grad_plan.pta_grad_plan(lib, 8192, 64, 19, 0, 10, 1024), "65535 sets"),
    (lambda lib: grad_plan.pta_grad_plan(lib, 8192, 65536, 19, 0, 10, 1), "65535 pulsars"),
], ids=("k9 values", "k9 basis", "k9 sets", "k9 rows", "k9 epochs", "k10 values", "k10 basis",
        "k10 sets", "k10 pulsars"))
def test_plan_refuses_a_width_beyond_its_limit(lib, call, limit):
    with pytest.raises(ValueError, match=limit):
        call(lib)


@pytest.mark.parametrize("width", [(16384, 95, 2048, 120, 1, True),
                                   (16384, 95, 0, 120, 65535, True)],
                         ids=("k9 widest", "k9 most sets"))
def test_k9_plan_takes_its_limits(lib, width):
    n, p, ke, kd, E, marg = width
    check_plan(grad_plan.noise_grad_plan(lib, *width), p + 1, kd, True, E, n, ke)


@pytest.mark.parametrize("width", [(8192, 1, 96, 4096, 120, 1), (8192, 65535, 19, 0, 10, 1)],
                         ids=("k10 widest", "k10 most pulsars"))
def test_k10_plan_takes_its_limits(lib, width):
    n, N, q, ke, kd, E = width
    check_plan(grad_plan.pta_grad_plan(lib, *width), q, kd, True, E * N, n, ke)

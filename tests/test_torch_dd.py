"""The port's double-double twins (pint_tpu_torch.ops.dd / taylor) against
pint_tpu.ops.dd, bitwise, on hypothesis-drawn and adversarial inputs.

Both packages run the same IEEE float64 operations in the same order, so
every result must be identical to the bit (tests/test_dd.py is the model).
pint_tpu runs eagerly here: each jnp operation is one rounded IEEE
operation, as in the port. Kernel K0 (csrc/dd_elementwise.cu) is held
against these twins on the card by chip_smoke.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings
from hypothesis import strategies as st

from pint_tpu.ops.xprec import DD64Prec
from pint_tpu_torch.ops.xprec import DD64 as TXP
from pint_tpu_torch.ops import dd as tdd
from pint_tpu_torch.ops import taylor as ttaylor

# pint_tpu.ops re-exports a function named `dd`, which hides the submodule
jdd = importlib.import_module("pint_tpu.ops.dd")
jtaylor = importlib.import_module("pint_tpu.ops.taylor")
JXP = DD64Prec()


# XLA flushes subnormal results to zero and torch keeps them, so inputs stay
# where no intermediate of the op under test is subnormal (timing quantities
# never come near: seconds ~1e9, spin-downs ~1e-26).
def bounded(lo=1e-140, hi=1e15):
    mag = st.floats(min_value=lo, max_value=hi, allow_nan=False, allow_infinity=False)
    return st.one_of(st.just(0.0), mag, mag.map(lambda x: -x))


finite = bounded()
small = bounded(hi=1e6)
nonzero = st.floats(min_value=1e-100, max_value=1e15).map(float) | \
    st.floats(min_value=1e-100, max_value=1e15).map(lambda x: -x)


def T(x):
    return torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float64)


def same(jax_out, torch_out):
    """Bitwise equality of nested (DD / tuple / array) results."""
    if isinstance(torch_out, tuple):
        assert len(jax_out) == len(torch_out)
        for a, b in zip(jax_out, torch_out):
            same(a, b)
        return
    a = np.asarray(jax_out, np.float64)
    b = torch_out.numpy()
    assert a.shape == b.shape
    assert np.array_equal(a.view(np.uint64), b.view(np.uint64)), (a, b)


def jd(h, l):
    return jdd.DD(jnp.float64(h), jnp.float64(l))


def td(h, l):
    return tdd.DD(T(h), T(l))


def normalized(a, b):
    s = a + b
    return s, (a - s) + b


@given(finite, finite)
def test_two_sum_and_quick_two_sum(a, b):
    same(jdd.two_sum(jnp.float64(a), jnp.float64(b)), tdd.two_sum(T(a), T(b)))
    big, tiny = (a, b) if abs(a) >= abs(b) else (b, a)
    same(jdd.quick_two_sum(jnp.float64(big), jnp.float64(tiny)),
         tdd.quick_two_sum(T(big), T(tiny)))


@given(small, small)
def test_split_and_two_prod(a, b):
    same(jdd._split(jnp.float64(a)), tdd._split(T(a)))
    same(jdd.two_prod(jnp.float64(a), jnp.float64(b)), tdd.two_prod(T(a), T(b)))


@given(finite, finite, finite, finite)
def test_dd_add_sub(a, b, c, d):
    x, y = normalized(a, b * 1e-17), normalized(c, d * 1e-17)
    same(jdd.dd_add(jd(*x), jd(*y)), tdd.dd_add(td(*x), td(*y)))
    same(jdd.dd_sub(jd(*x), jd(*y)), tdd.dd_sub(td(*x), td(*y)))
    same(jdd.dd_add_fp(jd(*x), jnp.float64(c)), tdd.dd_add_fp(td(*x), T(c)))
    same(jdd.dd_to_float(jd(*x)), tdd.dd_to_float(td(*x)))


@settings(max_examples=25)
@given(bounded(lo=1e-90, hi=1e6), bounded(lo=1e-90, hi=1e6), bounded(lo=1e-90, hi=1e6))
def test_dd_mul(a, b, c):
    x, y = normalized(a, b * 1e-17), normalized(c, a * 1e-17)
    same(jdd.dd_mul(jd(*x), jd(*y)), tdd.dd_mul(td(*x), td(*y)))
    same(jdd.dd_mul_fp(jd(*x), jnp.float64(c)), tdd.dd_mul_fp(td(*x), T(c)))


@given(small, nonzero)
def test_dd_div(a, c):
    x, y = normalized(a, a * 3e-17), normalized(c, c * -2e-17)
    same(jdd.dd_div(jd(*x), jd(*y)), tdd.dd_div(td(*x), td(*y)))


@settings(max_examples=25)
@given(bounded(lo=1e-200, hi=2e11), bounded(lo=1e-200, hi=0.5))
def test_dd_rint(turns, frac_lo):
    x = normalized(turns, frac_lo * 1e-6)
    same(jdd.dd_rint(jd(*x)), tdd.dd_rint(td(*x)))


def adversarial(n=4096, seed=3):
    """Cancelling pairs (y ~ -x), exact half-integers and huge/tiny mixes."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-100, 15, (2, n)) * rng.choice([-1.0, 1.0], (2, n))
    lo = mag * rng.uniform(-1, 1, (2, n)) * 2.0**-54
    mag[1, : n // 2] = -mag[0, : n // 2]
    lo[1, : n // 2] = -lo[0, : n // 2] * (1 + rng.uniform(-1e-6, 1e-6, n // 2))
    hi, lo = normalized(mag, lo)
    ph = np.round(rng.uniform(-2e11, 2e11, n)) + 0.5
    return hi, lo, ph


def test_adversarial_cancellation_bitwise():
    hi, lo, ph = adversarial()
    jx, jy = jdd.DD(jnp.asarray(hi[0]), jnp.asarray(lo[0])), jdd.DD(jnp.asarray(hi[1]), jnp.asarray(lo[1]))
    tx, ty = tdd.DD(T(hi[0]), T(lo[0])), tdd.DD(T(hi[1]), T(lo[1]))
    same(jdd.dd_add(jx, jy), tdd.dd_add(tx, ty))
    same(jdd.dd_sub(jx, jdd.dd_neg(jy)), tdd.dd_sub(tx, tdd.dd_neg(ty)))
    same(jdd.dd_mul(jx, jy), tdd.dd_mul(tx, ty))
    same(jdd.dd_div(jx, jy), tdd.dd_div(tx, ty))
    same(jdd.dd_rint(jdd.DD(jnp.asarray(ph), jnp.zeros(len(ph)))),
         tdd.dd_rint(tdd.DD(T(ph), T(np.zeros(len(ph))))))


@pytest.mark.parametrize("op", ["add", "add_fp", "mul", "mul_fp", "div", "two_prod", "rint"])
def test_k0_wrapper_on_cpu_is_the_twin(op):
    """K0's wrapper takes the twin for CPU tensors, bitwise the dd ops."""
    hi, lo, ph = adversarial(512, seed=5)
    x, y = tdd.DD(T(hi[0]), T(lo[0])), tdd.DD(T(hi[1]), T(lo[1]))
    if op == "rint":
        x, y = tdd.DD(T(ph), T(lo[0] * 1e-30)), None
    elif op in ("add_fp", "mul_fp"):
        y = y.hi
    got = tdd.dd_elementwise(op, x, y)
    want = {"add": lambda: tdd.dd_add(x, y), "add_fp": lambda: tdd.dd_add_fp(x, y),
            "mul": lambda: tdd.dd_mul(x, y), "mul_fp": lambda: tdd.dd_mul_fp(x, y),
            "div": lambda: tdd.dd_div(x, y), "two_prod": lambda: tdd.two_prod(x.hi, y.hi),
            "rint": lambda: tdd.dd_rint(x)}[op]()
    def parts(v):
        return (v[0], *v[1]) if op == "rint" else tuple(v)

    for a, b in zip(parts(got), parts(want), strict=True):
        assert torch.equal(a, b)


def test_k0_rejects_unknown_op():
    x = tdd.DD(T([1.0]), T([0.0]))
    with pytest.raises(ValueError, match="unknown dd op"):
        tdd.dd_elementwise("sqrt", x, None)


@settings(max_examples=25)
@given(bounded(lo=1e-100, hi=3e8), bounded(lo=1e-100, hi=1e-8))
def test_taylor_horner_dd_and_x(dt_hi, dt_lo):
    x = normalized(dt_hi, dt_lo)
    f0 = (173.6879489990983, 3.1e-15)
    coeffs_j = [0.0, jd(*f0), jd(-1.728e-15, 2e-32), jnp.float64(1e-26)]
    coeffs_t = [0.0, td(*f0), td(-1.728e-15, 2e-32), T(1e-26)]
    same(jtaylor.taylor_horner_dd(jd(*x), coeffs_j), ttaylor.taylor_horner_dd(td(*x), coeffs_t))
    same(jtaylor.taylor_horner_x(JXP, jd(*x), coeffs_j[:3]),
         ttaylor.taylor_horner_x(TXP, td(*x), coeffs_t[:3]))
    fc = [173.6879489990983, -1.728e-15, 1e-26]
    for order in (0, 1, 2):
        same(jtaylor.taylor_horner_deriv(jnp.float64(dt_hi), fc, order),
             ttaylor.taylor_horner_deriv(T(dt_hi), [T(c) for c in fc], order))


def test_device_split_matches():
    rng = np.random.default_rng(9)
    hi = rng.uniform(-1e10, 1e10, 1000)
    lo = hi * rng.uniform(-1, 1, 1000) * 1e-17
    a, b = jdd.device_split(hi, lo)
    c, d = tdd.device_split(hi, lo)
    assert np.array_equal(a, c) and np.array_equal(b, d)


def test_ptxas_report_reads_every_instance(tmp_path, monkeypatch):
    """The build log's ptxas report -> registers and spill stores per kernel
    instance and per device function kept as a call, named by the template
    arguments (a bool one as 0 or 1)."""
    from pint_tpu_torch.ops import build

    k8 = "_ZN12_GLOBAL__N_120resid_tangent_kernelILi8ELb1EEEvNS_4RowsEPKdNS_6ConfigEPdS5_S5_S5_S5_"
    row8 = "_ZN12_GLOBAL__N_18eval_rowILi8ELb1EEENS_8RowPhaseIXT_EEEiRKNS_4RowsEPKdRKNS_6ConfigE"
    k0 = "_ZN12_GLOBAL__N_120resid_tangent_kernelILi0ELb0EEEvNS_4RowsEPKdNS_6ConfigEPdS5_S5_S5_S5_"
    (tmp_path / "resid_tangent.log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Function properties for {row8}\n"
        "    9052 bytes stack frame, 9052 bytes spill stores, 9052 bytes spill loads\n"
        f"ptxas info    : Compiling entry function '{k8}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {k8}\n"
        "    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 16 bytes smem\n"
        f"ptxas info    : Compiling entry function '{k0}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {k0}\n"
        "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 126 registers, used 1 barriers, 16 bytes smem\n")
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    assert build.ptxas_report("resid_tangent") == {
        "eval_row<8,1>": (0, 9052), "resid_tangent_kernel<8,1>": (128, 0),
        "resid_tangent_kernel<0,0>": (126, 4)}
    assert build.ptxas_summary("resid_tangent") == (
        "3 functions, at most 128 registers, at most 9052 bytes of spill stores")
    assert build.ptxas_summary("missing") == "no ptxas report"

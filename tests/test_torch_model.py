"""The port's forward chain against pint_tpu on the same TOAs: SMOKE_PAR
(astrometry, solar Shapiro, DM, spindown, AbsPhase) over 1,024 fake TOAs.

Bounds: time residuals within 1 ps and pulse numbers equal, spin frequency
within 1e-15 relative, design columns within 1e-10 relative of pint_tpu's
WLS step. The K1 twin (``residuals.resid_tangent_plain``) is what runs on
the CPU; chip_smoke.py holds the kernel against it on the card.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_fixture import port_pair


@pytest.fixture(scope="module")
def pair():
    return port_pair(n=1024)


def test_time_residuals_within_1ps(pair):
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu_torch.residuals import Residuals

    model, toas, tens, tm, tt = pair
    want = JaxResiduals(toas, model, tensor=tens)
    got = Residuals(tt, tm)
    dt = np.abs(got.time_resids.numpy() - want.time_resids)
    assert dt.max() <= 1e-12
    np.testing.assert_array_equal(got.pulse_numbers.numpy(), want.pulse_numbers)
    assert got.dof == want.dof
    assert abs(got.calc_chi2() - want.calc_chi2()) <= 1e-8 * want.calc_chi2()


def test_spin_frequency_and_phase_split(pair):
    from pint_tpu.residuals import phase_residual_frac as jax_prf
    from pint_tpu_torch.residuals import phase_residual_frac

    model, _, tens, tm, tt = pair
    pn_j, r_j, f_j = jax_prf(model, model.params, tens, subtract_mean=False)
    pn, r, f = phase_residual_frac(tm, tm.params, tt, subtract_mean=False)
    assert pn.shape == r.shape == f.shape == (1, 1024)
    np.testing.assert_array_equal(pn[0].numpy(), np.asarray(pn_j))
    assert np.max(np.abs(f[0].numpy() / np.asarray(f_j) - 1)) <= 1e-15
    assert np.max(np.abs(r[0].numpy() - np.asarray(r_j)) / np.asarray(f_j)) <= 1e-12


def test_design_matrix_matches_pint_tpu(pair):
    from pint_tpu.fitting import DownhillWLSFitter as JaxFitter
    from pint_tpu_torch.fitting.wls import wls_step
    from pint_tpu_torch.residuals import Residuals

    model, toas, tens, tm, tt = pair
    jf = JaxFitter(toas, model)
    r0_j, M_j = (np.asarray(a) for a in jf._step_fn(model.params, tens)[:2])
    res = Residuals(tt, tm)
    free = tuple(tm.free_params)
    assert free == jf._free
    r0, M = wls_step(tm, free, tm.params, tt, res.weights, res.errors_s, True)[:2]
    assert np.max(np.abs(r0.numpy() - r0_j)) <= 1e-12
    for i, n in enumerate(free):
        col = M[:, i].numpy()
        rel = np.max(np.abs(col - M_j[:, i])) / np.max(np.abs(M_j[:, i]))
        assert rel <= 1e-10, (n, rel)


def test_linear_columns_carry_the_tzr_row(pair):
    """M[:-1] - M[-1]: the DM column is anchored to the fiducial TOA."""
    from pint_tpu.fitting.design import linear_columns as jax_cols
    from pint_tpu.fitting.design import linear_split as jax_split
    from pint_tpu.residuals import phase_residual_frac as jax_prf
    from pint_tpu_torch.fitting.design import linear_columns, linear_split
    from pint_tpu_torch.residuals import phase_residual_frac

    model, _, tens, tm, tt = pair
    _, lin_j, own_j = jax_split(model, ("DM",))
    _, lin, own = linear_split(tm, ("DM",))
    assert lin == lin_j == ("DM",)
    f_j = jax_prf(model, model.params, tens)[2]
    f = phase_residual_frac(tm, tm.params, tt)[2][0]
    want = np.asarray(jax_cols(model, model.params, tens, f_j, slice(None, -1), lin_j, own_j))
    got = linear_columns(tm, tm.params, tt, f, slice(None, -1), lin, own)
    assert got.shape == (1, 1024)
    assert np.max(np.abs(got[0].numpy() - want[:, 0])) <= 1e-12 * np.max(np.abs(want))
    fb = tt["freq_mhz"][:-1]
    assert not torch.allclose(got[0], -4.15e3 / fb**2, rtol=1e-3)  # the anchor shifts it


def test_batched_twin_equals_single_sets(pair):
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.residuals import resid_tangent

    _, _, _, tm, tt = pair
    f0 = tm.params["F0"]
    shifts = torch.tensor([-1e-10, 0.0, 2e-10], dtype=torch.float64)
    batched = dict(tm.params, F0=DD(f0.hi + shifts, f0.lo.expand(3)))
    lanes = ("RAJ", "DECJ")
    out = resid_tangent(tm, batched, tt, lanes)
    assert out.frac.shape == (3, 1024) and out.dfrac.shape == (3, 2, 1024)
    for b in range(3):
        one = resid_tangent(tm, dict(tm.params, F0=DD(f0.hi + shifts[b], f0.lo)), tt, lanes)
        for got, want in zip(out, one):
            assert torch.equal(got[b], want[0])


def test_float32_anywhere_in_the_chain_raises(pair):
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.residuals import resid_tangent

    _, _, _, tm, tt = pair
    with pytest.raises(TypeError, match="t_lo"):
        resid_tangent(tm, tm.params, dict(tt, t_lo=tt["t_lo"].float()))
    f1 = tm.params["F1"]
    with pytest.raises(TypeError, match="F1"):
        resid_tangent(tm, dict(tm.params, F1=DD(f1.hi, f1.lo.float())), tt)
    out = resid_tangent(tm, tm.params, tt, ("F0",))
    assert all(t.dtype == torch.float64 for t in out)


@pytest.mark.parametrize("line, item", [
    ("NE_SW 7.9", "A9"), ("DJUMP -f L 0.1 1", "A9"),
    ("PHOFF 0.1 1", "A9"), ("SIFUNC 2", "A9"), ("PLANET_SHAPIRO Y", "A18"),
])
def test_unported_components_name_their_roadmap_item(line, item):
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import SMOKE_PAR

    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        get_model(SMOKE_PAR + line + "\n", from_text=True, device="cpu")


def test_tangent_lanes_cover_the_nonlinear_parameters():
    from pint_tpu_torch.residuals import lane_code

    assert [lane_code(n) for n in ("RAJ", "DECJ", "PX", "F0", "F1")] == [0, 1, 4, 16, 17]
    kepler = ("T0", "ECC", "OM", "OMDOT", "EDOT", "GAMMA", "PBDOT", "A1DOT", "M2", "SINI",
              "SHAPMAX", "DR", "DTH", "A0", "B0")
    assert [lane_code(n) for n in kepler] == list(range(48, 63))
    # the block of the ELL1H, ELL1K, DDK and DDGR parameters, after FB0-FB7
    rest = ("H3", "H4", "STIGMA", "LNEDOT", "KIN", "KOM", "MTOT", "XOMDOT", "XPBDOT")
    assert [lane_code(n) for n in rest] == list(range(264, 273))
    assert [lane_code(f"FB{k}") for k in (0, 7)] == [256, 263]
    for name in ("FB8", "NHARMS"):
        with pytest.raises(NotImplementedError, match="K1"):
            lane_code(name)

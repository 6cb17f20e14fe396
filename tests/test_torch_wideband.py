"""The port's wideband path against pint_tpu: DM measurements (-pp_dm,
-pp_dme), DMJUMP, DMEFAC/DMEQUAD, the combined [TOA; DM] residuals, the
wideband step and chi^2, and the WidebandDownhillFitter that ``fit_auto``
picks, on ``profiles.wideband_smoke_par(n_dmx=8, nf=10)`` over 1,024
wideband TOAs made by pint_tpu (`WIDEBAND_RECIPE`; p = 25 free parameters,
kd = 20 Fourier columns).

Bounds: the DM columns of the tensor and the scaled DM sigmas bitwise; the
model DM within 1e-15 relative; DMJUMP moves the DM block and leaves the TOA
residuals bitwise unchanged; the residuals' chi^2 within 1e-10 relative, dof
equal, DM residuals within 1e-15 of the DM scale; the six outputs of one
wideband step, the combined design matrix and the wideband chi^2 within
1e-10 relative, also with ECORR (NANOGrav-shaped sub-band epochs with DM
measurements); the fit's parameters and uncertainties within 1e-10
relative (the DM rows pin DMX and DMJUMP: the normal matrix is well enough
conditioned at this size that no witness is needed), DMJUMP within 4 sigma of
its truth. pint_tpu runs eagerly (``jax.disable_jit``; ROADMAP C1).
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_fixture import (WIDEBAND_RECIPE, nanograv_dataset, params_numpy,
                                      wideband_pair)

#: the fit's start: the truth moved (apply_delta's units: Hz, s, pc cm^-3);
#: DMJUMP1 starts at 0, its truth WIDEBAND_RECIPE["dmjump_true"] away
START = {"F0": 2e-10, "EPS1": 1e-7, "DMX_0001": 1e-4, "JUMP1": 1e-6, "FD1": 1e-6}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.max(np.abs(want)) if want.size else 0.0
    diff = np.max(np.abs(got - want)) if want.size else 0.0
    return diff / scale if scale else diff


def leaf(v) -> float:
    return float(v.hi) + float(v.lo) if hasattr(v, "hi") else float(np.asarray(v))


@pytest.fixture(scope="module")
def pair():
    return wideband_pair(1024)


@pytest.fixture(scope="module")
def fits(pair):
    """Both packages' fit_auto fits from the START shift, and pint_tpu's first
    wideband step (its parameters and outputs)."""
    from pint_tpu.fitting import fit_auto as jax_fit_auto
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu_torch.fitting import fit_auto
    from pint_tpu_torch.fitting.wls import apply_delta
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import wideband_smoke_par

    _, toas, _, _, tt = pair
    par = wideband_smoke_par(8, 10)
    jm = build_model(parse_parfile(par, from_text=True))
    tm = get_model(par, from_text=True, device="cpu")
    free = tuple(jm.free_params)
    assert free == tuple(tm.free_params)
    delta = np.array([START.get(n, 0.0) for n in free])
    jm.params = jax_apply(jm.params, free, delta)
    tm.params = apply_delta(tm.params, free, torch.tensor(delta))
    assert params_numpy(jm.params) == params_numpy(tm.params)
    start = dict(tm.params)
    want = jax_fit_auto(toas, jm)
    steps = []
    step_fn = want._step_fn

    def first_step(params, tensor):
        out = step_fn(params, tensor)
        if not steps:
            steps.append([np.asarray(a) for a in out])
        return out

    want._step_fn = first_step
    with jax.disable_jit():
        want.fit_toas()
        want_design = want.designmatrix()
    got = fit_auto(tt, tm)
    got.fit_toas()
    return jm, tm, want, got, (start, steps[0]), want_design


# --- TOAs, tensor and model ----------------------------------------------------------


def test_wideband_dm_of_the_toas(pair, tmp_path):
    """The port's TOAs read the -pp_dm/-pp_dme flags of a .tim as pint_tpu's
    do, its tensor carries them (the TZR row at zero weight), and a flag
    without its partner raises in both."""
    from pint_tpu_torch.toas import get_TOAs

    _, toas, tens, tm, _ = pair
    path = tmp_path / "wb.tim"
    toas.write_tim(str(path))
    port = get_TOAs(str(path), model=tm, device="cpu")
    assert port.is_wideband
    for got, want in zip(port.get_wideband_dm(), toas.get_wideband_dm()):
        np.testing.assert_array_equal(got, want)
    tensor = tm.build_tensor(port)
    for k in ("wb_dm", "wb_dme"):
        np.testing.assert_array_equal(tensor[k].numpy(), np.asarray(tens[k]), err_msg=k)
    assert tensor["wb_dme"][-1] == np.inf and tensor["wb_dm"][-1] == 0.0
    copy = toas.select(np.ones(len(toas), bool))
    both = ((port, list(port.flags)), (copy, list(toas.flags)))
    for drop in ("pp_dme", "pp_dm"):
        partner = {"pp_dme": "pp_dm", "pp_dm": "pp_dme"}[drop]
        for t, flags in both:
            t.flags = [dict(f) for f in flags]
            del t.flags[3][drop]
            with pytest.raises(ValueError, match=f"-{partner} without -{drop}"):
                t.get_wideband_dm()


def test_model_is_wideband_shaped(pair):
    model, _, _, tm, _ = pair
    assert tm.component_names == [c.name for c in model.components]
    assert "DispersionJump" in tm and "ScaleDmError" in tm and "EcorrNoise" not in tm
    assert len(tm.free_params) == 25 and tm.free_params == list(model.free_params)
    assert params_numpy(tm.params) == params_numpy(model.params)


def test_scaled_dm_sigma_bitwise(pair):
    model, _, tens, tm, tt = pair
    want = np.asarray(model.scaled_dm_sigma(model.xprec.convert_params(model.params), tens))
    got = tm.scaled_dm_sigma(tm.params, tt).numpy()
    np.testing.assert_array_equal(got, want)
    # DMEFAC and DMEQUAD differ from 1 and 0 on both receivers
    assert np.all(got[np.isfinite(got)] > 1.1e-4)


def test_total_dm(pair):
    model, _, tens, tm, tt = pair
    want = np.asarray(model.total_dm(model.xprec.convert_params(model.params), tens))
    got = tm.total_dm(tm.params, tt).numpy()
    assert got.shape == want.shape == (1024,)
    assert rel(got, want) <= 1e-15


def test_dmjump_moves_the_dm_block_only(pair):
    """DMJUMP enters the model DM with a minus sign on its selection and
    never the delay: the time residuals stay bitwise, in both packages."""
    from pint_tpu_torch.residuals import Residuals

    model, _, tens, tm, tt = pair
    moved = dict(tm.params, DMJUMP1=torch.tensor(1e-3, dtype=torch.float64))
    before = Residuals(tt, tm).time_resids
    tm_moved_dm = tm.total_dm(moved, tt)
    saved = tm.params
    tm.params = moved
    try:
        after = Residuals(tt, tm).time_resids
    finally:
        tm.params = saved
    assert torch.equal(before, after)
    mask = tt["mask_DMJUMP1"][:-1]
    assert mask.sum() == 512
    np.testing.assert_allclose((tm.total_dm(tm.params, tt) - tm_moved_dm).numpy(),
                               1e-3 * mask.numpy(), rtol=0, atol=1e-15 * 15)
    jp = model.xprec.convert_params(dict(model.params, DMJUMP1=1e-3))
    assert rel(tm_moved_dm.numpy(), np.asarray(model.total_dm(jp, tens))) <= 1e-15


def test_wideband_residuals(pair):
    from pint_tpu.residuals import WidebandTOAResiduals as JaxWB
    from pint_tpu_torch.residuals import WidebandTOAResiduals

    model, toas, _, tm, tt = pair
    want, got = JaxWB(toas, model), WidebandTOAResiduals(tt, tm)
    assert got.dof == want.dof == 1024 - 25 - 1 + 1024
    assert abs(got.calc_chi2() - want.calc_chi2()) <= 1e-10 * want.calc_chi2()
    dm_scale = float(np.max(np.abs(want.dm_data)))
    assert np.max(np.abs(got.dm_resids.numpy() - want.dm_resids)) <= 1e-15 * dm_scale
    np.testing.assert_array_equal(got.dm_data.numpy(), np.asarray(want.dm_data))


# --- the step, the chi^2 and the design ---------------------------------------------------


def test_wb_step_matches_pint_tpu(fits):
    """pint_tpu's first wideband step (r_aug, mtcm, mtcy, norm, chi2_0, ahat)
    against the port's at the same start: within 1e-10 relative."""
    _, tm, _, got, (start, want), _ = fits
    out = got._step(start)
    for name, g, w in zip(("r_aug", "mtcm", "mtcy", "norm", "chi2_0", "ahat"), out, want):
        assert g.shape == w.shape, name
        assert rel(g.numpy(), w) <= 1e-10, (name, rel(g.numpy(), w))


def test_designmatrix_matches_pint_tpu(fits):
    """The combined unweighted design at the fitted parameters, per column."""
    _, _, _, got, _, want = fits
    design = got.designmatrix()
    assert design.shape == want.shape == (2048, 25)
    assert max(rel(design[:, j], want[:, j]) for j in range(25)) <= 1e-10
    # DMJUMP1's TOA column is exactly zero, its DM column -mask
    j = got._free.index("DMJUMP1")
    assert not design[:1024, j].any() and set(design[1024:, j]) == {0.0, -1.0}


def test_wb_chi2_matches_pint_tpu(fits):
    _, tm, want, got, (start, _), _ = fits
    with jax.disable_jit():
        want_chi2 = want.chi2_at(want.model.params)
    got_chi2 = got.chi2_at(tm.params)
    assert abs(got_chi2 - want_chi2) <= 1e-10 * want_chi2
    assert abs(got_chi2 - got.result.chi2) <= 1e-10 * got_chi2


# --- the fit ----------------------------------------------------------------------------


def test_fit_auto_wideband_fit_matches_pint_tpu(fits):
    from pint_tpu_torch.fitting import WidebandDownhillFitter

    jm, tm, want, got, _, _ = fits
    assert isinstance(got, WidebandDownhillFitter)
    res, ref = got.result, want.result
    assert res.converged and ref.converged and res.iterations == ref.iterations
    assert res.dof == ref.dof and abs(res.chi2 - ref.chi2) <= 1e-10 * ref.chi2
    assert 0.8 <= res.reduced_chi2 <= 1.2
    for n in got._free:
        a, b = leaf(jm.params[n]), leaf(tm.params[n])
        assert abs(b - a) <= 1e-10 * abs(a), n
        u = ref.uncertainties[n]
        assert abs(res.uncertainties[n] - u) <= 1e-10 * u, n
    dmj, sig = leaf(tm.params["DMJUMP1"]), res.uncertainties["DMJUMP1"]
    assert abs(dmj - WIDEBAND_RECIPE["dmjump_true"]) <= 4 * sig
    assert rel(got.noise_ampls, want.noise_ampls) <= 1e-10
    assert float(torch.std(got.resids.dm_resids)) < 3e-4


def test_wb_step_with_ecorr_matches_pint_tpu():
    """A wideband model with ECORR (pint_tpu accepts it): the NANOGrav-shaped
    sub-band epochs, each TOA given a DM measurement, a DMJUMP and a DMEFAC;
    the stacked system's ECORR epochs hold no DM row."""
    from pint_tpu.fitting.wideband import WidebandDownhillFitter as JaxWB
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu_torch.fitting import fit_auto
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.prepared import tensor_from_numpy
    from pint_tpu_torch.profiles import nanograv_smoke_par

    _, base, _ = nanograv_dataset(1024, n_dmx=8, nf=10)
    toas = base.select(np.ones(len(base), bool))
    toas.flags = [dict(f) for f in toas.flags]
    par = nanograv_smoke_par(8, 10) + ("DMJUMP -f Rcvr_800_GUPPI 0 1\n"
                                       "DMEFAC -f Rcvr1_2_GUPPI 1.1\n")
    jm = build_model(parse_parfile(par, from_text=True))
    tens0 = jm.build_tensor(toas)
    dm = np.asarray(jm.total_dm(jm.xprec.convert_params(jm.params), tens0))
    rng = np.random.default_rng(3)
    for i, f in enumerate(toas.flags):
        if i % 7:  # every seventh TOA without a measurement
            f["pp_dm"] = repr(float(dm[i] + 1e-4 * rng.standard_normal()))
            f["pp_dme"] = "1e-4"
    tens = jm.build_tensor(toas)
    tm = get_model(par, from_text=True, device="cpu")
    tt = tensor_from_numpy({k: np.asarray(v) for k, v in tens.items()}, device="cpu")
    want_f, got_f = JaxWB(toas, jm), fit_auto(tt, tm)
    assert tm.has_correlated_errors and got_f.resids.dof == want_f.resids.dof
    with jax.disable_jit():
        fn, args = want_f._step_program(want_f.model.params)
        want = [np.asarray(a) for a in fn(*args)]
        want_chi2 = want_f.chi2_at(want_f.model.params)
    got = got_f._step(tm.params)
    assert want[5].shape == (128 + 20,)  # ECORR epochs, then the Fourier amplitudes
    for name, g, w in zip(("r_aug", "mtcm", "mtcy", "norm", "chi2_0", "ahat"), got, want):
        assert rel(g.numpy(), w) <= 1e-10, (name, rel(g.numpy(), w))
    assert abs(got_f.chi2_at(tm.params) - want_chi2) <= 1e-10 * want_chi2


def test_fused_and_mesh_fits_are_refused(pair):
    from pint_tpu_torch.fitting import WidebandDownhillFitter, fit_auto

    _, _, _, tm, tt = pair
    with pytest.raises(NotImplementedError, match="ROADMAP A11a"):
        fit_auto(tt, tm, fused=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        fit_auto(tt, tm, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP A11a"):
        WidebandDownhillFitter(tt, tm, fused=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        WidebandDownhillFitter(tt, tm, mesh=object())
    assert isinstance(fit_auto(tt, tm, fused=False), WidebandDownhillFitter)

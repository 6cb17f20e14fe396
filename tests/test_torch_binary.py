"""The flagship forward chain against pint_tpu: the ELL1 binary, DM1,
PM/PX astrometry, EFAC/EQUAD-scaled sigmas and the fitters' domain
projection (profiles.FLAGSHIP_SMOKE_PAR over 256 fake TOAs in 32 ECORR
epochs).

Bounds: delays and time residuals within 1 ps and pulse numbers equal;
the ELL1 engine functions within 1e-15 relative on seeded random inputs;
scaled sigmas and the projected parameter updates bitwise. The port's CPU
twin evaluates sin, cos and log with the C library, as XLA's CPU backend
does (``ops/libm.py``), so the chain agrees with pint_tpu's eager run far
inside these bounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fixture import flagship_pair, params_numpy


@pytest.fixture(scope="module")
def pair():
    return flagship_pair(n=256)


def test_model_structure_matches_pint_tpu(pair):
    model, _, _, tm, _ = pair
    assert tm.component_names == model.component_names
    assert tm.free_params == model.free_params and len(tm.free_params) == 14
    assert params_numpy(tm.params) == params_numpy(model.params)
    for name in ("EFAC2", "EQUAD1", "ECORR2"):
        assert tm.param_meta[name].frozen
    assert tm.has_correlated_errors and [c.name for c in tm.noise_components] == [
        "ScaleToaError", "EcorrNoise"]


def test_delay_components_within_1ps(pair):
    """Each delay, the ELL1 one at the delay so far of the others, in the
    order of the chain."""
    model, _, tens, tm, tt = pair
    with jax.disable_jit():
        jp = model.xprec.convert_params(model.params)
        jt = model._with_context(jp, tens)
        pt = tm._with_context(tm.params, tt)
        jd, pd = jnp.zeros_like(jt["t_hi"]), torch.zeros_like(pt["t_hi"])
        names = []
        for jc, pc in zip(model.delay_components, tm.delay_components):
            a = np.asarray(jc.delay(jp, jt, jd, model.xprec))
            b = pc.delay(tm.params, pt, pd, tm.xprec)
            assert np.max(np.abs(b.numpy() - a)) <= 1e-12, pc.name
            jd, pd = jd + a, pd + b
            names.append(pc.name)
    assert names == ["AstrometryEquatorial", "SolarSystemShapiro", "DispersionDM", "BinaryELL1"]


def test_flagship_time_residuals_within_1ps(pair):
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu_torch.residuals import Residuals

    model, toas, tens, tm, tt = pair
    want = JaxResiduals(toas, model, tensor=tens)
    got = Residuals(tt, tm)
    assert np.max(np.abs(got.time_resids.numpy() - np.asarray(want.time_resids))) <= 1e-12
    np.testing.assert_array_equal(got.pulse_numbers.numpy(), np.asarray(want.pulse_numbers))
    assert got.dof == want.dof


def test_scaled_sigma_bitwise(pair):
    """EQUAD in quadrature (jax.numpy.hypot's algorithm), then EFAC."""
    model, _, tens, tm, tt = pair
    want = np.asarray(model.scaled_sigma(model.params, tens))
    got = tm.scaled_sigma(tm.params, tt).numpy()
    np.testing.assert_array_equal(got, want)
    raw = np.asarray(tens["error_s"])[:-1]
    assert np.all(got > raw)


@pytest.mark.parametrize("fn", ["_ell1_dre_da1", "_ell1_dre_dphi_da1", "_ell1_dre_dphi2_da1"])
def test_ell1_roemer_expansions_match_pint_tpu(fn):
    from pint_tpu.models.binaries import engines as jeng
    from pint_tpu_torch.models.binaries import engines as eng

    rng = np.random.default_rng(5)
    phi = rng.uniform(-np.pi, np.pi, 512)
    e1, e2 = rng.uniform(-0.05, 0.05, (2, 512))
    want = np.asarray(getattr(jeng, fn)(*(jnp.asarray(a) for a in (phi, e1, e2))))
    got = getattr(eng, fn)(*(torch.tensor(a) for a in (phi, e1, e2))).numpy()
    assert np.max(np.abs(got - want)) <= 1e-15 * np.max(np.abs(want))


def test_ell1_delay_and_high_inclination_shapiro(pair):
    """ell1_delay over seeded orbital phases at SINI = sin(88.5 deg), where
    log(1 - SINI sin phi) is largest: finite and within 1 ps."""
    from pint_tpu.models.binaries import engines as jeng
    from pint_tpu_torch.models.binaries import engines as eng

    rng = np.random.default_rng(6)
    n = 512
    phi = np.concatenate([rng.uniform(-np.pi, np.pi, n - 1), [np.pi / 2]])
    dt = rng.uniform(-3e7, 3e7, n)
    pb = 4.766944 * 86400.0 + rng.normal(size=n) * 1e-6
    p = {"A1": 3.9775561, "A1DOT": 1e-14, "EPS1": -5.7e-6, "EPS2": -1.4e-5, "EPS1DOT": 1e-16,
         "EPS2DOT": -1e-16, "M2": 0.26, "SINI": math.sin(math.radians(88.5))}
    want = np.asarray(jeng.ell1_delay({k: jnp.float64(v) for k, v in p.items()},
                                      *(jnp.asarray(a) for a in (dt, phi, np.zeros(n), pb))))
    got = eng.ell1_delay({k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()},
                         *(torch.tensor(a) for a in (dt, phi, np.zeros(n), pb))).numpy()
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) <= 1e-12


def test_binary_tangent_lanes_and_unported_models():
    """The ELL1 lanes, and ELL1H (once unported, ROADMAP A8) built from the
    flagship par with its orthometric parameters on lanes of their own."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import FLAGSHIP_SMOKE_PAR, ell1h_smoke_par
    from pint_tpu_torch.residuals import lane_code, lane_names

    assert [lane_code(n) for n in ("PB", "A1", "TASC", "EPS1", "EPS2", "DM", "DM1")] == [
        5, 6, 7, 8, 9, 32, 33]
    with pytest.raises(ValueError, match="H3 must be set"):
        get_model(FLAGSHIP_SMOKE_PAR.replace("BINARY ELL1", "BINARY ELL1H").replace(
            "SINI 0.99", "STIGMA 0.8"), from_text=True, device="cpu")
    tm = get_model(ell1h_smoke_par("stigma"), from_text=True, device="cpu")
    assert "BinaryELL1H" in tm.component_names and "M2" not in tm.params
    assert [lane_code(n) for n in ("H3", "STIGMA")] == [264, 266]
    assert lane_names(tm.free_params, tm) == tuple(tm.free_params)


def test_apply_delta_projects_onto_domains_bitwise(pair):
    """Every fitter step clamps SINI, M2, EPS1 and EPS2 (on the high word
    of a dd leaf, its low word zeroed) exactly as pint_tpu's apply_delta
    with project_domain=True."""
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu_torch.fitting.wls import apply_delta

    model, _, _, tm, _ = pair
    free = ("SINI", "M2", "EPS1", "EPS2", "PB", "F0", "A1")
    rng = np.random.default_rng(7)
    for _ in range(4):
        delta = rng.normal(size=len(free)) * np.array([0.05, 0.3, 1.0, 1.0, 1e-3, 1e-9, 1e-3])
        want = params_numpy(jax_apply(model.params, free, delta, project_domain=True))
        got = params_numpy(apply_delta(tm.params, free, torch.tensor(delta)))
        assert got == want
    pinned = apply_delta(tm.params, ("SINI", "M2"), torch.tensor([5.0, -5.0]))
    assert float(pinned["SINI"]) == 1.0 - 1e-12 and float(pinned["M2"]) == 0.0


def test_apply_delta_projects_ecc_bitwise():
    """Every fitter step clamps ECC onto [0, 1 - 1e-12] exactly as
    pint_tpu's apply_delta with project_domain=True (DD_SMOKE_PAR)."""
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu_torch.fitting.wls import apply_delta
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import DD_SMOKE_PAR

    jm = build_model(parse_parfile(DD_SMOKE_PAR, from_text=True))
    tm = get_model(DD_SMOKE_PAR, from_text=True, device="cpu")
    free = ("ECC", "OM", "T0", "PB")
    for step in (0.3, -0.5, 0.9, 5.0, -5.0, 1e-7):
        delta = np.array([step, 1e-3, 2e-2, 1e-7])
        want = params_numpy(jax_apply(jm.params, free, delta, project_domain=True))
        assert params_numpy(apply_delta(tm.params, free, torch.tensor(delta))) == want
    pinned = apply_delta(tm.params, ("ECC",), torch.tensor([5.0]))
    assert float(pinned["ECC"]) == 1.0 - 1e-12
    assert float(apply_delta(tm.params, ("ECC",), torch.tensor([-5.0]))["ECC"]) == 0.0


def test_wls_step_pins_sini_as_pint_tpu(pair):
    """A WLS Gauss-Newton step on the ELL1 model with SINI free from 0.9:
    the Shapiro log steepens towards SINI = 1, so the linear step overshoots
    past 1, and both WLSFitters pin SINI at 1 - 1e-12 (bitwise equal), with
    F0 and the uncertainties within 1e-10 relative of pint_tpu's. The chi^2
    at the pin must be finite (unprojected, log(1 - SINI sin phi) is NaN);
    it is not held to 1e-10, since 1 - SINI sin phi ~ 1e-12 near conjunction
    turns an ulp of sin phi into ~1e-4 of that TOA's log."""
    import copy

    from pint_tpu.fitting.wls import WLSFitter as JaxWLSFitter
    from pint_tpu_torch.fitting.wls import WLSFitter

    model, toas, _, tm, tt = (copy.deepcopy(x) for x in pair)
    for m in (model, tm):
        m.set_free(["F0", "SINI"])
    model.params = {**model.params, "SINI": jnp.float64(0.9)}
    tm.params = {**tm.params, "SINI": torch.tensor(0.9, dtype=torch.float64)}
    ref = JaxWLSFitter(toas, model)
    want = ref.fit_toas(maxiter=1)
    ftr = WLSFitter(tt, tm)
    got = ftr.fit_toas(maxiter=1)
    ref_v, v = params_numpy(ref.model.params), params_numpy(ftr.model.params)
    assert v["SINI"] == ref_v["SINI"] == 1.0 - 1e-12
    assert abs(sum(v["F0"]) - sum(ref_v["F0"])) <= 1e-10 * abs(sum(ref_v["F0"]))
    for n, u in want.uncertainties.items():
        assert abs(got.uncertainties[n] - u) <= 1e-10 * u, n
    assert np.isfinite(got.chi2)

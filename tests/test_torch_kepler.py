"""Eccentric binaries against pint_tpu: Kepler's equation, the true anomaly,
the BT, DD and DDS engines, and the DD path (profiles.DD_SMOKE_PAR over
1,024 fake TOAs made by pint_tpu, carried across with the fixture bridge).

Bounds: kepler_E and true_anomaly bitwise (the C library's sin, cos and
atan2 on both sides, the same operations in the same order); their
tangents within 1e-14 relative of jax.jvp; the engines within 1e-15 s;
time residuals within 1 ps and pulse numbers equal; design columns over
every parameter that has a K1 lane, fitted parameters and
uncertainties, and grid chi^2 within 1e-10 relative. pint_tpu's references
run eagerly (``jax.disable_jit``), as in tests/test_torch_fit.py's grid.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fixture import dd_pair, params_numpy

ECCS = (0.0, 1e-12, 0.27, 0.9, 0.97)
#: pint_tpu's tests/test_binary.py DD perturbations, and F0's, in apply_delta's units
START = {"F0": 2e-10, "PB": 1e-7, "A1": 2e-6, "T0": 2e-2, "ECC": 1e-6, "OM": 2e-6}


def anomalies(seed: int = 3) -> np.ndarray:
    """Mean anomalies at 0, +-pi, 2 pi n +- 1e-9 (n up to 1e4 orbits) and
    random values."""
    rng = np.random.default_rng(seed)
    n = np.array([1.0, -1.0, 7.0, -13.0, 1e3, 1e4])
    edges = np.concatenate([2 * np.pi * n + 1e-9, 2 * np.pi * n - 1e-9, 2 * np.pi * n])
    return np.concatenate([[0.0, np.pi, -np.pi], edges, rng.uniform(-40.0, 40.0, 200),
                           rng.uniform(-1e5, 1e5, 50)])


@pytest.fixture(scope="module")
def pair():
    return dd_pair(n=1024)


@pytest.fixture(scope="module", params=["DD", "BT", "DDS"])
def kepler_pair(request, pair):
    """(binary, dd_pair) of each Kepler binary over the same TOAs, each
    built once; DD's is `pair`."""
    binary = request.param
    return binary, pair if binary == "DD" else dd_pair(n=1024, binary=binary)


@pytest.fixture(scope="module")
def fitted(pair):
    """pint_tpu's and the port's DownhillWLSFitter from the moved start, on
    models parsed anew."""
    from pint_tpu.fitting import DownhillWLSFitter as JaxFitter
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu_torch.fitting import DownhillWLSFitter
    from pint_tpu_torch.fitting.wls import apply_delta
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import DD_SMOKE_PAR

    _, toas, _, _, tt = pair
    jm = build_model(parse_parfile(DD_SMOKE_PAR, from_text=True))
    tm = get_model(DD_SMOKE_PAR, from_text=True, device="cpu")
    free = tuple(tm.free_params)
    delta = np.array([START.get(n, 0.0) for n in free])
    jm.params = jax_apply(jm.params, free, delta)
    tm.params = apply_delta(tm.params, free, torch.tensor(delta, dtype=torch.float64))
    want = JaxFitter(toas, jm)
    with jax.disable_jit():
        want.fit_toas()
    got = DownhillWLSFitter(tt, tm)
    got.fit_toas()
    return want, got


def test_libm_atan2_and_exp_against_xla():
    """XLA's CPU atan2 is the C library's, so the twin's (``ops/libm.py``)
    equals jnp.arctan2 bitwise; XLA's CPU exp is its own polynomial, up to
    2 ulp from the C library's that the twin follows."""
    import pint_tpu  # noqa: F401  (turns on jax's float64)
    from pint_tpu_torch.ops import libm

    rng = np.random.default_rng(9)
    n = 20000
    y, x = rng.uniform(-3, 3, (2, n)) * 10.0 ** rng.uniform(-5, 2, (2, n))
    np.testing.assert_array_equal(libm.atan2(torch.tensor(y), torch.tensor(x)).numpy(),
                                  np.asarray(jnp.arctan2(y, x)))
    z = rng.uniform(-40.0, 5.0, n)
    got, want = libm.exp(torch.tensor(z)).numpy(), np.asarray(jnp.exp(z))
    np.testing.assert_array_equal(got, [math.exp(v) for v in z])
    assert np.max(np.abs(got - want) / np.spacing(want)) <= 2.0


@pytest.mark.parametrize("e", ECCS)
def test_kepler_E_and_true_anomaly_bitwise(e):
    from pint_tpu.models.binaries import kepler as jk
    from pint_tpu_torch.models.binaries import kepler

    M = anomalies()
    ee = np.full_like(M, e)
    with jax.disable_jit():
        E_j = jk.kepler_E(jnp.asarray(M), jnp.asarray(ee))
        nu_j = np.asarray(jk.true_anomaly(E_j, jnp.asarray(ee)))
    E = kepler.kepler_E(torch.tensor(M), torch.tensor(ee))
    nu = kepler.true_anomaly(E, torch.tensor(ee))
    np.testing.assert_array_equal(E.numpy(), np.asarray(E_j))
    np.testing.assert_array_equal(nu.numpy(), nu_j)
    resid = E.numpy() - e * np.sin(E.numpy()) - M
    assert np.max(np.abs(resid)) <= 1e-14 * max(1.0, np.max(np.abs(M)))


@pytest.mark.parametrize("e", ECCS[2:])
def test_kepler_tangents_match_jax_jvp(e):
    """The implicit-rule tangent of E and the true anomaly's tangent (atan2
    and sqrt rules), in M and e, against jax.jvp of pint_tpu's."""
    from pint_tpu.models.binaries import kepler as jk
    from pint_tpu_torch.models.binaries import kepler

    M = anomalies()
    ee = np.full_like(M, e)
    rng = np.random.default_rng(4)
    tM, te = rng.normal(size=(2, M.size))

    def jf(m, x):
        E = jk.kepler_E(m, x)
        return E, jk.true_anomaly(E, x)

    def tf(m, x):
        E = kepler.kepler_E(m, x)
        return E, kepler.true_anomaly(E, x)

    with jax.disable_jit():
        _, (dE_j, dnu_j) = jax.jvp(jf, (jnp.asarray(M), jnp.asarray(ee)),
                                   (jnp.asarray(tM), jnp.asarray(te)))
    _, (dE, dnu) = torch.func.jvp(tf, (torch.tensor(M), torch.tensor(ee)),
                                  (torch.tensor(tM), torch.tensor(te)))
    for got, want in ((dE, dE_j), (dnu, dnu_j)):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want) / np.maximum(np.abs(want), 1.0)) <= 1e-14


@pytest.mark.parametrize("engine", ["bt_delay", "dd_delay", "dds_delay"])
def test_engines_match_pint_tpu(engine):
    """The engines over seeded orbital phases, times and periods, with
    every Kepler parameter non-zero: within 1e-15 s."""
    from pint_tpu.models.binaries import engines as jeng
    from pint_tpu_torch.models.binaries import engines as eng

    rng = np.random.default_rng(8)
    n = 512
    phi = rng.uniform(-np.pi, np.pi, n)
    dt = rng.uniform(-5e7, 5e7, n)
    norb = np.round(dt / 36351.7)
    pb = 36351.7 + rng.normal(size=n) * 1e-6
    p = {"A1": 3.729464, "A1DOT": 1e-14, "ECC": 0.27367752, "EDOT": 1e-17, "OM": 4.94,
         "OMDOT": 1.7557 * math.pi / 180 / 3.15576e7, "GAMMA": 2.056e-3, "M2": 0.25,
         "SINI": 0.99895068, "SHAPMAX": 6.859612943656104, "DR": 1e-6, "DTH": 2e-6,
         "A0": 1e-7, "B0": -2e-7}
    with jax.disable_jit():
        want = np.asarray(getattr(jeng, engine)({k: jnp.float64(v) for k, v in p.items()},
                                                *(jnp.asarray(a) for a in (dt, phi, norb, pb))))
    got = getattr(eng, engine)({k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()},
                               *(torch.tensor(a) for a in (dt, phi, norb, pb))).numpy()
    assert np.all(np.isfinite(got)) and np.max(np.abs(want)) > 1.0
    assert np.max(np.abs(got - want)) <= 1e-15


def test_time_residuals_within_1ps(kepler_pair):
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu_torch.residuals import Residuals

    binary, (model, toas, tens, tm, tt) = kepler_pair
    assert tm.component_names == model.component_names
    assert f"Binary{binary}" in tm.component_names
    assert params_numpy(tm.params) == params_numpy(model.params)
    with jax.disable_jit():
        want = JaxResiduals(toas, model, tensor=tens)
        wr, wpn = np.asarray(want.time_resids), np.asarray(want.pulse_numbers)
    got = Residuals(tt, tm)
    assert np.max(np.abs(got.time_resids.numpy() - wr)) <= 1e-12
    np.testing.assert_array_equal(got.pulse_numbers.numpy(), wpn)


def test_design_columns_over_every_lane(kepler_pair):
    """pint_tpu's WLS step with every parameter that has a K1 lane free
    against the port's (K1's twin), column by column."""
    import copy

    from pint_tpu.fitting import DownhillWLSFitter as JaxFitter
    from pint_tpu_torch.fitting.wls import wls_step
    from pint_tpu_torch.residuals import Residuals, lane_names

    binary, (model, toas, tens, tm, tt) = kepler_pair
    model, tm = copy.deepcopy(model), copy.deepcopy(tm)
    free = list(lane_names(tm.params))
    assert {"T0", "ECC", "OM", "OMDOT"} <= set(free) and len(free) >= 20, binary
    model.set_free(free)
    tm.set_free(free)
    jf = JaxFitter(toas, model)
    with jax.disable_jit():
        M_j = np.asarray(jf._step_fn(model.params, tens)[1])
    res = Residuals(tt, tm)
    assert tuple(tm.free_params) == jf._free
    M = wls_step(tm, tuple(tm.free_params), tm.params, tt, res.weights, res.errors_s,
                 True)[1].numpy()
    for i, n in enumerate(tm.free_params):
        scale = np.max(np.abs(M_j[:, i]))
        assert np.max(np.abs(M[:, i] - M_j[:, i])) <= 1e-10 * scale, n


def test_downhill_fit_matches_pint_tpu(fitted):
    from tests.test_torch_fit import leaf

    want, got = fitted
    rw, rg = want.result, got.result
    assert rg.converged and rw.converged and rg.iterations == rw.iterations >= 2
    assert 0.8 <= rg.reduced_chi2 <= 1.2
    assert len(got._free) == 10
    for n in got._free:
        a, b = leaf(want.model.params[n]), leaf(got.model.params[n])
        assert abs(b - a) <= 1e-10 * abs(a), n
        ua, ub = rw.uncertainties[n], rg.uncertainties[n]
        assert abs(ub - ua) <= 1e-10 * ua, n


def test_m2_sini_grid_matches_pint_tpu(pair, fitted):
    from pint_tpu.fitting import DownhillWLSFitter as JaxFitter
    from pint_tpu.gridutils import grid_chisq as jax_grid
    from pint_tpu.ops.dd import DD as JaxDD
    from pint_tpu_torch.gridutils import grid_chisq
    from pint_tpu_torch.profiles import grid_for

    _, toas, _, _, _ = pair
    want_ftr, ftr = fitted
    jm = want_ftr.model
    jm.params = {k: JaxDD(jnp.float64(v[0]), jnp.float64(v[1])) if isinstance(v, tuple)
                 else jnp.float64(v) for k, v in params_numpy(ftr.model.params).items()}
    names, vals = grid_for(ftr.model, ftr)
    assert names == ("M2", "SINI")
    got = grid_chisq(ftr, names, vals)
    with jax.disable_jit():
        want = np.asarray(jax_grid(JaxFitter(toas, jm), names, vals))
    assert got.shape == want.shape == (3, 3)
    assert np.max(np.abs(got - want) / want) <= 1e-10


@pytest.mark.parametrize("change", [
    ("BINARY DD\n", "BINARY DDGR\n"), ("BINARY DD\n", "BINARY DDK\n"),
    ("BINARY DD\n", "BINARY ELL1H\n"), ("BINARY DD\n", "BINARY ELL1K\n"),
    ("PB 0.420737298879 1\n", "FB0 2.75089e-05 1\n")])
def test_other_binaries_build_and_validate(change):
    """The binaries that once raised naming ROADMAP A8 (DDGR, DDK, ELL1H,
    ELL1K, and the FB orbital-frequency form) build from DD_SMOKE_PAR's
    lines with the parameters and validation pint_tpu gives them: DDGR
    refuses the post-Keplerian lines it derives, the ELL1 family needs TASC,
    and the FB form takes FB0 as a dd leaf in PB's place."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import DD_SMOKE_PAR
    from pint_tpu_torch.ops.dd import DD

    assert change[0] in DD_SMOKE_PAR
    par = DD_SMOKE_PAR.replace(*change)
    if "DDGR" in change[1]:
        with pytest.raises(ValueError, match="derives"):
            get_model(par, from_text=True, device="cpu")
        par = "".join(ln + "\n" for ln in par.splitlines()
                      if ln.split()[:1] not in (["OMDOT"], ["PBDOT"], ["GAMMA"], ["SINI"]))
        par += "MTOT 2.678 1\n"
    if "ELL1" in change[1]:
        with pytest.raises(ValueError, match="requires TASC"):
            get_model(par, from_text=True, device="cpu")
        par = par.replace("T0 55500.2 1\n", "TASC 55500.2 1\nEPS1 1e-5 1\n")
    tm = get_model(par, from_text=True, device="cpu")
    jm = build_model(parse_parfile(par, from_text=True))
    assert tm.component_names == jm.component_names
    assert sorted(tm.params) == sorted(jm.params)
    assert sorted(tm.free_params) == sorted(jm.free_params)
    if "FB0" in change[1]:
        assert "PB" not in tm.params and isinstance(tm.params["FB0"], DD)
        assert tm["BinaryDD"].fb_terms == 1


@pytest.mark.parametrize("binary", ["BT", "DD", "DDS"])
def test_kepler_models_build_and_validate(binary):
    """BT, DD and DDS build from the same par (DDS without SINI, with
    SHAPMAX); ECC outside [0, 1) is refused."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import dd_smoke_par

    tm = get_model(dd_smoke_par(binary), from_text=True, device="cpu")
    assert f"Binary{binary}" in tm.component_names and len(tm.free_params) == 10
    assert ("SINI" in tm.params) == (binary != "DDS") and ("SHAPMAX" in tm.params) == (
        binary == "DDS")
    assert abs(float(tm.params["OM"]) - math.radians(283.0)) <= 1e-15
    with pytest.raises(ValueError, match="ECC"):
        get_model(dd_smoke_par(binary).replace("ECC 0.27367752", "ECC 1.0"), from_text=True,
                  device="cpu")

"""The rest of pint_tpu's binaries against pint_tpu: ELL1H (h3, h4 and
stigma modes), ELL1K, DDGR, DDK and the FB orbital-frequency form, with
the read-only derived parameters of DDS and DDGR.

Inputs are made from seeds: ``profiles.DDGR_SMOKE_PAR`` and
``profiles.DDK_SMOKE_PAR`` over 1,024 fake TOAs of their recipes
(`DDGR_RECIPE`, `DDK_RECIPE`), and the ELL1-family pars over the
flagship's 1,024 (``flagship_smoke_dataset``). pint_tpu runs eagerly
(``jax.disable_jit``), as in tests/test_torch_kepler.py.

Bounds: the C library's pow equals XLA's CPU pow bitwise on DDGR's inputs;
the engines within 1e-15 s; ddgr_derived and ddk_corrections bitwise on the
value, tangents within 1e-14 relative of jax.jvp; get_derived within 1e-15
relative; time residuals within 1 ps with pulse numbers equal; design
columns over every lane within 1e-10 relative; fitted parameters and
uncertainties, and grid chi^2 from the same fitted parameters, within 1e-10
relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import grid_sensitivity
from tests.test_torch_fixture import flagship_pair, params_numpy, recipe_pair

N = 1024
#: DDGR and DDK over their recipes' TOAs, the ELL1 family over the flagship's
FORMS = ("DDGR", "DDK", "ELL1H-stigma", "ELL1H-h4", "ELL1H-h3", "ELL1K", "FB")
#: each form's start shift for the fit (apply_delta's units)
KEPLER_SHIFT = {"F0": 2e-10, "PB": 1e-7, "A1": 2e-6, "T0": 2e-2, "ECC": 1e-6, "OM": 2e-6}
DDK_SHIFT = {"F0": 2e-10, "PB": 1e-7, "A1": 2e-6, "KIN": 1e-4, "KOM": 1e-4}
FLAGSHIP_SHIFT = {"F0": 2e-10, "DM": 1e-3, "EPS1": 1e-7}


def form_par(form: str) -> str:
    from pint_tpu_torch import profiles

    return {"DDGR": profiles.DDGR_SMOKE_PAR, "DDK": profiles.DDK_SMOKE_PAR,
            "ELL1K": profiles.ELL1K_SMOKE_PAR, "FB": profiles.fb_smoke_par()}.get(form) or \
        profiles.ell1h_smoke_par(form.split("-")[1])


def form_pair(form: str, n: int = N):
    """(pint_tpu model, toas, tensor, port model, port tensor) of `form`."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu_torch.models import get_model

    if form in ("DDGR", "DDK"):
        return recipe_pair(form.lower(), n)
    _, toas, tens, _, tt = flagship_pair(n)
    par = form_par(form)
    return (build_model(parse_parfile(par, from_text=True)), toas, tens,
            get_model(par, from_text=True, device="cpu"), tt)


@pytest.fixture(scope="module", params=FORMS)
def pair(request):
    return request.param, form_pair(request.param)


def moved(form: str, jm, tm):
    """Both models moved off the solution by the form's start shift."""
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu_torch.fitting.wls import apply_delta

    shift = {"DDGR": KEPLER_SHIFT, "DDK": DDK_SHIFT}.get(form, FLAGSHIP_SHIFT)
    free = tuple(tm.free_params)
    delta = np.array([shift.get(n, 0.0) for n in free])
    jm.params = jax_apply(jm.params, free, delta, project_domain=True)
    tm.params = apply_delta(tm.params, free, torch.tensor(delta))
    assert params_numpy(jm.params) == params_numpy(tm.params)


#: the fits: WLS for the Kepler-orbit models, GLS (the flagship's ECORR) for
#: the ELL1 family
FIT_FORMS = ("DDGR", "DDK", "ELL1H-stigma", "ELL1K", "FB")


@pytest.fixture(scope="module", params=FIT_FORMS)
def fitted(request):
    """pint_tpu's (eager) and the port's downhill fit of the form from the
    moved start, on models parsed anew."""
    from pint_tpu.fitting import DownhillGLSFitter as JaxGLS
    from pint_tpu.fitting import DownhillWLSFitter as JaxWLS
    from pint_tpu_torch.fitting import DownhillGLSFitter, DownhillWLSFitter

    form = request.param
    jm, toas, _, tm, tt = form_pair(form)
    moved(form, jm, tm)
    gls = form not in ("DDGR", "DDK")
    want = (JaxGLS if gls else JaxWLS)(toas, jm)
    with jax.disable_jit():
        want.fit_toas()
    got = (DownhillGLSFitter if gls else DownhillWLSFitter)(tt, tm)
    got.fit_toas()
    return form, toas, want, got


# --- pow, the engines, the derived scalars -----------------------------------------


def ddgr_inputs(seed: int = 12, n: int = 64) -> dict:
    """DDGR's inputs around DDGR_SMOKE_PAR's values, and the extremes of its
    masses and eccentricity."""
    rng = np.random.default_rng(seed)
    return {"MTOT": rng.uniform(1.0, 3.5, n), "M2": rng.uniform(0.1, 1.4, n),
            "ECC": np.concatenate([[0.0, 1e-7, 0.27367752, 0.9], rng.uniform(0, 0.95, n - 4)]),
            "A1": rng.uniform(0.5, 40.0, n), "PB": rng.uniform(3e3, 6e6, n),
            "XOMDOT": rng.normal(size=n) * 1e-12}


def test_libm_pow_against_xla():
    """XLA's CPU pow of a float exponent is the C library's bitwise on DDGR's
    bases (n, Tsun MTOT, MTOT, 1 - e^2) and exponents, and so the twin's
    (``ops/libm.py``)."""
    import pint_tpu  # noqa: F401  (turns on jax's float64)
    from pint_tpu_torch import TSUN_S
    from pint_tpu_torch.ops import libm

    x = ddgr_inputs(n=2000)
    bases = np.concatenate([2 * np.pi / x["PB"], TSUN_S * x["MTOT"], x["MTOT"],
                            1.0 - x["ECC"] ** 2])
    for y in (2 / 3, 5 / 3, -1 / 3, 4 / 3, 1 / 3, 3.5, 2 / 3 - 1, 5 / 3 - 1, -1 / 3 - 1,
              4 / 3 - 1, 1 / 3 - 1, 2.5):
        got = libm.pow(torch.tensor(bases), y).numpy()
        with jax.disable_jit():
            want = np.asarray(jnp.power(jnp.asarray(bases), y))
        np.testing.assert_array_equal(got, want, err_msg=str(y))
        np.testing.assert_array_equal(got, [math.pow(b, y) for b in bases], err_msg=str(y))


@pytest.mark.parametrize("engine", ["ell1h-h3", "ell1h-h4", "ell1h-stigma", "ell1k"])
def test_engines_match_pint_tpu(engine):
    """ELL1H's three modes (h4 at 7 harmonics) and ELL1K over seeded phases,
    times and periods, every parameter non-zero: within 1e-15 s."""
    from pint_tpu.models.binaries import engines as jeng
    from pint_tpu_torch.models.binaries import engines as eng

    rng = np.random.default_rng(14)
    n = 512
    phi = np.concatenate([rng.uniform(-np.pi, np.pi, n - 1), [np.pi / 2]])
    dt = rng.uniform(-3e7, 3e7, n)
    pb = 4.766944 * 86400.0 + rng.normal(size=n) * 1e-6
    p = {"A1": 3.9775561, "A1DOT": 1e-14, "EPS1": -5.7e-6, "EPS2": -1.4e-5, "EPS1DOT": 1e-16,
         "EPS2DOT": -1e-16, "M2": 0.26, "SINI": 0.99, "H3": 8.36e-7, "H4": 7.25e-7,
         "STIGMA": 0.8676, "OMDOT": 2e-9, "LNEDOT": 3e-10}
    name, _, mode = engine.partition("-")
    kw = {"nharms": 7 if mode == "h4" else 3, "mode": mode} if mode else {}
    args = (dt, phi, np.zeros(n), pb)
    with jax.disable_jit():
        want = np.asarray(getattr(jeng, f"{name}_delay")(
            {k: jnp.float64(v) for k, v in p.items()}, *(jnp.asarray(a) for a in args), **kw))
    got = getattr(eng, f"{name}_delay")({k: torch.tensor(v, dtype=torch.float64)
                                         for k, v in p.items()},
                                        *(torch.tensor(a) for a in args), **kw).numpy()
    assert np.all(np.isfinite(got)) and np.max(np.abs(want)) > 1.0
    assert np.max(np.abs(got - want)) <= 1e-15


def test_ddgr_derived_and_tangents_match_pint_tpu():
    """The six GR-derived values bitwise, and their derivatives in each of
    the six inputs within 1e-14 relative of jax.jvp."""
    from pint_tpu.models.binaries import engines as jeng
    from pint_tpu_torch.models.binaries import engines as eng

    x = ddgr_inputs()
    keys = eng.DDGR_INPUTS

    def jf(*vals):
        d = jeng.ddgr_derived(dict(zip(keys, vals)))
        return [d[k] for k in eng.DDGR_DERIVED]

    def tf(*vals):
        d = eng.ddgr_derived(dict(zip(keys, vals)))
        return tuple(d[k] for k in eng.DDGR_DERIVED)

    for i, key in enumerate(keys):
        t = [np.zeros_like(x[k]) if j != i else np.ones_like(x[k]) for j, k in enumerate(keys)]
        with jax.disable_jit():
            want, dwant = jax.jvp(jf, tuple(jnp.asarray(x[k]) for k in keys),
                                  tuple(jnp.asarray(v) for v in t))
        got, dgot = torch.func.jvp(tf, tuple(torch.tensor(x[k]) for k in keys),
                                   tuple(torch.tensor(v) for v in t))
        for k, g, w, dg, dw in zip(eng.DDGR_DERIVED, got, want, dgot, dwant):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
            dw = np.asarray(dw)
            err = np.abs(dg.numpy() - dw)
            assert np.all(err <= 1e-14 * np.abs(dw)), (key, k, np.max(err / np.abs(dw)))


def test_ddk_corrections_and_tangents_match_pint_tpu():
    """DDK's per-TOA A1, OM and SINI on the DDK dataset (the pulsar
    direction with proper motion, the site positions) bitwise, and their
    tangents in KIN, KOM, PMRA, PMDEC, PX, RAJ, DECJ and T0 within 1e-14
    relative of jax.jvp (the KIN lane's A1 cancels to ~1e-7 of its terms:
    both sides take jax's division rule there)."""
    from pint_tpu.models.binaries import engines as jeng
    from pint_tpu_torch.models.binaries import engines as eng
    from pint_tpu_torch.ops.dd import DD, dd_add_fp

    jm, _, tens, tm, tt = form_pair("DDK")
    lanes = ("KIN", "KOM", "PMRA", "PMDEC", "PX", "RAJ", "DECJ", "T0")
    rng = np.random.default_rng(15)
    steps = rng.normal(size=len(lanes)) * np.array([1e-3, 1e-2, 1e-17, 1e-17, 1e-10, 1e-10,
                                                    1e-10, 10.0])

    def jf(*d):
        from pint_tpu.ops.dd import dd_add_fp as jadd

        p = dict(jm.params)
        for n, v in zip(lanes, d):
            p[n] = jadd(p[n], v) if hasattr(p[n], "hi") else p[n] + v
        out = jeng.ddk_corrections(p, jm._with_context(p, tens))
        return [out[k] for k in ("A1", "OM", "SINI")]

    def tf(*d):
        p = dict(tm.params)
        for n, v in zip(lanes, d):
            p[n] = dd_add_fp(p[n], v) if isinstance(p[n], DD) else p[n] + v
        out = eng.ddk_corrections(p, tm._with_context(p, tt))
        return tuple(out[k] for k in ("A1", "OM", "SINI"))

    zeros = tuple(np.zeros(()) for _ in lanes)
    with jax.disable_jit():
        want, dwant = jax.jvp(jf, tuple(jnp.asarray(z) for z in zeros),
                              tuple(jnp.asarray(s) for s in steps))
    got, dgot = torch.func.jvp(tf, tuple(torch.tensor(z) for z in zeros),
                               tuple(torch.tensor(s) for s in steps))
    for k, g, w, dg, dw in zip(("A1", "OM", "SINI"), got, want, dgot, dwant):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
        dw = np.asarray(dw)
        assert np.max(np.abs(dg.numpy() - dw)) <= 1e-14 * np.max(np.abs(dw)), k


def test_derived_params_match_pint_tpu():
    """DDS's read-only SINI and DDGR's six through get_derived, within
    1e-15 relative; a derived name is no fit parameter."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.models.binaries.engines import DDGR_DERIVED
    from pint_tpu_torch.profiles import DDGR_SMOKE_PAR, dd_smoke_par

    for par, names in ((dd_smoke_par("DDS"), ("SINI",)), (DDGR_SMOKE_PAR, DDGR_DERIVED)):
        jm = build_model(parse_parfile(par, from_text=True))
        tm = get_model(par, from_text=True, device="cpu")
        assert sorted(tm.derived_params) == sorted(jm.derived_params) == sorted(names)
        for n in names:
            want = jm.get_derived(n)
            assert n not in tm.params
            assert abs(tm.get_derived(n) - want) <= 1e-15 * abs(want), n
    assert tm.get_derived("MTOT") == jm.get_derived("MTOT") == 2.678
    with pytest.raises(KeyError):
        tm.get_derived("KIN")


# --- residuals and the design, per form ---------------------------------------------


def test_time_residuals_within_1ps(pair):
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu_torch.residuals import Residuals

    form, (model, toas, tens, tm, tt) = pair
    assert tm.component_names == model.component_names
    assert params_numpy(tm.params) == params_numpy(model.params)
    with jax.disable_jit():
        want = JaxResiduals(toas, model, tensor=tens)
        wr, wpn = np.asarray(want.time_resids), np.asarray(want.pulse_numbers)
    got = Residuals(tt, tm)
    assert np.std(wr) < 1e-4, form
    assert np.max(np.abs(got.time_resids.numpy() - wr)) <= 1e-12, form
    np.testing.assert_array_equal(got.pulse_numbers.numpy(), wpn)


def test_design_columns_over_every_lane(pair):
    """pint_tpu's WLS step with every parameter that has a K1 lane free
    against the port's (K1's twin), column by column."""
    import copy

    from pint_tpu.fitting import DownhillWLSFitter as JaxFitter
    from pint_tpu_torch.fitting.wls import wls_step
    from pint_tpu_torch.residuals import Residuals, lane_names

    form, (model, toas, tens, tm, tt) = pair
    model, tm = copy.deepcopy(model), copy.deepcopy(tm)
    free = list(lane_names(tm.params, tm))
    new = {"DDGR": {"MTOT", "XOMDOT", "XPBDOT"}, "DDK": {"KIN", "KOM"},
           "ELL1K": {"OMDOT", "LNEDOT"}, "FB": {"FB0", "FB1", "FB2"}}.get(
        form, {"H3", {"ELL1H-stigma": "STIGMA", "ELL1H-h4": "H4"}.get(form, "H3")})
    assert new <= set(free), form
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
        assert np.max(np.abs(M[:, i] - M_j[:, i])) <= 1e-10 * scale, (form, n)


# --- fits and grids -------------------------------------------------------------------


def test_downhill_fit_matches_pint_tpu(fitted):
    from tests.test_torch_fit import leaf

    form, _, want, got = fitted
    rw, rg = want.result, got.result
    assert rg.converged and rw.converged and rg.iterations == rw.iterations >= 1
    assert 0.8 <= rg.reduced_chi2 <= 1.2, form
    for n in got._free:
        a, b = leaf(want.model.params[n]), leaf(got.model.params[n])
        assert abs(b - a) <= 1e-10 * abs(a), (form, n)
        ua, ub = rw.uncertainties[n], rg.uncertainties[n]
        assert abs(ub - ua) <= 1e-10 * ua, (form, n)


def test_grid_matches_pint_tpu(fitted):
    """The form's 3x3 grid (``profiles.grid_for``: DDGR's (MTOT, M2), DDK's
    (KIN, KOM), ELL1H's (H3, STIGMA), else (M2, SINI)) from the port's fitted
    parameters, in both packages."""
    from pint_tpu.fitting import DownhillGLSFitter as JaxGLS
    from pint_tpu.fitting import DownhillWLSFitter as JaxWLS
    from pint_tpu.gridutils import grid_chisq as jax_grid
    from pint_tpu.ops.dd import DD as JaxDD
    from pint_tpu_torch.fitting import DownhillGLSFitter
    from pint_tpu_torch.gridutils import grid_chisq
    from pint_tpu_torch.profiles import grid_for

    form, toas, want_ftr, ftr = fitted
    jm = want_ftr.model
    jm.params = {k: JaxDD(jnp.float64(v[0]), jnp.float64(v[1])) if isinstance(v, tuple)
                 else jnp.float64(v) for k, v in params_numpy(ftr.model.params).items()}
    names, vals = grid_for(ftr.model, ftr)
    assert names == {"DDGR": ("MTOT", "M2"), "DDK": ("KIN", "KOM"),
                     "ELL1H-stigma": ("H3", "STIGMA")}.get(form, ("M2", "SINI"))
    got = grid_chisq(ftr, names, vals)
    cls = JaxGLS if isinstance(ftr, DownhillGLSFitter) else JaxWLS
    with jax.disable_jit():
        want = np.asarray(jax_grid(cls(toas, jm), names, vals))
    assert got.shape == want.shape == (3, 3) and np.all(np.isfinite(got))
    err = np.max(np.abs(got - want) / want)
    if err > 1e-10:  # the witness rule: DDK's refits amplify 1e-15 by ~1e5
        assert err <= 10 * grid_sensitivity(ftr, names, vals, got), (form, err)


# --- what the port refuses, and the kernel's view ---------------------------------------


@pytest.mark.parametrize("change, error, match", [
    ("DDK-ecliptic", NotImplementedError, "equatorial astrometry"),
    ("DDGR-SINI", ValueError, "derives"),
    ("ELL1H-H4-STIGMA", ValueError, "H4 or STIGMA but not both"),
    ("PB-FB0", ValueError, "both FB0 and PB"),
    ("FB-gap", ValueError, "without gaps"),
    ("ELL1H-H3-zero", ValueError, "H3 must be set and nonzero"),
])
def test_refusals_match_pint_tpu(change, error, match):
    """What pint_tpu refuses the port refuses: DDK with ecliptic astrometry,
    a DDGR par that sets a derived parameter, ELL1H with both H4 and
    STIGMA, PB with FB0, FB indices with a gap, ELL1H's STIGMA without H3."""
    from pint_tpu_torch import profiles
    from pint_tpu_torch.models import get_model

    ddk = profiles.DDK_SMOKE_PAR
    par = {
        "DDK-ecliptic": ddk.replace("RAJ 17:13:49.5331 1\nDECJ 07:47:37.492 1\n"
                                    "PMRA 4.92 1\nPMDEC -3.92 1\n",
                                    "ELONG 256.67 1\nELAT 30.7 1\nPMELONG 5.2 1\n"
                                    "PMELAT -3.5 1\n"),
        "DDGR-SINI": profiles.DDGR_SMOKE_PAR + "SINI 0.97\n",
        "ELL1H-H4-STIGMA": profiles.ell1h_smoke_par("stigma") + "H4 7e-7 1\n",
        "PB-FB0": profiles.FLAGSHIP_SMOKE_PAR + "FB0 2.4e-6 1\n",
        "FB-gap": profiles.fb_smoke_par().replace("FB2 0.0\n", "FB3 0.0\n"),
        "ELL1H-H3-zero": profiles.ell1h_smoke_par("stigma").replace(
            f"H3 {profiles._FLAGSHIP_H3!r}", "H3 0.0"),
    }[change]
    with pytest.raises(error, match=match):
        get_model(par, from_text=True, device="cpu")


def test_kernel_view_of_the_new_models():
    """K1's structure of each model (kind, model, FB terms, ELL1H's mode and
    harmonics), DDGR's packed derived values and Jacobian, and the caps:
    FB0-FB7 have lanes, FB8 has none and more than 8 FB terms or 20
    harmonics are refused naming the cap."""
    from pint_tpu_torch import profiles
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.models.binaries.engines import DDGR_DERIVED
    from pint_tpu_torch.residuals import (BIN_ELL1, BIN_KEPLER, MAX_FB, _pack_params,
                                          _structure, ddgr_jacobian, lane_code)

    def build(par):
        return get_model(par, from_text=True, device="cpu")

    want = {"DDGR": (BIN_KEPLER, 2, 0, 0, 0), "DDK": (BIN_KEPLER, 3, 0, 0, 0),
            "ELL1H-stigma": (BIN_ELL1, 1, 0, 2, 3), "ELL1H-h4": (BIN_ELL1, 1, 0, 1, 7),
            "ELL1H-h3": (BIN_ELL1, 1, 0, 0, 3), "ELL1K": (BIN_ELL1, 2, 0, 0, 0),
            "FB": (BIN_ELL1, 0, 3, 0, 0)}
    for form, (kind, model, n_fb, h_mode, nharms) in want.items():
        st = _structure(build(form_par(form)))
        assert (st.bin_kind, st.bin_model, st.n_fb, st.h_mode, st.nharms) == (
            kind, model, n_fb, h_mode, nharms), form
    m = build(profiles.DDGR_SMOKE_PAR)
    derived, jac = ddgr_jacobian(m.params)
    P = _pack_params(m, m.params, 1, _structure(m), "cpu")[0]
    # resid_tangent.cu's row: P_PBDOT 19, P_XPBDOT 20, P_SINI 22, P_OMDOT 26,
    # P_JAC 48-83, P_DM0 84, then DM and the (hi, lo) pairs of F0 and F1
    assert P.shape == (84 + 1 + 4,) and jac.shape == (1, 6, 6)
    assert [float(P[i]) for i in (19, 20, 22, 26)] == [
        float(derived["PBDOT"]), 0.0, float(derived["SINI"]), float(derived["OMDOT"])]
    assert torch.equal(P[48:84], jac.reshape(36)) and len(DDGR_DERIVED) == 6
    assert [lane_code(f"FB{k}") for k in range(MAX_FB)] == list(range(256, 264))
    with pytest.raises(NotImplementedError, match="FB0-FB7"):
        lane_code("FB8")
    many = profiles.fb_smoke_par().replace("FB2 0.0\n", "".join(
        f"FB{k} 0.0\n" for k in range(2, MAX_FB + 1)))
    with pytest.raises(NotImplementedError, match="at most 8 FB terms"):
        _structure(build(many))
    with pytest.raises(NotImplementedError, match="at most 20 ELL1H harmonics"):
        _structure(build(profiles.ell1h_smoke_par("h3").replace("NHARMS 3", "NHARMS 21")))

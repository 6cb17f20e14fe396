"""The port's NANOGrav-shaped path against pint_tpu: ecliptic astrometry,
DMX, FD, a phase JUMP, power-law red (and DM) noise, on
``profiles.nanograv_smoke_par(n_dmx=8, nf=10)`` over 1,024 TOAs in 128
epochs made by pint_tpu (p = 24 free parameters, kd = 20 Fourier columns;
40 with DM noise).

Bounds: the ecliptic direction and every new delay within 1e-15 relative;
time residuals within 1 ps and pulse numbers equal; every tangent lane,
closed-form (K8's twin) and Fourier column within 1e-10 relative; the
Woodbury chi^2 within 1e-10 and log|C| within 1e-8 relative (ECORR + red,
ECORR + red + DM noise); one GLS step's normal matrix and right-hand side
within 1e-10 relative; the downhill GLS fit's parameters and uncertainties
within 1e-10 relative where the normal matrix is well conditioned. The DMX,
FD and JUMP columns are nearly degenerate over the two receivers (condition
number ~2.4e6), so the two packages' normal matrices, which agree to ~1e-15
(their sums run in other orders), give fits ~3e-10 sigma apart there. A
witness measures that amplification: pint_tpu's own fit through normal
matrices perturbed by 1e-15 of their diagonals (`moved`). Each parameter and
uncertainty is held to 1e-10 relative or ten times the witness's distance,
and the (M2, SINI) grid to 1e-10 relative or ten times its own movement
under the same perturbation (``chip_smoke.grid_sensitivity``). pint_tpu
runs eagerly (``jax.disable_jit``; ROADMAP C1), as in
``tests/test_torch_gls.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import grid_sensitivity
from tests.test_torch_fixture import nanograv_pair, params_numpy

#: the fit's start: the truth moved (apply_delta's units: Hz, s, pc cm^-3)
START = {"F0": 2e-10, "EPS1": 1e-7, "DMX_0001": 1e-4, "JUMP1": 1e-6, "FD1": 1e-6}
#: the witness's perturbation of pint_tpu's normal matrices, relative to
#: their diagonals: the size of the difference of two sums run in other orders
GRAM_EPS = 1e-15


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.max(np.abs(want)) if want.size else 0.0
    diff = np.max(np.abs(got - want)) if want.size else 0.0
    return diff / scale if scale else diff


def leaf(v) -> float:
    return float(v.hi) + float(v.lo) if hasattr(v, "hi") else float(v)


@pytest.fixture(scope="module")
def pair():
    return nanograv_pair(1024)


def shifted(pair, dm_noise=False):
    """(jax model, port model) parsed anew, moved by START."""
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu_torch.fitting.wls import apply_delta
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import nanograv_smoke_par

    par = nanograv_smoke_par(8, 10, dm_noise)
    jm = build_model(parse_parfile(par, from_text=True))
    tm = get_model(par, from_text=True, device="cpu")
    free = tuple(jm.free_params)
    assert free == tuple(tm.free_params)
    delta = np.array([START.get(n, 0.0) for n in free])
    jm.params = jax_apply(jm.params, free, delta)
    tm.params = apply_delta(tm.params, free, torch.tensor(delta))
    assert params_numpy(jm.params) == params_numpy(tm.params)
    return jm, tm


@pytest.fixture(scope="module")
def fits(pair):
    """The DownhillGLSFitter of both packages from the shifted start, and
    pint_tpu's first GLS step (its inputs and outputs)."""
    from pint_tpu.fitting import DownhillGLSFitter as JaxFitter
    from pint_tpu_torch.fitting import DownhillGLSFitter

    _, toas, _, _, tt = pair
    jm, tm = shifted(pair)
    want = JaxFitter(toas, jm)
    steps = []
    step_fn = want._step_fn

    def first_step(params, tensor):
        out = step_fn(params, tensor)
        if not steps:
            steps.append([np.asarray(a) for a in out])
        return out

    want._step_fn = first_step
    start = dict(tm.params)
    with jax.disable_jit():
        want.fit_toas()
    got = DownhillGLSFitter(tt, tm)
    got.fit_toas()
    return jm, tm, want, got, (start, steps[0])


@pytest.fixture(scope="module")
def moved(pair):
    """pint_tpu's fit from the same start with every GLS normal matrix G
    moved by GRAM_EPS * S_ij * sqrt(G_ii G_jj), as
    ``chip_smoke.perturbed_normal_eq`` moves the port's (S its symmetric +-1
    pattern): (its model, the fitter)."""
    from pint_tpu.fitting import DownhillGLSFitter as JaxFitter

    _, toas, _, _, _ = pair
    jm, _ = shifted(pair)
    ftr = JaxFitter(toas, jm)
    step_fn = ftr._step_fn

    def perturbed(params, tensor):
        out = list(step_fn(params, tensor))
        G = out[2]
        sign = np.random.default_rng(5).choice([-1.0, 1.0], G.shape)
        d = jnp.sqrt(jnp.abs(jnp.diagonal(G)))
        out[2] = G + GRAM_EPS * jnp.asarray(np.triu(sign) + np.triu(sign, 1).T) * d[:, None] * d
        return tuple(out)

    ftr._step_fn = perturbed
    with jax.disable_jit():
        ftr.fit_toas()
    return jm, ftr


# --- the model ----------------------------------------------------------------------


def test_model_is_nanograv_shaped(pair):
    model, _, tens, tm, tt = pair
    assert tm.component_names == [c.name for c in model.components]
    assert len(tm.free_params) == 24 and tm.free_params == list(model.free_params)
    assert tt["dmx_onehot"].shape == (1025, 8) and tt["noise_tspan"].shape == (1, 1)
    assert tm.meta["TNREDC"] == 10 and tm.meta["ECL"] == "IERS2010"
    from pint_tpu_torch.profiles import NANOGRAV_SMOKE_PAR
    from pint_tpu_torch.models import get_model

    assert len(get_model(NANOGRAV_SMOKE_PAR, from_text=True, device="cpu").free_params) == 80


def test_ecliptic_direction_and_new_delays(pair):
    """The obliquity's cosine and sine bitwise as XLA's, the pulsar
    direction, and the DMX, FD and jump terms within 1e-15 relative."""
    from pint_tpu.models.astrometry import OBL_RAD
    from pint_tpu_torch.models.astrometry import COS_OBL, SIN_OBL

    model, _, tens, tm, tt = pair
    with jax.disable_jit():
        assert (COS_OBL, SIN_OBL) == (float(jnp.cos(OBL_RAD)), float(jnp.sin(OBL_RAD)))
        jt = model._with_context(model.params, tens)
        want = {"dir": jt["_psr_dir"]}
        for name in ("DispersionDMX", "FD"):
            want[name] = model[name].delay(model.params, jt, None, model.xprec)
        jp = model["PhaseJump"].phase(model.params, jt, None, model.xprec)
        want["jump"] = np.asarray(jp.hi) + np.asarray(jp.lo)
    t = tm._with_context(tm.params, tt)
    got = {"dir": t["_psr_dir"]}
    for name in ("DispersionDMX", "FD"):
        got[name] = tm[name].delay(tm.params, t, None, tm.xprec)
    gp = tm["PhaseJump"].phase(tm.params, t, None, tm.xprec)
    got["jump"] = gp.hi + gp.lo
    for k in want:
        assert rel(got[k].numpy(), want[k]) <= 1e-15, k
    assert np.max(np.abs(np.asarray(want["DispersionDMX"]))) > 1e-7  # DMX ~1e-4 at 722 MHz
    assert np.max(np.abs(np.asarray(want["FD"]))) > 1e-6


def test_time_residuals_within_1ps(pair):
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu_torch.residuals import Residuals

    model, toas, _, tm, tt = pair
    with jax.disable_jit():
        rj = JaxResiduals(toas, model)
        want, pn = np.asarray(rj.time_resids), np.asarray(rj.pulse_numbers)
    got = Residuals(tt, tm)
    assert np.max(np.abs(got.time_resids.numpy() - want)) <= 1e-12
    np.testing.assert_array_equal(got.pulse_numbers.numpy(), pn)


def test_linear_and_fourier_columns_match_pint_tpu(pair):
    """K8's twins: the hybrid design's closed-form DMX, FD and JUMP columns
    (TZR row subtracted) and both power-law Fourier bases, with their prior
    variances."""
    from pint_tpu.fitting.design import linear_columns as jax_linear_columns
    from pint_tpu.fitting.design import linear_split as jax_linear_split
    from pint_tpu_torch.fitting.design import linear_columns, linear_split
    from pint_tpu_torch.residuals import resid_tangent

    model, toas, tens, tm, tt = nanograv_pair(1024, dm_noise=True)
    free = tuple(model.free_params)
    nonlin, lin, owners = jax_linear_split(model, free)
    assert len(nonlin) == 12 and len(lin) == 12
    params = model.xprec.convert_params(model.params)
    with jax.disable_jit():
        from pint_tpu.residuals import phase_residual_frac

        _, _, f = phase_residual_frac(model, params, tens, subtract_mean=False)
        want = np.asarray(jax_linear_columns(model, params, tens, f, slice(None, -1), lin, owners))
        basis = model.noise_basis_and_weights(model.params, tens)
    t_nonlin, t_lin, t_owners = linear_split(tm, free)
    assert (t_nonlin, t_lin) == (nonlin, lin)
    out = resid_tangent(tm, tm.params, tt)
    got = linear_columns(tm, tm.params, tt, out.f[0], slice(None, -1), lin, t_owners,
                         out.fb[0])
    for j, n in enumerate(lin):
        assert rel(got[j].numpy(), want[:, j]) <= 1e-10, n
    tb = tm.noise_basis_and_weights(tm.params, tt)
    assert tb.kd == basis.kd == 40 and tb.ke == basis.ke == 128
    assert rel(tb.dense.numpy(), basis.dense) <= 1e-10
    assert rel(tb.dense_phi.numpy(), basis.dense_phi) <= 1e-10


@pytest.mark.parametrize("dm_noise", [False, True])
def test_woodbury_chi2_and_logdet_match_pint_tpu(dm_noise):
    """s_factor, woodbury_chi2 and logdet_C on the model's own basis (ECORR
    epochs + red noise, + DM noise): chi^2 within 1e-10, log|C| within
    1e-8 relative."""
    from pint_tpu.fitting import woodbury as jw
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu_torch.fitting import woodbury as tw
    from pint_tpu_torch.residuals import Residuals

    model, toas, tens, tm, tt = nanograv_pair(1024, dm_noise=dm_noise)
    with jax.disable_jit():
        rj = JaxResiduals(toas, model)
        r = rj.time_resids
        w = 1.0 / jnp.asarray(model.scaled_sigma(model.params, tens)) ** 2
        jb = model.noise_basis_and_weights(model.params, tens)
        sf = jw.s_factor(jb, w)
        chi2_j, _ = jw.woodbury_chi2(jb, w, r, sf=sf)
        logdet_j = jw.logdet_C(jb, w, sf=sf)
    res = Residuals(tt, tm)
    tb = tm.noise_basis_and_weights(tm.params, tt)
    tw_w = 1.0 / res.errors_s ** 2
    tsf = tw.s_factor(tb, tw_w)
    chi2_t, _ = tw.woodbury_chi2(tb, tw_w, res.time_resids, sf=tsf)
    logdet_t = tw.logdet_C(tb, tw_w, sf=tsf)
    assert abs(float(chi2_t) - float(chi2_j)) <= 1e-10 * abs(float(chi2_j))
    assert abs(float(logdet_t) - float(logdet_j)) <= 1e-8 * abs(float(logdet_j))


# --- the GLS step, the fit and the grid ----------------------------------------------


def test_gls_step_matches_pint_tpu(pair, fits):
    """The first GLS step at the shifted start: all 24 design columns from
    the tangents (DMX, FD and JUMP lanes included), the normal matrix and
    right-hand side, the chi^2 and the noise amplitudes (128 epochs + 20
    Fourier coefficients)."""
    from pint_tpu_torch.fitting.gls import gls_step
    from pint_tpu_torch.residuals import Residuals

    _, _, _, tm, tt = pair
    start, want = fits[4]
    free = tuple(tm.free_params)
    res = Residuals(tt, tm)
    got = gls_step(tm, free, start, tt, res.weights, res.errors_s, True)
    assert np.max(np.abs(got[0].numpy() - want[0])) <= 1e-12
    assert got[1].shape == (1024, 24)
    for j, n in enumerate(free):
        assert rel(got[1][:, j].numpy(), want[1][:, j]) <= 1e-10, n
    for name, g, wv in zip(("mtcm", "mtcy", "norm", "chi2_0", "ahat"), got[2:], want[2:]):
        assert rel(g, wv) <= 1e-10, name
    assert got[6].shape == (148,)


def test_downhill_gls_fit_matches_pint_tpu(fits, moved):
    """Parameters and uncertainties within 1e-10 relative of pint_tpu's, or
    within ten times the distance of pint_tpu's fit through perturbed normal
    matrices (`moved`), where that is larger: the DMX, FD and JUMP values
    sit ~3e-10 sigma (~2e-10 relative) from pint_tpu's, and the witness
    moves them ~1e-9 sigma. The port's chi^2 at pint_tpu's parameters
    within 1e-10 of pint_tpu's. The noise amplitudes are held at equal
    inputs in `test_gls_step_matches_pint_tpu`: at the two fits' end points
    they differ as the DMX and FD values do, amplified (~2e-8 relative)."""
    from pint_tpu_torch.fitting.gls import gls_chi2_at
    from pint_tpu_torch.prepared import params_from_numpy

    jm, tm, want, got, _ = fits
    jm_moved, witness = moved
    rw, rg, rm = want.result, got.result, witness.result
    assert rg.converged and rw.converged and rg.iterations == rw.iterations >= 2
    assert 0.8 <= rg.reduced_chi2 <= 1.2
    # the fits' chi^2 differ as their parameters do; at pint_tpu's
    # parameters the port's chi^2 is pint_tpu's
    r = got.resids
    at_jax = gls_chi2_at(tm, params_from_numpy(params_numpy(jm.params), device="cpu"),
                         got.tensor, r.weights, r.errors_s, True)
    assert abs(float(at_jax) - rw.chi2) <= 1e-10 * rw.chi2
    assert rm.converged and rm.iterations == rw.iterations
    for n in got._free:
        a, b, m = leaf(jm.params[n]), leaf(tm.params[n]), leaf(jm_moved.params[n])
        assert abs(b - a) <= max(1e-10 * abs(a), 10 * abs(m - a)), n
        assert abs(b - a) <= 1e-6 * rw.uncertainties[n], n
        ua, ub, um = rw.uncertainties[n], rg.uncertainties[n], rm.uncertainties[n]
        assert abs(ub - ua) <= max(1e-10 * ua, 10 * abs(um - ua)), n
    well = [n for n in got._free if not n.startswith(("DMX_", "FD", "JUMP"))]
    for n in well:  # the well-conditioned parameters: the plain bound
        assert abs(leaf(tm.params[n]) - leaf(jm.params[n])) <= 1e-10 * abs(leaf(jm.params[n])), n
    assert got.noise_ampls.shape == want.noise_ampls.shape == (148,)


def test_m2_sini_grid_matches_pint_tpu(pair, fits):
    """The 3x3 (M2, SINI) GLS grid from the port's fitted model (`fits`),
    pint_tpu given the same parameters: one Gauss-Newton refit of the other
    22 free parameters (10 tangent lanes and 12 closed-form columns) per
    point."""
    from pint_tpu.fitting import DownhillGLSFitter as JaxFitter
    from pint_tpu.gridutils import grid_chisq as jax_grid
    from pint_tpu.ops.dd import DD as JaxDD
    from pint_tpu_torch.gridutils import grid_chisq
    from pint_tpu_torch.profiles import grid_for

    _, toas, _, _, _ = pair
    ftr = fits[3]
    tm = ftr.model
    jm, _ = shifted(pair)
    jm.params = {k: JaxDD(jnp.float64(v[0]), jnp.float64(v[1])) if isinstance(v, tuple)
                 else jnp.float64(v) for k, v in params_numpy(tm.params).items()}
    names, vals = grid_for(tm, ftr)
    assert names == ("M2", "SINI")
    got = grid_chisq(ftr, names, vals)
    with jax.disable_jit():
        want = np.asarray(jax_grid(JaxFitter(toas, jm), names, vals))
    assert got.shape == want.shape == (3, 3) and np.all(np.isfinite(got))
    sens = grid_sensitivity(ftr, names, vals, got)  # chip_smoke's: the twins on the CPU
    assert np.max(np.abs(got - want) / want) <= max(1e-10, 10 * sens)


def test_k1_lane_codes_for_the_nanograv_terms(pair):
    from pint_tpu_torch.residuals import L_DMX0, L_FD0, L_JUMP0, lane_code, lane_names

    _, _, _, tm, _ = pair
    assert [lane_code(n) for n in ("ELONG", "ELAT", "PMELONG", "PMELAT")] == [0, 1, 2, 3]
    assert [lane_code(n, tm) for n in ("FD1", "FD3", "JUMP1", "DMX_0001", "DMX_0008")] == [
        L_FD0 + 1, L_FD0 + 3, L_JUMP0, L_DMX0, L_DMX0 + 7]
    assert lane_names(tm.free_params, tm) == tuple(tm.free_params)
    with pytest.raises(NotImplementedError, match="K1"):
        lane_code("DMX_0001")  # a DMX lane needs the model's windows
    assert sum(1 for n in tm.free_params if n.startswith("DMX_")) == 8

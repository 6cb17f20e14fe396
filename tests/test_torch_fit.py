"""The port's WLS fitters and chi^2 grid against pint_tpu on the same TOAs
(SMOKE_PAR, 1,024 fake TOAs, the start moved by F0 +2e-10 Hz and DM +1e-3).

Bounds: fitted parameters and uncertainties within 1e-10 relative; grid
chi^2 per point within 1e-10 relative. pint_tpu's grid runs eagerly
(``jax.disable_jit``): XLA contracts multiply-adds inside the dd arithmetic
of pint_tpu's jitted CPU programs, which rounds the TZR-anchored phase
differently from the eager run by more than the grid's bound allows;
eagerly both packages do the same IEEE operations. The fitted parameters
hold 1e-10 against the jitted fitter all the same; its chi^2 is held to
1e-8.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_fixture import params_numpy, port_pair

START = {"F0": 2e-10, "DM": 1e-3}


@pytest.fixture(scope="module")
def pair():
    return port_pair(n=1024)


def fresh_models(pair):
    """(jax model, port model) parsed anew and moved to the shifted start."""
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu.profiles import SMOKE_PAR
    from pint_tpu_torch.fitting.wls import apply_delta
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import SMOKE_PAR as PORT_PAR

    jm = build_model(parse_parfile(SMOKE_PAR, from_text=True))
    tm = get_model(PORT_PAR, from_text=True, device="cpu")
    free = tuple(jm.free_params)
    delta = np.array([START.get(n, 0.0) for n in free])
    jm.params = jax_apply(jm.params, free, delta)
    tm.params = apply_delta(tm.params, free, torch.tensor(delta, dtype=torch.float64))
    return jm, tm


def leaf(v) -> float:
    return float(v.hi) + float(v.lo) if hasattr(v, "hi") else float(v)


def test_apply_delta_bitwise(pair):
    """K0's add_fp (the twin on the CPU) updates the dd leaves exactly as
    pint_tpu's dd_add_fp; a (B, p) delta updates a batched dict."""
    from pint_tpu_torch.fitting.wls import apply_delta
    from pint_tpu_torch.ops.dd import DD

    jm, tm = fresh_models(pair)
    assert params_numpy(jm.params) == params_numpy(tm.params)
    free = ("F0", "F1", "DM")
    steps = torch.tensor([[3e-11, -2e-19, 1e-4], [-7e-12, 5e-20, -2e-4]], dtype=torch.float64)
    batched = apply_delta(tm.params, free, steps)
    assert batched["F0"].hi.shape == (2,)
    for b in range(2):
        one = apply_delta(tm.params, free, steps[b])
        for n in free:
            v, w = batched[n], one[n]
            if isinstance(w, DD):
                assert (float(v.hi[b]), float(v.lo[b])) == (float(w.hi), float(w.lo))
            else:
                assert float(v[b]) == float(w)


def test_downhill_fit_matches_pint_tpu(pair):
    from pint_tpu.fitting import DownhillWLSFitter as JaxFitter
    from pint_tpu_torch.fitting import DownhillWLSFitter

    _, toas, tens, _, tt = pair
    jm, tm = fresh_models(pair)
    want = JaxFitter(toas, jm)
    want.fit_toas()
    got = DownhillWLSFitter(tt, tm)
    got.fit_toas()
    rw, rg = want.result, got.result
    assert rg.converged and rw.converged and rg.iterations == rw.iterations
    assert rg.iterations >= 2  # the start is far enough off for the LM loop to iterate
    assert abs(rg.chi2 - rw.chi2) <= 1e-8 * rw.chi2  # jitted pint_tpu rounds apart (docstring)
    assert 0.8 <= rg.reduced_chi2 <= 1.2
    for n in got._free:
        a, b = leaf(jm.params[n]), leaf(tm.params[n])
        assert abs(b - a) <= 1e-10 * abs(a), n
        ua, ub = rw.uncertainties[n], rg.uncertainties[n]
        assert abs(ub - ua) <= 1e-10 * ua, n
        assert tm.param_meta[n].uncertainty == ub


def test_plain_wls_fitter_matches_pint_tpu(pair):
    from pint_tpu.fitting import WLSFitter as JaxFitter
    from pint_tpu_torch.fitting import WLSFitter

    _, toas, _, _, tt = pair
    jm, tm = fresh_models(pair)
    rw = JaxFitter(toas, jm).fit_toas()
    rg = WLSFitter(tt, tm).fit_toas()
    assert rg.iterations == rw.iterations and rg.converged == rw.converged
    for n in rg.free_params:
        a, b = leaf(jm.params[n]), leaf(tm.params[n])
        assert abs(b - a) <= 1e-10 * abs(a), n
        assert abs(rg.uncertainties[n] - rw.uncertainties[n]) <= 1e-10 * rw.uncertainties[n]


def test_lm_step_matches_pint_tpu(pair):
    """The damped re-solve from the cached SVD pieces (s, Vt, U^T b, norm)."""
    from pint_tpu.fitting.wls import lm_step as jax_lm_step
    from pint_tpu_torch.fitting.wls import lm_step, wls_step
    from pint_tpu_torch.residuals import Residuals

    _, _, _, _, tt = pair
    _, tm = fresh_models(pair)
    res = Residuals(tt, tm)
    pieces = wls_step(tm, tuple(tm.free_params), tm.params, tt, res.weights, res.errors_s, True)
    s, vt, utb, norm = pieces[4], pieces[5], pieces[7], pieces[8]
    assert torch.allclose(lm_step(s, vt, utb, norm, 0.0), pieces[2], rtol=1e-12, atol=0)
    for lam in (1e-8, 1e-5, 1e-2):
        want = jax_lm_step(*(t.numpy() for t in (s, vt, utb, norm)), lam)
        got = lm_step(s, vt, utb, norm, lam).numpy()
        assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-12, lam


def test_refit_from_the_solution_reverts_its_sub_threshold_step(pair):
    """run_lm reverts a final step whose chi^2 gain is below the threshold:
    a refit from the converged solution returns it bit for bit."""
    from pint_tpu_torch.fitting import DownhillWLSFitter

    _, _, _, _, tt = pair
    _, tm = fresh_models(pair)
    DownhillWLSFitter(tt, tm).fit_toas()
    first = params_numpy(tm.params)
    again = DownhillWLSFitter(tt, tm).fit_toas()
    assert again.converged and again.iterations == 1
    assert params_numpy(tm.params) == first


def test_grid_chisq_matches_pint_tpu(pair):
    """The first eager pint_tpu grid call compiles every primitive it meets
    (~15 s on an 8-core CPU, whatever N), which is most of this test's time."""
    import jax.numpy as jnp

    from pint_tpu.fitting import DownhillWLSFitter as JaxFitter
    from pint_tpu.gridutils import grid_chisq as jax_grid
    from pint_tpu.ops.dd import DD as JaxDD
    from pint_tpu_torch.fitting import DownhillWLSFitter
    from pint_tpu_torch.gridutils import grid_chisq
    from pint_tpu_torch.profiles import spin_grid

    _, toas, _, _, tt = pair
    jm, tm = fresh_models(pair)
    ftr = DownhillWLSFitter(tt, tm)
    ftr.fit_toas()
    jm.params = {k: JaxDD(jnp.float64(v[0]), jnp.float64(v[1])) if isinstance(v, tuple)
                 else jnp.float64(v) for k, v in params_numpy(tm.params).items()}
    names, vals = spin_grid(tm, ftr)
    got = grid_chisq(ftr, names, vals)
    with jax.disable_jit():
        want = np.asarray(jax_grid(JaxFitter(toas, jm), names, vals))
    assert got.shape == want.shape == (3, 3)
    assert np.max(np.abs(got - want) / want) <= 1e-10
    assert int(np.argmin(got)) == 4


def test_normal_eq_twin_is_the_point_kernel_algebra():
    """K2's twin against the gn_step algebra written out in numpy."""
    from pint_tpu_torch.gridutils import normal_eq

    rng = np.random.default_rng(4)
    B, p, n = 3, 3, 257
    r = rng.normal(size=(B, n)) * 1e-6 + 2e-6
    M = rng.normal(size=(B, p, n)) * np.array([1e3, 1e-2, 5.0])[:, None] + 1.0
    w = rng.uniform(0.5, 2.0, n) * 1e12
    G, c, chi2, norm = normal_eq(*(torch.tensor(a) for a in (r, M, w)), 1e-6, True)
    for b in range(B):
        rm = r[b] - np.sum(w * r[b]) / np.sum(w)
        Mm = (M[b] - np.sum(w * M[b], axis=1, keepdims=True) / np.sum(w)).T
        nrm = np.sqrt(np.sum(w[:, None] * Mm * Mm, axis=0))
        Mn = Mm / nrm
        np.testing.assert_allclose(G[b].numpy(), Mn.T @ (w[:, None] * Mn) + 1e-6 * np.eye(p),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(c[b].numpy(), (w[:, None] * Mn).T @ (-rm), rtol=1e-10)
        np.testing.assert_allclose(chi2[b].numpy(), np.sum(w * rm * rm), rtol=1e-12)
        np.testing.assert_allclose(norm[b].numpy(), nrm, rtol=1e-12)

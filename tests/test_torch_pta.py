"""The port's joint PTA likelihood (``pint_tpu_torch/fitting/pta_like.py``)
against pint_tpu's, on the CPU.

Three arrays made by pint_tpu's simulation (``tests/test_pta.py``'s
``_array``: per-pulsar noise from each model, one Hellings-Downs correlated
background over the array), handed to both packages as the same TOAs (copied
into the port's container, ``tests/test_torch_simulation.port_toas``):

- ``template``: 4 pulsars of ``profiles.PTA_PAR_TEMPLATE`` (EFAC, red noise
  with 5 frequencies, the background with 6), 64 TOAs each;
- ``test``: 2 pulsars of ``tests/test_pta.py``'s test par (EFAC/EQUAD/ECORR,
  red noise, the background), 64 TOAs each;
- ``ragged``: 3 pulsars of its par without ECORR at 64, 66 and 68 TOAs, so
  that the rows bucket to 128 and pad rows show.

Both ``marginalize_timing`` modes. Bounds: positions and the ORF within
1e-15; the span, hyperparameter names, priors, scales and start equal;
``loglike`` and ``loglike_curn`` within 1e-8 relative; ``loglike_many``
within 1e-13 of the port's own pointwise ``loglike`` and 1e-8 of pint_tpu's;
``grad`` within 1e-8 of the largest entry of pint_tpu's ``jax.grad``;
``detection_statistic``'s likelihoods within 1e-8 relative, rho and the
optimal statistic within 1e-8; ``gwb_coefficient_blocks`` within 1e-10 of
the largest entry; the fused likelihood within 1e-8 of an independent
numpy/scipy dense joint reference and of the port's ``dense_joint_program``
(2 pulsars); K3's stacked twin at m = 0 within 1e-13 of the per-set twin;
K10's twin within 1e-10 of ``torch.autograd`` through the plain forward (the
coupling's own cotangent); ``optimize`` (2 restarts, 20 steps) within PR 9's
gates. A par with TNGWAMP fits alone (GLS) and runs ``NoiseLikelihood``
with the background's auto term in its basis, against pint_tpu.

pint_tpu's member designs (the dd phase chain) run eagerly
(``jax.disable_jit``; ROADMAP C1); its likelihood programs run jitted. The
port runs on one torch thread.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from tests.test_pta import PTA_RAGGED_PAR, PTA_TEST_PAR, _array
from tests.test_torch_simulation import port_toas, rel

CONFIGS = ("template", "test", "ragged")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


#: (par, pulsars, seed, ragged) of each configuration's array
ARRAYS = {"template": ("template", 4, 31, False), "test": (PTA_TEST_PAR, 2, 5, False),
          "ragged": (PTA_RAGGED_PAR, 3, 13, True)}


def config_array(config: str):
    """(pint_tpu TOAs, pint_tpu models, the models' par texts) of `config`'s
    array, 32 epochs (64 TOAs) a pulsar, 2 more TOAs a pulsar when ragged."""
    from pint_tpu.profiles import PTA_PAR_TEMPLATE, pta_sky

    par, n, seed, ragged = ARRAYS[config]
    par = PTA_PAR_TEMPLATE if par == "template" else par
    toas, models = _array(n, n_epochs=32, seed=seed, par=par, ragged=ragged)
    pars = [par.format(name=name, raj=raj, decj=decj, f0=346.531996493 + 0.37 * k)
            for k, (name, raj, decj) in enumerate(pta_sky(n))]
    return toas, models, pars


def port_model(par: str, jm):
    """The port's model of `par`, its parameters checked against pint_tpu's
    model of the same text."""
    from pint_tpu_torch.models import get_model
    from tests.test_torch_fixture import params_numpy

    tm = get_model(par, from_text=True, device="cpu")
    assert params_numpy(jm.params) == params_numpy(tm.params)
    return tm


_MEMBERS: dict = {}


def members(config: str):
    """(pint_tpu members, port members, par texts) of `config`, built once;
    pint_tpu's designs eagerly."""
    if config not in _MEMBERS:
        from pint_tpu.fitting.noise_like import NoiseLikelihood as JaxNL
        from pint_tpu_torch.fitting import NoiseLikelihood

        toas, models, pars = config_array(config)
        with jax.disable_jit():
            want = [JaxNL(t, copy.deepcopy(m)) for t, m in zip(toas, models)]
        got = [NoiseLikelihood(port_toas(t), port_model(par, m))
               for t, m, par in zip(toas, models, pars)]
        _MEMBERS[config] = (want, got, pars)
    return _MEMBERS[config]


_PTAS: dict = {}


def ptas(config: str, marg: bool = True):
    """(pint_tpu PTALikelihood, the port's) over `config`'s members."""
    key = (config, marg)
    if key not in _PTAS:
        from pint_tpu.fitting.pta_like import PTALikelihood as JaxPTA
        from pint_tpu_torch.fitting import PTALikelihood

        want, got, _ = members(config)
        _PTAS[key] = (JaxPTA(want, marginalize_timing=marg),
                      PTALikelihood(got, marginalize_timing=marg))
    return _PTAS[key]


def points(pta, k: int = 3, seed: int = 3):
    """x0 and k - 1 points moved by 0.03 prior scales (EQUAD and ECORR kept
    inside their priors)."""
    rng = np.random.default_rng(seed)
    out = [pta.x0]
    edge = np.array([n.split(":")[-1].startswith(("EQUAD", "ECORR")) for n in pta.hyper])
    for _ in range(k - 1):
        eta = pta.x0 + 0.03 * pta.scales * rng.standard_normal(pta.nparams)
        out.append(np.where(edge, np.abs(eta), eta))
    return np.array(out)


@pytest.mark.parametrize("config", CONFIGS)
def test_build_surface(config):
    want, got = ptas(config)
    assert rel(got.positions, want.positions) <= 1e-15
    assert rel(got.orf, np.asarray(want.orf)) <= 1e-15
    assert got.gw_tspan == want.gw_tspan
    assert got.hyper == want.hyper and got.psr_hyper == want.psr_hyper
    assert got.gw_hyper == want.gw_hyper and got.p_lin == want.p_lin
    assert {n: (p.lo, p.hi) for n, p in got.priors.items()} == \
        {n: (p.lo, p.hi) for n, p in want.priors.items()}
    assert np.array_equal(got.scales, want.scales) and np.array_equal(got.x0, want.x0)
    assert got.rows == want.rows
    if config == "ragged":
        assert got.rows == 128 and [nl._n_data for nl in got.members] == [64, 66, 68]


@pytest.mark.parametrize("marg", (True, False), ids=("marginalized", "profiled"))
@pytest.mark.parametrize("config", CONFIGS)
def test_loglike_and_curn(config, marg):
    want, got = ptas(config, marg)
    for eta in points(got):
        a, b = got.loglike(eta), want.loglike(eta)
        assert np.isfinite(a) and abs(a - b) <= 1e-8 * abs(b), (eta, a, b)
        a, b = got.loglike_curn(eta), want.loglike_curn(eta)
        assert np.isfinite(a) and abs(a - b) <= 1e-8 * abs(b), (eta, a, b)


@pytest.mark.parametrize("config", ("template", "ragged"))
def test_loglike_many(config):
    want, got = ptas(config)
    etas = points(got, 5, seed=11)
    for chunk in (None, 4):  # a bucket of 8, and one chunk of 4 padded with the last row
        batch = got.loglike_many(etas, chunk=chunk)
        one = np.array([got.loglike(e) for e in etas])
        assert batch.shape == (5,) and rel(batch, one) <= 1e-13
    assert rel(batch, want.loglike_many(etas, chunk=4)) <= 1e-8


@pytest.mark.parametrize("config", CONFIGS)
def test_grad(config):
    want, got = ptas(config)
    for eta in points(got, 2, seed=5):
        g, gj = got.grad(eta), want.grad(eta)
        assert np.all(np.isfinite(g))
        assert np.max(np.abs(g - gj)) <= 1e-8 * np.max(np.abs(gj)), (g, gj)


@pytest.mark.parametrize("config", CONFIGS)
def test_detection_statistic(config):
    want, got = ptas(config)
    eta = points(got, 2, seed=7)[1]
    d, dj = got.detection_statistic(eta), want.detection_statistic(eta)
    for k in ("ll_hd", "ll_curn"):
        assert abs(d[k] - dj[k]) <= 1e-8 * abs(dj[k]), (k, d[k], dj[k])
    assert np.max(np.abs(d["rho"] - dj["rho"])) <= 1e-8
    assert abs(d["os"] - dj["os"]) <= 1e-8
    assert rel(d["angle_deg"], dj["angle_deg"]) <= 1e-13 and rel(d["hd"], dj["hd"]) <= 1e-15
    pc = got.pair_correlations(eta)
    assert np.array_equal(pc["rho"], d["rho"]) and np.array_equal(pc["hd"], d["hd"])


@pytest.mark.parametrize("config", CONFIGS)
def test_gwb_coefficient_blocks(config):
    want, got = ptas(config)
    eta = points(got, 2, seed=9)[1]
    b, bj = got.gwb_coefficient_blocks(eta), want.gwb_coefficient_blocks(eta)
    for k in ("u", "V", "phi"):
        assert b[k].shape == bj[k].shape and rel(b[k], bj[k]) <= 1e-10, k
    assert np.array_equal(b["orf"], bj["orf"])


def dense_reference(pta, eta, marginalize: bool) -> float:
    """An independent dense joint likelihood in numpy/scipy over each
    member's own rows (no padding): the full HD-coupled covariance, its
    Cholesky factor, every timing column profiled jointly."""
    import scipy.linalg as sl

    from pint_tpu_torch.fitting.noise_like import RIDGE
    from pint_tpu_torch.fitting.woodbury import basis_dense

    n = len(pta.members)
    h = len(pta.psr_hyper)
    eta = np.asarray(eta)
    eta_psr, (lg_a, gam) = eta[: n * h].reshape(n, h), eta[n * h:]
    nf, T = pta.gw_comp.nf, pta.gw_tspan
    f = np.repeat(np.linspace(1.0 / T, nf / T, nf), 2)
    fyr = 1.0 / 3.16e7
    phi_gw = (10.0**lg_a) ** 2 / (12.0 * np.pi**2) * fyr ** (gam - 3.0) * f ** (-gam) * f[0]
    tspan = torch.tensor(T, dtype=torch.float64)
    Cs, Gs, rs, Ms, norms = [], [], [], [], []
    for a, nl in enumerate(pta.members):
        params = dict(nl._params0)
        for i, nm in enumerate(pta.psr_hyper):
            params[nm] = torch.tensor(eta_psr[a, i], dtype=torch.float64)
        sigma = nl.model.scaled_sigma(params, nl.tensor).numpy()
        C = np.diag(sigma**2)
        basis = nl.model.noise_basis_and_weights(params, nl.tensor, include_common=False)
        if basis is not None:
            F, ph = (x.numpy() for x in basis_dense(basis, sigma.size))
            C = C + (F * ph) @ F.T
        Cs.append(C)
        Gs.append(nl.model.gwb_common_basis(params, nl.tensor, tspan)[0].numpy())
        r0, M, mnorm = (x.numpy() for x in nl.design)
        rs.append(r0)
        Ms.append(M / mnorm)
        norms.append(mnorm)
    ns = [c.shape[0] for c in Cs]
    off = np.cumsum([0] + ns)
    C = np.zeros((off[-1], off[-1]))
    for a in range(n):
        C[off[a]:off[a + 1], off[a]:off[a + 1]] += Cs[a]
        for b in range(n):
            C[off[a]:off[a + 1], off[b]:off[b + 1]] += (Gs[a] * (pta.orf[a, b] * phi_gw)) @ Gs[b].T
    r = np.concatenate(rs)
    cf = sl.cho_factor(C)
    Cinv_r = sl.cho_solve(cf, r)
    chi2 = r @ Cinv_r
    ld = 2.0 * np.sum(np.log(np.diag(cf[0])))
    p = Ms[0].shape[1]
    M = np.zeros((off[-1], n * p))
    for a in range(n):
        M[off[a]:off[a + 1], a * p:(a + 1) * p] = Ms[a]
    A = M.T @ sl.cho_solve(cf, M) + RIDGE * np.eye(n * p)
    b = M.T @ Cinv_r
    cfA = sl.cho_factor(A)
    chi2 -= b @ sl.cho_solve(cfA, b)
    n_prof = 0.0
    if marginalize:
        ld += 2.0 * np.sum(np.log(np.diag(cfA[0]))) + 2.0 * sum(np.sum(np.log(x)) for x in norms)
        n_prof = float(n * p)
    return -0.5 * (chi2 + ld + (off[-1] - n_prof) * np.log(2 * np.pi))


@pytest.mark.parametrize("marg", (True, False), ids=("marginalized", "profiled"))
def test_fused_matches_the_dense_joint(marg):
    _, got = ptas("test", marg)
    prog = got.dense_joint_program()
    for eta in points(got, 2, seed=17):
        fused = got.loglike(eta)
        ref = dense_reference(got, eta, marg)
        assert abs(fused - ref) <= 1e-8 * abs(ref), (fused, ref)
        dense = prog(eta)
        assert abs(fused - dense) <= 1e-8 * abs(dense), (fused, dense)


@pytest.mark.parametrize("config", CONFIGS)
def test_stacked_prior_weights_match_each_member(config):
    """The array's prior variances, one call of ``noise_prior_weights`` on
    the members' stacked columns, equal each member's own without the common
    process, bitwise."""
    from pint_tpu_torch.fitting.noise_like import _apply_eta, _as_sets

    _, got = ptas(config)
    etas = torch.as_tensor(points(got))
    _, pe, pd, _ = got._sets(etas)
    h = len(got.psr_hyper)
    for a, nl in enumerate(got.members):
        eta_a = torch.as_tensor(np.tile(nl.x0, (len(etas), 1)))
        eta_a[:, [nl.hyper.index(n) for n in got.psr_hyper]] = etas[:, a * h:(a + 1) * h]
        params = _apply_eta(nl._params0, nl.hyper, eta_a.T[..., None])
        pe_a, pd_a = nl.model.noise_prior_weights(params, nl.tensor, include_common=False)
        assert torch.equal(pe[:, a], _as_sets(pe_a, len(etas), eta_a))
        assert torch.equal(pd[:, a], _as_sets(pd_a, len(etas), eta_a))


def test_k3_stacked_twin_at_m0_matches_the_per_set_twin():
    """With no common block and ridge 0 the stacked twin is the per-set twin
    (pint_tpu's single-pulsar algebra) on the pulsar's own rows."""
    from pint_tpu_torch.fitting.woodbury import (ecorr_normal_eq_sets_plain,
                                                 ecorr_normal_eq_stacked_plain, stacked_epochs)

    _, got = ptas("test")
    nl = got.members[0]
    core = nl._core
    w, pe, pd = nl._sets(torch.as_tensor(points(nl, 2)))
    want = ecorr_normal_eq_sets_plain(core.r0, core.M, w, core.Fd, core.epochs, pe, pd, 0.0)
    eidx = core.eidx[None]
    stk = ecorr_normal_eq_stacked_plain(
        core.r0[None], core.M[None], core.M.new_zeros((1, 0, core.M.shape[1])), w[:, None],
        core.Fd[None], stacked_epochs(eidx, core.epochs.ke), pe[:, None], pd[:, None])
    for name in want._fields:
        g, wv = getattr(stk, name), getattr(want, name)
        g = g[0] if name == "norm" else g[:, 0]
        assert g.shape == wv.shape and rel(g, wv) <= 1e-13, name


@pytest.mark.parametrize("marg", (True, False), ids=("marginalized", "profiled"))
@pytest.mark.parametrize("config", ("test", "ragged"))
def test_backward_twin_matches_autograd(config, marg):
    """K10's twin against torch.autograd through the plain forward (K3's
    stacked twin), under the coupling's own cotangent, at 3 points."""
    from pint_tpu_torch.fitting.pta_like import pta_blocks, pta_grad_plain

    _, got = ptas(config, marg)
    etas = torch.as_tensor(points(got))
    w, pe, pd, phi = got._sets(etas)
    ins = [x.detach().clone().requires_grad_(True) for x in (w, pe, pd)]
    gram, ld, st = pta_blocks(got._core, *ins)
    gram_, ld_ = gram.detach().requires_grad_(True), ld.detach().requires_grad_(True)
    gbar, ldbar = torch.autograd.grad(got._couple(gram_, ld_, phi.detach(), got._orf_ops).sum(),
                                      (gram_, ld_))
    leaves = [x for x in ins if x.shape[-1]]
    auto = torch.autograd.grad(((gram * gbar).sum() + (ld * ldbar).sum()), leaves)
    with torch.no_grad():
        dw, dphi = pta_grad_plain(got._core, pta_blocks(got._core, w, pe, pd)[2], gbar, ldbar)
    real = w > 0
    assert rel(dw[real], auto[0][real]) <= 1e-10
    assert torch.all(dw[~real] == 0)
    assert rel(dphi, torch.cat(auto[1:], dim=-1)) <= 1e-10


def test_optimize():
    want, got = ptas("template")
    eta, lp = got.optimize(n_restarts=2, n_steps=20)
    eta_j, lp_j = want.optimize(n_restarts=2, n_steps=20)
    assert abs(lp - lp_j) <= 1e-8 * abs(lp_j), (lp, lp_j)
    assert np.all(np.abs(eta - eta_j) <= 1e-6 * got.scales), (eta, eta_j)
    with torch.no_grad():
        start = float(got._lnpost(torch.as_tensor(got.x0)[None])[0])
    assert lp > start, (lp, start)


def test_refusals():
    from pint_tpu_torch.fitting import PTALikelihood

    _, got = ptas("test")
    with pytest.raises(NotImplementedError, match="A15"):
        PTALikelihood(got.members, mesh=object())
    with pytest.raises(NotImplementedError, match="B15"):
        got.laplace_scales()
    with pytest.raises(NotImplementedError, match="B15"):
        got.sample()
    with pytest.raises(NotImplementedError, match="A17"):
        got.static_peak_bytes_per_chip()


def test_build_errors_match_pint_tpu():
    from pint_tpu.fitting.noise_like import NoiseLikelihood as JaxNL
    from pint_tpu.fitting.pta_like import PTALikelihood as JaxPTA
    from pint_tpu_torch.fitting import NoiseLikelihood, PTALikelihood

    want, got, pars = members("test")
    with pytest.raises(ValueError) as e1:
        PTALikelihood([])
    with pytest.raises(ValueError) as e2:
        JaxPTA([])
    assert str(e1.value) == str(e2.value)
    # a member without the common process
    par = pars[0].replace("TNGWAMP -12.9\nTNGWGAM 4.33\nTNGWC 3\n", "")
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu_torch.models import get_model

    jm = build_model(parse_parfile(par, from_text=True))
    tm = get_model(par, from_text=True, device="cpu")
    with jax.disable_jit():
        jnl = JaxNL(want[0].toas, jm)
    tnl = NoiseLikelihood(got[0].toas, tm)
    with pytest.raises(ValueError) as e1:
        PTALikelihood([tnl, got[1]])
    with pytest.raises(ValueError) as e2:
        JaxPTA([jnl, want[1]])
    assert str(e1.value) == str(e2.value)
    with pytest.raises(ValueError, match="mode-count mismatch") as e1:
        PTALikelihood([got[1], tnl])
    with pytest.raises(ValueError) as e2:
        JaxPTA([want[1], jnl])
    assert str(e1.value) == str(e2.value)
    with pytest.raises(ValueError, match="prepared TOAs"):
        PTALikelihood([NoiseLikelihood(got[0].tensor, got[0].model), got[1]])


@pytest.fixture(scope="module")
def solo():
    """Pulsar 0 of the test array, with the background's auto term in its own
    basis: both packages' downhill GLS fits from the par, then their
    NoiseLikelihoods at the fitted parameters."""
    from pint_tpu.fitting import DownhillGLSFitter as JaxGLS
    from pint_tpu.fitting.noise_like import NoiseLikelihood as JaxNL
    from pint_tpu_torch.fitting import DownhillGLSFitter, NoiseLikelihood

    want, got, pars = members("test")
    jm, tm = copy.deepcopy(want[0].model), port_model(pars[0], want[0].model)
    jtoas, ttoas = want[0].toas, got[0].toas
    with jax.disable_jit():
        jf = JaxGLS(jtoas, jm)
        jf.fit_toas()
        jnl = JaxNL(jtoas, jm)
    tf = DownhillGLSFitter(ttoas, tm)
    tf.fit_toas()
    return jf, tf, jnl, NoiseLikelihood(ttoas, tm)


def test_single_pulsar_gls_fit_with_tngwamp(solo):
    from tests.test_torch_fixture import params_numpy

    from pint_tpu_torch.residuals import _structure

    jf, tf, _, _ = solo
    assert tf.model.common_noise_component.nf == 3
    _structure(tf.model)  # kernel K1 evaluates the model (the background has no delay)
    jp, tp = params_numpy(jf.model.params), params_numpy(tf.model.params)
    for n in tf.model.free_params:
        a = tp[n] if not isinstance(tp[n], tuple) else sum(tp[n])
        b = jp[n] if not isinstance(jp[n], tuple) else sum(jp[n])
        sig = jf.result.uncertainties[n]
        assert abs(a - b) <= 1e-6 * sig, (n, a, b, sig)
        assert abs(tf.result.uncertainties[n] - sig) <= 1e-8 * sig, n


def test_single_pulsar_noise_likelihood_with_the_auto_term(solo):
    _, _, jnl, tnl = solo
    assert tnl.hyper == jnl.hyper and "TNGWAMP" in tnl.hyper
    assert tnl._core.Fd.shape[0] == 8 + 6  # red noise's columns, then the background's
    for eta in points(tnl, 2, seed=21):
        a, b = tnl.loglike(eta), jnl.loglike(eta)
        assert abs(a - b) <= 1e-8 * abs(b), (a, b)
        g, gj = tnl.grad(eta), jnl.grad(eta)
        assert np.max(np.abs(g - gj)) <= 1e-8 * np.max(np.abs(gj))

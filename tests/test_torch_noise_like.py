"""The port's marginalized noise likelihood against pint_tpu's (eager) on the
NANOGrav-shaped par at a narrow width: ``profiles.nanograv_smoke_par(n_dmx=8,
nf=10)`` over 1,024 TOAs in 128 ECORR epochs, GLS-fitted by the port, the
fitted parameters handed to both packages (p_lin = 25: 24 free timing
parameters and the profiled offset; kd = 20 Fourier columns, 40 with DM
noise; h = 8 hyperparameters, 10 with DM noise).

Four noise configurations: white only (the par without its ECORR and TNRED
lines), ECORR, ECORR + red, ECORR + red + DM noise; both
``marginalize_timing`` modes. Bounds: hyperparameter names, priors, scales
and start equal; the design (r0, M, Mnorm) within 1e-10 relative per
column; ``loglike`` within 1e-8 relative; ``loglike_many`` within 1e-13 of
the port's own pointwise ``loglike`` (padded bucket included) and 1e-8 of
pint_tpu's; ``grad`` within 1e-8 of the largest entry of pint_tpu's
``jax.grad`` and within 1e-5 relative of central finite differences
(Richardson-extrapolated, steps of 3e-3 prior scales and at most half the
value: an ECORR's prior variance vanishes at 0; lnL's own rounding, ~1e-9,
swamps steps much smaller than that); the
backward twin (K9's formulas) within 1e-10 of ``torch.autograd`` through the
plain forward (K3's twin); ``optimize`` (4 restarts, 50 steps) from moved
noise values: the best ln posterior within 1e-8 relative, eta_hat within
1e-6 of each prior scale, above the start's ln posterior.

pint_tpu's design is the dd phase chain, so it runs eagerly
(``jax.disable_jit``; ROADMAP C1), once: the timing model is the same in
every noise configuration, so its (r0, M) is handed to the other
configurations' builds. Its likelihood programs run jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fixture import nanograv_pair, params_numpy

CONFIGS = ("white", "ecorr", "ecorr_red", "ecorr_red_dm")
#: the optimizer's start: noise values away from the simulation's truth (an
#: EQUAD or ECORR at the truth's 0.01 us sits at its prior's edge, where
#: Adam's first steps leave the prior and the start is already the best point)
NOISE_START = {"EFAC1": 1.3, "EFAC2": 0.8, "EQUAD1": 1.23e-6, "EQUAD2": 0.87e-6,
               "ECORR1": 1.11e-6, "ECORR2": 0.93e-6, "TNREDAMP": -13.1, "TNREDGAM": 4.1}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.max(np.abs(want)) if want.size else 0.0
    diff = np.max(np.abs(got - want)) if want.size else 0.0
    return diff / scale if scale else diff


def par_of(config: str) -> str:
    from pint_tpu_torch.profiles import nanograv_smoke_par

    par = nanograv_smoke_par(8, 10, dm_noise=config == "ecorr_red_dm")
    drop = {"white": ("ECORR", "TNRED"), "ecorr": ("TNRED",)}.get(config, ())
    return "".join(line + "\n" for line in par.splitlines() if not line.startswith(drop))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path here is many small ops: one intra-op thread is
    faster, and leaves the other test workers their cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def fitted():
    """(pint_tpu TOAs, the port's GLS-fitted timing parameters), with the
    ECORR + red likelihoods built (pint_tpu's eager design among them)."""
    from pint_tpu_torch.fitting import DownhillGLSFitter

    _, toas, _, tm, tt = nanograv_pair(1024)
    DownhillGLSFitter(tt, tm).fit_toas()
    out = toas, dict(tm.params)
    likes(out, "ecorr_red")
    return out


def to_jax(value, like):
    """A port parameter leaf as pint_tpu's leaf of the same kind."""
    if hasattr(like, "hi"):
        return type(like)(np.float64(value.hi), np.float64(value.lo))
    return float(value)


_MODELS: dict = {}


def models(fitted, config: str, start=None):
    """(pint_tpu model, its tensor, port model, port tensor) of `config` at
    the fitted timing parameters (noise values moved by `start`)."""
    key = (config, tuple(sorted((start or {}).items())))
    if key not in _MODELS:
        from pint_tpu.io.par import parse_parfile
        from pint_tpu.models.builder import build_model
        from pint_tpu_torch.models import get_model
        from pint_tpu_torch.prepared import tensor_from_numpy

        toas, params = fitted
        jm = build_model(parse_parfile(par_of(config), from_text=True))
        tm = get_model(par_of(config), from_text=True, device="cpu")
        for n, v in params.items():
            if n in tm.params and n not in (start or {}):
                jm.params[n] = to_jax(v, jm.params[n])
                tm.params[n] = v
        for n, v in (start or {}).items():
            if n in tm.params:
                jm.params[n] = float(v)
                tm.params[n] = torch.tensor(v, dtype=torch.float64)
        assert params_numpy(jm.params) == params_numpy(tm.params)
        jt = jm.build_tensor(toas)
        tt = tensor_from_numpy({k: np.asarray(v) for k, v in jt.items()}, device="cpu")
        _MODELS[key] = (jm, jt, tm, tt)
    return _MODELS[key]


_LIKES: dict = {}
_DESIGN: dict = {}


def likes(fitted, config: str, marg: bool = True, start=None):
    """(pint_tpu NoiseLikelihood, port NoiseLikelihood), built once each.
    pint_tpu's ECORR + red build runs its design eagerly; the others take
    that (r0, M): the timing model and its parameters are the same."""
    from pint_tpu.fitting import noise_like as jnl
    from pint_tpu_torch.fitting import NoiseLikelihood

    key = (config, marg, tuple(sorted((start or {}).items())))
    base = ("ecorr_red", True, ())
    if key != base and base not in _LIKES:
        likes(fitted, "ecorr_red")
    if key not in _LIKES:
        toas = fitted[0]
        jm, _, tm, tt = models(fitted, config, start)
        saved = jnl._design_program
        if key == base:
            def recording(model, free):
                prog = saved(model, free)

                def run(*args):
                    _DESIGN["rM"] = prog(*args)
                    return _DESIGN["rM"]
                return run
            jnl._design_program = recording
        else:
            jnl._design_program = lambda model, free: (lambda *args: _DESIGN["rM"])
        try:
            with jax.disable_jit(key == base):
                want = jnl.NoiseLikelihood(toas, jm, marginalize_timing=marg)
        finally:
            jnl._design_program = saved
        _LIKES[key] = (want, NoiseLikelihood(tt, tm, marginalize_timing=marg))
    return _LIKES[key]


def points(nl, k: int = 3, seed: int = 3):
    """x0 and k - 1 points moved by 0.3 prior scales (EQUAD and ECORR kept
    inside their priors)."""
    rng = np.random.default_rng(seed)
    out = [nl.x0]
    for _ in range(k - 1):
        eta = nl.x0 + 0.03 * nl.scales * rng.standard_normal(nl.nparams)
        out.append(np.where(np.array([n.startswith(("EQUAD", "ECORR")) for n in nl.hyper]),
                            np.abs(eta), eta))
    return np.array(out)


@pytest.mark.parametrize("config", CONFIGS)
def test_names_priors_scales(fitted, config):
    from pint_tpu.fitting.noise_like import noise_param_names as jax_names
    from pint_tpu_torch.fitting import noise_param_names

    want, got = likes(fitted, config)
    jm, _, tm, _ = models(fitted, config)
    assert noise_param_names(tm) == jax_names(jm) == got.hyper == want.hyper
    assert {n: (p.lo, p.hi) for n, p in got.priors.items()} == \
        {n: (p.lo, p.hi) for n, p in want.priors.items()}
    assert np.array_equal(got.scales, want.scales) and np.array_equal(got.x0, want.x0)
    assert got.timing_free == want._timing_free() and got.p_lin == want.p_lin == 25


def test_design(fitted):
    want, got = likes(fitted, "ecorr_red")
    r0, M, mnorm = (t.numpy() for t in got.design)
    assert rel(r0, want._vecs["r0"]) <= 1e-10
    Mw = want._vecs["Mn"] * want._mnorm
    worst = max(rel(M[:, j], Mw[:, j]) for j in range(M.shape[1]))
    assert worst <= 1e-10, worst
    assert rel(mnorm, want._mnorm) <= 1e-10


@pytest.mark.parametrize("marg", (True, False), ids=("marginalized", "profiled"))
@pytest.mark.parametrize("config", CONFIGS)
def test_loglike(fitted, config, marg):
    want, got = likes(fitted, config, marg)
    for eta in points(got):
        a, b = got.loglike(eta), want.loglike(eta)
        assert np.isfinite(a) and abs(a - b) <= 1e-8 * abs(b), (eta, a, b)


@pytest.mark.parametrize("config", ("ecorr_red", "ecorr_red_dm"))
def test_loglike_many(fitted, config):
    want, got = likes(fitted, config)
    etas = points(got, 5, seed=11)
    for chunk in (None, 4):  # a bucket of 8, and one chunk of 4 padded with the last row
        batch = got.loglike_many(etas, chunk=chunk)
        one = np.array([got.loglike(e) for e in etas])
        assert batch.shape == (5,) and rel(batch, one) <= 1e-13
    assert rel(batch, want.loglike_many(etas, chunk=4)) <= 1e-8


@pytest.mark.parametrize("config", ("ecorr_red", "ecorr_red_dm", "white"))
def test_grad(fitted, config):
    want, got = likes(fitted, config)
    for eta in points(got, 2, seed=5):
        g, gj = got.grad(eta), want.grad(eta)
        assert np.all(np.isfinite(g))
        assert np.max(np.abs(g - gj)) <= 1e-8 * np.max(np.abs(gj)), (g, gj)
    eta = got.x0
    g = got.grad(eta)

    def central(i, h):
        ep, em = eta.copy(), eta.copy()
        ep[i] += h
        em[i] -= h
        return (got.loglike(ep) - got.loglike(em)) / (2 * h)

    for i in range(got.nparams):
        h = min(3e-3 * got.scales[i], 0.5 * abs(eta[i]))
        fd = (4 * central(i, h / 2) - central(i, h)) / 3
        assert abs(g[i] - fd) <= 1e-5 * abs(fd), (got.hyper[i], g[i], fd)


@pytest.mark.parametrize("marg", (True, False), ids=("marginalized", "profiled"))
@pytest.mark.parametrize("config", ("ecorr_red_dm", "white"))
def test_backward_twin_matches_autograd(fitted, config, marg):
    """K9's twin (its closed-form formulas) against torch.autograd through
    the plain forward (K3's twin and the Cholesky of A), at 3 points at once."""
    from pint_tpu_torch.fitting.noise_like import noise_forward, noise_grad_plain

    _, got = likes(fitted, config, marg)
    ins = [x.detach().clone().requires_grad_(True)
           for x in got._sets(torch.as_tensor(points(got)))]
    ll, st = noise_forward(got._core, *ins)
    leaves = [x for x in ins if x.shape[1]]
    auto = torch.autograd.grad(ll.sum(), leaves)
    with torch.no_grad():
        dw, dphi = noise_grad_plain(got._core, noise_forward(got._core, *ins)[1])
    assert rel(dw, auto[0]) <= 1e-10
    if len(leaves) > 1:
        assert rel(dphi, torch.cat(auto[1:], dim=1)) <= 1e-10


@pytest.fixture(scope="module")
def optimized(fitted):
    """Both packages' optimize (4 restarts, 50 steps) from NOISE_START, and
    the port's likelihood."""
    want, got = likes(fitted, "ecorr_red", start=NOISE_START)
    return got.optimize(n_restarts=4, n_steps=50), want.optimize(n_restarts=4, n_steps=50), got


def test_optimize(optimized):
    (eta, lp), (eta_j, lp_j), got = optimized
    assert abs(lp - lp_j) <= 1e-8 * abs(lp_j), (lp, lp_j)
    assert np.all(np.abs(eta - eta_j) <= 1e-6 * got.scales), (eta, eta_j)
    x0 = torch.as_tensor(got.x0)[None]
    with torch.no_grad():
        start = float(got._lnpost(x0)[0])
    assert lp > start, (lp, start)


def test_out_of_prior_point(fitted):
    """Outside its prior the ln posterior is -inf and its gradient exactly
    zero (the likelihood masked by `where`, as pint_tpu's isfinite mask)."""
    _, got = likes(fitted, "ecorr_red")
    eta = got.x0.copy()
    eta[got.hyper.index("EQUAD1")] = -1e-6
    eta[got.hyper.index("ECORR2")] = 0.0  # phi = 0 inside the prior's edge: lnL not finite
    x = torch.as_tensor(np.stack([eta, got.x0])).requires_grad_(True)
    lp = got._lnpost(x)
    (g,) = torch.autograd.grad(lp.sum(), x)
    lp = lp.detach()
    assert float(lp[0]) == -np.inf and np.isfinite(float(lp[1]))
    assert torch.equal(g[0], torch.zeros_like(g[0])) and torch.all(torch.isfinite(g[1]))


def test_refusals(fitted):
    from pint_tpu.fitting import NoiseLikelihood as JaxNoiseLikelihood
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu_torch.fitting import NoiseLikelihood
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import SMOKE_PAR

    _, got = likes(fitted, "ecorr_red")
    with pytest.raises(NotImplementedError, match="A15"):
        NoiseLikelihood(got.tensor, got.model, mesh=object())
    with pytest.raises(NotImplementedError, match="B15"):
        got.sample()
    with pytest.raises(NotImplementedError, match="B15"):
        got.laplace_scales()
    with pytest.raises(KeyError, match="NOPE"):
        NoiseLikelihood(got.tensor, got.model, hyper=("NOPE",))
    plain = get_model(SMOKE_PAR, from_text=True, device="cpu")
    with pytest.raises(ValueError, match="no noise components") as port_err:
        NoiseLikelihood(got.tensor, plain)
    with pytest.raises(ValueError) as jax_err:
        JaxNoiseLikelihood(fitted[0], build_model(parse_parfile(SMOKE_PAR, from_text=True)))
    assert str(port_err.value) == str(jax_err.value)


def test_priors():
    from pint_tpu import priors as jp
    from pint_tpu_torch import priors as tp

    x = np.array([-1.0, 0.0, 0.5, 1e-5, 10.0, 11.0, np.inf])
    for args in ((0.0, 10.0), (-np.inf, np.inf), (0.01, 10.0)):
        got = tp.UniformPrior(*args).logpdf(torch.as_tensor(x)).numpy()
        assert np.array_equal(got, np.asarray(jp.UniformPrior(*args).logpdf(jnp.asarray(x))))
    got = tp.NormalPrior(0.3, 2.0).logpdf(torch.as_tensor(x[:-1])).numpy()
    assert rel(got, np.asarray(jp.NormalPrior(0.3, 2.0).logpdf(jnp.asarray(x[:-1])))) <= 1e-15
    assert tp.default_prior(1.0, 0.1) == tp.UniformPrior(1.0 - 10.0, 1.0 + 10.0)
    assert tp.default_prior(1.0, None) == tp.UniformPrior()

"""The port's GLS path against pint_tpu: the Woodbury algebra
(``fitting/woodbury.py``, the twin of kernel K3), the GLS step, the
DownhillGLSFitter and GLSFitter, and the (M2, SINI) grid with the GLS
statistic, on the flagship profile (profiles.FLAGSHIP_SMOKE_PAR).

Bounds: every woodbury function within 1e-12 relative of pint_tpu's on a
hand-made basis (ECORR epochs, dense columns, both, and both with a row
scale); design columns and the GLS step's pieces within 1e-10 relative;
fitted parameters and uncertainties within 1e-10 relative (N = 1,024); grid
chi^2 within 1e-10 relative (N = 256).

pint_tpu runs EAGERLY here (``jax.disable_jit``). XLA contracts
multiply-adds inside the double-double arithmetic of pint_tpu's jitted CPU
programs (ROADMAP C1), which moves its jitted time residuals ~6e-14 s from
its own eager run; at the flagship's 1 us errors that moves parameters
that sit within a few sigma of zero (PX, DM1) by more than 1e-10 of their
value, jitted against eager pint_tpu alike. Eagerly both packages do the
same IEEE operations (the port's CPU twin takes sin, cos and log from the C
library, as XLA's CPU backend does), and agree far inside the bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fixture import flagship_pair, params_numpy

START = {"F0": 2e-10, "DM": 1e-3, "EPS1": 1e-7}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.max(np.abs(want)) if want.size else 0.0
    diff = np.max(np.abs(got - want)) if want.size else 0.0
    return diff / scale if scale else diff


def leaf(v) -> float:
    return float(v.hi) + float(v.lo) if hasattr(v, "hi") else float(v)


def shifted(pair):
    """(jax model, port model) of `pair` parsed anew, moved by START."""
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu.profiles import FLAGSHIP_SMOKE_PAR
    from pint_tpu_torch.fitting.wls import apply_delta
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.profiles import FLAGSHIP_SMOKE_PAR as PORT_PAR

    jm = build_model(parse_parfile(FLAGSHIP_SMOKE_PAR, from_text=True))
    tm = get_model(PORT_PAR, from_text=True, device="cpu")
    free = tuple(jm.free_params)
    delta = np.array([START.get(n, 0.0) for n in free])
    jm.params = jax_apply(jm.params, free, delta)
    tm.params = apply_delta(tm.params, free, torch.tensor(delta))
    assert params_numpy(jm.params) == params_numpy(tm.params)
    return jm, tm


@pytest.fixture(scope="module")
def small():
    return flagship_pair(n=256)


@pytest.fixture(scope="module")
def big():
    return flagship_pair(n=1024)


@pytest.fixture(scope="module")
def fits(big):
    """The DownhillGLSFitter of both packages at N = 1,024 from the shifted
    start, pint_tpu's eager (which also compiles the eager primitives the
    other N = 1,024 tests meet)."""
    from pint_tpu.fitting import DownhillGLSFitter as JaxFitter
    from pint_tpu_torch.fitting import DownhillGLSFitter

    pair = big
    _, toas, _, _, tt = pair
    jm, tm = shifted(pair)
    want = JaxFitter(toas, jm)
    steps = []  # pint_tpu's first GLS step: its inputs and outputs
    step_fn = want._step_fn

    def first_step(params, tensor):
        out = step_fn(params, tensor)
        if not steps:
            steps.append((params, [np.asarray(a) for a in out]))
        return out

    want._step_fn = first_step
    start = dict(tm.params)
    with jax.disable_jit():
        want.fit_toas()
    got = DownhillGLSFitter(tt, tm)
    got.fit_toas()
    return jm, tm, want, got, (start, steps[0][1])


# --- the Woodbury algebra --------------------------------------------------------


BASES = ("ecorr", "dense", "both", "both_scaled")


def hand_basis(kind: str, seed: int = 9, n: int = 200, ke: int = 24, kd: int = 6):
    """(jax NoiseBasis, port NoiseBasis, w, X (n, 3), r) from a seed: epochs
    of 1-12 rows with lone rows at -1, ECORR-like 1e-16 s^2 variances,
    dense columns with 1e-14 s^2, 1 us white errors."""
    from pint_tpu.fitting.woodbury import NoiseBasis as JaxBasis
    from pint_tpu_torch.fitting.woodbury import NoiseBasis, epoch_index

    rng = np.random.default_rng(seed)
    eidx = np.where(rng.uniform(size=n) < 0.15, -1, rng.integers(0, ke, n))
    eidx[:ke] = np.arange(ke)  # every epoch has a row
    ephi = rng.uniform(0.5, 2.0, ke) * 1e-16
    F = rng.normal(size=(n, kd))
    dphi = rng.uniform(0.5, 2.0, kd) * 1e-14
    scale = rng.uniform(0.5, 2.0, n)
    w = rng.uniform(0.5, 2.0, n) * 1e12
    X = rng.normal(size=(n, 3)) * np.array([1.0, 1e-3, 30.0])
    r = rng.normal(size=n) * 1e-6
    epoch = kind in ("ecorr", "both", "both_scaled")
    dense = kind in ("dense", "both", "both_scaled")
    row = scale if kind == "both_scaled" else None
    jb = JaxBasis(dense=jnp.asarray(F) if dense else None,
                  dense_phi=jnp.asarray(dphi) if dense else None,
                  eidx=jnp.asarray(eidx, jnp.int32) if epoch else None,
                  ephi=jnp.asarray(ephi) if epoch else None,
                  row_scale=None if row is None else jnp.asarray(row))
    t = torch.tensor
    pb = NoiseBasis(dense=t(F) if dense else None, dense_phi=t(dphi) if dense else None,
                    epochs=epoch_index(t(eidx), ke) if epoch else None,
                    ephi=t(ephi) if epoch else None, row_scale=None if row is None else t(row))
    return jb, pb, w, X, r


def test_epoch_index_is_the_csr_of_eidx():
    from pint_tpu_torch.fitting.woodbury import epoch_index

    eidx = torch.tensor([2, -1, 0, 2, 2, -1, 0, 1])
    ep = epoch_index(eidx, 4)
    assert ep.offsets.tolist() == [0, 2, 3, 6, 6] and ep.rows.tolist() == [2, 6, 7, 0, 3, 4]
    assert ep.padded.tolist() == [[2, 6, 8], [7, 8, 8], [0, 3, 4], [8, 8, 8]]
    with pytest.raises(ValueError, match="out of range"):
        epoch_index(torch.tensor([0, 4]), 4)


@pytest.mark.parametrize("kind", BASES)
def test_woodbury_functions_match_pint_tpu(kind):
    import pint_tpu.fitting.woodbury as J
    import pint_tpu_torch.fitting.woodbury as P

    jb, pb, w, X, r = hand_basis(kind)
    jw, jX, jr = jnp.asarray(w), jnp.asarray(X), jnp.asarray(r)
    tw, tX, tr = torch.tensor(w), torch.tensor(X), torch.tensor(r)
    jsf, psf = J.s_factor(jb, jw), P.s_factor(pb, tw)
    if kind != "dense":
        assert rel(P.seg_sum(tX, pb.epochs), J.seg_sum(jX, jb.eidx, jb.ke)) <= 1e-12
        assert rel(P.seg_sum(tr, pb.epochs), J.seg_sum(jr, jb.eidx, jb.ke)) <= 1e-12
        a = np.arange(jb.ke, dtype=np.float64) + 1.0
        np.testing.assert_array_equal(P.seg_gather(torch.tensor(a), pb.epochs).numpy(),
                                      np.asarray(J.seg_gather(jnp.asarray(a), jb.eidx)))
        assert rel(psf.De, jsf.De) <= 1e-12
    if kind != "ecorr":
        assert rel(torch.diagonal(psf.schur_cf), jnp.diag(jsf.schur_cf[0])) <= 1e-12
    if psf.B is not None:
        assert rel(psf.B, jsf.B) <= 1e-12
    assert rel(P.s_logdet(psf), J.s_logdet(jsf)) <= 1e-12
    for Y, jY in ((tX, jX), (tr, jr)):
        pye, pyd = P.basis_rmatvec(pb, tw, Y)
        jye, jyd = J.basis_rmatvec(jb, jw, jY)
        for got, want in ((pye, jye), (pyd, jyd)):
            assert (got is None) == (want is None) and (got is None or rel(got, want) <= 1e-12)
        pze, pzd = P.s_solve(psf, pye, pyd)
        jze, jzd = J.s_solve(jsf, jye, jyd)
        for got, want in ((pze, jze), (pzd, jzd)):
            assert (got is None) == (want is None) and (got is None or rel(got, want) <= 1e-12)
        assert rel(P.basis_matvec(pb, pze, pzd), J.basis_matvec(jb, jze, jzd)) <= 1e-12
        assert rel(P.cinv_apply(pb, tw, Y, psf), J.cinv_apply(jb, jw, jY, jsf)) <= 1e-12
    pin, pCY = P.cinv_inner(pb, tw, tX, tr)
    jin, jCY = J.cinv_inner(jb, jw, jX, jr)
    assert rel(pin, jin) <= 1e-12 and rel(pCY, jCY) <= 1e-12
    pc, (pze, pzd) = P.woodbury_chi2(pb, tw, tr)
    jc, (jze, jzd) = J.woodbury_chi2(jb, jw, jr)
    assert rel(pc, jc) <= 1e-12
    assert rel(P.cat_ahat(pze, pzd), J.cat_ahat(jze, jzd)) <= 1e-12
    assert rel(P.logdet_C(pb, tw), J.logdet_C(jb, jw)) <= 1e-12
    mask = (np.arange(w.size) % 7 != 0).astype(np.float64)
    assert rel(P.logdet_C(pb, tw, mask=torch.tensor(mask)),
               J.logdet_C(jb, jw, mask=jnp.asarray(mask))) <= 1e-12
    pF, pphi = P.basis_dense(pb, w.size)
    jF, jphi = J.basis_dense(jb, w.size)
    np.testing.assert_array_equal(pF.numpy(), np.asarray(jF))
    np.testing.assert_array_equal(pphi.numpy(), np.asarray(jphi))


@pytest.mark.parametrize("step", ("gls", "grid"))
@pytest.mark.parametrize("kind", ("ecorr", "both"))
def test_k3_twin_is_the_dense_gls_algebra(kind, step):
    """K3's twin (batched) against the normal equations with C built dense,
    from the raw design M: the grid's step first removes the weighted means
    from r and M and equilibrates by sqrt(sum w M^2), the GLS step by
    sqrt(sum M^2); then with Mn = M / norm, G = Mn^T C^-1 Mn + ridge,
    c = -Mn^T C^-1 r, chi2 = r^T C^-1 r, ahat = phi F^T C^-1 r."""
    from pint_tpu_torch.fitting.woodbury import basis_dense, ecorr_normal_eq

    _, pb, w, X, r = hand_basis(kind)
    F, phi = (a.numpy() for a in basis_dense(pb, w.size))
    Cinv = np.linalg.inv(np.diag(1.0 / w) + (F * phi) @ F.T)
    rs = np.stack([r, 2.0 * r + 1e-6])
    Ms = np.stack([X.T, 0.5 * X.T + 3.0])
    grid = step == "grid"
    G, c, chi2, ahat, norm = ecorr_normal_eq(torch.tensor(rs), torch.tensor(Ms),
                                             torch.tensor(w), pb, 1e-6, grid, grid)
    for b in range(2):
        rb, Mb = rs[b], Ms[b]
        if grid:
            rb = rb - np.sum(w * rb) / np.sum(w)
            Mb = Mb - np.sum(w * Mb, axis=1, keepdims=True) / np.sum(w)
        nb = np.sqrt(np.sum((w if grid else 1.0) * Mb * Mb, axis=1))
        assert rel(norm[b], nb) <= 1e-12
        Mn = Mb / nb[:, None]
        assert rel(G[b], Mn @ Cinv @ Mn.T + 1e-6 * np.eye(3)) <= 1e-10
        assert rel(c[b], -Mn @ Cinv @ rb) <= 1e-10
        assert rel(chi2[b], rb @ Cinv @ rb) <= 1e-10
        assert rel(ahat[b], phi * (F.T @ (Cinv @ rb))) <= 1e-10


# --- the GLS step, the fitters and the grid ---------------------------------------


def test_gls_step_matches_pint_tpu(big, fits):
    """The first step of the fits (at the shifted start): all 14 design
    columns from the tangents (DM and DM1 included), the unweighted
    equilibration and every Woodbury piece."""
    from pint_tpu_torch.fitting.gls import gls_step
    from pint_tpu_torch.residuals import Residuals

    _, _, _, tm, tt = big
    start, want = fits[4]
    free = tuple(tm.free_params)
    res = Residuals(tt, tm)
    got = gls_step(tm, free, start, tt, res.weights, res.errors_s, True)
    assert np.max(np.abs(got[0].numpy() - np.asarray(want[0]))) <= 1e-12
    M, Mj = got[1].numpy(), np.asarray(want[1])
    assert M.shape == Mj.shape == (1024, 14)
    for j, n in enumerate(free):
        assert rel(M[:, j], Mj[:, j]) <= 1e-10, n
    for name, g, wv in zip(("mtcm", "mtcy", "norm", "chi2_0", "ahat"), got[2:], want[2:]):
        assert rel(g, wv) <= 1e-10, name
    assert got[6].shape == (128,)


def test_grid_hybrid_design_matches_pint_tpu(big, fits):
    """The grid's design: tangents of the 12 nonlinear parameters and the
    analytic DM, DM1 columns, each with its weighted mean removed."""
    from pint_tpu.fitting.design import linear_columns as jax_linear_columns
    from pint_tpu.fitting.design import linear_split as jax_linear_split
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu.residuals import phase_residual_frac as jax_prf
    from pint_tpu_torch.fitting.woodbury import _step_inputs
    from pint_tpu_torch.gridutils import _time_resids_design
    from pint_tpu_torch.residuals import Residuals

    model, _, tens, tm, tt = big
    free = tuple(model.free_params)
    nonlin, lin, owners = jax_linear_split(model, free)
    assert (len(nonlin), lin) == (12, ("DM", "DM1"))
    w_np = 1.0 / np.asarray(model.scaled_sigma(model.params, tens)) ** 2
    w = jnp.asarray(w_np)
    params = model.xprec.convert_params(model.params)

    def rfun(delta):
        _, r, f = jax_prf(model, jax_apply(params, nonlin, delta), tens, subtract_mean=False)
        r = r / f
        return r - jnp.sum(w * r) / jnp.sum(w), f

    with jax.disable_jit():
        (r0, f0), lin_fn = jax.linearize(rfun, jnp.zeros(len(nonlin)))
        M_nl = jax.vmap(lin_fn)(jnp.eye(len(nonlin)))[0].T
        M_l = jax_linear_columns(model, params, tens, f0, slice(None, -1), lin, owners)
        M_l = M_l - jnp.sum(w[:, None] * M_l, axis=0) / jnp.sum(w)
    want = dict(zip(nonlin + lin, np.concatenate([np.asarray(M_nl), np.asarray(M_l)], 1).T))
    one = {k: (type(v)(v.hi[None], v.lo[None]) if hasattr(v, "hi") else v[None])
           for k, v in tm.params.items()}
    r, M = _time_resids_design(tm, one, tt, free)
    tw = 1.0 / Residuals(tt, tm).errors_s ** 2
    np.testing.assert_array_equal(tw.numpy(), w_np)
    r, Mn, norm = _step_inputs(r, M, tw, True, True)
    assert np.max(np.abs(r[0].numpy() - np.asarray(r0))) <= 1e-12
    for j, n in enumerate(free):
        assert rel(Mn[0, j] * norm[0, j], want[n]) <= 1e-10, n


def test_downhill_gls_fit_matches_pint_tpu(fits):
    jm, tm, want, got, _ = fits
    rw, rg = want.result, got.result
    assert rg.converged and rw.converged and rg.iterations == rw.iterations
    assert rg.iterations >= 2  # the shifted start makes the LM loop iterate
    assert abs(rg.chi2 - rw.chi2) <= 1e-10 * rw.chi2
    assert 0.8 <= rg.reduced_chi2 <= 1.2
    for n in got._free:
        a, b = leaf(jm.params[n]), leaf(tm.params[n])
        assert abs(b - a) <= 1e-10 * abs(a), n
        ua, ub = rw.uncertainties[n], rg.uncertainties[n]
        assert abs(ub - ua) <= 1e-10 * ua, n
    assert rel(got.noise_ampls, want.noise_ampls) <= 1e-10
    assert got.noise_ampls.shape == (128,)


def test_residuals_gls_chi2_matches_pint_tpu(fits):
    """Residuals.calc_chi2 of a correlated-noise model is the Woodbury
    chi^2 (pint_tpu dispatches the same way)."""
    from pint_tpu.residuals import Residuals as JaxResiduals

    jm, tm, want, got, _ = fits
    with jax.disable_jit():
        chi2_j = JaxResiduals(want.toas, jm, tensor=want.tensor).calc_chi2()
    assert abs(got.resids.calc_chi2() - chi2_j) <= 1e-10 * chi2_j
    assert abs(got.resids.calc_chi2() - got.result.chi2) <= 1e-10 * chi2_j


def test_gls_fitter_one_step_matches_pint_tpu(big, fits):
    from pint_tpu.fitting import GLSFitter as JaxFitter
    from pint_tpu_torch.fitting import GLSFitter

    _, toas, _, _, tt = big
    jm, tm = shifted(big)
    with jax.disable_jit():
        rw = JaxFitter(toas, jm).fit_toas()
    rg = GLSFitter(tt, tm).fit_toas()
    assert rg.iterations == rw.iterations == 1 and rg.converged == rw.converged
    assert abs(rg.chi2 - rw.chi2) <= 1e-10 * rw.chi2
    for n in rg.free_params:
        a, b = leaf(jm.params[n]), leaf(tm.params[n])
        assert abs(b - a) <= 1e-10 * abs(a), n
        assert abs(rg.uncertainties[n] - rw.uncertainties[n]) <= 1e-10 * rw.uncertainties[n]


def test_gls_grid_chisq_matches_pint_tpu(small):
    """The 3x3 (M2, SINI) grid with the GLS statistic after one
    Gauss-Newton refit of all 14 free parameters per point."""
    import jax.numpy as jnp

    from pint_tpu.fitting import DownhillGLSFitter as JaxFitter
    from pint_tpu.gridutils import grid_chisq as jax_grid
    from pint_tpu.ops.dd import DD as JaxDD
    from pint_tpu_torch.fitting import DownhillGLSFitter
    from pint_tpu_torch.gridutils import grid_chisq
    from pint_tpu_torch.profiles import grid_for

    model, toas, _, _, tt = small
    jm, tm = shifted(small)
    ftr = DownhillGLSFitter(tt, tm)
    ftr.fit_toas()
    jm.params = {k: JaxDD(jnp.float64(v[0]), jnp.float64(v[1])) if isinstance(v, tuple)
                 else jnp.float64(v) for k, v in params_numpy(tm.params).items()}
    names, vals = grid_for(tm, ftr)
    assert names == ("M2", "SINI")
    got = grid_chisq(ftr, names, vals)
    with jax.disable_jit():
        want = np.asarray(jax_grid(JaxFitter(toas, jm), names, vals))
    assert got.shape == want.shape == (3, 3) and np.all(np.isfinite(got))
    assert np.max(np.abs(got - want) / want) <= 1e-10

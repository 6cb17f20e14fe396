"""The port's simulation (``pint_tpu_torch/simulation.py``) and PTA profiles
against pint_tpu's, on the CPU, from one seed.

Two pulsars of ``tests/test_pta.py``'s test par (EFAC/EQUAD/ECORR, red noise
and the common background), 64 TOAs each. ``make_fake_toas_fromMJDs`` lies on
the model in both packages, so their TDB agrees within 1 ns, the tolerance of
``zero_residuals``. From the same TOAs (pint_tpu's, copied field by field
into the port's container) and the same seed, ``add_noise_from_model``'s white,
ECORR and red shifts and ``add_gwb_to_arrays``' shift agree within 1e-12 of
their largest value, and the shifted TDB within 1 ns. ``pta_sky`` and
``PTA_PAR_TEMPLATE`` are pint_tpu's letter for letter, and
``pta_smoke_array`` draws the same array.
"""

import copy

import numpy as np
import pytest
import torch

from tests.test_pta import PTA_TEST_PAR

SEED = 7
#: the TDB tolerance: zero_residuals' (1 ns)
TDB_TOL_S = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.max(np.abs(want)) if want.size else 0.0
    diff = np.max(np.abs(got - want)) if want.size else 0.0
    return diff / scale if scale else diff


def port_toas(jt):
    """pint_tpu's prepared TOAs copied field by field into the port's
    container (the same numbers)."""
    from pint_tpu_torch.astro.time import MJDEpoch
    from pint_tpu_torch.toas import TOAs

    def ep(e):
        return None if e is None else MJDEpoch(e.day.copy(), e.frac_hi.copy(), e.frac_lo.copy())

    return TOAs(utc=ep(jt.utc), tdb=ep(jt.tdb), error_us=jt.error_us.copy(),
                freq_mhz=jt.freq_mhz.copy(), obs=jt.obs.copy(), flags=copy.deepcopy(jt.flags),
                ssb_obs_pos_m=jt.ssb_obs_pos_m.copy(), ssb_obs_vel_m_s=jt.ssb_obs_vel_m_s.copy(),
                obs_sun_pos_m=jt.obs_sun_pos_m.copy(),
                planet_pos_m={k: v.copy() for k, v in jt.planet_pos_m.items()},
                ephem=jt.ephem, planets=jt.planets, utc_raw=ep(jt.utc_raw),
                include_gps=jt.include_gps, include_bipm=jt.include_bipm,
                bipm_version=jt.bipm_version, geom_stale_s=jt.geom_stale_s)


def tdb_distance(a, b) -> float:
    """max |TDB_a - TDB_b| in seconds."""
    day = (a.tdb.day - b.tdb.day).astype(np.float64)
    frac = (a.tdb.frac_hi - b.tdb.frac_hi) + (a.tdb.frac_lo - b.tdb.frac_lo)
    return float(np.max(np.abs(day + frac))) * 86400.0


def par_of(k: int, par: str = PTA_TEST_PAR) -> str:
    from pint_tpu.profiles import pta_sky

    name, raj, decj = pta_sky(k + 1)[k]
    return par.format(name=name, raj=raj, decj=decj, f0=346.531996493 + 0.37 * k)


def grid(k: int, n_epochs: int = 32):
    mjds = np.repeat(np.linspace(56600.0, 57400.0, n_epochs), 2)
    mjds[1::2] += 0.5 / 86400.0
    freqs = np.where(np.arange(len(mjds)) % 2 == 0, 1400.0, 800.0)
    return np.sort(mjds), freqs, [{"f": "Rcvr1_2_GUPPI"} for _ in mjds]


@pytest.fixture(scope="module")
def base():
    """Per pulsar: (pint_tpu model, port model, pint_tpu fake TOAs, the
    port's fake TOAs at the same MJDs)."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs as jax_fake
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    out = []
    for k in range(2):
        jm = build_model(parse_parfile(par_of(k), from_text=True))
        tm = get_model(par_of(k), from_text=True, device="cpu")
        mjds, freqs, flags = grid(k)
        jt = jax_fake(mjds, jm, obs="gbt", freq_mhz=freqs, error_us=1.0, flags=flags)
        tt = make_fake_toas_fromMJDs(mjds, tm, obs="gbt", freq_mhz=freqs, error_us=1.0,
                                     flags=flags)
        out.append((jm, tm, jt, tt))
    return out


def test_fake_toas_lie_on_the_model(base):
    from pint_tpu_torch.residuals import Residuals

    for jm, tm, jt, tt in base:
        d = tdb_distance(tt, jt)
        assert d <= TDB_TOL_S, d
        r = Residuals(tt, tm, subtract_mean=False).time_resids
        assert float(torch.max(torch.abs(r))) < TDB_TOL_S


class _Recorder:
    """Wraps a package's `_reprepare` and `basis_matvec` to keep each call's
    shift and each basis part's contribution."""

    def __init__(self, monkeypatch, sim, wood, to_np):
        self.shifts, self.parts = [], []
        reprepare, matvec = sim._reprepare, wood.basis_matvec

        def rec_reprepare(toas, shift, *args, **kwargs):
            self.shifts.append(np.array(shift, np.float64))
            return reprepare(toas, shift, *args, **kwargs)

        def rec_matvec(basis, ae, ad):
            self.parts.append({"ecorr": None if ae is None else to_np(matvec(basis, ae, None)),
                               "red": None if ad is None else to_np(matvec(basis, None, ad))})
            return matvec(basis, ae, ad)

        monkeypatch.setattr(sim, "_reprepare", rec_reprepare)
        monkeypatch.setattr(wood, "basis_matvec", rec_matvec)


def draws(monkeypatch, base):
    """Both packages' add_noise_from_model (the pulsar's own noise) and then
    add_gwb_to_arrays on the same TOAs from one seed; (pint_tpu's record,
    the port's, pint_tpu's TOAs after the draws, the port's)."""
    import pint_tpu.fitting.woodbury as jwood
    import pint_tpu.simulation as jsim
    import pint_tpu_torch.fitting.woodbury as twood
    import pint_tpu_torch.simulation as tsim

    recs = {}
    toas = {}
    for name, sim, wood, to_np in (("jax", jsim, jwood, np.asarray),
                                   ("port", tsim, twood, lambda t: t.cpu().numpy())):
        with monkeypatch.context() as mp:
            rec = recs[name] = _Recorder(mp, sim, wood, to_np)
            rng = np.random.default_rng(SEED)
            models = [m[0] if name == "jax" else m[1] for m in base]
            start = [m[2] if name == "jax" else port_toas(m[2]) for m in base]
            noisy = [sim.add_noise_from_model(t, m, rng=rng, include_common=False)
                     for t, m in zip(start, models)]
            rec.n_noise = len(rec.shifts)
            toas[name] = sim.add_gwb_to_arrays(noisy, models, rng=rng)
    return recs["jax"], recs["port"], toas["jax"], toas["port"]


@pytest.fixture(scope="module")
def drawn(base):
    with pytest.MonkeyPatch.context() as mp:
        return draws(mp, base)


def test_noise_shifts_match(drawn, base):
    """White, ECORR and red shifts of each pulsar within 1e-12 of the
    largest value, drawn in pint_tpu's order."""
    want, got, _, _ = drawn
    assert want.n_noise == got.n_noise == len(base)
    for a in range(len(base)):
        n = len(base[a][2])
        wp, gp = want.parts[a], got.parts[a]
        for part in ("ecorr", "red"):
            assert rel(gp[part][:n], wp[part][:n]) <= 1e-12, (a, part)
        white_w = want.shifts[a] - wp["ecorr"][:n] - wp["red"][:n]
        white_g = got.shifts[a] - gp["ecorr"][:n] - gp["red"][:n]
        assert rel(white_g, white_w) <= 1e-12, a
        assert rel(got.shifts[a], want.shifts[a]) <= 1e-12, a


def test_gwb_shifts_match(drawn, base):
    want, got, jt, tt = drawn
    k = len(base)
    for a in range(k):
        assert rel(got.shifts[k + a], want.shifts[k + a]) <= 1e-12, a
        d = tdb_distance(tt[a], jt[a])
        assert d <= TDB_TOL_S, (a, d)


def test_reprepare_reuses_the_geometry_below_its_threshold(base, monkeypatch):
    """Below PINT_TPU_REPREPARE_REUSE_US the times shift alone and the
    staleness adds up, as pint_tpu's; past it the prepare runs again."""
    from pint_tpu.simulation import _reprepare as jax_reprepare
    from pint_tpu_torch.simulation import _reprepare

    jt = base[0][2]
    tt = port_toas(jt)
    shift = np.full(len(jt), 4e-6)
    monkeypatch.setenv("PINT_TPU_REPREPARE_REUSE_US", "10")
    stale = jt.geom_stale_s  # zero_residuals' late passes
    j1, t1 = jax_reprepare(jt, shift), _reprepare(tt, shift, device="cpu")
    assert t1.geom_stale_s == j1.geom_stale_s == stale + 4e-6
    assert np.array_equal(t1.ssb_obs_pos_m, tt.ssb_obs_pos_m)
    assert tdb_distance(t1, j1) == 0.0
    j2, t2 = jax_reprepare(j1, shift), _reprepare(t1, shift, device="cpu")
    assert t2.geom_stale_s == j2.geom_stale_s == stale + 4e-6 + 4e-6
    j3, t3 = jax_reprepare(j2, shift), _reprepare(t2, shift, device="cpu")
    assert t3.geom_stale_s == j3.geom_stale_s == 0.0
    assert tdb_distance(t3, j3) <= 1e-12


def test_pta_profiles_letter_for_letter():
    from pint_tpu import profiles as jp
    from pint_tpu_torch import profiles as tp

    assert tp.PTA_PAR_TEMPLATE == jp.PTA_PAR_TEMPLATE
    assert tp.PTA_SKY == jp.PTA_SKY
    assert tp.pta_sky(70) == jp.pta_sky(70)


def test_pta_smoke_array_draws_pint_tpus_array():
    from pint_tpu.profiles import pta_smoke_array as jax_array
    from pint_tpu_torch.profiles import pta_smoke_array

    jm, jt = jax_array(2, 32, seed=3)
    tm, tt = pta_smoke_array(2, 32, seed=3, device="cpu")
    for a in range(2):
        assert tm[a].psr_name == jm[a].psr_name and tm[a].free_params == jm[a].free_params
        assert tdb_distance(tt[a], jt[a]) <= TDB_TOL_S
        assert np.array_equal(tt[a].error_us, jt[a].error_us)
        assert np.array_equal(tt[a].freq_mhz, jt[a].freq_mhz)

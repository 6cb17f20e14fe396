"""The port's N-body window (``astro/nbody.py``) against pint_tpu's: the host
build, the serve (K6's plain twin), the window quantization, the disk cache,
and the TOA prepare under pint_tpu's default ephemeris.

A window is built once per module, in each package, over 1 year at
t0 = 0.15 (about 9 s each on the CPU); the 12-year flagship window (about 80
s each) is the slow test. Measured on the CPU: the port's 1-year window is
bitwise pint_tpu's (grid, positions, velocities, both corrections; the K5
twin's 7.6e-6 m on Mercury does not reach it), within the bounds of 1 mm and
1e-7 m/s.

A 1-year window's own band corrections are ill-conditioned: over one year
the 780- and 584-day synodic columns are nearly those of the sextic, and the
terms of G . corr reach 5e15 m to sum to ~1e5 m, so that the sum depends on
its order by meters (BLAS's is 1.7 m from the exact one). The quantized
windows pint_tpu serves span at least 12 years, where the largest term is
1.8e6 m. So the serve and prepare parity run on a carried window of
pint_tpu's 1-year trajectories with the 12-year flagship window's
corrections (``tests/data/nbody_flagship_corr.npz``, 198 numbers of
pint_tpu's build); there they are bitwise equal. The 1-year window's own
serve is held to its Hermite part bitwise and the band product's rounding
bound.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_fixture import REPO

T0 = 0.15  # jcent; the flagship's quantized window centre (MJD 57023.25)
CORR = REPO / "tests" / "data" / "nbody_flagship_corr.npz"


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """(pint_tpu's, the port's) 1-year windows at T0, each built once, the
    port's into a disk cache of its own (the miss the cache test reads)."""
    from pint_tpu.astro.ephemeris import AnalyticEphemeris as JaxEphemeris
    from pint_tpu.astro.nbody import NBodyEphemeris as JaxWindow
    from pint_tpu_torch.astro.ephemeris import AnalyticEphemeris
    from pint_tpu_torch.astro.nbody import NBodyEphemeris

    cache = tmp_path_factory.mktemp("nbody_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PINT_TPU_CACHE_DIR", str(cache))
        mp.delenv("PINT_TPU_NBODY_CACHE", raising=False)
        mp.delenv("PINT_TPU_NBODY_COMB", raising=False)
        jw = JaxWindow(JaxEphemeris(), T0, span_years=1.0)
        pw = NBodyEphemeris(AnalyticEphemeris(), T0, span_years=1.0)
    return jw, pw, cache


def carried(jw, well_conditioned: bool = True):
    """(pint_tpu window, the port's window from its arrays): `jw`'s own, or
    its trajectories with the flagship window's band corrections."""
    from pint_tpu.astro.nbody import NBodyEphemeris as JaxWindow
    from pint_tpu_torch.astro.nbody import NBodyEphemeris

    src = {"corr_e": jw._corr_e, "corr_m": jw._corr_m, "periods_e": jw._periods_e,
           "periods_m": jw._periods_m, "half_span_s": jw.half_span_s}
    if well_conditioned:
        with np.load(CORR) as z:
            src = {k: z[k] for k in src}
    j = JaxWindow.__new__(JaxWindow)
    j.t0, j.grid_s, j.pos, j.vel = jw.t0, jw.grid_s, jw.pos, jw.vel
    j.half_span_s = float(src["half_span_s"])
    j._corr_e, j._corr_m = np.asarray(src["corr_e"]), np.asarray(src["corr_m"])
    j._periods_e, j._periods_m = tuple(src["periods_e"]), tuple(src["periods_m"])
    p = NBodyEphemeris.from_arrays(j.grid_s, j.pos, j.vel, j._corr_e, j._corr_m, j._periods_e,
                                   j._periods_m, j.t0, j.half_span_s)
    return j, p


def serve_epochs(nb, seed: int = 3):
    """TDB centuries: grid nodes, the last representable epoch before a
    node (cell edges), both ends of the window, and random epochs."""
    from pint_tpu.astro.nbody import CENT_S

    rng = np.random.default_rng(seed)
    g = nb.grid_s
    nodes = g[rng.integers(0, g.size, 200)]
    edges = np.nextafter(g[rng.integers(1, g.size, 100)], -np.inf)
    t = np.concatenate([nodes, edges, g[[0, 1, -2, -1]], rng.uniform(g[0], g[-1], 400)])
    T = nb.t0 + t / CENT_S
    assert np.any(np.isin((T - nb.t0) * CENT_S, g))  # some land exactly on a node
    return T


def test_port_window_matches_pint_tpu(windows):
    """The 1-year build: grid equal; positions, velocities and both
    corrections within 1 mm / 1e-7 m/s (measured: bitwise)."""
    jw, pw, _ = windows
    assert np.array_equal(pw.grid_s, jw.grid_s)
    assert pw.pos.shape == jw.pos.shape == (jw.grid_s.size, 10, 3)
    assert np.max(np.abs(pw.pos - jw.pos)) <= 1e-3
    assert np.max(np.abs(pw.vel - jw.vel)) <= 1e-7
    assert pw._corr_e.shape == (39, 3) and pw._corr_m.shape == (27, 3)
    assert (pw._periods_e, pw._periods_m) == (jw._periods_e, jw._periods_m)
    for got, want, periods in ((pw._corr_e, jw._corr_e, jw._periods_e),
                               (pw._corr_m, jw._corr_m, jw._periods_m)):
        G = jw._band_design(jw.grid_s, periods)  # the served corrections
        assert np.max(np.abs(G @ got - G @ want)) <= 1e-3


def test_serve_twin_matches_pint_tpu(windows):
    """K6's twin against pint_tpu's posvel on a carried window, every body
    and the EMB, at nodes, cell edges, both ends and random epochs: within
    1e-6 m and 1e-9 m/s (measured: bitwise)."""
    from pint_tpu.astro.nbody import _BODIES
    from pint_tpu_torch.astro import device_prepare as dp

    j, p = carried(windows[0])
    T = serve_epochs(j)
    served = dp.nbody_posvel(p, _BODIES + ("emb",), T, device="cpu")
    for b in _BODIES + ("emb",):
        want_p, want_v = j.posvel(b, T)
        got_p, got_v = served[b]
        assert got_p.shape == (T.size, 3)
        assert np.max(np.abs(got_p - want_p)) <= 1e-6, b
        assert np.max(np.abs(got_v - want_v)) <= 1e-9, b


def test_serve_twin_on_the_one_year_window(windows):
    """The 1-year window's own corrections: the Hermite part and the design
    columns bitwise equal to pint_tpu's, Earth and Moon within the rounding
    bound of the band product (2 K eps sum |G_j c_j|, K columns), since
    its terms cancel from ~1e15 m (module docstring)."""
    from pint_tpu.astro.nbody import CENT_S
    from pint_tpu_torch.astro.nbody import band_design

    j, p = carried(windows[0], well_conditioned=False)
    T = serve_epochs(j, seed=4)
    Tt = torch.as_tensor(T)
    for b in ("sun", "earth", "moon", "jupiter"):
        got, want = p._posvel_raw(b, Tt), j._posvel_raw(b, T)
        assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(),
                                                                          want[1]), b
    t = (T - j.t0) * CENT_S
    bound = 0.0
    for periods, corr in ((j._periods_e, j._corr_e), (j._periods_m, j._corr_m)):
        G, dG = band_design(torch.as_tensor(t), periods, j.half_span_s)
        wG, wdG = j._band_design(t, periods, deriv=True)
        assert np.array_equal(G.numpy(), wG) and np.array_equal(dG.numpy(), wdG)
        K = G.shape[1]
        bound += 2 * K * np.finfo(float).eps * np.max(np.abs(wG) @ np.abs(corr))
    assert bound > 1e-3  # the cancellation this test is about
    for b in ("earth", "moon"):
        got_p, _ = p.posvel(b, Tt)
        want_p, _ = j.posvel(b, T)
        assert np.max(np.abs(got_p.numpy() - want_p)) <= bound, b


def test_quantize_matches_pint_tpu():
    """Bitwise over random ranges; the flagship's data and TZR epoch share one key."""
    from pint_tpu.astro.ephemeris import quantize_nbody_window as jq
    from pint_tpu_torch.astro.ephemeris import quantize_nbody_window

    rng = np.random.default_rng(9)
    lo = rng.uniform(-0.3, 0.4, 2000)
    hi = lo + np.concatenate([rng.uniform(0, 0.3, 1990), np.zeros(10)])
    for a, b in zip(lo, hi):
        assert quantize_nbody_window(a, b) == jq(a, b)
    jc = lambda mjd: (mjd - 51544.5) / 36525.0  # noqa: E731
    key = quantize_nbody_window(jc(56650.0), jc(57350.0))
    assert key == quantize_nbody_window(jc(57000.1), jc(57000.1)) == (0.15, 12.0)


def test_disk_cache_miss_then_hit(windows, tmp_path, monkeypatch):
    """The module's build was a miss and wrote its entry under the port's own
    subdirectory, beside pint_tpu's entry for the same window; the same
    window again is a hit, bitwise equal, with no build; an empty cache is a
    miss again."""
    from pint_tpu_torch.astro.ephemeris import AnalyticEphemeris
    from pint_tpu_torch.astro.nbody import NBodyEphemeris

    _, pw, cache = windows
    entries = list((cache / "torch" / "nbody").glob("*.npz"))
    assert len(entries) == 1 and len(list((cache / "nbody").glob("*.npz"))) == 1

    def no_build(self, refine_iters):
        raise AssertionError("built")

    monkeypatch.setattr(NBodyEphemeris, "_build", no_build)
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(cache))
    hit = NBodyEphemeris(AnalyticEphemeris(), T0, span_years=1.0)
    for k in ("grid_s", "pos", "vel", "_corr_e", "_corr_m"):
        assert np.array_equal(getattr(hit, k), getattr(pw, k)), k
    assert (hit._periods_e, hit._periods_m) == (pw._periods_e, pw._periods_m)
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    with pytest.raises(AssertionError, match="built"):
        NBodyEphemeris(AnalyticEphemeris(), T0, span_years=1.0)


def test_legacy_comb_is_refused(monkeypatch):
    """Under pint_tpu's legacy ``PINT_TPU_NBODY_COMB=1`` a window build, the
    default serve and a pack snapshot raise before any work (pint_tpu builds
    another window there)."""
    from pint_tpu_torch.astro.ephemeris import AnalyticEphemeris
    from pint_tpu_torch.astro.kernel_ephemeris import pack_for_analytic
    from pint_tpu_torch.astro.nbody import NBodyEphemeris

    monkeypatch.setenv("PINT_TPU_NBODY_COMB", "1")
    monkeypatch.delenv("PINT_TPU_NBODY", raising=False)
    eph = AnalyticEphemeris()
    T = np.array([T0 - 0.001, T0 + 0.001])
    for call in (lambda: NBodyEphemeris(eph, T0, span_years=1.0),
                 lambda: eph.posvel_many(("earth",), T, device="cpu"),
                 lambda: pack_for_analytic(eph, T)):
        with pytest.raises(NotImplementedError, match="PINT_TPU_NBODY_COMB"):
            call()
    assert eph._nbody_windows == {}


def test_prepare_arrays_matches_pint_tpu(windows, tmp_path, monkeypatch):
    """256 synthetic GBT TOAs within 150 days of the window's centre, under
    pint_tpu's default ephemeris, a carried window in both packages'
    window caches under the quantized key (pint_tpu's host prepare,
    ``PINT_TPU_DEVICE_PREPARE=0``): positions within 1 mm, velocities within
    1e-7 m/s, TDB bitwise."""
    import pint_tpu.astro.ephemeris as jeph
    import pint_tpu_torch.astro.ephemeris as peph
    from pint_tpu.astro import time as jtime
    from pint_tpu.toas import prepare_arrays as jprepare
    from pint_tpu_torch.astro import time as ptime
    from pint_tpu_torch.toas import prepare_arrays

    for k in ("PINT_TPU_EPHEM", "PINT_TPU_KERNEL_EPHEM", "PINT_TPU_EOP", "PINT_CLOCK_OVERRIDE",
              "PINT_TPU_CLOCK_REPO", "TEMPO", "TEMPO2"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("PINT_TPU_NBODY", "1")
    monkeypatch.setenv("PINT_TPU_DEVICE_PREPARE", "0")
    j, p = carried(windows[0])
    rng = np.random.default_rng(12)
    n = 256
    mjd = np.sort(57023.25 + rng.uniform(-150.0, 150.0, n))
    day = np.floor(mjd).astype(np.int64)
    frac = mjd - day
    jc = (mjd - 51544.5) / 36525.0
    key = peph.quantize_nbody_window(float(jc.min()), float(jc.max()))
    assert key == (T0, 12.0)
    jeph_default, peph_default = jeph.AnalyticEphemeris(), peph.AnalyticEphemeris()
    jeph_default._nbody_windows[key] = j
    peph_default._nbody_windows[key] = p
    monkeypatch.setattr(jeph, "_DEFAULT", jeph_default)
    monkeypatch.setattr(peph, "_DEFAULT", peph_default)
    err = np.full(n, 1.0)
    freq = rng.choice([820.0, 1400.0], n)
    obs = np.array(["gbt"] * n)
    want = jprepare(jtime.MJDEpoch(day, frac, np.zeros(n)), err, freq, obs)
    got = prepare_arrays(ptime.MJDEpoch(day, frac, np.zeros(n)), err, freq, obs, device="cpu")
    assert peph_default._nbody_windows == {key: p} and got.ephem == want.ephem == "analytic"
    for k in ("ssb_obs_pos_m", "obs_sun_pos_m"):
        assert np.max(np.abs(getattr(got, k) - getattr(want, k))) <= 1e-3, k
    assert np.max(np.abs(got.ssb_obs_vel_m_s - want.ssb_obs_vel_m_s)) <= 1e-7
    for f in ("day", "frac_hi", "frac_lo"):
        assert np.array_equal(getattr(got.tdb, f), getattr(want.tdb, f)), f
    assert "nbody_build" not in got.stage_s  # served from the instance's window


@pytest.mark.slow
def test_flagship_window_matches_pint_tpu(tmp_path, monkeypatch):
    """The 12-year window of the flagship's data (t0 0.15, ~80 s per build in
    each package): grid equal, positions and velocities within 1 mm and
    1e-7 m/s, and the served Earth within 1e-6 m of pint_tpu's."""
    from pint_tpu.astro.ephemeris import AnalyticEphemeris as JaxEphemeris
    from pint_tpu.astro.nbody import NBodyEphemeris as JaxWindow
    from pint_tpu_torch.astro import device_prepare as dp
    from pint_tpu_torch.astro.ephemeris import AnalyticEphemeris
    from pint_tpu_torch.astro.nbody import NBodyEphemeris

    monkeypatch.setenv("PINT_TPU_NBODY_CACHE", "0")
    jw = JaxWindow(JaxEphemeris(), T0, span_years=12.0)
    pw = NBodyEphemeris(AnalyticEphemeris(), T0, span_years=12.0)
    assert np.array_equal(pw.grid_s, jw.grid_s) and jw.grid_s.size == 8767
    assert np.max(np.abs(pw.pos - jw.pos)) <= 1e-3
    assert np.max(np.abs(pw.vel - jw.vel)) <= 1e-7
    T = serve_epochs(jw)
    served = dp.nbody_posvel(pw, ("earth", "moon", "emb"), T, device="cpu")
    for b in ("earth", "moon", "emb"):
        assert np.max(np.abs(served[b][0] - jw.posvel(b, T)[0])) <= 1e-6, b

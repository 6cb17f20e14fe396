"""The port's SPK reader (``astro/spk.py``), Chebyshev pack
(``astro/kernel_ephemeris.py``, K7's twin), SPK writer
(``astro/spk_write.py``) and ephemeris settings against pint_tpu's.

Bounds: the pack compiled from ``tests/data/mini_de.bsp`` (MJD 55000-55120;
Sun, EMB, Earth, Moon, Jupiter) equal to pint_tpu's; the reader and the
pack's evaluation within 1e-6 m and 1e-9 m/s of pint_tpu's (measured:
bitwise), the pack within 1 mm and 1e-7 m/s of the reader (the same
polynomial summed in another order; measured 0.37 mm on Jupiter); the
analytic-series pack (``PINT_TPU_NBODY=0``) within 1 mm of pint_tpu's. The
export round trip runs on a 1-year window built here (~9 s).
"""

import os
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_fixture import REPO

MINI_DE = REPO / "tests" / "data" / "mini_de.bsp"
ET_DAY = 86400.0
BODIES = ("sun", "emb", "earth", "moon", "jupiter")


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    from pint_tpu.astro import kernel_ephemeris as jke
    from pint_tpu_torch.astro import kernel_ephemeris as ke

    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path / "cache"))
    for k in ("PINT_TPU_EPHEM", "PINT_TPU_KERNEL_EPHEM", "PINT_TPU_NBODY_COMB"):
        monkeypatch.delenv(k, raising=False)
    ke.clear_memory_cache()
    jke.clear_memory_cache()
    yield
    ke.clear_memory_cache()
    jke.clear_memory_cache()


def mini_epochs(pack, seed: int = 4):
    """TDB centuries inside the mini kernel's coverage: random epochs, every
    record edge of the EMB and the Earth, and both ends."""
    rng = np.random.default_rng(seed)
    lo, hi = pack.span_et("earth")
    et = [rng.uniform(lo, hi, 600)]
    for b in ("emb", "earth"):
        i = pack.row(b)
        et.append(pack.init[i] + pack.intlen[i] * np.arange(pack.nrec[i] + 1))
    et = np.clip(np.concatenate(et + [[lo, hi]]), lo, hi)
    return et / (36525.0 * ET_DAY)


def test_pack_from_spk_matches_pint_tpu():
    from pint_tpu.astro.kernel_ephemeris import pack_from_spk as jax_pack
    from pint_tpu_torch.astro.kernel_ephemeris import pack_from_spk

    got, want = pack_from_spk(str(MINI_DE)), jax_pack(str(MINI_DE))
    assert got.bodies == want.bodies == BODIES
    assert got.centers == want.centers == ("ssb", "ssb", "emb", "emb", "ssb")
    for k in ("coef", "mid", "init", "intlen", "nrec"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.coef.shape == (5, 30, 12, 3) and got.nrec.dtype == np.int32
    assert got.source == want.source


def test_reader_and_eval_twin_match_pint_tpu():
    """The host reader and K7's twin against pint_tpu's reader and eval,
    every body of the kernel, at random epochs and every record edge."""
    from pint_tpu.astro import kernel_ephemeris as jke
    from pint_tpu.astro.spk import SPKEphemeris as JaxReader
    from pint_tpu_torch.astro import device_prepare as dp
    from pint_tpu_torch.astro.kernel_ephemeris import pack_from_spk
    from pint_tpu_torch.astro.spk import SPKEphemeris

    pack = pack_from_spk(str(MINI_DE))
    jpack = jke.pack_from_spk(str(MINI_DE))
    T = mini_epochs(pack)
    reader, jreader = SPKEphemeris(str(MINI_DE)), JaxReader(str(MINI_DE))
    served = dp.kernel_posvel(pack, BODIES, T, device="cpu")
    for b in BODIES:
        rp, rv = reader.posvel_ssb(b, T)
        wp, wv = jreader.posvel_ssb(b, T)
        assert np.max(np.abs(rp - wp)) <= 1e-6 and np.max(np.abs(rv - wv)) <= 1e-9, b
        ep, ev = jke.eval_posvel(jpack, b, T * 36525.0 * ET_DAY)
        gp, gv = served[b]
        assert np.max(np.abs(gp - ep)) <= 1e-6 and np.max(np.abs(gv - ev)) <= 1e-9, b
        assert np.max(np.abs(gp - rp)) <= 1e-3 and np.max(np.abs(gv - rv)) <= 1e-7, b
    many = reader.posvel_many(("earth",), T)
    assert np.array_equal(many["earth"][0], reader.posvel_ssb("earth", T)[0])


def test_nan_pad_records_change_nothing():
    """Pad records (past a body's nrec) and pad coefficients are never read:
    poisoned with NaN, every served bit is unchanged."""
    from dataclasses import replace

    from pint_tpu_torch.astro import device_prepare as dp
    from pint_tpu_torch.astro.kernel_ephemeris import pack_from_spk

    pack = pack_from_spk(str(MINI_DE))
    T = mini_epochs(pack, seed=5)
    coef, mid = pack.coef.copy(), pack.mid.copy()
    padded = 0
    for i, n in enumerate(pack.nrec):
        coef[i, n:], mid[i, n:] = np.nan, np.nan
        padded += pack.mid.shape[1] - n
    assert padded > 0
    poisoned = replace(pack, coef=coef, mid=mid, _dev={})
    a = dp.kernel_posvel(pack, BODIES, T, device="cpu")
    b = dp.kernel_posvel(poisoned, BODIES, T, device="cpu")
    for body in BODIES:
        assert np.array_equal(a[body][0], b[body][0]) and np.array_equal(a[body][1], b[body][1])


def test_out_of_coverage_raises():
    from pint_tpu_torch.astro import device_prepare as dp
    from pint_tpu_torch.astro.kernel_ephemeris import KernelEphemeris, pack_from_spk

    pack = pack_from_spk(str(MINI_DE))
    lo, hi = pack.span_et("earth")
    late = np.array([hi + 2.0 * ET_DAY]) / (36525.0 * ET_DAY)
    with pytest.raises(ValueError, match="outside kernel pack coverage"):
        dp.kernel_posvel(pack, ("earth",), late, device="cpu")
    with pytest.raises(ValueError, match="outside kernel pack coverage"):
        KernelEphemeris(pack).posvel_many(("sun",), late, device="cpu")
    with pytest.raises(KeyError, match="mars"):
        dp.kernel_posvel(pack, ("mars",), late, device="cpu")


@pytest.mark.parametrize("env,cls", [
    ({}, "AnalyticEphemeris"),
    ({"PINT_TPU_NBODY": "0"}, "AnalyticEphemeris"),
    ({"PINT_TPU_KERNEL_EPHEM": "1"}, "AnalyticEphemeris"),
    ({"PINT_TPU_EPHEM": str(MINI_DE)}, "KernelEphemeris"),
    ({"PINT_TPU_EPHEM": str(MINI_DE), "PINT_TPU_KERNEL_EPHEM": "0"}, "SPKEphemeris"),
])
def test_get_ephemeris_serves_each_setting(monkeypatch, env, cls):
    """The class pint_tpu's get_ephemeris returns under each setting, and the
    same source name; the built-in ephemeris engages its window unless
    PINT_TPU_NBODY=0."""
    from pint_tpu.astro.ephemeris import get_ephemeris as jax_get
    from pint_tpu_torch.astro.ephemeris import get_ephemeris

    monkeypatch.delenv("PINT_TPU_NBODY", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = get_ephemeris(), jax_get()
    assert type(got).__name__ == type(want).__name__ == cls
    assert got.name == want.name
    if cls == "AnalyticEphemeris":
        engaged = env.get("PINT_TPU_NBODY") != "0"
        windows = []
        monkeypatch.setattr(type(got), "_nbody_window", lambda self, *key: windows.append(key))
        got._nbody_for(np.array([0.149, 0.151]))
        assert windows == ([(0.15, 12.0)] if engaged else [])


@pytest.mark.parametrize("env", [{}, {"PINT_TPU_KERNEL_EPHEM_CACHE": "0"},
                                 {"PINT_TPU_KERNEL_EPHEM_KEEP": "1"}])
def test_cached_pack_disk_knobs(monkeypatch, env):
    """`cached_pack` under pint_tpu's disk knobs: by default an entry is
    written, read back bitwise once the memory cache is dropped, and a
    corrupt entry is quarantined and rebuilt; ``PINT_TPU_KERNEL_EPHEM_CACHE=0``
    leaves the disk alone; ``PINT_TPU_KERNEL_EPHEM_KEEP=1`` keeps one entry."""
    from pint_tpu_torch.astro import kernel_ephemeris as ke

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    builds = []

    def build():
        builds.append(1)
        return ke.pack_from_spk(str(MINI_DE))

    d = ke._pack_cache_dir()
    first = ke.cached_pack("a", build)
    ke.clear_memory_cache()
    again = ke.cached_pack("a", build)
    if "PINT_TPU_KERNEL_EPHEM_CACHE" in env:
        assert not d.exists() and len(builds) == 2
        return
    assert len(builds) == 1
    for k in ("coef", "mid", "init", "intlen", "nrec"):
        assert np.array_equal(getattr(again, k), getattr(first, k), equal_nan=True), k
    (entry,) = d.glob("pack-*.npz")
    ke.cached_pack("b", build)
    assert len(list(d.glob("pack-*.npz"))) == (1 if env else 2)
    if env:
        return
    entry.write_bytes(b"not a pack")
    ke.clear_memory_cache()
    ke.cached_pack("a", build)
    assert len(builds) == 3 and (d / "quarantine" / entry.name).exists() and entry.exists()


def test_pack_for_analytic_matches_pint_tpu(monkeypatch):
    """The analytic series' pack snapshot (PINT_TPU_NBODY=0) over the
    flagship's quantized window: layout equal to pint_tpu's, the served
    positions within 1 mm for every body; cached on disk in the port's own
    subdirectory, and served again from memory."""
    from pint_tpu.astro.ephemeris import AnalyticEphemeris as JaxEphemeris
    from pint_tpu.astro.kernel_ephemeris import eval_posvel as jax_eval
    from pint_tpu.astro.kernel_ephemeris import pack_for_analytic as jax_pack
    from pint_tpu_torch.astro import device_prepare as dp
    from pint_tpu_torch.astro import ephemeris as peph
    from pint_tpu_torch.astro.kernel_ephemeris import pack_for_analytic

    monkeypatch.setenv("PINT_TPU_NBODY", "0")
    T = np.array([0.149, 0.151])
    eph = peph.AnalyticEphemeris()
    with peph.stage_sink({}) as built:
        got = pack_for_analytic(eph, T)
    want = jax_pack(JaxEphemeris(), T)
    assert set(built) == {"kernel_build"}
    assert (got.bodies, got.centers, got.source) == (want.bodies, want.centers, want.source)
    for k in ("mid", "init", "intlen", "nrec"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    rng = np.random.default_rng(6)
    Ts = rng.uniform(0.095, 0.205, 400)
    served = dp.kernel_posvel(got, got.bodies, Ts, device="cpu")
    for b in got.bodies:
        wp, _ = jax_eval(want, b, Ts * 36525.0 * ET_DAY)
        assert np.max(np.abs(served[b][0] - wp)) <= 1e-3, b
    assert pack_for_analytic(eph, T) is got
    cache = Path(os.environ["PINT_TPU_CACHE_DIR"]) / "torch" / "ephem_packs"
    assert len(list(cache.glob("pack-*.npz"))) == 1


def test_export_spk_round_trip(tmp_path, monkeypatch):
    """export_spk of a 1-year window (with the flagship window's band
    corrections, see test_torch_nbody) over 300 days: its records equal
    pint_tpu's export of the same window (measured: bitwise); read back by the
    port's reader, within the distance of a 12-coefficient record (8 days for
    the EMB, 4 for the Earth and Moon about it) to the window's own serve,
    whose cubic Hermite interpolation on the half-day grid is only C1 (~170 m
    of interpolation error on the Moon): measured 0.18 mm (Sun), 1.5 mm
    (Jupiter), 2.6 m (EMB), 4.2 m (Earth), 266 m (Moon), the same distance
    as pint_tpu's own snapshots of the flagship window (6.7 m Earth, 350 m
    Moon); its pack serves the reader's values within 1 mm."""
    from pint_tpu.astro.ephemeris import AnalyticEphemeris as JaxEphemeris
    from pint_tpu.astro.kernel_ephemeris import pack_from_spk as jax_pack
    from pint_tpu.astro.spk_write import export_spk as jax_export
    from pint_tpu_torch.astro import device_prepare as dp
    from pint_tpu_torch.astro.ephemeris import AnalyticEphemeris
    from pint_tpu_torch.astro.kernel_ephemeris import pack_for_spk_file
    from pint_tpu_torch.astro.nbody import NBodyEphemeris
    from pint_tpu_torch.astro.spk import SPKEphemeris
    from pint_tpu_torch.astro.spk_write import export_spk
    from tests.test_torch_nbody import T0, carried

    monkeypatch.setenv("PINT_TPU_NBODY", "1")
    j, nb = carried(NBodyEphemeris(AnalyticEphemeris(), T0, span_years=1.0))
    eph, jeph = AnalyticEphemeris(), JaxEphemeris()
    eph._nbody_windows[(T0, 12.0)], jeph._nbody_windows[(T0, 12.0)] = nb, j
    path, jpath = tmp_path / "window.bsp", tmp_path / "pint_tpu.bsp"
    export_spk(str(path), 56873.0, 57173.0, ephem=eph, device="cpu")
    jax_export(str(jpath), 56873.0, 57173.0, ephem=jeph)
    pack, want = pack_for_spk_file(str(path)), jax_pack(str(jpath))
    assert pack.bodies == want.bodies and pack.coef.shape == (11, 75, 12, 3)
    for k in ("coef", "mid", "init", "intlen", "nrec"):
        assert np.array_equal(getattr(pack, k), getattr(want, k)), k
    reader = SPKEphemeris(str(path))
    T = (np.random.default_rng(7).uniform(56874.0, 57172.0, 300) - 51544.5) / 36525.0
    bounds = {"sun": (1e-3, 1e-7), "jupiter": (5e-3, 1e-7), "emb": (10.0, 1e-3),
              "earth": (10.0, 1e-3), "moon": (500.0, 0.05)}
    direct = dp.nbody_posvel(nb, tuple(bounds), T, device="cpu")
    packed = dp.kernel_posvel(pack, tuple(bounds), T, device="cpu")
    for b, (p, v) in direct.items():
        rp, rv = reader.posvel_ssb(b, T)
        assert np.max(np.abs(rp - p)) <= bounds[b][0], b
        assert np.max(np.abs(rv - v)) <= bounds[b][1], b
        assert np.max(np.abs(packed[b][0] - rp)) <= 1e-3, b


#: what ``chip_smoke.py`` phases 21-22 hold the port's pack snapshot and SPK
#: export of the flagship window to, against its direct serve: the Earth
#: (m, m/s) and the GLS fit (sigma)
SNAPSHOT_LIMITS = {"earth_m": 10.0, "earth_m_s": 1e-3, "fit_sigma": 0.1}


def dd_diff(a, b) -> float:
    """a - b of two pint_tpu parameter leaves, a DD one without rounding its
    two parts together first."""
    if hasattr(a, "hi"):
        return float((np.asarray(a.hi) - np.asarray(b.hi)) + (np.asarray(a.lo) - np.asarray(b.lo)))
    return float(np.asarray(a) - np.asarray(b))


@pytest.mark.slow
def test_pint_tpu_snapshot_of_the_flagship_window(tmp_path, monkeypatch, capsys):
    """pint_tpu's own pack snapshot (``PINT_TPU_KERNEL_EPHEM=1``) of the
    flagship's 12-year N-body window against its direct serve, and the shift
    of its GLS fit of ``flagship_n16384_nbody.tim`` between the two: the
    basis of `SNAPSHOT_LIMITS`. pint_tpu's 0.05 m pack-vs-direct bound
    (tests/test_kernel_ephemeris.py) is of the analytic series: a Chebyshev
    record cannot follow the window's C1 Hermite serve that close, so the
    Earth's distance is above it. A cold window build (~1 minute) and two
    fits of 16,384 TOAs; 157 s on the CPU. Measured: Earth 5.88 m and
    5.4e-4 m/s, Moon 311 m and 0.027 m/s, the fit 0.060 sigma (DECJ)."""
    from pint_tpu.astro import ephemeris as jeph
    from pint_tpu.fitting import DownhillGLSFitter
    from pint_tpu.models import get_model_and_toas
    from pint_tpu_torch.prepared import FLAGSHIP_NBODY_TIM
    from pint_tpu_torch.profiles import FLAGSHIP_SMOKE_PAR

    monkeypatch.setenv("PINT_TPU_NBODY", "1")  # tests/conftest.py pins 0
    monkeypatch.setattr(jeph, "_DEFAULT", None)
    eph = jeph.get_ephemeris()
    mjd = np.concatenate([np.random.default_rng(8).uniform(56650.0, 57350.0, 4000),
                          [56650.0, 57000.1, 57350.0]])
    T = (mjd - 51544.5) / 36525.0
    direct = {b: eph.posvel_ssb(b, T) for b in ("earth", "moon")}
    monkeypatch.setenv("PINT_TPU_KERNEL_EPHEM", "1")
    snap = {b: eph.posvel_ssb(b, T) for b in ("earth", "moon")}
    dist = {f"{b}_{u}": float(np.max(np.abs(snap[b][i] - direct[b][i])))
            for b in ("earth", "moon") for i, u in enumerate(("m", "m_s"))}

    par = tmp_path / "flagship.par"
    par.write_text(FLAGSHIP_SMOKE_PAR)
    fits = []
    for kernel in (None, "1"):
        if kernel is None:
            monkeypatch.delenv("PINT_TPU_KERNEL_EPHEM")
        else:
            monkeypatch.setenv("PINT_TPU_KERNEL_EPHEM", kernel)
        model, toas = get_model_and_toas(str(par), str(FLAGSHIP_NBODY_TIM))
        ftr = DownhillGLSFitter(toas, model)
        ftr.fit_toas()
        assert ftr.result.converged
        fits.append(ftr)
    unc = fits[0].result.uncertainties
    shift = {n: abs(dd_diff(fits[1].model.params[n], fits[0].model.params[n])) / unc[n]
             for n in fits[0].result.free_params}
    worst = max(shift, key=shift.get)
    with capsys.disabled():
        print(f"\npint_tpu snapshot vs direct serve: {dist}; fit shift {shift[worst]:.4g} sigma "
              f"({worst})")
    assert 0.05 < dist["earth_m"] <= SNAPSHOT_LIMITS["earth_m"]
    assert dist["earth_m_s"] <= SNAPSHOT_LIMITS["earth_m_s"]
    assert shift[worst] <= SNAPSHOT_LIMITS["fit_sigma"]

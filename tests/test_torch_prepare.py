"""The twins of the TOA prepare's two kernels against pint_tpu's host numpy:
K4 (site geometry, ``astro/erot.py``) and K5 (the analytic ephemeris,
``astro/ephemeris.py``), the packing of K5's tables, the ephemeris settings
the port refuses, and the mask clauses.

Bounds: K4's twin within 1e-6 m and 1e-9 m/s of ``erot.itrf_to_gcrs_posvel``
(4,096 epochs 1995-2035, GBT, polar motion of a few tenths of an arcsecond);
K5's twin within 1 mm and 1e-4 m/s of ``AnalyticEphemeris._posvel_analytic``
for every body. An ulp of Neptune's barycentric position is ~1 mm, so the
twins sum every series in numpy's order (``erot.npsum``) and form the 3x3
products as numpy's matmul and einsum do; they then agree to the bit on
nearly every value.
"""

import numpy as np
import pytest
import torch

N_EPOCHS = 4096
GBT_ITRF = (882589.65, -4924872.32, 3943729.348)


def epochs(seed: int = 5, n: int = N_EPOCHS):
    """UTC MJDs 1995-2035, their TT centuries, and polar-motion angles."""
    rng = np.random.default_rng(seed)
    mjd = np.sort(rng.uniform(49718.0, 64328.0, n))
    tt = (mjd + 69.184 / 86400.0 - 51544.5) / 36525.0
    xp = rng.uniform(-1.5e-6, 1.5e-6, n)  # ~0.3 arcsec
    yp = rng.uniform(-1.5e-6, 1.5e-6, n)
    return mjd, tt, xp, yp


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def test_k4_twin_matches_pint_tpu_erot():
    from pint_tpu.astro import erot as jerot
    from pint_tpu_torch.astro.device_prepare import site_geometry

    ut1, tt, xp, yp = epochs()
    want_p, want_v = jerot.itrf_to_gcrs_posvel(np.asarray(GBT_ITRF), ut1, tt, xp_rad=xp,
                                              yp_rad=yp)
    got_p, got_v = site_geometry(GBT_ITRF, t64(ut1), t64(tt), t64(xp), t64(yp))
    assert got_p.shape == (N_EPOCHS, 3) and got_p.dtype == torch.float64
    assert np.max(np.abs(got_p.numpy() - want_p)) <= 1e-6
    assert np.max(np.abs(got_v.numpy() - want_v)) <= 1e-9
    # the polar motion reaches the result (~10 m at 0.3 arcsec)
    p0, _ = site_geometry(GBT_ITRF, t64(ut1), t64(tt), t64(0 * xp), t64(0 * yp))
    assert np.max(np.abs(p0.numpy() - got_p.numpy())) > 1.0


def test_k4_twin_pieces_match_pint_tpu():
    """ERA's remainders (divisor's sign), the nutation and the NPB matrix."""
    from pint_tpu.astro import erot as jerot
    from pint_tpu_torch.astro import erot

    ut1, tt, _, _ = epochs(n=512)
    ut1 = np.concatenate([ut1, [51544.5, 51544.25, 40000.75]])  # du <= 0 included
    tt = np.concatenate([tt, [0.0, -1e-5, -0.3]])
    assert np.array_equal(erot.era(t64(ut1)).numpy(), jerot.era(ut1))
    for a, b in zip(erot.nutation(t64(tt)), jerot.nutation(tt)):
        assert np.max(np.abs(a.numpy() - b)) <= 1e-18
    assert np.max(np.abs(erot.npb_matrix(t64(tt)).numpy() - jerot.npb_matrix(tt))) <= 1e-15


def test_npsum_is_numpys_summation_order():
    from pint_tpu_torch.astro.erot import npsum

    rng = np.random.default_rng(2)
    for n in (0, 1, 5, 7, 8, 9, 16, 31, 64, 128, 129, 300):
        x = rng.standard_normal((7, n)) * 10.0 ** rng.uniform(-6, 12, (7, n))
        assert np.array_equal(npsum(t64(x)).numpy(), np.sum(x, axis=-1)), n


def test_k5_twin_matches_pint_tpu_for_every_body():
    from pint_tpu.astro.ephemeris import AnalyticEphemeris
    from pint_tpu_torch.astro.device_prepare import analytic_ephemeris
    from pint_tpu_torch.astro.ephemeris import BODIES

    ref = AnalyticEphemeris()
    assert BODIES == ref.bodies
    mjd, _, _, _ = epochs(seed=6)
    T = (mjd - 51544.5) / 36525.0
    got = analytic_ephemeris(BODIES, t64(T))
    for b in BODIES:
        want_p, want_v = ref._posvel_analytic(b, T)
        gp, gv = got[b]
        assert gp.shape == (N_EPOCHS, 3)
        assert np.max(np.abs(gp.numpy() - want_p)) <= 1e-3, b
        assert np.max(np.abs(gv.numpy() - want_v)) <= 1e-4, b


def test_k5_table_pack_holds_every_series():
    """The packed table K5 reads: the VSOP87 term counts (Earth 195, Venus
    52, Jupiter 92, Saturn 117, Uranus 168, Neptune 124),
    the Moon's rows, three bodies' mean elements and the constants."""
    from pint_tpu_torch.astro.ephemeris import (ECL2EQU, KEPLER_BODIES, VSOP_BODIES,
                                                _ELEMENTS, pack_tables)

    table, layout = pack_tables()
    assert table.dtype == np.float64 and layout.dtype == np.int32
    lay = layout[:-7].reshape(len(VSOP_BODIES), 3, 6, 2)
    counts = dict(zip(VSOP_BODIES, lay[..., 1].sum(axis=(1, 2))))
    assert counts == {"earth": 195, "venus": 52, "jupiter": 92, "saturn": 117,
                      "uranus": 168, "neptune": 124}
    assert lay[..., 1].max() <= 128  # each power fits one pairwise block
    off_lr, n_lr, off_b, n_b, off_k, off_c, size = layout[-7:]
    assert (n_lr, n_b, size) == (31, 20, table.size)
    assert off_b - off_lr == 6 * n_lr and off_k - off_b == 5 * n_b
    kep = table[off_k:off_c].reshape(len(KEPLER_BODIES), 12)
    for j, b in enumerate(KEPLER_BODIES):
        assert np.array_equal(kep[j], np.ravel(_ELEMENTS[b]))
    assert np.array_equal(table[off_c + 14:off_c + 23], ECL2EQU.ravel())
    assert table.size == off_c + 41


def test_k5_wrappers_take_the_twin_on_the_cpu():
    """On a CPU tensor the wrappers run the twins and count no launch; the
    numpy-facing entry points resolve the device."""
    from pint_tpu_torch.astro import device_prepare as dp

    mjd, tt, xp, yp = epochs(n=16)
    T = (mjd - 51544.5) / 36525.0
    k4, k5 = dp.site_geometry.launches, dp.analytic_ephemeris.launches
    out = dp.analytic_posvel(("earth", "sun"), T, device="cpu")
    want = dp.analytic_ephemeris_plain(("earth", "sun"), t64(T))
    assert np.array_equal(out["earth"][0], want["earth"][0].numpy())
    p, v = dp.site_posvel(GBT_ITRF, mjd, tt, xp, yp, device="cpu")
    assert isinstance(p, np.ndarray) and p.shape == (16, 3)
    assert (dp.site_geometry.launches, dp.analytic_ephemeris.launches) == (k4, k5)
    with pytest.raises(KeyError, match="pluto"):
        dp.analytic_ephemeris(("earth", "pluto"), t64(T))


@pytest.mark.parametrize("env", [{"PINT_TPU_NBODY": "1"}, {"PINT_TPU_EPHEM": "/x/de440.bsp"},
                                 {"PINT_TPU_KERNEL_EPHEM": "1"}])
def test_port_raises_where_pint_tpu_falls_back(monkeypatch, tmp_path, env):
    """Where pint_tpu falls back from the ephemerides of slice 4 (a window
    that fails to build, to the analytic series; a missing SPK kernel, to
    the analytic series with a ledger event; a pack snapshot that fails, to
    the direct path), the port raises instead of answering differently."""
    from pint_tpu_torch.astro import kernel_ephemeris, nbody
    from pint_tpu_torch.astro.ephemeris import AnalyticEphemeris, get_ephemeris

    def broken(*args, **kwargs):
        raise OSError("no room")

    monkeypatch.setenv("PINT_TPU_NBODY", "0")
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(nbody.NBodyEphemeris, "_build", broken)
    monkeypatch.setattr(nbody.NBodyEphemeris, "_load_cached", lambda self, n: False)
    monkeypatch.setattr(kernel_ephemeris, "pack_from_source", broken)
    T = (np.array([57000.0, 57001.0]) - 51544.5) / 36525.0
    if "PINT_TPU_EPHEM" in env:
        with pytest.raises(FileNotFoundError, match="does not exist"):
            get_ephemeris()
        return
    eph = AnalyticEphemeris()
    match = "no room" if "PINT_TPU_NBODY" in env else "direct path"
    with pytest.raises((OSError, RuntimeError), match=match):
        eph.posvel_many(("earth", "sun"), T, device="cpu")


def test_mask_clauses_select_as_pint_tpu():
    """The all, mjd, freq, tel and flag clause kinds over prepared TOAs."""
    from pint_tpu.models.parameter import MaskClause as JaxClause
    from pint_tpu.models.parameter import parse_mask_clause as jax_parse
    from pint_tpu_torch.astro.time import MJDEpoch
    from pint_tpu_torch.models.parameter import MaskClause, parse_mask_clause

    class Toas:  # the host fields a clause reads
        def __init__(self, rng, n=300):
            day = rng.integers(56000, 58000, n)
            self.tdb = MJDEpoch(day, rng.uniform(0, 1, n), np.zeros(n))
            self.freq_mhz = rng.choice([430.0, 820.0, 1400.0, np.inf], n)
            self.obs = rng.choice(["gbt", "arecibo", "parkes"], n)
            self.flags = [{"f": str(rng.choice(["A", "B"]))} if rng.uniform() < 0.8 else {}
                          for _ in range(n)]

        def __len__(self):
            return len(self.freq_mhz)

    toas = Toas(np.random.default_rng(8))
    lines = (["-f", "A", "1.1"], ["MJD", "56500", "57200.5", "0.1"], ["FREQ", "500", "1500", "1"],
             ["TEL", "ao", "0.1"], ["T", "pks", "0.2", "1"], ["-f", "C", "1"])
    for tokens in lines:
        (jc, jrest), (pc, prest) = jax_parse(list(tokens)), parse_mask_clause(list(tokens))
        assert (pc.kind, pc.key, pc.args, prest) == (jc.kind, jc.key, jc.args, jrest)
        assert pc.as_parfile_tokens() == jc.as_parfile_tokens()
        got, want = pc.select(toas), jc.select(toas)
        assert got.dtype == bool and np.array_equal(got, want), tokens
    assert MaskClause("all").select(toas).all() and JaxClause("all").select(toas).all()

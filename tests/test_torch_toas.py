"""The port's own TOA prepare against pint_tpu's host numpy prepare
(``PINT_TPU_NBODY=0``, the analytic ephemeris; on the CPU pint_tpu's device
prepare is off): .tim parsing, the time scales, the clock chain, the
prepared columns of ``get_TOAs`` + ``TimingModel.build_tensor``, and the
flagship GLS fit from ``get_model_and_toas``.

Bounds: parsed lines, time scales and clock corrections bitwise; the
prepared tensor of a 1,024-TOA flagship-shaped .tim written by pint_tpu:
``t`` (hi + lo) within 1 ps, ``ssb_obs_pos_ls`` and ``obs_sun_pos_ls``
within 1 mm / c, ``error_s`` and ``freq_mhz`` bitwise, the mask and ECORR
columns exact; the DownhillGLSFitter fit from each package's own prepare
(pint_tpu eager, ``jax.disable_jit``, ROADMAP C1): parameters within 1e-6
of their uncertainty, uncertainties within 1e-10 relative.

pint_tpu caches prepared TOAs under ``PINT_TPU_CACHE_DIR``; the tests point
it at a temporary directory, so that nothing outside them is read or
written (pint_tpu also searches its clock-repository cache there).
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_fixture import flagship_dataset

START = {"F0": 2e-10, "DM": 1e-3, "EPS1": 1e-7}
C_M_PER_S = 299792458.0


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("PINT_TPU_NBODY", "0")
    for k in ("PINT_TPU_EPHEM", "PINT_TPU_EOP", "PINT_CLOCK_OVERRIDE", "PINT_TPU_CLOCK_REPO",
              "TEMPO", "TEMPO2", "PINT_TPU_KERNEL_EPHEM"):
        monkeypatch.delenv(k, raising=False)


# --- .tim parsing ------------------------------------------------------------------


def _princeton(rng, code: str) -> str:
    mjd = f"{rng.integers(50000, 60000)}.{rng.integers(0, 10**13):013d}"
    freq, err = rng.uniform(400, 3000), rng.uniform(0.1, 9)
    return f"{code}{'J1234+5678':<13s} {freq:9.3f}{mjd:>20s}{err:9.2f}"


def _parkes(rng) -> str:
    line = [" "] * 80
    for start, text in ((1, "J1909 X"), (25, f"{rng.uniform(400, 3000):9.3f}"),
                        (34, f"{rng.integers(50000, 60000)}.{rng.integers(0, 10**14):014d}"),
                        (63, f"{rng.uniform(0.1, 9):8.3f}"), (79, "7")):
        line[start:start + len(text)] = list(text)
    return "".join(line)


def _tempo2(rng, i: int) -> str:
    mjd = f"{rng.integers(50000, 60000)}.{rng.integers(0, 10**16):016d}"
    return (f"t2_{i} {rng.uniform(400, 3000):.6f} {mjd} {rng.uniform(0.1, 9):.3f} gbt "
            f"-fe {rng.choice(['L-wide', 'S-wide'])} -be GUPPI")


def write_mixed_tim(tmp_path, seed: int = 21):
    """A main .tim of comments, Princeton and Parkes lines, TIME and EFAC
    commands and an INCLUDE of a FORMAT 1 file with JUMP pairs and one
    malformed line."""
    rng = np.random.default_rng(seed)
    inc = ["FORMAT 1", "# tempo2 block"] + [_tempo2(rng, i) for i in range(6)]
    inc += ["JUMP"] + [_tempo2(rng, i) for i in range(6, 9)] + ["JUMP", "this line is malformed"]
    inc += [_tempo2(rng, i) for i in range(9, 12)]
    (tmp_path / "inc.tim").write_text("\n".join(inc) + "\n")
    main = ["C a comment", "# another"] + [_princeton(rng, c) for c in "13a"]
    main += [_parkes(rng) for _ in range(3)]
    main += ["TIME 1.25", _princeton(rng, "1"), "EFAC 1.5", _princeton(rng, "8"),
             "INCLUDE inc.tim", "TIME -1.25", "EFAC 1", _princeton(rng, "3")]
    (tmp_path / "main.tim").write_text("\n".join(main) + "\n")
    return tmp_path / "main.tim"


def test_parse_tim_matches_pint_tpu(tmp_path, caplog):
    from pint_tpu.io.tim import parse_tim as jax_parse
    from pint_tpu_torch.io.tim import parse_tim

    path = str(write_mixed_tim(tmp_path))
    want, got = jax_parse(path), parse_tim(path)
    assert [vars(t) for t in got.toas] == [vars(t) for t in want.toas]
    assert got.commands == want.commands
    assert len(got.toas) == 21  # the malformed line is skipped, with a warning
    assert {t.format for t in got.toas} == {"Princeton", "Parkes", "Tempo2"}
    assert any("unparseable" in r.message for r in caplog.records)


def test_write_tim_round_trips(tmp_path):
    from pint_tpu_torch.io.tim import parse_tim, write_tim

    # a name with a blank (the Parkes lines') does not survive a Tempo2 line
    lines = [t for t in parse_tim(str(write_mixed_tim(tmp_path))).toas if " " not in t.name]
    write_tim(lines, str(tmp_path / "out.tim"))
    back = parse_tim(str(tmp_path / "out.tim")).toas
    assert len(back) == len(lines) == 18
    for a, b in zip(lines, back):
        assert (a.mjd_day, a.obs, a.flags) == (b.mjd_day, b.obs, b.flags)
        assert abs((a.mjd_frac_hi - b.mjd_frac_hi) + (a.mjd_frac_lo - b.mjd_frac_lo)) <= 1e-16


# --- time scales and clocks ----------------------------------------------------------


def test_time_scales_match_pint_tpu_bitwise():
    from pint_tpu.astro import time as jtime
    from pint_tpu_torch.astro import time as ptime

    rng = np.random.default_rng(4)
    n = 5000
    day = rng.integers(41000, 64000, n)
    hi = rng.uniform(0, 1, n)
    lo = rng.uniform(-1, 1, n) * 1e-17
    topo = rng.uniform(-2e-6, 2e-6, n)
    for a, b in ((jtime.MJDEpoch(day, hi, lo), ptime.MJDEpoch(day, hi, lo)),):
        ta, tb = jtime.pulsar_mjd_utc_to_tt(a), ptime.pulsar_mjd_utc_to_tt(b)
        for x, y in ((ta, tb), (jtime.tt_to_tdb(ta, topo), ptime.tt_to_tdb(tb, topo))):
            for f in ("day", "frac_hi", "frac_lo"):
                assert np.array_equal(getattr(x, f), getattr(y, f)), f
        assert all(np.array_equal(u, v) for u, v in zip(ta.seconds_since(55000),
                                                         tb.seconds_since(55000)))


def test_clock_chain_matches_pint_tpu(tmp_path, monkeypatch):
    from pint_tpu.astro import clock as jclock
    from pint_tpu_torch.astro import clock as pclock

    d = tmp_path / "clk"
    d.mkdir()
    rng = np.random.default_rng(9)
    m = np.sort(rng.uniform(50000, 60000, 40))
    (d / "gbt2gps.clk").write_text("# UTC(GBT) UTC(GPS)\n" + "".join(
        f"{a:.5f} {c:.12e}\n" for a, c in zip(m, rng.uniform(-2e-6, 2e-6, 40))))
    (d / "gps2utc.clk").write_text("# UTC(GPS) UTC\n" + "".join(
        f"{a:.5f} {c:.12e}  # row\n" for a, c in zip(m, rng.uniform(-1e-8, 1e-8, 40))))
    (d / "time_ao.dat").write_text("".join(
        f"{a:10.2f}{c:14.3f}{0.0:12.3f}  3\n" for a, c in zip(m, rng.uniform(-3, 3, 40))))
    monkeypatch.setenv("PINT_CLOCK_OVERRIDE", str(d))
    mjd = rng.uniform(50100, 59900, 500)
    # tempo2 files, a tempo file, a site with no file of its own (GPS only)
    for site, gps in (("gbt", True), ("ao", True), ("ao", False), ("parkes", True),
                      ("parkes", False)):
        want = jclock.get_clock_chain(site, include_gps=gps).evaluate(mjd)
        got = pclock.get_clock_chain(site, include_gps=gps).evaluate(mjd)
        assert np.array_equal(got, want), site
    assert np.any(pclock.get_clock_chain("gbt").evaluate(mjd) != 0)
    assert not np.any(pclock.get_clock_chain("parkes", include_gps=False).evaluate(mjd))
    monkeypatch.delenv("PINT_CLOCK_OVERRIDE")  # no file at all: zeros in both
    assert not np.any(jclock.get_clock_chain("gbt").evaluate(mjd))
    assert not np.any(pclock.get_clock_chain("gbt").evaluate(mjd))
    monkeypatch.setenv("PINT_TPU_CLOCK_REPO", str(d))
    with pytest.raises(NotImplementedError, match="A17"):
        pclock.get_clock_chain("gbt")


# --- the prepared tensor and the fit -----------------------------------------------------


@pytest.fixture(scope="module")
def flagship_files(tmp_path_factory):
    """(par, tim) of a 1,024-TOA flagship dataset written by pint_tpu."""
    from pint_tpu_torch.profiles import FLAGSHIP_SMOKE_PAR

    d = tmp_path_factory.mktemp("flagship")
    _, toas, _ = flagship_dataset(1024)
    toas.write_tim(str(d / "f1024.tim"))
    (d / "f.par").write_text(FLAGSHIP_SMOKE_PAR)
    return str(d / "f.par"), str(d / "f1024.tim")


def prepared_pair(par, tim):
    """(pint_tpu model, tensor, port model, TOAs, tensor) of `par`, `tim`."""
    from pint_tpu.models.builder import get_model_and_toas as jax_gmt
    from pint_tpu_torch.models import get_model_and_toas

    jm, jt = jax_gmt(par, tim)
    jtens = jm.build_tensor(jt)
    pm, pt = get_model_and_toas(par, tim, device="cpu")
    return jm, jtens, pm, pt, pm.build_tensor(pt)


def test_prepared_tensor_matches_pint_tpu(flagship_files):
    jm, want, pm, toas, got = prepared_pair(*flagship_files)
    assert toas.ephem == "analytic" and len(toas) == 1024
    assert set(toas.stage_s) == {"parse", "clock", "tdb", "eop", "geometry", "ephemeris"}
    assert set(got) == set(want) - {"t_q0", "t_q1", "t_q2", "t_q3"}
    assert all(v.dtype == torch.float64 for v in got.values())
    dt = (got["t_hi"].numpy() - np.asarray(want["t_hi"])) \
        + (got["t_lo"].numpy() - np.asarray(want["t_lo"]))
    assert np.max(np.abs(dt)) <= 1e-12
    for k in ("ssb_obs_pos_ls", "obs_sun_pos_ls"):
        assert np.max(np.abs(got[k].numpy() - np.asarray(want[k]))) <= 1e-3 / C_M_PER_S, k
    assert np.max(np.abs(got["ssb_obs_vel_ls"].numpy() - np.asarray(want["ssb_obs_vel_ls"]))) \
        <= 1e-4 / C_M_PER_S
    for k in got:
        if k in ("error_s", "freq_mhz") or k.startswith(("mask_", "ecorr_")):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert got["ecorr_widx"].shape == (1, 128) and got["mask_EFAC1"][-1] == 0


def test_flagship_fit_from_tim_matches_pint_tpu(flagship_files):
    from pint_tpu.fitting import DownhillGLSFitter as JaxFitter
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu_torch.fitting import DownhillGLSFitter
    from pint_tpu_torch.fitting.wls import apply_delta

    jm, jtens, pm, toas, tens = prepared_pair(*flagship_files)
    free = tuple(jm.free_params)
    assert free == tuple(pm.free_params) and len(free) == 14
    delta = np.array([START.get(n, 0.0) for n in free])
    jm.params = jax_apply(jm.params, free, delta)
    pm.params = apply_delta(pm.params, free, torch.tensor(delta))
    from pint_tpu.models.builder import get_model_and_toas as jax_gmt

    _, jtoas = jax_gmt(*flagship_files)
    want = JaxFitter(jtoas, jm)
    with jax.disable_jit():
        want.fit_toas()
    got = DownhillGLSFitter(toas, pm)  # the TOAs object: the fitter builds the tensor
    got.fit_toas()
    rw, rg = want.result, got.result
    assert rg.converged and rw.converged and rg.iterations == rw.iterations >= 2
    for n in free:
        a = float(jm.params[n].hi) + float(jm.params[n].lo) if hasattr(jm.params[n], "hi") \
            else float(jm.params[n])
        v = pm.params[n]
        b = float(v.hi) + float(v.lo) if hasattr(v, "hi") else float(v)
        assert abs(b - a) <= 1e-6 * rw.uncertainties[n], n
        assert abs(rg.uncertainties[n] - rw.uncertainties[n]) <= 1e-10 * rw.uncertainties[n], n


def test_prepare_refuses_what_is_not_ported(tmp_path):
    from pint_tpu_torch.io.tim import TOALine
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toas import prepare_TOAs

    line = TOALine("x", 1400.0, 57000, 0.25, 0.0, 1.0, "stl_geo", {"telx": "1"})
    with pytest.raises(NotImplementedError, match="A9"):
        prepare_TOAs([line], device="cpu")
    # wideband TOAs are ported: the tensor carries their DM measurements; a
    # -pp_dm without its -pp_dme is refused
    wb = TOALine("x", 1400.0, 57000, 0.25, 0.0, 1.0, "gbt", {"pp_dm": "10", "pp_dme": "1"})
    toas = prepare_TOAs([wb], device="cpu")
    model = get_model("PSR X\nF0 100 1\nPEPOCH 57000\n", from_text=True, device="cpu")
    tensor = model.build_tensor(toas)
    assert tensor["wb_dm"].tolist() == [10.0] and tensor["wb_dme"].tolist() == [1.0]
    bad = TOALine("x", 1400.0, 57000, 0.25, 0.0, 1.0, "gbt", {"pp_dm": "10"})
    with pytest.raises(ValueError, match="-pp_dm without -pp_dme"):
        model.build_tensor(prepare_TOAs([bad], device="cpu"))
    with pytest.raises(ValueError, match="no TOAs"):
        prepare_TOAs([], device="cpu")
    with pytest.raises(KeyError, match="unknown observatory"):
        prepare_TOAs([TOALine("x", 1400.0, 57000, 0.25, 0.0, 1.0, "nowhere")], device="cpu")


def test_nbody_window_build_failure_raises(flagship_files, monkeypatch):
    """pint_tpu's default engages the N-body window, and so does the port's
    get_TOAs: a window that cannot be built is refused (the error reaches the
    caller) rather than served by the analytic series."""
    from pint_tpu_torch.astro import nbody
    from pint_tpu_torch.toas import get_TOAs

    def refused(self, refine_iters):
        raise RuntimeError("window build refused")

    monkeypatch.delenv("PINT_TPU_NBODY")
    monkeypatch.setattr(nbody.NBodyEphemeris, "_load_cached", lambda self, n: False)
    monkeypatch.setattr(nbody.NBodyEphemeris, "_build", refused)
    with pytest.raises(RuntimeError, match="window build refused"):
        get_TOAs(flagship_files[1], device="cpu")
    assert os.environ.get("PINT_TPU_NBODY") is None

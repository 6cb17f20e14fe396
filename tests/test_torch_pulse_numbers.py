"""Pulse-number offsets and tracking (ROADMAP C11): a .tim with a PHASE
command, -padd, -phase and -pn flags, written here from SMOKE_PAR fake TOAs
at gbt, through the port (``toas.TOAs.get_pulse_numbers``, the tensor's
``delta_pn`` and ``track_pn``, K1's twin, ``Residuals(track_mode=)``)
against pint_tpu on the same file.

Bounds: time residuals within 1 ps, pulse numbers equal, under both
``nearest`` and ``TRACK -2``; a WLS fit under ``TRACK -2`` within 1e-10
relative (parameters and uncertainties); fits handed residuals whose
``track_mode`` overrides the par's keep it, post-fit residuals within 1 ps;
the error of ``TRACK -2`` without -pn flags equal to pint_tpu's.
"""

import jax
import numpy as np
import pytest
import torch

N_TOAS = 48


@pytest.fixture(scope="module", autouse=True)
def isolated(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PINT_TPU_CACHE_DIR", str(tmp_path_factory.mktemp("cache")))
        mp.setenv("PINT_TPU_NBODY", "0")
        for k in ("PINT_TPU_EPHEM", "PINT_TPU_EOP", "PINT_CLOCK_OVERRIDE", "PINT_TPU_CLOCK_REPO",
                  "TEMPO", "TEMPO2", "PINT_TPU_KERNEL_EPHEM"):
            mp.delenv(k, raising=False)
        yield


def smoke_par(track: bool) -> str:
    from pint_tpu_torch.profiles import SMOKE_PAR

    return SMOKE_PAR + ("TRACK -2\n" if track else "")


@pytest.fixture(scope="module")
def fake_lines(tmp_path_factory):
    """(TOA lines of a written .tim, pint_tpu's nearest pulse numbers of
    them): SMOKE_PAR fake TOAs at gbt over two years, 1 us white noise."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(61)
    model = build_model(parse_parfile(smoke_par(False), from_text=True))
    mjds = np.sort(rng.uniform(54700.0, 55400.0, N_TOAS))
    freqs = np.where(np.arange(N_TOAS) % 2, 1400.0, 2300.0)
    toas = make_fake_toas_fromMJDs(mjds, model, obs="gbt", freq_mhz=freqs, error_us=1.0,
                                   add_noise=True, rng=rng)
    path = tmp_path_factory.mktemp("tim") / "fake.tim"
    toas.write_tim(str(path))
    lines = path.read_text().splitlines()
    head = [ln for ln in lines if not ln.startswith("fake_")]
    body = [ln for ln in lines if ln.startswith("fake_")]
    assert len(body) == N_TOAS
    pn = np.asarray(JaxResiduals(toas, model).pulse_numbers)
    return head, body, pn


def write_tim(path, fake_lines, flags=None, phase_blocks=(), pn_shift=None, with_pn=True):
    """A .tim of the fake lines with extra flags per TOA ({index: "-flag v
    ..."}), PHASE commands ((first, last, turns): PHASE turns before TOA
    `first`, PHASE -turns after TOA `last`) and -pn flags: pint_tpu's
    nearest pulse numbers plus `pn_shift` (N,) turns."""
    head, body, pn = fake_lines
    flags = flags or {}
    shift = np.zeros(N_TOAS) if pn_shift is None else pn_shift
    out = list(head)
    for i, line in enumerate(body):
        for first, last, turns in phase_blocks:
            if i == first:
                out.append(f"PHASE {turns!r}")
        extra = flags.get(i, "")
        if with_pn:
            extra += f" -pn {int(pn[i] + shift[i])}"
        out.append(line + (" " + extra.strip() if extra.strip() else ""))
        for first, last, turns in phase_blocks:
            if i == last:
                out.append(f"PHASE {-turns!r}")
    path.write_text("\n".join(out) + "\n")
    return path


def both(path, track: bool):
    """(pint_tpu model, TOAs; port model, TOAs) of SMOKE_PAR (with TRACK -2
    when `track`) and the .tim at `path`."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu.toas import get_TOAs
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toas import get_TOAs as port_get_TOAs

    jm = build_model(parse_parfile(smoke_par(track), from_text=True))
    jt = get_TOAs(str(path), model=jm)
    tm = get_model(smoke_par(track), from_text=True, device="cpu")
    tt = port_get_TOAs(str(path), model=tm, device="cpu")
    return jm, jt, tm, tt


def offsets_tim(tmp_path, fake_lines):
    """PHASE 0.5 over TOAs 8-15, -padd 0.25 on 20-25, -phase -0.125 on 30-35
    (-padd and -phase together on 24-25), -pn everywhere, one turn off
    pint_tpu's nearest on 40-43."""
    flags = {i: "-padd 0.25" for i in range(20, 26)}
    for i in range(30, 36):
        flags[i] = "-phase -0.125"
    flags[24] += " -phase 0.0625"
    flags[25] += " -phase -0.375"
    shift = np.zeros(N_TOAS)
    shift[40:44] = 1.0
    return write_tim(tmp_path / "offsets.tim", fake_lines, flags, ((8, 15, 0.5),), shift)


def compare(jr, pr, n_tagged=None):
    """Port residuals `pr` against pint_tpu's `jr`: time within 1 ps, phase
    within 1 ps of turns at F0, pulse numbers equal."""
    jt = np.asarray(jr.time_resids)
    pt = pr.time_resids.numpy()
    assert np.max(np.abs(pt - jt)) <= 1e-12
    f0 = 173.6879489990983
    assert np.max(np.abs(pr.phase_resids.numpy() - np.asarray(jr.phase_resids))) <= 1e-12 * f0
    np.testing.assert_array_equal(pr.pulse_numbers.numpy(), np.asarray(jr.pulse_numbers))


@pytest.mark.parametrize("track", [False, True], ids=["nearest", "track-2"])
def test_offsets_and_tracking_match_pint_tpu(tmp_path, fake_lines, track):
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu_torch.residuals import Residuals

    jm, jt, tm, tt = both(offsets_tim(tmp_path, fake_lines), track)
    jr, pr = JaxResiduals(jt, jm), Residuals(tt, tm)
    assert jr.track_mode == pr.track_mode == ("use_pulse_numbers" if track else "nearest")
    compare(jr, pr)
    dpn = pr.tensor["delta_pn"][:-1].numpy()
    np.testing.assert_array_equal(dpn, np.asarray(jt.tensor().delta_pulse_number))
    assert pr.tensor["delta_pn"][-1] == 0.0  # the TZR row takes no offset
    assert ("track_pn" in pr.tensor) == track
    pn = pr.pulse_numbers.numpy()
    if track:  # the tracked pulse numbers are the -pn flags themselves
        np.testing.assert_array_equal(pn, jt.get_pulse_numbers())
        # one turn more pulses on 40-43: their residuals are one turn less
        rp = pr.phase_resids.numpy()
        assert np.all(np.abs(rp[40:44] - np.median(rp[44:]) + 1.0) < 0.01)


def test_explicit_track_modes_match_pint_tpu(tmp_path, fake_lines):
    """Residuals(track_mode=) overrides the par's TRACK either way."""
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu_torch.residuals import Residuals

    path = offsets_tim(tmp_path, fake_lines)
    jm, jt, tm, tt = both(path, track=False)
    compare(JaxResiduals(jt, jm, track_mode="use_pulse_numbers"),
            Residuals(tt, tm, track_mode="use_pulse_numbers"))
    jm, jt, tm, tt = both(path, track=True)
    pr = Residuals(tt, tm, track_mode="nearest")
    assert "track_pn" not in pr.tensor
    compare(JaxResiduals(jt, jm, track_mode="nearest"), pr)


def test_quarter_turn_padd_regression(tmp_path, fake_lines):
    """12 TOAs, 6 of them with -padd 0.25: pint_tpu's phase residuals move
    by a quarter turn (mod 1) on those 6; the port's now move with them."""
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu_torch.residuals import Residuals

    head, body, pn = fake_lines
    short = (head, body[:12], pn[:12])
    plain = write_tim(tmp_path / "plain.tim", short, with_pn=False)
    padd = write_tim(tmp_path / "padd.tim", short, {i: "-padd 0.25" for i in range(0, 12, 2)},
                     with_pn=False)
    jm, jt, tm, tt = both(padd, track=False)
    jr, pr = JaxResiduals(jt, jm, subtract_mean=False), Residuals(tt, tm, subtract_mean=False)
    compare(jr, pr)
    _, _, tm0, tt0 = both(plain, track=False)
    moved = pr.phase_resids.numpy() - Residuals(tt0, tm0, subtract_mean=False).phase_resids.numpy()
    moved = moved - np.round(moved)
    np.testing.assert_allclose(moved[0::2], 0.25, atol=1e-9)
    np.testing.assert_allclose(moved[1::2], 0.0, atol=1e-9)


def test_track_without_pulse_numbers_raises_as_pint_tpu(tmp_path, fake_lines):
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu_torch.fitting import DownhillWLSFitter
    from pint_tpu_torch.residuals import Residuals

    path = write_tim(tmp_path / "nopn.tim", fake_lines, {3: "-padd 0.5"}, with_pn=False)
    jm, jt, tm, tt = both(path, track=True)
    with pytest.raises(ValueError) as want:
        JaxResiduals(jt, jm)
    with pytest.raises(ValueError) as got:
        Residuals(tt, tm)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=str(want.value)):
        DownhillWLSFitter(tt, tm)
    assert "track_pn" not in tm.build_tensor(tt)


def fit_tim(tmp_path, fake_lines):
    """Whole-turn offsets (PHASE 1 over TOAs 34-39, -padd 2 on 10-19,
    -phase -1 on 25-29) and -pn flags that follow them."""
    flags = {i: "-padd 2" for i in range(10, 20)}
    flags.update({i: "-phase -1" for i in range(25, 30)})
    shift = np.zeros(N_TOAS)
    shift[10:20] += 2.0
    shift[25:30] -= 1.0
    shift[34:40] += 1.0
    return write_tim(tmp_path / "fit.tim", fake_lines, flags, ((34, 39, 1.0),), shift)


def fit_both(path, track: bool, track_mode=None):
    """Downhill WLS fits of pint_tpu (eager, ROADMAP C1) and the port from
    a moved start (F0 +2e-10 Hz, DM +1e-3), each handed residuals in
    `track_mode` when one is given: (pint_tpu model, fitter, result; port
    model, fitter, result)."""
    from pint_tpu.fitting import DownhillWLSFitter as JaxFitter
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu.residuals import Residuals as JaxResiduals
    from pint_tpu_torch.fitting import DownhillWLSFitter
    from pint_tpu_torch.fitting.wls import apply_delta
    from pint_tpu_torch.residuals import Residuals

    jm, jt, tm, tt = both(path, track)
    free = tuple(jm.free_params)
    delta = np.array([{"F0": 2e-10, "DM": 1e-3}.get(n, 0.0) for n in free])
    jm.params = jax_apply(jm.params, free, delta)
    tm.params = apply_delta(tm.params, free, torch.tensor(delta, dtype=torch.float64))
    with jax.disable_jit():
        jr = None if track_mode is None else JaxResiduals(jt, jm, track_mode=track_mode)
        want = JaxFitter(jt, jm, residuals=jr)
        rw = want.fit_toas()
    pr = None if track_mode is None else Residuals(tt, tm, track_mode=track_mode)
    got = DownhillWLSFitter(tt, tm, residuals=pr)
    rg = got.fit_toas()
    return jm, want, rw, tm, got, rg


@pytest.mark.parametrize("track,mode", [(True, "nearest"), (False, "use_pulse_numbers")],
                         ids=["track-2-par-nearest", "plain-par-use-pulse-numbers"])
def test_fit_keeps_the_residuals_track_mode(tmp_path, fake_lines, track, mode):
    """A fitter handed residuals whose track_mode overrides the par's TRACK
    keeps that mode in its steps and in its post-fit residuals, as
    pint_tpu's does: post-fit residuals within 1 ps, pulse numbers equal."""
    jm, want, rw, tm, got, rg = fit_both(fit_tim(tmp_path, fake_lines), track, mode)
    assert rg.converged and rw.converged and rg.iterations == rw.iterations
    assert want.resids.track_mode == got.resids.track_mode == mode
    assert ("track_pn" in got.tensor) == ("track_pn" in got.resids.tensor) == (not track)
    compare(want.resids, got.resids)


def test_tracked_wls_fit_matches_pint_tpu(tmp_path, fake_lines):
    """A downhill WLS fit under TRACK -2 from a moved start over a .tim with
    whole-turn offsets and -pn flags that follow them: parameters and
    uncertainties within 1e-10 relative of pint_tpu's."""
    jm, want, rw, tm, got, rg = fit_both(fit_tim(tmp_path, fake_lines), track=True)
    free = tuple(jm.free_params)
    assert rg.converged and rw.converged and rg.iterations == rw.iterations
    assert 0.5 <= rg.chi2 / rg.dof <= 2.0
    assert "track_pn" in got.tensor and "delta_pn" in got.tensor
    assert got.resids.track_mode == "use_pulse_numbers"
    compare(want.resids, got.resids)
    for n in free:
        a = float(jm.params[n].hi) + float(jm.params[n].lo) if hasattr(jm.params[n], "hi") \
            else float(jm.params[n])
        v = tm.params[n]
        b = float(v.hi) + float(v.lo) if hasattr(v, "hi") else float(v)
        assert abs(b - a) <= 1e-10 * abs(a), n
        ua, ub = rw.uncertainties[n], rg.uncertainties[n]
        assert abs(ub - ua) <= 1e-10 * ua, n

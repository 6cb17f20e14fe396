"""TOA loading and preparation (counterpart of ``pint_tpu/toas.py``): .tim
-> clock chain -> TT -> site geometry (K4) -> ephemeris (the N-body window
K6 by default, a Chebyshev pack K7, or the analytic series K5) -> TDB, the
host ``TOAs`` container, and ``TOAs.tensor`` for ``TimingModel.build_tensor``.

The host steps are numpy, as in pint_tpu, with the same arithmetic: times
ride as ``MJDEpoch`` (integer day + two-float64 fraction) and the tensor's
TDB is double-double seconds since MJD 55000. The two device programs run
as kernels on the card (``astro/device_prepare.py``), or as their plain
twins when the caller asks for the CPU; every entry point takes ``device=``
and runs on CUDA by default.

``prepare_arrays`` records the host wall seconds of its stages (``clock``,
``tdb``, ``eop``, ``geometry``, ``ephemeris``, and ``nbody_build`` or
``kernel_build`` when the ephemeris builds its window or pack there;
``get_TOAs`` adds ``parse``) in ``TOAs.stage_s``; each stage that runs a
kernel ends with its result copied to the host, so the walls include the
kernels. ``TOAs.ephem`` names the ephemeris source, as pint_tpu's does.

pint_tpu's prepared-TOA caches (the tim pickle, the content and prefix
caches) are not on the compute path and are not ported (ROADMAP A17).
"""

from __future__ import annotations

import re
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from pint_tpu_torch import C_M_PER_S, TENSOR_EPOCH_MJD
from pint_tpu_torch.astro import clock as clockmod
from pint_tpu_torch.astro import ephemeris
from pint_tpu_torch.astro import time as ptime
from pint_tpu_torch.astro.eop import get_eop
from pint_tpu_torch.astro.observatories import get_observatory
from pint_tpu_torch.device import resolve_device
from pint_tpu_torch.io.tim import TOALine, parse_tim

PLANETS = ("jupiter", "saturn", "venus", "uranus", "neptune")

_FLAG_KEY_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_+-]*$")
_FLAG_WS = re.compile(r"\s")


def validate_flags(flags: list[dict]) -> list[dict]:
    """Flag keys are bare identifiers, values whitespace-free strings
    (non-strings are coerced), as pint_tpu requires."""
    for f in flags:
        for k, v in f.items():
            if not isinstance(k, str) or not _FLAG_KEY_OK.match(k):
                raise ValueError(
                    f"invalid TOA flag name {k!r}: flag names are bare identifiers "
                    "(store '-fe L-wide' as {'fe': 'L-wide'})")
            if type(v) is not str:
                f[k] = v = str(v)
            if _FLAG_WS.search(v):
                raise ValueError(f"invalid value {v!r} for TOA flag -{k}: flag values "
                                 "cannot contain whitespace")
    return flags


@dataclass
class TOATensor:
    """Per-row host arrays of the tensor; `t_hi + t_lo` is TDB seconds since
    TENSOR_EPOCH_MJD, positions are light-seconds with ICRS axes."""

    t_hi: np.ndarray
    t_lo: np.ndarray
    error_s: np.ndarray
    freq_mhz: np.ndarray
    ssb_obs_pos_ls: np.ndarray
    ssb_obs_vel_ls: np.ndarray
    obs_sun_pos_ls: np.ndarray
    planet_pos_ls: dict[str, np.ndarray] = field(default_factory=dict)
    #: the -padd (the .tim PHASE command) plus -phase flags, turns; None
    #: when every row's sum is zero
    delta_pulse_number: np.ndarray | None = None


@dataclass
class TOAs:
    """Host TOA container, numpy-backed; flags stay on the host and become
    mask columns in ``TimingModel.build_tensor``."""

    utc: ptime.MJDEpoch  # clock-corrected UTC
    tdb: ptime.MJDEpoch
    error_us: np.ndarray
    freq_mhz: np.ndarray
    obs: np.ndarray  # observatory names (str)
    flags: list[dict[str, str]]
    ssb_obs_pos_m: np.ndarray
    ssb_obs_vel_m_s: np.ndarray
    obs_sun_pos_m: np.ndarray
    planet_pos_m: dict[str, np.ndarray] = field(default_factory=dict)
    ephem: str = "analytic"
    planets: bool = False
    utc_raw: ptime.MJDEpoch | None = None  # site-arrival UTC, before the clock chain
    #: host wall seconds of the prepare's stages
    stage_s: dict[str, float] = field(default_factory=dict)
    #: the clock-chain settings of the prepare (simulation re-prepares with them)
    include_gps: bool = True
    include_bipm: bool = False
    bipm_version: str = "BIPM2019"
    #: accumulated |time shift| (s) since the geometry columns were computed
    #: (``simulation._reprepare``'s fast path)
    geom_stale_s: float = 0.0

    def __len__(self):
        return len(self.error_us)

    @property
    def is_wideband(self) -> bool:
        """True when any TOA carries a -pp_dm wideband DM measurement."""
        return any("pp_dm" in f for f in self.flags)

    def get_wideband_dm(self) -> tuple[np.ndarray | None, np.ndarray | None]:
        """(dm [pc cm^-3], dm error) per TOA from the -pp_dm/-pp_dme flags.
        A row without a measurement gets dm 0 and an infinite error (zero
        weight); (None, None) when no TOA has one. A row with one flag of the
        pair and not the other raises."""
        n = len(self.flags)
        dm = np.zeros(n)
        dme = np.full(n, np.inf)
        has_dm = np.zeros(n, bool)
        has_dme = np.zeros(n, bool)
        for i, f in enumerate(self.flags):
            v = f.get("pp_dm")
            if v is not None:
                dm[i] = float(v)
                has_dm[i] = True
            e = f.get("pp_dme")
            if e is not None:
                dme[i] = float(e)
                has_dme[i] = True
        if not has_dm.any():
            return None, None
        for a, b, bad in (("pp_dm", "pp_dme", has_dm & ~has_dme),
                          ("pp_dme", "pp_dm", has_dme & ~has_dm)):
            if bad.any():
                raise ValueError(
                    f"{int(bad.sum())} TOAs carry -{a} without -{b} (first at index "
                    f"{int(np.flatnonzero(bad)[0])}); wideband DM measurements need both")
        return dm, dme

    def get_pulse_numbers(self) -> np.ndarray | None:
        """The -pn flag of every row as float64 (NaN where a row has none);
        None when no row has one."""
        out = np.full(len(self.flags), np.nan)
        any_pn = False
        for i, f in enumerate(self.flags):
            p = f.get("pn")
            if p is not None:
                out[i] = float(p)
                any_pn = True
        return out if any_pn else None

    def tensor(self) -> TOATensor:
        t_hi, t_lo = self.tdb.seconds_since(TENSOR_EPOCH_MJD)
        # the pulse offsets: -padd (the PHASE command) plus -phase, per row
        dpn = np.zeros(len(self.flags))
        any_dpn = False
        for i, f in enumerate(self.flags):
            if "padd" in f or "phase" in f:
                dpn[i] = float(f.get("padd", 0.0)) + float(f.get("phase", 0.0))
                any_dpn = True
        return TOATensor(
            t_hi=t_hi,
            t_lo=t_lo,
            error_s=self.error_us * 1e-6,
            freq_mhz=self.freq_mhz,
            ssb_obs_pos_ls=self.ssb_obs_pos_m / C_M_PER_S,
            ssb_obs_vel_ls=self.ssb_obs_vel_m_s / C_M_PER_S,
            obs_sun_pos_ls=self.obs_sun_pos_m / C_M_PER_S,
            planet_pos_ls={k: v / C_M_PER_S for k, v in self.planet_pos_m.items()},
            delta_pulse_number=dpn if any_dpn and np.any(dpn) else None,
        )


def merge_TOAs(toas_list: Sequence[TOAs]) -> TOAs:
    """Concatenate prepared TOA sets; every prepared column is reused."""
    t0 = toas_list[0]
    for t in toas_list[1:]:
        if t.ephem != t0.ephem:
            raise ValueError(f"cannot merge TOAs with ephems {t0.ephem} vs {t.ephem}")
    cat = np.concatenate

    def _cat_ep(eps):
        if any(e is None for e in eps):
            return None
        return ptime.MJDEpoch(cat([e.day for e in eps]), cat([e.frac_hi for e in eps]),
                              cat([e.frac_lo for e in eps]))

    return TOAs(
        utc=_cat_ep([t.utc for t in toas_list]),
        tdb=_cat_ep([t.tdb for t in toas_list]),
        utc_raw=_cat_ep([t.utc_raw for t in toas_list]),
        error_us=cat([t.error_us for t in toas_list]),
        freq_mhz=cat([t.freq_mhz for t in toas_list]),
        obs=cat([t.obs for t in toas_list]),
        flags=sum((list(t.flags) for t in toas_list), []),
        ssb_obs_pos_m=cat([t.ssb_obs_pos_m for t in toas_list]),
        ssb_obs_vel_m_s=cat([t.ssb_obs_vel_m_s for t in toas_list]),
        obs_sun_pos_m=cat([t.obs_sun_pos_m for t in toas_list]),
        planet_pos_m={k: cat([t.planet_pos_m[k] for t in toas_list]) for k in t0.planet_pos_m},
        ephem=t0.ephem,
        planets=t0.planets,
    )


def get_TOAs(timfile: str, ephem: str = "auto", planets: bool = False, include_gps: bool = True,
             include_bipm: bool = False, bipm_version: str = "BIPM2019", model=None,
             device=None) -> TOAs:
    """Parse and prepare a .tim file on `device` (CUDA unless 'cpu').

    With `model`, its EPHEM, PLANET_SHAPIRO and CLK directives override the
    defaults as in pint_tpu: ``CLK TT(BIPMyyyy)`` turns on the TAI -> TT(BIPM)
    correction."""
    dev = resolve_device(device)
    if model is not None:
        ephem = model.meta.get("EPHEM") or ephem
        planets = planets or bool(model.meta.get("PLANET_SHAPIRO", False))
        clk = (model.meta.get("CLOCK") or "").upper().replace(" ", "")
        if clk.startswith("TT(BIPM"):
            include_bipm = True
            ver = clk[3:].strip("()")
            if ver != "BIPM":  # bare TT(BIPM) keeps the default version
                bipm_version = ver
    t0 = time.perf_counter()
    tf = parse_tim(timfile)
    parse_s = time.perf_counter() - t0
    toas = prepare_TOAs(tf.toas, ephem=ephem, planets=planets, include_gps=include_gps,
                        include_bipm=include_bipm, bipm_version=bipm_version, device=dev)
    toas.stage_s = {"parse": parse_s, **toas.stage_s}
    return toas


def prepare_TOAs(lines: list[TOALine], ephem: str = "auto", planets: bool = False,
                 include_gps: bool = True, include_bipm: bool = False,
                 bipm_version: str = "BIPM2019", device=None) -> TOAs:
    """Prepare parsed TOA lines on `device` (CUDA unless 'cpu')."""
    n = len(lines)
    if n == 0:
        raise ValueError("no TOAs to prepare")
    utc = ptime.MJDEpoch(
        np.array([t.mjd_day for t in lines], np.int64),
        np.array([t.mjd_frac_hi for t in lines]),
        np.array([t.mjd_frac_lo for t in lines]),
    )
    error_us = np.array([t.error_us for t in lines])
    freq = np.array([t.freq_mhz if t.freq_mhz > 0 else np.inf for t in lines])
    names = {o: get_observatory(o).name for o in {t.obs for t in lines}}
    obs_names = np.array([names[t.obs] for t in lines])
    flags = [dict(t.flags) for t in lines]
    return prepare_arrays(utc, error_us, freq, obs_names, flags, ephem=ephem,
                          planets=planets, include_gps=include_gps, include_bipm=include_bipm,
                          bipm_version=bipm_version, device=device)


def prepare_arrays(utc: ptime.MJDEpoch, error_us: np.ndarray, freq: np.ndarray,
                   obs_names: np.ndarray, flags: list[dict] | None = None, ephem: str = "auto",
                   planets: bool = False, include_gps: bool = True, include_bipm: bool = False,
                   bipm_version: str = "BIPM2019", device=None) -> TOAs:
    """Array-level TOA preparation, the core of `get_TOAs`: the same steps
    as pint_tpu's prepare_arrays, with the site geometry and the ephemeris
    on `device`."""
    dev = resolve_device(device)
    n = len(utc)
    flags = [{} for _ in range(n)] if flags is None else validate_flags(flags)
    stage_s: dict[str, float] = {}

    @contextmanager
    def stage(name):
        t0 = time.perf_counter()
        yield
        stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t0

    uniq_obs, obs_inv = np.unique(obs_names, return_inverse=True)
    uniq_ob = [get_observatory(str(u)) for u in uniq_obs]

    # 1. clock corrections per observatory group (site -> UTC)
    with stage("clock"):
        corr_s = np.zeros(n)
        utc_mjd_raw = utc.mjd_float()
        for j, ob in enumerate(uniq_ob):
            if ob.is_barycenter or ob.timescale != "utc":
                continue
            sel = obs_inv == j
            chain = clockmod.get_clock_chain(str(uniq_obs[j]), include_gps=include_gps,
                                             include_bipm=include_bipm,
                                             bipm_version=bipm_version)
            corr_s[sel] = chain.evaluate(utc_mjd_raw[sel])
        utc_corr = utc.add_seconds(corr_s)

    # 2. UTC -> TT; rows of a TT-timescale observatory already are TT
    with stage("tdb"):
        bary = np.array([ob.is_barycenter for ob in uniq_ob])[obs_inv]
        tt_scale = np.array([ob.timescale == "tt" for ob in uniq_ob])[obs_inv]
        tt = ptime.pulsar_mjd_utc_to_tt(utc_corr)
        if np.any(tt_scale):
            for dst, src in ((tt.day, utc_corr.day), (tt.frac_hi, utc_corr.frac_hi),
                             (tt.frac_lo, utc_corr.frac_lo)):
                dst[tt_scale] = src[tt_scale]
        tt_jcent = ptime.mjd_tt_julian_centuries(tt)

    # 3. UT1 and polar motion (zero without an IERS table), then the site's
    # GCRS posvel per observatory: K4
    with stage("eop"):
        utc_mjd = utc_corr.mjd_float()
        dut1_s, xp_rad, yp_rad = get_eop(utc_mjd)
        ut1_mjd = utc_mjd + dut1_s / 86400.0
    with stage("geometry"):
        site_pos = np.zeros((n, 3))
        site_vel = np.zeros((n, 3))
        for j, ob in enumerate(uniq_ob):
            sel = obs_inv == j
            if getattr(ob, "needs_flags", False):
                raise NotImplementedError(
                    f"observatory {ob.name!r} takes its position from per-TOA flags "
                    "(T2SpacecraftObs): not ported yet, ROADMAP A9")
            p, v = ob.site_posvel_gcrs(ut1_mjd[sel], tt_jcent[sel], xp_rad[sel], yp_rad[sel],
                                       dev)
            site_pos[sel] = p
            site_vel[sel] = v

    # 4. Earth, Sun (and planets) wrt the SSB at the geocentric TDB: the
    # N-body window (K6), a Chebyshev pack (K7) or the series (K5); a window
    # or pack built here is timed as its own stage, outside "ephemeris"
    built: dict[str, float] = {}
    with stage("ephemeris"), ephemeris.stage_sink(built):
        eph = ephemeris.get_ephemeris(ephem)
        tdb_geo = ptime.tt_to_tdb(tt)
        tdb_jcent = (tdb_geo.mjd_float() - ptime.MJD_J2000) / 36525.0
        bodies = ("earth", "sun") + (PLANETS if planets else ())
        served = eph.posvel_many(bodies, tdb_jcent, dev)
        earth_pos, earth_vel = served["earth"]
        sun_pos = served["sun"][0]
        ssb_obs_pos = earth_pos + site_pos
        ssb_obs_vel = earth_vel + site_vel
        ssb_obs_pos[bary] = 0.0  # barycentric TOAs: the observer is at the SSB
        ssb_obs_vel[bary] = 0.0
        obs_sun_pos = sun_pos - ssb_obs_pos
        planet_pos = {p: served[p][0] - ssb_obs_pos for p in PLANETS} if planets else {}
    stage_s.update(built)
    stage_s["ephemeris"] -= sum(built.values())

    # 5. TDB with the topocentric term
    with stage("tdb"):
        topo = ptime.topocentric_tdb_correction(earth_vel, site_pos)
        tdb = ptime.tt_to_tdb(tt, topo)
        if np.any(bary):  # barycentric TOAs are already TDB at the SSB
            for dst, src in ((tdb.day, utc.day), (tdb.frac_hi, utc.frac_hi),
                             (tdb.frac_lo, utc.frac_lo)):
                dst[bary] = src[bary]

    toas = TOAs(
        utc=utc_corr,
        tdb=tdb,
        error_us=error_us,
        freq_mhz=freq,
        obs=obs_names,
        flags=flags,
        ssb_obs_pos_m=ssb_obs_pos,
        ssb_obs_vel_m_s=ssb_obs_vel,
        obs_sun_pos_m=obs_sun_pos,
        planet_pos_m=planet_pos,
        ephem=eph.name,
        planets=planets,
        utc_raw=utc,
        stage_s=stage_s,
        include_gps=include_gps,
        include_bipm=include_bipm,
        bipm_version=bipm_version,
    )
    return toas


def make_tzr_toa(tzrmjd_day: int, tzrmjd_frac_hi: float, tzrmjd_frac_lo: float, tzrsite: str,
                 tzrfrq_mhz: float, ephem: str = "auto", planets: bool = False,
                 device=None) -> TOAs:
    """The single fiducial TZR TOA, through the same pipeline, so that its
    row can be appended to the tensor and folded into the same phase
    evaluation."""
    line = TOALine(name="TZR",
                   freq_mhz=tzrfrq_mhz if tzrfrq_mhz and np.isfinite(tzrfrq_mhz) else 0.0,
                   mjd_day=tzrmjd_day, mjd_frac_hi=tzrmjd_frac_hi, mjd_frac_lo=tzrmjd_frac_lo,
                   error_us=0.0, obs=tzrsite, flags={"tzr": "True"})
    return prepare_TOAs([line], ephem=ephem, planets=planets, device=device)

"""The built-in analytic solar-system ephemeris (counterpart of the analytic
part of ``pint_tpu/astro/ephemeris.py``): barycentric ICRS positions and
velocities of the Sun, Moon and planets.

- Earth, Venus, Jupiter, Saturn, Uranus, Neptune: truncated VSOP87D series
  (``astro/vsop87.py``, ``astro/vsop87_planets.py``), ecliptic of date,
  rotated to GCRS by the Fukushima-Williams bias-precession;
- Mercury, Mars and the EMB: JPL approximate Keplerian elements with a
  10-step Newton solve of Kepler's equation;
- the Moon: truncated Meeus/ELP series;
- the Sun: at the barycentric constraint sum(GM_i r_i) = 0;
- velocities: central differences over +-16 s.

`analytic_posvel` is the plain-torch twin of kernel K5
(``csrc/analytic_ephemeris.cu``, wrapped by ``device_prepare.analytic_posvel``):
the same formulas, on tensors. `pack_tables` packs every table the series
read into the one float64 tensor K5 receives, so the tables have one source
in the port.

`get_ephemeris` serves what pint_tpu serves under the same settings:

- by default the N-body window of ``astro/nbody.py`` (kernel K6), built on
  the host once per quantized window (`quantize_nbody_window`) and kept per
  instance; ``PINT_TPU_NBODY=0`` serves the analytic series (K5);
- ``PINT_TPU_KERNEL_EPHEM=1``: a Chebyshev pack snapshot of that path
  (``astro/kernel_ephemeris.py``, kernel K7);
- ``PINT_TPU_EPHEM=<SPK file>``: the kernel's records as a pack (K7), or
  with ``PINT_TPU_KERNEL_EPHEM=0`` the host reader ``astro/spk.py``.

pint_tpu falls back where a pack cannot be built or compiled (to the direct
path or the host reader), and to the analytic series when the SPK file is
missing or unreadable (a degradation-ledger event). The port raises in each
of those places, naming the cause.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from contextvars import ContextVar

import numpy as np
import torch

from pint_tpu_torch import AU_M, EARTH_MOON_MASS_RATIO, GM_BODY, GM_SUN, OBLIQUITY_J2000_ARCSEC
from pint_tpu_torch.astro import vsop87, vsop87_planets
from pint_tpu_torch.astro.erot import fdiv, fma, fukushima_williams, matmul3, pymod, rx, rz
from pint_tpu_torch.ops.libm import cos, sin

ARCSEC = np.pi / (180.0 * 3600.0)
DEG = np.pi / 180.0

# JPL approximate Keplerian elements, J2000 values + per-Julian-century rates
# (valid 1800-2050): a[AU], e, I[deg], L[deg], long.peri[deg], long.node[deg].
_ELEMENTS = {
    "mercury": (
        (0.38709927, 0.20563593, 7.00497902, 252.25032350, 77.45779628, 48.33076593),
        (0.00000037, 0.00001906, -0.00594749, 149472.67411175, 0.16047689, -0.12534081),
    ),
    "venus": (
        (0.72333566, 0.00677672, 3.39467605, 181.97909950, 131.60246718, 76.67984255),
        (0.00000390, -0.00004107, -0.00078890, 58517.81538729, 0.00268329, -0.27769418),
    ),
    "emb": (
        (1.00000261, 0.01671123, -0.00001531, 100.46457166, 102.93768193, 0.0),
        (0.00000562, -0.00004392, -0.01294668, 35999.37244981, 0.32327364, 0.0),
    ),
    "mars": (
        (1.52371034, 0.09339410, 1.84969142, -4.55343205, -23.94362959, 49.55953891),
        (0.00001847, 0.00007882, -0.00813131, 19140.30268499, 0.44441088, -0.29257343),
    ),
    "jupiter": (
        (5.20288700, 0.04838624, 1.30439695, 34.39644051, 14.72847983, 100.47390909),
        (-0.00011607, -0.00013253, -0.00183714, 3034.74612775, 0.21252668, 0.20469106),
    ),
    "saturn": (
        (9.53667594, 0.05386179, 2.48599187, 49.95424423, 92.59887831, 113.66242448),
        (-0.00125060, -0.00050991, 0.00193609, 1222.49362201, -0.41897216, -0.28867794),
    ),
    "uranus": (
        (19.18916464, 0.04725744, 0.77263783, 313.23810451, 170.95427630, 74.01692503),
        (-0.00196176, -0.00004397, -0.00242939, 428.48202785, 0.40805281, 0.04240589),
    ),
    "neptune": (
        (30.06992276, 0.00859048, 1.77004347, -55.12002969, 44.96476227, 131.78422574),
        (0.00026291, 0.00005105, 0.00035372, 218.45945325, -0.32241464, -0.00508664),
    ),
}

# rotation ecliptic-J2000 -> equatorial-J2000 (ICRS to within the ~mas frame bias)
_EPS0 = OBLIQUITY_J2000_ARCSEC * ARCSEC
ECL2EQU = np.array([
    [1.0, 0.0, 0.0],
    [0.0, np.cos(_EPS0), -np.sin(_EPS0)],
    [0.0, np.sin(_EPS0), np.cos(_EPS0)],
])

#: every body the ephemeris serves, in pint_tpu's order (K5's body codes)
BODIES = ("sun", "mercury", "venus", "earth", "moon", "mars", "jupiter", "saturn",
          "uranus", "neptune", "emb")
#: the series of K5's packed table, in its order
VSOP_BODIES = ("earth", "venus", "jupiter", "saturn", "uranus", "neptune")
KEPLER_BODIES = ("mercury", "emb", "mars")


def solve_kepler(M, e, iters: int = 10):
    """Newton iteration for the eccentric anomaly (fixed count)."""
    E = M + e * sin(M)
    for _ in range(iters):
        E = E - (E - e * sin(E) - M) / (1.0 - e * cos(E))
    return E


def helio_ecliptic(body: str, T):
    """Heliocentric ecliptic-J2000 position [AU], shape (N, 3), from the
    body's mean elements."""
    el0, rate = _ELEMENTS[body]
    a = el0[0] + rate[0] * T
    e = el0[1] + rate[1] * T
    inc = (el0[2] + rate[2] * T) * DEG
    L = (el0[3] + rate[3] * T) * DEG
    lperi = (el0[4] + rate[4] * T) * DEG
    lnode = (el0[5] + rate[5] * T) * DEG
    M = pymod(L - lperi, 2 * np.pi)
    w = lperi - lnode
    E = solve_kepler(M, e)
    px = a * (cos(E) - e)
    py = a * torch.sqrt(1 - e * e) * sin(E)
    cw, sw = cos(w), sin(w)
    cO, sO = cos(lnode), sin(lnode)
    ci, si = cos(inc), sin(inc)
    x = (cw * cO - sw * sO * ci) * px + (-sw * cO - cw * sO * ci) * py
    y = (cw * sO + sw * cO * ci) * px + (-sw * sO + cw * cO * ci) * py
    z = (sw * si) * px + (cw * si) * py
    return torch.stack([x, y, z], dim=-1)


# (D, M, Mp, F, sum_l [1e-6 deg], sum_r [1e-3 km])
_MOON_LR = [
    (0, 0, 1, 0, 6288774, -20905355),
    (2, 0, -1, 0, 1274027, -3699111),
    (2, 0, 0, 0, 658314, -2955968),
    (0, 0, 2, 0, 213618, -569925),
    (0, 1, 0, 0, -185116, 48888),
    (0, 0, 0, 2, -114332, -3149),
    (2, 0, -2, 0, 58793, 246158),
    (2, -1, -1, 0, 57066, -152138),
    (2, 0, 1, 0, 53322, -170733),
    (2, -1, 0, 0, 45758, -204586),
    (0, 1, -1, 0, -40923, -129620),
    (1, 0, 0, 0, -34720, 108743),
    (0, 1, 1, 0, -30383, 104755),
    (2, 0, 0, -2, 15327, 10321),
    (0, 0, 1, 2, -12528, 0),
    (0, 0, 1, -2, 10980, 79661),
    (4, 0, -1, 0, 10675, -34782),
    (0, 0, 3, 0, 10034, -23210),
    (4, 0, -2, 0, 8548, -21636),
    (2, 1, -1, 0, -7888, 24208),
    (2, 1, 0, 0, -6766, 30824),
    (1, 0, -1, 0, -5163, -8379),
    (1, 1, 0, 0, 4987, -16675),
    (2, -1, 1, 0, 4036, -12831),
    (2, 0, 2, 0, 3994, -10445),
    (4, 0, 0, 0, 3861, -11650),
    (2, 0, -3, 0, 3665, 14403),
    (0, 1, -2, 0, -2689, -7003),
    (2, -1, -2, 0, 2390, 10056),
    (1, 0, 1, 0, -2348, 6322),
    (2, -2, 0, 0, 2236, -9884),
]

# (D, M, Mp, F, sum_b [1e-6 deg])
_MOON_B = [
    (0, 0, 0, 1, 5128122),
    (0, 0, 1, 1, 280602),
    (0, 0, 1, -1, 277693),
    (2, 0, 0, -1, 173237),
    (2, 0, -1, 1, 55413),
    (2, 0, -1, -1, 46271),
    (2, 0, 0, 1, 32573),
    (0, 0, 2, 1, 17198),
    (2, 0, 1, -1, 9266),
    (0, 0, 2, -1, 8822),
    (2, -1, 0, -1, 8216),
    (2, 0, -2, -1, 4324),
    (2, 0, 1, 1, 4200),
    (2, 1, 0, -1, -3359),
    (2, -1, -1, 1, 2463),
    (2, -1, 0, 1, 2211),
    (2, -1, -1, -1, 2065),
    (0, 1, -1, -1, -1870),
    (4, 0, -1, -1, 1828),
    (0, 1, 0, 1, -1794),
]




def _efac(m: int, E):
    return E if abs(m) == 1 else (E * E if abs(m) == 2 else 1.0)


def moon_geocentric_ecliptic_date(T):
    """Geocentric ecliptic-of-date Moon position [m] (Meeus accuracy)."""
    T2, T3 = T * T, T * T * T
    Lp = (218.3164477 + 481267.88123421 * T - 0.0015786 * T2 + fdiv(T3, 538841.0)) * DEG
    D = (297.8501921 + 445267.1114034 * T - 0.0018819 * T2 + fdiv(T3, 545868.0)) * DEG
    M = (357.5291092 + 35999.0502909 * T - 0.0001536 * T2) * DEG
    Mp = (134.9633964 + 477198.8675055 * T + 0.0087414 * T2 + fdiv(T3, 69699.0)) * DEG
    F = (93.2720950 + 483202.0175233 * T - 0.0036539 * T2 - fdiv(T3, 3526000.0)) * DEG
    E = 1.0 - 0.002516 * T - 0.0000074 * T2
    suml = torch.zeros_like(T)
    sumr = torch.zeros_like(T)
    for d, m, mp, f, sl, sr in _MOON_LR:
        arg = d * D + m * M + mp * Mp + f * F
        efac = _efac(m, E)
        suml = suml + sl * efac * sin(arg)
        sumr = sumr + sr * efac * cos(arg)
    sumb = torch.zeros_like(T)
    for d, m, mp, f, sb in _MOON_B:
        arg = d * D + m * M + mp * Mp + f * F
        sumb = sumb + sb * _efac(m, E) * sin(arg)
    # additive perturbations (Venus, Jupiter, flattening)
    A1 = (119.75 + 131.849 * T) * DEG
    A2 = (53.09 + 479264.290 * T) * DEG
    A3 = (313.45 + 481266.484 * T) * DEG
    suml = suml + 3958 * sin(A1) + 1962 * sin(Lp - F) + 318 * sin(A2)
    sumb = (sumb - 2235 * sin(Lp) + 382 * sin(A3) + 175 * sin(A1 - F) + 175 * sin(A1 + F)
            + 127 * sin(Lp - Mp) - 115 * sin(Lp + Mp))
    lam = Lp + suml * 1e-6 * DEG
    beta = sumb * 1e-6 * DEG
    r = (385000.56 + sumr * 1e-3) * 1e3  # meters
    cb = cos(beta)
    return torch.stack([r * cb * cos(lam), r * cb * sin(lam), r * sin(beta)], dim=-1)


def ecl_date_matrix(T):
    """Rotation mean-ecliptic-&-equinox-of-date -> GCRS, consistent with the
    IAU2006 Fukushima-Williams bias-precession of ``astro/erot.py``:
    r_gcrs = Rz(-gamma_bar) Rx(-phi_bar) Rz(psi_bar) r_ecl_date."""
    gamb, phib, psib, _ = fukushima_williams(T)
    return matmul3(matmul3(rz(-gamb), rx(-phib)), rz(psib))


def _apply(M, vec):
    """M @ vec over (N, 3, 3) and (N, 3) in the order of pint_tpu's
    ``einsum("...ij,...j->...i")`` on a contiguous row: (p0 + p2) + p1."""
    return (M[..., 0] * vec[..., 0, None] + M[..., 2] * vec[..., 2, None]) \
        + M[..., 1] * vec[..., 1, None]


def _rotate(E, vec):
    """vec @ E.T for a fixed (3, 3) E, in numpy's matmul order: e0 v0, then
    two fused multiply-adds."""
    e = lambda j: E[:, j]  # noqa: E731
    v = lambda j: vec[..., j, None]  # noqa: E731
    return fma(v(2), e(2), fma(v(1), e(1), v(0) * e(0)))


def _planets_helio_icrs(T, M_fw) -> dict:
    """Heliocentric ICRS positions [m] of the planets and the EMB, in the
    order of the element table (the Sun constraint sums them in it)."""
    ecl2equ = torch.as_tensor(ECL2EQU, device=T.device)
    helio = {}
    for b in _ELEMENTS:
        if b in vsop87_planets.bodies:
            helio[b] = _apply(M_fw, vsop87_planets.planet_helio_ecl_date(b, T) * AU_M)
        else:
            helio[b] = _rotate(ecl2equ, helio_ecliptic(b, T) * AU_M)
    return helio


def _gm(b: str) -> float:
    return GM_BODY["earth"] + GM_BODY["moon"] if b == "emb" else GM_BODY[b]


GM_TOTAL = GM_SUN + sum(GM_BODY[b] for b in GM_BODY)


def pos_ssb_many(bodies, T) -> dict:
    """{body: barycentric ICRS position [m]} at TDB centuries `T`, the shared
    per-epoch work (the F-W rotation, the planets, the Sun) done once."""
    M_fw = ecl_date_matrix(T)
    helio = _planets_helio_icrs(T, M_fw)
    acc = torch.zeros_like(helio["emb"])
    for b, r in helio.items():
        acc = acc + _gm(b) * r
    sun = fdiv(-acc, GM_TOTAL)
    out = {}
    earth = moon_gc = None
    for body in bodies:
        if body == "sun":
            out[body] = sun
        elif body in ("earth", "moon", "emb"):
            if earth is None:
                earth = sun + _apply(M_fw, vsop87.earth_helio_ecl_date(T) * AU_M)
            if body == "earth":
                out[body] = earth
                continue
            if moon_gc is None:
                moon_gc = _apply(M_fw, moon_geocentric_ecliptic_date(T))
            out[body] = (earth + moon_gc if body == "moon"
                         else earth + fdiv(moon_gc, 1.0 + EARTH_MOON_MASS_RATIO))
        else:
            out[body] = sun + helio[body]
    return out


def analytic_posvel(bodies, tdb_jcent, dt_s: float = 16.0) -> dict:
    """{body: (pos [m], vel [m/s])}, (N, 3) each: positions at T and the
    central difference over T +- dt_s. The plain twin of K5."""
    unknown = [b for b in bodies if b not in BODIES]
    if unknown:
        raise KeyError(f"the analytic ephemeris serves {BODIES}; not {unknown}")
    T = tdb_jcent
    dT = dt_s / (36525.0 * 86400.0)
    p0 = pos_ssb_many(bodies, T - dT)
    p1 = pos_ssb_many(bodies, T + dT)
    pos = pos_ssb_many(bodies, T)
    return {b: (pos[b], fdiv(p1[b] - p0[b], 2 * dt_s)) for b in bodies}


def pack_tables() -> tuple[np.ndarray, np.ndarray]:
    """(table float64, layout int32): every table and constant K5 reads.

    ``table`` holds, in order: the VSOP87 terms (A, B, C) of `VSOP_BODIES`,
    coordinate L, B, R, power k; the Moon's longitude/distance rows (6
    values each) and latitude rows (5 each); the mean elements and rates of
    `KEPLER_BODIES` (12 each); the constants ARCSEC, DEG, 2 pi, AU_M,
    GM_TOTAL, 1 + EMRAT, the GM of each element-table body in order,
    ECL2EQU (row-major) and the F-W polynomials of gamma, phi and psi.
    ``layout[((body * 3 + coord) * 6 + k) * 2]`` is (first term, term count)
    of one power (count 0 past the last power); its last 7 entries are the
    offsets (in doubles) of the Moon's two tables with their row counts, of
    the elements, of the constants, and the table's length."""
    from pint_tpu_torch.astro.erot import FW_GAMB, FW_PHIB, FW_PSIB

    terms, layout = [], np.zeros((len(VSOP_BODIES), 3, 6, 2), np.int32)
    n = 0
    for bi, body in enumerate(VSOP_BODIES):
        series = vsop87.EARTH_SERIES if body == "earth" else vsop87_planets._SERIES[body]
        for ci, coord in enumerate(series):
            for k, tab in enumerate(coord):
                layout[bi, ci, k] = (n, len(tab))
                terms.append(np.asarray(tab, np.float64).ravel())
                n += len(tab)
    moon_lr = np.asarray(_MOON_LR, np.float64).ravel()
    moon_b = np.asarray(_MOON_B, np.float64).ravel()
    kep = np.concatenate([np.ravel(_ELEMENTS[b]) for b in KEPLER_BODIES]).astype(np.float64)
    consts = np.array([ARCSEC, DEG, 2 * np.pi, AU_M, GM_TOTAL, 1.0 + EARTH_MOON_MASS_RATIO]
                      + [_gm(b) for b in _ELEMENTS] + list(ECL2EQU.ravel())
                      + list(FW_GAMB) + list(FW_PHIB) + list(FW_PSIB), np.float64)
    offs = np.cumsum([3 * n, moon_lr.size, moon_b.size, kep.size, consts.size])
    table = np.concatenate(terms + [moon_lr, moon_b, kep, consts])
    tail = np.array([offs[0], len(_MOON_LR), offs[1], len(_MOON_B), offs[2], offs[3],
                     table.size], np.int32)
    return table, np.concatenate([layout.ravel(), tail]).astype(np.int32)


def quantize_nbody_window(lo: float, hi: float) -> tuple[float, float]:
    """The serving window of a [lo, hi] TDB-century request, as pint_tpu
    quantizes it: centre snapped to whole years, span to a multiple of 4
    years (at least 12). The N-body window and the pack snapshot share it,
    and neither depends on what the process loaded before."""
    yr = 365.25 * 86400.0 / (36525.0 * 86400.0)  # 1 year in jcent
    t0_q = round(((lo + hi) / 2.0) / yr) * yr
    # span: data + 4 yr margin + 1 yr quantization slack, snapped up to a
    # multiple of 4 years, at least 12
    span_yr = max(4.0 * np.ceil(((hi - lo) * 100.0 + 5.0) / 4.0), 12.0)
    return round(t0_q, 6), span_yr


#: the dict that `build_stage` adds its walls to (`stage_sink`), if any
_SINK: ContextVar[dict | None] = ContextVar("build_stage_sink", default=None)


@contextmanager
def stage_sink(stage_s: dict):
    """Add the walls of the window and pack builds run in the block to
    `stage_s`, by stage (``nbody_build``, ``kernel_build``)."""
    token = _SINK.set(stage_s)
    try:
        yield stage_s
    finally:
        _SINK.reset(token)


@contextmanager
def build_stage(name: str):
    """Time a build as stage `name` of the enclosing `stage_sink`,
    exclusive of the stages nested in it."""
    sink = _SINK.get()
    if sink is None:
        yield
        return
    t0, nested = time.perf_counter(), sum(sink.values())
    try:
        yield
    finally:
        dt = time.perf_counter() - t0 - (sum(sink.values()) - nested)
        sink[name] = sink.get(name, 0.0) + dt


def _cpu(T) -> torch.Tensor:
    return torch.as_tensor(np.asarray(T, np.float64))


class AnalyticEphemeris:
    """The built-in ephemeris: the analytic series, refined by the N-body
    window unless ``PINT_TPU_NBODY=0`` (see the module docstring)."""

    name = "analytic"
    bodies = BODIES

    def __init__(self):
        #: quantized window key -> NBodyEphemeris (`_nbody_for`)
        self._nbody_windows: dict = {}
        #: (window, configuration) -> kernel-pack key (`kernel_ephemeris.pack_for_analytic`)
        self._pack_key_memo: dict = {}

    # the series on the host, through K5's CPU twin (numpy in, numpy out),
    # as pint_tpu's host numpy: the N-body build's anchors and the pack keys

    def pos_ssb_many(self, bodies, tdb_jcent) -> dict:
        return {b: p.numpy() for b, p in pos_ssb_many(tuple(bodies), _cpu(tdb_jcent)).items()}

    def pos_ssb(self, body: str, tdb_jcent) -> np.ndarray:
        return self.pos_ssb_many((body,), tdb_jcent)[body]

    def _posvel_analytic(self, body: str, tdb_jcent, dt_s: float = 16.0):
        p, v = analytic_posvel((body,), _cpu(tdb_jcent), dt_s)[body]
        return p.numpy(), v.numpy()

    def _nbody_for(self, T: np.ndarray):
        """The N-body window serving the request `T` (TDB centuries), or None
        under ``PINT_TPU_NBODY=0``. It depends only on the requested range,
        quantized (`quantize_nbody_window`), never on what was loaded before."""
        if os.environ.get("PINT_TPU_NBODY", "1") == "0":
            return None
        from pint_tpu_torch.astro.nbody import refuse_comb

        refuse_comb()
        t0_q, span_yr = quantize_nbody_window(float(np.min(T)), float(np.max(T)))
        return self._nbody_window(t0_q, span_yr)

    def _nbody_window(self, t0_q: float, span_yr: float):
        """The window of an already quantized key, built (or read from the
        disk cache) once per instance, in the ``nbody_build`` stage."""
        key = (t0_q, span_yr)
        if key not in self._nbody_windows:
            from pint_tpu_torch.astro.nbody import NBodyEphemeris

            with build_stage("nbody_build"):
                self._nbody_windows[key] = NBodyEphemeris(self, t0_q, span_years=span_yr)
        return self._nbody_windows[key]

    def _kernel_pack_for(self, T: np.ndarray):
        """The pack snapshot covering a request (``PINT_TPU_KERNEL_EPHEM=1``).
        pint_tpu serves the direct path when the build fails; the port raises."""
        from pint_tpu_torch.astro import kernel_ephemeris as ke

        try:
            return ke.pack_for_analytic(self, T)
        except Exception as e:
            raise RuntimeError(
                f"PINT_TPU_KERNEL_EPHEM=1: the kernel-pack snapshot could not be built ({e}); "
                "pint_tpu would serve the direct path, the port does not (unset the "
                "knob to ask for it)") from e

    def posvel_many(self, bodies, tdb_jcent: np.ndarray, device=None) -> dict:
        """{body: (pos [m], vel [m/s])} as numpy: a forced pack (K7), else the
        N-body window (K6), else the series (K5), on `device` (the twins on
        the CPU); ``device_prepare.posvel_ssb_many``."""
        from pint_tpu_torch.astro import device_prepare

        return device_prepare.posvel_ssb_many(self, tuple(bodies), tdb_jcent, device)


_DEFAULT: AnalyticEphemeris | None = None


def get_ephemeris(name: str = "auto"):
    """The ephemeris pint_tpu serves under the current settings (module
    docstring). A par file's EPHEM name (DE440, ...) is served by the
    built-in ephemeris, with a warning in pint_tpu's degradation ledger
    there and none here (ROADMAP A17)."""
    global _DEFAULT
    kernel = os.environ.get("PINT_TPU_EPHEM")
    if kernel:
        from pint_tpu_torch.astro import kernel_ephemeris as ke
        from pint_tpu_torch.astro.spk import SPKEphemeris

        if not os.path.exists(kernel):
            raise FileNotFoundError(
                f"PINT_TPU_EPHEM={kernel} does not exist; pint_tpu would serve the analytic "
                "ephemeris instead (with a degradation-ledger event), the port does not")
        if ke.enabled():
            try:
                return ke.KernelEphemeris(ke.pack_for_spk_file(kernel))
            except Exception as e:
                raise RuntimeError(
                    f"PINT_TPU_EPHEM={kernel}: the Chebyshev pack could not be compiled ({e}); "
                    "pint_tpu would serve the host SPK reader, the port does not (set "
                    "PINT_TPU_KERNEL_EPHEM=0 to ask for it)") from e
        return SPKEphemeris(kernel)
    if _DEFAULT is None:
        _DEFAULT = AnalyticEphemeris()
    return _DEFAULT

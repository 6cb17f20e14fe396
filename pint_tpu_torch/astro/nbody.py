"""N-body refined solar-system trajectories (counterpart of
``pint_tpu/astro/nbody.py``): pint_tpu's default ephemeris.

The truncated analytic theories (``astro/ephemeris.py``) are good at low
frequencies but miss ~50-100 km of forced high-frequency perturbations. A
numerical integration of the point-mass system reproduces those, given the
right initial conditions, so the built-in ephemeris is refined dynamically:

1. initial conditions for Sun..Neptune from the analytic theories at a
   central epoch, barycentre and momentum zeroed;
2. the Newtonian N-body equations + the Sun's 1PN Schwarzschild terms,
   integrated with DOP853 (rtol 1e-11) over a window longer than the data;
3. Gauss-Newton refinement of the Earth and Moon initial states, so that the
   integrated-minus-analytic difference has no component in the trusted
   bands of the analytic anchors (a sextic drift and the annual, synodic
   and monthly lines);
4. the serve: cubic-Hermite interpolation of the dense solution on a
   half-day grid, with the in-band misfit of Earth and Moon subtracted (the
   hybrid correction: in-band content from the series, out-of-band from
   the dynamics).

The build (1-3) is host numpy and scipy, as in pint_tpu; its analytic
anchors come from K5's CPU twin (``ephemeris.pos_ssb_many``), whatever
device later serves the window, so a window is the same on every device.
The serve (4) is kernel K6 (``csrc/nbody_serve.cu``, wrapped by
``device_prepare.nbody_serve``); `NBodyEphemeris.posvel` is its plain
twin, on tensors of any device.

A built window is cached on disk under ``$PINT_TPU_CACHE_DIR/torch/nbody``
(default ``~/.cache/pint_tpu``), keyed by pint_tpu's recipe, in the port's
own subdirectory so that a window pint_tpu wrote is never served to the
port. ``PINT_TPU_NBODY_CACHE=0`` turns the cache off. `NBodyEphemeris.from_arrays`
builds a window from another package's arrays (the tests serve exactly
pint_tpu's window through it).
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

from pint_tpu_torch import EARTH_MOON_MASS_RATIO, GM_BODY, GM_SUN
from pint_tpu_torch.astro.erot import fdiv

log = logging.getLogger("pint_tpu_torch.nbody")

C_M_S = 299792458.0
DAY_S = 86400.0
CENT_S = 36525.0 * DAY_S

# Earth and Moon are integrated separately: a point-mass EMB misses the
# solar-tide deviation of the true barycentre trajectory
_BODIES = ("sun", "mercury", "venus", "earth", "moon", "mars",
           "jupiter", "saturn", "uranus", "neptune")

#: DOP853 tolerances; part of the solution's identity, so they join the
#: disk-cache key and the kernel-pack key
_RTOL = 1e-11
_ATOL = 1e-3


def _gm(body: str) -> float:
    return GM_SUN if body == "sun" else GM_BODY[body]


_GMS = np.array([_gm(b) for b in _BODIES])
_FIT_BODIES = ("earth", "moon")  # ICs refined against the analytic anchors

# the trusted anchor bands: annual harmonics 1-5 and the giant-planet synodic
# periods for the Earth; sidereal and anomalistic month, evection, variation
# and the first harmonic for the Moon
_ANCHOR_PERIODS_E = (365.25, 182.625, 121.75, 91.3125, 73.05,
                     779.94, 583.92, 398.88)
_ANCHOR_PERIODS_M = (27.321662, 27.554550, 31.811940, 29.530589, 13.660831)


def refuse_comb() -> None:
    """Raise under pint_tpu's legacy ``PINT_TPU_NBODY_COMB=1``, whose extra
    harmonics of the window span give another window than the port builds."""
    if os.environ.get("PINT_TPU_NBODY_COMB", "0") != "0":
        raise NotImplementedError(
            "pint_tpu's legacy long-period comb (PINT_TPU_NBODY_COMB=1) is not ported: "
            "the port's window fits the anchor lines only")


def cache_root() -> Path:
    """The port's disk-cache directory: ``torch/`` under pint_tpu's cache
    root (``$PINT_TPU_CACHE_DIR``, default ``~/.cache/pint_tpu``)."""
    root = os.environ.get("PINT_TPU_CACHE_DIR") or os.path.expanduser("~/.cache/pint_tpu")
    return Path(root) / "torch"


def _accelerations(pos: np.ndarray, vel: np.ndarray) -> np.ndarray:
    """(n,3) accelerations: pairwise Newtonian + Sun 1PN Schwarzschild."""
    dr = pos[None, :, :] - pos[:, None, :]  # [i, j] = r_j - r_i
    d2 = np.sum(dr * dr, axis=-1)
    np.fill_diagonal(d2, 1.0)
    inv_d3 = d2 ** (-1.5)
    np.fill_diagonal(inv_d3, 0.0)
    acc = np.einsum("j,ijk,ij->ik", _GMS, dr, inv_d3)
    # 1PN Schwarzschild correction of the Sun on each planet (harmonic
    # coordinates): a = GM/(c^2 r^3) [(4GM/r - v^2) r + 4 (r.v) v]
    rs = pos[1:] - pos[0]
    vs = vel[1:] - vel[0]
    r2 = np.sum(rs * rs, axis=-1)
    r1 = np.sqrt(r2)
    v2 = np.sum(vs * vs, axis=-1)
    rv = np.sum(rs * vs, axis=-1)
    f = GM_SUN / (C_M_S**2 * r2 * r1)
    acc[1:] += f[:, None] * ((4.0 * GM_SUN / r1 - v2)[:, None] * rs + 4.0 * rv[:, None] * vs)
    return acc


def _rhs(t: float, y: np.ndarray) -> np.ndarray:
    n = len(_BODIES)
    pos = y[: 3 * n].reshape(n, 3)
    vel = y[3 * n:].reshape(n, 3)
    return np.concatenate([vel.ravel(), _accelerations(pos, vel).ravel()])


def _zero_barycenter(y: np.ndarray) -> np.ndarray:
    n = len(_BODIES)
    pos = y[: 3 * n].reshape(n, 3).copy()
    vel = y[3 * n:].reshape(n, 3).copy()
    pos -= (_GMS @ pos)[None, :] / _GMS.sum()
    vel -= (_GMS @ vel)[None, :] / _GMS.sum()
    return np.concatenate([pos.ravel(), vel.ravel()])


# --- the serve's arithmetic, shared by the twin and (spelled the same) K6 ---------


def power(x: torch.Tensor, k: int) -> torch.Tensor:
    """x**k as pint_tpu's host serve computes it: on the CPU numpy's own
    ``**`` (its power has fast paths for k <= 2 and, on AVX-512 machines,
    a vector pow that is neither the C library's nor a product); on the
    card a left-to-right product, which K6 spells the same way."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(x.numpy() ** k, np.float64))
    out = x
    for _ in range(k - 1):
        out = out * x
    return out


def floor_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """numpy's float floor division a // b (its divmod: fmod, the quotient
    of the remainder-free part, then floor with the half-way fix), which
    is not floor(a / b) at exact multiples. `b` is a tensor on a's device
    (C8)."""
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    div = torch.where((mod != 0) & ((b < 0) != (mod < 0)), div - 1.0, div)
    fl = torch.floor(div)
    fl = torch.where(div - fl > 0.5, fl + 1.0, fl)
    return torch.where(div != 0, fl, torch.copysign(torch.zeros_like(div), a / b))


def band_design(t: torch.Tensor, periods_d, S: float):
    """(G, dG), (N, 7 + 4 len(periods)) each: the trusted-band design of
    ``NBodyEphemeris._band_design(t, periods_d, deriv=True)`` on tensors,
    {1, t..t^6} + (1, t) x sin/cos at each period, and its time derivative."""
    from pint_tpu_torch.ops.libm import cos, sin

    tn = fdiv(t, S)
    cols = [torch.ones_like(t)] + [power(tn, k) for k in range(1, 7)]
    dcols = [torch.zeros_like(t), torch.full_like(t, 1.0 / S)]
    dcols += [fdiv(k * power(tn, k - 1), S) for k in range(2, 7)]
    for period_d in periods_d:
        w = 2 * np.pi / (period_d * DAY_S)
        wt = w * t
        s, c = sin(wt), cos(wt)
        cols += [s, c, tn * s, tn * c]
        dcols += [w * c, -w * s, fdiv(s, S) + tn * w * c, fdiv(c, S) - tn * w * s]
    return torch.stack(cols, dim=1), torch.stack(dcols, dim=1)


def band_sum(G: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """G @ corr, (N, 3), summed column by column in order (pint_tpu's BLAS
    product sums in its own order; K6 sums in this one)."""
    out = G[:, :1] * corr[0]
    for j in range(1, G.shape[1]):
        out = out + G[:, j:j + 1] * corr[j]
    return out


class NBodyEphemeris:
    """Dynamically refined trajectories of the major bodies.

    `base` (the port's ``AnalyticEphemeris``) supplies the initial conditions
    and the Earth/Moon anchors. Positions and velocities are served by cubic
    Hermite interpolation of the dense integration on a `grid_days` grid.
    """

    #: pint_tpu's algorithm version, part of the disk-cache key
    _CACHE_VERSION = 12

    def __init__(self, base, t0_jcent: float, span_years: float = 16.0,
                 grid_days: float = 0.5, refine_iters: int = 3):
        refuse_comb()
        self.base = base
        self.t0 = float(t0_jcent)
        self.half_span_s = span_years * 0.5 * 365.25 * DAY_S
        self.grid_days = grid_days
        self._fit_idx = [_BODIES.index(b) for b in _FIT_BODIES]
        self._dev: dict = {}
        if not self._load_cached(refine_iters):
            self._build(refine_iters)
            self._save_cache(refine_iters)

    @classmethod
    def from_arrays(cls, grid_s, pos, vel, corr_e, corr_m, periods_e, periods_m,
                    t0: float, half_span_s: float) -> "NBodyEphemeris":
        """A window from arrays built elsewhere (numpy; pint_tpu's attribute
        names ``grid_s``, ``pos``, ``vel``, ``_corr_e``, ``_corr_m``,
        ``_periods_e``, ``_periods_m``, ``t0``, ``half_span_s``)."""
        nb = cls.__new__(cls)
        nb.base, nb.t0, nb.half_span_s = None, float(t0), float(half_span_s)
        nb.grid_s = np.asarray(grid_s, np.float64)
        nb.grid_days = float(nb.grid_s[1] - nb.grid_s[0]) / DAY_S
        nb.pos, nb.vel = np.asarray(pos, np.float64), np.asarray(vel, np.float64)
        nb._corr_e, nb._corr_m = np.asarray(corr_e, np.float64), np.asarray(corr_m, np.float64)
        nb._periods_e, nb._periods_m = tuple(periods_e), tuple(periods_m)
        nb._fit_idx = [_BODIES.index(b) for b in _FIT_BODIES]
        nb._dev = {}
        return nb

    # --- disk cache ---------------------------------------------------------------

    def _cache_path(self, refine_iters: int) -> str | None:
        """Cache file keyed, as pint_tpu keys it, by everything the solution
        depends on: epoch, span, serving grid, refinement depth, body/GM
        table, integrator tolerances, anchor periods and probe positions of
        the analytic theory itself."""
        if os.environ.get("PINT_TPU_NBODY_CACHE", "1") == "0":
            return None
        import hashlib

        probe = np.concatenate([
            np.asarray(self.base.pos_ssb(
                b, np.array([self.t0 - 0.05, self.t0, self.t0 + 0.05]))).ravel()
            for b in ("earth", "moon", "jupiter", "uranus", "neptune")
        ]).round(3)
        key = hashlib.sha256(
            repr((
                self._CACHE_VERSION, round(self.t0, 10), round(self.half_span_s, 3),
                self.grid_days, refine_iters, _BODIES, _GMS.tobytes(),
                _RTOL, _ATOL,
                self._earth_periods(), _ANCHOR_PERIODS_M,
                type(self.base).__name__, probe.tobytes(),
            )).encode()
        ).hexdigest()[:24]
        return str(cache_root() / "nbody" / f"{key}.npz")

    def _load_cached(self, refine_iters: int) -> bool:
        path = self._cache_path(refine_iters)
        if path is None or not os.path.exists(path):
            return False
        try:
            with np.load(path) as z:
                self.grid_s = z["grid_s"]
                self.pos = z["pos"]
                self.vel = z["vel"]
                self._corr_e = z["corr_e"]
                self._corr_m = z["corr_m"]
                self._periods_e = tuple(z["periods_e"])
                self._periods_m = tuple(z["periods_m"])
        except Exception as e:  # noqa: BLE001 — a corrupt entry is rebuilt from scratch
            log.warning(f"nbody cache read failed ({e}); rebuilding")
            return False
        log.info(f"nbody ephemeris loaded from cache: {path}")
        return True

    def _save_cache(self, refine_iters: int) -> None:
        path = self._cache_path(refine_iters)
        if path is None:
            return
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp{os.getpid()}.npz"
            np.savez(
                tmp, grid_s=self.grid_s, pos=self.pos, vel=self.vel,
                corr_e=self._corr_e, corr_m=self._corr_m,
                periods_e=np.array(self._periods_e),
                periods_m=np.array(self._periods_m),
            )
            os.replace(tmp, path)
        except OSError as e:  # a read-only cache directory costs the next run a build
            log.warning(f"nbody cache write failed: {e}")

    # --- integration (host) ---------------------------------------------------------

    def _integrate(self, y0: np.ndarray, t_eval: np.ndarray):
        from scipy.integrate import solve_ivp

        out = np.empty((t_eval.size, y0.size))
        # integrate backwards and forwards from 0
        for sign in (-1.0, 1.0):
            sel = t_eval <= 0 if sign < 0 else t_eval >= 0
            ts = t_eval[sel]
            if ts.size == 0:
                continue
            order = np.argsort(sign * ts)
            sol = solve_ivp(
                _rhs, (0.0, sign * self.half_span_s), y0,
                method="DOP853", rtol=_RTOL, atol=_ATOL,
                t_eval=ts[order],
                dense_output=False,
            )
            out[np.flatnonzero(sel)[order]] = sol.y.T
        return out

    def _fit_modes(self, y0: np.ndarray, t_eval: np.ndarray, base_traj: np.ndarray):
        """Sensitivity of the fit bodies' trajectories to their ICs (finite
        differences): (6*len(fit), nt, len(fit)*3)."""
        n = len(_BODIES)
        nf = len(self._fit_idx)
        cols = [np.s_[3 * i: 3 * i + 3] for i in self._fit_idx]
        modes = np.empty((6 * nf, t_eval.size, 3 * nf))
        for fi, i in enumerate(self._fit_idx):
            for k in range(6):
                y = y0.copy()
                if k < 3:
                    eps = 1e3  # 1 km position
                    y[3 * i + k] += eps
                else:
                    eps = 1e-4  # 0.1 mm/s velocity
                    y[3 * n + 3 * i + (k - 3)] += eps
                traj = self._integrate(y, t_eval)
                d = np.concatenate(
                    [traj[:, c] - base_traj[:, c] for c in cols], axis=1
                )
                modes[6 * fi + k] = d / eps
        return modes

    def _earth_periods(self) -> tuple:
        """The Earth's anchor lines (pint_tpu's legacy long-period comb,
        ``PINT_TPU_NBODY_COMB=1``, is refused: `refuse_comb`)."""
        return tuple(_ANCHOR_PERIODS_E)

    def _band_design(self, t: np.ndarray, periods_d, deriv: bool = False):
        """Host design matrix of the trusted band of an analytic anchor:
        {1, t, ..., t^6} + (1, t) x sin/cos at the given periods (the build's
        least squares; `band_design` is the serve's, on tensors)."""
        S = self.half_span_s
        tn = t / S
        cols = [tn**k for k in range(7)]
        cols[0] = np.ones_like(t)
        dcols = [np.zeros_like(t), np.full_like(t, 1.0 / S)]
        dcols += [k * tn ** (k - 1) / S for k in range(2, 7)]
        for period_d in periods_d:
            w = 2 * np.pi / (period_d * DAY_S)
            s, c = np.sin(w * t), np.cos(w * t)
            cols += [s, c, tn * s, tn * c]
            dcols += [w * c, -w * s, s / S + tn * w * c, c / S - tn * w * s]
        G = np.stack(cols, axis=1)
        if not deriv:
            return G
        return G, np.stack(dcols, axis=1)

    def _build(self, refine_iters: int) -> None:
        t_start = time.perf_counter()
        y0 = _zero_barycenter(_state_from_base(self.base, self.t0))
        # coarse grid for the IC fit (the fit only needs the low-frequency shape)
        fit_grid = np.arange(-self.half_span_s, self.half_span_s + 1, 2 * DAY_S)
        n = len(_BODIES)
        ie = _BODIES.index("earth")
        im = _BODIES.index("moon")
        se = np.s_[3 * ie: 3 * ie + 3]
        sm = np.s_[3 * im: 3 * im + 3]
        # anchor channels, each banded to where its theory is trustworthy:
        # the barycentric Earth against the series (secular + annual
        # harmonics + synodic lines), the geocentric Moon against the lunar
        # series (secular + monthly)
        self._periods_e = self._earth_periods()
        self._periods_m = _ANCHOR_PERIODS_M
        G_e = self._band_design(fit_grid, self._periods_e)
        G_m = self._band_design(fit_grid, self._periods_m)
        T_grid = self.t0 + fit_grid / CENT_S
        e_anchor = self.base.pos_ssb("earth", T_grid)
        m_anchor = self.base.pos_ssb("moon", T_grid) - e_anchor

        def bandfit(G, x):
            coef, *_ = np.linalg.lstsq(G, x, rcond=None)
            return coef

        def channels(earth_xyz, moon_xyz):
            c1 = earth_xyz - e_anchor
            c2 = (moon_xyz - earth_xyz) - m_anchor
            return np.concatenate(
                [G_e @ bandfit(G_e, c1), G_m @ bandfit(G_m, c2)], axis=1
            )

        def mode_channels(d_earth, d_moon):
            c2 = d_moon - d_earth
            return np.concatenate(
                [G_e @ bandfit(G_e, d_earth), G_m @ bandfit(G_m, c2)], axis=1
            )

        A = None  # the IC-variation modes, integrated once and reused
        for it in range(refine_iters):
            traj = self._integrate(y0, fit_grid)
            diff_lp = channels(traj[:, se], traj[:, sm])
            if A is None:
                modes = self._fit_modes(y0, fit_grid, traj)
                A = np.stack(
                    [mode_channels(mk[:, 0:3], mk[:, 3:6]).reshape(-1) for mk in modes],
                    axis=1,
                )
            b = diff_lp.reshape(-1)
            dx, *_ = np.linalg.lstsq(A, b, rcond=None)
            for fi, i in enumerate(self._fit_idx):
                y0[3 * i: 3 * i + 3] -= dx[6 * fi: 6 * fi + 3]
                y0[3 * n + 3 * i: 3 * n + 3 * i + 3] -= dx[6 * fi + 3: 6 * fi + 6]
            y0 = _zero_barycenter(y0)
            rms = np.sqrt(np.mean(np.sum(diff_lp[:, :3] ** 2, -1))) / 1e3
            log.info(f"nbody refine iter {it}: earth in-band anchor-vs-integration rms "
                     f"{rms:.1f} km")
        # the dense solution for serving
        grid = np.arange(-self.half_span_s, self.half_span_s + 1, self.grid_days * DAY_S)
        traj = self._integrate(y0, grid)
        self.grid_s = grid
        self.pos = traj[:, : 3 * n].reshape(-1, n, 3)
        self.vel = traj[:, 3 * n:].reshape(-1, n, 3)
        # the hybrid correction: the integration's in-band misfit against the
        # anchors, subtracted when serving
        e_final = self.pos[:, ie]
        m_final = self.pos[:, im]
        T_serve = self.t0 + grid / CENT_S
        e_anchor_s = self.base.pos_ssb("earth", T_serve)
        m_anchor_s = self.base.pos_ssb("moon", T_serve) - e_anchor_s
        Ge_s = self._band_design(grid, self._periods_e)
        Gm_s = self._band_design(grid, self._periods_m)
        ce, *_ = np.linalg.lstsq(Ge_s, e_final - e_anchor_s, rcond=None)
        cm, *_ = np.linalg.lstsq(Gm_s, (m_final - e_final) - m_anchor_s, rcond=None)
        self._corr_e = ce  # (n_basis, 3)
        self._corr_m = cm
        log.info(
            f"nbody ephemeris built: {len(_BODIES)} bodies, {grid.size} samples, "
            f"in-band corr earth {np.linalg.norm(Ge_s @ ce, axis=1).max() / 1e3:.0f} km / "
            f"moon {np.linalg.norm(Gm_s @ cm, axis=1).max() / 1e3:.0f} km, "
            f"{time.perf_counter() - t_start:.1f} s"
        )

    # --- serving ------------------------------------------------------------------

    def tensors(self, device) -> dict:
        """The window's arrays as float64 tensors on `device`, moved there
        once: grid_s (G,), pos and vel (G, 10, 3), corr_e and corr_m."""
        key = str(device)
        if key not in self._dev:
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64),  # noqa: E731
                                          device=device)
            self._dev[key] = {"grid_s": t(self.grid_s), "pos": t(self.pos), "vel": t(self.vel),
                              "corr_e": t(self._corr_e), "corr_m": t(self._corr_m)}
        return self._dev[key]

    def posvel(self, body: str, t_jcent: torch.Tensor):
        """Cubic-Hermite (pos [m], vel [m/s]), (N, 3) each, of an integrated
        body at TDB centuries `t_jcent` (float64, any device), with the
        in-band correction of Earth and Moon: K6's plain twin, in the order
        of pint_tpu's ``posvel``. The EMB is combined by the caller
        (``device_prepare.nbody_posvel``)."""
        p, v = self._posvel_raw(body, t_jcent)
        if body in ("earth", "moon"):
            w = self.tensors(t_jcent.device)
            t = (t_jcent - self.t0) * CENT_S
            Ge, dGe = band_design(t, self._periods_e, self.half_span_s)
            p = p - band_sum(Ge, w["corr_e"])
            v = v - band_sum(dGe, w["corr_e"])
            if body == "moon":
                Gm, dGm = band_design(t, self._periods_m, self.half_span_s)
                p = p - band_sum(Gm, w["corr_m"])
                v = v - band_sum(dGm, w["corr_m"])
        return p, v

    def _posvel_raw(self, body: str, t_jcent: torch.Tensor):
        w = self.tensors(t_jcent.device)
        grid_s, pos, vel = w["grid_s"], w["pos"], w["vel"]
        bi = _BODIES.index(body)
        t = (t_jcent - self.t0) * CENT_S
        h = grid_s[1] - grid_s[0]
        k = torch.clamp(floor_divide(t - grid_s[0], h).long(), 0, grid_s.shape[0] - 2)
        u = (t - grid_s[k]) / h
        p0, p1 = pos[k, bi], pos[k + 1, bi]
        v0, v1 = vel[k, bi] * h, vel[k + 1, bi] * h
        u = u[:, None]
        u2, u3 = power(u, 2), power(u, 3)
        h00 = 2 * u3 - 3 * u2 + 1
        h10 = u3 - 2 * u2 + u
        h01 = -2 * u3 + 3 * u2
        h11 = u3 - u2
        p = h00 * p0 + h10 * v0 + h01 * p1 + h11 * v1
        d00 = (6 * u2 - 6 * u) / h
        d10 = (3 * u2 - 4 * u + 1) / h
        d01 = (-6 * u2 + 6 * u) / h
        d11 = (3 * u2 - 2 * u) / h
        v = d00 * p0 + d10 * v0 + d01 * p1 + d11 * v1
        return p, v

    def posvel_host(self, body: str, t_jcent: np.ndarray):
        """(pos, vel) as numpy through the CPU twin, EMB included: the host
        serve pint_tpu's ``posvel`` is, which samples the window for the
        kernel-pack snapshot."""
        t = torch.as_tensor(np.asarray(t_jcent, np.float64))
        if body == "emb":
            (pe, ve), (pm, vm) = self.posvel_host("earth", t_jcent), self.posvel_host("moon",
                                                                                     t_jcent)
            w = EMB_WEIGHT
            return pe + (pm - pe) * w, ve + (vm - ve) * w
        p, v = self.posvel(body, t)
        return p.numpy(), v.numpy()


#: the Moon's weight in the Earth-Moon barycentre
EMB_WEIGHT = 1.0 / (1.0 + EARTH_MOON_MASS_RATIO)


def _state_from_base(base, t0: float) -> np.ndarray:
    pos = np.zeros((len(_BODIES), 3))
    vel = np.zeros((len(_BODIES), 3))
    for i, b in enumerate(_BODIES):
        # the analytic path explicitly: the refined path would recurse into
        # the window this state seeds
        p, v = base._posvel_analytic(b, np.array([t0]))
        pos[i], vel[i] = p[0], v[0]
    return np.concatenate([pos.ravel(), vel.ravel()])

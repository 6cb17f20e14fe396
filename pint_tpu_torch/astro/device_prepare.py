"""The TOA prepare's four device programs, as hand-written CUDA kernels
(counterpart of ``pint_tpu/astro/device_prepare.py``).

- K4 `site_geometry` (``csrc/site_geometry.cu``): ITRF -> GCRS site
  position and velocity, pint_tpu's ``prepare_geometry``; plain twin
  ``erot.itrf_to_gcrs_posvel``.
- K5 `analytic_ephemeris` (``csrc/analytic_ephemeris.cu``): barycentric
  position and velocity of the requested bodies from the analytic series,
  pint_tpu's ``prepare_ephemeris``; plain twin ``ephemeris.analytic_posvel``.
- K6 `nbody_serve` (``csrc/nbody_serve.cu``): the N-body window's serve,
  cubic-Hermite interpolation and the Earth/Moon in-band correction,
  pint_tpu's ``prepare_nbody``; plain twin ``nbody.NBodyEphemeris.posvel``.
- K7 `chebyshev_eval` (``csrc/chebyshev_eval.cu``): the Chebyshev pack's
  serve, record gather, recurrence and analytic velocity, summed along each
  body's chain to the SSB, pint_tpu's ``prepare_kernel_eval``; plain twin
  ``kernel_ephemeris.eval_posvel``.

Each wrapper launches its kernel on a CUDA tensor (and raises if the kernel
does not build or launch) and takes its twin on a CPU tensor; it adds one
to its ``launches`` count where it launches. pint_tpu falls back to host
numpy when a device program fails; the port does not: a failed kernel is
an error. `site_posvel`, `analytic_posvel`, `nbody_posvel` (which forms the
EMB from Earth and Moon after K6, as pint_tpu does) and `kernel_posvel` are
the numpy-facing entry points of the prepare: numpy in, the kernel or the
twin on `device`, numpy out. `posvel_ssb_many` picks among the last three as
pint_tpu's does: a forced pack first, then the N-body window, then the
series; ``AnalyticEphemeris.posvel_many`` and ``KernelEphemeris.posvel_many``
(and through them ``toas.prepare_arrays``) reach it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pint_tpu_torch.astro import ephemeris, erot
from pint_tpu_torch.device import resolve_device

__all__ = ["site_geometry", "site_geometry_plain", "analytic_ephemeris",
           "analytic_ephemeris_plain", "nbody_serve", "nbody_serve_plain", "chebyshev_eval",
           "chebyshev_eval_plain", "site_posvel", "analytic_posvel", "nbody_posvel",
           "kernel_posvel", "posvel_ssb_many"]

#: central-difference half step of the velocities (seconds), as pint_tpu's
DT_S = 16.0

_tables: dict = {}


def _on(device, key: str, make):
    """A constant tensor, made once per device."""
    k = (key, str(device))
    if k not in _tables:
        _tables[k] = make()
    return _tables[k]


def _f64(*tensors, n: int | None = None) -> None:
    for t in tensors:
        if t.dtype != torch.float64 or t.dim() != 1 or (n is not None and t.shape[0] != n):
            raise ValueError(f"expected float64 tensors of shape ({n},); got "
                             f"{[(x.dtype, tuple(x.shape)) for x in tensors]}")


# --- K4 ---------------------------------------------------------------------------


def _k4_consts() -> np.ndarray:
    return np.concatenate([[erot.ARCSEC, erot.TWO_PI, erot.OMEGA_EARTH], erot.FW_GAMB,
                           erot.FW_PHIB, erot.FW_PSIB, erot.FW_EPSA, erot.GMST_POLY,
                           erot.NUT_TABLE.ravel()]).astype(np.float64)


def site_geometry_plain(itrf_m, ut1_mjd, tt_jcent, xp_rad, yp_rad):
    """K4's twin: ``erot.itrf_to_gcrs_posvel``."""
    return erot.itrf_to_gcrs_posvel(itrf_m, ut1_mjd, tt_jcent, xp_rad, yp_rad)


def site_geometry(itrf_m, ut1_mjd, tt_jcent, xp_rad, yp_rad):
    """K4: GCRS (pos [m], vel [m/s]) of the site at ITRF `itrf_m` (3 floats)
    for float64 (N,) tensors of UT1 MJD, TT centuries and the polar-motion
    angles; (N, 3) each. A CPU tensor takes the twin."""
    if ut1_mjd.device.type == "cpu":
        return site_geometry_plain(itrf_m, ut1_mjd, tt_jcent, xp_rad, yp_rad)
    out = _launch_k4(itrf_m, ut1_mjd, tt_jcent, xp_rad, yp_rad)
    site_geometry.launches += 1
    return out


site_geometry.launches = 0


def _launch_k4(itrf_m, ut1_mjd, tt_jcent, xp_rad, yp_rad):
    """K4's launch on tensors of any device (the CPU only in a rehearsal
    against a host build of the source)."""
    n = ut1_mjd.shape[0]
    _f64(ut1_mjd, tt_jcent, xp_rad, yp_rad, n=n)
    ins = [t.contiguous() for t in (ut1_mjd, tt_jcent, xp_rad, yp_rad)]
    dev = ins[0].device
    consts = _on(dev, "k4", lambda: torch.as_tensor(_k4_consts(), device=dev))
    pos = torch.empty((n, 3), dtype=torch.float64, device=dev)
    vel = torch.empty_like(pos)
    from pint_tpu_torch.ops import build

    lib = build.library("site_geometry", _declare_k4)
    sx, sy, sz = (float(v) for v in itrf_m)
    build.check(lib, lib.site_geometry(*[t.data_ptr() for t in ins], consts.data_ptr(),
                                       erot.NUT_TABLE.shape[0], sx, sy, sz, pos.data_ptr(),
                                       vel.data_ptr(), n, build.stream_of(pos)))
    return pos, vel


def _declare_k4(lib) -> None:
    p, d = ctypes.c_void_p, ctypes.c_double
    lib.site_geometry.argtypes = [p, p, p, p, p, ctypes.c_int, d, d, d, p, p,
                                  ctypes.c_longlong, p]
    lib.site_geometry.restype = ctypes.c_int


# --- K5 ---------------------------------------------------------------------------


def analytic_ephemeris_plain(bodies, tdb_jcent, dt_s: float = DT_S) -> dict:
    """K5's twin: ``ephemeris.analytic_posvel``."""
    return ephemeris.analytic_posvel(bodies, tdb_jcent, dt_s)


def analytic_ephemeris(bodies, tdb_jcent, dt_s: float = DT_S) -> dict:
    """K5: {body: (pos [m], vel [m/s])}, (N, 3) each, for the bodies of
    ``ephemeris.BODIES`` at TDB centuries `tdb_jcent` (float64 (N,)). A CPU
    tensor takes the twin."""
    bodies = tuple(bodies)
    if tdb_jcent.device.type == "cpu":
        return analytic_ephemeris_plain(bodies, tdb_jcent, dt_s)
    out = _launch_k5(bodies, tdb_jcent, dt_s)
    analytic_ephemeris.launches += 1
    return out


analytic_ephemeris.launches = 0


def _launch_k5(bodies, tdb_jcent, dt_s: float):
    """K5's launch on a tensor of any device (the CPU only in a rehearsal
    against a host build of the source)."""
    unknown = [b for b in bodies if b not in ephemeris.BODIES]
    if unknown or not bodies or len(set(bodies)) != len(bodies):
        raise ValueError(f"K5 serves distinct bodies of {ephemeris.BODIES}; got {bodies}")
    n = tdb_jcent.shape[0]
    _f64(tdb_jcent, n=n)
    T = tdb_jcent.contiguous()
    dev = T.device

    def make():
        table, layout = ephemeris.pack_tables()
        return (torch.as_tensor(table, device=dev),
                torch.as_tensor(layout, dtype=torch.int32, device=dev))

    table, layout = _on(dev, "k5", make)
    codes = torch.tensor([ephemeris.BODIES.index(b) for b in bodies], dtype=torch.int32,
                         device=dev)
    nb = len(bodies)
    pos = torch.empty((nb, n, 3), dtype=torch.float64, device=dev)
    vel = torch.empty_like(pos)
    scratch = torch.empty((2, nb, n, 3), dtype=torch.float64, device=dev)
    dT = dt_s / (36525.0 * 86400.0)
    from pint_tpu_torch.ops import build

    lib = build.library("analytic_ephemeris", _declare_k5)
    build.check(lib, lib.analytic_ephemeris(
        T.data_ptr(), table.data_ptr(), layout.data_ptr(), table.shape[0], codes.data_ptr(),
        nb, dT, 2 * dt_s, pos.data_ptr(), vel.data_ptr(), scratch.data_ptr(), n,
        build.stream_of(T)))
    return {b: (pos[j], vel[j]) for j, b in enumerate(bodies)}


def _declare_k5(lib) -> None:
    p, d = ctypes.c_void_p, ctypes.c_double
    lib.analytic_ephemeris.argtypes = [p, p, p, ctypes.c_int, p, ctypes.c_int, d, d, p, p, p,
                                       ctypes.c_longlong, p]
    lib.analytic_ephemeris.restype = ctypes.c_int


# --- K6 ---------------------------------------------------------------------------

def _band_of(body: str) -> int:
    """The band correction an integrated body takes: 0 none, 1 the Earth's,
    2 the Earth's and the Moon's (pint_tpu's ``band_of``)."""
    return {"earth": 1, "moon": 2}.get(body, 0)


def nbody_serve_plain(nb, bodies, tdb_jcent) -> dict:
    """K6's twin: ``NBodyEphemeris.posvel`` of each body."""
    return {b: nb.posvel(b, tdb_jcent) for b in bodies}


def nbody_serve(nb, bodies, tdb_jcent) -> dict:
    """K6: {body: (pos [m], vel [m/s])}, (N, 3) each, for integrated bodies
    of the window `nb` (``nbody._BODIES``; not the EMB) at TDB centuries
    `tdb_jcent` (float64 (N,)). A CPU tensor takes the twin."""
    bodies = tuple(bodies)
    if tdb_jcent.device.type == "cpu":
        return nbody_serve_plain(nb, bodies, tdb_jcent)
    out = _launch_k6(nb, bodies, tdb_jcent)
    nbody_serve.launches += 1
    return out


nbody_serve.launches = 0


def _k6_consts(nb) -> np.ndarray:
    """t0, CENT_S, S, 1/S, then the angular rates 2 pi / (period day) of the
    Earth's and the Moon's trusted periods, computed as pint_tpu's
    ``_band_design`` computes them."""
    from pint_tpu_torch.astro.nbody import CENT_S, DAY_S

    S = nb.half_span_s
    w = [2 * np.pi / (p * DAY_S) for p in tuple(nb._periods_e) + tuple(nb._periods_m)]
    return np.array([nb.t0, CENT_S, S, 1.0 / S] + w, np.float64)


def _launch_k6(nb, bodies, tdb_jcent):
    """K6's launch on a tensor of any device (the CPU only in a rehearsal
    against a host build of the source)."""
    from pint_tpu_torch.astro.nbody import _BODIES

    unknown = [b for b in bodies if b not in _BODIES]
    if unknown or not bodies or len(set(bodies)) != len(bodies):
        raise ValueError(f"K6 serves distinct bodies of {_BODIES}; got {bodies}")
    n = tdb_jcent.shape[0]
    _f64(tdb_jcent, n=n)
    T = tdb_jcent.contiguous()
    dev = T.device
    w = nb.tensors(dev)
    if "k6_consts" not in w:
        w["k6_consts"] = torch.as_tensor(_k6_consts(nb), device=dev)
    consts = w["k6_consts"]
    codes = torch.tensor([[_BODIES.index(b), _band_of(b)] for b in bodies], dtype=torch.int32,
                         device=dev)
    nb_ = len(bodies)
    pos = torch.empty((nb_, n, 3), dtype=torch.float64, device=dev)
    vel = torch.empty_like(pos)
    from pint_tpu_torch.ops import build

    lib = build.library("nbody_serve", _declare_k6)
    build.check(lib, lib.nbody_serve(
        T.data_ptr(), w["grid_s"].data_ptr(), w["grid_s"].shape[0], w["pos"].data_ptr(),
        w["vel"].data_ptr(), len(_BODIES), w["corr_e"].data_ptr(), w["corr_m"].data_ptr(),
        consts.data_ptr(), len(nb._periods_e), len(nb._periods_m), codes.data_ptr(), nb_,
        pos.data_ptr(), vel.data_ptr(), n, build.stream_of(T)))
    return {b: (pos[j], vel[j]) for j, b in enumerate(bodies)}


def _declare_k6(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nbody_serve.argtypes = [p, p, i, p, p, i, p, p, p, i, i, p, i, p, p,
                                ctypes.c_longlong, p]
    lib.nbody_serve.restype = ctypes.c_int


# --- K7 ---------------------------------------------------------------------------


def chebyshev_eval_plain(pack, bodies, tdb_jcent) -> dict:
    """K7's twin: ``kernel_ephemeris.eval_posvel`` of each body at the epochs
    converted in two steps, t * 36525.0 * 86400.0 [ET s]."""
    from pint_tpu_torch.astro.kernel_ephemeris import eval_posvel

    et = tdb_jcent * 36525.0 * 86400.0
    return {b: eval_posvel(pack, b, et) for b in bodies}


def chebyshev_eval(pack, bodies, tdb_jcent) -> dict:
    """K7: {body: (pos [m], vel [m/s])}, (N, 3) each, from the Chebyshev pack
    `pack`, each body composed along its chain to the SSB, at TDB centuries
    `tdb_jcent` (float64 (N,)). Coverage is the caller's check. A CPU tensor
    takes the twin."""
    bodies = tuple(bodies)
    if tdb_jcent.device.type == "cpu":
        return chebyshev_eval_plain(pack, bodies, tdb_jcent)
    out = _launch_k7(pack, bodies, tdb_jcent)
    chebyshev_eval.launches += 1
    return out


chebyshev_eval.launches = 0

#: the longest chain K7 composes (the DE layout's is 2: Earth -> EMB -> SSB)
K7_MAX_CHAIN = 4


def _launch_k7(pack, bodies, tdb_jcent):
    """K7's launch on a tensor of any device (the CPU only in a rehearsal
    against a host build of the source)."""
    chains = [pack.chain_rows(b) for b in bodies]
    if not bodies or any(len(c) > K7_MAX_CHAIN for c in chains):
        raise ValueError(f"K7 composes chains of at most {K7_MAX_CHAIN} rows; got {chains}")
    n = tdb_jcent.shape[0]
    _f64(tdb_jcent, n=n)
    T = tdb_jcent.contiguous()
    dev = T.device
    w = pack.tensors(dev)
    B, R, C, _ = w["coef"].shape
    rows = torch.tensor([list(c) + [-1] * (K7_MAX_CHAIN - len(c)) for c in chains],
                        dtype=torch.int32, device=dev)
    nc = len(bodies)
    pos = torch.empty((nc, n, 3), dtype=torch.float64, device=dev)
    vel = torch.empty_like(pos)
    from pint_tpu_torch.ops import build

    lib = build.library("chebyshev_eval", _declare_k7)
    build.check(lib, lib.chebyshev_eval(
        T.data_ptr(), w["coef"].data_ptr(), w["mid"].data_ptr(), w["init"].data_ptr(),
        w["intlen"].data_ptr(), w["nrec"].data_ptr(), B, R, C, rows.data_ptr(), nc,
        K7_MAX_CHAIN, pos.data_ptr(), vel.data_ptr(), n, build.stream_of(T)))
    return {b: (pos[j], vel[j]) for j, b in enumerate(bodies)}


def _declare_k7(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chebyshev_eval.argtypes = [p, p, p, p, p, p, i, i, i, p, i, i, p, p,
                                   ctypes.c_longlong, p]
    lib.chebyshev_eval.restype = ctypes.c_int


# --- the prepare's numpy-facing entry points ----------------------------------------


def _tensor(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=dev)


def site_posvel(itrf_m, ut1_mjd, tt_jcent, xp_rad, yp_rad, device=None):
    """Site GCRS (pos, vel) as numpy (N, 3), from K4 on `device` (the twin
    on the CPU)."""
    dev = resolve_device(device)
    pos, vel = site_geometry(itrf_m, *(_tensor(a, dev) for a in (ut1_mjd, tt_jcent, xp_rad,
                                                                 yp_rad)))
    return pos.cpu().numpy(), vel.cpu().numpy()


def analytic_posvel(bodies, tdb_jcent, device=None) -> dict:
    """{body: (pos, vel)} as numpy (N, 3), from K5 on `device` (the twin on
    the CPU)."""
    dev = resolve_device(device)
    out = analytic_ephemeris(bodies, _tensor(tdb_jcent, dev))
    return {b: (p.cpu().numpy(), v.cpu().numpy()) for b, (p, v) in out.items()}


def nbody_posvel(nb, bodies, tdb_jcent, device=None) -> dict:
    """{body: (pos, vel)} as numpy (N, 3) from the N-body window `nb`, through
    K6 on `device` (the twin on the CPU); the EMB is formed from the Earth
    and the Moon after the launch, as pint_tpu forms it."""
    from pint_tpu_torch.astro.nbody import EMB_WEIGHT

    dev = resolve_device(device)
    expanded: list[str] = []
    for b in bodies:
        for bb in (("earth", "moon") if b == "emb" else (b,)):
            if bb not in expanded:
                expanded.append(bb)
    served = nbody_serve(nb, tuple(expanded), _tensor(tdb_jcent, dev))
    served = {b: (p.cpu().numpy(), v.cpu().numpy()) for b, (p, v) in served.items()}
    out = {}
    for b in bodies:
        if b == "emb":
            (pe, ve), (pm, vm) = served["earth"], served["moon"]
            out[b] = (pe + (pm - pe) * EMB_WEIGHT, ve + (vm - ve) * EMB_WEIGHT)
        else:
            out[b] = served[b]
    return out


def kernel_posvel(pack, bodies, tdb_jcent, device=None) -> dict:
    """{body: (pos, vel)} as numpy (N, 3) from the Chebyshev pack `pack`,
    through K7 on `device` (the twin on the CPU). Epochs outside the pack's
    coverage raise."""
    dev = resolve_device(device)
    et = np.asarray(tdb_jcent, np.float64) * 36525.0 * 86400.0
    for b in bodies:
        pack.check_coverage(b, et)
    out = chebyshev_eval(pack, tuple(bodies), _tensor(tdb_jcent, dev))
    return {b: (p.cpu().numpy(), v.cpu().numpy()) for b, (p, v) in out.items()}


def posvel_ssb_many(eph, bodies, tdb_jcent, device=None) -> dict:
    """{body: (pos, vel)} as numpy for the ephemeris `eph`, as pint_tpu's
    ``posvel_ssb_many`` serves it: a ``KernelEphemeris`` through its pack
    (K7); the built-in ephemeris through its forced pack snapshot
    (``PINT_TPU_KERNEL_EPHEM=1``, K7), else its N-body window (K6), else the
    analytic series (``PINT_TPU_NBODY=0``, K5). pint_tpu falls back to host
    numpy where a device program fails; here a failure raises."""
    from pint_tpu_torch.astro.kernel_ephemeris import KernelEphemeris, forced

    T = np.asarray(tdb_jcent, np.float64)
    bodies = tuple(bodies)
    if isinstance(eph, KernelEphemeris):
        return kernel_posvel(eph.pack, bodies, T, device)
    if forced():
        return kernel_posvel(eph._kernel_pack_for(T), bodies, T, device)
    nb = eph._nbody_for(T)
    if nb is not None:
        return nbody_posvel(nb, bodies, T, device)
    return analytic_posvel(bodies, T, device)

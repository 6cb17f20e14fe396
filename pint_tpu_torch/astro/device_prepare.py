"""The TOA prepare's two device programs, as hand-written CUDA kernels
(counterpart of ``pint_tpu/astro/device_prepare.py``).

- K4 `site_geometry` (``csrc/site_geometry.cu``): ITRF -> GCRS site
  position and velocity, pint_tpu's ``prepare_geometry``; plain twin
  ``erot.itrf_to_gcrs_posvel``.
- K5 `analytic_ephemeris` (``csrc/analytic_ephemeris.cu``): barycentric
  position and velocity of the requested bodies from the analytic series,
  pint_tpu's ``prepare_ephemeris``; plain twin ``ephemeris.analytic_posvel``.

Each wrapper launches its kernel on a CUDA tensor (and raises if the kernel
does not build or launch) and takes its twin on a CPU tensor; it adds one
to its ``launches`` count where it launches. pint_tpu falls back to host
numpy when a device program fails; the port does not: a failed kernel is
an error. `site_posvel` and `analytic_posvel` are the numpy-facing entry
points of the prepare (``toas.prepare_arrays``): numpy in, the kernel or
the twin on `device`, numpy out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pint_tpu_torch.astro import ephemeris, erot
from pint_tpu_torch.device import resolve_device

__all__ = ["site_geometry", "site_geometry_plain", "analytic_ephemeris",
           "analytic_ephemeris_plain", "site_posvel", "analytic_posvel"]

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

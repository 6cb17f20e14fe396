"""Earth orientation: IAU-2006 precession, truncated IAU-2000B nutation,
Earth rotation angle and sidereal time, and the ITRF -> GCRS site position
and velocity (counterpart of ``pint_tpu/astro/erot.py``).

This module is the plain-torch twin of kernel K4 (``csrc/site_geometry.cu``,
wrapped by ``device_prepare.site_posvel``): the same formulas, on tensors.
The nutation table `NUT_TABLE` is K4's input, so the series has one source
in the port. On a CPU tensor sin and cos come from the C library
(``ops/libm.py``), as numpy's do in pint_tpu's host prepare.

Polar motion and UT1-UTC come from ``astro/eop.py`` (zero without an IERS
table).
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.ops.dd import two_prod, two_sum
from pint_tpu_torch.ops.libm import cos, sin

ARCSEC = np.pi / (180.0 * 3600.0)
TWO_PI = 2.0 * np.pi

# Earth rotation rate dERA/dt [rad/s of UT1]
OMEGA_EARTH = 1.00273781191135448 * TWO_PI / 86400.0

#: Fukushima-Williams polynomials (arcsec, powers of T = TT centuries)
FW_GAMB = (-0.052928, 10.556378, 0.4932044, -0.00031238, -2.788e-6, 2.60e-8)
FW_PHIB = (84381.412819, -46.811016, 0.0511268, 0.00053289, -4.40e-7, -1.76e-8)
FW_PSIB = (-0.041775, 5038.481484, 1.5584175, -0.00018522, -2.6452e-5, -1.48e-8)
FW_EPSA = (84381.406, -46.836769, -0.0001831, 0.00200340, -5.76e-7, -4.34e-8)
#: GMST06 - ERA (arcsec, powers of T)
GMST_POLY = (0.014506, 4612.156534, 1.3915817, -0.00000044, -2.9956e-5, -3.68e-8)

# (l, l', F, D, Om, dpsi_sin [0.1 uas], dpsi_t_sin, deps_cos [0.1 uas], deps_t_cos)
# Leading IAU2000B luni-solar terms; longitude amplitudes in units of 1e-7 arcsec.
_NUT = [
    (0, 0, 0, 0, 1, -172064161.0, -174666.0, 92052331.0, 9086.0),
    (0, 0, 2, -2, 2, -13170906.0, -1675.0, 5730336.0, -3015.0),
    (0, 0, 2, 0, 2, -2276413.0, -234.0, 978459.0, -485.0),
    (0, 0, 0, 0, 2, 2074554.0, 207.0, -897492.0, 470.0),
    (0, 1, 0, 0, 0, 1475877.0, -3633.0, 73871.0, -184.0),
    (0, 1, 2, -2, 2, -516821.0, 1226.0, 224386.0, -677.0),
    (1, 0, 0, 0, 0, 711159.0, 73.0, -6750.0, 0.0),
    (0, 0, 2, 0, 1, -387298.0, -367.0, 200728.0, 18.0),
    (1, 0, 2, 0, 2, -301461.0, -36.0, 129025.0, -63.0),
    (0, -1, 2, -2, 2, 215829.0, -494.0, -95929.0, 299.0),
    (0, 0, 2, -2, 1, 128227.0, 137.0, -68982.0, -9.0),
    (-1, 0, 2, 0, 2, 123457.0, 11.0, -53311.0, 32.0),
    (-1, 0, 0, 2, 0, 156994.0, 10.0, -1235.0, 0.0),
    (1, 0, 0, 0, 1, 63110.0, 63.0, -33228.0, 0.0),
    (-1, 0, 0, 0, 1, -57976.0, -63.0, 31429.0, 0.0),
    (-1, 0, 2, 2, 2, -59641.0, -11.0, 25543.0, -11.0),
    (1, 0, 2, 0, 1, -51613.0, -42.0, 26366.0, 0.0),
    (-2, 0, 2, 0, 1, 45893.0, 50.0, -24236.0, -10.0),
    (0, 0, 0, 2, 0, 63384.0, 11.0, -1220.0, 0.0),
    (0, 0, 2, 2, 2, -38571.0, -1.0, 16452.0, -11.0),
    (0, -2, 2, -2, 2, 32481.0, 0.0, -13870.0, 0.0),
    (-2, 0, 0, 2, 0, -47722.0, 0.0, 477.0, 0.0),
    (2, 0, 2, 0, 2, -31046.0, -1.0, 13238.0, -11.0),
    (1, 0, 2, -2, 2, 28593.0, 0.0, -12338.0, 10.0),
    (-1, 0, 2, 0, 1, 20441.0, 21.0, -10758.0, 0.0),
    (2, 0, 0, 0, 0, 29243.0, 0.0, -609.0, 0.0),
    (0, 0, 2, 0, 0, 25887.0, 0.0, -550.0, 0.0),
    (0, 1, 0, 0, 1, -14053.0, -25.0, 8551.0, -2.0),
    (-1, 0, 0, 2, 1, 15164.0, 10.0, -8001.0, 0.0),
    (0, 2, 2, -2, 2, -15794.0, 72.0, 6850.0, -42.0),
]


#: (terms, 9): argument multipliers, then the four amplitudes; K4's table
NUT_TABLE = np.array(_NUT, dtype=np.float64)


def _poly(T, coeffs):
    out = torch.zeros_like(T)
    for c in reversed(coeffs):
        out = out * T + c
    return out


def pymod(x, m: float):
    """numpy's remainder for a positive divisor: fmod (exact), then moved
    into [0, m) (the result takes the divisor's sign)."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def npsum(x):
    """Sum over the last axis in numpy's order (its pairwise summation, as
    ``np.sum(..., axis=-1)`` runs it on a contiguous row): below 8 terms one
    after another from 0; up to 128 terms in 8 interleaved partial sums,
    folded ((0+1)+(2+3))+((4+5)+(6+7)), then the remainder; above, the two
    halves (the first a multiple of 8 long) each so. pint_tpu's series sum
    this way, and on the ~6e11 leading VSOP87 terms another order moves the
    Earth by centimetres; K4 and K5 sum in the same order."""
    n = x.shape[-1]
    if n < 8:
        res = x.new_zeros(x.shape[:-1])
        for i in range(n):
            res = res + x[..., i]
        return res
    if n <= 128:
        m = n - n % 8
        r = x[..., 0:8]
        for i in range(8, m, 8):
            r = r + x[..., i:i + 8]
        res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) \
            + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(m, n):
            res = res + x[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return npsum(x[..., :n2]) + npsum(x[..., n2:])


def fukushima_williams(T):
    """IAU2006 bias-precession F-W angles (radians); T = TT centuries J2000."""
    return tuple(_poly(T, c) * ARCSEC for c in (FW_GAMB, FW_PHIB, FW_PSIB, FW_EPSA))


def delaunay_args(T):
    """Fundamental luni-solar arguments (IERS 2003), radians."""
    T2, T3 = T * T, T * T * T
    l = (485868.249036 + 1717915923.2178 * T + 31.8792 * T2 + 0.051635 * T3) * ARCSEC
    lp = (1287104.79305 + 129596581.0481 * T - 0.5532 * T2 + 0.000136 * T3) * ARCSEC
    F = (335779.526232 + 1739527262.8478 * T - 12.7512 * T2 - 0.001037 * T3) * ARCSEC
    D = (1072260.70369 + 1602961601.2090 * T - 6.3706 * T2 + 0.006593 * T3) * ARCSEC
    Om = (450160.398036 - 6962890.5431 * T + 7.4722 * T2 + 0.007702 * T3) * ARCSEC
    return l, lp, F, D, Om


def nutation(T):
    """(dpsi, deps) radians, truncated IAU2000B."""
    tab = torch.as_tensor(NUT_TABLE, device=T.device)
    args = delaunay_args(T)
    arg = args[0][..., None] * tab[:, 0]  # (N, terms)
    for j in range(1, 5):
        arg = arg + args[j][..., None] * tab[:, j]
    Tcol = T[..., None]
    dpsi = npsum((tab[:, 5] + tab[:, 6] * Tcol) * sin(arg))
    deps = npsum((tab[:, 7] + tab[:, 8] * Tcol) * cos(arg))
    return dpsi * 1e-7 * ARCSEC, deps * 1e-7 * ARCSEC


def rx(theta):
    c, s = cos(theta), sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([o, z, z], -1), torch.stack([z, c, s], -1),
                        torch.stack([z, -s, c], -1)], -2)


def rz(theta):
    c, s = cos(theta), sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, s, z], -1), torch.stack([-s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def fdiv(x, d: float):
    """x / d as an IEEE division on every device. PyTorch's CUDA division by
    a Python (or CPU) scalar multiplies by the scalar's reciprocal, one bit
    off the quotient; on tau = T / 10 that moved the twin's Earth by ~1 cm
    on the card. A divisor on the tensor's own device is divided by."""
    return x / x.new_full((), d)


def fma(a, b, c):
    """a * b + c rounded once: Dekker's exact product, Knuth's exact sum, and
    one final rounding (the correctly rounded FMA but in rare ties)."""
    p, e = two_prod(a, b)
    s, t = two_sum(p, c)
    return s + (t + e)


def matmul3(a, b):
    """(..., 3, 3) @ (..., 3, 3) in numpy's order for stacked 3x3 products:
    a0 b0, then two fused multiply-adds (k = 1, 2)."""
    ai = lambda k: a[..., :, k, None]  # noqa: E731
    bk = lambda k: b[..., None, k, :]  # noqa: E731
    return fma(ai(2), bk(2), fma(ai(1), bk(1), ai(0) * bk(0)))


def npb_matrix(T):
    """GCRS -> true-of-date matrix (N, 3, 3): r_tod = M @ r_gcrs."""
    gamb, phib, psib, epsa = fukushima_williams(T)
    dpsi, deps = nutation(T)
    # SOFA fw2m composition: R1(-eps) R3(-psi) R1(phi) R3(gamb)
    m = matmul3(rx(-(epsa + deps)), rz(-(psib + dpsi)))
    return matmul3(matmul3(m, rx(phib)), rz(gamb))


def era(ut1_mjd):
    """Earth rotation angle (radians) from UT1 MJD."""
    du = ut1_mjd - 51544.5
    f = pymod(du, 1.0)
    return TWO_PI * pymod(0.7790572732640 + f + 0.00273781191135448 * du, 1.0)


def gmst06(ut1_mjd, tt_jcent):
    return era(ut1_mjd) + _poly(tt_jcent, GMST_POLY) * ARCSEC


def gast06(ut1_mjd, tt_jcent):
    epsa = fukushima_williams(tt_jcent)[3]
    dpsi, _ = nutation(tt_jcent)
    return gmst06(ut1_mjd, tt_jcent) + dpsi * cos(epsa)


def itrf_to_gcrs_posvel(itrf_m, ut1_mjd, tt_jcent, xp_rad, yp_rad):
    """Site GCRS position [m] and velocity [m/s] at each epoch, (N, 3) each:
    the plain twin of K4. `itrf_m` is the site's (3,) ITRF position; polar
    motion enters as the small-angle wobble x' = x - xp z, y' = y + yp z,
    z' = z + xp x - yp y."""
    x, y, z = (float(v) for v in itrf_m)
    xw = x - xp_rad * z
    yw = y + yp_rad * z
    zw = z + xp_rad * x - yp_rad * y
    theta = gast06(ut1_mjd, tt_jcent)
    M = npb_matrix(tt_jcent)
    c, s = cos(theta), sin(theta)
    r_tod = torch.stack([c * xw - s * yw, s * xw + c * yw, zw.expand_as(c)], -1)
    v_tod = OMEGA_EARTH * torch.stack([-s * xw - c * yw, c * xw - s * yw, torch.zeros_like(c)], -1)
    # transpose(M) maps tod -> gcrs: r_i = sum_j M[j, i] r_j, j in order
    r_gcrs = (M[..., 0, :] * r_tod[..., 0, None] + M[..., 1, :] * r_tod[..., 1, None]) \
        + M[..., 2, :] * r_tod[..., 2, None]
    v_gcrs = (M[..., 0, :] * v_tod[..., 0, None] + M[..., 1, :] * v_tod[..., 1, None]) \
        + M[..., 2, :] * v_tod[..., 2, None]
    return r_gcrs, v_gcrs

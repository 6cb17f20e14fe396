"""Binary-orbit delay engines as plain torch functions (counterpart of
``pint_tpu/models/binaries/engines.py``, the ELL1 family only).

An engine maps (params, dt, phi, norb, pb) -> delay seconds, where

- ``params`` is a dict of float64 values in internal units (collapsed from
  the double-double leaves by ``models/binary.PulsarBinary``);
- ``dt``     float64 seconds since the binary epoch (TASC), for the secular
  terms (A1DOT, EPS1DOT, EPS2DOT);
- ``phi``    orbital phase in radians on the centred branch (|phi| <= pi),
  reduced in double-double by the wrapper;
- ``norb``   orbit count (integer-valued float64);
- ``pb``     the instantaneous orbital period PB + PBDOT dt, seconds.

ELL1 follows Lange et al. (2001) with the third-order eccentricity terms of
Zhu et al. (2019) and Fiore et al. (2023). These functions are the plain twin
of the binary term of kernel K1 (csrc/resid_tangent.cu), which evaluates
the same expressions per TOA with forward-mode tangents.
"""

from __future__ import annotations

import math


from pint_tpu_torch import TSUN_S
from pint_tpu_torch.ops import libm

TWO_PI = 2.0 * math.pi


def _get(p: dict, name: str, default: float = 0.0):
    v = p.get(name)
    return default if v is None else v


def _a1(p, dt):
    return _get(p, "A1") + _get(p, "A1DOT") * dt


def _harmonics(phi):
    """sin and cos of phi, 2 phi, 3 phi, 4 phi."""
    return [(libm.sin(k * phi), libm.cos(k * phi)) if k > 1 else
            (libm.sin(phi), libm.cos(phi)) for k in (1, 2, 3, 4)]


def _ell1_dre_da1(phi, e1, e2):
    """ELL1 Roemer delay / (a1/c), to third order in eccentricity."""
    (s1, c1), (s2, c2), (s3, c3), (s4, c4) = _harmonics(phi)
    return (
        s1
        + 0.5 * (e2 * s2 - e1 * c2)
        - 0.125
        * (5 * e2**2 * s1 - 3 * e2**2 * s3 - 2 * e2 * e1 * c1 + 6 * e2 * e1 * c3
           + 3 * e1**2 * s1 + 3 * e1**2 * s3)
        - (1.0 / 12)
        * (
            5 * e2**3 * s2
            + 3 * e1**2 * e2 * s2
            - 6 * e1 * e2**2 * c2
            - 4 * e1**3 * c2
            - 4 * e2**3 * s4
            + 12 * e1**2 * e2 * s4
            + 12 * e1 * e2**2 * c4
            - 4 * e1**3 * c4
        )
    )


def _ell1_dre_dphi_da1(phi, e1, e2):
    """d/dphi of _ell1_dre_da1."""
    (s1, c1), (s2, c2), (s3, c3), (s4, c4) = _harmonics(phi)
    return (
        c1
        + e1 * s2
        + e2 * c2
        - 0.125
        * (5 * e2**2 * c1 - 9 * e2**2 * c3 + 2 * e1 * e2 * s1 - 18 * e1 * e2 * s3
           + 3 * e1**2 * c1 + 9 * e1**2 * c3)
        - (1.0 / 12)
        * (
            10 * e2**3 * c2
            + 6 * e1**2 * e2 * c2
            + 12 * e1 * e2**2 * s2
            + 8 * e1**3 * s2
            - 16 * e2**3 * c4
            + 48 * e1**2 * e2 * c4
            - 48 * e1 * e2**2 * s4
            + 16 * e1**3 * s4
        )
    )


def _ell1_dre_dphi2_da1(phi, e1, e2):
    """d^2/dphi^2 of _ell1_dre_da1."""
    (s1, c1), (s2, c2), (s3, c3), (s4, c4) = _harmonics(phi)
    return (
        -s1
        + 2 * e1 * c2
        - 2 * e2 * s2
        - 0.125
        * (-5 * e2**2 * s1 + 27 * e2**2 * s3 + 2 * e1 * e2 * c1 - 54 * e1 * e2 * c3
           - 3 * e1**2 * s1 - 27 * e1**2 * s3)
        - (1.0 / 12)
        * (
            -20 * e2**3 * s2
            - 12 * e1**2 * e2 * s2
            + 24 * e1 * e2**2 * c2
            + 16 * e1**3 * c2
            + 64 * e2**3 * s4
            - 192 * e1**2 * e2 * s4
            - 192 * e1 * e2**2 * c4
            + 64 * e1**3 * c4
        )
    )


def _ell1_inverse(a1, pb, dre_da1, drep_da1, drepp_da1):
    """Inverse-timing expansion, proper -> coordinate time, nhat = 2 pi / pb."""
    Dre = a1 * dre_da1
    Drep = a1 * drep_da1
    Drepp = a1 * drepp_da1
    nhat = TWO_PI / pb
    return Dre * (1.0 - nhat * Drep + (nhat * Drep) ** 2 + 0.5 * nhat**2 * Dre * Drepp)


def _ell1_eps(p, dt):
    e1 = _get(p, "EPS1") + _get(p, "EPS1DOT") * dt
    e2 = _get(p, "EPS2") + _get(p, "EPS2DOT") * dt
    return e1, e2


def ell1_delay(p: dict, dt, phi, norb, pb):
    """ELL1: inverse Roemer + M2/SINI Shapiro (Lange et al. 2001 eq A16)."""
    a1 = _a1(p, dt)
    e1, e2 = _ell1_eps(p, dt)
    delayI = _ell1_inverse(
        a1,
        pb,
        _ell1_dre_da1(phi, e1, e2),
        _ell1_dre_dphi_da1(phi, e1, e2),
        _ell1_dre_dphi2_da1(phi, e1, e2),
    )
    tm2 = _get(p, "M2") * TSUN_S
    delayS = -2.0 * tm2 * libm.log(1.0 - _get(p, "SINI") * libm.sin(phi))
    return delayI + delayS

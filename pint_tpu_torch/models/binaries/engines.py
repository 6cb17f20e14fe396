"""Binary-orbit delay engines as plain torch functions (counterpart of
``pint_tpu/models/binaries/engines.py``: BT, DD, DDS and ELL1).

An engine maps (params, dt, phi, norb, pb) -> delay seconds, where

- ``params`` is a dict of float64 values in internal units (collapsed from
  the double-double leaves by ``models/binary.PulsarBinary``);
- ``dt``     float64 seconds since the binary epoch (T0 or TASC), for the
  secular terms (EDOT, A1DOT, OMDOT in BT, EPS1DOT, EPS2DOT);
- ``phi``    orbital phase in radians on the centred branch (|phi| <= pi),
  reduced in double-double by the wrapper;
- ``norb``   orbit count (integer-valued float64), which re-attaches the
  true anomaly to its orbit in DD's omega = OM + k nu;
- ``pb``     the instantaneous orbital period PB + PBDOT dt, seconds.

BT follows Blandford & Teukolsky (1976), DD Damour & Deruelle (1986) eqs
25-52, DDS Kramer et al. (2006); both solve Kepler's equation through
``kepler.kepler_E``. ELL1 follows Lange et al. (2001) with the third-order
eccentricity terms of Zhu et al. (2019) and Fiore et al. (2023). These
functions are the plain twin of the binary terms of kernel K1
(csrc/resid_tangent.cu), which evaluates the same expressions per TOA with
forward-mode tangents, in the same order. Powers that jax traces as
``integer_pow`` are spelled as products; divisions by a constant and of a
constant divide by a tensor (``erot.fdiv``, ``_rdiv``: torch's ``x / c`` on
CUDA is ``x * (1 / c)`` and its ``c / x`` everywhere ``c * (1 / x)``).
"""

from __future__ import annotations

import math


import torch

from pint_tpu_torch import TSUN_S
from pint_tpu_torch.astro.erot import fdiv
from pint_tpu_torch.models.binaries.kepler import kepler_E, true_anomaly
from pint_tpu_torch.ops import libm

TWO_PI = 2.0 * math.pi


def _get(p: dict, name: str, default: float = 0.0):
    v = p.get(name)
    return default if v is None else v


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x as an IEEE division."""
    return x.new_full((), c) / x


def _ecc(p, dt):
    return _get(p, "ECC") + _get(p, "EDOT") * dt


def _a1(p, dt):
    return _get(p, "A1") + _get(p, "A1DOT") * dt


# --- BT (Blandford & Teukolsky 1976) -------------------------------------------


def bt_delay(p: dict, dt, phi, norb, pb):
    e = _ecc(p, dt)
    a1 = _a1(p, dt)
    omega = _get(p, "OM") + _get(p, "OMDOT") * dt
    gamma = _get(p, "GAMMA")
    E = kepler_E(phi, e)
    sinE, cosE = libm.sin(E), libm.cos(E)
    sw, cw = libm.sin(omega), libm.cos(omega)
    root = torch.sqrt(1.0 - e * e)
    L1 = a1 * sw * (cosE - e)
    L2 = (a1 * cw * root + gamma) * sinE
    num = a1 * cw * root * cosE - a1 * sw * sinE
    D = 1.0 - TWO_PI * num / ((1.0 - e * cosE) * pb)
    return (L1 + L2) * D


# --- DD family (Damour & Deruelle 1986) ----------------------------------------


def _dd_core(p: dict, dt, phi, norb, pb, sini):
    e = _ecc(p, dt)
    a1 = _a1(p, dt)
    gamma = _get(p, "GAMMA")
    E = kepler_E(phi, e)
    sinE, cosE = libm.sin(E), libm.cos(E)
    nu = true_anomaly(E, e)
    nu_full = nu + TWO_PI * norb
    # omega = OM + k nu, k = OMDOT / n = OMDOT pb / 2 pi
    k = fdiv(_get(p, "OMDOT") * pb, TWO_PI)
    omega = _get(p, "OM") + k * nu_full
    sw, cw = libm.sin(omega), libm.cos(omega)
    er = e * (1.0 + _get(p, "DR"))
    eth = e * (1.0 + _get(p, "DTH"))
    alpha = a1 * sw
    beta = a1 * torch.sqrt(1.0 - eth * eth) * cw
    bg = beta + gamma
    # Dre = Roemer + Einstein in proper time (DD eq 48)
    Dre = alpha * (cosE - er) + bg * sinE
    Drep = -alpha * sinE + bg * cosE
    Drepp = -alpha * cosE - bg * sinE
    one_m_ecosE = 1.0 - e * cosE
    nhat = _rdiv(TWO_PI, pb) / one_m_ecosE
    # inverse timing, DD eqs 46-52 with the e sin E term
    nD = nhat * Drep
    nhat2 = nhat * nhat
    delayI = Dre * (
        1.0
        - nhat * Drep
        + nD * nD
        + 0.5 * nhat2 * Dre * Drepp
        - 0.5 * e * sinE / one_m_ecosE * nhat2 * Dre * Drep
    )
    # Shapiro (DD eq 26)
    tm2 = _get(p, "M2") * TSUN_S
    delayS = -2.0 * tm2 * libm.log(
        1.0 - e * cosE - sini * (sw * (cosE - e) + torch.sqrt(1.0 - e * e) * cw * sinE)
    )
    # aberration (DD eq 27)
    wpnu = omega + nu_full
    delayA = _get(p, "A0") * (libm.sin(wpnu) + e * sw) + _get(p, "B0") * (
        libm.cos(wpnu) + e * cw
    )
    return delayI + delayS + delayA


def dd_delay(p: dict, dt, phi, norb, pb):
    return _dd_core(p, dt, phi, norb, pb, _get(p, "SINI"))


def dds_sini(shapmax):
    """DDS's sin i = 1 - exp(-SHAPMAX) (Kramer et al. 2006)."""
    return 1.0 - libm.exp(-shapmax)


def dds_delay(p: dict, dt, phi, norb, pb):
    """DD with SHAPMAX = -ln(1 - sin i)."""
    return _dd_core(p, dt, phi, norb, pb, dds_sini(_get(p, "SHAPMAX")))


# --- ELL1 family (Lange et al. 2001) -------------------------------------------


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

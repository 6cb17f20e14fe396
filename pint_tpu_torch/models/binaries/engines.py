"""Binary-orbit delay engines as plain torch functions (counterpart of
``pint_tpu/models/binaries/engines.py``: BT, DD, DDS, DDGR and DDK, ELL1,
ELL1H and ELL1K).

An engine maps (params, dt, phi, norb, pb) -> delay seconds, where

- ``params`` is a dict of float64 values in internal units (collapsed from
  the double-double leaves by ``models/binary.PulsarBinary``);
- ``dt``     float64 seconds since the binary epoch (T0 or TASC), for the
  secular terms (EDOT, A1DOT, OMDOT in BT, EPS1DOT, EPS2DOT);
- ``phi``    orbital phase in radians on the centred branch (|phi| <= pi),
  reduced in double-double by the wrapper;
- ``norb``   orbit count (integer-valued float64), which re-attaches the
  true anomaly to its orbit in DD's omega = OM + k nu;
- ``pb``     the instantaneous orbital period, seconds: PB + PBDOT dt, or
  1 / (FB0 + FB1 dt + ...) in the orbital-frequency form.

BT follows Blandford & Teukolsky (1976), DD Damour & Deruelle (1986) eqs
25-52, DDS Kramer et al. (2006); both solve Kepler's equation through
``kepler.kepler_E``; DDGR derives DD's post-Keplerian parameters from the
masses under GR (`ddgr_derived`), DDK moves A1, OM and sin i per TOA by
Kopeikin's proper-motion and parallax terms (`ddk_corrections`). ELL1
follows Lange et al. (2001) with the third-order eccentricity terms of Zhu
et al. (2019) and Fiore et al. (2023), ELL1H adds Freire & Wex's (2010)
orthometric Shapiro delay, ELL1K (Susobhanan et al. 2018) an advancing,
decaying eccentricity vector. These
functions are the plain twin of the binary terms of kernel K1
(csrc/resid_tangent.cu), which evaluates the same expressions per TOA with
forward-mode tangents, in the same order (DDGR's derived scalars excepted:
they are formed once per parameter set on the host, `ddgr_derived`, and
reach the kernel with their Jacobian). Powers that jax traces as
``integer_pow`` are spelled as products in its order (`ipow`); a float
power is the C library's on the CPU (``libm.pow``); divisions by a constant and of a
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
    nhat = _rdiv(TWO_PI, pb)
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


def ipow(x, y: int):
    """x ** y for an integer y >= 0 as jax's ``integer_pow`` lowers it: by
    repeated squaring, the result multiplied on the left (x^3 = x (x x),
    x^4 = (x x)(x x)); y = 0 gives ones."""
    if y == 0:
        return torch.ones_like(torch.as_tensor(x, dtype=torch.float64))
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def ell1h_shapiro(h3, stigma, phi, nharms: int):
    """Freire & Wex (2010) orthometric Shapiro delay from the 3rd harmonic
    up (their eq 19): harmonic k contributes (-1)^pwr (2/k) stigma^(k-3)
    basis(k phi), basis sin and pwr (k+1)/2 for odd k, cos and (k+2)/2 for
    even k; each sin(k phi), cos(k phi) evaluated on its own."""
    total = torch.zeros_like(phi)
    for k in range(3, nharms + 1):
        if k % 2 == 0:
            pwr = (k + 2) // 2
            basis = libm.cos(k * phi)
        else:
            pwr = (k + 1) // 2
            basis = libm.sin(k * phi)
        total = total + (-1.0) ** pwr * (2.0 / k) * ipow(stigma, k - 3) * basis
    return -2.0 * h3 * total


def ell1h_delay(p: dict, dt, phi, norb, pb, nharms: int = 3, mode: str = "h3"):
    """ELL1H: ELL1's Roemer delay and the orthometric Shapiro delay, in
    `mode` "h3" (the harmonic series with stigma = 0), "h4" (stigma =
    H4 / H3, NHARMS >= 7) or "stigma" (the exact form, Freire & Wex eq 29:
    -2 H3 / stigma^3 ln(1 + stigma^2 - 2 stigma sin phi))."""
    a1 = _a1(p, dt)
    e1, e2 = _ell1_eps(p, dt)
    delayI = _ell1_inverse(
        a1,
        pb,
        _ell1_dre_da1(phi, e1, e2),
        _ell1_dre_dphi_da1(phi, e1, e2),
        _ell1_dre_dphi2_da1(phi, e1, e2),
    )
    h3 = _get(p, "H3")
    if mode == "stigma":
        stigma = _get(p, "STIGMA")
        lognum = 1.0 + stigma * stigma - 2.0 * stigma * libm.sin(phi)
        delayS = -2.0 * h3 / ipow(stigma, 3) * libm.log(lognum)
    else:
        if mode == "h4":
            stigma = _get(p, "H4") / torch.where(h3 == 0.0, 1.0, h3)
        else:
            stigma = torch.zeros_like(h3)
        delayS = ell1h_shapiro(h3, stigma, phi, nharms)
    return delayI + delayS


def ell1k_delay(p: dict, dt, phi, norb, pb):
    """ELL1K (Susobhanan et al. 2018): the eccentricity vector rotates at
    OMDOT and grows at LNEDOT; the first-order Roemer delay with the extra
    -3 eps1 / 2 term; M2/SINI Shapiro."""
    a1 = _a1(p, dt)
    omdot = _get(p, "OMDOT")
    lnedot = _get(p, "LNEDOT")
    e10, e20 = _get(p, "EPS1"), _get(p, "EPS2")
    cw, sw = libm.cos(omdot * dt), libm.sin(omdot * dt)
    growth = 1.0 + lnedot * dt
    e1 = growth * (e10 * cw + e20 * sw)
    e2 = growth * (e20 * cw - e10 * sw)
    s1 = libm.sin(phi)
    s2, c2 = libm.sin(2 * phi), libm.cos(2 * phi)
    dre_da1 = s1 + 0.5 * (e2 * s2 - e1 * (c2 + 3.0))
    drep_da1 = libm.cos(phi) + e2 * c2 + e1 * s2
    drepp_da1 = -s1 - 2.0 * e2 * s2 + 2.0 * e1 * c2
    delayI = _ell1_inverse(a1, pb, dre_da1, drep_da1, drepp_da1)
    tm2 = _get(p, "M2") * TSUN_S
    delayS = -2.0 * tm2 * libm.log(1.0 - _get(p, "SINI") * s1)
    return delayI + delayS


# --- DDGR: GR-derived post-Keplerian parameters ---------------------------------

#: DDGR's derived parameters, and the inputs they are functions of
DDGR_DERIVED = ("OMDOT", "GAMMA", "PBDOT", "SINI", "DR", "DTH")
DDGR_INPUTS = ("MTOT", "M2", "ECC", "A1", "PB", "XOMDOT")


def ddgr_derived(params: dict) -> dict:
    """DD's post-Keplerian parameters from (MTOT, M2) under GR (Damour &
    Deruelle 1986, Taylor & Weisberg 1989), with n = 2 pi / PB:

        OMDOT = 3 n^(5/3) (Tsun MTOT)^(2/3) / (1 - e^2)   [+ XOMDOT]
        GAMMA = e n^(-1/3) Tsun^(2/3) m2 (m1 + 2 m2) / MTOT^(4/3)
        PBDOT = -(192 pi / 5) n^(5/3) f(e) Tsun^(5/3) m1 m2 / MTOT^(1/3)
        SINI  = n^(2/3) x (Tsun MTOT)^(2/3) / (Tsun m2)
        DR    = n^(2/3) Tsun^(2/3) (3 m1^2 + 6 m1 m2 + 2 m2^2) / MTOT^(4/3)
        DTH   = n^(2/3) Tsun^(2/3) (3.5 m1^2 + 6 m1 m2 + 2 m2^2) / MTOT^(4/3)

    float64 values, shaped as the inputs. Float powers of tensors are
    ``libm.pow``; those of the constant Tsun are Python's (the C
    library's), as in pint_tpu."""
    from pint_tpu_torch.models.base import leaf_to_f64

    mt = leaf_to_f64(params["MTOT"])
    m2 = leaf_to_f64(params["M2"])
    m1 = mt - m2
    e = leaf_to_f64(params.get("ECC", 0.0))
    x = leaf_to_f64(params.get("A1", 0.0))
    pb = leaf_to_f64(params["PB"])
    n = _rdiv(2.0 * math.pi, pb)
    t = TSUN_S
    n23 = libm.pow(n, 2.0 / 3.0)
    omdot = 3.0 * libm.pow(n, 5.0 / 3.0) * libm.pow(t * mt, 2.0 / 3.0) / (1.0 - e * e)
    omdot = omdot + leaf_to_f64(params.get("XOMDOT", 0.0))
    gamma = (e * libm.pow(n, -1.0 / 3.0) * t ** (2.0 / 3.0) * m2 * (m1 + 2.0 * m2)
             / libm.pow(mt, 4.0 / 3.0))
    e2 = e * e
    fe = (1.0 + 73.0 / 24.0 * e2 + 37.0 / 96.0 * (e2 * e2)) / libm.pow(1.0 - e * e, 3.5)
    pbdot = (-192.0 * math.pi / 5.0 * libm.pow(n, 5.0 / 3.0) * fe * t ** (5.0 / 3.0)
             * m1 * m2 / libm.pow(mt, 1.0 / 3.0))
    sini = n23 * x * libm.pow(t * mt, 2.0 / 3.0) / (t * m2)
    m12, m22 = m1 * m1, m2 * m2
    dr = (n23 * t ** (2.0 / 3.0) * (3.0 * m12 + 6.0 * m1 * m2 + 2.0 * m22)
          / libm.pow(mt, 4.0 / 3.0))
    dth = (n23 * t ** (2.0 / 3.0) * (3.5 * m12 + 6.0 * m1 * m2 + 2.0 * m22)
           / libm.pow(mt, 4.0 / 3.0))
    return {"OMDOT": omdot, "GAMMA": gamma, "PBDOT": pbdot, "SINI": sini, "DR": dr,
            "DTH": dth}


# --- DDK: Kopeikin proper-motion + annual-parallax corrections ------------------

#: the light-seconds per AU that pint_tpu's DDK divides the parallax by
#: (engines.py's own literal, not ``pint_tpu_torch.AU_LS``)
DDK_AU_LS = 499.00478384


class _JaxDiv(torch.autograd.Function):
    """a / b with jax's tangent rule for division, ta / b + ((-tb) a) (1 /
    (b b)), where torch's is ta / b - tb ((a / b) / b). DDK's
    A1 sin(kin) / sin(KIN) cancels to ~1e-7 of its terms in the KIN lane, so
    the two rules' last bits there move the KIN design column by ~3e-10;
    kernel K1 takes the same rule (resid_tangent.cu ddiv_jax)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return a / b

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, ta, tb):
        a, b = ctx.saved_tensors
        out = None if ta is None else ta / b
        if tb is not None:
            term = ((-tb) * a) * (1.0 / (b * b))
            out = term if out is None else out + term
        return out if out is not None else torch.zeros_like(a / b)


def _cross(a, b):
    """a x b over the last axis, in jnp.cross's order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _sum3(v):
    """Sum over the last axis (length 3) from zero, in order, as XLA's CPU
    reduction runs it."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def ddk_corrections(params: dict, tensor: dict) -> dict:
    """Per-TOA A1, OM and SINI of DDK's orbital orientation (KIN, KOM)
    (Kopeikin 1995 eq 18, 1996 eqs 10, 16): the proper motion drifts the
    inclination, d(kin) = (-PMRA sin KOM + PMDEC cos KOM) dt, and turns the
    node, d(OM) = (PMRA cos KOM + PMDEC sin KOM) dt / sin KIN; the annual
    parallax, with the site's position r in the (east, north) basis at the
    pulsar, adds -(PX / AU)(r_e sin KOM - r_n cos KOM) to the first and
    -(PX / AU)(r_e cos KOM + r_n sin KOM) / sin KIN to the second. dt is
    t_hi - T0 in plain float64, as in pint_tpu."""
    from pint_tpu_torch.models.base import leaf_to_f64

    if "PMELONG" in params or "PMELAT" in params or "ELONG" in params:
        raise NotImplementedError("DDK requires equatorial astrometry (RAJ/DECJ/PMRA/PMDEC)")
    kin0 = leaf_to_f64(params["KIN"])
    kom = leaf_to_f64(params["KOM"])
    x0 = leaf_to_f64(params["A1"])
    om0 = leaf_to_f64(params.get("OM", 0.0))
    sin_kom, cos_kom = libm.sin(kom), libm.cos(kom)
    dt = tensor["t_hi"] - leaf_to_f64(params.get("T0", 0.0))
    pmra = leaf_to_f64(params.get("PMRA", 0.0))
    pmdec = leaf_to_f64(params.get("PMDEC", 0.0))
    d_kin = (-pmra * sin_kom + pmdec * cos_kom) * dt
    dom = (pmra * cos_kom + pmdec * sin_kom) * dt / libm.sin(kin0)
    px = leaf_to_f64(params.get("PX", 0.0))
    if "_psr_dir" in tensor:
        n_hat = tensor["_psr_dir"]
        zhat = n_hat.new_tensor([0.0, 0.0, 1.0])
        east = _cross(torch.broadcast_to(zhat, n_hat.shape), n_hat)
        east = east / torch.sqrt(_sum3(east * east))[..., None]
        north = _cross(n_hat, east)
        r = tensor["ssb_obs_pos_ls"]
        r_e = _sum3(r * east)
        r_n = _sum3(r * north)
        inv_d = fdiv(px, DDK_AU_LS)
        d_kin = d_kin - inv_d * (r_e * sin_kom - r_n * cos_kom)
        dom = dom - inv_d * (r_e * cos_kom + r_n * sin_kom) / libm.sin(kin0)
    kin_t = kin0 + d_kin
    return {"A1": _JaxDiv.apply(x0 * libm.sin(kin_t), libm.sin(kin0)), "OM": om0 + dom,
            "SINI": libm.sin(kin_t)}

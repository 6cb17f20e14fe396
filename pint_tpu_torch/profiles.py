"""Workload profiles (counterpart of ``pint_tpu/profiles.py``): the parfiles
of the smoke and flagship-shaped workloads, their default scan grids, and the
PTA array (`PTA_PAR_TEMPLATE`, `pta_sky`, `pta_smoke_array`)."""

from __future__ import annotations

import numpy as np

from pint_tpu_torch import TSUN_S

#: minimal single-receiver smoke par (astrometry + spin + DM), the model of
#: the committed prepared-TOA archive (prepared.SMOKE_ARCHIVE)
SMOKE_PAR = """
PSR SMOKE
RAJ 04:37:15.9 1
DECJ -47:15:09.1 1
F0 173.6879489990983 1
F1 -1.728e-15 1
PEPOCH 55000
POSEPOCH 55000
DM 2.64 1
TZRMJD 55000.1
TZRSITE gbt
TZRFRQ 1400
"""

#: NANOGrav-style receivers: (flag value, sub-band frequencies), the epoch
#: structure that binds the EFAC/EQUAD/ECORR masks of FLAGSHIP_SMOKE_PAR
RECEIVERS = (
    ("Rcvr1_2_GUPPI", np.linspace(1150.0, 1850.0, 8)),
    ("Rcvr_800_GUPPI", np.linspace(722.0, 919.0, 8)),
)

#: flagship-shaped smoke par (J0740-like): astrometry with parallax and
#: proper motion, spin, DM + DM1, an ELL1 binary, and EFAC/EQUAD/ECORR bound
#: to the receiver flags; the model of prepared.FLAGSHIP_ARCHIVE
FLAGSHIP_SMOKE_PAR = """
PSR FLAGSMOKE
RAJ 07:40:45.79 1
DECJ 66:20:33.6 1
PMRA -9.9 1
PMDEC -33.0 1
PX 0.4 1
F0 346.531996 1
F1 -1.46e-15 1
PEPOCH 57000
POSEPOCH 57000
DM 14.96 1
DM1 0.0 1
DMEPOCH 57000
BINARY ELL1
PB 4.766944 1
A1 3.9775561 1
TASC 56999.1 1
EPS1 -5.7e-6 1
EPS2 -1.4e-5 1
M2 0.26
SINI 0.99
EFAC -f Rcvr1_2_GUPPI 1.02
EQUAD -f Rcvr1_2_GUPPI 0.01
ECORR -f Rcvr1_2_GUPPI 0.01
EFAC -f Rcvr_800_GUPPI 1.03
EQUAD -f Rcvr_800_GUPPI 0.01
ECORR -f Rcvr_800_GUPPI 0.01
TZRMJD 57000.1
TZRSITE gbt
TZRFRQ 1400
"""

#: eccentric-binary smoke par (B1534-like, pint_tpu's tests/test_binary.py
#: DD_PAR): astrometry, spin, DM and BINARY DD with OMDOT free and a fixed
#: PBDOT, M2 and SINI at the centre of grid_for's (M2, SINI) grid (sin
#: 87.375 deg); 10 free parameters. The model of
#: pint_tpu_torch/data/dd_n16384.tim (prepared.DD_TIM)
DD_SMOKE_PAR = """
PSR FAKE-DD
RAJ 15:37:09.9 1
DECJ 11:55:55.5 1
F0 26.38213 1
F1 -1.7e-15 1
PEPOCH 55500
POSEPOCH 55500
DM 11.6
BINARY DD
PB 0.420737298879 1
A1 3.729464 1
T0 55500.2 1
ECC 0.27367752 1
OM 283.0 1
OMDOT 1.7557 1
PBDOT -1.366e-13
GAMMA 2.056e-3
M2 0.25
SINI 0.99895068
TZRMJD 55500.5
TZRSITE gbt
TZRFRQ 1400
"""


def dd_smoke_par(binary: str = "DD") -> str:
    """DD_SMOKE_PAR under ``BINARY`` BT, DD or DDS; DDS takes SHAPMAX =
    -ln(1 - SINI) in SINI's place (the same orbit)."""
    if binary == "DD":
        return DD_SMOKE_PAR
    par = DD_SMOKE_PAR.replace("BINARY DD\n", f"BINARY {binary}\n")
    if binary == "DDS":
        sini = next(float(ln.split()[1]) for ln in par.splitlines() if ln.startswith("SINI "))
        par = par.replace(f"SINI {sini!r}", f"SHAPMAX {float(-np.log1p(-sini))!r}")
    return par


#: DD_SMOKE_PAR's B1534+12-like orbit under ``BINARY DDGR``: the
#: post-Keplerian lines removed (GR derives OMDOT, GAMMA, PBDOT, SINI, DR and
#: DTH from the masses), B1534+12's MTOT and M2 free; 11 free parameters.
#: The model of pint_tpu_torch/data/ddgr_n16384.tim (prepared.DDGR_TIM)
DDGR_SMOKE_PAR = "".join(
    ln + "\n" for ln in DD_SMOKE_PAR.replace("BINARY DD\n", "BINARY DDGR\n").replace(
        "PSR FAKE-DD\n", "PSR FAKE-DDGR\n").split("\n")
    if ln.split()[:1] not in (["OMDOT"], ["PBDOT"], ["GAMMA"], ["M2"], ["SINI"])
).replace("OM 283.0 1\n", "OM 283.0 1\nMTOT 2.678 1\nM2 1.3455 1\n")

#: a J1713+0747-like DDK binary (equatorial astrometry with proper motion and
#: parallax, Kopeikin's orientation KIN, KOM); 14 free parameters, M2 fixed.
#: The model of pint_tpu_torch/data/ddk_n16384.tim (prepared.DDK_TIM)
DDK_SMOKE_PAR = """
PSR FAKE-DDK
RAJ 17:13:49.5331 1
DECJ 07:47:37.492 1
PMRA 4.92 1
PMDEC -3.92 1
PX 0.85 1
F0 218.81184 1
F1 -4.08e-16 1
PEPOCH 55500
POSEPOCH 55500
DM 15.99
BINARY DDK
PB 67.825 1
A1 32.342 1
T0 55500.1 1
ECC 7.49e-5 1
OM 176.2 1
KIN 71.7 1
KOM 89.0 1
M2 0.29
TZRMJD 55500.5
TZRSITE gbt
TZRFRQ 1400
"""

#: the flagship's Shapiro delay in Freire & Wex's orthometric terms: its M2
#: 0.26 and SINI 0.99 give STIGMA = SINI / (1 + cos i) and H3 = Tsun M2
#: STIGMA^3 (`ell1h_smoke_par`)
_FLAGSHIP_STIGMA = 0.99 / (1.0 + float(np.sqrt(1.0 - 0.99 * 0.99)))
_FLAGSHIP_H3 = TSUN_S * 0.26 * _FLAGSHIP_STIGMA**3


def ell1h_smoke_par(mode: str = "stigma") -> str:
    """FLAGSHIP_SMOKE_PAR under ``BINARY ELL1H`` in `mode`: "stigma" (H3 and
    STIGMA free; the exact form, ELL1's Shapiro delay up to a constant), "h4"
    (H3 and H4 = H3 STIGMA free, 7 harmonics) or "h3" (H3 free, NHARMS 3)."""
    lines = {"stigma": f"H3 {_FLAGSHIP_H3!r} 1\nSTIGMA {_FLAGSHIP_STIGMA!r} 1\n",
             "h4": f"H3 {_FLAGSHIP_H3!r} 1\nH4 {_FLAGSHIP_H3 * _FLAGSHIP_STIGMA!r} 1\n"
                   "NHARMS 7\n",
             "h3": f"H3 {_FLAGSHIP_H3!r} 1\nNHARMS 3\n"}[mode]
    return FLAGSHIP_SMOKE_PAR.replace("BINARY ELL1\n", "BINARY ELL1H\n").replace(
        "M2 0.26\nSINI 0.99\n", lines)


#: the flagship under ``BINARY ELL1K`` with OMDOT and LNEDOT free at 0: to
#: first order in its ~1e-5 eccentricity the same orbit; 16 free
ELL1K_SMOKE_PAR = FLAGSHIP_SMOKE_PAR.replace("BINARY ELL1\n", "BINARY ELL1K\n").replace(
    "EPS2 -1.4e-5 1\n", "EPS2 -1.4e-5 1\nOMDOT 0.0 1\nLNEDOT 0.0 1\n")


def fb_smoke_par() -> str:
    """The flagship with PB replaced by the orbital frequency FB0 = 1 / PB
    (Hz), FB1 and FB2 at 0 (it has no PBDOT); FB0 and FB1 free, 15 free."""
    fb0 = 1.0 / (4.766944 * 86400.0)
    return FLAGSHIP_SMOKE_PAR.replace("PB 4.766944 1\n",
                                      f"FB0 {fb0!r} 1\nFB1 0.0 1\nFB2 0.0\n")


#: the DMX windows of `nanograv_smoke_par` tile this TDB MJD span (the
#: flagship epochs', 56650-57350, with a margin), each window ending
#: `DMX_GAP_DAYS` before the next begins, so that no TOA is in two
DMX_SPAN_MJD = (56649.9, 57350.1)
DMX_GAP_DAYS = 1e-3


def nanograv_smoke_par(n_dmx: int = 64, nf: int = 30, dm_noise: bool = False) -> str:
    """The flagship (J0740-shaped) model with NANOGrav's keys: ecliptic
    astrometry (ELONG, ELAT, PMELONG, PMELAT, PX; ECL IERS2010), F0 and F1,
    a fixed DM with `n_dmx` DMX windows over the flagship's epochs, a JUMP
    on the 800 MHz receiver, FD1-FD3, the flagship's ELL1 binary with M2 and
    SINI fixed at the centre of grid_for's (M2, SINI) grid,
    EFAC/EQUAD/ECORR on both receivers and power-law red noise with `nf`
    frequencies (and DM noise with `dm_noise`). Free: 12 nonlinear + n_dmx
    DMX + 1 JUMP + 3 FD, 80 at the default."""
    lo, hi = DMX_SPAN_MJD
    edges = np.linspace(lo, hi, n_dmx + 1)
    dmx = []
    for i in range(1, n_dmx + 1):
        val = 2e-4 * float(np.sin(0.7 * i + 0.3))
        dmx += [f"DMX_{i:04d} {val!r} 1", f"DMXR1_{i:04d} {float(edges[i - 1])!r}",
                f"DMXR2_{i:04d} {float(edges[i]) - DMX_GAP_DAYS!r}"]
    dm_lines = "TNDMAMP -13.0\nTNDMGAM 2.5\nTNDMC %d\n" % nf if dm_noise else ""
    return f"""
PSR NANOSMOKE
ELONG 103.75912286891041 1
ELAT 44.10250689751051 1
PMELONG -2.8 1
PMELAT -34.1 1
PX 0.4 1
ECL IERS2010
POSEPOCH 57000
F0 346.531996 1
F1 -1.46e-15 1
PEPOCH 57000
DM 14.96
{chr(10).join(dmx)}
JUMP -f Rcvr_800_GUPPI 2.5e-6 1
FD1 1.2e-5 1
FD2 -4.0e-6 1
FD3 1.5e-6 1
BINARY ELL1
PB 4.766944 1
A1 3.9775561 1
TASC 56999.1 1
EPS1 -5.7e-6 1
EPS2 -1.4e-5 1
M2 0.25
SINI 0.9989506813588601
EFAC -f Rcvr1_2_GUPPI 1.02
EQUAD -f Rcvr1_2_GUPPI 0.01
ECORR -f Rcvr1_2_GUPPI 0.01
EFAC -f Rcvr_800_GUPPI 1.03
EQUAD -f Rcvr_800_GUPPI 0.01
ECORR -f Rcvr_800_GUPPI 0.01
TNREDAMP -13.5
TNREDGAM 3.0
TNREDC {nf}
{dm_lines}TZRMJD 57000.1
TZRSITE gbt
TZRFRQ 1400
"""


#: the NANOGrav-shaped model at full width: 80 free parameters, 60 Fourier
#: columns; the model of pint_tpu_torch/data/nanograv_n16384.tim
NANOGRAV_SMOKE_PAR = nanograv_smoke_par()


def wideband_smoke_par(n_dmx: int = 64, nf: int = 30) -> str:
    """`nanograv_smoke_par` in the form NANOGrav publishes for wideband data:
    no ECORR (one TOA per observation and receiver), a DMJUMP on the 800 MHz
    receiver (free, at 0) and fixed DMEFAC and DMEQUAD on both receivers.
    Free: the NANOGrav par's 80 and DMJUMP1 at the defaults."""
    par = "".join(line + "\n" for line in nanograv_smoke_par(n_dmx, nf).splitlines()
                  if not line.startswith("ECORR"))
    return par.replace("TNREDAMP", """DMJUMP -f Rcvr_800_GUPPI 0 1
DMEFAC -f Rcvr1_2_GUPPI 1.1
DMEQUAD -f Rcvr1_2_GUPPI 5e-5
DMEFAC -f Rcvr_800_GUPPI 1.25
DMEQUAD -f Rcvr_800_GUPPI 8e-5
TNREDAMP""")


#: the wideband NANOGrav-shaped model at full width: 81 free parameters, 60
#: Fourier columns; the model of pint_tpu_torch/data/wideband_n16384.tim
WIDEBAND_SMOKE_PAR = wideband_smoke_par()


def spin_grid(model, ftr):
    """3x3 (F0, F1) grid around the model values, +-1 sigma when the fitter
    has uncertainties."""
    f0 = float(model.params["F0"].hi)
    f1 = float(model.params["F1"].hi)
    unc = ftr.result.uncertainties if ftr.result is not None else {}
    s0 = unc.get("F0") or 1e-10
    s1 = unc.get("F1") or 1e-18
    return ("F0", "F1"), (
        np.linspace(f0 - s0, f0 + s0, 3),
        np.linspace(f1 - s1, f1 + s1, 3),
    )


#: the 3x3 grids users scan for each binary's masses or orientation, in
#: internal units, centred on the pars' values, the outer points ~1-2 sigma
#: away at 16,384 TOAs: DDGR's (MTOT, M2) (sigma 3.7e-6 and 1.2e-4 Msun),
#: DDK's (KIN, KOM) (0.19 and 3.6 deg), ELL1H's (H3, STIGMA) (7.3e-9 s and
#: 0.0038), from the port's fits of ddgr_n16384.tim, ddk_n16384.tim and
#: flagship_n16384.tim
BINARY_GRIDS = {
    "MTOT": (("MTOT", "M2"), (np.linspace(2.678 - 5e-6, 2.678 + 5e-6, 3),
                              np.linspace(1.3455 - 1.5e-4, 1.3455 + 1.5e-4, 3))),
    "KIN": (("KIN", "KOM"), (np.deg2rad(np.linspace(71.7 - 0.25, 71.7 + 0.25, 3)),
                             np.deg2rad(np.linspace(89.0 - 4.0, 89.0 + 4.0, 3)))),
    "STIGMA": (("H3", "STIGMA"), (np.linspace(_FLAGSHIP_H3 - 1e-8, _FLAGSHIP_H3 + 1e-8, 3),
                                  np.linspace(_FLAGSHIP_STIGMA - 5e-3, _FLAGSHIP_STIGMA + 5e-3,
                                              3))),
}


def grid_for(model, ftr):
    """The reference 3x3 grid of a model: `BINARY_GRIDS`' for DDGR, DDK and
    ELL1H in its STIGMA mode, (M2, SINI) for a binary with M2 and SINI, else
    the spin grid."""
    for key, grid in BINARY_GRIDS.items():
        if key in model.param_meta:
            return grid
    if "M2" in model.param_meta and "SINI" in model.param_meta:
        return ("M2", "SINI"), (
            np.linspace(0.20, 0.30, 3),
            np.sin(np.deg2rad(np.linspace(86.25, 88.5, 3))),
        )
    return spin_grid(model, ftr)


#: the PTA par: spin, astrometry and DM free, EFAC on one receiver, the
#: pulsar's red noise and the common background (TNGWAMP/TNGWGAM bind
#: models/noise.py PLGWBNoise; a strong amplitude, so that recovery is
#: informative)
PTA_PAR_TEMPLATE = """
PSR {name}
RAJ {raj} 1
DECJ {decj} 1
F0 {f0} 1
F1 -1.46389e-15 1
PEPOCH 57000
POSEPOCH 57000
DM 14.96 1
EFAC -f Rcvr1_2_GUPPI 1.1
TNREDAMP -13.5
TNREDGAM 3.0
TNREDC 5
TNGWAMP -12.8
TNGWGAM 4.33
TNGWC 6
TZRMJD 57000.1
TZRSITE gbt
TZRFRQ 1400
"""

#: fixed sky grid (name, RAJ, DECJ) spread over the sphere so that the pair
#: angles sample the Hellings-Downs curve; an N-pulsar array takes the first
#: N rows
PTA_SKY = (
    ("PTA0000", "04:37:15.9", "-47:15:09.1"),
    ("PTA0001", "07:40:45.79", "66:20:33.6"),
    ("PTA0002", "19:09:47.4", "-37:44:14.4"),
    ("PTA0003", "16:43:38.1", "-12:24:58.7"),
    ("PTA0004", "00:02:58.2", "54:31:25.6"),
    ("PTA0005", "10:12:33.4", "53:07:02.5"),
    ("PTA0006", "21:24:43.8", "-33:58:44.9"),
    ("PTA0007", "13:00:00.0", "05:00:00.0"),
)


def _hms(hours: float) -> str:
    h = int(hours)
    rem = (hours - h) * 60.0
    m = int(rem)
    return f"{h:02d}:{m:02d}:{(rem - m) * 60.0:07.4f}"


def _dms(deg: float) -> str:
    sign = "-" if deg < 0 else ""
    deg = abs(deg)
    d = int(deg)
    rem = (deg - d) * 60.0
    m = int(rem)
    return f"{sign}{d:02d}:{m:02d}:{(rem - m) * 60.0:06.3f}"


def pta_sky(n_pulsars: int):
    """The first `n_pulsars` rows of the array's sky: PTA_SKY, extended past
    8 by an index-only low-discrepancy map (golden-angle RA, an irrational
    stride in sin(dec), |dec| below ~72 deg). Row k depends on k alone."""
    rows = list(PTA_SKY[:n_pulsars])
    golden = np.pi * (3.0 - np.sqrt(5.0))
    for k in range(len(rows), n_pulsars):
        ra_hours = (k * golden / (2.0 * np.pi)) % 1.0 * 24.0
        sin_dec = np.clip(2.0 * ((k * np.sqrt(2.0)) % 1.0) - 1.0, -0.95, 0.95)
        dec_deg = float(np.degrees(np.arcsin(sin_dec)))
        rows.append((f"PTA{k:04d}", _hms(ra_hours), _dms(dec_deg)))
    return tuple(rows)


def pta_smoke_array(n_pulsars: int, ntoas: int, seed: int = 29, gwb_amp: float | None = None,
                    device=None):
    """(models, toas_list): an N-pulsar array on `device` (CUDA unless 'cpu'),
    each pulsar PTA_PAR_TEMPLATE at its PTA_SKY position with ntoas TOAs
    (ntoas / 2 epochs at 1400 and 800 MHz, 0.5 s apart, MJD 56300-57700, 0.5
    us), its own white and red noise drawn from its model, then one
    Hellings-Downs correlated draw of the common background over the array.
    `gwb_amp` sets the injected log10 amplitude only: the models keep the
    template's, and the draws are the same at any amplitude."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import (add_gwb_to_arrays, add_noise_from_model,
                                           make_fake_toas_fromMJDs)

    rng = np.random.default_rng(seed)
    sky = pta_sky(n_pulsars)
    models, toas_list, inject_models = [], [], []
    for k in range(n_pulsars):
        name, raj, decj = sky[k]
        par = PTA_PAR_TEMPLATE.format(name=name, raj=raj, decj=decj, f0=346.531996493 + 0.37 * k)
        if gwb_amp is not None:
            inject_models.append(get_model(par.replace("TNGWAMP -12.8", f"TNGWAMP {gwb_amp}"),
                                           from_text=True, device=device))
        model = get_model(par, from_text=True, device=device)
        n_epochs = max(ntoas // 2, 4)
        mjds = np.repeat(np.linspace(56300.0, 57700.0, n_epochs), 2)
        mjds[1::2] += 0.5 / 86400.0
        freqs = np.where(np.arange(len(mjds)) % 2 == 0, 1400.0, 800.0)
        flags = [{"f": "Rcvr1_2_GUPPI"} for _ in mjds]
        toas = make_fake_toas_fromMJDs(np.sort(mjds), model, obs="gbt", freq_mhz=freqs,
                                       error_us=0.5, flags=flags)
        toas = add_noise_from_model(toas, model, rng=rng, include_common=False)
        models.append(model)
        toas_list.append(toas)
    return models, add_gwb_to_arrays(toas_list, inject_models if gwb_amp is not None else models,
                                     rng=rng)

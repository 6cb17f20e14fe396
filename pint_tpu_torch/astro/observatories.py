"""Observatory registry: site positions, aliases, timescales (counterpart of
``pint_tpu/astro/observatories.py``).

The same built-in table of pulsar observatories (public ITRF geodetic
coordinates, ~10 m), overlaid by the packaged long tail of sites
(``astro/data/observatories_extra.json``, the port's own copy) and by
``PINT_TPU_OBS_JSON`` files, in pint_tpu's order.

A ground site's GCRS position and velocity come from kernel K4
(``device_prepare.site_posvel``) on the card, or from its twin
``erot.itrf_to_gcrs_posvel`` on the CPU. Spacecraft whose position rides
on per-TOA flags (``T2SpacecraftObs``) and orbit-file satellites are not
ported yet (ROADMAP A9) and raise.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass

import numpy as np

log = logging.getLogger("pint_tpu_torch.observatory")


@dataclass
class Observatory:
    name: str
    aliases: tuple[str, ...] = ()
    timescale: str = "utc"

    def site_posvel_gcrs(self, ut1_mjd, tt_jcent, xp_rad, yp_rad, device):
        """(pos [m], vel [m/s]) of the site wrt the geocenter, GCRS axes,
        as numpy (N, 3) arrays."""
        raise NotImplementedError

    @property
    def is_barycenter(self) -> bool:
        return False


@dataclass
class TopoObs(Observatory):
    """Ground observatory at fixed ITRF coordinates."""

    itrf_xyz_m: tuple[float, float, float] = (0.0, 0.0, 0.0)
    tempo_code: str = ""

    def site_posvel_gcrs(self, ut1_mjd, tt_jcent, xp_rad, yp_rad, device):
        from pint_tpu_torch.astro import device_prepare

        return device_prepare.site_posvel(np.asarray(self.itrf_xyz_m), ut1_mjd, tt_jcent,
                                          xp_rad, yp_rad, device)


@dataclass
class GeocenterObs(Observatory):
    def site_posvel_gcrs(self, ut1_mjd, tt_jcent, xp_rad, yp_rad, device):
        n = np.shape(np.atleast_1d(ut1_mjd))[0]
        z = np.zeros((n, 3))
        return z, z.copy()


@dataclass
class T2SpacecraftObs(Observatory):
    """Spacecraft whose GCRS state rides on per-TOA -telx/-tely/-telz flags."""

    needs_flags: bool = True

    def site_posvel_gcrs(self, ut1_mjd, tt_jcent, xp_rad, yp_rad, device):
        raise NotImplementedError(
            f"observatory {self.name!r} takes its position from per-TOA flags "
            "(T2SpacecraftObs): not ported yet, ROADMAP A9")


@dataclass
class BarycenterObs(Observatory):
    """TOAs already referred to the SSB: no site, no Roemer, TDB timescale."""

    timescale: str = "tdb"

    @property
    def is_barycenter(self) -> bool:
        return True

    def site_posvel_gcrs(self, ut1_mjd, tt_jcent, xp_rad, yp_rad, device):
        n = np.shape(np.atleast_1d(ut1_mjd))[0]
        z = np.zeros((n, 3))
        return z, z.copy()


# --- built-in site table --------------------------------------------------------

_BUILTIN = [
    TopoObs("gbt", ("gb", "1"), "utc", (882589.65, -4924872.32, 3943729.348), "1"),
    TopoObs("arecibo", ("ao", "aoutc", "3"), "utc", (2390490.0, -5564764.0, 1994727.0), "3"),
    TopoObs("vla", ("jvla", "c"), "utc", (-1601192.0, -5041981.4, 3554871.4), "c"),
    TopoObs("parkes", ("pks", "7"), "utc", (-4554231.5, 2816759.1, -3454036.3), "7"),
    TopoObs("jodrell", ("jb", "jbo", "8"), "utc", (3822626.04, -154105.65, 5086486.04), "8"),
    TopoObs("effelsberg", ("eff", "g"), "utc", (4033949.5, 486989.4, 4900430.8), "g"),
    TopoObs("nancay", ("ncy", "f"), "utc", (4324165.81, 165927.11, 4670132.83), "f"),
    TopoObs("wsrt", ("i",), "utc", (3828445.659, 445223.6, 5064921.568), "i"),
    TopoObs("chime", ("w",), "utc", (-2059166.313, -3621302.972, 4814304.113), "w"),
    TopoObs("meerkat", ("mk",), "utc", (5109360.133, 2006852.586, -3238948.127), "m"),
    TopoObs("fast", ("z",), "utc", (-1668557.0, 5506838.0, 2744934.0), "z"),
    TopoObs("gmrt", ("gm",), "utc", (1656342.3, 5797947.77, 2073243.16), "r"),
    TopoObs("lofar", ("t",), "utc", (3826577.462, 461022.624, 5064892.526), "t"),
    TopoObs("hobart", ("4",), "utc", (-3950077.96, 2522377.31, -4311667.52), "4"),
    TopoObs("most", ("e",), "utc", (-4483311.64, 2648815.92, -3671909.31), "e"),
    TopoObs("srt", ("s",), "utc", (4865182.766, 791922.689, 4035137.174), "s"),
    TopoObs("gb140", ("a",), "utc", (882872.57, -4924552.73, 3944154.92), "a"),
    TopoObs("gb853", ("b",), "utc", (882315.33, -4925191.41, 3943414.05), "b"),
    TopoObs("lwa1", ("x", "y"), "utc", (-1602196.6, -5042313.47, 3553971.51), "x"),
    TopoObs("effelsberg_asterix", ("effix",), "utc", (4033949.5, 486989.4, 4900430.8), ""),
    TopoObs("atca", ("2",), "utc", (-4752329.7, 2790505.9, -3200483.7), "2"),
    TopoObs("nanshan", ("5", "urumqi"), "utc", (228310.7, 4631922.9, 4367064.1), "5"),
    TopoObs("tid43", ("6", "dss43"), "utc", (-4460894.7, 2682361.5, -3674748.6), "6"),
    # Jodrell Bank outstations / backends share the JBO clock environment;
    # outstation coordinates approximate (~km) — flagged for override files
    TopoObs("darnhall", ("l",), "utc", (3829087.9, -169568.7, 5081082.3), "l"),
    TopoObs("knockin", ("m",), "utc", (3860084.9, -202105.0, 5056568.8), "m"),
    TopoObs("defford", ("n",), "utc", (3923442.6, -146914.3, 5009755.1), "n"),
    TopoObs("tabley", ("k",), "utc", (3817549.9, -163031.4, 5089060.9), "k"),
    TopoObs("jbdfb", ("q",), "utc", (3822626.04, -154105.65, 5086486.04), "q"),
    TopoObs("jbroach", ("r",), "utc", (3822626.04, -154105.65, 5086486.04), "r"),
    TopoObs("mkiii", ("j",), "utc", (3822626.04, -154105.65, 5086486.04), "j"),
    GeocenterObs("geocenter", ("coe", "0", "geo")),
    # geocentered photon events keep their native TT timescale (no
    # UTC leap-second chain): Fermi GEO FT1, geocentered X-ray events
    GeocenterObs("geocenter_tt", ("geo_tt",), "tt"),
    BarycenterObs("barycenter", ("@", "bat", "ssb"), "tdb"),
    T2SpacecraftObs("stl_geo", ("stl",)),
]

_registry: dict[str, Observatory] = {}


def _register(obs: Observatory) -> None:
    _registry[obs.name.lower()] = obs
    for a in obs.aliases:
        _registry.setdefault(a.lower(), obs)


def _load_builtin() -> None:
    if _registry:
        return
    for obs in _BUILTIN:
        _register(obs)
    load_observatories_json(os.path.join(os.path.dirname(__file__), "data",
                                         "observatories_extra.json"))
    for path in os.environ.get("PINT_TPU_OBS_JSON", "").split(":"):
        if path and os.path.exists(path):
            load_observatories_json(path)


def load_observatories_json(path: str) -> None:
    """Overlay a PINT-format observatories.json: the last loaded wins, and a
    TEMPO code resolves unless it would mask an existing name or alias."""
    with open(path) as f:
        data = json.load(f)
    n = 0
    for name, info in data.items():
        xyz = info.get("itrf_xyz")
        if xyz is None:
            continue
        _registry.pop(name.lower(), None)
        obs = TopoObs(
            name.lower(),
            tuple(a.lower() for a in info.get("aliases", [])),
            info.get("timescale", "utc").lower().replace("tt(tai)", "utc")
            .replace("utc(nist)", "utc"),
            tuple(float(v) for v in xyz),
            info.get("tempo_code", ""),
        )
        _register(obs)
        for a in obs.aliases:
            _registry[a.lower()] = obs
        code = str(info.get("tempo_code", "")).lower()
        if code and code not in _registry:
            _registry[code] = obs
        n += 1
    log.debug(f"loaded {n} observatories from {path}")


def get_observatory(name: str) -> Observatory:
    """Look up by name, alias, or tempo code."""
    _load_builtin()
    obs = _registry.get(name.lower())
    if obs is None:
        raise KeyError(
            f"unknown observatory {name!r}; known: "
            f"{sorted(set(o.name for o in _registry.values()))}"
        )
    return obs


def get_satellite_observatory(name: str, orbitfile: str):
    """Orbit-file satellites (Fermi FT2, NICER, ...; pint_tpu's
    astro/satellite_obs.py) are not ported yet."""
    raise NotImplementedError(
        f"satellite observatory {name!r} from {orbitfile}: not ported yet, ROADMAP A9")

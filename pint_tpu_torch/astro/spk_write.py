"""Type-2 SPK kernel writer: export any ephemeris source to a .bsp file
(counterpart of ``pint_tpu/astro/spk_write.py``, host numpy as there).

Counterpart of ``astro/spk.py`` (the DAF/type-2 reader). Uses: snapshot the
built-in N-body-refined ephemeris once into a kernel and serve later runs
through ``PINT_TPU_EPHEM``; ship a reproducible ephemeris beside a timing
analysis; build test kernels. `chebyshev_fit_records` is shared with the
Chebyshev pack builder (``astro/kernel_ephemeris.py``).

Each record holds Chebyshev coefficients fit at Chebyshev-Gauss-Lobatto
nodes of the record interval: near-minimax interpolation of the sampled
trajectory. Format per the NAIF "SPK Required Reading" type-2 layout
(little-endian DAF, the byte order ``astro/spk.py`` reads natively).
"""

from __future__ import annotations

import logging
import struct

import numpy as np

from pint_tpu_torch.astro.spk import NAIF_IDS, RECLEN

log = logging.getLogger("pint_tpu_torch.spk")

J2000_JCENT_S = 36525.0 * 86400.0

__all__ = ["write_spk_type2", "export_spk", "chebyshev_fit_records"]


_CGL_CACHE: dict = {}


def _cgl_nodes(ncoef: int) -> np.ndarray:
    if ncoef not in _CGL_CACHE:
        k = np.arange(ncoef)
        tau = -np.cos(np.pi * k / (ncoef - 1))  # ascending
        # inverse of the Chebyshev-Vandermonde matrix at the CGL nodes:
        # coeffs = Vinv @ samples turns ALL records of a segment into one
        # matmul instead of per-axis-per-record least squares
        V = np.polynomial.chebyshev.chebvander(tau, ncoef - 1)
        _CGL_CACHE[ncoef] = (tau, np.linalg.inv(V))
    return _CGL_CACHE[ncoef]


def chebyshev_fit_records(pos_fn, t0: float, t1: float, intlen: float,
                          ncoef: int) -> tuple[np.ndarray, np.ndarray]:
    """Near-minimax Chebyshev records of a sampled trajectory:
    ``(mids (n,), coef (n, 3, ncoef))`` over uniform records of length
    ``intlen`` covering [t0, t1].

    Every record's CGL node epochs go to ``pos_fn`` in ONE flat call
    (windowed ephemeris backends see the whole request at once), and
    every record's coefficients come from one matmul. Shared by the SPK
    writer below and the tensor-pack compiler
    (astro/kernel_ephemeris.py)."""
    n = int(np.ceil((t1 - t0) / intlen - 1e-9))
    radius = intlen / 2.0
    mids = t0 + intlen * (np.arange(n) + 0.5)
    tau, vinv = _cgl_nodes(ncoef)
    et_nodes = (mids[:, None] + radius * tau[None, :]).ravel()
    xyz = np.asarray(pos_fn(et_nodes)).reshape(n, ncoef, 3)
    return mids, np.einsum("ij,njc->nci", vinv, xyz)  # (n, 3, ncoef)


def write_spk_type2(path: str, segments, comment: str = "pint_tpu_torch export") -> None:
    """Write a little-endian DAF/SPK file of type-2 segments.

    `segments`: list of (target, center, t0, t1, intlen, ncoef, pos_km_fn)
    with times in ET seconds past J2000 and pos_km_fn(et (n,)) -> (n, 3)
    positions of target wrt center in KM (SPK convention; the reader
    converts to meters). Each segment's node epochs are evaluated in ONE
    pos_km_fn call (ephemeris backends that build windowed solutions see
    the whole request at once)."""
    nd, ni = 2, 6
    ss = nd + (ni + 1) // 2  # summary size in doubles
    nseg = len(segments)
    if nseg * ss * 8 + 24 > RECLEN:
        raise ValueError(
            f"{nseg} segments exceed a single summary record "
            f"({(RECLEN - 24) // (ss * 8)} max)"
        )

    rec1 = bytearray(RECLEN)
    rec1[0:8] = b"DAF/SPK "
    struct.pack_into("<i", rec1, 8, nd)
    struct.pack_into("<i", rec1, 12, ni)
    rec1[16:76] = comment.encode()[:60].ljust(60)
    struct.pack_into("<i", rec1, 76, 2)  # FWARD
    struct.pack_into("<i", rec1, 80, 2)  # BWARD
    rec1[88:96] = b"LTL-IEEE"

    seg_words = []
    word = 3 * (RECLEN // 8) + 1  # data start: record 4
    payload = bytearray()
    for target, center, t0, t1, intlen, ncoef, pos_km_fn in segments:
        rsize = 2 + 3 * ncoef
        radius = intlen / 2.0
        # every record's CGL nodes in one flat evaluation, then every
        # record's coefficients in one matmul (near-minimax interpolation)
        mids, chs = chebyshev_fit_records(pos_km_fn, t0, t1, intlen, ncoef)
        n = mids.size
        ia = word
        for k in range(n):
            rec = np.concatenate([[mids[k], radius], chs[k].ravel()])
            payload += rec.astype("<f8").tobytes()
            word += rsize
        trailer = np.array([t0, intlen, rsize, n], "<f8")
        payload += trailer.tobytes()
        word += 4
        fa = word - 1
        seg_words.append((target, center, t0, t0 + n * intlen, ia, fa))

    rec2 = bytearray(RECLEN)
    struct.pack_into("<ddd", rec2, 0, 0.0, 0.0, float(nseg))
    off = 24
    for target, center, t0, t1, ia, fa in seg_words:
        struct.pack_into("<dd", rec2, off, t0, t1)
        struct.pack_into("<6i", rec2, off + 16, target, center, 1, 2, ia, fa)
        off += ss * 8
    rec3 = bytearray(RECLEN)  # name record

    with open(path, "wb") as f:
        f.write(rec1)
        f.write(rec2)
        f.write(rec3)
        f.write(payload)
    log.info(f"wrote type-2 SPK {path}: {nseg} segments")


_DEFAULT_BODIES = ("sun", "mercury", "venus", "emb", "moon", "earth",
                   "mars", "jupiter", "saturn", "uranus", "neptune")


# per-body record length [days]: the fastest angular rates need the
# shortest records for a given ncoef (the JPL DE kernels likewise use
# 4-day lunar and 8-day inner-planet records)
_RECORD_DAYS = {"moon": 4.0, "earth": 4.0, "mercury": 8.0, "venus": 8.0,
                "emb": 8.0, "sun": 8.0, "mars": 16.0, "jupiter": 16.0,
                "saturn": 16.0, "uranus": 16.0, "neptune": 16.0}


def export_spk(path: str, start_mjd: float, end_mjd: float, ephem=None,
               bodies=_DEFAULT_BODIES, record_days: dict | float | None = None,
               ncoef: int = 12, device=None) -> None:
    """Snapshot an ephemeris source into a type-2 SPK kernel.

    `ephem` defaults to the built-in ephemeris (``ephemeris.get_ephemeris()``:
    the N-body-refined window unless ``PINT_TPU_NBODY=0``); any object with
    ``posvel_many(bodies, tdb_jcent, device)`` works, and its serving path
    (the N-body serve K6 on the card, its twin on the CPU) gives the
    positions. Earth and Moon are written relative to the EMB (the DE
    layout ``astro/spk.py`` chains through), everything else relative to
    the SSB. Record lengths follow the JPL-style per-body table (override
    with a float or a dict). Serve the result with ``PINT_TPU_EPHEM=<path>``."""
    from pint_tpu_torch.astro.ephemeris import get_ephemeris
    from pint_tpu_torch.device import resolve_device

    eph = ephem or get_ephemeris("auto")
    dev = resolve_device(device)
    t0 = (start_mjd - 51544.5) * 86400.0
    t1 = (end_mjd - 51544.5) * 86400.0
    if record_days is None:
        rec_d = dict(_RECORD_DAYS)
    elif isinstance(record_days, dict):
        rec_d = {**_RECORD_DAYS, **record_days}
    else:
        rec_d = {b: float(record_days) for b in bodies}

    def pos_km(body, center=None):
        def fn(et):
            T = np.asarray(et) / J2000_JCENT_S
            served = eph.posvel_many((body,) if center is None else (body, center), T, dev)
            p = served[body][0]
            if center is not None:
                p = p - served[center][0]
            return p / 1e3

        return fn

    segments = []
    for b in bodies:
        intlen = rec_d.get(b, 8.0) * 86400.0
        if b in ("earth", "moon"):
            segments.append(
                (NAIF_IDS[b], NAIF_IDS["emb"], t0, t1, intlen, ncoef,
                 pos_km(b, center="emb"))
            )
        else:
            segments.append((NAIF_IDS[b], 0, t0, t1, intlen, ncoef, pos_km(b)))
    write_spk_type2(
        path, segments,
        comment=f"pint_tpu_torch export mjd {start_mjd:.1f}-{end_mjd:.1f}",
    )

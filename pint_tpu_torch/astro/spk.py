"""Reader for JPL SPK (DAF) ephemeris kernels, types 2 and 3 (counterpart of
``pint_tpu/astro/spk.py``, host numpy as there).

A DAF file is a chain of 1024-byte records; the file record carries ND/NI
and the first summary record pointer; each summary holds ND=2 doubles
(segment start/stop epoch, TDB seconds past J2000) and NI=6 ints (target,
center, frame, type, initial and final word addresses). Type-2 segments
store Chebyshev coefficients for position (velocity by differentiating the
polynomial); type-3 store both.

Positions return in meters (kernels store km), ICRS axes, wrt the segment
center; `SPKEphemeris` composes segments to the SSB. It is the host reader
served under ``PINT_TPU_KERNEL_EPHEM=0``, and the reference the Chebyshev
pack (``astro/kernel_ephemeris.py``, kernel K7) is held to.
"""

from __future__ import annotations

import struct

import numpy as np

RECLEN = 1024

NAIF_IDS = {
    "mercury": 1,
    "venus": 2,
    "emb": 3,
    "mars": 4,
    "jupiter": 5,
    "saturn": 6,
    "uranus": 7,
    "neptune": 8,
    "pluto": 9,
    "sun": 10,
    "moon": 301,
    "earth": 399,
    "ssb": 0,
}
# barycenter id -> representative body id for composing chains
_BARY_FALLBACK = {4: 499, 5: 599, 6: 699, 7: 799, 8: 899}


class SPKSegment:
    def __init__(self, daf, target, center, frame, dtype, start_et, stop_et, ia, fa):
        self.daf = daf
        self.target = target
        self.center = center
        self.frame = frame
        self.dtype = dtype
        self.start_et = start_et
        self.stop_et = stop_et
        self.ia = ia
        self.fa = fa
        # segment trailer: INIT, INTLEN, RSIZE, N  (last 4 doubles)
        init, intlen, rsize, n = daf.read_doubles(fa - 3, 4)
        self.init = init
        self.intlen = intlen
        self.rsize = int(rsize)
        self.n = int(n)
        if dtype == 2:
            self.ncoef = (self.rsize - 2) // 3
            self.ncomp = 3
        elif dtype == 3:
            self.ncoef = (self.rsize - 2) // 6
            self.ncomp = 6
        else:
            raise NotImplementedError(f"SPK data type {dtype} not supported")

    def records(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Raw Chebyshev position records: ``(mid (n,), radius (n,),
        coef (n, 3, ncoef))`` in km — the tensor-pack compiler
        (astro/kernel_ephemeris.py) lifts these verbatim, so pack
        evaluation is the same polynomial this reader evaluates."""
        words = self.daf.read_doubles(self.ia, self.n * self.rsize)
        recs = np.asarray(words).reshape(self.n, self.rsize)
        mid = recs[:, 0].copy()
        radius = recs[:, 1].copy()
        coef = recs[:, 2:].reshape(self.n, self.ncomp, self.ncoef)[:, :3, :]
        return mid, radius, coef.copy()

    def posvel(self, et: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(pos[m], vel[m/s]) of target wrt center at TDB sec past J2000."""
        et = np.atleast_1d(np.asarray(et, np.float64))
        if et.size == 0:
            return np.empty((0, 3)), np.empty((0, 3))
        # outside-coverage epochs would silently evaluate the EDGE record's
        # Chebyshev polynomial outside [-1, 1], which diverges fast: raise
        # (1 s slack for row rounding)
        lo, hi = float(np.min(et)), float(np.max(et))
        if lo < self.start_et - 1.0 or hi > self.stop_et + 1.0:
            day = 86400.0
            raise ValueError(
                f"epoch range [{lo / day + 51544.5:.1f}, {hi / day + 51544.5:.1f}] MJD "
                f"outside SPK segment coverage "
                f"[{self.start_et / day + 51544.5:.1f}, "
                f"{self.stop_et / day + 51544.5:.1f}] for target {self.target}"
            )
        idx = np.clip(((et - self.init) / self.intlen).astype(np.int64), 0, self.n - 1)
        pos = np.empty(et.shape + (3,))
        vel = np.empty(et.shape + (3,))
        # group by record for vectorized Chebyshev evaluation
        for rec in np.unique(idx):
            sel = idx == rec
            words = self.daf.read_doubles(self.ia + rec * self.rsize, self.rsize)
            mid, radius = words[0], words[1]
            coeffs = np.asarray(words[2:]).reshape(self.ncomp, self.ncoef)
            tau = (et[sel] - mid) / radius
            T, dT = _cheby_and_deriv(tau, self.ncoef)
            if self.dtype == 2:
                pos[sel] = (T @ coeffs[:3].T) * 1e3
                vel[sel] = (dT @ coeffs[:3].T) / radius * 1e3
            else:
                pos[sel] = (T @ coeffs[:3].T) * 1e3
                vel[sel] = (T @ coeffs[3:].T) * 1e3
        return pos, vel


def _cheby_and_deriv(tau: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    T = np.empty(tau.shape + (n,))
    dT = np.empty_like(T)
    T[..., 0] = 1.0
    dT[..., 0] = 0.0
    if n > 1:
        T[..., 1] = tau
        dT[..., 1] = 1.0
    for k in range(2, n):
        T[..., k] = 2 * tau * T[..., k - 1] - T[..., k - 2]
        dT[..., k] = 2 * T[..., k - 1] + 2 * tau * dT[..., k - 1] - dT[..., k - 2]
    return T, dT


class DAF:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        locidw = self.data[:8].decode("ascii", "replace")
        if not locidw.startswith(("DAF/SPK", "NAIF/DAF")):
            raise ValueError(f"not an SPK kernel: id word {locidw!r}")
        locfmt = self.data[88:96].decode("ascii", "replace")
        self.endian = "<" if "LTL" in locfmt else ">"
        (self.nd,) = struct.unpack_from(self.endian + "i", self.data, 8)
        (self.ni,) = struct.unpack_from(self.endian + "i", self.data, 12)
        (self.fward,) = struct.unpack_from(self.endian + "i", self.data, 76)
        (self.bward,) = struct.unpack_from(self.endian + "i", self.data, 80)

    def read_doubles(self, word_addr: int, n: int) -> np.ndarray:
        """Read n doubles starting at 1-based word address."""
        off = (word_addr - 1) * 8
        return np.frombuffer(self.data, dtype=self.endian + "f8", count=n, offset=off)

    def summaries(self):
        ss = self.nd + (self.ni + 1) // 2  # summary size in doubles
        rec = self.fward
        while rec:
            base = (rec - 1) * RECLEN
            nxt, _prev, nsum = struct.unpack_from(self.endian + "ddd", self.data, base)
            for i in range(int(nsum)):
                off = base + 24 + i * ss * 8
                dbls = struct.unpack_from(self.endian + f"{self.nd}d", self.data, off)
                ints = struct.unpack_from(
                    self.endian + f"{self.ni}i", self.data, off + self.nd * 8
                )
                yield dbls, ints
            rec = int(nxt)


class SPKEphemeris:
    """JPL kernel-backed ephemeris (pos_ssb / posvel_ssb in meters, ICRS,
    host numpy); `posvel_many` is the prepare's surface."""

    def __init__(self, path: str):
        self.daf = DAF(path)
        # long-span/spkmerge kernels split one (target, center) arc across
        # several time-consecutive segments: keep them ALL, time-ordered,
        # and select per epoch (a single-slot dict silently dropped every
        # segment but the last)
        self.segments: dict[tuple[int, int], list[SPKSegment]] = {}
        for (start, stop), (t, c, frame, dtype, ia, fa) in self.daf.summaries():
            seg = SPKSegment(self.daf, t, c, frame, dtype, start, stop, ia, fa)
            self.segments.setdefault((t, c), []).append(seg)
        for segs in self.segments.values():
            segs.sort(key=lambda s: s.start_et)
        self.name = f"spk:{path}"

    def _chain(self, body_id: int) -> list[tuple[list[SPKSegment], float]]:
        """Segment groups composing body -> SSB with signs."""
        chain = []
        cur = body_id
        guard = 0
        while cur != 0 and guard < 5:
            nxt = None
            for (t, c), segs in self.segments.items():
                if t == cur:
                    chain.append((segs, +1.0))
                    nxt = c
                    break
            if nxt is None:
                raise KeyError(f"no segment chain from body {body_id} to SSB")
            cur = nxt
            guard += 1
        return chain

    @staticmethod
    def _group_posvel(segs: list[SPKSegment], et: np.ndarray):
        """Evaluate a time-ordered (target, center) segment group: each
        epoch routes to the segment covering it (1 s slack at joins);
        epochs outside the union coverage raise."""
        if len(segs) == 1:
            return segs[0].posvel(et)
        pos = np.empty(et.shape + (3,))
        vel = np.empty(et.shape + (3,))
        done = np.zeros(et.shape, bool)
        for seg in segs:
            m = (~done & (et >= seg.start_et - 1.0) & (et <= seg.stop_et + 1.0))
            if m.any():
                pos[m], vel[m] = seg.posvel(et[m])
                done |= m
        if not done.all():
            day = 86400.0
            bad = et[~done]
            raise ValueError(
                f"epochs around MJD {bad[0] / day + 51544.5:.1f} outside the "
                f"SPK coverage of target {segs[0].target} "
                f"([{segs[0].start_et / day + 51544.5:.1f}, "
                f"{segs[-1].stop_et / day + 51544.5:.1f}] with possible gaps)"
            )
        return pos, vel

    def posvel_ssb(self, body: str, tdb_jcent: np.ndarray, dt_s: float = 0.0):
        et = np.atleast_1d(np.asarray(tdb_jcent, np.float64)) * 36525.0 * 86400.0
        bid = NAIF_IDS[body]
        pos = 0.0
        vel = 0.0
        for segs, sign in self._chain(bid):
            p, v = self._group_posvel(segs, et)
            pos = pos + sign * p
            vel = vel + sign * v
        return pos, vel

    def pos_ssb(self, body: str, tdb_jcent: np.ndarray) -> np.ndarray:
        return self.posvel_ssb(body, tdb_jcent)[0]

    def posvel_many(self, bodies, tdb_jcent: np.ndarray, device=None) -> dict:
        """{body: (pos [m], vel [m/s])} from the host reader (no kernel: this
        reader is served only when the caller asks for it with
        ``PINT_TPU_KERNEL_EPHEM=0``)."""
        return {b: self.posvel_ssb(b, tdb_jcent) for b in bodies}

"""Chebyshev kernel-pack ephemeris: every source as one tensor pack
(counterpart of ``pint_tpu/astro/kernel_ephemeris.py``).

A JPL SPK type-2/3 kernel (``astro/spk.py``), the analytic series or the
N-body window (``astro/nbody.py``) compiles into one padded pack:

    coef   (body, record, coef, dim)   Chebyshev coefficients [km]
    mid    (body, record)              record midpoints [ET s past J2000]
    init / intlen / nrec  (body,)      record grid metadata

and every query is a gather and a polynomial: the record index from the
uniform record grid, the position from the Chebyshev series summed small to
large, the velocity from the analytic derivative of the same coefficients.
That evaluation is kernel K7 (``csrc/chebyshev_eval.cu``, wrapped by
``device_prepare.chebyshev_eval``); `eval_rows` and `eval_posvel` are its
plain twin, on tensors. The builders (`pack_from_spk`, `pack_from_source`)
are host numpy, as in pint_tpu.

``PINT_TPU_KERNEL_EPHEM``: ``auto`` (the default: a configured SPK kernel
serves through a pack), ``1`` (the analytic or N-body ephemeris also serves
through a pack snapshot), ``0`` (off: ``PINT_TPU_EPHEM`` is read by the host
reader). Ragged per-body record grids pad with zero coefficients (exact: a
zero coefficient adds nothing) and the record index is clipped at
``nrec - 1``, so pad records are never selected.

Packs are cached in memory and on disk under
``$PINT_TPU_CACHE_DIR/torch/ephem_packs`` (the port's own subdirectory), the
full key stored inside each entry; a corrupt entry is moved to
``quarantine/`` beside the cache and rebuilt. pint_tpu records that in its
degradation ledger, which the port does not have yet (ROADMAP A17): the
port logs it. ``measured_fallback_bound_us`` and ``find_pack_for_source``
feed that ledger and wait with it.
"""

from __future__ import annotations

import hashlib
import logging
import os
from dataclasses import dataclass, field

import numpy as np
import torch

log = logging.getLogger("pint_tpu_torch.kernel_ephem")

__all__ = [
    "KernelPack", "KernelEphemeris", "eval_rows", "eval_posvel", "pack_from_spk",
    "pack_from_source", "pack_for_spk_file", "pack_for_analytic", "save_pack", "load_pack",
    "cached_pack", "clear_memory_cache", "enabled", "forced",
]

#: bump when the pack layout or build recipe changes (joins every key)
PACK_VERSION = 1

CENT_S = 36525.0 * 86400.0
DAY_S = 86400.0

#: per-body record length [days] of packs fit here (analytic / N-body sources)
_RECORD_DAYS = {"moon": 4.0, "earth": 4.0, "emb": 4.0, "mercury": 8.0,
                "venus": 8.0, "sun": 8.0, "mars": 16.0, "jupiter": 16.0,
                "saturn": 16.0, "uranus": 16.0, "neptune": 16.0}
_NCOEF_FIT = 14

#: bodies snapshotted into an analytic/N-body pack
_DEFAULT_BODIES = ("sun", "mercury", "venus", "emb", "earth", "moon",
                   "mars", "jupiter", "saturn", "uranus", "neptune")


@dataclass(frozen=True)
class KernelPack:
    """Padded Chebyshev coefficient arrays (numpy) for a set of bodies.

    ``centers[i]`` names what ``bodies[i]``'s coefficients are relative to:
    ``"ssb"`` or another body of the pack (the DE layout keeps Earth and
    Moon relative to the EMB). Pad records and pad coefficients are zero.
    """

    bodies: tuple[str, ...]
    centers: tuple[str, ...]
    coef: np.ndarray    # (B, R, C, 3) float64 [km]
    mid: np.ndarray     # (B, R) float64 [ET s]
    init: np.ndarray    # (B,) float64 [ET s]
    intlen: np.ndarray  # (B,) float64 [s]
    nrec: np.ndarray    # (B,) int32
    source: str = "unknown"
    #: the arrays as tensors, per device (``tensors``)
    _dev: dict = field(default_factory=dict, compare=False, repr=False)

    def row(self, body: str) -> int:
        return self.bodies.index(body)

    def chain_rows(self, body: str) -> tuple[int, ...]:
        """Pack rows summed to compose ``body`` -> SSB (DE-style chain)."""
        rows = []
        cur = body
        guard = 0
        while cur != "ssb":
            if cur not in self.bodies:
                raise KeyError(
                    f"no pack chain from {body!r} to SSB (missing {cur!r}; "
                    f"pack bodies: {self.bodies})")
            i = self.row(cur)
            rows.append(i)
            cur = self.centers[i]
            guard += 1
            if guard > 8:
                raise KeyError(f"pack center chain for {body!r} does not reach the SSB")
        return tuple(rows)

    def span_et(self, body: str) -> tuple[float, float]:
        """Coverage [ET s] of ``body``: the intersection of its chain."""
        lo, hi = -np.inf, np.inf
        for i in self.chain_rows(body):
            lo = max(lo, float(self.init[i]))
            hi = min(hi, float(self.init[i] + self.nrec[i] * self.intlen[i]))
        return lo, hi

    def covers(self, body: str, et: np.ndarray, slack_s: float = 1.0) -> bool:
        lo, hi = self.span_et(body)
        return float(np.min(et)) >= lo - slack_s and float(np.max(et)) <= hi + slack_s

    def check_coverage(self, body: str, et: np.ndarray) -> None:
        """Raise when `et` leaves the body's coverage (a Chebyshev record
        evaluated outside [-1, 1] diverges silently)."""
        if not self.covers(body, et):
            lo, hi = self.span_et(body)
            raise ValueError(
                f"epoch range [{float(np.min(et)) / DAY_S + 51544.5:.1f}, "
                f"{float(np.max(et)) / DAY_S + 51544.5:.1f}] MJD outside "
                f"kernel pack coverage [{lo / DAY_S + 51544.5:.1f}, "
                f"{hi / DAY_S + 51544.5:.1f}] for body {body!r}")

    def tensors(self, device) -> dict:
        """coef, mid, init, intlen (float64) and nrec (int32) on `device`,
        moved there once."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = {
                "coef": torch.as_tensor(np.ascontiguousarray(self.coef), device=device),
                "mid": torch.as_tensor(np.ascontiguousarray(self.mid), device=device),
                "init": torch.as_tensor(self.init, device=device),
                "intlen": torch.as_tensor(self.intlen, device=device),
                "nrec": torch.as_tensor(self.nrec.astype(np.int32), device=device)}
        return self._dev[key]


# --- evaluation: K7's plain twin --------------------------------------------------


def eval_rows(t_et, coef, mid, init, intlen, nrec, rows: tuple[int, ...]):
    """Evaluate pack rows at epochs ``t_et`` [ET s] (float64 (N,) tensor;
    the pack as tensors on its device): per row a ``(pos [km], vel [km/s])``
    pair, (N, 3) each.

    Record index = floor((t - init) / intlen) clipped to [0, nrec - 1];
    the Chebyshev three-term recurrence and its derivative; the terms summed
    small to large (high order first, the constant last) so that the
    rounding is one ulp of the result; the velocity from the derivative on
    the same coefficients. Zero-padded coefficients add exactly nothing.
    """
    C = coef.shape[2]
    out = []
    for b in rows:
        r = torch.clamp(torch.floor((t_et - init[b]) / intlen[b]).long(), min=0)
        r = torch.minimum(r, nrec[b].long() - 1)
        cb = coef[b, r]                       # (N, C, 3)
        radius = intlen[b] * 0.5
        tau = ((t_et - mid[b, r]) / radius)[:, None]
        one = torch.ones_like(tau)
        p_terms, v_terms = [], []
        if C > 1:
            p_terms.append(cb[:, 1, :] * tau)
            v_terms.append(cb[:, 1, :] * one)
        Tm2, Tm1 = one, tau
        dTm2, dTm1 = torch.zeros_like(tau), one
        for k in range(2, C):
            Tk = 2.0 * tau * Tm1 - Tm2
            dTk = 2.0 * Tm1 + 2.0 * tau * dTm1 - dTm2
            p_terms.append(cb[:, k, :] * Tk)
            v_terms.append(cb[:, k, :] * dTk)
            Tm2, Tm1 = Tm1, Tk
            dTm2, dTm1 = dTm1, dTk
        pos_tail = torch.zeros_like(cb[:, 0, :])
        vel = torch.zeros_like(cb[:, 0, :])
        for pt, vt in zip(reversed(p_terms), reversed(v_terms)):
            pos_tail = pos_tail + pt
            vel = vel + vt
        out.append((cb[:, 0, :] + pos_tail, vel / radius))
    return out


def eval_posvel(pack: KernelPack, body: str, t_et: torch.Tensor):
    """Composed ``(pos [m], vel [m/s])`` of ``body`` wrt SSB: the chain's rows
    summed in order, then x 1e3."""
    rows = pack.chain_rows(body)
    w = pack.tensors(t_et.device)
    parts = eval_rows(t_et, w["coef"], w["mid"], w["init"], w["intlen"], w["nrec"], rows)
    pos = sum(p for p, _ in parts)
    vel = sum(v for _, v in parts)
    return pos * 1e3, vel * 1e3


# --- builders (host) ----------------------------------------------------------------


def pack_from_spk(path: str) -> KernelPack:
    """Compile an SPK type-2/3 kernel's raw records into a pack, verbatim (no
    refitting): the pack evaluates the polynomial the host reader does.
    Raises when a (target, center) arc is not one uniform record grid."""
    from pint_tpu_torch.astro.spk import NAIF_IDS, SPKEphemeris

    names = {v: k for k, v in NAIF_IDS.items()}
    eph = SPKEphemeris(path)
    bodies: list[str] = []
    centers: list[str] = []
    per_body: list[tuple[np.ndarray, np.ndarray, float, float]] = []
    for (t, c), segs in eph.segments.items():
        if t not in names or c not in names:
            continue  # an unnamed minor body: not servable through this API
        intlen = segs[0].intlen
        if any(abs(s.intlen - intlen) > 1e-6 for s in segs):
            raise ValueError(
                f"SPK target {t} splits across segments with unequal "
                f"record lengths; pack compilation needs one uniform grid")
        mids, coefs = [], []
        expect = segs[0].init
        for s in sorted(segs, key=lambda s: s.init):
            if abs(s.init - expect) > 1e-3:
                raise ValueError(
                    f"SPK target {t} has a coverage gap at ET {expect}; "
                    "pack compilation needs contiguous records")
            m, _radius, cf = s.records()
            mids.append(m)
            coefs.append(cf)
            expect = s.init + s.n * s.intlen
        bodies.append(names[t])
        centers.append(names[c])
        per_body.append((np.concatenate(mids), np.concatenate(coefs), segs[0].init, intlen))
    if not bodies:
        raise ValueError(f"no packable segments in {path}")
    return _assemble(tuple(bodies), tuple(centers), per_body,
                     source=f"spk:{os.path.abspath(path)}")


def pack_from_source(start_mjd: float, end_mjd: float, pos_m_many,
                     bodies: tuple[str, ...] = _DEFAULT_BODIES,
                     record_days: dict | None = None, ncoef: int = _NCOEF_FIT,
                     source: str = "analytic") -> KernelPack:
    """Fit a pack from a sampling callable ``pos_m_many(bodies, T_jcent) ->
    {body: pos_m}`` (numpy), bodies that share a record length sampled in
    one call. Earth/Moon are stored relative to the EMB, the DE layout."""
    from pint_tpu_torch.astro.spk_write import chebyshev_fit_records

    rec_d = dict(_RECORD_DAYS)
    if record_days:
        rec_d.update(record_days)
    t0 = (start_mjd - 51544.5) * DAY_S
    t1 = (end_mjd - 51544.5) * DAY_S

    groups: dict[float, list[str]] = {}
    for b in bodies:
        groups.setdefault(rec_d.get(b, 8.0), []).append(b)
    per_body: dict[str, tuple] = {}
    for days, group in sorted(groups.items()):
        # snap the record length so that the grid divides the span exactly
        n = max(int(round((t1 - t0) / (days * DAY_S))), 1)
        intlen = (t1 - t0) / n
        samples: dict[str, np.ndarray] = {}

        def group_fn(et, _group=tuple(group)):
            T = np.asarray(et) / CENT_S
            sampled = pos_m_many(_group, T)
            samples.update({b: np.asarray(sampled[b]) / 1e3 for b in _group})
            return samples[_group[0]]

        mids, coef0 = chebyshev_fit_records(group_fn, t0, t1, intlen, ncoef)
        fits = {group[0]: coef0}
        for b in group[1:]:
            _, cf = chebyshev_fit_records(lambda et, _b=b: samples[_b], t0, t1, intlen, ncoef)
            fits[b] = cf
        for b in group:
            per_body[b] = (mids, fits[b], t0, intlen)

    centers = ["emb" if b in ("earth", "moon") and "emb" in bodies else "ssb" for b in bodies]
    rows = []
    for b, c in zip(bodies, centers):
        mids, cf, init, intlen = per_body[b]
        if c != "ssb":
            cf = cf - per_body[c][1]
            if per_body[c][3] != intlen:
                raise ValueError(f"{b} and its center {c} must share a record length")
        rows.append((mids, cf, init, intlen))
    return _assemble(tuple(bodies), tuple(centers), rows, source=source)


def _assemble(bodies, centers, per_body, source: str) -> KernelPack:
    """Pad ragged per-body (mids, coef (n,3,ncoef), init, intlen) rows into
    the dense (B, R, C, 3) arrays; pads are zero."""
    B = len(bodies)
    R = max(m.size for m, _, _, _ in per_body)
    C = max(cf.shape[2] for _, cf, _, _ in per_body)
    coef = np.zeros((B, R, C, 3))
    mid = np.zeros((B, R))
    init = np.zeros(B)
    intlen = np.zeros(B)
    nrec = np.zeros(B, np.int32)
    for i, (m, cf, i0, dt) in enumerate(per_body):
        n, _, nc = cf.shape
        coef[i, :n, :nc, :] = np.transpose(cf, (0, 2, 1))
        mid[i, :n] = m
        init[i] = i0
        intlen[i] = dt
        nrec[i] = n
    return KernelPack(tuple(bodies), tuple(centers), coef, mid, init, intlen, nrec,
                      source=source)


# --- persistence and the content-hash cache -----------------------------------------


def save_pack(path: str, pack: KernelPack, key: str = "") -> None:
    """Write a pack (npz, bitwise exact), atomically replacing `path`."""
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez(
        tmp, coef=pack.coef, mid=pack.mid, init=pack.init,
        intlen=pack.intlen, nrec=pack.nrec,
        bodies=np.array(pack.bodies), centers=np.array(pack.centers),
        source=np.array(pack.source), key=np.array(key),
        version=np.array(PACK_VERSION),
    )
    os.replace(tmp, path)


def load_pack(path: str) -> tuple[KernelPack, str]:
    """(pack, its stored full key); raises on any corruption or version drift."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != PACK_VERSION:
            raise ValueError(f"pack version {int(z['version'])} != {PACK_VERSION}")
        pack = KernelPack(
            tuple(str(b) for b in z["bodies"]), tuple(str(c) for c in z["centers"]),
            z["coef"], z["mid"], z["init"], z["intlen"], z["nrec"].astype(np.int32),
            source=str(z["source"]),
        )
        return pack, str(z["key"])


def _pack_cache_dir():
    from pint_tpu_torch.astro.nbody import cache_root

    return cache_root() / "ephem_packs"


#: in-memory packs by full content key (a pack is immutable)
_MEM: dict[str, KernelPack] = {}


def clear_memory_cache() -> None:
    """Drop the in-memory packs (disk entries stay)."""
    _MEM.clear()


def cached_pack(key: str, build) -> KernelPack:
    """A pack from the content-hash cache, or built and stored. The full key
    is stored in the entry and compared on load (a hash collision is a miss);
    a corrupt entry is quarantined beside the cache, logged, and rebuilt;
    ``PINT_TPU_KERNEL_EPHEM_KEEP`` entries are kept. A build runs in the
    ``kernel_build`` stage (``ephemeris.build_stage``)."""
    from pint_tpu_torch.astro.ephemeris import build_stage

    pack = _MEM.get(key)
    if pack is not None:
        return pack
    path = None
    if os.environ.get("PINT_TPU_KERNEL_EPHEM_CACHE", "1") != "0":
        d = _pack_cache_dir()
        path = d / f"pack-{hashlib.sha256(key.encode()).hexdigest()[:24]}.npz"
        if path.exists():
            try:
                pack, stored = load_pack(str(path))
                if stored == key:
                    log.info(f"kernel pack cache hit {path.name}")
                    _MEM[key] = pack
                    return pack
                log.info(f"kernel pack key mismatch for {path.name}; rebuilding")
            except Exception as e:  # noqa: BLE001 — a corrupt pack is quarantined and rebuilt
                qdir = d / "quarantine"
                try:
                    os.makedirs(qdir, exist_ok=True)
                    os.replace(path, qdir / path.name)
                except OSError:
                    pass
                log.warning(f"corrupt kernel ephemeris pack {path.name} quarantined ({e}); "
                            "rebuilding from source")
    with build_stage("kernel_build"):
        pack = build()
    _MEM[key] = pack
    if path is not None:
        try:
            os.makedirs(path.parent, exist_ok=True)
            save_pack(str(path), pack, key=key)
            keep = int(os.environ.get("PINT_TPU_KERNEL_EPHEM_KEEP", "8"))
            entries = sorted(path.parent.glob("pack-*.npz"), key=os.path.getmtime)
            for old in entries[:-keep] if keep > 0 else []:
                old.unlink(missing_ok=True)
        except OSError as e:  # a write failure costs the next run a rebuild
            log.warning(f"could not write kernel pack cache: {e}")
    return pack


# --- knob semantics ------------------------------------------------------------------


def enabled() -> bool:
    """True when a configured SPK kernel serves through a pack
    (``PINT_TPU_KERNEL_EPHEM`` auto or 1)."""
    return os.environ.get("PINT_TPU_KERNEL_EPHEM", "auto") != "0"


def forced() -> bool:
    """True when the analytic/N-body ephemeris also serves through a pack
    snapshot (``PINT_TPU_KERNEL_EPHEM=1``)."""
    return os.environ.get("PINT_TPU_KERNEL_EPHEM", "auto") == "1"


# --- source-specific keys ---------------------------------------------------------


def pack_for_spk_file(path: str) -> KernelPack:
    """The pack of an SPK kernel file, keyed on (path, size, mtime)."""
    st = os.stat(path)
    key = f"v{PACK_VERSION}-spk-{os.path.abspath(path)}-{st.st_size}-{st.st_mtime:.0f}"
    return cached_pack(key, lambda: pack_from_spk(path))


def pack_for_analytic(eph, tdb_jcent) -> KernelPack:
    """Pack snapshot of the built-in ephemeris's serving path (the N-body
    window, or the analytic series under ``PINT_TPU_NBODY=0``) over the
    quantized window covering the request, the window's own quantization.
    The key holds the window, the layout, the N-body configuration and probe
    positions of the analytic theory, as pint_tpu's does: a warm cache
    serves the pack without building the window. The window is sampled
    through K6's CPU twin (the series through K5's), so a pack is the same
    whichever device serves it."""
    from pint_tpu_torch.astro.ephemeris import quantize_nbody_window
    from pint_tpu_torch.astro.nbody import _ATOL, _BODIES, _GMS, _RTOL, refuse_comb

    T = np.asarray(tdb_jcent, np.float64)
    t0_q, span_yr = quantize_nbody_window(float(np.min(T)), float(np.max(T)))
    nbody_on = os.environ.get("PINT_TPU_NBODY", "1") != "0"
    if nbody_on:
        refuse_comb()  # before a warm cache could serve a pack without the comb
    memo = eph._pack_key_memo
    mkey = (round(t0_q, 10), span_yr, nbody_on)
    key = memo.get(mkey)
    if key is None:
        probe = np.concatenate([
            np.asarray(eph.pos_ssb(b, np.array([t0_q - 0.05, t0_q, t0_q + 0.05]))).ravel()
            for b in ("earth", "moon", "jupiter", "uranus", "neptune")
        ]).round(3)
        key_src = repr((
            PACK_VERSION, round(t0_q, 10), span_yr, _DEFAULT_BODIES,
            sorted(_RECORD_DAYS.items()), _NCOEF_FIT, nbody_on,
            _BODIES, _GMS.tobytes(), _RTOL, _ATOL, probe.tobytes(),
        ))
        key = memo[mkey] = (f"v{PACK_VERSION}-analytic-"
                            f"{hashlib.sha256(key_src.encode()).hexdigest()[:24]}")

    def build():
        half_mjd = span_yr * 365.25 / 2.0
        mid_mjd = t0_q * 36525.0 + 51544.5
        if nbody_on:
            nb = eph._nbody_window(t0_q, span_yr)

            def pos_m_many(bodies, T):
                return {b: nb.posvel_host(b, T)[0] for b in bodies}
        else:
            pos_m_many = eph.pos_ssb_many
        return pack_from_source(mid_mjd - half_mjd, mid_mjd + half_mjd, pos_m_many,
                                source=f"analytic-nb{int(nbody_on)}")

    return cached_pack(key, build)


# --- serving class --------------------------------------------------------------------


class KernelEphemeris:
    """Pack-backed ephemeris: `posvel_many` serves through K7 on the card
    (its twin on the CPU); epochs outside the pack's coverage raise."""

    def __init__(self, pack: KernelPack):
        self.pack = pack
        self.name = f"kernelpack:{pack.source}"

    def posvel_many(self, bodies, tdb_jcent: np.ndarray, device=None) -> dict:
        """{body: (pos [m], vel [m/s])} as numpy (N, 3) each."""
        from pint_tpu_torch.astro import device_prepare

        return device_prepare.posvel_ssb_many(self, tuple(bodies), tdb_jcent, device)

"""Residuals: phase and time residuals, pulse numbers, chi^2 (counterpart of
``pint_tpu/residuals.py``), and kernel K1.

K1 (`resid_tangent`, csrc/resid_tangent.cu) evaluates the whole forward
chain per TOA (equatorial or ecliptic astrometry, solar Shapiro, DM, DMX,
FD, an ELL1-family binary (ELL1, ELL1H, ELL1K) or a Kepler-orbit one (BT,
DD, DDS, DDGR, DDK), with PB or the FB orbital-frequency form, spindown,
phase JUMPs): pulse number, fractional phase, spin frequency and the barycentric
radio frequency (which kernel K8 reads), plus forward-mode tangents of the
fractional phase and the frequency for up to `MAX_LANES` free parameters,
eight lanes per block (more lanes are more blocks in the same launch, each
recomputing the primal). It replaces the TPU's `resid` program and the
jax.linearize design columns of the fit and grid steps. Its plain-torch twin
`resid_tangent_plain` runs ``TimingModel.phase_and_freq`` and takes the
tangents with torch.func.jvp, as the JAX package does with jax.linearize.

`resid_tangent` launches the kernel for CUDA tensors and takes the twin only
for CPU tensors. Fitters and grids reach it through `phase_resid_tangents`
in this module.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pint_tpu_torch import AU_LS, DMCONST, TSUN_S
from pint_tpu_torch.device import require_f64
from pint_tpu_torch.models.base import leaf_to_f64
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.ops.dd import DD, dd_add_fp, dd_rint, dd_to_float

#: tangent lane codes of csrc/resid_tangent.cu (its L_* enum, in the same
#: order); F<k> is 16 + k, DM<k> 32 + k, FD<k> 64 + k, the m-th JUMP 80 + m,
#: the DMX of window column j 128 + j (`_lane`, from the model), FB<k>
#: 256 + k; the ecliptic angles share the equatorial ones' lanes
LANE_CODES = {"RAJ": 0, "DECJ": 1, "PMRA": 2, "PMDEC": 3, "PX": 4,
              "ELONG": 0, "ELAT": 1, "PMELONG": 2, "PMELAT": 3,
              "PB": 5, "A1": 6, "TASC": 7, "EPS1": 8, "EPS2": 9,
              "T0": 48, "ECC": 49, "OM": 50, "OMDOT": 51, "EDOT": 52, "GAMMA": 53,
              "PBDOT": 54, "A1DOT": 55, "M2": 56, "SINI": 57, "SHAPMAX": 58, "DR": 59,
              "DTH": 60, "A0": 61, "B0": 62,
              "H3": 264, "H4": 265, "STIGMA": 266, "LNEDOT": 267, "KIN": 268, "KOM": 269,
              "MTOT": 270, "XOMDOT": 271, "XPBDOT": 272}
L_FD0, L_JUMP0, L_DMX0, L_FB0 = 64, 80, 128, 256
MAX_FD, MAX_JUMP, MAX_DMX, MAX_FB = 15, 48, 128, 8
#: the most orthometric harmonics K1 evaluates (ELL1H's NHARMS)
MAX_NHARMS = 20
MAX_LANES = 128
#: lanes one block carries (resid_tangent.cu KCHUNK)
LANE_CHUNK = 8


def _lane(name: str, model=None) -> int | None:
    if name in LANE_CODES:
        return LANE_CODES[name]
    if name.startswith("F") and name[1:].isdigit():
        return 16 + int(name[1:])
    if name == "DM":
        return 32
    if name.startswith("DM") and name[2:].isdigit() and 0 < int(name[2:]) < 16:
        return 32 + int(name[2:])
    if name.startswith("FD") and name[2:].isdigit() and 0 < int(name[2:]) <= MAX_FD:
        return L_FD0 + int(name[2:])
    if name.startswith("FB") and name[2:].isdigit() and int(name[2:]) < MAX_FB:
        return L_FB0 + int(name[2:])
    if model is not None and "PhaseJump" in model:
        jumps = [mp.name for mp in model["PhaseJump"].mask_params]
        if name in jumps and jumps.index(name) < MAX_JUMP:
            return L_JUMP0 + jumps.index(name)
    if model is not None and "DispersionDMX" in model:
        dmx = model["DispersionDMX"].linear_param_names()
        if name in dmx and dmx.index(name) < MAX_DMX:
            return L_DMX0 + dmx.index(name)
    return None


def lane_names(names, model=None) -> tuple[str, ...]:
    """The names among `names` that have a tangent lane in K1, in order
    (the JUMP and DMX lanes are the `model`'s)."""
    return tuple(n for n in names if _lane(n, model) is not None)


def lane_code(name: str, model=None) -> int:
    code = _lane(name, model)
    if code is not None:
        return code
    raise NotImplementedError(
        f"{name} as a fit parameter has no tangent lane in kernel K1 "
        f"(csrc/resid_tangent.cu); lanes exist for {', '.join(LANE_CODES)}, F<k>, DM<k>, "
        f"FD<k>, FB0-FB{MAX_FB - 1}, JUMPs and DMX")


class ResidTangent(NamedTuple):
    """K1 outputs over B parameter sets, N data rows (N_rows with the TZR
    row) and k lanes."""

    pn: torch.Tensor     # (B, N) pulse numbers
    frac: torch.Tensor   # (B, N) fractional phase, turns
    f: torch.Tensor      # (B, N) spin frequency, Hz
    dfrac: torch.Tensor  # (B, k, N) d frac / d lane
    df: torch.Tensor     # (B, k, N) d f / d lane
    fb: torch.Tensor     # (B, N_rows) barycentric radio frequency, MHz


def batch_size(params: dict) -> int:
    """B of a parameter dict whose leaves are scalars (B = 1) or (B,)."""
    shapes = {tuple((v.hi if isinstance(v, DD) else v).shape) for v in params.values()}
    sizes = {s[0] for s in shapes if len(s) == 1}
    if len(sizes) > 1 or any(len(s) > 1 for s in shapes):
        raise ValueError(f"parameter leaves must be scalars or one (B,) shape; got {shapes}")
    return sizes.pop() if sizes else 1


def take(params: dict, b: int) -> dict:
    """The b-th parameter set of a batched dict (scalars pass through)."""
    def one(v):
        return v[b] if v.dim() else v
    return {k: DD(one(v.hi), one(v.lo)) if isinstance(v, DD) else one(v)
            for k, v in params.items()}


def _apply_lanes(params: dict, lanes: tuple, delta: torch.Tensor) -> dict:
    new = dict(params)
    for i, n in enumerate(lanes):
        v = params[n]
        new[n] = dd_add_fp(v, delta[i]) if isinstance(v, DD) else v + delta[i]
    return new


def barycentric_freq(model: TimingModel, params: dict, tensor: dict) -> torch.Tensor:
    """The radio frequency in the SSB frame at every row (the TZR row too)."""
    from pint_tpu_torch.models.dispersion import barycentric_radio_freq

    return barycentric_radio_freq(model._with_context(params, tensor))


def pulse_columns(model: TimingModel, tensor: dict):
    """(delta_pn, track_pn) over the data rows, each None where the tensor
    lacks its column (``TimingModel.build_tensor``)."""
    n_out = tensor["t_hi"].shape[0] - int(model.has_abs_phase)
    return tuple(tensor[k][:n_out] if k in tensor else None for k in ("delta_pn", "track_pn"))


def resid_tangent_plain(model: TimingModel, params: dict, tensor: dict,
                        lanes: tuple = ()) -> ResidTangent:
    """Twin of K1: the model's forward chain in plain torch, tangents by
    torch.func.jvp over the lane parameters (one jvp per lane, vmapped).
    The pulse offsets ``delta_pn`` are added to the phase before the
    nearest pulse is taken; with ``track_pn`` the residual is the phase
    minus those pulse numbers (pint_tpu's ``phase_residual_frac``)."""
    k = len(lanes)
    dpn, track = pulse_columns(model, tensor)
    outs = []
    for b in range(batch_size(params)):
        pb = take(params, b)

        def fwd(delta):
            ph, f = model.phase_and_freq(_apply_lanes(pb, lanes, delta), tensor)
            if dpn is not None:
                ph = dd_add_fp(ph, dpn)
            if track is not None:
                return dd_to_float(dd_add_fp(ph, -track)), f, track
            pn, rem = dd_rint(ph)
            return dd_to_float(rem), f, pn

        dev = tensor["t_hi"].device
        z = torch.zeros(k, dtype=torch.float64, device=dev)
        frac, f, pn = fwd(z)
        if k:
            def tangent(v):
                return torch.func.jvp(lambda d: fwd(d)[:2], (z,), (v,))[1]

            dfrac, df = torch.func.vmap(tangent)(torch.eye(k, dtype=torch.float64, device=dev))
        else:
            dfrac = df = frac.new_zeros((0, frac.shape[-1]))
        fb = torch.broadcast_to(barycentric_freq(model, pb, tensor), tensor["t_hi"].shape)
        outs.append((pn, frac, f, dfrac, df, fb))
    return ResidTangent(*(torch.stack(x) for x in zip(*outs)))


# --- K1 on the card ------------------------------------------------------------

_ROW_KEYS = ("t_hi", "t_lo", "freq_mhz", "ssb_obs_pos_ls", "ssb_obs_vel_ls", "obs_sun_pos_ls")
# the binary block of the parameter row, after RAJ DECJ PMRA PMDEC PX (or
# their ecliptic counterparts) POSEPOCH DMEPOCH PEPOCH_hi PEPOCH_lo
# (resid_tangent.cu P_PB_HI ...): PB and the epoch (TASC or T0) as dd
# pairs, the float64 values of `_BIN_F64`, FB0 as a dd pair and FB1-FB7,
# `_BIN_EXT`, and DDGR's 6 x 6 Jacobian. SINI of DDS is 1 - exp(-SHAPMAX),
# and DSINI its derivative, the SHAPMAX lane's seed; DDGR's OMDOT, GAMMA,
# PBDOT, SINI, DR and DTH are `engines.ddgr_derived` of each set, and JAC
# their derivatives in (MTOT, M2, ECC, A1, PB, XOMDOT), the seeds of those
# lanes
_BIN_F64 = ("A1", "A1DOT", "EPS1", "EPS2", "EPS1DOT", "EPS2DOT", "PBDOT", "XPBDOT",
            "M2", "SINI", "ECC", "EDOT", "OM", "OMDOT", "GAMMA", "DR", "DTH", "A0", "B0",
            "DSINI")
_BIN_EXT = ("H3", "H4", "STIGMA", "LNEDOT", "KIN", "KOM")
#: binary kinds of the kernel (resid_tangent.cu BIN) and each kind's models
#: (Config::bin_model)
BIN_NONE, BIN_ELL1, BIN_KEPLER = 0, 1, 2
KEPLER_MODELS = {"BT": 0, "DD": 1, "DDS": 1, "DDGR": 2, "DDK": 3}
ELL1_MODELS = {"ELL1": 0, "ELL1H": 1, "ELL1K": 2}
#: ELL1H's Shapiro modes (Config::h_mode)
H_MODES = {"h3": 0, "h4": 1, "stigma": 2}


class Structure(NamedTuple):
    """The kernel's view of a model's components."""

    has_ast: bool
    bin_kind: int   # BIN_NONE, BIN_ELL1 or BIN_KEPLER
    bin_model: int  # the kind's model: KEPLER_MODELS or ELL1_MODELS
    nd: int
    nf: int
    ecliptic: bool  # the astrometry is AstrometryEcliptic
    n_dmx: int      # DMX windows (0: no DispersionDMX)
    n_fd: int       # FD terms (0: no FD)
    n_jump: int     # phase JUMPs (0: no PhaseJump)
    n_fb: int       # FB terms (0: the PB form)
    h_mode: int     # ELL1H: H_MODES
    nharms: int     # ELL1H: the harmonics of its Shapiro series


def _structure(model: TimingModel) -> Structure:
    """The components of `model` as kernel K1 sees them (noise components do
    not enter the phase)."""
    binaries = {**{f"Binary{m}": BIN_ELL1 for m in ELL1_MODELS},
                **{f"Binary{m}": BIN_KEPLER for m in KEPLER_MODELS}}
    allowed = {"AstrometryEquatorial", "AstrometryEcliptic", "SolarSystemShapiro",
               "DispersionDM", "DispersionDMX", "FD", "Spindown", "PhaseJump", "AbsPhase",
               "ScaleToaError", "EcorrNoise", "PLRedNoise", "PLDMNoise", "PLGWBNoise",
               # the model DM's offsets and the DM sigmas' scaling: no delay
               "DispersionJump", "ScaleDmError", *binaries}
    extra = set(model.component_names) - allowed
    if extra:
        raise NotImplementedError(f"kernel K1 does not evaluate {sorted(extra)}")
    if "Spindown" not in model:
        raise NotImplementedError("kernel K1 needs a Spindown component")
    nd = model["DispersionDM"].num_terms if "DispersionDM" in model else 0
    kind, flag, n_fb, h_mode, nharms = BIN_NONE, 0, 0, 0, 0
    for comp in model.components:
        if comp.name in binaries:
            kind = binaries[comp.name]
            flag = {**ELL1_MODELS, **KEPLER_MODELS}[comp.model_name]
            n_fb = comp.fb_terms
            if comp.model_name == "ELL1H":
                h_mode, nharms = H_MODES[comp.h_mode], comp.nharms
    n_dmx = len(model["DispersionDMX"].windows) if "DispersionDMX" in model else 0
    n_fd = model["FD"].num_terms if "FD" in model else 0
    n_jump = len(model["PhaseJump"].mask_params) if "PhaseJump" in model else 0
    if n_fd > MAX_FD:
        raise NotImplementedError(f"kernel K1 takes at most {MAX_FD} FD terms; got {n_fd}")
    if n_fb > MAX_FB:
        raise NotImplementedError(
            f"kernel K1 takes at most {MAX_FB} FB terms (FB0-FB{MAX_FB - 1}); got {n_fb}")
    if nharms > MAX_NHARMS:
        raise NotImplementedError(
            f"kernel K1 takes at most {MAX_NHARMS} ELL1H harmonics (NHARMS); got {nharms}")
    return Structure(model.astrometry is not None, kind, flag, nd, model["Spindown"].num_terms,
                     "AstrometryEcliptic" in model, n_dmx, n_fd, n_jump, n_fb, h_mode, nharms)


def ddgr_jacobian(params: dict) -> tuple[dict, torch.Tensor]:
    """DDGR's derived values of every parameter set (`engines.ddgr_derived`,
    leaves (B,) or scalars) and their Jacobian (B, 6, 6): rows
    `engines.DDGR_DERIVED`, columns d/d `engines.DDGR_INPUTS`. One pass of
    forward-mode dual tensors (``torch.autograd.forward_ad``, the tangent
    rules the twin's lanes take) over the inputs repeated once per column,
    each copy seeded on its own input: no functorch transform, whose
    decompositions cost ~100 ms a call."""
    import torch.autograd.forward_ad as fwad

    from pint_tpu_torch.models.binaries import engines as eng

    derived = eng.ddgr_derived(params)
    B = batch_size(params)
    k = len(eng.DDGR_INPUTS)
    X = torch.stack([torch.broadcast_to(leaf_to_f64(params[n]), (B,)) for n in eng.DDGR_INPUTS])
    seeds = torch.eye(k, dtype=torch.float64, device=X.device)[:, :, None].expand(k, k, B)
    with fwad.dual_level():
        x = fwad.make_dual(X.expand(k, k, B).contiguous(), seeds.contiguous())
        d = eng.ddgr_derived(dict(zip(eng.DDGR_INPUTS, x.unbind(1))))
        jac = torch.stack([fwad.unpack_dual(d[n]).tangent for n in eng.DDGR_DERIVED])
    return derived, jac.permute(2, 0, 1)  # (copy = input, derived, B) -> (B, derived, input)


def _binary_values(model: TimingModel, params: dict, B: int) -> dict:
    """The binary block's values by name (leaves as the parameters hold
    them; missing ones are absent). DDS's SINI = 1 - exp(-SHAPMAX) is formed
    here, one value per parameter set, with libm.exp as the twin does, and
    its derivative exp(-SHAPMAX) rides along as DSINI; DDGR's derived set
    and its Jacobian JAC (B, 36) likewise."""
    comp = next(c for c in model.components if c.name.startswith("Binary"))
    vals = {n: params[n] for n in ("PB", comp.epoch_name, *_BIN_F64, *_BIN_EXT)
            if n in params}
    vals.update({f"FB{k}": params[f"FB{k}"] for k in range(MAX_FB) if f"FB{k}" in params})
    vals["EPOCH"] = vals.pop(comp.epoch_name)
    if comp.model_name == "DDS":
        from pint_tpu_torch.models.binaries.engines import dds_sini
        from pint_tpu_torch.ops import libm

        vals["SINI"] = dds_sini(params["SHAPMAX"])
        vals["DSINI"] = libm.exp(-params["SHAPMAX"])
    elif comp.model_name == "DDGR":
        derived, jac = ddgr_jacobian(params)
        vals.update(derived)
        vals["JAC"] = jac.reshape(B, 36)
    return vals


def _pack_params(model: TimingModel, params: dict, B: int, st: Structure,
                 device) -> torch.Tensor:
    """(B, n_par) float64 parameter rows in the layout of resid_tangent.cu."""
    def col(v):
        v = torch.as_tensor(v, dtype=torch.float64, device=device)
        return torch.broadcast_to(v, (B,))

    zero = col(0.0)
    posep = params.get("POSEPOCH", params.get("PEPOCH"))
    ast = ("ELONG", "ELAT", "PMELONG", "PMELAT") if st.ecliptic else ("RAJ", "DECJ", "PMRA",
                                                                      "PMDEC")
    cols = [
        *(col(params[n]) if n in params else zero for n in ast),
        col(params["PX"]) if "PX" in params else zero,
        col(leaf_to_f64(posep)) if posep is not None else zero,
        col(leaf_to_f64(params["DMEPOCH"])) if "DMEPOCH" in params else zero,
        col(params["PEPOCH"].hi), col(params["PEPOCH"].lo),
    ]
    vals = _binary_values(model, params, B) if st.bin_kind else {}
    for n in ("PB", "EPOCH"):
        v = vals.get(n, DD(zero, zero))
        cols += [col(v.hi), col(v.lo)]
    cols += [col(vals[n]) if n in vals else zero for n in _BIN_F64]
    fb0 = vals.get("FB0", DD(zero, zero))
    cols += [col(fb0.hi), col(fb0.lo)]
    cols += [col(vals[f"FB{k}"]) if f"FB{k}" in vals else zero for k in range(1, MAX_FB)]
    cols += [col(vals[n]) if n in vals else zero for n in _BIN_EXT]
    jac = vals.get("JAC")
    cols += [jac[:, j] if jac is not None else zero for j in range(36)]
    for k in range(st.nd):
        cols.append(col(leaf_to_f64(params[f"DM{k}" if k else "DM"])))
    for k in range(st.nf):
        v = params[f"F{k}"]
        if isinstance(v, DD):
            cols += [col(v.hi), col(v.lo)]
        else:
            cols += [col(v), zero]
    for k in range(1, st.n_fd + 1):
        cols.append(col(leaf_to_f64(params.get(f"FD{k}", 0.0))))
    return torch.stack(cols, dim=1).contiguous()


def _nanograv_columns(model: TimingModel, params: dict, tensor: dict, B: int, st: Structure):
    """The row columns of K1's NANOGrav terms: each row's DMX DM per set (the
    one-hot product, as DispersionDMX.dmx_dm) and its jump seconds per set
    (PhaseJump.jump_seconds), both (B, N_rows); and the one-hot (N_rows,
    n_dmx) and jump masks (n_jump, N_rows) that seed the DMX and JUMP lanes.
    An absent term is one zero."""
    n_rows = tensor["t_hi"].shape[0]
    dev = tensor["t_hi"].device
    empty = torch.zeros(1, dtype=torch.float64, device=dev)
    dmx = jump = onehot = masks = empty
    if st.n_dmx:
        comp = model["DispersionDMX"]
        vals = torch.broadcast_to(comp.dmx_values(params), (B, st.n_dmx))
        onehot = tensor["dmx_onehot"].contiguous()
        dmx = (onehot @ vals.T).T.contiguous()
    if st.n_jump:
        comp = model["PhaseJump"]
        jump = torch.zeros((B, n_rows), dtype=torch.float64, device=dev)
        for mp in comp.mask_params:
            v = torch.broadcast_to(leaf_to_f64(params[mp.name]), (B,))
            jump = jump + tensor[f"mask_{mp.name}"] * v[:, None]
        masks = torch.stack([tensor[f"mask_{mp.name}"] for mp in comp.mask_params]).contiguous()
    return dmx, jump, onehot, masks


def _lane_width(k: int) -> int:
    """Lanes one block carries (resid_tangent.cu launch<K>): 0, 2, 4, or 8
    per chunk, ceil(k / 8) chunks."""
    return 0 if k == 0 else 2 if k <= 2 else 4 if k <= 4 else LANE_CHUNK


def _lane_slots(k: int) -> int:
    """Tangent rows the kernel writes: whole chunks."""
    kw = _lane_width(k)
    return kw * -(-k // kw) if kw else 0


def resid_tangent(model: TimingModel, params: dict, tensor: dict,
                  lanes: tuple = ()) -> ResidTangent:
    """K1: forward chain + tangents for every parameter set in `params`
    (leaves scalar, or (B,) for B sets). CUDA tensors launch the kernel;
    CPU tensors take `resid_tangent_plain`."""
    require_f64("resid_tangent", params=params, tensor=tensor)
    if tensor["t_hi"].device.type == "cpu":
        return resid_tangent_plain(model, params, tensor, lanes)
    out = _launch_k1(model, params, tensor, lanes)
    resid_tangent.launches += 1
    return out


def _launch_k1(model: TimingModel, params: dict, tensor: dict, lanes: tuple) -> ResidTangent:
    """One launch of K1 on the tensors' device (shapes checked here)."""
    from pint_tpu_torch.models.astrometry import COS_OBL, SIN_OBL

    dev = tensor["t_hi"].device
    k = len(lanes)
    if k > MAX_LANES:
        raise ValueError(f"kernel K1 carries at most {MAX_LANES} tangent lanes; got {k}")
    codes = [lane_code(n, model) for n in lanes]
    st = _structure(model)
    rows = [tensor[key].contiguous() for key in _ROW_KEYS]
    n_rows = rows[0].shape[0]
    for t, key in zip(rows, _ROW_KEYS):
        if t.dtype != torch.float64 or t.device != dev or t.shape[0] != n_rows:
            raise ValueError(f"tensor[{key!r}] must be float64 on {dev} with {n_rows} rows")
    has_tzr = model.has_abs_phase
    n_out = n_rows - int(has_tzr)
    B = batch_size(params)
    P = _pack_params(model, params, B, st, dev)
    ng = _nanograv_columns(model, params, tensor, B, st)
    for t in ng:
        if t.dtype != torch.float64 or t.device != dev:
            raise ValueError(f"kernel K1's DMX and JUMP columns must be float64 on {dev}")
    dpn, track = pulse_columns(model, tensor)
    none = torch.zeros(1, dtype=torch.float64, device=dev)
    pulse = [none if t is None else t.contiguous() for t in (dpn, track)]
    for t in pulse:
        if t.dtype != torch.float64 or t.device != dev:
            raise ValueError(f"the pulse-number columns must be float64 on {dev}")
    slots = _lane_slots(k)
    out = [torch.empty((B, n_out), dtype=torch.float64, device=dev) for _ in range(3)]
    tan = [torch.empty((B, slots, n_out), dtype=torch.float64, device=dev) for _ in range(2)]
    fb = torch.empty((B, n_rows), dtype=torch.float64, device=dev)
    ints = (ctypes.c_int * (19 + MAX_LANES))(
        n_rows, n_out, int(has_tzr), int(st.has_ast), st.nd, st.nf, P.shape[1], k,
        st.bin_kind, st.bin_model, int(st.ecliptic), st.n_dmx, st.n_fd, st.n_jump,
        st.n_fb, st.h_mode, st.nharms, *(codes + [-1] * (MAX_LANES - k)),
        int(dpn is not None), int(track is not None))
    consts = (ctypes.c_double * 5)(AU_LS, DMCONST, TSUN_S, COS_OBL, SIN_OBL)
    from pint_tpu_torch.ops import build

    lib = build.library("resid_tangent", _declare_k1)
    build.check(lib, lib.resid_tangent(
        *[t.data_ptr() for t in rows], *[t.data_ptr() for t in ng],
        *[t.data_ptr() for t in pulse], P.data_ptr(), B, ints,
        consts, *[o.data_ptr() for o in out], *[t.data_ptr() for t in tan], fb.data_ptr(),
        build.stream_of(P)))
    return ResidTangent(*out, tan[0][:, :k], tan[1][:, :k], fb)


resid_tangent.launches = 0


def _declare_k1(lib) -> None:
    p = ctypes.c_void_p
    lib.resid_tangent.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_double), p, p, p, p, p, p, p]
    lib.resid_tangent.restype = ctypes.c_int


# --- residuals -----------------------------------------------------------------


def weighted_mean(x: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    """Mean over the row (last) axis, 1/sigma^2-weighted when given."""
    if weights is None:
        return torch.mean(x, dim=-1, keepdim=True)
    return torch.sum(x * weights, dim=-1, keepdim=True) / torch.sum(weights)


def phase_resid_tangents(model: TimingModel, params: dict, tensor: dict,
                         lanes: tuple = ()) -> ResidTangent:
    """The forward chain through kernel K1 (looked up here at call time, so
    a reference run can substitute the twin)."""
    return resid_tangent(model, params, tensor, lanes)


def phase_residual_frac(model: TimingModel, params: dict, tensor: dict,
                        subtract_mean: bool = True, weights=None):
    """-> (pulse_number, fractional phase residual in turns, spin frequency),
    each (B, N). The weighted mean is subtracted in TURNS (pint_tpu order)."""
    out = phase_resid_tangents(model, params, tensor)
    r = out.frac
    if subtract_mean and not model.has_phase_offset:
        r = r - weighted_mean(r, weights)
    return out.pn, r, out.f


def data_errors(model: TimingModel, tensor: dict) -> torch.Tensor:
    """Per-TOA sigma (seconds) over the data rows (the TZR row dropped),
    EFAC/EQUAD-rescaled when the model has noise components (fixed inputs
    of the fits, as in pint_tpu)."""
    if model.noise_components:
        return model.scaled_sigma(model.params, tensor)
    err = tensor["error_s"]
    return err[:-1] if model.has_abs_phase else err


def tensor_of(toas, model: TimingModel) -> dict:
    """The tensor dict of `toas`: a dict as it is (``prepared.load_prepared``,
    ``TimingModel.build_tensor``), prepared TOAs (``toas.TOAs``) through
    ``model.build_tensor``."""
    return toas if isinstance(toas, dict) else model.build_tensor(toas)


def tracked_tensor(toas, model: TimingModel, track_mode: str | None = None):
    """(tensor, track_mode): the tensor of `toas` as residuals of `model` in
    `track_mode` read it, and the one place that decides the mode. The
    default is pint_tpu's: "use_pulse_numbers" under the model's
    ``TRACK -2``, else "nearest". "nearest" drops a tensor's ``track_pn``;
    "use_pulse_numbers" keeps a tensor dict's ``track_pn`` or adds the
    TOAs' -pn pulse numbers (the TZR row 0), and raises as pint_tpu raises
    when there are none."""
    if track_mode is None:
        track_mode = "use_pulse_numbers" if model.meta.get("TRACK") == "-2" else "nearest"
    if track_mode not in ("nearest", "use_pulse_numbers"):
        raise ValueError(f"unknown track_mode {track_mode!r}")
    tensor = tensor_of(toas, model)
    if track_mode == "nearest":
        return {k: v for k, v in tensor.items() if k != "track_pn"}, track_mode
    if "track_pn" not in tensor:
        pn = None if isinstance(toas, dict) else toas.get_pulse_numbers()
        if pn is None:
            raise ValueError("track_mode=use_pulse_numbers but TOAs have no pulse numbers")
        if model.has_abs_phase:
            pn = np.append(pn, 0.0)
        tensor = {**tensor, "track_pn": torch.as_tensor(pn, dtype=torch.float64,
                                                        device=tensor["t_hi"].device)}
    return tensor, track_mode


class Residuals:
    """Residuals of a model against TOAs: a tensor dict, or prepared TOAs
    (``toas.get_TOAs``), whose tensor is built once here. `track_mode` as
    `tracked_tensor`: the tensor the residuals read (``self.tensor``, which
    the fitters and grids take) holds ``track_pn`` only when tracking."""

    def __init__(self, toas, model: TimingModel, subtract_mean: bool = True,
                 track_mode: str | None = None):
        toas, self.track_mode = tracked_tensor(toas, model, track_mode)
        dev = toas["t_hi"].device
        if model.device is not None and torch.device(model.device) != dev:
            raise ValueError(f"model on {model.device} but TOAs on {dev}")
        self.toas = toas
        self.tensor = toas
        self.model = model
        self.subtract_mean = subtract_mean
        self.errors_s = data_errors(model, toas)
        if bool(torch.all(self.errors_s == 0)):
            self.weights = torch.ones_like(self.errors_s)
        else:
            safe = torch.where(self.errors_s > 0, self.errors_s, 1.0)
            self.weights = torch.where(self.errors_s > 0, 1.0 / safe**2, 0.0)
        self._cache = None

    def _compute(self):
        if self._cache is None:
            pn, r, f = phase_residual_frac(self.model, self.model.params, self.tensor,
                                           self.subtract_mean, self.weights)
            self._cache = (pn[0], r[0], r[0] / f[0])
        return self._cache

    def update(self):
        self._cache = None

    @property
    def pulse_numbers(self) -> torch.Tensor:
        return self._compute()[0]

    @property
    def phase_resids(self) -> torch.Tensor:
        return self._compute()[1]

    @property
    def time_resids(self) -> torch.Tensor:
        return self._compute()[2]

    def rms_weighted(self) -> float:
        r = self.time_resids
        w = 1.0 / self.errors_s**2
        mean = torch.sum(r * w) / torch.sum(w)
        return float(torch.sqrt(torch.sum(w * (r - mean) ** 2) / torch.sum(w)))

    def calc_chi2(self) -> float:
        """White chi^2 over the scaled sigmas, or the GLS (Woodbury) chi^2
        when the model has correlated noise."""
        if self.model.has_correlated_errors:
            from pint_tpu_torch.fitting.gls import gls_chi2

            return gls_chi2(self)
        return float(torch.sum((self.time_resids / self.errors_s) ** 2))

    @property
    def dof(self) -> int:
        n = self.errors_s.shape[0] - len(self.model.free_params)
        if self.subtract_mean and not self.model.has_phase_offset:
            n -= 1
        return n

    @property
    def reduced_chi2(self) -> float:
        return self.calc_chi2() / self.dof


class WidebandTOAResiduals:
    """Combined TOA + wideband-DM residuals (pint_tpu
    ``WidebandTOAResiduals``): the TOA block is a `Residuals`; the DM block
    is dm_data - total_dm (the model DM from kernel K8's DM-row pass) with
    the DMEFAC/DMEQUAD-scaled uncertainties; chi^2 adds the two blocks."""

    def __init__(self, toas, model: TimingModel, subtract_mean: bool = True,
                 track_mode: str | None = None):
        self.toa = Residuals(toas, model, subtract_mean, track_mode)
        self.toas = self.toa.toas
        self.tensor = self.toa.tensor
        self.model = model
        if "wb_dm" not in self.tensor:
            raise ValueError("TOAs carry no -pp_dm wideband DM measurements")
        self.dm_errors = model.scaled_dm_sigma(model.params, self.tensor)
        self.dm_data = self.tensor["wb_dm"][: self.dm_errors.shape[0]]

    @property
    def errors_s(self) -> torch.Tensor:
        return self.toa.errors_s

    @property
    def dm_resids(self) -> torch.Tensor:
        from pint_tpu_torch.fitting.design import dm_rows

        total = dm_rows(self.model, self.model.params, self.tensor, self.dm_data,
                        self.dm_errors)[0]
        return self.dm_data - total

    def calc_chi2(self) -> float:
        e = self.dm_errors
        w = torch.where(torch.isfinite(e), 1.0 / e**2, 0.0)
        return self.toa.calc_chi2() + float(torch.sum(w * self.dm_resids**2))

    @property
    def dof(self) -> int:
        return self.toa.dof + int(torch.sum(torch.isfinite(self.dm_errors)))

    @property
    def reduced_chi2(self) -> float:
        return self.calc_chi2() / self.dof

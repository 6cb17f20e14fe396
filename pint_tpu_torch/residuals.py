"""Residuals: phase and time residuals, pulse numbers, chi^2 (counterpart of
``pint_tpu/residuals.py``), and kernel K1.

K1 (`resid_tangent`, csrc/resid_tangent.cu) evaluates the whole forward
chain per TOA (equatorial or ecliptic astrometry, solar Shapiro, DM, DMX,
FD, an ELL1-family binary (ELL1, ELL1H, ELL1K) or a Kepler-orbit one (BT,
DD, DDS, DDGR, DDK), with PB or the FB orbital-frequency form, spindown,
phase JUMPs): pulse number, fractional phase, spin frequency and the barycentric
radio frequency (which kernel K8 reads), plus forward-mode tangents of the
fractional phase and the frequency for up to `MAX_LANES` free parameters.
Its passes evaluate the chain once per row without lanes, storing the
transcendentals in a scratch tape, then the TZR row's tangents, then each
row's lanes from the tape, a few lanes a thread; all the DMX lanes ride one
kernel lane and the JUMP lanes none (csrc/k1_plan.h). It replaces the TPU's
`resid` program and the jax.linearize design columns of the fit and grid
steps. Its plain-torch twin `resid_tangent_plain` runs
``TimingModel.phase_and_freq`` and takes the tangents with torch.func.jvp, as
the JAX package does with jax.linearize.

`resid_tangent` launches the kernel for CUDA tensors and takes the twin only
for CPU tensors. Fitters and grids reach it through `phase_resid_tangents`
in this module.
"""

from __future__ import annotations

import ctypes
import weakref
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


#: the parameter row's columns before the DM and F terms (resid_tangent.cu
#: P_DM0)
P_ROW_LEN = 84
#: read-only zeros by (device, shape): the absent columns and arguments
_ZEROS: dict = {}


def _zeros(device, shape: tuple) -> torch.Tensor:
    key = (torch.device(device), shape)
    z = _ZEROS.get(key)
    if z is None:
        z = _ZEROS[key] = torch.zeros(shape, dtype=torch.float64, device=key[0])
    return z


def _pack_params(model: TimingModel, params: dict, B: int, st: Structure,
                 device) -> torch.Tensor:
    """(B, n_par) float64 parameter rows in the layout of resid_tangent.cu:
    the leaves in row order (absent ones a shared zero) broadcast together
    and stacked in one copy."""
    zero = _zeros(device, ())
    posep = params.get("POSEPOCH", params.get("PEPOCH"))
    ast = ("ELONG", "ELAT", "PMELONG", "PMELAT") if st.ecliptic else ("RAJ", "DECJ", "PMRA",
                                                                      "PMDEC")
    leaves = [*(params.get(n, zero) for n in ast), params.get("PX", zero),
              zero if posep is None else leaf_to_f64(posep),
              leaf_to_f64(params["DMEPOCH"]) if "DMEPOCH" in params else zero,
              params["PEPOCH"].hi, params["PEPOCH"].lo]
    vals = _binary_values(model, params, B) if st.bin_kind else {}
    for n in ("PB", "EPOCH", None, "FB0"):
        if n is None:  # between the dd pairs: the float64 block
            leaves += [vals.get(m, zero) for m in _BIN_F64]
            continue
        v = vals.get(n)
        leaves += [zero, zero] if v is None else [v.hi, v.lo]
    leaves += [vals.get(f"FB{k}", zero) for k in range(1, MAX_FB)]
    leaves += [vals.get(n, zero) for n in _BIN_EXT]
    leaves += list(vals["JAC"].unbind(1)) if "JAC" in vals else [zero] * 36
    leaves += [leaf_to_f64(params[f"DM{k}" if k else "DM"]) for k in range(st.nd)]
    for k in range(st.nf):
        v = params[f"F{k}"]
        leaves += [v.hi, v.lo] if isinstance(v, DD) else [v, zero]
    leaves += [leaf_to_f64(params[f"FD{k}"]) if f"FD{k}" in params else zero
               for k in range(1, st.n_fd + 1)]
    P = torch.stack(torch.broadcast_tensors(*leaves), dim=-1)
    return P.expand(B, P.shape[-1]).contiguous()


def _nanograv_columns(model: TimingModel, params: dict, tensor: dict, B: int, st: Structure,
                      setup: "_K1Setup"):
    """The row columns of K1's NANOGrav terms: each row's DMX DM per set (the
    one-hot product, as DispersionDMX.dmx_dm) and its jump seconds per set
    (PhaseJump.jump_seconds), both (B, N_rows); and the one-hot (N_rows,
    n_dmx) and jump masks (n_jump, N_rows) from which the kernel writes the
    DMX and JUMP columns (`setup.masks_of`). An absent term is one zero."""
    n_rows = tensor["t_hi"].shape[0]
    dev = tensor["t_hi"].device
    empty = _zeros(dev, (1,))
    dmx = jump = empty
    onehot, masks = setup.masks_of(model, tensor, empty)
    if st.n_dmx:
        vals = torch.broadcast_to(model["DispersionDMX"].dmx_values(params), (B, st.n_dmx))
        dmx = (onehot @ vals.T).T.contiguous()
    if st.n_jump:
        jump = torch.zeros((B, n_rows), dtype=torch.float64, device=dev)
        for mp in model["PhaseJump"].mask_params:
            v = torch.broadcast_to(leaf_to_f64(params[mp.name]), (B,))
            jump = jump + tensor[f"mask_{mp.name}"] * v[:, None]
    return dmx, jump, onehot, masks


# the integer arguments of resid_tangent() (csrc/k1_plan.h I_*): 17 scalars,
# the lane codes, has_dpn and has_track
_I_LANE = 17
_I_COUNT = _I_LANE + MAX_LANES + 2


class K1Plan(ctypes.Structure):
    """csrc/k1_plan.h's Plan: the kernel lanes (dense ones in the caller's
    order, then the one DMX lane), each lane's row of the outputs, the lane
    width and groups, and the scratch in doubles."""

    _fields_ = [("n_klane", ctypes.c_int), ("width", ctypes.c_int), ("groups", ctypes.c_int),
                ("dmx_lane", ctypes.c_int), ("n_slots", ctypes.c_int),
                ("code", ctypes.c_int * MAX_LANES), ("pos", ctypes.c_int * MAX_LANES),
                ("dmx_pos", ctypes.c_int * MAX_DMX), ("jump_pos", ctypes.c_int * MAX_JUMP),
                ("scratch", ctypes.c_longlong)]


def _k1_ints(st: Structure, codes, n_rows: int, n_out: int, has_tzr: bool, has_dpn: bool,
             has_track: bool):
    """resid_tangent()'s integer arguments."""
    n_par = P_ROW_LEN + st.nd + 2 * st.nf + st.n_fd
    return (ctypes.c_int * _I_COUNT)(
        n_rows, n_out, int(has_tzr), int(st.has_ast), st.nd, st.nf, n_par, len(codes),
        st.bin_kind, st.bin_model, int(st.ecliptic), st.n_dmx, st.n_fd, st.n_jump,
        st.n_fb, st.h_mode, st.nharms, *codes, *([-1] * (MAX_LANES - len(codes))),
        int(has_dpn), int(has_track))


def k1_plan(lib, ints, n_batch: int) -> K1Plan:
    """The plan of a call (the library's ``resid_tangent_plan``); a refused
    call raises ValueError."""
    plan = K1Plan()
    if lib.resid_tangent_plan(ints, n_batch, ctypes.byref(plan)):
        raise ValueError("kernel K1 refuses these arguments (csrc/k1_plan.h plan_of)")
    return plan


class _K1Setup:
    """What K1's launches keep between calls with one model and one lane
    tuple: the model's Structure, the lane codes, and per tensor shape the
    integer arguments and the plan. Parameter values are read anew on every
    call. The stacked JUMP masks and the checked one-hot are kept with the
    tensor columns they came from and made anew for other ones."""

    def __init__(self, model: TimingModel, lanes: tuple):
        if len(lanes) > MAX_LANES:
            raise ValueError(f"kernel K1 carries at most {MAX_LANES} tangent lanes; "
                             f"got {len(lanes)}")
        self.st = _structure(model)
        self.codes = [lane_code(n, model) for n in lanes]
        once = [c for c in self.codes if L_JUMP0 <= c < L_FB0]
        if len(set(once)) != len(once):
            raise ValueError("kernel K1 takes each DMX window's and JUMP's lane once")
        self._calls: dict = {}
        self._masks = None

    def call(self, lib, n_rows: int, n_out: int, has_tzr: bool, has_dpn: bool,
             has_track: bool, B: int):
        """(ints, plan) of one call's shape."""
        key = (n_rows, n_out, has_tzr, has_dpn, has_track, B)
        got = self._calls.get(key)
        if got is None:
            ints = _k1_ints(self.st, self.codes, n_rows, n_out, has_tzr, has_dpn, has_track)
            got = self._calls[key] = (ints, k1_plan(lib, ints, B))
        return got

    def masks_of(self, model: TimingModel, tensor: dict, empty: torch.Tensor):
        """(onehot, masks) of `tensor`: its DMX one-hot and its JUMP masks
        stacked (n_jump, N_rows), each `empty` when the model lacks the term.
        The kernel writes the DMX and JUMP columns as the lanes seeded with
        these entries would give them only for entries 0 and 1, which the
        models build (window comparisons, flag masks): checked once per
        column."""
        st = self.st
        jumps = model["PhaseJump"].mask_params if st.n_jump else ()
        src = (tensor["dmx_onehot"] if st.n_dmx else None,
               *(tensor[f"mask_{mp.name}"] for mp in jumps))
        if self._masks is not None and len(src) == len(self._masks[0]) and all(
                a is b for a, b in zip(src, self._masks[0])):
            return self._masks[1]
        onehot = src[0].contiguous() if st.n_dmx else empty
        masks = torch.stack(src[1:]).contiguous() if st.n_jump else empty
        for name, t in (("DMX one-hot", onehot), ("JUMP masks", masks)):
            if not bool(torch.all((t == 0.0) | (t == 1.0))):
                raise ValueError(f"kernel K1 takes a {name} of zeros and ones")
        self._masks = (src, (onehot, masks))
        return onehot, masks


#: K1's setups by model, then by lane tuple (and the model's components)
_K1_SETUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _k1_setup(model: TimingModel, lanes: tuple) -> _K1Setup:
    per_model = _K1_SETUPS.setdefault(model, {})
    key = (lanes, tuple(map(id, model.components)))
    setup = per_model.get(key)
    if setup is None:
        setup = per_model[key] = _K1Setup(model, lanes)
    return setup


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
    """One call of K1 (its passes) on the tensors' device (shapes checked
    here)."""
    from pint_tpu_torch.models.astrometry import COS_OBL, SIN_OBL
    from pint_tpu_torch.ops import build

    dev = tensor["t_hi"].device
    k = len(lanes)
    setup = _k1_setup(model, tuple(lanes))
    st = setup.st
    rows = [tensor[key].contiguous() for key in _ROW_KEYS]
    n_rows = rows[0].shape[0]
    for t, key in zip(rows, _ROW_KEYS):
        if t.dtype != torch.float64 or t.device != dev or t.shape[0] != n_rows:
            raise ValueError(f"tensor[{key!r}] must be float64 on {dev} with {n_rows} rows")
    has_tzr = model.has_abs_phase
    n_out = n_rows - int(has_tzr)
    B = batch_size(params)
    P = _pack_params(model, params, B, st, dev)
    if P.shape[1] != P_ROW_LEN + st.nd + 2 * st.nf + st.n_fd:
        raise ValueError(f"K1's parameter row has {P.shape[1]} columns")
    ng = _nanograv_columns(model, params, tensor, B, st, setup)
    for t in ng:
        if t.dtype != torch.float64 or t.device != dev:
            raise ValueError(f"kernel K1's DMX and JUMP columns must be float64 on {dev}")
    dpn, track = pulse_columns(model, tensor)
    pulse = [_zeros(dev, (1,)) if t is None else t.contiguous() for t in (dpn, track)]
    for t in pulse:
        if t.dtype != torch.float64 or t.device != dev:
            raise ValueError(f"the pulse-number columns must be float64 on {dev}")
    lib = build.library("resid_tangent", _declare_k1)
    ints, plan = setup.call(lib, n_rows, n_out, has_tzr, dpn is not None, track is not None, B)
    # the outputs in one allocation: pn, frac, f (B, N), dfrac, df (B, k, N), fb (B, N_rows)
    buf = torch.empty(B * ((3 + 2 * k) * n_out + n_rows), dtype=torch.float64, device=dev)
    sizes = [B * n_out] * 3 + [B * k * n_out] * 2 + [B * n_rows]
    shapes = [(B, n_out)] * 3 + [(B, k, n_out)] * 2 + [(B, n_rows)]
    out = [x.view(shape) for x, shape in zip(torch.split(buf, sizes), shapes)]
    scratch = torch.empty(max(plan.scratch, 1), dtype=torch.float64, device=dev)
    consts = (ctypes.c_double * 5)(AU_LS, DMCONST, TSUN_S, COS_OBL, SIN_OBL)
    build.check(lib, lib.resid_tangent(
        *[t.data_ptr() for t in rows], *[t.data_ptr() for t in ng],
        *[t.data_ptr() for t in pulse], P.data_ptr(), B, ints,
        consts, *[o.data_ptr() for o in out], scratch.data_ptr(), build.stream_of(P)))
    return ResidTangent(*out)


resid_tangent.launches = 0


def _declare_k1(lib) -> None:
    p = ctypes.c_void_p
    lib.resid_tangent.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_double), p, p, p, p, p, p, p, p]
    lib.resid_tangent.restype = ctypes.c_int
    lib.resid_tangent_plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                       ctypes.POINTER(K1Plan)]
    lib.resid_tangent_plan.restype = ctypes.c_int


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

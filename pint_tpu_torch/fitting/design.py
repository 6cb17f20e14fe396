"""Design-matrix assembly: tangents for nonlinear parameters, closed forms
for exactly-linear ones (counterpart of ``pint_tpu/fitting/design.py``), and
kernel K8.

A component opts in with ``linear_param_names()`` and
``linear_resid_columns(params, tensor, f, sl) -> {name: column}``, where a
column is d(time residual)/d(param). The nonlinear columns come from the
tangent lanes of kernel K1 (``residuals.resid_tangent``).

K8 (`linear_columns`, csrc/linear_columns.cu) writes the closed-form
columns of DM<k>, DMX, FD<k> and JUMP over every row in one pass, the TZR
row's value subtracted, from the barycentric frequency K1 hands back
(``ResidTangent.fb``); (`fourier_basis`) the interleaved sin/cos columns of
the power-law noise bases; and (`dm_rows`) the DM block of a wideband fit:
the model DM of every data row, the weighted DM residual and the weighted
DM-row column of every fit parameter. Their plain twins are
`linear_columns_plain` (the components' own closed forms),
``models/noise.fourier_basis_plain`` and `dm_rows_plain` (the components'
``dm_value`` and ``dm_columns``); on a CPU tensor the wrappers take the
twins, on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pint_tpu_torch import DMCONST
from pint_tpu_torch.device import require_f64
from pint_tpu_torch.models.base import leaf_to_f64


def linear_split(model, free: tuple[str, ...]):
    """(nonlinear_names, linear_names, owner by linear name)."""
    owners = {}
    for c in model.components:
        if hasattr(c, "linear_param_names"):
            for n in c.linear_param_names():
                owners[n] = c
    lin = tuple(n for n in free if n in owners)
    nonlin = tuple(n for n in free if n not in owners)
    return nonlin, lin, owners


def linear_columns_plain(model, params, tensor, f, sl, linear_names, owners) -> torch.Tensor:
    """Twin of K8: (..., L, N_data) analytic d(time resid)/d(param)
    columns, columns before rows, in `linear_names` order.

    With AbsPhase the residual is TZR-anchored, so every column carries the
    TZR row's term too: the columns are evaluated over ALL rows (the
    fiducial last) and its value subtracted. The spin frequency at the TZR
    row is approximated by its neighbour's."""
    cols = {}
    tensor = model._with_context(params, tensor)
    if model.has_abs_phase:
        f_use = torch.cat([f, f[..., -1:]], dim=-1)
        sl_use = slice(None)
    else:
        f_use = f
        sl_use = sl
    for c in {id(owners[n]): owners[n] for n in linear_names}.values():
        cols.update(c.linear_resid_columns(params, tensor, f_use, sl_use))
    M = torch.stack([torch.broadcast_to(cols[n], f_use.shape) for n in linear_names], dim=-2)
    if model.has_abs_phase:
        M = M[..., :-1] - M[..., -1:]
    return M


def linear_columns(model, params, tensor, f, sl, linear_names, owners, fb=None) -> torch.Tensor:
    """K8: the closed-form columns of `linear_names`, as the twin. A CUDA
    tensor launches the kernel, which reads the barycentric frequency `fb`
    ((..., N_rows), K1's ``ResidTangent.fb``) instead of forming it again; a
    CPU tensor takes `linear_columns_plain`."""
    if f.device.type == "cpu":
        return linear_columns_plain(model, params, tensor, f, sl, linear_names, owners)
    out = _launch_k8_columns(model, params, tensor, f, fb, linear_names, owners)
    linear_columns.launches += 1
    return out


linear_columns.launches = 0

# column kinds of csrc/linear_columns.cu
KIND_DM, KIND_DMX, KIND_FD, KIND_JUMP = 0, 1, 2, 3


def column_kinds(model, linear_names, owners):
    """(kinds, indices, jump mask names) of the columns in the kernel's
    codes: DM<k> -> (DM, k), DMX_nnnn -> (DMX, its window's column),
    FD<k> -> (FD, k), a JUMP -> (JUMP, its row among the masks)."""
    from pint_tpu_torch.models.dispersion import DispersionDM, DispersionDMX
    from pint_tpu_torch.models.frequency_dependent import FD
    from pint_tpu_torch.models.phase_misc import PhaseJump

    kinds, idx, jumps = [], [], []
    for n in linear_names:
        c = owners[n]
        if isinstance(c, DispersionDM):
            kinds.append(KIND_DM)
            idx.append(c.coeff_names().index(n))
        elif isinstance(c, DispersionDMX):
            kinds.append(KIND_DMX)
            idx.append(c.linear_param_names().index(n))
        elif isinstance(c, FD):
            kinds.append(KIND_FD)
            idx.append(int(n[2:]))
        elif isinstance(c, PhaseJump):
            kinds.append(KIND_JUMP)
            idx.append(len(jumps))
            jumps.append(n)
        else:
            raise NotImplementedError(f"kernel K8 has no closed form for {n} ({c.name})")
    return kinds, idx, jumps


def _launch_k8_columns(model, params, tensor, f, fb, linear_names, owners) -> torch.Tensor:
    """One launch of K8's column pass: f (..., N) -> (..., L, N)."""
    dev = f.device
    if fb is None:
        raise ValueError("kernel K8 needs the barycentric frequency fb from K1")
    require_f64("linear_columns", tensor={"fb": fb, "f": f})
    lead = f.shape[:-1]
    n_out = f.shape[-1]
    n_rows = tensor["t_hi"].shape[0]
    has_tzr = int(model.has_abs_phase)
    if n_rows != n_out + has_tzr or fb.shape[:-1] != lead or fb.shape[-1] != n_rows:
        raise ValueError(f"linear_columns needs f (..., {n_rows - has_tzr}) and fb (..., "
                         f"{n_rows}); got {tuple(f.shape)}, {tuple(fb.shape)}")
    B = math.prod(lead)
    kinds, idx, jumps = column_kinds(model, linear_names, owners)
    L = len(kinds)
    empty = torch.zeros(1, dtype=torch.float64, device=dev)
    onehot = tensor.get("dmx_onehot", empty) if KIND_DMX in kinds else empty
    masks = torch.stack([tensor[f"mask_{n}"] for n in jumps]) if jumps else empty
    # F0 per set (leaves scalar, (B,) or the grid's (B, 1)); DMEPOCH is one
    f0 = leaf_to_f64(params["F0"]).reshape(-1).expand(B).contiguous() if jumps else empty
    ep = params.get("DMEPOCH")
    dmepoch = float(leaf_to_f64(ep).reshape(-1)[0]) if ep is not None else 0.0
    cols = [tensor["t_hi"], tensor["t_lo"], onehot, masks]
    for t in cols:
        if t.dtype != torch.float64 or t.device != dev:
            raise ValueError(f"linear_columns needs float64 tensors on {dev}")
    cols = [t.contiguous() for t in cols]
    fbc, fc = fb.reshape(B, n_rows).contiguous(), f.reshape(B, n_out).contiguous()
    out = torch.empty((B, L, n_out), dtype=torch.float64, device=dev)
    if L == 0 or n_out == 0:
        return out.reshape(*lead, L, n_out)
    codes = (ctypes.c_int * (2 * L))(*kinds, *idx)
    n_dmx = onehot.shape[1] if onehot.dim() == 2 else 0
    from pint_tpu_torch.ops import build

    lib = build.library("linear_columns", _declare_k8)
    build.check(lib, lib.linear_columns(
        fbc.data_ptr(), fc.data_ptr(), cols[0].data_ptr(), cols[1].data_ptr(),
        cols[2].data_ptr(), cols[3].data_ptr(), f0.data_ptr(), B, n_rows, n_out, has_tzr,
        n_dmx, L, codes, dmepoch, DMCONST, out.data_ptr(), build.stream_of(out)))
    return out.reshape(*lead, L, n_out)


def fourier_basis(t: torch.Tensor, freqs: torch.Tensor, scale=None) -> torch.Tensor:
    """K8's Fourier pass: (N, 2 nf) interleaved sin, cos of 2 pi t f_k
    (times `scale` (N,) per row when given), as
    ``models/noise.fourier_basis_plain``. A CUDA tensor launches the kernel
    (the result is a transposed view of its (2 nf, N) output, columns
    before rows); a CPU tensor takes the twin."""
    from pint_tpu_torch.models.noise import fourier_basis_plain

    if t.device.type == "cpu":
        return fourier_basis_plain(t, freqs, scale)
    out = _launch_k8_fourier(t, freqs, scale)
    fourier_basis.launches += 1
    return out


fourier_basis.launches = 0


def _launch_k8_fourier(t, freqs, scale) -> torch.Tensor:
    require_f64("fourier_basis", tensor={"t": t, "freqs": freqs})
    n, nf = t.shape[0], freqs.shape[0]
    if t.dim() != 1 or freqs.dim() != 1 or (scale is not None and scale.shape != t.shape):
        raise ValueError("fourier_basis needs t (N,), freqs (nf,) and scale (N,) or None")
    for x in (freqs, scale):
        if x is not None and (x.dtype != torch.float64 or x.device != t.device):
            raise ValueError(f"fourier_basis needs float64 tensors on {t.device}")
    t, freqs = t.contiguous(), freqs.contiguous()
    sc = scale.contiguous() if scale is not None else None
    out = torch.empty((2 * nf, n), dtype=torch.float64, device=t.device)
    if n and nf:
        from pint_tpu_torch.ops import build

        lib = build.library("linear_columns", _declare_k8)
        build.check(lib, lib.fourier_basis(
            t.data_ptr(), freqs.data_ptr(), sc.data_ptr() if sc is not None else None, n, nf,
            out.data_ptr(), build.stream_of(out)))
    return out.T


def dm_weights(sigma: torch.Tensor) -> torch.Tensor:
    """1 / sigma where sigma is finite, else 0: the DM rows' weights. The
    division is by a tensor (IEEE on every device, ROADMAP C8)."""
    ok = torch.isfinite(sigma)
    return torch.where(ok, torch.ones_like(sigma) / torch.where(ok, sigma, 1.0), 0.0)


def dm_rows_plain(model, params, tensor, dm_data, sigma, names=()):
    """Twin of K8's DM-row pass: (DM (N,), (DM - dm_data) sw (N,), columns
    (L, N)) over the data rows, sw = `dm_weights(sigma)`; column l is
    d DM / d names[l] times sw, 0 for a parameter the model DM does not
    depend on."""
    total = model.total_dm(params, tensor)
    sw = dm_weights(sigma)
    n = total.shape[0]
    derivs = {}
    for c in model.dm_components:
        derivs.update(c.dm_columns(params, tensor))
    cols = [derivs[k][:n] * sw if k in derivs else torch.zeros_like(total) for k in names]
    cols = torch.stack(cols) if cols else total.new_zeros((0, n))
    return total, (total - dm_data) * sw, cols


def dm_rows(model, params, tensor, dm_data, sigma, names=()):
    """K8's DM-row pass, as `dm_rows_plain`. A CUDA tensor launches the
    kernel; a CPU tensor takes the twin."""
    if dm_data.device.type == "cpu":
        return dm_rows_plain(model, params, tensor, dm_data, sigma, names)
    out = _launch_k8_dm(model, params, tensor, dm_data, sigma, names)
    dm_rows.launches += 1
    return out


dm_rows.launches = 0

# DM-row kinds and model parts of csrc/linear_columns.cu
DM_KIND_NONE, DM_KIND_DM, DM_KIND_DMX, DM_KIND_DMJUMP = 0, 1, 2, 3
DM_HAS_DM, DM_HAS_DMX, DM_HAS_JUMP = 1, 2, 4


def dm_kinds(model, names):
    """(kinds, indices) of the DM-row columns of `names`: DM<k> -> (DM, k),
    DMX_nnnn -> (DMX, its window's column), a DMJUMP -> (DMJUMP, its row
    among the masks), anything else (NONE, 0)."""
    owner = {}
    for c in model.dm_components:
        for i, n in enumerate(c.dm_param_names()):
            owner[n] = (c, i)
    kinds, idx = [], []
    code = {"DispersionDM": DM_KIND_DM, "DispersionDMX": DM_KIND_DMX,
            "DispersionJump": DM_KIND_DMJUMP}
    for n in names:
        if n in owner:
            c, i = owner[n]
            kinds.append(code[c.name])
            idx.append(i)
        else:
            kinds.append(DM_KIND_NONE)
            idx.append(0)
    return kinds, idx


def _launch_k8_dm(model, params, tensor, dm_data, sigma, names):
    """One launch of K8's DM-row pass."""
    dev = dm_data.device
    require_f64("dm_rows", params={n: params[n] for c in model.dm_components
                                   for n in c.dm_param_names()},
                tensor={"dm_data": dm_data, "sigma": sigma, "t_hi": tensor["t_hi"]})
    unknown = {c.name for c in model.dm_components} - {"DispersionDM", "DispersionDMX",
                                                      "DispersionJump"}
    if unknown:
        raise NotImplementedError(f"kernel K8's DM-row pass has no term for {sorted(unknown)}")
    n_out, n_rows = dm_data.shape[0], tensor["t_hi"].shape[0]
    if sigma.shape != (n_out,) or n_rows != n_out + int(model.has_abs_phase):
        raise ValueError(f"dm_rows needs dm_data and sigma ({n_rows - int(model.has_abs_phase)},);"
                         f" got {tuple(dm_data.shape)}, {tuple(sigma.shape)}")
    empty = torch.zeros(1, dtype=torch.float64, device=dev)
    coeffs = onehot = dmx = masks = jumps = empty
    parts, nd, n_dmx, n_jump, dmepoch = 0, 0, 0, 0, 0.0
    if "DispersionDM" in model:
        comp = model["DispersionDM"]
        parts |= DM_HAS_DM
        nd = comp.num_terms
        coeffs = torch.stack([leaf_to_f64(params[n]) for n in comp.coeff_names()])
        if nd > 1:
            dmepoch = float(leaf_to_f64(params["DMEPOCH"]))
    if "DispersionDMX" in model:
        comp = model["DispersionDMX"]
        parts |= DM_HAS_DMX
        onehot, dmx = tensor["dmx_onehot"], comp.dmx_values(params)
        n_dmx = dmx.shape[0]
    if "DispersionJump" in model and model["DispersionJump"].mask_params:
        comp = model["DispersionJump"]
        parts |= DM_HAS_JUMP
        masks = torch.stack([tensor[f"mask_{mp.name}"] for mp in comp.mask_params])
        jumps = torch.stack([leaf_to_f64(params[mp.name]) for mp in comp.mask_params])
        n_jump = jumps.shape[0]
    ins = [tensor["t_hi"], tensor["t_lo"], coeffs, onehot, dmx, masks, jumps, dm_data, sigma]
    for t in ins:
        if t.dtype != torch.float64 or t.device != dev:
            raise ValueError(f"dm_rows needs float64 tensors on {dev}")
    ins = [t.contiguous() for t in ins]
    kinds, idx = dm_kinds(model, names)
    L = len(kinds)
    total, resid = (torch.empty(n_out, dtype=torch.float64, device=dev) for _ in range(2))
    cols = torch.empty((L, n_out), dtype=torch.float64, device=dev)
    codes = (ctypes.c_int * max(2 * L, 1))(*kinds, *idx)
    from pint_tpu_torch.ops import build

    lib = build.library("linear_columns", _declare_k8)
    build.check(lib, lib.dm_rows(
        ins[0].data_ptr(), ins[1].data_ptr(), ins[2].data_ptr(), nd, dmepoch, ins[3].data_ptr(),
        ins[4].data_ptr(), n_dmx, ins[5].data_ptr(), ins[6].data_ptr(), n_jump,
        ins[7].data_ptr(), ins[8].data_ptr(), n_rows, n_out, parts, L, codes,
        total.data_ptr(), resid.data_ptr(), cols.data_ptr(), build.stream_of(total)))
    return total, resid, cols


def _declare_k8(lib) -> None:
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.linear_columns.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                   ctypes.POINTER(ctypes.c_int), d, d, p, p]
    lib.linear_columns.restype = ctypes.c_int
    lib.fourier_basis.argtypes = [p, p, p, i, i, p, p]
    lib.fourier_basis.restype = ctypes.c_int
    lib.dm_rows.argtypes = [p, p, p, i, d, p, p, i, p, p, i, p, p, i, i, i, i,
                            ctypes.POINTER(ctypes.c_int), p, p, p, p]
    lib.dm_rows.restype = ctypes.c_int

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
(``ResidTangent.fb``); and (`fourier_basis`) the interleaved sin/cos
columns of the power-law noise bases. Their plain twins are
`linear_columns_plain` (the components' own closed forms) and
``models/noise.fourier_basis_plain``; on a CPU tensor the wrappers take the
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


def _declare_k8(lib) -> None:
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.linear_columns.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                   ctypes.POINTER(ctypes.c_int), d, d, p, p]
    lib.linear_columns.restype = ctypes.c_int
    lib.fourier_basis.argtypes = [p, p, p, i, i, p, p]
    lib.fourier_basis.restype = ctypes.c_int

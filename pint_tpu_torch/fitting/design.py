"""Design-matrix assembly: tangents for nonlinear parameters, closed forms
for exactly-linear ones (counterpart of ``pint_tpu/fitting/design.py``).

A component opts in with ``linear_param_names()`` and
``linear_resid_columns(params, tensor, f, sl) -> {name: column}``, where a
column is d(time residual)/d(param). The nonlinear columns come from the
tangent lanes of kernel K1 (``residuals.resid_tangent``).
"""

from __future__ import annotations

import torch


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


def linear_columns(model, params, tensor, f, sl, linear_names, owners) -> torch.Tensor:
    """(..., L, N_data) analytic d(time resid)/d(param) columns, columns
    before rows, in `linear_names` order.

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

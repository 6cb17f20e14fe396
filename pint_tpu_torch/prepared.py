"""Prepared-TOA archives: the port's input until it has its own TOA prepare.

pint_tpu prepares TOAs on the host (clock chain, TDB, ephemeris, observatory
geometry) and hands the device ONE dict of per-row columns,
``TimingModel.build_tensor``. The port starts from that dict: an ``.npz``
archive holding the float64 columns below with the TZR fiducial TOA as the
last row, and a ``meta`` JSON record (N, seed, the parfile it was built
for). ``tests/test_torch_fixture.py --write`` exports it with pint_tpu and a
test checks that a fresh export still equals the committed file.

`tensor_from_numpy` and `params_from_numpy` are the bridge from values
computed by pint_tpu (as numpy; dd leaves as (hi, lo) pairs) to the port.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from pint_tpu_torch.device import resolve_device
from pint_tpu_torch.ops.dd import DD

#: the build_tensor columns the ported components read; the qf32 columns
#: t_q0..t_q3 are not carried (the qf32 backend is not ported)
COLUMNS = ("t_hi", "t_lo", "error_s", "freq_mhz",
           "ssb_obs_pos_ls", "ssb_obs_vel_ls", "obs_sun_pos_ls")
_DROPPED = ("t_q0", "t_q1", "t_q2", "t_q3")

SMOKE_ARCHIVE = Path(__file__).resolve().parent / "data" / "smoke_n16384.npz"


def tensor_from_numpy(tensor: dict, device=None) -> dict:
    """pint_tpu build_tensor output (numpy-convertible) -> the port's dict of
    float64 tensors on `device`. Columns the ported components do not read
    raise, rather than being dropped silently."""
    dev = resolve_device(device)
    unknown = set(tensor) - set(COLUMNS) - set(_DROPPED)
    if unknown:
        raise NotImplementedError(f"tensor columns not handled by the port yet: {sorted(unknown)}")
    return {k: torch.tensor(np.asarray(tensor[k], np.float64), dtype=torch.float64, device=dev)
            for k in COLUMNS}


def params_from_numpy(params: dict, device=None) -> dict:
    """{name: float | (hi, lo)} -> the port's {name: tensor | DD} on `device`."""
    dev = resolve_device(device)

    def t(x):
        return torch.tensor(float(x), dtype=torch.float64, device=dev)

    return {k: DD(t(v[0]), t(v[1])) if isinstance(v, tuple) else t(v)
            for k, v in params.items()}


def save_prepared(path, tensor: dict, meta: dict) -> None:
    """Write the COLUMNS of a numpy tensor dict and a JSON meta record."""
    cols = {k: np.ascontiguousarray(np.asarray(tensor[k], np.float64)) for k in COLUMNS}
    np.savez_compressed(path, meta=np.array(json.dumps(meta, sort_keys=True)), **cols)


def archive_meta(path=SMOKE_ARCHIVE) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["meta"]))


def load_prepared(path=SMOKE_ARCHIVE, device=None) -> dict:
    """The archive's tensor dict, float64 on `device` (CUDA unless 'cpu')."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        cols = {k: z[k] for k in COLUMNS}
    return tensor_from_numpy(cols, dev)

"""Prepared-TOA archives: the input of the port's first two slices, and the
reference its own TOA prepare (``toas.py``) is checked against.

pint_tpu prepares TOAs on the host (clock chain, TDB, ephemeris, observatory
geometry) and hands the device ONE dict of per-row columns,
``TimingModel.build_tensor``. The port starts from that dict: an ``.npz``
archive holding the float64 columns below with the TZR fiducial TOA as the
last row, and a ``meta`` JSON record (N, seed, the parfile it was built
for). ``tests/test_torch_fixture.py --write`` exports both archives with
pint_tpu and tests check that a fresh export still equals each committed
file.

Besides the fixed `COLUMNS`, a model with noise components reads

- ``mask_<NAME>`` (N+1,): 1.0 on the rows the mask parameter NAME (EFAC1,
  EQUAD2, ECORR1, ...) selects;
- ``ecorr_eidx`` (N+1,): each row's ECORR epoch as float64, -1 for none
  (the TZR row always);
- ``ecorr_widx`` (1, ke): the ECORR parameter (its index among the ECORR
  masks) of each epoch. The leading singleton axis keeps it clear of the
  row axis: nothing that slices rows may touch it;
- ``dmx_onehot`` (N+1, n_dmx): 1.0 where a row falls in a DMX window (the
  TZR row too: it is a model evaluation, not a selection);
- ``noise_tspan`` (1, 1): the span of the real TOAs, the power-law
  noise bases' fundamental period;
- ``wb_dm``, ``wb_dme`` (N+1,): wideband TOAs' DM measurements and their
  errors (pc cm^-3; an infinite error, zero weight, on rows without one,
  the TZR row always);
- ``delta_pn`` (N+1,): each row's -padd plus -phase pulse offset in turns
  (absent when all are zero; the TZR row 0), added to the phase before
  the nearest pulse is taken;
- ``track_pn`` (N+1,): when residuals track pulse numbers (``TRACK -2``
  or ``track_mode="use_pulse_numbers"``; ``residuals.tracked_tensor``
  adds it), the -pn pulse numbers (NaN where a row has none; the TZR row
  0), subtracted from the phase in place of the nearest pulse.

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
#: the noise and DMX columns (see the module docstring)
ECORR_COLUMNS = ("ecorr_eidx", "ecorr_widx")
MODEL_COLUMNS = ("dmx_onehot", "noise_tspan")
WIDEBAND_COLUMNS = ("wb_dm", "wb_dme")
PULSE_COLUMNS = ("delta_pn", "track_pn")

SMOKE_ARCHIVE = Path(__file__).resolve().parent / "data" / "smoke_n16384.npz"
#: profiles.FLAGSHIP_SMOKE_PAR over 16,384 sub-band TOAs in 2,048 epochs
FLAGSHIP_ARCHIVE = Path(__file__).resolve().parent / "data" / "flagship_n16384.npz"
#: the same TOAs as a .tim file (pint_tpu's TOAs.write_tim of the raw site
#: UTC), the input of the port's own TOA prepare (toas.get_TOAs)
FLAGSHIP_TIM = Path(__file__).resolve().parent / "data" / "flagship_n16384.tim"
#: the same dataset simulated under pint_tpu's default ephemeris (the N-body
#: window), the input of the default-ephemeris prepare
FLAGSHIP_NBODY_TIM = Path(__file__).resolve().parent / "data" / "flagship_n16384_nbody.tim"
#: profiles.DD_SMOKE_PAR over 16,384 fake TOAs, simulated by pint_tpu under
#: the analytic ephemeris: the input of the eccentric-binary path
DD_TIM = Path(__file__).resolve().parent / "data" / "dd_n16384.tim"
#: profiles.DDGR_SMOKE_PAR and profiles.DDK_SMOKE_PAR over 16,384 fake TOAs
#: in DD_TIM's layout, simulated by pint_tpu under the analytic ephemeris:
#: the inputs of the DDGR and DDK paths
DDGR_TIM = Path(__file__).resolve().parent / "data" / "ddgr_n16384.tim"
DDK_TIM = Path(__file__).resolve().parent / "data" / "ddk_n16384.tim"
#: profiles.NANOGRAV_SMOKE_PAR over the flagship's 2,048 epochs of 8
#: sub-bands, with white, ECORR and red noise drawn by pint_tpu under the
#: analytic ephemeris: the input of the NANOGrav-shaped path
NANOGRAV_TIM = Path(__file__).resolve().parent / "data" / "nanograv_n16384.tim"
#: profiles.WIDEBAND_SMOKE_PAR over 16,384 wideband TOAs (one per epoch, the
#: two receivers in turn, each with a -pp_dm/-pp_dme DM measurement), noise
#: drawn by pint_tpu under the analytic ephemeris: the input of the wideband
#: path
WIDEBAND_TIM = Path(__file__).resolve().parent / "data" / "wideband_n16384.tim"


def carried(names) -> list[str]:
    """The columns of `names` the port carries, in a fixed order: COLUMNS,
    then the mask columns sorted, then the ECORR, DMX, noise-span,
    wideband and pulse-number columns. Any other column raises, rather than
    being dropped silently."""
    names = set(names)
    tail = ECORR_COLUMNS + MODEL_COLUMNS + WIDEBAND_COLUMNS + PULSE_COLUMNS
    unknown = names - set(COLUMNS) - set(_DROPPED) - set(tail)
    unknown = {k for k in unknown if not k.startswith("mask_")}
    if unknown:
        raise NotImplementedError(f"tensor columns not handled by the port yet: {sorted(unknown)}")
    masks = sorted(k for k in names if k.startswith("mask_"))
    return [k for k in COLUMNS if k in names] + masks + [k for k in tail if k in names]


def tensor_from_numpy(tensor: dict, device=None) -> dict:
    """pint_tpu build_tensor output (numpy-convertible) -> the port's dict of
    float64 tensors on `device`. Columns the ported components do not read
    raise, rather than being dropped silently."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(tensor[k], np.float64), dtype=torch.float64, device=dev)
            for k in carried(tensor)}


def params_from_numpy(params: dict, device=None) -> dict:
    """{name: float | (hi, lo)} -> the port's {name: tensor | DD} on `device`."""
    dev = resolve_device(device)

    def t(x):
        return torch.tensor(float(x), dtype=torch.float64, device=dev)

    return {k: DD(t(v[0]), t(v[1])) if isinstance(v, tuple) else t(v)
            for k, v in params.items()}


def save_prepared(path, tensor: dict, meta: dict) -> None:
    """Write the carried columns of a numpy tensor dict and a JSON meta record."""
    cols = {k: np.ascontiguousarray(np.asarray(tensor[k], np.float64))
            for k in carried(tensor)}
    np.savez_compressed(path, meta=np.array(json.dumps(meta, sort_keys=True)), **cols)


def archive_meta(path=SMOKE_ARCHIVE) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["meta"]))


def load_prepared(path=SMOKE_ARCHIVE, device=None) -> dict:
    """The archive's tensor dict, float64 on `device` (CUDA unless 'cpu')."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        cols = {k: z[k] for k in z.files if k != "meta"}
    return tensor_from_numpy(cols, dev)

"""The port's input fixtures: the prepared-TOA archives, the bridge from
pint_tpu, the import boundary and the device rule.

``pint_tpu_torch/data/smoke_n16384.npz`` holds ``TimingModel.build_tensor``
of ``profiles.SMOKE_PAR`` over fake TOAs made by pint_tpu (the TZR row
last); ``pint_tpu_torch/data/flagship_n16384.npz`` that of
``profiles.flagship_smoke_dataset(16384, seed=17)`` (the flagship par,
2,048 sub-band epochs with their EFAC/EQUAD/ECORR masks and ECORR epoch
index), and ``flagship_n16384.tim`` the same TOAs as a .tim. All three are
simulated under the analytic ephemeris (``PINT_TPU_NBODY=0``);
``flagship_n16384_nbody.tim`` is the same dataset simulated under pint_tpu's
default ephemeris, the N-body window (its cold build takes about a minute).
``dd_n16384.tim`` holds ``profiles.DD_SMOKE_PAR`` (an eccentric DD binary)
over fake TOAs made by pint_tpu under the analytic ephemeris (`DD_RECIPE`);
``nanograv_n16384.tim`` ``profiles.NANOGRAV_SMOKE_PAR`` over the flagship's
epochs with white, ECORR and red noise drawn by pint_tpu (`NANOGRAV_RECIPE`);
``ddgr_n16384.tim`` and ``ddk_n16384.tim`` ``profiles.DDGR_SMOKE_PAR`` and
``profiles.DDK_SMOKE_PAR`` in `DD_RECIPE`'s layout (`DDGR_RECIPE`,
`DDK_RECIPE`); ``wideband_n16384.tim`` ``profiles.WIDEBAND_SMOKE_PAR`` over
one wideband TOA per epoch with a DM measurement each (`WIDEBAND_RECIPE`).
Write them anew with

    JAX_PLATFORMS=cpu python tests/test_torch_fixture.py --write [smoke|flagship|nbody|dd|nanograv|ddgr|ddk|wideband ...]

(all nine without names).

The helpers here (`smoke_dataset`, `port_pair`, `flagship_pair`, `dd_pair`,
`recipe_pair`, `nanograv_pair`, `wideband_pair`) also feed the other ``tests/test_torch_*.py``
files.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":  # the exporter runs without the test conftest
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("PINT_TPU_NBODY", "0")

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

#: how the archive is made (recorded in its meta entry)
ARCHIVE_RECIPE = {"par": "profiles.SMOKE_PAR", "start_mjd": 54500.0, "end_mjd": 55500.0,
                  "freq_mhz": [1400.0, 2300.0], "error_us": 1.0, "obs": "gbt",
                  "noise": True, "nbody": 0}
ARCHIVE_N = 16384
ARCHIVE_SEED = 11
FLAGSHIP_SEED = 17
FLAGSHIP_RECIPE = {"par": "profiles.FLAGSHIP_SMOKE_PAR",
                   "dataset": "profiles.flagship_smoke_dataset", "nbody": 0}
FLAGSHIP_NBODY_RECIPE = {**FLAGSHIP_RECIPE, "n": ARCHIVE_N, "seed": FLAGSHIP_SEED, "nbody": 1}
#: how the eccentric-binary .tim is made (recorded in its comment line)
DD_RECIPE = {"par": "profiles.DD_SMOKE_PAR", "n": ARCHIVE_N, "seed": 41, "start_mjd": 55000.0,
             "end_mjd": 56000.0, "freq_mhz": [1400.0, 2300.0], "error_us": 1.0, "obs": "gbt",
             "noise": True, "nbody": 0}
#: DD_RECIPE's layout for the DDGR and DDK binaries (recorded in their .tim)
DDGR_RECIPE = {**DD_RECIPE, "par": "profiles.DDGR_SMOKE_PAR", "seed": 45}
DDK_RECIPE = {**DD_RECIPE, "par": "profiles.DDK_SMOKE_PAR", "seed": 47}
#: the recipes of the binary .tim files, by name
TIM_RECIPES = {"dd": DD_RECIPE, "ddgr": DDGR_RECIPE, "ddk": DDK_RECIPE}
#: how the NANOGrav-shaped .tim is made (recorded in its comment line): the
#: flagship's epoch layout, noise drawn from the model's full covariance
NANOGRAV_RECIPE = {"par": "profiles.nanograv_smoke_par", "n_dmx": 64, "nf": 30,
                   "n": ARCHIVE_N, "seed": 43, "span_mjd": [56650.0, 57350.0],
                   "error_us": 1.0, "obs": "gbt",
                   "noise": "simulation.add_noise_from_model", "nbody": 0}

#: how the wideband .tim is made (recorded in its comment line): NANOGRAV_RECIPE's
#: span and receivers with one TOA per epoch, the receivers in turn, each
#: epoch's frequency the next of its receiver's sub-bands; white and red noise
#: drawn by pint_tpu, then each TOA's DM measurement: the model's DM, minus
#: the true DMJUMP on the 800 MHz receiver, plus a normal draw of the
#: DMEFAC/DMEQUAD-scaled error (`pp_dme` before scaling), from the same
#: generator after the TOA noise. An epoch within `dmx_edge_clearance_d` of
#: a DMX window's start moves that far past it, out of the windows' gaps
WIDEBAND_RECIPE = {"par": "profiles.wideband_smoke_par", "n_dmx": 64, "nf": 30,
                   "n": ARCHIVE_N, "seed": 49, "span_mjd": [56650.0, 57350.0],
                   "error_us": 1.0, "obs": "gbt", "toas_per_epoch": 1,
                   "dmx_edge_clearance_d": 3e-3,
                   "noise": "simulation.add_noise_from_model", "pp_dme": 1e-4,
                   "dmjump_true": 2.5e-3, "nbody": 0}


def smoke_dataset(n: int, seed: int):
    """(pint_tpu model, toas, build_tensor dict) for SMOKE_PAR over `n` fake
    TOAs, alternating 1400/2300 MHz, 1 us errors, white noise from `seed`."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu.profiles import SMOKE_PAR
    from pint_tpu.simulation import make_fake_toas_uniform

    r = ARCHIVE_RECIPE
    model = build_model(parse_parfile(SMOKE_PAR, from_text=True))
    freqs = np.where(np.arange(n) % 2 == 0, *r["freq_mhz"])
    toas = make_fake_toas_uniform(r["start_mjd"], r["end_mjd"], n, model, obs=r["obs"],
                                  freq_mhz=freqs, error_us=r["error_us"], add_noise=True,
                                  rng=np.random.default_rng(seed))
    return model, toas, model.build_tensor(toas)


def export(n: int = ARCHIVE_N, seed: int = ARCHIVE_SEED):
    """(numpy columns, meta) of a fresh export."""
    from pint_tpu_torch.prepared import COLUMNS

    _, _, tens = smoke_dataset(n, seed)
    cols = {k: np.asarray(tens[k], np.float64) for k in COLUMNS}
    return cols, {"n": n, "seed": seed, "rows": n + 1, **ARCHIVE_RECIPE}


@functools.lru_cache(maxsize=2)
def flagship_dataset(n: int, seed: int = FLAGSHIP_SEED):
    """(pint_tpu model, toas, build_tensor dict) of the flagship profile,
    made once per (n, seed) in a process: callers must not modify it."""
    from pint_tpu.profiles import flagship_smoke_dataset

    model, toas = flagship_smoke_dataset(n, seed=seed)
    return model, toas, model.build_tensor(toas)


def flagship_nbody_tim(path) -> None:
    """Write the flagship dataset simulated under pint_tpu's default
    ephemeris (``PINT_TPU_NBODY=1``: the N-body window) as a .tim, its
    recipe in a comment line after the header's first line."""
    import json

    from pint_tpu.profiles import flagship_smoke_dataset

    r = FLAGSHIP_NBODY_RECIPE
    old = os.environ.get("PINT_TPU_NBODY")
    os.environ["PINT_TPU_NBODY"] = "1"
    try:
        _, toas = flagship_smoke_dataset(r["n"], seed=r["seed"])
    finally:
        os.environ["PINT_TPU_NBODY"] = old if old is not None else "0"
    toas.write_tim(str(path))
    lines = Path(path).read_text().splitlines(keepends=True)
    lines.insert(1, f"C Recipe: {json.dumps(r, sort_keys=True)}\n")
    Path(path).write_text("".join(lines))


def recipe_par(recipe: dict) -> str:
    """The port's par text a recipe names (``profiles.<NAME>``)."""
    from pint_tpu_torch import profiles

    return getattr(profiles, recipe["par"].removeprefix("profiles."))


@functools.lru_cache(maxsize=4)
def recipe_dataset(name: str, n: int, seed: int | None = None):
    """(pint_tpu model, toas, build_tensor dict) of the `TIM_RECIPES[name]`
    par over `n` fake TOAs made as the recipe says (alternating frequencies,
    white noise from its seed, or `seed`), once per arguments in a process:
    callers must not modify it."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu.simulation import make_fake_toas_uniform

    r = TIM_RECIPES[name]
    model = build_model(parse_parfile(recipe_par(r), from_text=True))
    freqs = np.where(np.arange(n) % 2 == 0, *r["freq_mhz"])
    toas = make_fake_toas_uniform(r["start_mjd"], r["end_mjd"], n, model, obs=r["obs"],
                                  freq_mhz=freqs, error_us=r["error_us"], add_noise=r["noise"],
                                  rng=np.random.default_rng(r["seed"] if seed is None else seed))
    return model, toas, model.build_tensor(toas)


def dd_dataset(n: int, seed: int = DD_RECIPE["seed"]):
    """`recipe_dataset` of profiles.DD_SMOKE_PAR (`DD_RECIPE`)."""
    return recipe_dataset("dd", n, None if seed == DD_RECIPE["seed"] else seed)


def recipe_tim(name: str, path) -> None:
    """Write the `TIM_RECIPES[name]` dataset as a .tim (pint_tpu's
    ``TOAs.write_tim``), its recipe in a comment line after the header's
    first line."""
    import json

    r = TIM_RECIPES[name]
    _, toas, _ = recipe_dataset(name, r["n"])
    toas.write_tim(str(path))
    lines = Path(path).read_text().splitlines(keepends=True)
    lines.insert(1, f"C Recipe: {json.dumps(r, sort_keys=True)}\n")
    Path(path).write_text("".join(lines))


def dd_tim(path) -> None:
    recipe_tim("dd", path)


def recipe_pair(name: str, n: int = 1024, par: str | None = None):
    """(pint_tpu model, toas, tensor, port model, port tensor) on the CPU of
    the `TIM_RECIPES[name]` dataset, both models parsed from `par` (default
    the recipe's own)."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.prepared import tensor_from_numpy

    model, toas, tens = recipe_dataset(name, n)
    if par is not None:
        model = build_model(parse_parfile(par, from_text=True))
    tm = get_model(par or recipe_par(TIM_RECIPES[name]), from_text=True, device="cpu")
    tt = tensor_from_numpy({k: np.asarray(v) for k, v in tens.items()}, device="cpu")
    return model, toas, tens, tm, tt


def dd_pair(n: int = 1024, binary: str = "DD"):
    """(pint_tpu model, toas, tensor, port model, port tensor) on the CPU of
    the DD dataset, both models parsed from ``profiles.dd_smoke_par(binary)``
    (BT, DD or DDS over the same TOAs)."""
    from pint_tpu_torch.profiles import dd_smoke_par

    return recipe_pair("dd", n, None if binary == "DD" else dd_smoke_par(binary))


@functools.lru_cache(maxsize=4)
def nanograv_dataset(n: int, seed: int = NANOGRAV_RECIPE["seed"], n_dmx: int = 64, nf: int = 30,
                     dm_noise: bool = False):
    """(pint_tpu model, toas, build_tensor dict) of
    ``profiles.nanograv_smoke_par(n_dmx, nf, dm_noise)`` over the flagship's
    epoch layout (n / 8 epochs of 8 sub-bands, the two receivers in turn),
    made exactly on the model, then moved by one draw of its white, ECORR
    and red (and DM) noise from `seed`; once per arguments in a process:
    callers must not modify it. Every row lies in exactly one DMX window."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu.profiles import RECEIVERS
    from pint_tpu.simulation import add_noise_from_model, make_fake_toas_fromMJDs
    from pint_tpu_torch.profiles import nanograv_smoke_par

    r = NANOGRAV_RECIPE
    model = build_model(parse_parfile(nanograv_smoke_par(n_dmx, nf, dm_noise), from_text=True))
    per_epoch = len(RECEIVERS[0][1])
    mjds, freqs, flags = [], [], []
    for i, emjd in enumerate(np.linspace(*r["span_mjd"], max(n // per_epoch, 2))):
        fname, subbands = RECEIVERS[i % len(RECEIVERS)]
        for j, f in enumerate(subbands):
            mjds.append(emjd + j * 0.1 / 86400.0)
            freqs.append(f)
            flags.append({"f": fname, "fe": fname.split("_GUPPI")[0]})
    rng = np.random.default_rng(seed)
    toas = make_fake_toas_fromMJDs(np.array(mjds), model, obs=r["obs"],
                                   freq_mhz=np.array(freqs), error_us=r["error_us"],
                                   flags=flags)
    toas = add_noise_from_model(toas, model, rng=rng)
    tens = model.build_tensor(toas)
    per_row = np.asarray(tens["dmx_onehot"]).sum(axis=1)
    if not np.all(per_row == 1.0):
        raise AssertionError(f"{int(np.sum(per_row != 1.0))} rows not in exactly one DMX window")
    return model, toas, tens


def nanograv_tim(path) -> None:
    """Write the `NANOGRAV_RECIPE` dataset as a .tim, its recipe in a comment
    line after the header's first line."""
    import json

    r = NANOGRAV_RECIPE
    _, toas, _ = nanograv_dataset(r["n"], r["seed"], r["n_dmx"], r["nf"])
    toas.write_tim(str(path))
    lines = Path(path).read_text().splitlines(keepends=True)
    lines.insert(1, f"C Recipe: {json.dumps(r, sort_keys=True)}\n")
    Path(path).write_text("".join(lines))


def nanograv_pair(n: int = 1024, n_dmx: int = 8, nf: int = 10, dm_noise: bool = False):
    """(pint_tpu model, toas, tensor, port model, port tensor) on the CPU of
    the NANOGrav-shaped dataset at a narrow width (p = 12 + n_dmx + 4, 2 nf
    Fourier columns per power-law process)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.prepared import tensor_from_numpy
    from pint_tpu_torch.profiles import nanograv_smoke_par

    model, toas, tens = nanograv_dataset(n, NANOGRAV_RECIPE["seed"], n_dmx, nf, dm_noise)
    tm = get_model(nanograv_smoke_par(n_dmx, nf, dm_noise), from_text=True, device="cpu")
    tt = tensor_from_numpy({k: np.asarray(v) for k, v in tens.items()}, device="cpu")
    return model, toas, tens, tm, tt


@functools.lru_cache(maxsize=4)
def wideband_dataset(n: int, seed: int = WIDEBAND_RECIPE["seed"], n_dmx: int = 64,
                     nf: int = 30):
    """(pint_tpu model, toas, build_tensor dict) of
    ``profiles.wideband_smoke_par(n_dmx, nf)`` over `n` wideband TOAs made
    by `WIDEBAND_RECIPE`; once per arguments in a process: callers must not
    modify it. Every row lies in exactly one DMX window."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu.profiles import RECEIVERS
    from pint_tpu.simulation import add_noise_from_model, make_fake_toas_fromMJDs
    from pint_tpu_torch.profiles import DMX_SPAN_MJD, wideband_smoke_par

    r = WIDEBAND_RECIPE
    model = build_model(parse_parfile(wideband_smoke_par(n_dmx, nf), from_text=True))
    epochs = np.linspace(*r["span_mjd"], n)
    clear = r["dmx_edge_clearance_d"]
    for start in np.linspace(*DMX_SPAN_MJD, n_dmx + 1)[1:-1]:
        near = np.abs(epochs - start) < clear
        epochs[near] = start + clear
    mjds, freqs, flags = [], [], []
    for i, emjd in enumerate(epochs):
        fname, subbands = RECEIVERS[i % len(RECEIVERS)]
        mjds.append(emjd)
        freqs.append(subbands[(i // len(RECEIVERS)) % len(subbands)])
        flags.append({"f": fname, "fe": fname.split("_GUPPI")[0]})
    rng = np.random.default_rng(seed)
    toas = make_fake_toas_fromMJDs(np.array(mjds), model, obs=r["obs"],
                                   freq_mhz=np.array(freqs), error_us=r["error_us"],
                                   flags=flags)
    toas = add_noise_from_model(toas, model, rng=rng)
    tens = model.build_tensor(toas)
    dm = np.asarray(model.total_dm(model.xprec.convert_params(model.params), tens))
    # the scaled error of each row: DMEFAC * hypot(pp_dme, DMEQUAD) of its receiver
    scale = {}
    for mp in model["ScaleDmError"].mask_params:
        scale.setdefault(mp.clause.as_parfile_tokens()[-1], {})[mp.base] = \
            float(np.asarray(model.params[mp.name]))
    for i, f in enumerate(toas.flags):
        sc = scale[f["f"]]
        sigma = sc["DMEFAC"] * float(np.hypot(r["pp_dme"], sc["DMEQUAD"]))
        meas = dm[i] - (r["dmjump_true"] if f["f"] == "Rcvr_800_GUPPI" else 0.0) \
            + rng.standard_normal() * sigma
        f["pp_dm"], f["pp_dme"] = repr(float(meas)), repr(r["pp_dme"])
    tens = model.build_tensor(toas)
    per_row = np.asarray(tens["dmx_onehot"]).sum(axis=1)
    if not np.all(per_row == 1.0):
        raise AssertionError(f"{int(np.sum(per_row != 1.0))} rows not in exactly one DMX window")
    return model, toas, tens


def wideband_tim(path) -> None:
    """Write the `WIDEBAND_RECIPE` dataset as a .tim, its recipe in a comment
    line after the header's first line."""
    import json

    r = WIDEBAND_RECIPE
    _, toas, _ = wideband_dataset(r["n"], r["seed"], r["n_dmx"], r["nf"])
    toas.write_tim(str(path))
    lines = Path(path).read_text().splitlines(keepends=True)
    lines.insert(1, f"C Recipe: {json.dumps(r, sort_keys=True)}\n")
    Path(path).write_text("".join(lines))


def wideband_pair(n: int = 1024, n_dmx: int = 8, nf: int = 10):
    """(pint_tpu model, toas, tensor, port model, port tensor) on the CPU of
    the wideband dataset at a narrow width (p = 12 + n_dmx + 5, 2 nf
    Fourier columns)."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.prepared import tensor_from_numpy
    from pint_tpu_torch.profiles import wideband_smoke_par

    model, toas, tens = wideband_dataset(n, WIDEBAND_RECIPE["seed"], n_dmx, nf)
    tm = get_model(wideband_smoke_par(n_dmx, nf), from_text=True, device="cpu")
    tt = tensor_from_numpy({k: np.asarray(v) for k, v in tens.items()}, device="cpu")
    return model, toas, tens, tm, tt


def flagship_export(n: int = ARCHIVE_N, seed: int = FLAGSHIP_SEED):
    """(numpy columns, meta) of a fresh flagship export."""
    from pint_tpu_torch.prepared import carried

    _, toas, tens = flagship_dataset(n, seed)
    cols = {k: np.asarray(tens[k], np.float64) for k in carried(tens)}
    ke = int(cols["ecorr_widx"].shape[1])
    # pint_tpu's fake-TOA iteration reuses the geometry columns across
    # sub-10-us time shifts and records the total shift: the positions are
    # those of times up to geom_stale_s away from the archive's t
    return cols, {"n": n, "seed": seed, "rows": n + 1, "epochs": ke,
                  "geom_stale_s": float(toas.geom_stale_s), **FLAGSHIP_RECIPE}


def flagship_pair(n: int = 1024, seed: int = FLAGSHIP_SEED):
    """(pint_tpu model, toas, tensor, port model, port tensor) of the
    flagship profile on the CPU, the port's model parsed from its own copy
    of FLAGSHIP_SMOKE_PAR."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.prepared import tensor_from_numpy
    from pint_tpu_torch.profiles import FLAGSHIP_SMOKE_PAR

    model, toas, tens = flagship_dataset(n, seed)
    tm = get_model(FLAGSHIP_SMOKE_PAR, from_text=True, device="cpu")
    tt = tensor_from_numpy({k: np.asarray(v) for k, v in tens.items()}, device="cpu")
    return model, toas, tens, tm, tt


def params_numpy(params: dict) -> dict:
    """pint_tpu parameters as numpy: floats, dd leaves as (hi, lo)."""
    return {k: (float(v.hi), float(v.lo)) if hasattr(v, "hi") else float(v)
            for k, v in params.items()}


def port_pair(n: int = 1024, seed: int = ARCHIVE_SEED):
    """(pint_tpu model, toas, tensor, port model, port tensor) on the CPU:
    the same fake TOAs in both packages, the port's model parsed from its
    own copy of SMOKE_PAR."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.prepared import tensor_from_numpy
    from pint_tpu_torch.profiles import SMOKE_PAR

    model, toas, tens = smoke_dataset(n, seed)
    tm = get_model(SMOKE_PAR, from_text=True, device="cpu")
    tt = tensor_from_numpy({k: np.asarray(v) for k, v in tens.items()}, device="cpu")
    return model, toas, tens, tm, tt


# --- the archive ---------------------------------------------------------------


def test_archive_matches_fresh_export():
    from pint_tpu_torch.prepared import COLUMNS, SMOKE_ARCHIVE, archive_meta, load_prepared

    cols, meta = export()
    assert archive_meta(SMOKE_ARCHIVE) == meta
    got = load_prepared(SMOKE_ARCHIVE, device="cpu")
    assert set(got) == set(COLUMNS)
    for k in ("error_s", "freq_mhz"):
        np.testing.assert_array_equal(got[k].numpy(), cols[k], err_msg=k)
    for k in ("t_hi", "t_lo", "ssb_obs_pos_ls", "ssb_obs_vel_ls", "obs_sun_pos_ls"):
        want = cols[k]
        scale = np.abs(cols["t_hi"]) if k == "t_lo" else np.abs(want)
        err = np.abs(got[k].numpy() - want)
        assert np.all(err <= 1e-12 * np.maximum(scale, np.finfo(float).tiny)), k
    assert got["t_hi"].shape[0] == meta["rows"]


def test_flagship_archive_matches_fresh_export():
    from pint_tpu_torch.prepared import FLAGSHIP_ARCHIVE, archive_meta, carried, load_prepared

    cols, meta = flagship_export()
    assert archive_meta(FLAGSHIP_ARCHIVE) == meta
    got = load_prepared(FLAGSHIP_ARCHIVE, device="cpu")
    assert list(got) == carried(cols)
    assert got["ecorr_widx"].shape == (1, meta["epochs"]) and meta["epochs"] == 2048
    for k, want in cols.items():
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
    assert got["t_hi"].shape[0] == meta["rows"]


def test_flagship_tim_matches_fresh_export(tmp_path):
    """The committed .tim parses to the lines of a fresh export (the
    provenance C lines differ, so lines and not bytes are compared)."""
    from pint_tpu.io.tim import parse_tim
    from pint_tpu_torch.prepared import FLAGSHIP_TIM

    _, toas, _ = flagship_dataset(ARCHIVE_N)
    toas.write_tim(str(tmp_path / "fresh.tim"))
    fresh, committed = parse_tim(str(tmp_path / "fresh.tim")), parse_tim(str(FLAGSHIP_TIM))
    assert len(committed.toas) == ARCHIVE_N
    assert [vars(t) for t in committed.toas] == [vars(t) for t in fresh.toas]


@pytest.mark.slow
def test_flagship_nbody_tim_matches_fresh_export(tmp_path, monkeypatch):
    """The committed N-body .tim parses to the lines of a fresh export
    under pint_tpu's default ephemeris (a cold 12-year window build, ~1
    minute), and records its recipe."""
    import json

    from pint_tpu.io.tim import parse_tim
    from pint_tpu_torch.prepared import FLAGSHIP_NBODY_TIM

    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    flagship_nbody_tim(tmp_path / "fresh.tim")
    fresh, committed = parse_tim(str(tmp_path / "fresh.tim")), parse_tim(str(FLAGSHIP_NBODY_TIM))
    assert len(committed.toas) == ARCHIVE_N
    assert [vars(t) for t in committed.toas] == [vars(t) for t in fresh.toas]
    recipe = FLAGSHIP_NBODY_TIM.read_text().splitlines()[1]
    assert json.loads(recipe.removeprefix("C Recipe: ")) == FLAGSHIP_NBODY_RECIPE


def test_dd_tim_matches_fresh_export(tmp_path):
    """The committed eccentric-binary .tim parses to the lines of a fresh
    export of `DD_RECIPE`, and records the recipe."""
    import json

    from pint_tpu.io.tim import parse_tim
    from pint_tpu_torch.prepared import DD_TIM

    dd_tim(tmp_path / "fresh.tim")
    fresh, committed = parse_tim(str(tmp_path / "fresh.tim")), parse_tim(str(DD_TIM))
    assert len(committed.toas) == DD_RECIPE["n"]
    assert [vars(t) for t in committed.toas] == [vars(t) for t in fresh.toas]
    recipe = DD_TIM.read_text().splitlines()[1]
    assert json.loads(recipe.removeprefix("C Recipe: ")) == DD_RECIPE


@pytest.mark.parametrize("name", ["ddgr", "ddk"])
def test_binary_tim_matches_fresh_export(tmp_path, name):
    """The committed DDGR and DDK .tim files parse to the lines of a fresh
    export of their recipe (`DD_RECIPE`'s layout), and record it."""
    import json

    from pint_tpu.io.tim import parse_tim
    from pint_tpu_torch import prepared

    path = getattr(prepared, f"{name.upper()}_TIM")
    recipe_tim(name, tmp_path / "fresh.tim")
    fresh, committed = parse_tim(str(tmp_path / "fresh.tim")), parse_tim(str(path))
    assert len(committed.toas) == TIM_RECIPES[name]["n"]
    assert [vars(t) for t in committed.toas] == [vars(t) for t in fresh.toas]
    recipe = path.read_text().splitlines()[1]
    assert json.loads(recipe.removeprefix("C Recipe: ")) == TIM_RECIPES[name]


def test_nanograv_tim_matches_fresh_export(tmp_path):
    """The committed NANOGrav-shaped .tim parses to the lines of a fresh
    export of `NANOGRAV_RECIPE`, and records the recipe."""
    import json

    from pint_tpu.io.tim import parse_tim
    from pint_tpu_torch.prepared import NANOGRAV_TIM

    nanograv_tim(tmp_path / "fresh.tim")
    fresh, committed = parse_tim(str(tmp_path / "fresh.tim")), parse_tim(str(NANOGRAV_TIM))
    assert len(committed.toas) == NANOGRAV_RECIPE["n"]
    assert [vars(t) for t in committed.toas] == [vars(t) for t in fresh.toas]
    recipe = NANOGRAV_TIM.read_text().splitlines()[1]
    assert json.loads(recipe.removeprefix("C Recipe: ")) == NANOGRAV_RECIPE


def test_wideband_tim_matches_fresh_export(tmp_path):
    """The committed wideband .tim parses to the lines of a fresh export of
    `WIDEBAND_RECIPE` (its -pp_dm/-pp_dme flags included), and records the
    recipe."""
    import json

    from pint_tpu.io.tim import parse_tim
    from pint_tpu_torch.prepared import WIDEBAND_TIM

    wideband_tim(tmp_path / "fresh.tim")
    fresh, committed = parse_tim(str(tmp_path / "fresh.tim")), parse_tim(str(WIDEBAND_TIM))
    assert len(committed.toas) == WIDEBAND_RECIPE["n"]
    assert all("pp_dm" in t.flags and "pp_dme" in t.flags for t in committed.toas)
    assert [vars(t) for t in committed.toas] == [vars(t) for t in fresh.toas]
    recipe = WIDEBAND_TIM.read_text().splitlines()[1]
    assert json.loads(recipe.removeprefix("C Recipe: ")) == WIDEBAND_RECIPE


def test_flagship_tim_prepares_to_the_archive(tmp_path, monkeypatch):
    """pint_tpu's prepare of the committed .tim gives the archive's columns:
    t (hi + lo) within 5 ps (the tim's 16 decimals of a day round each UTC
    by <= 4.3 ps), masks and ECORR columns exact, positions within 1 mm
    plus the archive's recorded geometry staleness: the fake-TOA iteration
    that made it moved the times by up to ``geom_stale_s`` (4.1 us) without
    recomputing the positions, which are thus up to |v| geom_stale_s
    (~0.12 m) from those of its own times."""
    from pint_tpu.toas import get_TOAs
    from pint_tpu_torch.prepared import FLAGSHIP_ARCHIVE, FLAGSHIP_TIM, archive_meta

    monkeypatch.setenv("PINT_TPU_CACHE_DIR", str(tmp_path))
    model, _, _ = flagship_dataset(ARCHIVE_N)
    tens = model.build_tensor(get_TOAs(str(FLAGSHIP_TIM), model=model))
    with np.load(FLAGSHIP_ARCHIVE) as z:
        arch = {k: z[k] for k in z.files if k != "meta"}
    dt = (np.asarray(tens["t_hi"]) - arch["t_hi"]) + (np.asarray(tens["t_lo"]) - arch["t_lo"])
    assert np.max(np.abs(dt)) <= 5e-12
    stale = archive_meta(FLAGSHIP_ARCHIVE)["geom_stale_s"]
    assert 0 < stale < 1e-5
    speed = np.linalg.norm(arch["ssb_obs_vel_ls"], axis=1)  # light-seconds per second
    for k in ("ssb_obs_pos_ls", "obs_sun_pos_ls"):
        err = np.linalg.norm(np.asarray(tens[k]) - arch[k], axis=1)
        assert np.all(err <= speed * stale + 1e-3 / 299792458.0), k
    noise = [k for k in arch if k.startswith(("mask_", "ecorr_"))]
    assert len(noise) == 8
    for k in noise:
        assert np.array_equal(np.asarray(tens[k]), arch[k]), k


def test_bridge_round_trips_noise_columns():
    """mask_*, ecorr_eidx and ecorr_widx of the flagship tensor cross the
    bridge exactly, and the port's model reads the same noise parameters."""
    from pint_tpu_torch.prepared import tensor_from_numpy

    model, _, tens, tm, _ = flagship_pair(n=64)
    tt = tensor_from_numpy({k: np.asarray(v) for k, v in tens.items()}, device="cpu")
    noise = [k for k in tens if k.startswith("mask_") or k.startswith("ecorr_")]
    assert sorted(noise) == sorted(
        ["ecorr_eidx", "ecorr_widx"] + [f"mask_{b}{i}" for b in ("EFAC", "EQUAD", "ECORR")
                                        for i in (1, 2)])
    for k in noise:
        assert tt[k].dtype == torch.float64
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(tens[k]), err_msg=k)
    assert tt["ecorr_widx"].shape[0] == 1 and tt["ecorr_eidx"][-1] == -1
    assert params_numpy({k: model.params[k] for k in model.params}) == params_numpy(
        {k: tm.params[k] for k in model.params})
    assert tm.free_params == model.free_params


def test_bridge_round_trips_tensor_and_params():
    from pint_tpu_torch.ops.dd import DD
    from pint_tpu_torch.prepared import COLUMNS, params_from_numpy, tensor_from_numpy

    model, _, tens, tm, _ = port_pair(n=64)
    tt = tensor_from_numpy({k: np.asarray(v) for k, v in tens.items()}, device="cpu")
    for k in COLUMNS:
        assert tt[k].dtype == torch.float64
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(tens[k]), err_msg=k)
    pnp = params_numpy(model.params)
    pp = params_from_numpy(pnp, device="cpu")
    assert set(pp) == set(model.params) == set(tm.params)
    for k, v in pnp.items():
        for name, got in (("bridge", pp[k]), ("parsed", tm.params[k])):
            if isinstance(v, tuple):
                assert isinstance(got, DD), (name, k)
                assert (float(got.hi), float(got.lo)) == v, (name, k)
            else:
                assert float(got) == v, (name, k)
    assert set(tm.free_params) == set(model.free_params)


def test_tensor_bridge_rejects_unported_columns():
    from pint_tpu_torch.prepared import tensor_from_numpy

    cols = {k: np.zeros(3) for k in ("t_hi", "t_lo", "error_s", "freq_mhz")}
    cols["obs_jupiter_pos_ls"] = np.zeros((3, 3))
    with pytest.raises(NotImplementedError, match="obs_jupiter_pos_ls"):
        tensor_from_numpy(cols, device="cpu")


# --- the import boundary and the device rule ------------------------------------


def test_port_imports_no_jax_and_nothing_of_pint_tpu():
    code = (
        "import sys\n"
        "import pint_tpu_torch, pint_tpu_torch.fitting, pint_tpu_torch.gridutils\n"
        "import pint_tpu_torch.prepared, pint_tpu_torch.ops.build, pint_tpu_torch.profiles\n"
        "import pint_tpu_torch.toas, pint_tpu_torch.io.tim, pint_tpu_torch.astro.time\n"
        "import pint_tpu_torch.astro.clock, pint_tpu_torch.astro.observatories\n"
        "import pint_tpu_torch.astro.eop, pint_tpu_torch.astro.erot, pint_tpu_torch.astro.vsop87\n"
        "import pint_tpu_torch.astro.vsop87_planets, pint_tpu_torch.astro.ephemeris\n"
        "import pint_tpu_torch.astro.device_prepare, pint_tpu_torch.astro.nbody\n"
        "import pint_tpu_torch.astro.spk, pint_tpu_torch.astro.spk_write\n"
        "import pint_tpu_torch.astro.kernel_ephemeris, pint_tpu_torch.models.binaries.kepler\n"
        "import pint_tpu_torch.fitting.pta_like, pint_tpu_torch.simulation\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'pint_tpu' or m.startswith('pint_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.prepared import load_prepared, params_from_numpy
    from pint_tpu_torch.profiles import SMOKE_PAR

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(SMOKE_PAR, from_text=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_prepared()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"F0": 1.0})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(SMOKE_PAR, from_text=True, device="cuda")
    from pint_tpu_torch.io.tim import TOALine
    from pint_tpu_torch.models import get_model_and_toas
    from pint_tpu_torch.prepared import FLAGSHIP_TIM
    from pint_tpu_torch.toas import get_TOAs, prepare_TOAs

    line = TOALine("x", 1400.0, 57000, 0.25, 0.0, 1.0, "gbt")
    for call in (lambda: get_TOAs(str(FLAGSHIP_TIM)), lambda: prepare_TOAs([line]),
                 lambda: get_model_and_toas("unused.par", str(FLAGSHIP_TIM))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert get_model(SMOKE_PAR, from_text=True, device="cpu").device.type == "cpu"


def _write_archive(which) -> None:
    from pint_tpu_torch import prepared
    from pint_tpu_torch.prepared import (FLAGSHIP_ARCHIVE, FLAGSHIP_NBODY_TIM, FLAGSHIP_TIM,
                                         NANOGRAV_TIM, SMOKE_ARCHIVE, save_prepared)

    for name, path, make in (("smoke", SMOKE_ARCHIVE, export),
                             ("flagship", FLAGSHIP_ARCHIVE, flagship_export)):
        if name in which:
            cols, meta = make()
            path.parent.mkdir(parents=True, exist_ok=True)
            save_prepared(path, cols, meta)
            print(f"wrote {path} ({path.stat().st_size} bytes, {meta['rows']} rows)")
    if "flagship" in which:
        _, toas, _ = flagship_dataset(ARCHIVE_N)
        toas.write_tim(str(FLAGSHIP_TIM))
        print(f"wrote {FLAGSHIP_TIM} ({FLAGSHIP_TIM.stat().st_size} bytes, {len(toas)} TOAs)")
    if "nbody" in which:
        flagship_nbody_tim(FLAGSHIP_NBODY_TIM)
        print(f"wrote {FLAGSHIP_NBODY_TIM} ({FLAGSHIP_NBODY_TIM.stat().st_size} bytes)")
    for name in TIM_RECIPES:
        if name in which:
            path = getattr(prepared, f"{name.upper()}_TIM")
            recipe_tim(name, path)
            print(f"wrote {path} ({path.stat().st_size} bytes)")
    if "nanograv" in which:
        nanograv_tim(NANOGRAV_TIM)
        print(f"wrote {NANOGRAV_TIM} ({NANOGRAV_TIM.stat().st_size} bytes)")
    if "wideband" in which:
        wideband_tim(prepared.WIDEBAND_TIM)
        print(f"wrote {prepared.WIDEBAND_TIM} ({prepared.WIDEBAND_TIM.stat().st_size} bytes)")


if __name__ == "__main__":
    names = {"smoke", "flagship", "nbody", "dd", "nanograv", "ddgr", "ddk", "wideband"}
    if sys.argv[1:2] != ["--write"] or not set(sys.argv[2:]) <= names:
        sys.exit("usage: python tests/test_torch_fixture.py --write "
                 "[smoke|flagship|nbody|dd|nanograv|ddgr|ddk|wideband ...]")
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    _write_archive(set(sys.argv[2:]) or names)

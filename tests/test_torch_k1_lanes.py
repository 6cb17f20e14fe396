"""Kernel K1's lane plan, the identity its DMX lane rests on, and its launch
path's packer, on the CPU.

(a) ``csrc/k1_plan.h`` built with the host's C++ compiler: every fixture
model's fit and grid lanes, in order and shuffled, split into the dense
lanes (one kernel lane each, in the caller's order), the DMX lanes (one
kernel lane after them) and the JUMP lanes (none), every caller's lane
mapped back to its row of the outputs exactly once; refusals.

(b) On a NANOGrav-shaped par whose DMX windows overlap (a row in two
windows, rows in none, the TZR row in a window), built by both packages: a
Python copy of the kernel's scatter rebuilds the twin's DMX columns from one
value per row and the TZR row's value; the JUMP column is F0 mask - F0
mask_tzr; and the twin's DMX and JUMP columns match pint_tpu's jax.linearize
columns within 1e-10 relative, the bound ``tests/test_torch_nanograv.py``
holds K1's twin to.

(c) The packer of the launch path equals the column-by-column packer it
replaced (copied here as `pack_params_reference`) bitwise for every fixture
model at B = 1 and 9, and a second call through the same cached setup with
moved parameter values packs the new values. The kernel's own parity with the twin is
``chip_smoke.py``'s.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu_torch import profiles
from pint_tpu_torch import residuals as rs

CSRC = Path(rs.__file__).resolve().parent / "csrc"
#: the fixture models: the pars of chip_smoke.py's phases
PARS = {"smoke": profiles.SMOKE_PAR, "flagship": profiles.FLAGSHIP_SMOKE_PAR,
        "dd": profiles.DD_SMOKE_PAR, "bt": profiles.dd_smoke_par("BT"),
        "dds": profiles.dd_smoke_par("DDS"), "nanograv": profiles.NANOGRAV_SMOKE_PAR,
        "wideband": profiles.WIDEBAND_SMOKE_PAR, "ddgr": profiles.DDGR_SMOKE_PAR,
        "ddk": profiles.DDK_SMOKE_PAR, "ell1h-stigma": profiles.ell1h_smoke_par("stigma"),
        "ell1h-h4": profiles.ell1h_smoke_par("h4"), "ell1h-h3": profiles.ell1h_smoke_par("h3"),
        "ell1k": profiles.ELL1K_SMOKE_PAR, "fb": profiles.fb_smoke_par()}


def port_model(par: str):
    from pint_tpu_torch.models import get_model

    return get_model(par, from_text=True, device="cpu")


@pytest.fixture(scope="module")
def models():
    return {name: port_model(par) for name, par in PARS.items()}


def grid_names(model) -> tuple:
    """The parameters of the model's 3x3 grid (``profiles.grid_for``'s)."""
    for key, grid in profiles.BINARY_GRIDS.items():
        if key in model.param_meta:
            return grid[0]
    if "M2" in model.param_meta and "SINI" in model.param_meta:
        return ("M2", "SINI")
    return ("F0", "F1")


def lane_sets(model):
    """{label: lanes}: the fit's (every lane, as the GLS fits; the nonlinear
    ones, as the WLS fits) and the grid's, each also shuffled."""
    from pint_tpu_torch.fitting.design import linear_split

    free = tuple(model.free_params)
    grid = tuple(n for n in free if n not in grid_names(model))
    sets = {"every": free, "nonlinear": linear_split(model, free)[0],
            "grid": linear_split(model, grid)[0], "grid every": grid}
    sets = {k: rs.lane_names(v, model) for k, v in sets.items()}  # DMJUMP has no lane
    rng = np.random.default_rng(13)
    for k in list(sets):
        sets[f"{k} shuffled"] = tuple(rng.permutation(np.array(sets[k], dtype=object)))
    return sets


# --- (a) the lane plan ------------------------------------------------------------


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """k1_plan.h built for the host, exporting resid_tangent_plan."""
    out = tmp_path_factory.mktemp("k1_plan")
    src = out / "k1_plan.cc"
    src.write_text('#include "k1_plan.h"\nPINT_EXPORT_K1_PLAN\n')
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "no host C++ compiler"
    subprocess.run([cxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared", "-fPIC", "-I",
                    str(CSRC), str(src), "-o", str(out / "libk1_plan.so")], check=True)
    lib = ctypes.CDLL(str(out / "libk1_plan.so"))
    lib.resid_tangent_plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                       ctypes.POINTER(rs.K1Plan)]
    lib.resid_tangent_plan.restype = ctypes.c_int
    return lib


def plan_of(lib, model, lanes, B=1, n_rows=1025):
    st = rs._structure(model)
    codes = [rs.lane_code(n, model) for n in lanes]
    ints = rs._k1_ints(st, codes, n_rows, n_rows - 1, True, False, False)
    return codes, rs.k1_plan(lib, ints, B)


@pytest.mark.parametrize("name", sorted(PARS))
def test_lane_plan_splits_and_maps_back(plan_lib, models, name):
    model = models[name]
    st = rs._structure(model)
    for label, lanes in lane_sets(model).items():
        for B in (1, 9):
            codes, plan = plan_of(plan_lib, model, lanes, B)
            dmx = [i for i, c in enumerate(codes) if rs.L_DMX0 <= c < rs.L_FB0]
            jump = [i for i, c in enumerate(codes) if rs.L_JUMP0 <= c < rs.L_DMX0]
            dense = [i for i in range(len(codes)) if i not in dmx and i not in jump]
            tag = f"{name} {label} B={B}"
            assert plan.n_klane == len(dense) + bool(dmx), tag
            assert list(plan.code[:len(dense)]) == [codes[i] for i in dense], tag
            assert list(plan.pos[:len(dense)]) == dense, tag
            if dmx:
                assert plan.dmx_lane == len(dense), tag
                assert (plan.code[plan.dmx_lane], plan.pos[plan.dmx_lane]) == (511, -1), tag
            else:
                assert plan.dmx_lane == -1, tag
            assert [plan.dmx_pos[codes[i] - rs.L_DMX0] for i in dmx] == dmx, tag
            assert [plan.jump_pos[codes[i] - rs.L_JUMP0] for i in jump] == jump, tag
            # every caller's lane has one row of the outputs, and no other row is written
            rows = [p for p in plan.pos[:plan.n_klane] if p >= 0] + \
                [p for p in plan.dmx_pos if p >= 0] + [p for p in plan.jump_pos if p >= 0]
            assert sorted(rows) == list(range(len(codes))), tag
            assert plan.width == (2 if plan.n_klane > 1 else 1), tag
            assert plan.groups == max(1, -(-plan.n_klane // plan.width)), tag
            assert all(c == -1 for c in plan.code[plan.n_klane:]), tag
            assert plan.n_slots >= 2 + 8 * st.has_ast, tag
            assert plan.scratch == B * plan.n_slots * 1025 + B * plan.n_klane, tag


def test_lane_plan_takes_the_nanograv_fit_in_sixteen_kernel_lanes(plan_lib, models):
    """NANOGrav's 80 fit lanes: 12 nonlinear and 3 FD lanes, one DMX lane,
    no JUMP lane: 16 kernel lanes, 8 groups of 2."""
    model = models["nanograv"]
    for label in ("every", "every shuffled"):
        _, plan = plan_of(plan_lib, model, lane_sets(model)[label], 1, 16385)
        assert (plan.n_klane, plan.width, plan.groups) == (16, 2, 8), label


def test_lane_plan_refuses_what_the_kernel_does_not_take(plan_lib, models):
    model = models["nanograv"]
    st = rs._structure(model)
    codes = [rs.lane_code(n, model) for n in ("F0", "DMX_0001", "DMX_0001")]
    for bad in (codes, codes[:2] + [rs.L_DMX0 + 64], [rs.L_JUMP0 + 1]):
        ints = rs._k1_ints(st, bad, 1025, 1024, True, False, False)
        with pytest.raises(ValueError, match="K1"):
            rs.k1_plan(plan_lib, ints, 1)
    for n_batch in (0, 65536):  # beyond the grid's sets
        ints = rs._k1_ints(st, codes[:2], 1025, 1024, True, False, False)
        with pytest.raises(ValueError, match="K1"):
            rs.k1_plan(plan_lib, ints, n_batch)
    with pytest.raises(ValueError, match="once"):
        rs._K1Setup(model, ("F0", "DMX_0001", "DMX_0001"))


def test_plan_takes_two_lanes_a_thread(plan_lib, models):
    """The plan's width: 2 lanes a thread (k1_plan.h DEFAULT_WIDTH, the
    fastest on the H100 at the main path's shapes), 1 for one kernel lane."""
    for name, lanes, want in (("flagship", None, 2), ("smoke", ("F0",), 1),
                              ("nanograv", tuple(f"DMX_{j:04d}" for j in range(1, 9)), 1),
                              ("nanograv", ("F0", "DMX_0001", "JUMP1"), 2)):
        model = models[name]
        lanes = lanes or lane_sets(model)["every"]
        for B, n_rows in ((1, 16385), (9, 16385), (64, 8193)):
            _, plan = plan_of(plan_lib, model, lanes, B, n_rows)
            assert plan.width == want, (name, lanes, B)


# --- (b) the identity of the DMX lane ----------------------------------------------

#: NANOGrav's par at 4 windows, 2 Fourier terms: window 1 reaches into window
#: 2, window 4 starts 25 days after window 3 ends, TZRMJD 57000.1 in window 3
OVERLAP = (("DMXR2_0001 56824.949", "DMXR2_0001 56900.0"),
           ("DMXR1_0004 57175.05", "DMXR1_0004 57200.0"))


def overlap_par(tzr: bool = True) -> str:
    par = profiles.nanograv_smoke_par(4, 2)
    for a, b in OVERLAP:
        assert a in par
        par = par.replace(a, b)
    return par if tzr else "\n".join(ln for ln in par.splitlines()
                                     if not ln.startswith("TZR"))


@pytest.fixture(scope="module")
def overlap():
    """(pint_tpu model, its tensor, port model, port tensor) over 50 TOAs
    of the two receivers in turn, one at MJD 56850 (windows 1 and 2) and
    one at 57190 (no window)."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models.builder import build_model
    from pint_tpu.profiles import RECEIVERS
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.prepared import tensor_from_numpy

    jm = build_model(parse_parfile(overlap_par(), from_text=True))
    mjds = np.concatenate([np.linspace(56660.0, 57340.0, 48), [56850.0, 57190.0]])
    freqs, flags = [], []
    for i in range(mjds.size):
        fname, subbands = RECEIVERS[i % 2]
        freqs.append(subbands[i % len(subbands)])
        flags.append({"f": fname, "fe": fname.split("_GUPPI")[0]})
    toas = make_fake_toas_fromMJDs(mjds, jm, obs="gbt", freq_mhz=np.array(freqs),
                                   error_us=1.0, flags=flags)
    tens = jm.build_tensor(toas)
    tt = tensor_from_numpy({k: np.asarray(v) for k, v in tens.items()}, device="cpu")
    return jm, tens, port_model(overlap_par()), tt


def test_overlap_dataset_has_rows_in_two_windows_none_and_the_tzr_in_one(overlap):
    oh = overlap[3]["dmx_onehot"]
    per_row = oh[:-1].sum(dim=1)
    assert int((per_row == 2).sum()) >= 1 and int((per_row == 0).sum()) >= 1
    assert oh[-1].tolist() == [0.0, 0.0, 1.0, 0.0]
    assert bool(torch.all((oh == 0) | (oh == 1)))


def scatter(onehot, g, g_tzr, has_tzr=True):
    """The kernel's DMX scatter (resid_tangent.cu scatter_dmx): window j's
    column at data row i is (onehot[i, j] ? g_i : 0) - (onehot[tzr, j] ?
    g_tzr : 0)."""
    n = g.shape[0]
    cols = []
    for j in range(onehot.shape[1]):
        v = torch.where(onehot[:n, j] != 0, g, torch.zeros_like(g))
        if has_tzr:
            v = v - (g_tzr if onehot[-1, j] != 0 else 0.0)
        cols.append(v)
    return torch.stack(cols)


def test_dmx_columns_are_one_value_per_row_scattered(overlap):
    """Each row's value and the TZR row's come from the twin's own DMX
    columns without the TZR subtraction (the par without TZR lines, the TZR
    row a data row there): a row in two windows carries the same value in
    both, a window's column is zero off its rows. The scatter of those
    values rebuilds the TZR par's DMX columns bitwise off the TZR row's
    window, and within 1e-15 of each column's largest value on it, where the
    twin takes the tangent of the dd subtraction of the TZR row's phase (its
    low word's tangent included), which the kernel forms as one float64
    subtraction."""
    _, _, tm, tt = overlap
    oh = tt["dmx_onehot"]
    lanes = rs.lane_names(tm.free_params, tm)
    dmx = [i for i, n in enumerate(lanes) if n.startswith("DMX_")]
    want = rs.resid_tangent_plain(tm, tm.params, tt, lanes).dfrac[0, dmx]
    bare = port_model(overlap_par(tzr=False))
    raw = rs.resid_tangent_plain(bare, bare.params, tt, lanes).dfrac[0, dmx]  # every row data
    g = torch.zeros(oh.shape[0], dtype=torch.float64)
    for j in range(oh.shape[1]):
        on = oh[:, j] != 0
        assert bool(torch.all(raw[j][~on] == 0)), j
        g[on] = raw[j][on]
    for j in range(oh.shape[1]):  # a row in two windows: the same value in both
        on = oh[:, j] != 0
        assert torch.equal(raw[j][on], g[on]), j
    n = want.shape[1]
    got = scatter(oh, g[:n], g[-1])
    tzr_window = oh[:n, 2] != 0
    off = torch.ones_like(got, dtype=torch.bool)
    off[2] = ~tzr_window
    assert torch.equal(got[off], want[off])
    scale = float(torch.max(torch.abs(want[2])))
    assert float(torch.max(torch.abs(got[2] - want[2]))) <= 1e-15 * scale
    # without the TZR row's phase, the scatter is the columns themselves
    assert torch.equal(scatter(oh, g, 0.0, has_tzr=False), raw)


def test_jump_column_is_f0_mask_minus_the_tzr_rows(overlap):
    """d frac / d JUMP1 = F0 mask - F0 mask_tzr (F0 as hi + lo), within
    1e-15 relative (the twin's dd products), and d f / d JUMP1 = 0."""
    _, _, tm, tt = overlap
    lanes = rs.lane_names(tm.free_params, tm)
    j = lanes.index("JUMP1")
    out = rs.resid_tangent_plain(tm, tm.params, tt, lanes)
    f0 = float(tm.params["F0"].hi + tm.params["F0"].lo)
    mask = tt["mask_JUMP1"]
    want = (mask[:-1] != 0).double() * f0 - (f0 if mask[-1] != 0 else 0.0)
    assert float(torch.max(torch.abs(out.dfrac[0, j] - want))) <= 1e-15 * f0
    assert bool(torch.all(out.df[0, j] == 0))


def test_dmx_and_jump_columns_match_pint_tpu_linearize(overlap):
    """The twin's DMX and JUMP columns against jax.linearize of pint_tpu's
    phase_residual_frac over the same parameters (eager), within 1e-10
    relative per column."""
    from pint_tpu.fitting.wls import apply_delta as jax_apply
    from pint_tpu.residuals import phase_residual_frac as jax_prf

    jm, tens, tm, tt = overlap
    lanes = tuple(n for n in rs.lane_names(tm.free_params, tm)
                  if n.startswith(("DMX_", "JUMP")))
    params = jm.xprec.convert_params(jm.params)

    def frac(delta):
        return jax_prf(jm, jax_apply(params, lanes, delta), tens, subtract_mean=False)[1]

    with jax.disable_jit():
        _, lin = jax.linearize(frac, jnp.zeros(len(lanes)))
        want = np.asarray(jax.vmap(lin)(jnp.eye(len(lanes))))
    got = rs.resid_tangent_plain(tm, tm.params, tt, lanes).dfrac[0].numpy()
    for k, n in enumerate(lanes):
        scale = np.max(np.abs(want[k]))
        assert scale > 0 and np.max(np.abs(got[k] - want[k])) <= 1e-10 * scale, n


def test_one_hot_of_other_values_is_refused(overlap):
    _, _, tm, tt = overlap
    half = {**tt, "dmx_onehot": tt["dmx_onehot"] * 0.5}
    setup = rs._K1Setup(tm, ("DMX_0001",))
    with pytest.raises(ValueError, match="zeros and ones"):
        setup.masks_of(tm, half, torch.zeros(1, dtype=torch.float64))


# --- (c) the packer ---------------------------------------------------------------


def pack_params_reference(model, params, B, st, device):
    """The column-by-column packer ``residuals._pack_params`` replaced: a
    column per leaf, each broadcast to (B,), stacked."""
    from pint_tpu_torch.models.base import leaf_to_f64
    from pint_tpu_torch.ops.dd import DD

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
    vals = rs._binary_values(model, params, B) if st.bin_kind else {}
    for n in ("PB", "EPOCH"):
        v = vals.get(n, DD(zero, zero))
        cols += [col(v.hi), col(v.lo)]
    cols += [col(vals[n]) if n in vals else zero for n in rs._BIN_F64]
    fb0 = vals.get("FB0", DD(zero, zero))
    cols += [col(fb0.hi), col(fb0.lo)]
    cols += [col(vals[f"FB{k}"]) if f"FB{k}" in vals else zero for k in range(1, rs.MAX_FB)]
    cols += [col(vals[n]) if n in vals else zero for n in rs._BIN_EXT]
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


def batched(model, B: int, moved: dict | None = None):
    """The model's parameters as B sets, its grid's two parameters spread
    over them (as a grid), each of `moved` shifted by its value."""
    from pint_tpu_torch.ops.dd import DD

    params = {k: (DD(v.hi.expand(B).clone(), v.lo.expand(B).clone()) if isinstance(v, DD)
                  else v.expand(B).clone()) for k, v in model.params.items()}
    for k, n in enumerate(grid_names(model)):
        v = params[n]
        step = torch.linspace(-1, 1, B, dtype=torch.float64) * 1e-9 * (k + 1)
        params[n] = DD(v.hi + step * v.hi, v.lo) if isinstance(v, DD) else v + step * v
    for n, d in (moved or {}).items():
        v = params[n]
        params[n] = DD(v.hi + d, v.lo) if isinstance(v, DD) else v + d
    return params


@pytest.mark.parametrize("name", sorted(PARS))
def test_packer_equals_the_column_packer_bitwise(models, name):
    model = models[name]
    st = rs._structure(model)
    for B, params in ((1, model.params), (9, batched(model, 9))):
        got = rs._pack_params(model, params, B, st, "cpu")
        want = pack_params_reference(model, params, B, st, "cpu")
        assert got.shape == want.shape == (B, rs.P_ROW_LEN + st.nd + 2 * st.nf + st.n_fd), name
        assert torch.equal(got, want), name


def test_second_call_packs_the_moved_values(overlap):
    """Three calls through one cached setup (B = 1, 9, then 9 with F0, a
    DMX value, the JUMP, A1 and FD2 moved): each call's parameter rows and
    DMX and jump columns are those of its own values."""
    _, _, model, tt = overlap
    lanes = rs.lane_names(model.free_params, model)
    setup = rs._k1_setup(model, lanes)
    st = setup.st
    moves = {"F0": 1e-9, "DMX_0003": 1e-4, "JUMP1": 1e-6, "A1": 1e-7, "FD2": 1e-7}
    out = []
    for B, moved in ((1, None), (9, None), (9, moves)):
        params = batched(model, B, moved)
        assert rs._k1_setup(model, lanes) is setup
        P = rs._pack_params(model, params, B, st, "cpu")
        dmx, jump, onehot, masks = rs._nanograv_columns(model, params, tt, B, st, setup)
        assert torch.equal(P, pack_params_reference(model, params, B, st, "cpu"))
        vals = torch.broadcast_to(model["DispersionDMX"].dmx_values(params), (B, st.n_dmx))
        assert torch.equal(dmx, (tt["dmx_onehot"] @ vals.T).T)
        assert torch.equal(jump, torch.zeros((B, tt["t_hi"].shape[0]), dtype=torch.float64)
                           + tt["mask_JUMP1"] * torch.broadcast_to(params["JUMP1"], (B,))[:, None])
        assert torch.equal(onehot, tt["dmx_onehot"]) and torch.equal(masks[0], tt["mask_JUMP1"])
        out.append((P, dmx, jump))
    assert all(not torch.equal(a, b) for a, b in zip(out[1], out[2]))

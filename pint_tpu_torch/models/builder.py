"""Model builder: parfile -> components -> TimingModel (counterpart of
``pint_tpu/models/builder.py``, restricted to the components ported so far:
AstrometryEquatorial, AstrometryEcliptic, SolarSystemShapiro, DispersionDM,
DispersionDMX, DispersionJump, FD, PulsarBinary (every BINARY model of
pint_tpu, PB or FB form), Spindown, PhaseJump, AbsPhase, ScaleToaError,
ScaleDmError, EcorrNoise, PLRedNoise, PLDMNoise, PLGWBNoise).

Mask parameters (``EFAC -f Rcvr1_2_GUPPI 1.02``) number per family in
parfile order (EFAC1, EFAC2, ...) as in pint_tpu; each reads the tensor
column ``mask_<name>`` that ``TimingModel.build_tensor`` selects from the
TOAs' flags (or that a prepared archive carries).

A parfile that selects any other component raises NotImplementedError
naming the ROADMAP item that ports it. Parameter values become float64
tensors on the model's device; epochs and F0/F1 become exact DD pairs.
"""

from __future__ import annotations

import logging

import torch

from pint_tpu_torch.device import resolve_device
from pint_tpu_torch.io.par import ParFile, parse_fit_flag, parse_parfile
from pint_tpu_torch.io.tim import mjd_string_to_day_frac
from pint_tpu_torch.models.astrometry import AstrometryEcliptic, AstrometryEquatorial
from pint_tpu_torch.models.base import Component
from pint_tpu_torch.models.binary import make_binary_component
from pint_tpu_torch.models.dispersion import DispersionDM, DispersionDMX, DispersionJump
from pint_tpu_torch.models.frequency_dependent import FD
from pint_tpu_torch.models.noise import (EcorrNoise, NoiseComponent, PLDMNoise, PLGWBNoise,
                                         PLRedNoise, ScaleDmError, ScaleToaError)
from pint_tpu_torch.models.parameter import (MaskParamInfo, ParamSpec, ParamValueMeta,
                                             parse_mask_clause)
from pint_tpu_torch.models.phase_misc import AbsPhase, PhaseJump
from pint_tpu_torch.models.solar_system_shapiro import SolarSystemShapiro
from pint_tpu_torch.models.spindown import Spindown
from pint_tpu_torch.models.timing_model import TimingModel
from pint_tpu_torch.ops.dd import DD

log = logging.getLogger("pint_tpu_torch.builder")

# top-level configuration keys that land in model.meta (not parameters)
META_KEYS = {"PSR", "PSRJ", "PSRB", "EPHEM", "CLK", "CLOCK", "UNITS", "TIMEEPH",
             "T2CMETHOD", "ECL", "DILATEFREQ", "TRACK", "INFO"}

# recognized-but-inert bookkeeping keys (fit summary data etc.)
IGNORED_KEYS = {"START", "FINISH", "NTOA", "TRES", "CHI2", "CHI2R", "NITS", "MODE",
                "IBOOT", "EPHVER", "DMDATA", "BADTOA"}


def _unported(pf: ParFile) -> list[tuple[str, str]]:
    """(parfile key, ROADMAP item) for every component this parfile selects
    that the port does not have yet."""
    names = list(pf.names())
    checks = [
        ("PHOFF", "PHOFF" in pf, "A9 (PhaseOffset)"),
        ("DJUMP", "DJUMP" in pf, "A9 (DelayJump)"),
        ("GLEP_", any(n.startswith("GLEP_") for n in names), "A9 (Glitch)"),
        ("WAVE_OM", "WAVE_OM" in pf, "A9 (Wave)"),
        ("NE_SW", any(k in pf for k in ("NE_SW", "NE1AU", "SOLARN0")), "A9 (solar wind)"),
        ("SWXDM_", any(n.startswith("SWXDM_") for n in names), "A9 (SWX)"),
        ("SIFUNC", "SIFUNC" in pf, "A9 (IFunc)"),
        ("PWEP_", any(n.startswith("PWEP_") for n in names), "A9 (piecewise spindown)"),
        ("CORRECT_TROPOSPHERE", _parse_bool(pf.get("CORRECT_TROPOSPHERE", "N")),
         "A9 (troposphere)"),
        ("PLANET_SHAPIRO", _parse_bool(pf.get("PLANET_SHAPIRO", "N")),
         "A18 (planet positions from the TOA prepare)"),
    ]
    return [(key, item) for key, hit, item in checks if hit]


def get_model(parfile: str, from_text: bool = False, device=None) -> TimingModel:
    """Parfile path (or text with from_text=True) -> TimingModel on `device`
    (CUDA unless 'cpu' is asked for)."""
    return build_model(parse_parfile(parfile, from_text=from_text), device=device)


def get_model_and_toas(parfile: str, timfile: str, device=None, **kw):
    """(model, TOAs) from a parfile and a .tim file on `device` (CUDA unless
    'cpu'): the model's EPHEM, PLANET_SHAPIRO and CLK directives steer the
    prepare as in pint_tpu (``toas.get_TOAs``)."""
    from pint_tpu_torch.toas import get_TOAs

    model = get_model(parfile, device=resolve_device(device))
    toas = get_TOAs(timfile, model=model, device=model.device, **kw)
    return model, toas


def build_model(pf: ParFile, device=None) -> TimingModel:
    dev = resolve_device(device)
    missing = _unported(pf)
    if missing:
        raise NotImplementedError(
            "pint_tpu_torch does not port these components yet: "
            + "; ".join(f"{k} -> ROADMAP {item}" for k, item in missing))
    consumed: set[str] = set(META_KEYS) | set(IGNORED_KEYS)
    meta = _collect_meta(pf)

    components: list[Component] = []
    if "F0" in pf or "F" in pf:
        components.append(Spindown())
    if "RAJ" in pf or "RA" in pf:
        components.append(AstrometryEquatorial())
    elif "ELONG" in pf or "LAMBDA" in pf:
        components.append(AstrometryEcliptic())
    if "DM" in pf or any(n.startswith("DM1") for n in pf.names()):
        components.append(DispersionDM())
    if any(n.startswith("DMX_") for n in pf.names()):
        components.append(DispersionDMX())
    if "DMJUMP" in pf:
        components.append(DispersionJump())
    if any(isinstance(c, (AstrometryEquatorial, AstrometryEcliptic)) for c in components):
        components.append(SolarSystemShapiro())
        meta["PLANET_SHAPIRO"] = False
        consumed.add("PLANET_SHAPIRO")
    if "TZRMJD" in pf:
        components.append(AbsPhase())
        day, hi, lo = mjd_string_to_day_frac(pf.get("TZRMJD"))
        meta["TZR_DAY"], meta["TZR_HI"], meta["TZR_LO"] = day, hi, lo
        meta["TZRMJD_STR"] = pf.get("TZRMJD")
        meta["TZRSITE"] = pf.get("TZRSITE", "ssb")
        frq = pf.get("TZRFRQ")
        meta["TZRFRQ"] = float(frq) if frq not in (None, "0", "0.0") else float("inf")
        consumed |= {"TZRMJD", "TZRSITE", "TZRFRQ"}
    if "JUMP" in pf:
        components.append(PhaseJump())
    if any(n.startswith("FD") and n[2:].isdigit() for n in pf.names()):
        components.append(FD())
    if "BINARY" in pf:
        components.append(make_binary_component(pf.get("BINARY").upper(), pf))
        meta["BINARY"] = pf.get("BINARY").upper()
        consumed.add("BINARY")
    if any(k in pf for k in ("EFAC", "T2EFAC", "EQUAD", "T2EQUAD")):
        components.append(ScaleToaError())
    if any(k in pf for k in ("ECORR", "TNECORR")):
        components.append(EcorrNoise())
    if ("RNAMP" in pf and "RNIDX" in pf) or "TNREDAMP" in pf:
        components.append(PLRedNoise())
    if "TNDMAMP" in pf:
        components.append(PLDMNoise())
    if "TNGWAMP" in pf:
        components.append(PLGWBNoise())
    if "DMEFAC" in pf or "DMEQUAD" in pf:
        components.append(ScaleDmError())

    model = TimingModel(components, meta, device=dev)
    for comp in model.components:
        _collect_component_params(comp, pf, model, consumed)
    for comp in model.components:
        for base_spec in comp.mask_bases():
            _collect_mask_params(comp, base_spec, pf, model, consumed)
            consumed.add(base_spec.name)
    for comp in model.components:
        if isinstance(comp, DispersionDMX):
            _collect_dmx(comp, pf, model, consumed)
    # noise parameters are fixed inputs to WLS/GLS, as in pint_tpu: frozen
    for comp in model.components:
        if not isinstance(comp, NoiseComponent):
            continue
        for pname in comp.specs:
            pm = model.param_meta.get(pname)
            if pm is not None and not pm.frozen:
                log.warning(f"noise parameter {pname} cannot be fit by WLS/GLS; freezing")
                pm.frozen = True
    for name in pf.names():
        if name not in consumed:
            log.warning(f"unrecognized parfile key {name}; ignored")
    model.validate()
    return model


def _parse_bool(tok: str) -> bool:
    return str(tok).upper() in ("1", "Y", "YES", "T", "TRUE")


def _collect_meta(pf: ParFile) -> dict:
    meta: dict = {}
    psr = pf.get("PSR") or pf.get("PSRJ") or pf.get("PSRB")
    if psr:
        meta["PSR"] = psr
    for k in ("EPHEM", "UNITS", "TIMEEPH", "T2CMETHOD", "ECL", "TRACK", "INFO"):
        v = pf.get(k)
        if v is not None:
            meta[k] = v
    clk = pf.get("CLK") or pf.get("CLOCK")
    if clk:
        meta["CLOCK"] = clk
    units = meta.get("UNITS", "TDB")
    if units.upper() not in ("TDB", "SI"):
        raise NotImplementedError(
            f"UNITS {units}: TCB conversion is not ported yet (ROADMAP A9)")
    return meta


def _find_entry(pf: ParFile, spec: ParamSpec):
    for key in (spec.name, *spec.aliases):
        if key in pf:
            return pf.get_all(key)[0], key
    return None, None


def value_to_tensor(spec: ParamSpec, value, device):
    """Host parse result -> float64 tensor leaf (DD for dd/epoch kinds)."""
    if spec.is_dd:
        hi, lo = value
        return DD(torch.tensor(float(hi), dtype=torch.float64, device=device),
                  torch.tensor(float(lo), dtype=torch.float64, device=device))
    return torch.tensor(float(value), dtype=torch.float64, device=device)


def _collect_component_params(comp: Component, pf: ParFile, model: TimingModel, consumed: set):
    for spec in list(comp.specs.values()):
        if spec.name in consumed:
            continue
        line, key = _find_entry(pf, spec)
        if line is None:
            if spec.default is not None:
                if spec.is_fittable:
                    model.params[spec.name] = value_to_tensor(
                        spec, spec.parse(str(spec.default)), model.device)
                    model.param_meta[spec.name] = ParamValueMeta(spec=spec)
                else:
                    model.meta.setdefault(spec.name, spec.parse(str(spec.default)))
            continue
        consumed.add(key)
        _store_param(model, spec, line, from_alias=key if key != spec.name else None)

    for pspec in comp.prefix_specs():
        for name in list(pf.names()):
            if name in consumed:
                continue
            k = pspec.matches(name)
            if k is None:
                continue
            spec = pspec.make(k)
            comp.add_prefix_param(spec)
            consumed.add(name)
            _store_param(model, spec, pf.get_all(name)[0])


def _store_param(model: TimingModel, spec: ParamSpec, line, from_alias=None):
    value = spec.parse(line.value)
    if spec.is_fittable:
        model.params[spec.name] = value_to_tensor(spec, value, model.device)
        frozen, unc_tok = parse_fit_flag(line.tokens)
        pm = ParamValueMeta(spec=spec, frozen=frozen, from_alias=from_alias)
        if unc_tok is not None:
            pm.uncertainty = spec.parse_uncertainty(unc_tok)
        model.param_meta[spec.name] = pm
    else:
        model.meta[spec.name] = value


def _collect_mask_params(comp: Component, base_spec: ParamSpec, pf: ParFile,
                         model: TimingModel, consumed: set) -> None:
    """The family's lines (name and aliases) in parfile order become
    <BASE>1, <BASE>2, ..."""
    lines = []
    for key in (base_spec.name, *base_spec.aliases):
        if key in pf:
            lines.extend(pf.get_all(key))
            consumed.add(key)
    for i, line in enumerate(lines, start=1):
        clause, rest = parse_mask_clause(line.tokens)
        name = f"{base_spec.name}{i}"
        spec = ParamSpec(name, kind=base_spec.kind, scale=base_spec.scale,
                         unit=base_spec.unit,
                         description=f"{base_spec.name} on "
                                     f"{' '.join(clause.as_parfile_tokens())}")
        comp.mask_params.append(MaskParamInfo(name=name, base=base_spec.name, index=i,
                                              clause=clause, spec=spec))
        comp.specs[name] = spec
        if not rest:
            raise ValueError(f"{base_spec.name} line missing value: {line.raw}")
        model.params[name] = value_to_tensor(spec, spec.parse(rest[0]), model.device)
        frozen, unc_tok = parse_fit_flag(rest)
        pm = ParamValueMeta(spec=spec, frozen=frozen)
        if unc_tok is not None:
            pm.uncertainty = spec.parse_uncertainty(unc_tok)
        model.param_meta[name] = pm


def _collect_dmx(comp: DispersionDMX, pf: ParFile, model: TimingModel, consumed: set):
    """DMX_nnnn values with their DMXR1_nnnn/DMXR2_nnnn ranges (MJD)."""
    idxs = sorted(int(n[4:]) for n in pf.names() if n.startswith("DMX_") and n[4:].isdigit())
    for i in idxs:
        r1, r2 = pf.get(f"DMXR1_{i:04d}"), pf.get(f"DMXR2_{i:04d}")
        if r1 is None or r2 is None:
            raise ValueError(f"DMX_{i:04d} missing DMXR1/DMXR2 range")
        comp.add_window(i, float(r1), float(r2))
        _store_param(model, comp.specs[f"DMX_{i:04d}"], pf.get_all(f"DMX_{i:04d}")[0])
        consumed |= {f"DMX_{i:04d}", f"DMXR1_{i:04d}", f"DMXR2_{i:04d}"}

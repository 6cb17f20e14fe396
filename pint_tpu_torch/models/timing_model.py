"""TimingModel: ordered component chain -> phase and spin frequency, and
the noise surface (counterpart of ``pint_tpu/models/timing_model.py``,
restricted to the components ported so far).

``phase_and_freq(params, tensor)`` is the plain-torch forward pass: delays
accumulated in DEFAULT_ORDER, phase summed over the phase components in
double-double, then the TZR fiducial row (the tensor's last) subtracted.
It is the twin of the fused forward of kernel K1 (``residuals.resid_tangent``),
which computes the same chain per TOA on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.models.base import DEFAULT_ORDER, Component
from pint_tpu_torch.models.parameter import ParamValueMeta
from pint_tpu_torch.ops.dd import device_split
from pint_tpu_torch.ops.xprec import DD64

# params that configure host-side tensor construction and cannot be fitted
UNFITTABLE = {"TZRMJD", "TZRSITE", "TZRFRQ", "PLANET_SHAPIRO"}


class TimingModel:
    def __init__(self, components: list[Component], meta: dict | None = None,
                 device: torch.device | None = None):
        order = {cat: i for i, cat in enumerate(DEFAULT_ORDER)}
        self.components = sorted(components, key=lambda c: order.get(c.category, 99))
        self.meta: dict = meta or {}
        self.params: dict = {}
        self.param_meta: dict[str, ParamValueMeta] = {}
        self.device = device
        self.xprec = DD64

    def __getitem__(self, name: str) -> Component:
        for c in self.components:
            if c.name == name:
                return c
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(c.name == name for c in self.components)

    @property
    def component_names(self) -> list[str]:
        return [c.name for c in self.components]

    @property
    def delay_components(self) -> list[Component]:
        return [c for c in self.components if _overrides(c, "delay")]

    @property
    def phase_components(self) -> list[Component]:
        return [c for c in self.components if _overrides(c, "phase")]

    @property
    def astrometry(self) -> Component | None:
        for c in self.components:
            if c.category == "astrometry":
                return c
        return None

    @property
    def has_abs_phase(self) -> bool:
        return any(c.category == "absolute_phase" for c in self.components)

    @property
    def psr_name(self) -> str:
        return self.meta.get("PSR", "")

    @property
    def has_phase_offset(self) -> bool:
        return False  # PhaseOffset (PHOFF) is not ported yet (ROADMAP A9)

    @property
    def free_params(self) -> list[str]:
        return [n for n, m in self.param_meta.items() if not m.frozen]

    def set_free(self, names: list[str]) -> None:
        for n in names:
            if n not in self.param_meta:
                raise KeyError(f"unknown parameter {n}")
            if n in UNFITTABLE:
                raise ValueError(f"{n} configures tensor construction; cannot fit")
        for n, m in self.param_meta.items():
            m.frozen = n not in names

    def validate(self) -> None:
        for c in self.components:
            c.validate(self.params, self.meta)

    @property
    def derived_params(self) -> dict:
        """name -> FuncParamSpec of every derived parameter the components
        expose."""
        return {fp.name: fp for c in self.components for fp in c.func_param_specs()}

    def get_derived(self, name: str) -> float:
        """A derived quantity's value (float64, internal units), or the
        parameter's own where `name` is a parameter."""
        fps = self.derived_params
        if name in fps:
            return fps[name].value(self.params)
        if name in self.params:
            from pint_tpu_torch.models.base import leaf_to_f64

            return float(leaf_to_f64(self.params[name]))
        raise KeyError(f"no parameter or derived quantity {name}")

    # --- the tensor (host columns -> float64 tensors on the model's device) ------

    def build_tensor(self, toas) -> dict:
        """Prepared TOAs -> the dict of float64 tensors on the model's device
        that the forward chain reads: the TZR fiducial TOA, prepared through
        the same pipeline (K4 and K5 on the card), appended as the last row;
        TDB as double-double seconds (``device_split``); every component's
        host columns; with -pp_dm flags the wideband DM measurements
        (``wb_dm``, ``wb_dme``: rows without one, the TZR row included, get
        an infinite error, zero weight in the DM block); the pulse-number
        offsets ``delta_pn`` of -padd and -phase flags (absent when all
        zero). The tracked pulse numbers ``track_pn`` are not built here:
        ``residuals.tracked_tensor`` adds them. The TZR row belongs to no mask. Columns the port does not read yet
        (planet positions) raise."""
        from pint_tpu_torch.prepared import tensor_from_numpy
        from pint_tpu_torch.toas import make_tzr_toa, merge_TOAs

        full = toas
        if self.has_abs_phase:
            tzr = make_tzr_toa(self.meta["TZR_DAY"], self.meta["TZR_HI"], self.meta["TZR_LO"],
                               self.meta.get("TZRSITE", "ssb"),
                               self.meta.get("TZRFRQ", float("inf")),
                               ephem=toas.ephem, planets=toas.planets, device=self.device)
            full = merge_TOAs([toas, tzr])
        tens = full.tensor()
        t_hi, t_lo = device_split(tens.t_hi, tens.t_lo)
        out = {"t_hi": t_hi, "t_lo": t_lo, "error_s": tens.error_s, "freq_mhz": tens.freq_mhz,
               "ssb_obs_pos_ls": tens.ssb_obs_pos_ls, "ssb_obs_vel_ls": tens.ssb_obs_vel_ls,
               "obs_sun_pos_ls": tens.obs_sun_pos_ls}
        for p, arr in tens.planet_pos_ls.items():
            out[f"obs_{p}_pos_ls"] = arr
        wb_dm, wb_dme = full.get_wideband_dm()
        if wb_dm is not None:
            out["wb_dm"], out["wb_dme"] = wb_dm, wb_dme
        n_rows = t_hi.shape[0]
        # pulse-number offsets (-padd, -phase): data rows, added after the
        # TZR row's phase is taken off, as pint_tpu's Residuals adds them
        # (the TZR row's entry is 0 and never read)
        if tens.delta_pulse_number is not None:
            out["delta_pn"] = tens.delta_pulse_number
        for c in self.components:
            for k, col in c.host_columns(full, self.params).items():
                col = np.array(col, np.float64)
                if self.has_abs_phase and k.startswith("mask_") and col.shape[:1] == (n_rows,):
                    col[-1] = 0.0
                out[k] = col
        return tensor_from_numpy(out, self.device)

    # --- the noise surface (models/noise.py) ---------------------------------------

    @property
    def noise_components(self) -> list[Component]:
        from pint_tpu_torch.models.noise import NoiseComponent

        return [c for c in self.components if isinstance(c, NoiseComponent)]

    @property
    def has_correlated_errors(self) -> bool:
        return any(getattr(c, "introduces_correlated_errors", False) for c in self.components)

    def scaled_sigma(self, params: dict, tensor: dict) -> torch.Tensor:
        """Noise-rescaled per-TOA sigma (seconds), data rows only (the last
        axis; leaves of shape (E, 1) give (E, N))."""
        sigma = tensor["error_s"]
        for c in self.noise_components:
            sigma = c.scale_sigma(params, tensor, sigma)
        if self.has_abs_phase:
            sigma = sigma[..., :-1]
        return sigma

    # --- the wideband DM surface -------------------------------------------------

    @property
    def dm_components(self) -> list[Component]:
        """The components with a model DM (``dm_value``), in chain order."""
        return [c for c in self.components if hasattr(c, "dm_value")]

    @property
    def dm_only_params(self) -> list[str]:
        """Parameters that move the model DM and no delay (DMJUMP)."""
        if "DispersionJump" not in self:
            return []
        return self["DispersionJump"].dm_param_names()

    def total_dm(self, params: dict, tensor: dict) -> torch.Tensor:
        """Model DM at each TOA (pc cm^-3), data rows only: the components'
        ``dm_value`` summed in chain order (the twin of the model DM that
        kernel K8's DM-row pass writes)."""
        tensor = self._with_context(params, tensor)
        dm = torch.zeros_like(tensor["t_hi"])
        for c in self.dm_components:
            dm = dm + c.dm_value(params, tensor)
        if self.has_abs_phase:
            dm = dm[:-1]
        return dm

    def scaled_dm_sigma(self, params: dict, tensor: dict) -> torch.Tensor:
        """DMEFAC/DMEQUAD-rescaled wideband DM uncertainties, data rows."""
        sigma = tensor["wb_dme"]
        for c in self.noise_components:
            if hasattr(c, "scale_dm_sigma"):
                sigma = c.scale_dm_sigma(params, tensor, sigma)
        if self.has_abs_phase:
            sigma = sigma[:-1]
        return sigma

    @property
    def common_noise_component(self):
        """The array-common noise process (PLGWBNoise) of the model, or None.
        At most one: the joint PTA likelihood couples pulsars through it."""
        out = [c for c in self.noise_components if getattr(c, "common_process", False)]
        if len(out) > 1:
            raise ValueError(
                f"model carries {len(out)} common noise processes; the "
                "joint PTA likelihood supports exactly one")
        return out[0] if out else None

    def gwb_common_basis(self, params: dict, tensor: dict, tspan: torch.Tensor):
        """(G (N_data, m), phi_gw (m,)) of the common process on the array's
        span `tspan`, or None without one: the pulsar's block of the joint
        likelihood's ORF (x) diag(phi_gw) coupling (fitting/pta_like.py)."""
        c = self.common_noise_component
        if c is None:
            return None
        sl = slice(None, -1) if self.has_abs_phase else slice(None)
        return c.gwb_basis(params, tensor, sl, tspan)

    def _noise_parts(self, include_common: bool):
        return [c for c in self.noise_components
                if include_common or not getattr(c, "common_process", False)]

    def noise_basis_and_weights(self, params: dict, tensor: dict, include_common: bool = True):
        """Structured correlated-noise basis (fitting/woodbury.NoiseBasis) or
        None: the dense Fourier parts concatenated in component order, the
        ECORR epochs kept implicit (their index becomes a CSR once per
        tensor). ``include_common=False`` leaves the common process out: the
        joint PTA likelihood carries it through the ORF instead."""
        from pint_tpu_torch.fitting.woodbury import NoiseBasis

        sl = slice(None, -1) if self.has_abs_phase else slice(None)
        Fs, phis = [], []
        epochs = ephi = None
        for c in self._noise_parts(include_common):
            out = c.basis_and_weights(params, tensor, sl)
            if out is None:
                continue
            if out[0] == "dense":
                Fs.append(out[1])
                phis.append(out[2])
            else:  # "epoch": at most one EcorrNoise component per model
                epochs, ephi = self._epochs(tensor, out[1], out[2].shape[0]), out[2]
        if not Fs and epochs is None:
            return None
        # columns before rows, as K8 writes them and K3 reads them
        return NoiseBasis(dense=torch.cat([F.T for F in Fs]).T if Fs else None,
                          dense_phi=torch.cat(phis) if phis else None,
                          epochs=epochs, ephi=ephi)

    def noise_prior_weights(self, params: dict, tensor: dict, include_common: bool = True):
        """(phi_e, phi_d): the prior variances of the ECORR epochs and of the
        dense columns in `noise_basis_and_weights`' order (each (..., k) or
        None), without forming the basis."""
        ephi, phis = None, []
        for c in self._noise_parts(include_common):
            phi = c.prior_weights(params, tensor)
            if phi is None:
                continue
            if c.category == "ecorr_noise":
                ephi = phi
            else:
                phis.append(phi)
        if not phis:
            return ephi, None
        batch = torch.broadcast_shapes(*(x.shape[:-1] for x in phis))
        return ephi, torch.cat([x.expand(*batch, x.shape[-1]) for x in phis], dim=-1)

    def _epochs(self, tensor: dict, eidx: torch.Tensor, ke: int):
        """The EpochIndex of `eidx`, built once per tensor: cached against the
        tensor's ``ecorr_eidx`` column (a strong reference, so a recycled id
        cannot alias)."""
        from pint_tpu_torch.fitting.woodbury import epoch_index

        col = tensor["ecorr_eidx"]
        memo = self.__dict__.get("_epoch_memo")
        if memo is None or memo[0] is not col:
            memo = self._epoch_memo = (col, epoch_index(eidx, ke))
        return memo[1]

    # --- the forward pass (plain torch) -------------------------------------------

    def phase_and_freq(self, params: dict, tensor: dict, xp=None):
        """(phase DD turns, spin frequency Hz) sharing one delay chain; with
        AbsPhase the fiducial (last) row is subtracted and dropped."""
        xp = xp or self.xprec
        tensor = self._with_context(params, tensor)
        total_delay = torch.zeros_like(tensor["t_hi"])
        for c in self.delay_components:
            total_delay = total_delay + c.delay(params, tensor, total_delay, xp)
        ph = xp.zeros_like(tensor["t_hi"])
        for c in self.phase_components:
            ph = xp.add(ph, c.phase(params, tensor, total_delay, xp))
        if "Spindown" in self:
            f = self["Spindown"].spin_frequency(params, tensor, total_delay, xp)
        else:
            f = torch.ones_like(tensor["t_hi"])
        if self.has_abs_phase:
            tzr_phase = xp.index(ph, slice(-1, None))
            ph = xp.index(ph, slice(None, -1))
            ph = xp.add(ph, xp.neg(tzr_phase))
            f = f[..., :-1]
        return ph, f

    def _with_context(self, params: dict, tensor: dict) -> dict:
        ast = self.astrometry
        if ast is not None:
            tensor = dict(tensor)
            tensor["_psr_dir"] = ast.pulsar_direction(params, tensor)
        return tensor


def _overrides(c: Component, method: str) -> bool:
    return getattr(type(c), method, None) is not getattr(Component, method, None)

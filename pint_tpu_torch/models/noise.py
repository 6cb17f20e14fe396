"""Noise models: white-noise rescaling and the ECORR basis (counterpart of
``ScaleToaError``, ``EcorrNoise`` and ``NoiseComponent`` in
``pint_tpu/models/noise.py``).

Noise enters a fit through two surfaces:

- ``scale_sigma(params, tensor, sigma)``: per-TOA uncertainty rescaling
  (EFAC/EQUAD), elementwise over the mask columns of the tensor (and
  ``scale_dm_sigma`` of ScaleDmError, DMEFAC/DMEQUAD, the wideband DM
  uncertainties);
- ``basis_and_weights(params, tensor, sl)``: the correlated-noise basis in
  structured form (``fitting/woodbury.NoiseBasis``). For ECORR it is the
  implicit per-TOA epoch index and the prior variance of each epoch; the
  Woodbury algebra of ``fitting/woodbury.py`` (and kernel K3) never builds
  the (N, k_epoch) membership matrix.

The noise likelihood (``fitting/noise_like.py``) samples the
hyperparameters that ``hyper_param_names`` lists. Its basis does not depend
on them, so it is formed once; per evaluation only ``scale_sigma`` and
``prior_weights`` (the basis's prior variances) run, on leaves that may be
batched (shape (E, 1)) and that autograd differentiates.

The epoch grouping is host work of ``TimingModel.build_tensor``
(``EcorrNoise.host_columns``, on the prepared TDB); a prepared archive
carries its result (``ecorr_eidx``, ``ecorr_widx``).

The power-law processes (PLRedNoise, PLDMNoise) are dense Fourier bases:
interleaved sin and cos columns at f_k = k / T over the global span T of
the real TOAs (``noise_tspan``, a (1, 1) host column), DM noise's scaled by
(1400 MHz / f)^2, with the power-law prior variance of each column. Kernel
K8 writes the columns on the card (``fitting/design.fourier_basis``). The
common GWB process (PLGWBNoise) is the same power law on a pulsar's own span
when it stands alone, and on an array's span, coupled across the pulsars by
the Hellings-Downs ORF (``hd_orf``, ``orf_matrix``), in the joint PTA
likelihood (``fitting/pta_like.py``).
"""

from __future__ import annotations

import logging

import math

import numpy as np
import torch

from pint_tpu_torch.models.base import Component, leaf_to_f64
from pint_tpu_torch.models.parameter import ParamSpec

log = logging.getLogger("pint_tpu_torch.noise")


def hypot(x, y):
    """jax.numpy.hypot's algorithm, so that scaled sigmas are bitwise those
    of the JAX package: max(|x|, |y|) sqrt(1 + (min/max)^2)."""
    x, y = torch.abs(x), torch.abs(y)
    idx_inf = torch.isposinf(x) | torch.isposinf(y)
    x, y = torch.maximum(x, y), torch.minimum(x, y)
    q = y / torch.where(x == 0, torch.ones_like(x), x)
    h = torch.where(x == 0, x, x * torch.sqrt(1 + q * q))
    return torch.where(idx_inf, torch.full_like(h, float("inf")), h)


class NoiseComponent(Component):
    register = False
    introduces_correlated_errors = False

    def scale_sigma(self, params: dict, tensor: dict, sigma):
        """Rescale per-TOA sigmas (seconds); identity by default."""
        return sigma

    def hyper_param_names(self, params: dict) -> list[str]:
        """The noise hyperparameters this component owns among `params`:
        the bound mask parameters (EFAC1, EQUAD1, ECORR1, ...); the
        power-law components name their amplitude and index."""
        return [mp.name for mp in self.mask_params if mp.name in params]

    def prior_weights(self, params: dict, tensor: dict):
        """The prior variances of this component's basis columns ((..., k),
        leading axes those of the parameter leaves), or None."""
        return None

    def basis_and_weights(self, params: dict, tensor: dict, sl):
        """``("epoch", eidx (N_data,) int64, phi (ke,))`` for ECORR,
        ``("dense", F (N_data, kd), phi (kd,))`` for a Fourier basis, or
        None."""
        return None


class ScaleToaError(NoiseComponent):
    """EFAC/EQUAD rescaling: sigma' = EFAC sqrt(sigma^2 + EQUAD^2) over each
    mask, EQUADs in quadrature first, then EFACs."""

    category = "scale_toa_error"
    register = True

    @classmethod
    def mask_bases(cls):
        return [
            ParamSpec("EFAC", unit="", aliases=("T2EFAC",), description="error scale factor"),
            ParamSpec("EQUAD", scale=1e-6, unit="us", aliases=("T2EQUAD",),
                      description="error added in quadrature"),
        ]

    def scale_sigma(self, params, tensor, sigma):
        for mp in self.mask_params:
            if mp.base != "EQUAD":
                continue
            m = tensor[f"mask_{mp.name}"]
            eq = leaf_to_f64(params[mp.name])
            sigma = torch.where(m > 0, hypot(sigma, eq), sigma)
        for mp in self.mask_params:
            if mp.base != "EFAC":
                continue
            m = tensor[f"mask_{mp.name}"]
            ef = leaf_to_f64(params[mp.name])
            sigma = torch.where(m > 0, ef * sigma, sigma)
        return sigma


class ScaleDmError(NoiseComponent):
    """DMEFAC/DMEQUAD rescaling of the wideband DM uncertainties, over each
    mask: DMEQUADs in quadrature first, then DMEFACs. It acts on the DM
    block of a wideband fit only, never on the TOA sigmas."""

    category = "scale_dm_error"
    register = True

    @classmethod
    def mask_bases(cls):
        return [ParamSpec("DMEFAC", unit="", description="DM error scale factor"),
                ParamSpec("DMEQUAD", unit="pc cm^-3", description="DM error added in quadrature")]

    def scale_dm_sigma(self, params, tensor, sigma_dm):
        for mp in self.mask_params:
            if mp.base != "DMEQUAD":
                continue
            m = tensor[f"mask_{mp.name}"]
            eq = leaf_to_f64(params[mp.name])
            sigma_dm = torch.where(m > 0, hypot(sigma_dm, eq), sigma_dm)
        for mp in self.mask_params:
            if mp.base != "DMEFAC":
                continue
            m = tensor[f"mask_{mp.name}"]
            ef = leaf_to_f64(params[mp.name])
            sigma_dm = torch.where(m > 0, ef * sigma_dm, sigma_dm)
        return sigma_dm


def _quantize_epochs(t_s: np.ndarray, dt: float = 1.0, nmin: int = 2) -> list[np.ndarray]:
    """Group times into buckets separated by > dt seconds, keeping buckets
    with >= nmin members (NANOGrav ECORR epochs: simultaneous sub-band TOAs
    within ~1 s)."""
    if len(t_s) == 0:
        return []
    isort = np.argsort(t_s)
    buckets = [[isort[0]]]
    ref = t_s[isort[0]]
    for i in isort[1:]:
        if t_s[i] - ref < dt:
            buckets[-1].append(i)
        else:
            buckets.append([i])
            ref = t_s[i]
    return [np.asarray(b) for b in buckets if len(b) >= nmin]


class EcorrNoise(NoiseComponent):
    """Epoch-correlated white noise: a fully correlated error within each
    observing epoch of a backend. The archive carries the epoch of every
    row (``ecorr_eidx``, float64, -1 for none, the TZR row included) and
    the ECORR parameter of every epoch (``ecorr_widx``, shape (1, ke): the
    leading axis keeps it clear of the row axis)."""

    category = "ecorr_noise"
    register = True
    introduces_correlated_errors = True

    @classmethod
    def mask_bases(cls):
        return [ParamSpec("ECORR", scale=1e-6, unit="us", aliases=("TNECORR",),
                          description="epoch-correlated error")]

    def host_columns(self, toas, params):
        """The mask columns, then each row's epoch (``ecorr_eidx``, -1 for
        none) and each epoch's ECORR parameter (``ecorr_widx``), grouped on
        the prepared TDB. Zero-error rows (the TZR row) join no epoch; where
        two ECORR selections overlap, the first keeps the rows."""
        cols = super().host_columns(toas, params)
        t_s = toas.tdb.mjd_float() * 86400.0
        n = len(toas)
        real = np.asarray(toas.error_us) > 0
        eidx = np.full(n, -1.0)
        widx: list[int] = []
        k = 0
        for pi, mp in enumerate(self.mask_params):
            mask = np.flatnonzero((cols[f"mask_{mp.name}"] > 0) & real)
            for bucket in _quantize_epochs(t_s[mask]):
                rows = mask[bucket]
                taken = eidx[rows] >= 0
                if taken.any():
                    log.warning(f"{int(taken.sum())} TOAs already in an ECORR epoch; "
                                f"{mp.name} keeps only the unclaimed ones")
                    rows = rows[~taken]
                    if len(rows) < 2:
                        continue
                eidx[rows] = k
                widx.append(pi)
                k += 1
        if k == 0:
            log.warning("ECORR present but no epoch has >= 2 selected TOAs")
        cols["ecorr_eidx"] = eidx
        cols["ecorr_widx"] = (np.asarray(widx, np.float64)[None, :] if widx
                              else np.zeros((1, 0)))
        return cols

    def prior_weights(self, params, tensor):
        """ECORR^2 of each epoch's parameter. An array's stacked
        ``ecorr_widx`` (N, 1, ke), with parameter leaves (..., N, 1), gives
        (..., N, ke)."""
        widx_arr = tensor["ecorr_widx"]
        if widx_arr.shape[-1] == 0:
            return None
        vals = torch.stack(torch.broadcast_tensors(
            *[leaf_to_f64(params[mp.name]) for mp in self.mask_params]), dim=-1)
        if widx_arr.dim() == 2:
            return vals[..., widx_arr[0].to(torch.int64)] ** 2
        widx = widx_arr[:, 0].to(torch.int64)
        vals = vals[..., 0, :]
        return torch.gather(vals, -1, widx.expand(*vals.shape[:-1], widx.shape[-1])) ** 2

    def basis_and_weights(self, params, tensor, sl):
        phi = self.prior_weights(params, tensor)
        if phi is None:
            return None
        eidx = tensor["ecorr_eidx"][sl].to(torch.int64)
        return ("epoch", eidx, phi)


#: 1 / year in Hz, the power law's reference frequency (pint_tpu FYR_HZ)
FYR_HZ = 1.0 / 3.16e7


def _tspan_col(toas) -> np.ndarray:
    """Global observing span (s) over real (error > 0) TOAs, shaped (1, 1)
    to ride in the tensor clear of the TZR row."""
    t = toas.tdb.mjd_float() * 86400.0
    real = np.asarray(toas.error_us) > 0
    if real.any():
        t = t[real]
    return np.asarray([[t.max() - t.min()]])


def powerlaw_psd_weights(f: torch.Tensor, amp, gamma) -> torch.Tensor:
    """Power-law PSD A^2/(12 pi^2) fyr^(gamma-3) f^(-gamma) at frequencies f."""
    return amp**2 / (12.0 * np.pi**2) * FYR_HZ ** (gamma - 3.0) * f ** (-gamma)


def fourier_freqs(nf: int, T: torch.Tensor) -> torch.Tensor:
    """jnp.linspace(1/T, nf/T, nf) in jax's arithmetic: start (1 - s_k) +
    stop s_k with s_k = k / (nf - 1), the last one stop itself. Spans T
    (...,) give (..., nf)."""
    start = (T.new_full((), 1.0) / T)[..., None]
    stop = (T.new_full((), float(nf)) / T)[..., None]
    if nf == 1:
        return start
    div = nf - 1
    step = torch.arange(div, dtype=torch.float64, device=T.device) / T.new_full((), float(div))
    return torch.cat([start * (1 - step) + stop * step, stop], dim=-1)


def dm_noise_scale(freq_mhz: torch.Tensor) -> torch.Tensor:
    """(1400 MHz / f)^2, zero at a non-finite frequency."""
    q = freq_mhz.new_full((), 1400.0) / freq_mhz
    return torch.where(torch.isfinite(freq_mhz), q * q, 0.0)


def fourier_basis_plain(t: torch.Tensor, freqs: torch.Tensor, scale=None) -> torch.Tensor:
    """Twin of K8's Fourier pass: (N, 2 nf) interleaved sin, cos of
    2 pi t f_k, times `scale` (N,) per row when given."""
    from pint_tpu_torch.ops import libm

    arg = 2.0 * math.pi * t[:, None] * freqs[None, :]
    F = torch.stack([libm.sin(arg), libm.cos(arg)], dim=2).reshape(t.shape[0], 2 * freqs.shape[0])
    return F if scale is None else F * scale[:, None]


class PowerLawNoise(NoiseComponent):
    """A power-law process on a Fourier basis of `nf` frequencies."""

    register = False
    introduces_correlated_errors = True
    count_key = ""
    dm_scaled = False

    def __init__(self):
        super().__init__()
        self.nf = 30

    def host_columns(self, toas, params):
        cols = super().host_columns(toas, params)
        cols["noise_tspan"] = _tspan_col(toas)
        return cols

    def validate(self, params, meta):
        self.nf = int(meta.get(self.count_key, 30))

    def amp_gamma(self, params):
        raise NotImplementedError

    def prior_weights(self, params, tensor):
        """`weights_at` the grid of the span ``noise_tspan`` (1, 1). An
        array's stacked span (N, 1, 1), with parameter leaves (..., N, 1),
        gives (..., N, k)."""
        freqs = fourier_freqs(self.nf, tensor["noise_tspan"][..., 0, 0])
        return self.weights_at(params, torch.repeat_interleave(freqs, 2, dim=-1))

    def weights_at(self, params, fr: torch.Tensor) -> torch.Tensor:
        """The power law's variance of each sin and cos column at the
        frequencies `fr` (..., k), each repeated for its two columns, times
        the lowest frequency."""
        amp, gamma = self.amp_gamma(params)
        return powerlaw_psd_weights(fr, amp, gamma) * fr[..., :1]

    def basis_and_weights(self, params, tensor, sl):
        from pint_tpu_torch.fitting.design import fourier_basis

        freqs = fourier_freqs(self.nf, tensor["noise_tspan"][0, 0])
        scale = dm_noise_scale(tensor["freq_mhz"][sl]) if self.dm_scaled else None
        F = fourier_basis(tensor["t_hi"][sl], freqs, scale)
        return ("dense", F, self.prior_weights(params, tensor))


class PLRedNoise(PowerLawNoise):
    """Achromatic power-law red noise: TNREDAMP (log10 amplitude), TNREDGAM,
    TNREDC frequencies, or the tempo1 RNAMP/RNIDX pair."""

    category = "pl_red_noise"
    register = True
    count_key = "TNREDC"

    @classmethod
    def param_specs(cls):
        return [
            ParamSpec("RNAMP", kind="float", description="red noise amplitude (tempo1 units)"),
            ParamSpec("RNIDX", kind="float", description="red noise spectral index (tempo1 sign)"),
            ParamSpec("TNREDAMP", kind="float", description="log10 red noise amplitude"),
            ParamSpec("TNREDGAM", kind="float", description="red noise spectral index"),
            ParamSpec("TNREDC", kind="int", description="number of red-noise frequencies"),
        ]

    def validate(self, params, meta):
        super().validate(params, meta)
        has_tn = "TNREDAMP" in params and "TNREDGAM" in params
        has_rn = "RNAMP" in params and "RNIDX" in params
        if not (has_tn or has_rn):
            raise ValueError("PLRedNoise needs TNREDAMP/TNREDGAM or RNAMP/RNIDX")

    def amp_gamma(self, params):
        if "TNREDAMP" in params and "TNREDGAM" in params:
            return 10.0 ** leaf_to_f64(params["TNREDAMP"]), leaf_to_f64(params["TNREDGAM"])
        # RNAMP -> the GW-units amplitude (pint_tpu noise.py)
        fac = (86400.0 * 365.24 * 1e6) / (2.0 * np.pi * np.sqrt(3.0))
        return leaf_to_f64(params["RNAMP"]) / fac, -leaf_to_f64(params["RNIDX"])

    def hyper_param_names(self, params):
        if "TNREDAMP" in params and "TNREDGAM" in params:
            return ["TNREDAMP", "TNREDGAM"]
        return [n for n in ("RNAMP", "RNIDX") if n in params]


class PLDMNoise(PowerLawNoise):
    """Power-law DM noise: the Fourier basis scaled by (1400 MHz / f)^2 per
    TOA; TNDMAMP, TNDMGAM, TNDMC."""

    category = "pl_dm_noise"
    register = True
    count_key = "TNDMC"
    dm_scaled = True

    @classmethod
    def param_specs(cls):
        return [
            ParamSpec("TNDMAMP", kind="float", description="log10 DM noise amplitude"),
            ParamSpec("TNDMGAM", kind="float", description="DM noise spectral index"),
            ParamSpec("TNDMC", kind="int", description="number of DM-noise frequencies"),
        ]

    def validate(self, params, meta):
        super().validate(params, meta)
        if "TNDMAMP" not in params or "TNDMGAM" not in params:
            raise ValueError("PLDMNoise needs TNDMAMP and TNDMGAM")

    def amp_gamma(self, params):
        return 10.0 ** leaf_to_f64(params["TNDMAMP"]), leaf_to_f64(params["TNDMGAM"])

    def hyper_param_names(self, params):
        return [n for n in ("TNDMAMP", "TNDMGAM") if n in params]


class PLGWBNoise(PowerLawNoise):
    """The common power-law process of a PTA: the stochastic gravitational-
    wave background every pulsar shares, with Hellings-Downs correlations
    between pulsars (`hd_orf`). TNGWAMP (log10 strain amplitude), TNGWGAM
    (spectral index, 13/3 for a background of binary black holes), TNGWC
    (frequencies on the common grid).

    Alone (`basis_and_weights`) it is its auto term, a dense block on the
    pulsar's own span like any red noise; in the joint likelihood the
    per-pulsar block comes from `gwb_basis` on the span of the whole array,
    and the pulsar's own basis leaves it out
    (``TimingModel.noise_basis_and_weights(include_common=False)``), so that
    the auto term is not counted twice."""

    category = "pl_gwb_noise"
    register = True
    count_key = "TNGWC"
    #: an array-common process: the joint likelihood couples pulsars through it
    common_process = True

    def __init__(self):
        super().__init__()
        self.nf = 10

    @classmethod
    def param_specs(cls):
        return [
            ParamSpec("TNGWAMP", kind="float", description="log10 GWB strain amplitude"),
            ParamSpec("TNGWGAM", kind="float", description="GWB spectral index (13/3 for SMBHBs)"),
            ParamSpec("TNGWC", kind="int", description="number of GWB frequencies"),
        ]

    def validate(self, params, meta):
        self.nf = int(meta.get(self.count_key, 10))
        if "TNGWAMP" not in params or "TNGWGAM" not in params:
            raise ValueError("PLGWBNoise needs TNGWAMP and TNGWGAM")

    def amp_gamma(self, params):
        return 10.0 ** leaf_to_f64(params["TNGWAMP"]), leaf_to_f64(params["TNGWGAM"])

    def hyper_param_names(self, params):
        return [n for n in ("TNGWAMP", "TNGWGAM") if n in params]

    def gwb_basis(self, params: dict, tensor: dict, sl, tspan: torch.Tensor):
        """(G (N_data, 2 nf), phi_gw (2 nf,)) on the common span `tspan` (a
        float64 tensor): every pulsar of an array passes the same span, so
        that the frequencies line up across the pulsars."""
        from pint_tpu_torch.fitting.design import fourier_basis

        freqs = fourier_freqs(self.nf, tspan)
        G = fourier_basis(tensor["t_hi"][sl], freqs)
        return G, self.weights_at(params, torch.repeat_interleave(freqs, 2))


def hd_orf(cos_sep: torch.Tensor) -> torch.Tensor:
    """Hellings-Downs overlap reduction function of the separation cosine:
    Gamma = 1.5 x ln x - x / 4 + 1 / 2, x = (1 - cos) / 2 (distinct pulsars;
    `orf_matrix` sets the diagonal). The log is the C library's on the CPU
    (``ops/libm.py``), as the JAX package's."""
    from pint_tpu_torch.ops import libm

    x = 0.5 * (1.0 - cos_sep)
    xs = torch.where(x > 0, x, 1.0)
    return 1.5 * x * libm.log(xs) - 0.25 * x + 0.5


def orf_matrix(positions: np.ndarray) -> np.ndarray:
    """(N, N) Hellings-Downs matrix of an array's unit sky vectors (host):
    `hd_orf` off the diagonal, 1 on it (the auto term with the pulsar term)."""
    pos = np.asarray(positions, float)
    cos = np.clip(pos @ pos.T, -1.0, 1.0)
    out = hd_orf(torch.as_tensor(cos)).numpy().copy()
    np.fill_diagonal(out, 1.0)
    return out


def pulsar_position(model) -> np.ndarray:
    """(3,) ICRS unit vector of a model's pulsar on the host, from RAJ/DECJ
    or ELONG/ELAT (proper motion is below the ORF's accuracy)."""
    from pint_tpu_torch.models.astrometry import ecliptic_to_icrs, unit_vector

    p = model.params

    def angle(name):
        return torch.as_tensor(float(leaf_to_f64(p[name])), dtype=torch.float64)

    if "RAJ" in p and "DECJ" in p:
        return unit_vector(angle("RAJ"), angle("DECJ")).numpy()
    if "ELONG" in p and "ELAT" in p:
        return ecliptic_to_icrs(unit_vector(angle("ELONG"), angle("ELAT"))).numpy()
    raise ValueError(
        f"model {model.psr_name!r} has no astrometry parameters; cannot "
        "place it on the sky for the Hellings-Downs ORF")

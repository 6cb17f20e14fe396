"""The marginalized noise likelihood of one pulsar, its gradient and the ML
optimizer (counterpart of ``pint_tpu/fitting/noise_like.py``), and kernel K9.

The timing model is linearized once at the current parameters (run a fit
first): r(delta) = r0 - M delta, with (r0, M) from kernel K1's tangents of
every free timing parameter (``subtract_mean=False``) and, when the model has
no PHOFF, the profiled phase offset 1/f as one more column. The timing
parameters are then marginalized in closed form (vH&V 2014, eq. 14):

    2 ln L(eta) = -[r0^T C^-1 r0 - b^T A^-1 b + ln|C| + ln|A| + (n - p) ln 2 pi],
    A = Mn^T C^-1 Mn + 1e-12 I,  b = Mn^T C^-1 r0,  Mn = M / sqrt(sum M^2),

(with the equilibration's log-det added back; ``marginalize_timing=False``
drops ln|A| and p: the profiled likelihood). The noise hyperparameters eta
(EFAC, EQUAD, ECORR, the power laws' log10 amplitude and index) change only
the weights w = 1/sigma(eta)^2 and the basis's prior variances phi(eta); the
basis (ECORR epochs, the Fourier columns that kernel K8 writes) is formed
once at construction.

On the card one evaluation of E points is:

- sigma(eta), phi(eta): elementwise torch, differentiable;
- `_NoiseLogLike`, a ``torch.autograd.Function``. Its forward is kernel K3's
  per-set-weight mode (``woodbury.ecorr_normal_eq_sets``) plus the p x p
  Cholesky of A (``torch.linalg``, batched); its backward is kernel K9
  (`noise_grad`, ``csrc/noise_grad.cu``), d lnL / d w and d lnL / d phi in
  closed form (the formulas are in the kernel's source), which autograd
  carries back to eta through the elementwise ops.

`optimize` is pint_tpu's batched Adam restarts in prior-scaled coordinates
as a host loop of one batched forward and backward per step; Adam's state
and the best points stay on the device. The JAX package's mesh layout
(ROADMAP A15), its chains and Laplace Hessian (B15) and its fleets (A11b)
are not ported: asking for them raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from pint_tpu_torch.fitting import grad_plan
from pint_tpu_torch.fitting.wls import time_resid_design
from pint_tpu_torch.fitting.woodbury import EpochIndex, ecorr_normal_eq_sets
from pint_tpu_torch.models.base import leaf_to_f64
from pint_tpu_torch.priors import UniformPrior

#: ridge on the equilibrated timing normal matrix A (pint_tpu RIDGE)
RIDGE = 1e-12

_LN2PI = float(np.log(2.0 * np.pi))


def noise_param_names(model) -> tuple[str, ...]:
    """Every noise hyperparameter the model owns (EFAC1.., EQUAD1..,
    ECORR1.., TNREDAMP/TNREDGAM, TNDMAMP/TNDMGAM), in component order."""
    names: list[str] = []
    for c in model.noise_components:
        for n in c.hyper_param_names(model.params):
            if n not in names:
                names.append(n)
    return tuple(names)


def default_noise_priors(model, hyper: tuple[str, ...]) -> dict:
    """Uniform windows per hyperparameter family (the enterprise/PINT
    convention): EFAC in [0.01, 10], EQUAD/ECORR in [0, 100 us] (seconds),
    log10 amplitudes in [-20, -8], spectral indices in [0, 7]."""
    out = {}
    for n in hyper:
        base = n.rstrip("0123456789")
        if base in ("EFAC", "T2EFAC", "DMEFAC"):
            out[n] = UniformPrior(0.01, 10.0)
        elif base in ("EQUAD", "T2EQUAD", "ECORR", "TNECORR"):
            out[n] = UniformPrior(0.0, 1e-4)
        elif base in ("TNREDAMP", "TNDMAMP", "TNGWAMP"):
            out[n] = UniformPrior(-20.0, -8.0)
        elif base in ("TNREDGAM", "TNDMGAM", "TNGWGAM"):
            out[n] = UniformPrior(0.0, 7.0)
        else:
            out[n] = UniformPrior()
    return out


def _prior_scale(prior) -> float:
    """A tenth of the prior window, else the prior's sigma, else 1: the
    optimizer's coordinate scale."""
    lo = getattr(prior, "lo", -np.inf)
    hi = getattr(prior, "hi", np.inf)
    if np.isfinite(lo) and np.isfinite(hi) and hi > lo:
        return 0.1 * (hi - lo)
    sig = getattr(prior, "sigma", None)
    return float(sig) if sig else 1.0


def _apply_eta(params0: dict, hyper: tuple[str, ...], eta) -> dict:
    """params with the hyperparameters replaced by eta's entries (eta[i] is
    hyperparameter i: a scalar, or (E, 1) for E points at once)."""
    params = dict(params0)
    for i, n in enumerate(hyper):
        params[n] = eta[i]
    return params


# --- the likelihood core ---------------------------------------------------------


class NoiseCore(NamedTuple):
    """The fixed operands of one likelihood: r0 (N,), the raw design M (p,
    N), its unweighted column norms mnorm (p,), the dense basis Fd (kd, N)
    (None without one), the ECORR epochs (None without), each row's epoch
    eidx (N,) int32 (-1 for none), and the mode."""

    r0: torch.Tensor
    M: torch.Tensor
    mnorm: torch.Tensor
    Fd: torch.Tensor | None
    epochs: EpochIndex | None
    eidx: torch.Tensor
    marginalize: bool


class NoiseState(NamedTuple):
    """What the backward reads from one forward of E points: the inputs
    (w (E, N), phi_e (E, ke), phi_d (E, kd)), K3's saved pieces (its
    design norms, De, the epoch sums, L, Wz, ad), the Cholesky factor K of A
    and dhat = A^-1 b (E, p), and which points factored."""

    w: torch.Tensor
    phi_e: torch.Tensor
    phi_d: torch.Tensor
    norm: torch.Tensor
    De: torch.Tensor
    esum: torch.Tensor
    L: torch.Tensor
    Wz: torch.Tensor
    ad: torch.Tensor
    K: torch.Tensor
    delta: torch.Tensor
    ok: torch.Tensor


def noise_forward(core: NoiseCore, w: torch.Tensor, phi_e: torch.Tensor,
                  phi_d: torch.Tensor):
    """(lnL (E,), NoiseState) at E weight sets w (E, N) and prior variances
    phi_e (E, ke), phi_d (E, kd) ((E, 0) where the basis has no such part):
    K3's per-set-weight mode (its twin on the CPU), then A's Cholesky factor
    and the profiled chi^2 in the JAX package's order. A point whose A does
    not factor gets NaN, as jax's Cholesky gives it."""
    E, n = w.shape
    p = core.M.shape[0]
    ne = ecorr_normal_eq_sets(core.r0, core.M, w, core.Fd, core.epochs, phi_e, phi_d, RIDGE)
    chi2, ld = ne.chi2, ne.logdet
    K = w.new_zeros((E, 0, 0))
    delta = w.new_zeros((E, 0))
    ok = torch.ones(E, dtype=torch.bool, device=w.device)
    n_prof = 0.0
    if p:
        b = -ne.c
        K, info = torch.linalg.cholesky_ex(ne.G)
        ok = info == 0
        delta = torch.cholesky_solve(b[..., None], K)[..., 0]
        chi2 = chi2 - (b[:, None, :] @ delta[:, :, None])[:, 0, 0]
        if core.marginalize:
            # ln|A_unequilibrated| = ln|A_n| + 2 sum ln norm
            ld = ld + 2.0 * torch.sum(torch.log(torch.diagonal(K, dim1=1, dim2=2)), dim=1)
            ld = ld + 2.0 * torch.sum(torch.log(core.mnorm))
            n_prof = float(p)
    ll = -0.5 * (chi2 + ld + (n - n_prof) * _LN2PI)
    ll = torch.where(ok, ll, float("nan"))
    st = NoiseState(w=w, phi_e=phi_e, phi_d=phi_d, norm=ne.norm, De=ne.De, esum=ne.esum,
                    L=ne.L, Wz=ne.Wz, ad=ne.ad, K=K, delta=delta, ok=ok)
    return ll, st


def _inverse_t(L: torch.Tensor) -> torch.Tensor:
    """L^-T (upper) of lower Cholesky factors (..., m, m)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False).mT.contiguous()


def _grad_prep(st: NoiseState, p: int):
    """The backward's small factors, shared by K9 and its twin: K^-T and
    L^-T (A = K K^T, Sigma = L L^T; each quadratic form is the squared norm
    of a triangular product), g_d = L^-T Wz_M (kd, p) and the profiled
    dense amplitudes ahat_d = L^-T (Wz_r - Wz_M dhat)."""
    E, kd = st.phi_d.shape
    Kt = _inverse_t(st.K) if p else st.K
    if not kd:
        return Kt, st.L, st.w.new_zeros((E, 0, p)), st.ad
    gd = torch.linalg.solve_triangular(st.L.mT, st.Wz[..., :p], upper=True)
    ahat_d = st.ad - (gd @ st.delta[..., None])[..., 0]
    return Kt, _inverse_t(st.L), gd, ahat_d


def _rows_of(x: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """(E, ke, ...) -> (E, N, ...): each row's epoch entry, 0 for none."""
    xp = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    return xp[:, torch.where(eidx < 0, x.shape[1], eidx.to(torch.int64))]


def noise_grad_plain(core: NoiseCore, st: NoiseState):
    """Twin of K9: (d lnL / d w (E, N), d lnL / d phi (E, ke + kd), epochs
    first), the kernel's formulas in torch on the same inputs."""
    E, n = st.w.shape
    p = core.M.shape[0]
    ke, kd = st.phi_e.shape[1], st.phi_d.shape[1]
    Kt, Lt, gd, ahd = _grad_prep(st, p)
    X = (core.M / st.norm[:, None]).T
    dl = st.delta[..., None]
    zero = st.w.new_zeros
    ge_r, ae_r, inv_r, Bn_r = zero((E, n, p)), zero((E, n)), zero((E, n)), zero((E, n, kd))
    dphi = []
    if ke:
        Y, s, B = st.esum[..., :p], st.esum[..., p], st.esum[..., p + 1:]
        inv = 1.0 / st.De
        ge = (Y - B @ gd) * inv[..., None]
        ae = (s - (Y @ dl)[..., 0] - (B @ ahd[..., None])[..., 0]) * inv
        Bn = B * inv[..., None]
        sinv = inv + torch.sum((Bn @ Lt) ** 2, dim=-1)
        dphi.append((st.phi_e, ae, sinv, torch.sum((ge @ Kt) ** 2, dim=-1)))
        ge_r, ae_r, inv_r, Bn_r = (_rows_of(x, core.eidx) for x in (ge, ae, inv, Bn))
    if kd:
        dphi.append((st.phi_d, ahd, torch.sum(Lt**2, dim=-1),
                     torch.sum((gd @ Kt) ** 2, dim=-1)))
    mt = X - ge_r
    u = core.r0 - (X @ dl)[..., 0] - ae_r
    q = inv_r
    if kd:
        F = core.Fd.T
        mt = mt - F @ gd
        u = u - (F @ ahd[..., None])[..., 0]
        h = F - Bn_r
        q = inv_r + torch.sum((h @ Lt) ** 2, dim=-1)
    t = torch.sum((mt @ Kt) ** 2, dim=-1) if core.marginalize else torch.zeros_like(u)
    dw = -0.5 * (u * u + q + t - 1.0 / st.w)
    parts = []
    for phi, ahat, sinv, gag in dphi:
        iphi = 1.0 / phi
        tt = gag if core.marginalize else torch.zeros_like(gag)
        parts.append(-0.5 * (iphi - iphi * iphi * (ahat * ahat + sinv + tt)))
    return dw, (torch.cat(parts, dim=1) if parts else zero((E, 0)))


def noise_grad(core: NoiseCore, st: NoiseState):
    """K9: d lnL / d w and d lnL / d phi of E points. A CUDA tensor launches
    the kernel (and raises if it cannot); a CPU tensor takes
    `noise_grad_plain`. `noise_grad.launches` counts calls (3 passes each)."""
    if st.w.device.type == "cpu":
        return noise_grad_plain(core, st)
    out = _launch_k9(core, st)
    noise_grad.launches += 1
    return out


noise_grad.launches = 0


def _launch_k9(core: NoiseCore, st: NoiseState):
    """K9's three passes (``csrc/noise_grad.cu``) at the plan its library
    gives (`grad_plan.noise_grad_plan`), which raises, naming the limit, on a
    shape the kernel does not take. The
    kernel forms K^-T, L^-T, g_d and ahat_d itself from K, L, Wz, ad and
    dhat (the twin's `_grad_prep`)."""
    from pint_tpu_torch.device import require_f64
    from pint_tpu_torch.ops import build

    E, n = st.w.shape
    p = core.M.shape[0]
    ke, kd = st.phi_e.shape[1], st.phi_d.shape[1]
    ins = {"M": core.M, "norm": st.norm, "r0": core.r0, "w": st.w, "De": st.De,
           "esum": st.esum, "phi_e": st.phi_e, "phi_d": st.phi_d, "K": st.K, "L": st.L,
           "Wz": st.Wz, "ad": st.ad, "delta": st.delta, **({"Fd": core.Fd} if kd else {})}
    require_f64("noise_grad", tensor=ins)
    dev = st.w.device
    if any(t.device != dev for t in ins.values()) or core.eidx.device != dev:
        raise ValueError("noise_grad needs its tensors on one device")
    lib = build.library("noise_grad", _declare_k9)
    plan = grad_plan.noise_grad_plan(lib, n, p, ke, kd, E, core.marginalize)
    ins = {k: v.contiguous() for k, v in ins.items()}
    ptr = {k: v.data_ptr() for k, v in ins.items()}
    eidx = core.eidx.contiguous()
    scratch = torch.empty(plan["scratch"], dtype=torch.float64, device=dev)
    dw = torch.empty((E, n), dtype=torch.float64, device=dev)
    dphi = torch.empty((E, ke + kd), dtype=torch.float64, device=dev)
    build.check(lib, lib.noise_grad(
        ptr["M"], ptr["norm"], ptr["r0"], ptr.get("Fd", ptr["w"]), ptr["w"],
        eidx.data_ptr(), ptr["De"], ptr["esum"], ptr["phi_e"], ptr["phi_d"],
        ptr["K"], ptr["L"], ptr["Wz"], ptr["ad"], ptr["delta"], E, p, n, ke, kd,
        int(core.marginalize), scratch.data_ptr(), dw.data_ptr(), dphi.data_ptr(),
        build.stream_of(st.w)))
    return dw, dphi


def _declare_k9(lib) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.noise_grad.argtypes = [p] * 15 + [i] * 6 + [p] * 4
    lib.noise_grad.restype = ctypes.c_int
    grad_plan.declare(lib)


class _NoiseLogLike(torch.autograd.Function):
    """lnL (E,) of E weight sets: forward K3's per-set-weight mode, backward
    K9 (their twins on the CPU). A point whose cotangent is zero (outside its
    prior, masked by `where`) gets an exactly zero gradient, a point whose A
    did not factor a NaN one."""

    @staticmethod
    def forward(ctx, w, phi_e, phi_d, core):
        ll, st = noise_forward(core, w, phi_e, phi_d)
        ctx.core = core
        ctx.save_for_backward(*st)
        return ll

    @staticmethod
    def backward(ctx, g):
        st = NoiseState(*ctx.saved_tensors)
        dw, dphi = noise_grad(ctx.core, st)
        bad = ~st.ok[:, None]
        dw = torch.where(bad, float("nan"), dw)
        dphi = torch.where(bad, float("nan"), dphi)
        live = (g != 0)[:, None]
        gw = torch.where(live, g[:, None] * dw, 0.0)
        gphi = torch.where(live, g[:, None] * dphi, 0.0)
        ke = st.phi_e.shape[1]
        need = ctx.needs_input_grad
        return (gw if need[0] else None, gphi[:, :ke] if need[1] else None,
                gphi[:, ke:] if need[2] else None, None)


# --- the posterior surface ---------------------------------------------------------


class MarginalizedPosterior:
    """Evaluation and optimization over one marginalized likelihood.
    Subclasses set ``hyper``, ``priors``, ``scales``, ``x0`` and
    ``_lnlike(eta (E, h) tensor) -> (E,)``."""

    #: loglike_many's bucket: E is padded to a multiple of it (a power of two
    #: below it for small E), the padding repeating the last point
    EVAL_CHUNK = 256

    @property
    def nparams(self) -> int:
        return len(self.hyper)

    def _eta(self, eta) -> torch.Tensor:
        return torch.as_tensor(np.asarray(eta, np.float64), device=self.device)

    def lnprior(self, eta: torch.Tensor) -> torch.Tensor:
        """Sum of the priors' log densities at eta (..., h)."""
        lp = 0.0
        for i, n in enumerate(self.hyper):
            lp = lp + self.priors[n].logpdf(eta[..., i])
        return lp

    def _lnpost(self, eta: torch.Tensor) -> torch.Tensor:
        """ln posterior (E,) at eta (E, h); the likelihood is masked to 0
        where the prior is -inf (value and gradient)."""
        lp = self.lnprior(eta)
        ll = self._lnlike(eta)
        return lp + torch.where(torch.isfinite(lp), ll, 0.0)

    def loglike(self, eta) -> float:
        """Marginalized ln-likelihood at one hyperparameter vector."""
        with torch.no_grad():
            return float(self._lnlike(self._eta(eta)[None])[0])

    def loglike_many(self, etas, chunk: int | None = None) -> np.ndarray:
        """ln-likelihood at each row of etas (E, h), `chunk` points per
        kernel call (pint_tpu's bucket: padded with the last row)."""
        etas = np.asarray(etas, np.float64)
        E = etas.shape[0]
        if chunk is None:
            chunk = self.EVAL_CHUNK
            while chunk >= 2 * max(E, 1):
                chunk //= 2
        n_pad = (-E) % chunk
        if n_pad:
            etas = np.concatenate([etas, np.repeat(etas[-1:], n_pad, 0)])
        outs = []
        with torch.no_grad():
            for k in range(0, etas.shape[0], chunk):
                outs.append(self._lnlike(self._eta(etas[k:k + chunk])).cpu().numpy())
        return np.concatenate(outs)[:E]

    def grad(self, eta) -> np.ndarray:
        """d lnL / d eta."""
        x = self._eta(eta).requires_grad_(True)
        (g,) = torch.autograd.grad(self._lnlike(x[None])[0], x)
        return g.detach().cpu().numpy()

    def optimize(self, n_restarts: int | None = None, n_steps: int = 200,
                 lr: float = 0.05, seed: int = 0):
        """Maximum a posteriori hyperparameters by R Adam restarts in the
        prior-scaled coordinates z = (eta - x0) / scales (pint_tpu's
        optimize): restart 0 starts at x0, the others at x0 plus
        `default_rng(seed)` normal draws. Each step is one batched forward
        and backward of the R points; the best point is recorded before the
        update, non-finite gradients count as 0, and the end point is
        checked once more. Returns (eta_hat, lnpost at eta_hat)."""
        if n_restarts is None:
            n_restarts = 8
        b1, b2, eps = 0.9, 0.999, 1e-8
        scales = self._eta(self.scales)
        center = self._eta(self.x0)
        rng = np.random.default_rng(seed)
        z0 = np.zeros((n_restarts, self.nparams))
        z0[1:] = rng.standard_normal((n_restarts - 1, self.nparams))
        z = self._eta(z0)
        m, v = torch.zeros_like(z), torch.zeros_like(z)
        best_z = z.clone()
        best_f = torch.full((n_restarts,), math.inf, dtype=torch.float64, device=z.device)
        for t in range(n_steps):
            zg = z.detach().requires_grad_(True)
            f = -self._lnpost(center + zg * scales)
            (g,) = torch.autograd.grad(f.sum(), zg)
            f = f.detach()
            g = torch.where(torch.isfinite(g), g, 0.0)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / (1 - b1 ** (t + 1.0))
            vh = v / (1 - b2 ** (t + 1.0))
            z_new = z - lr * mh / (torch.sqrt(vh) + eps)
            better = torch.isfinite(f) & (f < best_f)
            best_z = torch.where(better[:, None], z, best_z)
            best_f = torch.where(better, f, best_f)
            z = z_new
        with torch.no_grad():
            f_end = -self._lnpost(center + z * scales)
        better = torch.isfinite(f_end) & (f_end < best_f)
        zs = torch.where(better[:, None], z, best_z).cpu().numpy()
        fs = torch.where(better, f_end, best_f).cpu().numpy()
        best = int(np.nanargmin(fs))
        return self.x0 + zs[best] * self.scales, float(-fs[best])

    def laplace_scales(self):
        raise NotImplementedError("the Laplace Hessian of the noise posterior is not ported "
                                  "yet (ROADMAP B15)")

    def sample(self, *args, **kwargs):
        raise NotImplementedError("the noise posterior's chains are not ported yet "
                                  "(ROADMAP B15)")


def noise_design(model, free: tuple, params: dict, tensor: dict):
    """(r0 (N,), M (N, p_lin)) at the linearization point: kernel K1's
    tangents of every free timing parameter without mean subtraction, then
    the profiled phase offset 1/f when the model has no PHOFF (pint_tpu's
    noise_design program)."""
    r0, M, f = time_resid_design(model, free, params, tensor, None, False, hybrid=False,
                                 with_f=True)
    if not model.has_phase_offset:
        M = torch.cat([M, (1.0 / f)[:, None]], dim=1)
    return r0, M


def _as_sets(x: torch.Tensor | None, E: int, like: torch.Tensor) -> torch.Tensor:
    """A per-point quantity as (E, k): (k,) is shared by all points; None
    (no such basis part) is (E, 0)."""
    if x is None:
        return like.new_zeros((E, 0))
    return x.expand(E, x.shape[-1]) if x.dim() == 1 else x.reshape(E, -1)


class NoiseLikelihood(MarginalizedPosterior):
    """The noise-hyperparameter posterior of one dataset (pint_tpu's
    NoiseLikelihood on one device).

    Construction fixes the linearization point (the model's current
    parameters), computes (r0, M) once through K1 and the noise basis once
    through K8; every evaluation then runs K3's per-set-weight mode (and K9
    for a gradient) on the tensors' device.

    hyper      : hyperparameter names (default `noise_param_names`)
    priors     : {name: prior} overrides of `default_noise_priors`
    marginalize_timing : True = the marginalized likelihood (+ ln|A|);
                 False = the profiled one
    mesh       : pint_tpu's TOA-sharded layout (ROADMAP A15): raises
    """

    def __init__(self, toas, model, hyper: tuple[str, ...] | None = None,
                 priors: dict | None = None, marginalize_timing: bool = True,
                 mesh=None):
        from pint_tpu_torch.residuals import tracked_tensor

        if mesh is not None:
            raise NotImplementedError("NoiseLikelihood over a device mesh is not ported yet "
                                      "(ROADMAP A15)")
        if not model.noise_components:
            raise ValueError("model has no noise components to sample")
        self.model = model
        self.marginalize_timing = bool(marginalize_timing)
        self.hyper = tuple(hyper) if hyper else noise_param_names(model)
        if not self.hyper:
            raise ValueError("no noise hyperparameters bound on this model")
        for n in self.hyper:
            if n not in model.params:
                raise KeyError(f"unknown hyperparameter {n}")
        self.priors = default_noise_priors(model, self.hyper)
        self.priors.update(priors or {})
        self.scales = np.array([_prior_scale(self.priors[n]) for n in self.hyper])
        self.x0 = np.array([float(leaf_to_f64(model.params[n])) for n in self.hyper])
        self.toas = toas
        self.tensor = tracked_tensor(toas, model)[0]
        self.device = self.tensor["t_hi"].device
        self._build()

    def _timing_free(self) -> tuple[str, ...]:
        """The free timing parameters to profile: the free set minus every
        noise-owned parameter."""
        owned = set()
        for c in self.model.noise_components:
            owned.update(mp.name for mp in c.mask_params)
            owned.update(c.hyper_param_names(self.model.params))
        return tuple(n for n in self.model.free_params if n not in owned)

    def _build(self) -> None:
        model, tensor = self.model, self.tensor
        self._params0 = dict(model.params)
        free = self._timing_free()
        self.timing_free = free
        r0, M = noise_design(model, free, self._params0, tensor)
        self.p_lin = M.shape[1]
        col2 = torch.sum(M * M, dim=0)
        mnorm = torch.sqrt(torch.where(col2 == 0, 1.0, col2))
        basis = model.noise_basis_and_weights(self._params0, tensor)
        n = r0.shape[0]
        Fd = epochs = None
        eidx = torch.full((n,), -1, dtype=torch.int32, device=self.device)
        if basis is not None and basis.dense is not None:
            Fd = basis.dense.T.contiguous()
        if basis is not None and basis.epochs is not None:
            epochs = basis.epochs
            eidx = epochs.eidx.to(torch.int32)
        self._core = NoiseCore(r0=r0, M=M.T.contiguous(), mnorm=mnorm, Fd=Fd, epochs=epochs,
                               eidx=eidx, marginalize=self.marginalize_timing)
        self._n_data = n

    def _layout_padded(self, rows: int) -> dict:
        """The member's operands of a joint array likelihood, padded to
        `rows` data rows (memoized per bucket): r0 (rows,), the raw design M
        (p_lin, rows), its norms, the mask (1 real, 0 pad), the pulsar's own
        basis without the common process (Fd (kd, rows) or None, each row's
        epoch eidx (rows,) int32, -1 for none, and the epoch count ke), and
        the row columns the white noise reads (error_s, mask_*) for the
        weights. Pad rows are zero, in no epoch and in no mask, with error 1:
        their weight is zero."""
        cache = self.__dict__.setdefault("_padded_layouts", {})
        if rows in cache:
            return cache[rows]
        n = self._n_data
        if rows < n:
            raise ValueError(f"cannot pad {n} data rows into a bucket of {rows}")
        pad = rows - n
        dev = self.device

        def rowpad(x, fill=0.0):
            return torch.nn.functional.pad(x, (0, pad), value=fill)

        c = self._core
        basis = self.model.noise_basis_and_weights(self._params0, self.tensor,
                                                   include_common=False)
        Fd = None
        eidx = torch.full((n,), -1, dtype=torch.int32, device=dev)
        ke = 0
        if basis is not None and basis.dense is not None:
            Fd = rowpad(basis.dense.T.contiguous())
        if basis is not None and basis.epochs is not None:
            eidx = basis.epochs.eidx.to(torch.int32)
            ke = basis.ke
        cols = {"error_s": rowpad(self.tensor["error_s"][..., :n], 1.0)}
        for k, v in self.tensor.items():
            if k.startswith("mask_") and v.dim() == 1:
                cols[k] = rowpad(v[:n])
        out = {"r0": rowpad(c.r0), "M": rowpad(c.M), "mnorm": c.mnorm,
               "mask": rowpad(torch.ones(n, dtype=torch.float64, device=dev)),
               "Fd": Fd, "eidx": rowpad(eidx, -1), "ke": ke, "cols": cols}
        cache[rows] = out
        return out

    @property
    def design(self):
        """(r0 (N,), M (N, p_lin), Mnorm (p_lin,)) at the linearization point."""
        c = self._core
        return c.r0, c.M.T, c.mnorm

    def _sets(self, eta: torch.Tensor):
        """(w (E, N), phi_e (E, ke), phi_d (E, kd)) at eta (E, h): the
        weights 1/sigma(eta)^2 and the basis's prior variances."""
        E = eta.shape[0]
        params = _apply_eta(self._params0, self.hyper, eta.T[..., None])
        sigma = self.model.scaled_sigma(params, self.tensor)
        w = (1.0 / sigma**2).expand(E, self._core.r0.shape[0])
        phi_e, phi_d = self.model.noise_prior_weights(params, self.tensor)
        return w, _as_sets(phi_e, E, w), _as_sets(phi_d, E, w)

    def _lnlike(self, eta: torch.Tensor) -> torch.Tensor:
        """lnL (E,) at eta (E, h), differentiable by autograd."""
        return _NoiseLogLike.apply(*self._sets(eta), self._core)

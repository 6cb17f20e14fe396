"""The joint likelihood of a pulsar timing array under a Hellings-Downs
correlated gravitational-wave background (counterpart of
``pint_tpu/fitting/pta_like.py``), and kernel K10.

N pulsars share a stochastic background whose coefficients on a common
Fourier grid (m = 2 nf columns per pulsar, on the span of the whole array)
have the prior Phi = ORF (x) diag(phi_gw), ORF the Hellings-Downs matrix.
With D = blockdiag(C_a) (each pulsar's own noise: white, ECORR, its red
noise) and G = blockdiag(G_a) the common blocks, C = D + G Phi G^T and, by
the Woodbury identity and the determinant lemma,

    C^-1 = D^-1 - D^-1 G Sigma^-1 G^T D^-1,   Sigma = Phi^-1 + G^T D^-1 G,
    ln|C| = sum_a ln|C_a| + ln|Phi| + ln|Sigma|.

Every D^-1 stays per pulsar: each pulsar's blocks

    chi2_a = r^T C_a^-1 r,  ld_a = ln|C_a|,  u_a = G_a^T C_a^-1 r,
    V_a = G_a^T C_a^-1 G_a,  b_a = Mn^T C_a^-1 r,  A_a = Mn^T C_a^-1 Mn,
    W_a = Mn^T C_a^-1 G_a

are one Gram X^T C_a^-1 X over X = [Mn, G_a, r] (the design divided by its
norms, the common block raw). Then a small dense coupling: the (N m)-square
Sigma, its Cholesky factor, and the jointly marginalized (N p)-square timing
block A = blockdiag(A_a) - Wb Sigma^-1 Wb^T + RIDGE I, b = stack(b_a) -
Wb Sigma^-1 u (Wb = blockdiag(W_a)).

On the card one evaluation of E points is:

- each pulsar's weights w(eta) and prior variances phi(eta), stacked
  (E, N, rows) over the bucket-padded rows (pad rows: w = 0), in torch;
- `_PTABlocks`, a ``torch.autograd.Function``: its forward is kernel K3's
  stacked mode (``woodbury.ecorr_normal_eq_stacked``) over the E x N
  (point, pulsar) sets, its backward kernel K10 (`pta_grad`,
  ``csrc/pta_grad.cu``) under the coupling's dense cotangent of each Gram;
- the coupling in ``torch.linalg`` (Cholesky factors) and plain torch, which
  autograd differentiates; the common process's phi_gw(eta) enters there.

The member NoiseLikelihoods fix each pulsar's linearization point and
design (kernel K1, once) and their noise bases (K8, once); the common
block G_a is K8's Fourier pass on the array's span, once. `optimize`,
`loglike_many` and `grad` come from ``noise_like.MarginalizedPosterior``. The
JAX package's mesh layout (ROADMAP A15), its Laplace scales and chains
(B15) and its static memory estimate (A17) are not ported: asking for them
raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pint_tpu_torch.fitting import grad_plan
from pint_tpu_torch.fitting.batch import bucket_rows, stack_trees
from pint_tpu_torch.fitting.noise_like import (_LN2PI, RIDGE, MarginalizedPosterior, _inverse_t,
                                               _prior_scale, default_noise_priors)
from pint_tpu_torch.fitting.woodbury import (StackedEpochs, ecorr_normal_eq_stacked,
                                             stacked_epochs)
from pint_tpu_torch.models.base import leaf_to_f64
from pint_tpu_torch.models.noise import orf_matrix, pulsar_position


def _block_diag(B: torch.Tensor) -> torch.Tensor:
    """(..., n, p, q) stacked blocks -> (..., n p, n q) block-diagonal."""
    *lead, n, p, q = B.shape
    eye = torch.eye(n, dtype=B.dtype, device=B.device)
    return (B[..., :, :, None, :] * eye[:, None, :, None]).reshape(*lead, n * p, n * q)


def _kron_diag(A: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """kron(A (n, n), diag(d)) for d (..., m): (..., n m, n m)."""
    n, m = A.shape[0], d.shape[-1]
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    K = (A[:, None, :, None] * eye[None, :, None, :]) * d[..., None, :, None, None]
    return K.reshape(*d.shape[:-1], n * m, n * m)


# --- the per-pulsar blocks: K3's stacked mode forward, K10 backward -------------------


class PTACore(NamedTuple):
    """The fixed operands of an array: r (N, n), the raw design M (N, p, n),
    the common block G (N, m, n), each pulsar's dense basis Fd (N, kd, n) or
    None, its epochs (StackedEpochs or None) and each row's epoch eidx (N, n)
    int32 (-1 for none), over n bucket rows (pad rows zero)."""

    r: torch.Tensor
    M: torch.Tensor
    G: torch.Tensor
    Fd: torch.Tensor | None
    epochs: StackedEpochs | None
    eidx: torch.Tensor


class PTAState(NamedTuple):
    """What the backward reads from one forward: the inputs (w (E, N, n),
    phi_e (E, N, ke), phi_d (E, N, kd)) and K3's saved pieces (the design
    norms (N, p), De, the epoch sums, L, Wz)."""

    w: torch.Tensor
    phi_e: torch.Tensor
    phi_d: torch.Tensor
    norm: torch.Tensor
    De: torch.Tensor
    esum: torch.Tensor
    L: torch.Tensor
    Wz: torch.Tensor


def pta_blocks(core: PTACore, w: torch.Tensor, phi_e: torch.Tensor, phi_d: torch.Tensor):
    """(gram (E, N, q, q), ln|C_a| (E, N), PTAState): each set's Gram X^T
    C_a^-1 X over X = [Mn, G, r] (q = p + m + 1) through K3's stacked mode
    (its twin on the CPU)."""
    ke, kd = phi_e.shape[-1], phi_d.shape[-1]
    ne = ecorr_normal_eq_stacked(core.r, core.M, core.G, w, core.Fd, core.epochs,
                                 phi_e if ke else None, phi_d if kd else None)
    P = ne.G.shape[-1]
    gram = torch.empty(ne.G.shape[:2] + (P + 1, P + 1), dtype=w.dtype, device=w.device)
    gram[..., :P, :P] = ne.G
    gram[..., :P, P] = -ne.c
    gram[..., P, :P] = -ne.c
    gram[..., P, P] = ne.chi2
    st = PTAState(w=w, phi_e=phi_e, phi_d=phi_d, norm=ne.norm, De=ne.De, esum=ne.esum,
                  L=ne.L, Wz=ne.Wz)
    return gram, ne.logdet, st


def _sets_of(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _grad_prep(st: PTAState):
    """The backward's small factors, shared by K10 and its twin, per set: L^-T
    (S, kd, kd) and the dense amplitudes Ahat_d = L^-T Wz (S, kd, q)."""
    L, Wz = _sets_of(st.L), _sets_of(st.Wz)
    if not L.shape[-1]:
        return L, Wz
    return _inverse_t(L), torch.linalg.solve_triangular(L.mT, Wz, upper=True)


def pta_grad_plain(core: PTACore, st: PTAState, gbar: torch.Tensor, ldbar: torch.Tensor):
    """Twin of K10: (d/dw (E, N, n), d/dphi (E, N, ke + kd), epochs first) of
    sum(gbar * gram) + sum(ldbar * ln|C_a|), the kernel's formulas in torch."""
    E, N, n = st.w.shape
    S = E * N
    ke, kd = st.phi_e.shape[-1], st.phi_d.shape[-1]
    pulsar = torch.arange(S, device=st.w.device) % N
    Mn = core.M / st.norm[..., None]
    X = torch.cat([Mn, core.G, core.r[:, None]], dim=1).mT[pulsar]  # (S, n, q)
    q = X.shape[-1]
    w, G, ld = _sets_of(st.w), _sets_of(gbar), _sets_of(ldbar)
    Lt, Ad = _grad_prep(st)
    zero = w.new_zeros
    T, fsf = X, zero((S, n))
    amps, sinvs = [], []
    if ke:
        es = _sets_of(st.esum)
        Y, B = es[..., :q], es[..., q:]
        inv = 1.0 / _sets_of(st.De)
        Ae = (Y - B @ Ad) * inv[..., None]
        Bn = B * inv[..., None]
        amps.append(Ae)
        sinvs.append(inv + torch.sum((Bn @ Lt) ** 2, dim=-1))
        eidx = core.eidx.to(torch.int64)[pulsar]
        idx = torch.where(eidx < 0, ke, eidx)
        sets = torch.arange(S, device=w.device)[:, None]

        def rows_of(x):
            return torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)[sets, idx]

        T = T - rows_of(Ae)
        fsf = rows_of(inv[..., None])[..., 0]
    if kd:
        Fd = core.Fd.mT[pulsar]  # (S, n, kd)
        amps.append(Ad)
        sinvs.append(torch.sum(Lt**2, dim=-1))
        T = T - Fd @ Ad
        h = Fd - rows_of(Bn) if ke else Fd
        fsf = fsf + torch.sum((h @ Lt) ** 2, dim=-1)
    dw = torch.sum((T @ G) * T, dim=-1) - ld[:, None] * (1.0 / w - fsf)
    dw = torch.where(w == 0, 0.0, dw)
    dphi = zero((S, 0))
    if ke or kd:
        Ah = torch.cat(amps, dim=1)
        quad = torch.sum((Ah @ G) * Ah, dim=-1)
        iphi = 1.0 / torch.cat([_sets_of(st.phi_e), _sets_of(st.phi_d)], dim=-1)
        dphi = -iphi * iphi * quad + ld[:, None] * (iphi - iphi * iphi * torch.cat(sinvs, dim=-1))
    return dw.reshape(E, N, n), dphi.reshape(E, N, ke + kd)


def pta_grad(core: PTACore, st: PTAState, gbar: torch.Tensor, ldbar: torch.Tensor):
    """K10: d/dw and d/dphi of the E x N sets under the cotangents gbar (E, N,
    q, q) of the Grams and ldbar (E, N) of ln|C_a|. A CUDA tensor launches the
    kernel (and raises if it cannot); a CPU tensor takes `pta_grad_plain`.
    `pta_grad.launches` counts calls (3 passes each)."""
    if st.w.device.type == "cpu":
        return pta_grad_plain(core, st, gbar, ldbar)
    out = _launch_k10(core, st, gbar, ldbar)
    pta_grad.launches += 1
    return out


pta_grad.launches = 0

def _launch_k10(core: PTACore, st: PTAState, gbar, ldbar):
    """K10's three passes (``csrc/pta_grad.cu``) at the plan its library
    gives (`grad_plan.pta_grad_plan`), which raises, naming the limit, on a
    shape the kernel does not take. The
    kernel forms L^-T and Ahat_d itself from L and Wz (the twin's
    `_grad_prep`)."""
    from pint_tpu_torch.device import require_f64
    from pint_tpu_torch.ops import build

    E, N, n = st.w.shape
    S = E * N
    p, m = core.M.shape[1], core.G.shape[1]
    q = p + m + 1
    ke, kd = st.phi_e.shape[-1], st.phi_d.shape[-1]
    if gbar.shape != (E, N, q, q) or ldbar.shape != (E, N):
        raise ValueError(f"pta_grad needs gbar (E, N, q, q) = {(E, N, q, q)} and ldbar (E, N); "
                         f"got {tuple(gbar.shape)}, {tuple(ldbar.shape)}")
    ins = {"M": core.M, "norm": st.norm, "G": core.G, "r": core.r, "w": st.w, "De": st.De,
           "esum": st.esum, "phi_e": st.phi_e, "phi_d": st.phi_d, "gbar": gbar,
           "ldbar": ldbar, "L": st.L, "Wz": st.Wz, **({"Fd": core.Fd} if kd else {})}
    require_f64("pta_grad", tensor=ins)
    dev = st.w.device
    if any(t.device != dev for t in ins.values()) or core.eidx.device != dev:
        raise ValueError("pta_grad needs its tensors on one device")
    lib = build.library("pta_grad", _declare_k10)
    plan = grad_plan.pta_grad_plan(lib, n, N, q, ke, kd, E)
    ins = {k: v.contiguous() for k, v in ins.items()}
    ptr = {k: v.data_ptr() for k, v in ins.items()}
    eidx = core.eidx.contiguous()
    scratch = torch.empty(plan["scratch"], dtype=torch.float64, device=dev)
    dw = torch.empty((E, N, n), dtype=torch.float64, device=dev)
    dphi = torch.empty((E, N, ke + kd), dtype=torch.float64, device=dev)
    build.check(lib, lib.pta_grad(
        ptr["M"], ptr["norm"], ptr["G"], ptr["r"], ptr.get("Fd", ptr["w"]), ptr["w"],
        eidx.data_ptr(), ptr["De"], ptr["esum"], ptr["phi_e"], ptr["phi_d"], ptr["gbar"],
        ptr["ldbar"], ptr["L"], ptr["Wz"], S, N, p, m, n, ke, kd, scratch.data_ptr(),
        dw.data_ptr(), dphi.data_ptr(), build.stream_of(st.w)))
    return dw, dphi


def _declare_k10(lib) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.pta_grad.argtypes = [p] * 15 + [i] * 7 + [p] * 4
    lib.pta_grad.restype = ctypes.c_int
    grad_plan.declare(lib)


class _PTABlocks(torch.autograd.Function):
    """(gram (E, N, q, q), ln|C_a| (E, N)) of the E x N (point, pulsar)
    sets: forward K3's stacked mode, backward K10 (their twins on the CPU)."""

    @staticmethod
    def forward(ctx, w, phi_e, phi_d, core):
        gram, ld, st = pta_blocks(core, w, phi_e, phi_d)
        ctx.core = core
        ctx.save_for_backward(*st)
        return gram, ld

    @staticmethod
    def backward(ctx, gbar, ldbar):
        st = PTAState(*ctx.saved_tensors)
        dw, dphi = pta_grad(ctx.core, st, gbar.contiguous(), ldbar.contiguous())
        ke = st.phi_e.shape[-1]
        need = ctx.needs_input_grad
        return (dw if need[0] else None, dphi[..., :ke] if need[1] else None,
                dphi[..., ke:] if need[2] else None, None)


# --- the joint posterior ---------------------------------------------------------------


def _skeleton(d: dict) -> tuple:
    """The shapes a member's padded layout gives the stacked operands."""
    return tuple(sorted((k, None if v is None else tuple(v.shape) if torch.is_tensor(v) else v)
                        for k, v in d.items() if k != "cols")) + (tuple(sorted(d["cols"])),)


class PTALikelihood(MarginalizedPosterior):
    """The joint N-pulsar posterior marginalized over a Hellings-Downs
    correlated background (pint_tpu's PTALikelihood on one device).

    ``likelihoods`` are per-pulsar NoiseLikelihoods (built from prepared
    TOAs; each fixes its pulsar's linearization point) whose models share a
    skeleton and carry the common PLGWBNoise component. The joint vector is

        eta = [psr_0 noise hyper ..., psr_{N-1} noise hyper ...,
               log10_A_gw, gamma_gw]

    with per-pulsar coordinates named ``"<PSR>:<name>"``. The common process
    is left out of every pulsar's own basis (its auto term is the ORF's
    diagonal): pulsars couple only through ORF (x) diag(phi_gw).

    mesh : pint_tpu's batch-axis layout (ROADMAP A15): raises
    """

    def __init__(self, likelihoods: list, mesh=None, priors: dict | None = None,
                 marginalize_timing: bool = True):
        if not likelihoods:
            raise ValueError("empty pulsar array")
        if mesh is not None:
            raise NotImplementedError("PTALikelihood over a device mesh is not ported yet "
                                      "(ROADMAP A15)")
        self._build(list(likelihoods), priors or {}, bool(marginalize_timing))

    def _build(self, members: list, priors: dict, marginalize: bool) -> None:
        nl0 = members[0]
        self.members = members
        self.model = nl0.model
        self.marginalize_timing = marginalize
        self.device = nl0.device
        n = len(members)
        gw_comp = self.model.common_noise_component
        if gw_comp is None:
            raise ValueError(
                "PTA members carry no common noise process (PLGWBNoise"
                " / TNGWAMP) — nothing couples the pulsars")
        self.gw_comp = gw_comp
        self.gw_hyper = tuple(gw_comp.hyper_param_names(self.model.params))
        if len(self.gw_hyper) != 2:
            raise ValueError(
                f"common process exposes {self.gw_hyper}; expected the "
                "(log10 amplitude, spectral index) pair")
        self.psr_hyper = tuple(h for h in nl0.hyper if h not in self.gw_hyper)
        for nl in members:
            if tuple(h for h in nl.hyper if h not in self.gw_hyper) != self.psr_hyper:
                raise ValueError(f"array hyper mismatch: {nl.hyper} vs {nl0.hyper}")
            if nl.p_lin != nl0.p_lin:
                raise ValueError("array timing-design width mismatch")
            if nl.model.common_noise_component is None or \
                    nl.model.common_noise_component.nf != gw_comp.nf:
                raise ValueError("array common-process mode-count mismatch")
        self.p_lin = nl0.p_lin

        # the sky -> the HD matrix (host, once), and the array-wide span of
        # the common frequency grid, over real rows (pint_tpu's TDB MJD
        # seconds): per-pulsar spans would de-cohere the common modes
        self.positions = np.stack([pulsar_position(nl.model) for nl in members])
        self.orf = orf_matrix(self.positions)
        t_lo, t_hi = np.inf, -np.inf
        for nl in members:
            if not hasattr(nl.toas, "tdb"):
                raise ValueError("PTALikelihood needs members built from prepared TOAs "
                                 "(their TDB sets the array's span)")
            t = nl.toas.tdb.mjd_float() * 86400.0
            real = np.asarray(nl.toas.error_us) > 0
            t = t[real] if real.any() else t
            t_lo, t_hi = min(t_lo, t.min()), max(t_hi, t.max())
        self.gw_tspan = float(t_hi - t_lo)

        # the stacked bucket-padded member operands
        rows = max(bucket_rows(nl._n_data) for nl in members)
        self.rows = rows
        datas = [nl._layout_padded(rows) for nl in members]
        sig0 = _skeleton(datas[0])
        for d in datas[1:]:
            if _skeleton(d) != sig0:
                raise ValueError(
                    "array operand-signature mismatch: members must "
                    "share a model skeleton (component graph, Fourier "
                    "mode counts, ECORR epoch counts)")
        self._build_operands(datas)

        # joint coordinates, priors, scales, start point
        psrs = [nl.model.psr_name or f"PSR{a}" for a, nl in enumerate(members)]
        if len(set(psrs)) != len(psrs):  # de-collide duplicates
            psrs = [f"{p}#{a}" for a, p in enumerate(psrs)]
        names, x0, scales = [], [], []
        self.priors = {}
        for nl, psr in zip(members, psrs):
            for h in self.psr_hyper:
                j = nl.hyper.index(h)
                names.append(f"{psr}:{h}")
                x0.append(nl.x0[j])
                scales.append(nl.scales[j])
                self.priors[f"{psr}:{h}"] = priors.get(h, nl.priors[h])
        gw_defaults = default_noise_priors(self.model, self.gw_hyper)
        for h in self.gw_hyper:
            names.append(h)
            x0.append(float(leaf_to_f64(self.model.params[h])))
            scales.append(_prior_scale(gw_defaults[h]))
            self.priors[h] = priors.get(h, gw_defaults[h])
        self.hyper = tuple(names)
        self.x0 = np.asarray(x0)
        self.scales = np.asarray(scales)

    def _build_operands(self, datas: list) -> None:
        """Stack the members' padded layouts, form each common block G_a on
        the array's span (K8), and stack what the weights and prior
        variances read per pulsar."""
        members, dev, rows = self.members, self.device, self.rows
        nl0 = members[0]
        st = stack_trees([{k: v for k, v in d.items() if k != "ke"} for d in datas])
        ke = datas[0]["ke"]
        self._tspan = torch.tensor(self.gw_tspan, dtype=torch.float64, device=dev)
        Gs = []
        for nl in members:
            G = nl.model.gwb_common_basis(nl._params0, nl.tensor, self._tspan)[0]
            Gs.append(torch.nn.functional.pad(G.T, (0, rows - G.shape[0])))
        self._core = PTACore(r=st["r0"], M=st["M"], G=torch.stack(Gs).contiguous(), Fd=st["Fd"],
                             epochs=stacked_epochs(st["eidx"], ke) if ke else None,
                             eidx=st["eidx"].contiguous())
        self._mask = st["mask"]
        self._mnorm = st["mnorm"]
        self._cols = st["cols"]
        self._n_eff = float(torch.sum(self._mask))
        self._ldM = float(torch.sum(2.0 * torch.sum(torch.log(self._mnorm), dim=1)))
        # the pulsars' own noise parameters (N, 1), eta's entries replace
        # the hyperparameters per evaluation, and the columns their prior
        # variances read, stacked (N, 1, k)
        parts = self.model._noise_parts(include_common=False)
        self._own_noise = parts
        names = []
        for c in parts:
            for nm in list(c.specs) + [mp.name for mp in c.mask_params]:
                if nm in self.model.params and nm not in names:
                    names.append(nm)
        self._leaves = {nm: torch.stack([leaf_to_f64(nl._params0[nm]).reshape(1)
                                         for nl in members]) for nm in names}
        self._prior_cols = {k: torch.stack([nl.tensor[k] for nl in members])
                            for k in ("ecorr_widx", "noise_tspan") if k in nl0.tensor}
        self._gw_cols = {"noise_tspan": self._tspan.reshape(1, 1)}
        orf = torch.as_tensor(self.orf, device=dev)
        self._orf_ops = self._coupling_operand(orf)
        self._eye_ops = self._coupling_operand(torch.eye(len(members), dtype=torch.float64,
                                                         device=dev))

    @staticmethod
    def _coupling_operand(orf: torch.Tensor):
        """(ORF^-1, sum ln diag chol(ORF)) of an ORF operand: the HD matrix for
        the GWB model, the identity for the common-uncorrelated one."""
        cf = torch.linalg.cholesky(orf)
        eye = torch.eye(orf.shape[0], dtype=orf.dtype, device=orf.device)
        return torch.cholesky_solve(eye, cf), torch.sum(torch.log(torch.diagonal(cf)))

    # --- evaluation -------------------------------------------------------------------

    def _params(self, eta: torch.Tensor) -> dict:
        """The noise parameters at E points eta (E, H): each pulsar's
        hyperparameters (E, N, 1), its other parameters (N, 1), the common
        process's (E, 1)."""
        E, N, h = eta.shape[0], len(self.members), len(self.psr_hyper)
        eta_psr = eta[:, :N * h].reshape(E, N, h)
        params = dict(self._leaves)
        for j, nm in enumerate(self.psr_hyper):
            params[nm] = eta_psr[:, :, j:j + 1]
        for j, nm in enumerate(self.gw_hyper):
            params[nm] = eta[:, N * h + j:N * h + j + 1]
        return params

    def _sigma(self, params: dict) -> torch.Tensor:
        """The scaled TOA uncertainties (..., N, rows) of every pulsar."""
        sigma = self._cols["error_s"]
        for c in self._own_noise:
            sigma = c.scale_sigma(params, self._cols, sigma)
        return sigma

    def _sets(self, eta: torch.Tensor):
        """(w (E, N, rows), phi_e (E, N, ke), phi_d (E, N, kd), phi_gw (E, m))
        at eta (E, H): pad rows get w = 0."""
        E, N = eta.shape[0], len(self.members)
        params = self._params(eta)
        sigma = self._sigma(params)
        w = torch.where(self._mask > 0, 1.0 / sigma**2, 0.0).expand(E, N, self.rows)
        phis = self.model.noise_prior_weights(params, self._prior_cols, include_common=False)
        ephi, dphi = (eta.new_zeros((E, N, 0)) if x is None else x.expand(E, N, x.shape[-1])
                      for x in phis)
        phi_gw = self.gw_comp.prior_weights(params, self._gw_cols)
        return w.contiguous(), ephi.contiguous(), dphi.contiguous(), phi_gw

    def _blocks(self, eta: torch.Tensor):
        w, pe, pd, phi = self._sets(eta)
        gram, ld = _PTABlocks.apply(w, pe, pd, self._core)
        return gram, ld, phi

    def _couple(self, gram: torch.Tensor, ld: torch.Tensor, phi: torch.Tensor, ops):
        """The joint ln-likelihood (E,) from the blocks and an ORF operand
        (`_coupling_operand`): the Sigma solve and the jointly marginalized
        timing block, in pint_tpu's order. A point whose Sigma or A does not
        factor gets NaN."""
        E, N = gram.shape[:2]
        p, m = self.p_lin, phi.shape[-1]
        P = p + m
        chi2 = torch.sum(gram[..., P, P], dim=1)
        ldt = torch.sum(ld, dim=1)
        orf_inv, ld_orf = ops
        ld_phi = m * 2.0 * ld_orf + N * torch.sum(torch.log(phi), dim=-1)
        Sigma = _kron_diag(orf_inv, 1.0 / phi) + _block_diag(gram[..., p:P, p:P])
        S_cf, info = torch.linalg.cholesky_ex(Sigma)
        ok = info == 0
        u = gram[..., p:P, P].reshape(E, N * m)
        su = torch.cholesky_solve(u[..., None], S_cf)[..., 0]
        chi2 = chi2 - torch.sum(u * su, dim=-1)
        ldt = ldt + ld_phi + 2.0 * torch.sum(torch.log(torch.diagonal(S_cf, dim1=1, dim2=2)),
                                             dim=-1)
        n_prof = 0.0
        if p:
            Wb = _block_diag(gram[..., :p, p:P])
            eye = torch.eye(N * p, dtype=gram.dtype, device=gram.device)
            A = _block_diag(gram[..., :p, :p]) - Wb @ torch.cholesky_solve(Wb.mT, S_cf) \
                + RIDGE * eye
            b = gram[..., :p, P].reshape(E, N * p) - (Wb @ su[..., None])[..., 0]
            A_cf, info = torch.linalg.cholesky_ex(A)
            ok = ok & (info == 0)
            chi2 = chi2 - torch.sum(b * torch.cholesky_solve(b[..., None], A_cf)[..., 0], dim=-1)
            if self.marginalize_timing:
                ldt = ldt + 2.0 * torch.sum(torch.log(torch.diagonal(A_cf, dim1=1, dim2=2)),
                                            dim=-1)
                ldt = ldt + self._ldM
                n_prof = float(N * p)
        ll = -0.5 * (chi2 + ldt + (self._n_eff - n_prof) * _LN2PI)
        return torch.where(ok, ll, float("nan"))

    def _lnlike(self, eta: torch.Tensor) -> torch.Tensor:
        """The joint ln-likelihood (E,) at eta (E, H), differentiable."""
        gram, ld, phi = self._blocks(eta)
        return self._couple(gram, ld, phi, self._orf_ops)

    # --- detection statistics -----------------------------------------------------

    def loglike_curn(self, eta) -> float:
        """The common-uncorrelated alternative's joint ln-likelihood: the same
        blocks coupled through the identity instead of the ORF."""
        with torch.no_grad():
            gram, ld, phi = self._blocks(self._eta(eta)[None])
            return float(self._couple(gram, ld, phi, self._eye_ops)[0])

    def detection_statistic(self, eta) -> dict:
        """Every detection quantity at one eta from one set of blocks:
        {"ll_hd", "ll_curn", "dll" (their margin), "rho" (P,) the per-pair
        correlation statistics, "os" (the optimal-statistic amplitude ratio
        sum rho Gamma / sum Gamma^2), "angle_deg" (P,), "hd" (P,)}, pairs in
        `numpy.triu_indices(N, 1)` order."""
        n = len(self.members)
        ia, ib = np.triu_indices(n, 1)
        with torch.no_grad():
            gram, ld, phi = self._blocks(self._eta(eta)[None])
            ll_hd = float(self._couple(gram, ld, phi, self._orf_ops)[0])
            ll_curn = float(self._couple(gram, ld, phi, self._eye_ops)[0])
            p, m = self.p_lin, phi.shape[-1]
            u = gram[0, :, p:p + m, p + m]
            s = u * phi[0][None, :]
            auto = torch.sum(s * u, dim=-1)
            ta, tb = torch.as_tensor(ia, device=u.device), torch.as_tensor(ib, device=u.device)
            denom = torch.sqrt(torch.clamp(auto[ta] * auto[tb], min=1e-300))
            rho = torch.sum(s[ta] * u[tb], dim=-1) / denom
            gam = torch.as_tensor(self.orf[ia, ib], device=u.device)
            os_ = torch.sum(rho * gam) / torch.clamp(torch.sum(gam * gam), min=1e-300)
        cos = np.clip(self.positions @ self.positions.T, -1.0, 1.0)
        return {"ll_hd": ll_hd, "ll_curn": ll_curn, "dll": ll_hd - ll_curn,
                "rho": rho.cpu().numpy(), "os": float(os_),
                "angle_deg": np.degrees(np.arccos(cos[ia, ib])), "hd": self.orf[ia, ib]}

    def pair_correlations(self, eta) -> dict:
        """Per-pair correlation statistic against the HD curve, from
        `detection_statistic`: {"angle_deg", "rho", "hd"} (P,) each."""
        det = self.detection_statistic(eta)
        return {"angle_deg": det["angle_deg"], "rho": det["rho"], "hd": det["hd"]}

    def gwb_coefficient_blocks(self, eta) -> dict:
        """Each pulsar's common-process inner products at one eta: {"u" (N, m)
        G^T C^-1 r, "V" (N, m, m) G^T C^-1 G, "phi" (m,), "orf" (N, N)}."""
        with torch.no_grad():
            gram, _, phi = self._blocks(self._eta(eta)[None])
        p, m = self.p_lin, phi.shape[-1]
        return {"u": gram[0, :, p:p + m, p + m].cpu().numpy(),
                "V": gram[0, :, p:p + m, p:p + m].cpu().numpy(),
                "phi": phi[0].cpu().numpy(), "orf": np.array(self.orf)}

    def dense_joint_program(self):
        """The O((N T)^3) dense joint baseline: ``prog(eta) -> float``
        materializes the (N rows)-square HD-coupled covariance over the
        padded rows (pad rows: unit diagonal, no coupling), factors it with
        ``torch.linalg.cholesky`` and profiles every timing column jointly.
        It shares only the operand layout with the fused likelihood."""
        core, n, rows = self._core, len(self.members), self.rows
        p, marginalize = self.p_lin, self.marginalize_timing
        mask = self._mask

        def prog(eta) -> float:
            with torch.no_grad():
                e = self._eta(eta)[None]
                params = self._params(e)
                sigma = self._sigma(params)[0].expand(n, rows)
                _, pe, pd, phi = self._sets(e)
                Cs = []
                for a in range(n):
                    C = torch.diag(torch.where(mask[a] > 0, sigma[a] ** 2, 1.0))
                    cols, ph = [], []
                    if pe.shape[-1]:
                        ar = torch.arange(pe.shape[-1], device=mask.device)
                        cols.append((core.eidx[a].to(torch.int64)[:, None] == ar).double())
                        ph.append(pe[0, a])
                    if pd.shape[-1]:
                        cols.append(core.Fd[a].T)
                        ph.append(pd[0, a])
                    if cols:
                        F = torch.cat(cols, dim=1) * mask[a][:, None]
                        C = C + (F * torch.cat(ph)) @ F.T
                    Cs.append(C)
                Gb = _block_diag(core.G.mT)
                orf = torch.as_tensor(self.orf, device=mask.device)
                C = _block_diag(torch.stack(Cs)) + Gb @ _kron_diag(orf, phi[0]) @ Gb.T
                r = core.r.reshape(-1)
                cf = torch.linalg.cholesky(C)
                Cinv_r = torch.cholesky_solve(r[:, None], cf)[:, 0]
                chi2 = r @ Cinv_r
                ld = 2.0 * torch.sum(torch.log(torch.diagonal(cf)))
                n_prof = 0.0
                if p:
                    M = _block_diag((core.M / self._mnorm[..., None] * mask[:, None, :]).mT)
                    A = M.T @ torch.cholesky_solve(M, cf) + RIDGE * torch.eye(
                        n * p, dtype=M.dtype, device=M.device)
                    b = M.T @ Cinv_r
                    cfA = torch.linalg.cholesky(A)
                    chi2 = chi2 - b @ torch.cholesky_solve(b[:, None], cfA)[:, 0]
                    if marginalize:
                        ld = ld + 2.0 * torch.sum(torch.log(torch.diagonal(cfA))) + self._ldM
                        n_prof = float(n * p)
                return float(-0.5 * (chi2 + ld + (self._n_eff - n_prof) * _LN2PI))

        return prog

    def static_peak_bytes_per_chip(self):
        raise NotImplementedError("the static memory estimate of the joint program is not "
                                  "ported yet (ROADMAP A17)")

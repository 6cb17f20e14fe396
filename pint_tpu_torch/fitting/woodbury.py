"""Structured correlated-noise algebra: Woodbury solves without a dense ECORR
matrix (counterpart of ``pint_tpu/fitting/woodbury.py``), and kernel K3.

The covariance is C = diag(1/w) + F phi F^T with F = [U | Fd]: U the ECORR
epoch-membership matrix (each TOA in at most one epoch) and Fd dense
Fourier bases. U stays implicit as an epoch index, so every product with it
is a gather or a segment sum, and the Woodbury inner matrix

    S = diag(1/phi) + F^T diag(w) F = [[De, B], [B^T, Rd]],  De diagonal

is solved by block elimination on the small dense Schur complement
Rd - B^T De^-1 B. The functions below are the plain-torch algebra, in the
JAX package's order of operations; they are the twin of kernel K3 and run
on any device, the card included (`s_factor`, `s_solve`, `basis_rmatvec`,
`basis_matvec`, `woodbury_chi2`, `logdet_C` launch no kernel). The fit and
grid paths reach the card's Woodbury algebra only through
`ecorr_normal_eq`, which launches K3 on a CUDA tensor.

Segment sums use no atomics (ROADMAP C3): `epoch_index` turns the epoch
index once into a CSR (offsets, row ids) and a padded (ke, L) table of row
ids, and `seg_sum` adds each epoch's rows in ascending order, as
``jax.ops.segment_sum`` does on the CPU and as K3's epoch pass does on the
card. So the epoch sums add in the same order in the twin and the kernel
(bitwise equal where their inputs are), and run after run.

K3 (`ecorr_normal_eq`, csrc/ecorr_normal_eq.cu) is the block-Schur form of
``s_factor``/``cinv_apply``/``woodbury_chi2`` over B parameter sets at
once, from the raw design M: the step's optional weighted-mean removal and
its column norms come first (`_step_inputs`, Mn = M / norm), then, with
V_i = [Mn_i, r_i, Fd_i] and the epoch sums v_e = sum_{i in e} w_i V_i =
[y_e, s_e, B_e],

    De_e = 1/phi_e + sum_{i in e} w_i
    S1   = sum_i w_i V_i V_i^T - sum_e v_e v_e^T / De_e
    Rd   = diag(1/phi_d) + S1[Fd, Fd] = L L^T,  Wz = L^-1 S1[Fd, (Mn, r)]
    G    = S1[Mn, Mn] - Wz_M^T Wz_M + ridge I
    c    = -(S1[Mn, r] - Wz_M^T Wz_r),   chi2 = S1[r, r] - Wz_r^T Wz_r
    ahat = [(s_e - B_e ahat_d) / De_e ; ahat_d = L^-T Wz_r]

(without a dense basis the Wz terms vanish). It replaces the Woodbury part
of the TPU programs ``gls_step``, ``gls_chi2`` and the correlated branch of
``grid``.

K3's per-set-weight mode (`ecorr_normal_eq_sets`) turns the sets around for
the marginalized noise likelihood (``fitting/noise_like.py``): one (r, M)
and E sets of weights and prior variances, the same passes per weight set,
plus each set's log|C| and the pieces the likelihood's backward (kernel K9)
reads: De, the epoch sums [y_e, s_e, B_e], L and Wz.

K3's stacked mode (`ecorr_normal_eq_stacked`) runs the per-set passes over
the E x N (point, pulsar) sets of the joint PTA likelihood
(``fitting/pta_like.py``): set (e, a) reads pulsar a's r, M, Fd and epochs
by stride, with point e's weights and prior variances, and its Gram takes
the common process's block G (m columns, un-normalized, no ridge) after the
design, X = [Mn, G]. Pad rows (w = 0) drop out of every sum and of log|C|.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch


class EpochIndex(NamedTuple):
    """The ECORR epoch structure of the data rows, built once per tensor.

    eidx    : (N,) int64 epoch of each row, -1 for none
    offsets : (ke + 1,) int32 CSR offsets into `rows`
    rows    : (nnz,) int32 row ids, epoch by epoch, ascending within one
    padded  : (ke, L) int64 the same row ids padded with N (a zero row),
              L the largest epoch
    """

    eidx: torch.Tensor
    offsets: torch.Tensor
    rows: torch.Tensor
    padded: torch.Tensor

    @property
    def ke(self) -> int:
        return self.offsets.shape[0] - 1


def epoch_index(eidx: torch.Tensor, ke: int) -> EpochIndex:
    """CSR and padded forms of an epoch index (host work, once per tensor)."""
    e = eidx.detach().cpu().numpy().astype(np.int64)
    n = e.shape[0]
    if e.size and (e.max(initial=-1) >= ke or e.min(initial=0) < -1):
        raise ValueError(f"epoch index out of range for {ke} epochs")
    member = np.flatnonzero(e >= 0)
    order = member[np.argsort(e[member], kind="stable")]
    counts = np.bincount(e[member], minlength=ke)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    L = int(counts.max(initial=0))
    padded = np.full((ke, max(L, 1)), n, np.int64)
    pos = np.arange(order.size) - offsets[e[order]]
    padded[e[order], pos] = order
    dev = eidx.device
    return EpochIndex(
        eidx=torch.as_tensor(e, device=dev),
        offsets=torch.as_tensor(offsets, dtype=torch.int32, device=dev),
        rows=torch.as_tensor(order, dtype=torch.int32, device=dev),
        padded=torch.as_tensor(padded, device=dev))


class NoiseBasis(NamedTuple):
    """Structured correlated-noise basis (None = absent part).

    dense     : (N, kd) dense basis columns (Fourier modes)
    dense_phi : (kd,) prior variances of the dense columns
    epochs    : EpochIndex of the ECORR epochs
    ephi      : (ke,) prior variances (ECORR_i^2) per epoch
    row_scale : optional (N,) per-row scale: the basis is diag(row_scale) [U | Fd]
    """

    dense: torch.Tensor | None
    dense_phi: torch.Tensor | None
    epochs: EpochIndex | None
    ephi: torch.Tensor | None
    row_scale: torch.Tensor | None = None

    @property
    def ke(self) -> int:
        return 0 if self.ephi is None else self.ephi.shape[0]

    @property
    def kd(self) -> int:
        return 0 if self.dense is None else self.dense.shape[1]


class SFactor(NamedTuple):
    """Factorized Woodbury inner matrix S = diag(1/phi) + F^T diag(w) F."""

    De: torch.Tensor | None  # (ke,) diagonal ECORR block
    B: torch.Tensor | None  # (ke, kd) cross block
    schur_cf: torch.Tensor | None  # lower Cholesky factor of Rd - B^T De^-1 B


def seg_sum(v: torch.Tensor, epochs: EpochIndex) -> torch.Tensor:
    """Sum of v's rows per epoch, U^T v: (N,) or (N, p) -> (ke[, p]). Rows
    add in ascending order within each epoch, with no atomics."""
    vp = torch.cat([v, torch.zeros_like(v[:1])])
    g = vp[epochs.padded]  # (ke, L[, p])
    acc = torch.zeros_like(g[:, 0])
    for j in range(g.shape[1]):
        acc = acc + g[:, j]
    return acc


def seg_gather(a: torch.Tensor, epochs: EpochIndex) -> torch.Tensor:
    """U a: each row's epoch coefficient (0 for rows in no epoch)."""
    ap = torch.cat([a, torch.zeros_like(a[:1])])
    return ap[torch.where(epochs.eidx < 0, a.shape[0], epochs.eidx)]


def _col(d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return d[:, None] if like.dim() == 2 else d


def s_factor(basis: NoiseBasis, w: torch.Tensor) -> SFactor:
    """Factorize S for weights w (= 1/sigma^2)."""
    we = w if basis.row_scale is None else w * basis.row_scale**2
    De = B = schur_cf = None
    if basis.ephi is not None:
        De = 1.0 / basis.ephi + seg_sum(we, basis.epochs)
    if basis.dense is not None:
        Fd = basis.dense
        Rd = torch.diag(1.0 / basis.dense_phi) + Fd.T @ (we[:, None] * Fd)
        if De is not None:
            B = seg_sum(we[:, None] * Fd, basis.epochs)
            Rd = Rd - B.T @ (B / De[:, None])
        schur_cf = torch.linalg.cholesky(Rd)
    return SFactor(De=De, B=B, schur_cf=schur_cf)


def s_solve(sf: SFactor, ye, yd):
    """Solve S [ze; zd] = [ye; yd] by block elimination (ze/zd may be
    (ke[, p]) / (kd[, p]) batches)."""
    ze = zd = None
    if sf.schur_cf is not None:
        rhs = yd
        if sf.De is not None:
            rhs = yd - sf.B.T @ (ye / _col(sf.De, ye))
        col = rhs.dim() == 1
        zd = torch.cholesky_solve(rhs[:, None] if col else rhs, sf.schur_cf)
        zd = zd[:, 0] if col else zd
    if sf.De is not None:
        num = ye if zd is None else ye - sf.B @ zd
        ze = num / _col(sf.De, num)
    return ze, zd


def s_logdet(sf: SFactor) -> torch.Tensor:
    dev = (sf.De if sf.De is not None else sf.schur_cf).device
    out = torch.zeros((), dtype=torch.float64, device=dev)
    if sf.De is not None:
        out = out + torch.sum(torch.log(sf.De))
    if sf.schur_cf is not None:
        out = out + 2.0 * torch.sum(torch.log(torch.diagonal(sf.schur_cf)))
    return out


def basis_rmatvec(basis: NoiseBasis, w: torch.Tensor, X: torch.Tensor):
    """(F^T diag(w) X per part); X is (N,) or (N, p)."""
    we = w if basis.row_scale is None else w * basis.row_scale
    wX = we[:, None] * X if X.dim() == 2 else we * X
    ye = seg_sum(wX, basis.epochs) if basis.ephi is not None else None
    yd = None
    if basis.dense is not None:
        yd = basis.dense.T @ wX
    return ye, yd


def basis_matvec(basis: NoiseBasis, ae, ad) -> torch.Tensor:
    """F a = diag(row_scale) (U ae + Fd ad): the noise waveform of a
    coefficient vector."""
    parts = []
    if ae is not None and basis.ephi is not None:
        parts.append(seg_gather(ae, basis.epochs))
    if ad is not None and basis.dense is not None:
        parts.append(basis.dense @ ad)
    out = sum(parts)
    if basis.row_scale is None:
        return out
    return basis.row_scale[:, None] * out if out.dim() == 2 else basis.row_scale * out


def cinv_apply(basis: NoiseBasis | None, w: torch.Tensor, X: torch.Tensor,
               sf: SFactor | None = None) -> torch.Tensor:
    """C^-1 X = w X - w F S^-1 F^T w X; X is (N,) or (N, p)."""
    wX = w[:, None] * X if X.dim() == 2 else w * X
    if basis is None:
        return wX
    if sf is None:
        sf = s_factor(basis, w)
    ye, yd = basis_rmatvec(basis, w, X)
    ze, zd = s_solve(sf, ye, yd)
    corr = basis_matvec(basis, ze, zd)
    return wX - (w[:, None] * corr if X.dim() == 2 else w * corr)


def cinv_inner(basis: NoiseBasis | None, w: torch.Tensor, X: torch.Tensor,
               Y: torch.Tensor | None = None, sf: SFactor | None = None):
    """(X^T C^-1 Y, C^-1 Y), Y defaulting to X."""
    CinvY = cinv_apply(basis, w, X if Y is None else Y, sf)
    XT = X.T if X.dim() == 2 else X
    return XT @ CinvY, CinvY


def woodbury_chi2(basis: NoiseBasis | None, w: torch.Tensor, r: torch.Tensor,
                  sf: SFactor | None = None):
    """(r^T C^-1 r, (ze, zd)): the GLS chi^2 and the ML noise coefficients
    ahat = S^-1 F^T w r at these residuals."""
    chi2_w = torch.sum(w * r * r)
    if basis is None:
        return chi2_w, (None, None)
    if sf is None:
        sf = s_factor(basis, w)
    ye, yd = basis_rmatvec(basis, w, r)
    ze, zd = s_solve(sf, ye, yd)
    corr = torch.zeros((), dtype=torch.float64, device=r.device)
    if ye is not None:
        corr = corr + ye @ ze
    if yd is not None:
        corr = corr + yd @ zd
    return chi2_w - corr, (ze, zd)


def logdet_C(basis: NoiseBasis | None, w: torch.Tensor, sf: SFactor | None = None,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """log |C| = -sum log w + log |S| + sum log phi (the determinant lemma);
    `mask` (0/1 per row) keeps padding rows (w = 0) out of the first term."""
    if mask is not None:
        logw = torch.where(mask > 0, torch.log(torch.where(mask > 0, w, 1.0)), 0.0)
        out = -torch.sum(logw)
    else:
        out = -torch.sum(torch.log(w))
    if basis is None:
        return out
    if sf is None:
        sf = s_factor(basis, w)
    out = out + s_logdet(sf)
    if basis.ephi is not None:
        out = out + torch.sum(torch.log(basis.ephi))
    if basis.dense_phi is not None:
        out = out + torch.sum(torch.log(basis.dense_phi))
    return out


def cat_ahat(ze, zd) -> torch.Tensor:
    """The flat ML coefficient vector: epoch coefficients, then dense."""
    parts = [z for z in (ze, zd) if z is not None]
    if not parts:
        return torch.zeros(0, dtype=torch.float64)
    return torch.cat(parts)


def basis_dense(basis: NoiseBasis | None, n: int):
    """Materialize (F (n, k), phi (k,)), epoch columns first: for tests and
    small-N host work only."""
    if basis is None:
        return None
    cols, phis = [], []
    if basis.ephi is not None:
        ar = torch.arange(basis.ke, device=basis.ephi.device)
        cols.append((basis.epochs.eidx[:, None] == ar[None, :]).to(torch.float64))
        phis.append(basis.ephi)
    if basis.dense is not None:
        cols.append(basis.dense)
        phis.append(basis.dense_phi)
    F = torch.cat(cols, dim=1)
    if basis.row_scale is not None:
        F = basis.row_scale[:, None] * F
    return F, torch.cat(phis)


# --- K3 ------------------------------------------------------------------------


def _step_inputs(r: torch.Tensor, M: torch.Tensor, w: torch.Tensor, centre: bool,
                 weighted_norm: bool):
    """(r, Mn, norm): with `centre`, r and every column of M (B, p, N) lose
    their weighted mean (the grid's mean-free residuals); the columns are
    then divided by sqrt(sum w M^2) (`weighted_norm`, the grid's gn_step) or
    sqrt(sum M^2) (the GLS step), 1 where the sum is 0."""
    if centre:
        sw = torch.sum(w)
        r = r - torch.sum(w * r, dim=-1, keepdim=True) / sw
        M = M - torch.sum(w * M, dim=-1, keepdim=True) / sw
    col2 = torch.sum(w * M * M if weighted_norm else M**2, dim=-1)
    norm = torch.sqrt(torch.where(col2 == 0, 1.0, col2))
    return r, M / norm[..., None], norm


def ecorr_normal_eq_plain(r: torch.Tensor, M: torch.Tensor, w: torch.Tensor,
                          basis: NoiseBasis | None, ridge: float, centre: bool = False,
                          weighted_norm: bool = False):
    """Twin of K3: the Woodbury normal equations of B parameter sets in the
    JAX package's order (``gls.get_gls_step_fn.woodbury_pieces``,
    ``gridutils._point_kernel``), from the raw design through
    `_step_inputs`. r (B, N), M (B, p, N), w (N,) -> (G (B, p, p), c (B, p),
    chi2 (B,), ahat (B, ke + kd), norm (B, p))."""
    r, Mn, norm = _step_inputs(r, M, w, centre, weighted_norm)
    sf = s_factor(basis, w) if basis is not None else None
    p = Mn.shape[1]
    eye = torch.eye(p, dtype=torch.float64, device=r.device)
    outs = []
    for b in range(r.shape[0]):
        X = Mn[b].T
        CinvM = cinv_apply(basis, w, X, sf)
        G = X.T @ CinvM + ridge * eye
        c = CinvM.T @ (-r[b])
        chi2, (ze, zd) = woodbury_chi2(basis, w, r[b], sf=sf)
        outs.append((G, c, chi2, cat_ahat(ze, zd).to(r.device)))
    return (*(torch.stack(x) for x in zip(*outs)), norm)


#: the most design columns and dense basis columns K3 takes
#: (csrc/ecorr_normal_eq.cu PMAX, KDMAX)
K3_PMAX, K3_KDMAX = 256, 512


def ecorr_normal_eq(r: torch.Tensor, M: torch.Tensor, w: torch.Tensor,
                    basis: NoiseBasis | None, ridge: float, centre: bool = False,
                    weighted_norm: bool = False):
    """K3: the Woodbury normal equations over B parameter sets, the mean
    removal and column equilibration of the step included. A CUDA tensor
    launches the kernel (and raises if it cannot); a CPU tensor takes
    `ecorr_normal_eq_plain`. Shapes and options as in the twin; ahat is
    (B, ke + kd), epoch amplitudes first. `ecorr_normal_eq.launches` counts
    calls, each of which runs 4 to 8 kernel passes."""
    if r.device.type == "cpu":
        return ecorr_normal_eq_plain(r, M, w, basis, ridge, centre, weighted_norm)
    out = _launch_k3(r, M, w, basis, ridge, centre, weighted_norm)
    ecorr_normal_eq.launches += 1
    return out


def _launch_k3(r, M, w, basis, ridge, centre, weighted_norm):
    """One call of K3 on the tensors' device (shapes checked here): the row
    and epoch passes, the kd x kd factor of Rd and the triangular solves
    (torch.linalg), then the fold."""
    B, n = r.shape
    p = M.shape[1]
    dev = r.device
    if M.shape != (B, p, n) or w.shape != (n,) or p > K3_PMAX:
        raise ValueError(f"ecorr_normal_eq needs r (B, N), M (B, p <= {K3_PMAX}, N), w (N,); "
                         f"got {tuple(r.shape)}, {tuple(M.shape)}, {tuple(w.shape)}")
    if basis is not None and basis.row_scale is not None:
        raise NotImplementedError("kernel K3 takes no row-scaled basis")
    ke = 0 if basis is None else basis.ke
    kd = 0 if basis is None else basis.kd
    if kd > K3_KDMAX:
        raise ValueError(f"kernel K3 takes at most {K3_KDMAX} dense basis columns; got {kd}")
    one = torch.ones(1, dtype=torch.float64, device=dev)
    offsets = rows = torch.zeros(1, dtype=torch.int32, device=dev)
    ephi = Fd = one
    if ke:
        offsets, rows, ephi = basis.epochs.offsets, basis.epochs.rows, basis.ephi
        if basis.epochs.eidx.shape != (n,) or offsets.shape != (ke + 1,) \
                or offsets.device != dev:
            raise ValueError("the epoch index must match r's rows and device")
    if kd:
        Fd = basis.dense.T.contiguous()
        if Fd.shape != (kd, n):
            raise ValueError(f"the dense basis must be (N, kd) with N = {n}")
    for t in (r, M, w, ephi, Fd, *(() if not kd else (basis.dense_phi,))):
        if t.dtype != torch.float64 or t.device != dev:
            raise ValueError("ecorr_normal_eq needs float64 tensors on one device")
    r, M, w, ephi = r.contiguous(), M.contiguous(), w.contiguous(), ephi.contiguous()
    from pint_tpu_torch.ops import build

    lib = build.library("ecorr_normal_eq", _declare_k3)
    V = p + 1 + kd

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float64, device=dev)

    mean, norm, esum, De, S1 = (empty(B, p + 1), empty(B, max(p, 1)), empty(B, max(ke, 1), V),
                                empty(max(ke, 1)), empty(B, V, V))
    scratch = empty(lib.ecorr_gram_scratch_size(B, B, p, n, ke, kd))
    build.check(lib, lib.ecorr_gram(
        r.data_ptr(), M.data_ptr(), w.data_ptr(), Fd.data_ptr(), offsets.data_ptr(),
        rows.data_ptr(), ephi.data_ptr(), B, p, n, ke, kd, int(centre), int(weighted_norm),
        mean.data_ptr(), norm.data_ptr(), esum.data_ptr(), De.data_ptr(), scratch.data_ptr(),
        S1.data_ptr(), build.stream_of(r)))
    Wz = ad = one
    if kd:
        Rd = S1[0, p + 1:, p + 1:] + torch.diag(1.0 / basis.dense_phi)
        L = torch.linalg.cholesky(Rd)
        Wz = torch.linalg.solve_triangular(L, S1[:, p + 1:, :p + 1], upper=False).contiguous()
        ad = torch.linalg.solve_triangular(L.mT, Wz[:, :, p:], upper=True)[..., 0].contiguous()
    G, c, chi2, ahat = empty(B, p, p), empty(B, p), empty(B), empty(B, ke + kd)
    build.check(lib, lib.ecorr_fold(
        S1.data_ptr(), Wz.data_ptr(), esum.data_ptr(), De.data_ptr(), ad.data_ptr(), B, p, ke,
        kd, ridge, G.data_ptr(), c.data_ptr(), chi2.data_ptr(), ahat.data_ptr(),
        build.stream_of(r)))
    if kd:
        ahat[:, ke:] = ad
    return G, c, chi2, ahat, norm[:, :p]


ecorr_normal_eq.launches = 0


def _declare_k3(lib) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.ecorr_gram.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, p, p, p]
    lib.ecorr_gram.restype = ctypes.c_int
    lib.ecorr_gram_scratch_size.argtypes = [i, i, i, i, i, i]
    lib.ecorr_gram_scratch_size.restype = ctypes.c_long
    lib.ecorr_fold.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_double, p, p, p, p, p]
    lib.ecorr_fold.restype = ctypes.c_int
    lib.ecorr_gram_sets.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p, p, p, p, p, p, p, p]
    lib.ecorr_gram_sets.restype = ctypes.c_int
    lib.ecorr_fold_sets.argtypes = lib.ecorr_fold.argtypes
    lib.ecorr_fold_sets.restype = ctypes.c_int
    lib.ecorr_gram_stacked.argtypes = [p] * 8 + [i] * 8 + [p] * 7 + [p]
    lib.ecorr_gram_stacked.restype = ctypes.c_int


# --- K3, per-set-weight mode -----------------------------------------------------


class SetsNormalEq(NamedTuple):
    """K3's per-set-weight output for one design and E weight sets. Absent
    basis parts are empty tensors (ke or kd = 0).

    G (E, p, p), c (E, p), chi2 (E,): the Woodbury normal equations and
        r^T C^-1 r, G with the ridge;
    ahat (E, ke + kd): S^-1 F^T W r, epoch amplitudes first;
    norm (p,): the design's unweighted column norms;
    logdet (E,): log|C|;
    De (E, ke), esum (E, ke, p + 1 + kd): each epoch's 1/phi_e + sum w and
        sum w [Mn, r, Fd];
    L (E, kd, kd): the Cholesky factor of the Schur complement Rd;
    Wz (E, kd, p + 1), ad (E, kd): L^-1 S1[Fd, (Mn, r)] and L^-T Wz_r."""

    G: torch.Tensor
    c: torch.Tensor
    chi2: torch.Tensor
    ahat: torch.Tensor
    norm: torch.Tensor
    logdet: torch.Tensor
    De: torch.Tensor
    esum: torch.Tensor
    L: torch.Tensor
    Wz: torch.Tensor
    ad: torch.Tensor


def _check_sets(r, M, w, Fd, epochs, phi_e, phi_d):
    """(E, p, n, ke, kd) of a per-set-weight call, shapes checked."""
    E, n = w.shape
    p = M.shape[0]
    ke = 0 if epochs is None else epochs.ke
    kd = 0 if Fd is None else Fd.shape[0]
    ok = r.shape == (n,) and M.shape == (p, n) and p <= K3_PMAX and kd <= K3_KDMAX
    ok = ok and (ke == 0 or (phi_e is not None and phi_e.shape == (E, ke)
                             and epochs.eidx.shape == (n,)))
    ok = ok and (kd == 0 or (phi_d is not None and phi_d.shape == (E, kd) and Fd.shape == (kd, n)))
    if not ok:
        raise ValueError(
            f"ecorr_normal_eq_sets needs r (N,), M (p <= {K3_PMAX}, N), w (E, N), Fd "
            f"(kd <= {K3_KDMAX}, N), phi_e (E, ke), phi_d (E, kd); got r {tuple(r.shape)}, "
            f"M {tuple(M.shape)}, w {tuple(w.shape)}, Fd {None if Fd is None else tuple(Fd.shape)}, "
            f"phi_e {None if phi_e is None else tuple(phi_e.shape)}, "
            f"phi_d {None if phi_d is None else tuple(phi_d.shape)}, ke {ke}")
    return E, p, n, ke, kd


def ecorr_normal_eq_sets_plain(r: torch.Tensor, M: torch.Tensor, w: torch.Tensor,
                               Fd: torch.Tensor | None, epochs: EpochIndex | None,
                               phi_e: torch.Tensor | None, phi_d: torch.Tensor | None,
                               ridge: float) -> SetsNormalEq:
    """Twin of K3's per-set-weight mode, in the JAX package's order
    (``noise_like._loglike_fn``: ``s_factor``, ``cinv_apply``,
    ``woodbury_chi2``, ``logdet_C``), one weight set at a time, from the raw
    design M (p, N) with unweighted column norms. The backward's pieces (De,
    the epoch sums, L, Wz, ad) come from the same factorization."""
    E, p, n, ke, kd = _check_sets(r, M, w, Fd, epochs, phi_e, phi_d)
    _, Mn, norm = _step_inputs(r[None], M[None], w[0], False, False)
    X = Mn[0].T
    outs = [_set_plain(r, X, w[e], Fd, epochs, phi_e[e] if ke else None,
                       phi_d[e] if kd else None, ridge) for e in range(E)]
    return _stack_sets(outs, 0)._replace(norm=norm[0])


def _stack_sets(outs, dim: int) -> SetsNormalEq:
    """SetsNormalEq's of set groups stacked along `dim`, without norms."""
    return SetsNormalEq(*(None if x[0] is None else torch.stack(x, dim=dim) for x in zip(*outs)))


def _set_plain(r: torch.Tensor, X: torch.Tensor, w: torch.Tensor, Fd: torch.Tensor | None,
               epochs: EpochIndex | None, phi_e: torch.Tensor | None,
               phi_d: torch.Tensor | None, ridge: float, mask: torch.Tensor | None = None):
    """The twins' algebra of one weight set w (N,) over the design X (N, P):
    a SetsNormalEq of one set without its norms; `mask` is logdet_C's."""
    p = X.shape[1]
    ke = 0 if epochs is None else epochs.ke
    kd = 0 if Fd is None else Fd.shape[0]
    dense = None if kd == 0 else Fd.T
    eye = torch.eye(p, dtype=torch.float64, device=r.device)
    aug = torch.cat([X, r[:, None]] + ([dense] if kd else []), dim=1)
    empty = r.new_zeros
    basis = None
    if ke or kd:
        basis = NoiseBasis(dense=dense, dense_phi=phi_d, epochs=epochs if ke else None,
                           ephi=phi_e)
    sf = s_factor(basis, w) if basis is not None else None
    CinvM = cinv_apply(basis, w, X, sf)
    G = X.T @ CinvM + ridge * eye
    c = CinvM.T @ (-r)
    chi2, (ze, zd) = woodbury_chi2(basis, w, r, sf=sf)
    ld = logdet_C(basis, w, sf=sf, mask=mask)
    De = sf.De if ke else empty(0)
    esum = seg_sum(w[:, None] * aug, epochs) if ke else empty((0, p + 1 + kd))
    L, Wz, ad = empty((0, 0)), empty((0, p + 1)), empty(0)
    if kd:
        L = sf.schur_cf
        rhs = dense.T @ (w[:, None] * aug[:, :p + 1])
        if ke:
            rhs = rhs - sf.B.T @ (esum[:, :p + 1] / De[:, None])
        Wz = torch.linalg.solve_triangular(L, rhs, upper=False)
        ad = torch.linalg.solve_triangular(L.T, Wz[:, p:], upper=True)[:, 0]
    ahat = cat_ahat(ze, zd).to(r.device) if basis is not None else empty(0)
    return SetsNormalEq(G=G, c=c, chi2=chi2, ahat=ahat, norm=None, logdet=ld, De=De, esum=esum,
                        L=L, Wz=Wz, ad=ad)


def ecorr_normal_eq_sets(r: torch.Tensor, M: torch.Tensor, w: torch.Tensor,
                         Fd: torch.Tensor | None, epochs: EpochIndex | None,
                         phi_e: torch.Tensor | None, phi_d: torch.Tensor | None,
                         ridge: float) -> SetsNormalEq:
    """K3's per-set-weight mode: one design (r (N,), raw M (p, N), unweighted
    norms, no centring) under E sets of weights w (E, N) and prior variances
    phi_e (E, ke), phi_d (E, kd) (Fd (kd, N): the dense basis, columns
    before rows). A CUDA tensor launches the kernel (and raises if it
    cannot); a CPU tensor takes `ecorr_normal_eq_sets_plain`.
    `ecorr_normal_eq_sets.launches` counts calls (5 to 9 kernel passes
    each)."""
    if r.device.type == "cpu":
        return ecorr_normal_eq_sets_plain(r, M, w, Fd, epochs, phi_e, phi_d, ridge)
    out = _launch_k3_sets(r, M, w, Fd, epochs, phi_e, phi_d, ridge)
    ecorr_normal_eq_sets.launches += 1
    return out


def _launch_k3_sets(r, M, w, Fd, epochs, phi_e, phi_d, ridge) -> SetsNormalEq:
    """One call of K3's per-set-weight mode: passes 2-5 and the log sums,
    then `_fold_sets`."""
    E, p, n, ke, kd = _check_sets(r, M, w, Fd, epochs, phi_e, phi_d)
    dev = r.device
    one = torch.ones(1, dtype=torch.float64, device=dev)
    offsets = rows = torch.zeros(1, dtype=torch.int32, device=dev)
    ephi = Fdc = one
    if ke:
        offsets, rows, ephi = epochs.offsets, epochs.rows, phi_e.contiguous()
        if offsets.device != dev:
            raise ValueError("the epoch index must lie on r's device")
    if kd:
        Fdc = Fd.contiguous()
    for t in (r, M, w, ephi, Fdc, *(() if not kd else (phi_d,))):
        if t.dtype != torch.float64 or t.device != dev:
            raise ValueError("ecorr_normal_eq_sets needs float64 tensors on one device")
    r, M, w = r.contiguous(), M.contiguous(), w.contiguous()
    from pint_tpu_torch.ops import build

    lib = build.library("ecorr_normal_eq", _declare_k3)
    V = p + 1 + kd

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float64, device=dev)

    mean, norm, logw = empty(p + 1), empty(max(p, 1)), empty(E)
    esum, De, S1 = empty(E, max(ke, 1), V), empty(E, max(ke, 1)), empty(E, V, V)
    scratch = empty(lib.ecorr_gram_scratch_size(E, 1, p, n, ke, kd))
    build.check(lib, lib.ecorr_gram_sets(
        r.data_ptr(), M.data_ptr(), w.data_ptr(), Fdc.data_ptr(), offsets.data_ptr(),
        rows.data_ptr(), ephi.data_ptr(), E, p, n, ke, kd, mean.data_ptr(), norm.data_ptr(),
        logw.data_ptr(), esum.data_ptr(), De.data_ptr(), scratch.data_ptr(), S1.data_ptr(),
        build.stream_of(r)))
    return _fold_sets(lib, S1, esum, De, logw, phi_e, phi_d, p, ke, kd, ridge)._replace(
        norm=norm[:p])


def _fold_sets(lib, S1, esum, De, logw, phi_e, phi_d, p, ke, kd, ridge):
    """The tail of K3's per-set and stacked modes over B sets: the kd x kd
    Cholesky factors of Rd and the triangular solves (torch.linalg, batched; a
    factor that fails is NaN), the fold (``ecorr_fold_sets``), then log|C| =
    -sum log w + log|S| + sum log phi in logdet_C's order. Returns a
    SetsNormalEq over the B sets without its norms; phi_e (B, ke), phi_d (B,
    kd)."""
    from pint_tpu_torch.ops import build

    B, dev = S1.shape[0], S1.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float64, device=dev)

    L, Wz, ad = empty(B, 0, 0), empty(B, 0, p + 1), empty(B, 0)
    if kd:
        Rd = S1[:, p + 1:, p + 1:] + torch.diag_embed(1.0 / phi_d)
        L, info = torch.linalg.cholesky_ex(Rd)
        L = torch.where((info == 0)[:, None, None], L, float("nan"))
        Wz = torch.linalg.solve_triangular(L, S1[:, p + 1:, :p + 1], upper=False).contiguous()
        ad = torch.linalg.solve_triangular(L.mT, Wz[:, :, p:], upper=True)[..., 0].contiguous()
    G, c, chi2, ahat = empty(B, p, p), empty(B, p), empty(B), empty(B, ke + kd)
    build.check(lib, lib.ecorr_fold_sets(
        S1.data_ptr(), Wz.data_ptr(), esum.data_ptr(), De.data_ptr(), ad.data_ptr(), B, p, ke,
        kd, ridge, G.data_ptr(), c.data_ptr(), chi2.data_ptr(), ahat.data_ptr(),
        build.stream_of(S1)))
    if kd:
        ahat[:, ke:] = ad
    De, esum = De[:, :ke], esum[:, :ke]
    sl = torch.zeros(B, dtype=torch.float64, device=dev)
    if ke:
        sl = sl + torch.sum(torch.log(De), dim=1)
    if kd:
        sl = sl + 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)), dim=1)
    ld = -logw + sl
    if ke:
        ld = ld + torch.sum(torch.log(phi_e), dim=1)
    if kd:
        ld = ld + torch.sum(torch.log(phi_d), dim=1)
    return SetsNormalEq(G=G, c=c, chi2=chi2, ahat=ahat, norm=None, logdet=ld, De=De, esum=esum,
                        L=L, Wz=Wz, ad=ad)


ecorr_normal_eq_sets.launches = 0


# --- K3, stacked per-pulsar mode -------------------------------------------------


class StackedEpochs(NamedTuple):
    """The ECORR epochs of N pulsars' bucket-padded rows, ke epochs each.

    per     : tuple of N EpochIndex (the twin's)
    offsets : (N, ke + 1) int32 CSR offsets, one row per pulsar
    rows    : (N, nnz) int32 row ids (each pulsar's own, padded with 0)
    """

    per: tuple
    offsets: torch.Tensor
    rows: torch.Tensor

    @property
    def ke(self) -> int:
        return self.offsets.shape[1] - 1


def stacked_epochs(eidx: torch.Tensor, ke: int) -> StackedEpochs:
    """StackedEpochs of per-pulsar epoch indices eidx (N, rows) (host work,
    once per array)."""
    per = tuple(epoch_index(e, ke) for e in eidx)
    nnz = max(1, max(x.rows.shape[0] for x in per))
    rows = torch.zeros((len(per), nnz), dtype=torch.int32, device=eidx.device)
    for a, x in enumerate(per):
        rows[a, :x.rows.shape[0]] = x.rows
    return StackedEpochs(per=per, offsets=torch.stack([x.offsets for x in per]), rows=rows)


def _check_stacked(r, M, Gc, w, Fd, epochs, phi_e, phi_d):
    """(E, N, p, m, n, ke, kd) of a stacked call, shapes checked."""
    E, N, n = w.shape
    p, m = M.shape[1], Gc.shape[1]
    ke = 0 if epochs is None else epochs.ke
    kd = 0 if Fd is None else Fd.shape[1]
    ok = r.shape == (N, n) and M.shape == (N, p, n) and Gc.shape == (N, m, n)
    ok = ok and p + m <= K3_PMAX and kd <= K3_KDMAX
    ok = ok and (ke == 0 or (phi_e is not None and phi_e.shape == (E, N, ke)
                             and epochs.offsets.shape[0] == N))
    ok = ok and (kd == 0 or (phi_d is not None and phi_d.shape == (E, N, kd)
                             and Fd.shape == (N, kd, n)))
    if not ok:
        raise ValueError(
            f"ecorr_normal_eq_stacked needs r (N, n), M (N, p, n), G (N, m, n) with p + m <= "
            f"{K3_PMAX}, w (E, N, n), Fd (N, kd <= {K3_KDMAX}, n), phi_e (E, N, ke), phi_d "
            f"(E, N, kd); got r {tuple(r.shape)}, M {tuple(M.shape)}, G {tuple(Gc.shape)}, "
            f"w {tuple(w.shape)}, Fd {None if Fd is None else tuple(Fd.shape)}, phi_e "
            f"{None if phi_e is None else tuple(phi_e.shape)}, phi_d "
            f"{None if phi_d is None else tuple(phi_d.shape)}, ke {ke}")
    return E, N, p, m, n, ke, kd


#: vmap's output dimensions of `_set_plain` (no norms)
_SET_DIMS = SetsNormalEq(*(None if f == "norm" else 0 for f in SetsNormalEq._fields))


def ecorr_normal_eq_stacked_plain(r: torch.Tensor, M: torch.Tensor, Gc: torch.Tensor,
                                  w: torch.Tensor, Fd: torch.Tensor | None,
                                  epochs: StackedEpochs | None, phi_e: torch.Tensor | None,
                                  phi_d: torch.Tensor | None) -> SetsNormalEq:
    """Twin of K3's stacked mode: pint_tpu's per-pulsar algebra of the joint
    PTA likelihood (``pta_like._pta_core.pulsar_blocks``: ``cinv_inner``,
    ``woodbury_chi2``, ``logdet_C(mask=)``): the per-set twin's algebra
    (`_set_plain`) over each pulsar's E weight sets at once
    (`torch.func.vmap`, as pint_tpu vmaps it over the points). X = [Mn, G]:
    the raw design divided by its unweighted norms, then the common block's
    raw columns; no ridge. Pad rows have w = 0 and stay out of log|C|.
    Outputs as SetsNormalEq with a leading (E, N): G = X^T C^-1 X (E, N,
    p + m, p + m), c = -X^T C^-1 r, norm (N, p)."""
    E, N, p, m, n, ke, kd = _check_stacked(r, M, Gc, w, Fd, epochs, phi_e, phi_d)
    per, norms = [], []
    for a in range(N):
        _, Mn, norm = _step_inputs(r[a][None], M[a][None], w[0, a], False, False)
        X = torch.cat([Mn[0].T, Gc[a].T], dim=1)
        mask = (w[0, a] > 0).to(torch.float64)

        def one(we, pe, pd, a=a, X=X, mask=mask):
            return _set_plain(r[a], X, we, Fd[a] if kd else None, epochs.per[a] if ke else None,
                              pe if ke else None, pd if kd else None, 0.0, mask)

        none = w[:, a, :0]
        per.append(torch.func.vmap(one, out_dims=_SET_DIMS)(
            w[:, a], phi_e[:, a] if ke else none, phi_d[:, a] if kd else none))
        norms.append(norm[0])
    return _stack_sets(per, 1)._replace(norm=torch.stack(norms))


def ecorr_normal_eq_stacked(r: torch.Tensor, M: torch.Tensor, Gc: torch.Tensor,
                            w: torch.Tensor, Fd: torch.Tensor | None,
                            epochs: StackedEpochs | None, phi_e: torch.Tensor | None,
                            phi_d: torch.Tensor | None) -> SetsNormalEq:
    """K3's stacked mode: N pulsars' bucket-padded designs (r (N, n), raw M
    (N, p, n), the common block G (N, m, n), Fd (N, kd, n), their epochs)
    under E points' weights w (E, N, n) and prior variances phi_e (E, N,
    ke), phi_d (E, N, kd): E x N sets, set (e, a) reading pulsar a's rows by
    stride. A CUDA tensor launches the kernel (and raises if it cannot); a
    CPU tensor takes `ecorr_normal_eq_stacked_plain`.
    `ecorr_normal_eq_stacked.launches` counts calls (5 to 9 kernel passes
    each)."""
    if r.device.type == "cpu":
        return ecorr_normal_eq_stacked_plain(r, M, Gc, w, Fd, epochs, phi_e, phi_d)
    out = _launch_k3_stacked(r, M, Gc, w, Fd, epochs, phi_e, phi_d)
    ecorr_normal_eq_stacked.launches += 1
    return out


ecorr_normal_eq_stacked.launches = 0


def _launch_k3_stacked(r, M, Gc, w, Fd, epochs, phi_e, phi_d) -> SetsNormalEq:
    """One call of K3's stacked mode: passes 2-5 and the log sums over the
    E N sets (``ecorr_gram_stacked``), then `_fold_sets` with ridge 0 (the
    per-set mode's fold: each set's own De and epoch sums)."""
    from pint_tpu_torch.device import require_f64
    from pint_tpu_torch.ops import build

    E, N, p, m, n, ke, kd = _check_stacked(r, M, Gc, w, Fd, epochs, phi_e, phi_d)
    require_f64("ecorr_normal_eq_stacked", tensor={
        "r": r, "M": M, "G": Gc, "w": w, **({"Fd": Fd, "phi_d": phi_d} if kd else {}),
        **({"phi_e": phi_e} if ke else {})})
    dev = r.device
    S, P = E * N, p + m
    one = torch.ones(1, dtype=torch.float64, device=dev)
    offsets = rows = torch.zeros(1, dtype=torch.int32, device=dev)
    ephi = Fdc = one
    nnz = 1
    if ke:
        offsets, rows, ephi = epochs.offsets.contiguous(), epochs.rows.contiguous(), \
            phi_e.contiguous()
        nnz = rows.shape[1]
    if kd:
        Fdc = Fd.contiguous()
    for t in (r, M, Gc, w, ephi, Fdc, offsets, *(() if not kd else (phi_d,))):
        if t.device != dev:
            raise ValueError("ecorr_normal_eq_stacked needs its tensors on one device")
    r, M, Gc, w = r.contiguous(), M.contiguous(), Gc.contiguous(), w.contiguous()
    lib = build.library("ecorr_normal_eq", _declare_k3)
    V = P + 1 + kd

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float64, device=dev)

    mean, norm, logw = empty(N, P + 1), empty(N, max(p, 1)), empty(S)
    esum, De, S1 = empty(S, max(ke, 1), V), empty(S, max(ke, 1)), empty(S, V, V)
    scratch = empty(lib.ecorr_gram_scratch_size(S, N, P, n, ke, kd))
    build.check(lib, lib.ecorr_gram_stacked(
        r.data_ptr(), M.data_ptr(), Gc.data_ptr(), w.data_ptr(), Fdc.data_ptr(),
        offsets.data_ptr(), rows.data_ptr(), ephi.data_ptr(), E, N, p, m, n, ke, kd, nnz,
        mean.data_ptr(), norm.data_ptr(), logw.data_ptr(), esum.data_ptr(), De.data_ptr(),
        scratch.data_ptr(), S1.data_ptr(), build.stream_of(r)))
    out = _fold_sets(lib, S1, esum, De, logw, phi_e.reshape(S, ke) if ke else None,
                     phi_d.reshape(S, kd) if kd else None, P, ke, kd, 0.0)

    return out._replace(norm=norm[:, :p], **{
        f: getattr(out, f).reshape(E, N, *getattr(out, f).shape[1:])
        for f in out._fields if f != "norm"})

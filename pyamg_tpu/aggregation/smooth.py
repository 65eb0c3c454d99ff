"""Prolongation smoothers (setup phase, host side).

Rebuild of [R] pyamg/aggregation/smooth.py (SURVEY.md §2.2):
turn the tentative prolongator T into a smoothed P.  Jacobi/Richardson are
SpGEMM polynomials; energy minimization is the sparsity-constrained Krylov
scheme (amg_core incomplete_mat_mult_* masked SpGEMM analog implemented as
scipy product + pattern mask, which is numerically identical).
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from ..util.linalg import approximate_spectral_radius
from ..util.utils import conj_transpose_csr, get_block_diag, get_diagonal, scale_rows, compute_BtBinv

__all__ = [
    "jacobi_prolongation_smoother",
    "richardson_prolongation_smoother",
    "energy_prolongation_smoother",
    "satisfy_constraints",
]


def _dinv_scaled(S, weighting="diagonal", omega=4.0 / 3.0):
    """Return (omega_eff, dinv) for weighted-Jacobi smoothing of S —
    dinv is None for true block weighting (no scalar row scaling).

    D^-1 S is never materialized here: the smoothing product runs as the
    fused native jacobi_smooth (or a scipy fallback that scales on
    demand), and the 'diagonal' spectral radius runs the Arnoldi through
    a matvec-closure operator — saving a 21M-nnz np.repeat row-scaled
    copy per level at 4.2M unknowns."""
    if weighting == "local":
        # Local Jacobi weighting: diag = abs row sums; omega used directly.
        d = np.asarray(np.abs(S).sum(axis=1)).ravel()
        with np.errstate(divide="ignore", invalid="ignore"):
            dinv = np.where(d != 0, 1.0 / d, 0.0)
        return omega, dinv
    if weighting == "block":
        bs = S.blocksize[0] if sp.issparse(S) and S.format == "bsr" else 1
        if bs > 1:
            return omega, None
    # 'diagonal' — cache rho on S so the solve-phase smoother setup
    # (relaxation.smoothing.rho_D_inv_A) reuses the same Arnoldi
    S_csr = sp.csr_matrix(S)
    dinv = get_diagonal(S_csr, inv=True)
    rho = getattr(S, "_rho_D_inv", None)
    if rho is None:
        from scipy.sparse.linalg import LinearOperator

        if np.iscomplexobj(S_csr.data):
            op = LinearOperator(S_csr.shape,
                                matvec=lambda v: dinv * (S_csr @ v),
                                dtype=S_csr.dtype)
        else:
            # rho is only needed to ~1% (tol=0.01): run the Arnoldi in
            # f32 — halves the matvec + orthogonalization memory traffic
            # of the dominant setup-phase eigen-estimate
            S32 = S_csr.astype(np.float32)
            dinv32 = dinv.astype(np.float32)
            op = LinearOperator(S_csr.shape,
                                matvec=lambda v: dinv32 * (S32 @ v),
                                dtype=np.float32)
        rho = float(approximate_spectral_radius(op))
        try:
            S._rho_D_inv = rho
        except AttributeError:
            pass
    return omega / max(rho, 1e-300), dinv


def _jacobi_smooth_step(S_csr, P, dinv, omega_eff):
    """One P <- P - omega * diag(dinv) @ (S @ P) step: fused native
    kernel when available, scipy pipeline otherwise."""
    if not (np.iscomplexobj(S_csr.data) or np.iscomplexobj(P.data)):
        try:
            from ..amg_core import jacobi_smooth as _native
        except ImportError:
            _native = None
        if _native is not None:
            out = _native(S_csr, P, dinv, omega_eff)
            if out is not None:
                return out
    SP = sp.csr_matrix(S_csr @ P)
    if dinv is not None:
        SP = scale_rows(SP, dinv, copy=False)
    return sp.csr_matrix(P - omega_eff * SP)


def _blockdiag_csr(blocks):
    """(n, bs, bs) stack -> block-diagonal CSR, vectorized."""
    n, bs, _ = blocks.shape
    rows = (np.arange(n)[:, None, None] * bs + np.arange(bs)[None, :, None])
    cols = (np.arange(n)[:, None, None] * bs + np.arange(bs)[None, None, :])
    rows = np.broadcast_to(rows, (n, bs, bs)).ravel()
    cols = np.broadcast_to(cols, (n, bs, bs)).ravel()
    return sp.csr_matrix((blocks.ravel(), (rows, cols)), shape=(n * bs, n * bs))


def jacobi_prolongation_smoother(S, T, C, B, omega=4.0 / 3.0, degree=1,
                                 weighting="diagonal", filter_entries=False):
    """P = (I - omega * D^{-1} S)^degree @ T.

    Rebuild of [R] pyamg/aggregation/smooth.py::jacobi_prolongation_smoother.
    ``omega`` is scaled by rho(D^{-1} S) for 'diagonal'/'block' weighting
    (reference behavior); 'local' weighting uses abs row-sum scaling with
    omega unscaled.
    """
    bs = S.blocksize[0] if sp.issparse(S) and S.format == "bsr" else 1
    if weighting == "block" and bs > 1:
        # true block weighting: materialized block-D^-1 S (no scalar dinv)
        Dinv = get_block_diag(S, bs, inv_flag=True)   # (n/bs, bs, bs)
        DinvS = sp.csr_matrix(_blockdiag_csr(Dinv) @ sp.csr_matrix(S))
        rho = approximate_spectral_radius(DinvS)
        omega_eff = omega / max(rho, 1e-300)
        P = sp.csr_matrix(T)
        for _ in range(int(degree)):
            P = sp.csr_matrix(P - omega_eff * sp.csr_matrix(DinvS @ P))
        P.eliminate_zeros()
        return P

    omega_eff, dinv = _dinv_scaled(S, weighting, omega)
    S_csr = sp.csr_matrix(S)
    P = sp.csr_matrix(T)
    for _ in range(int(degree)):
        P = _jacobi_smooth_step(S_csr, P, dinv, omega_eff)
    P.eliminate_zeros()
    if not filter_entries and dinv is not None:
        # P applies EXACTLY as S_sm^degree @ T with
        # S_sm = I - omega_eff * diag(dinv) @ A.  Record the RECIPE (not
        # the materialized S_sm — building it costs a 21M-nnz sparse add
        # per level) for the device compiler, which scales the
        # already-converted DIA of A on device: applying the factors
        # (square A-pattern DIA + one-hot tentative spread) is far
        # cheaper on the device than applying the fused P
        # (engine/hierarchy.py::_factored_transfer).
        P._sa_factor = {"dinv": dinv, "omega": omega_eff,
                        "T": sp.csr_matrix(T), "degree": int(degree)}
    return P


def richardson_prolongation_smoother(S, T, omega=4.0 / 3.0, degree=1):
    """P = (I - omega/rho(S) * S)^degree @ T.

    Rebuild of [R] pyamg/aggregation/smooth.py::richardson_prolongation_smoother.
    """
    rho = approximate_spectral_radius(S)
    w = omega / max(rho, 1e-300)
    P = sp.csr_matrix(T)
    S = sp.csr_matrix(S)
    for _ in range(int(degree)):
        P = _jacobi_smooth_step(S, P, None, w)
    P.eliminate_zeros()
    # S_sm = I - w*S: dinv=None -> identity row scaling in the recipe
    P._sa_factor = {"dinv": None, "omega": w,
                    "T": sp.csr_matrix(T), "degree": int(degree)}
    return P


def satisfy_constraints(U, B, BtBinv):
    """Project update U so that U @ B = 0 row-wise (in place on U.data).

    Rebuild of [R] pyamg/aggregation/smooth.py::Satisfy_Constraints
    (amg_core satisfy_constraints_helper): for each row i with pattern J,
    subtract the component of U[i, J] along span(B[J]) so the candidate
    interpolation constraint P @ Bc = B is preserved by the energy
    minimization update.  BtBinv holds (B_J^H B_J)^+ per row.
    """
    U = sp.csr_matrix(U)
    U.sort_indices()
    n = U.shape[0]
    lens = np.diff(U.indptr)
    if U.nnz == 0:
        return U
    maxlen = int(lens.max())
    mask = np.arange(maxlen)[None, :] < lens[:, None]
    pad_idx = np.zeros((n, maxlen), dtype=np.int64)
    pad_val = np.zeros((n, maxlen), dtype=U.dtype)
    pad_idx[mask] = U.indices
    pad_val[mask] = U.data
    Bn = np.where(mask[:, :, None], B[pad_idx], 0)          # (n, m, k)
    UB = np.einsum("nm,nmk->nk", pad_val, Bn)                # (n, k)
    coef = np.einsum("nk,nkl->nl", UB, BtBinv)               # (n, k)
    corr = np.einsum("nl,nml->nm", coef, Bn.conj())
    pad_val = pad_val - np.where(mask, corr, 0)
    U.data = pad_val[mask]
    return U


def _masked_spgemm(A, Bmat, pattern):
    """(A @ Bmat) restricted to the sparsity of ``pattern``.

    Analog of amg_core incomplete_mat_mult_bsr/csr (SURVEY.md §2.4) — the
    engine of energy minimization.  Computed as an exact product followed
    by a pattern mask (numerically identical to the reference's
    incomplete product on that pattern).
    """
    full = sp.csr_matrix(A @ Bmat)
    mask = pattern.copy()
    mask.data = np.ones_like(mask.data)
    out = sp.csr_matrix(full.multiply(mask))
    # ensure the full pattern is present (explicit zeros kept) so later
    # in-place updates can address every slot
    out = out + 0.0 * mask
    out = sp.csr_matrix(out)
    out.sort_indices()
    return out


def energy_prolongation_smoother(
    A, T, Atilde, B, Bf, Cpt_params, krylov="cg", maxiter=4, tol=1e-8,
    degree=1, weighting="local", prefilter=None, postfilter=None,
):
    """Energy-minimization prolongation smoothing.

    Rebuild of [R] pyamg/aggregation/smooth.py::energy_prolongation_smoother:
    minimize the energy of P's columns in the A-norm subject to (a) the
    sparsity pattern ``Atilde^degree @ T`` and (b) the interpolation
    constraint ``P @ Bc = B`` (enforced via :func:`satisfy_constraints`).
    krylov='cg' (SPD), 'cgnr' (nonsymmetric, normal equations), or 'gmres'.

    Parameters mirror the reference; ``Cpt_params`` is either None or the
    (bool, dict) pair from rootnode (identity rows at root C-points are
    preserved through the iteration).
    """
    A = sp.csr_matrix(A) if A.format != "bsr" else A
    Acsr = sp.csr_matrix(A)
    T = sp.csr_matrix(T)
    Bf = np.asarray(Bf)
    if Bf.ndim == 1:
        Bf = Bf.reshape(-1, 1)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B.reshape(-1, 1)

    # sparsity pattern: Atilde^degree @ T  (pattern only); expand a
    # node-level strength graph to dof level if A is blocked
    pattern = sp.csr_matrix(T)
    Ap = sp.csr_matrix(Atilde)
    if Ap.shape[0] != Acsr.shape[0]:
        from ..util.utils import unamal

        bs = Acsr.shape[0] // Ap.shape[0]
        Ap = sp.csr_matrix(unamal(Ap, bs, bs))
    for _ in range(int(degree)):
        pattern = sp.csr_matrix(Ap @ pattern)
    if prefilter:
        from ..util.utils import filter_matrix_rows, truncate_rows
        if "theta" in prefilter:
            pattern = filter_matrix_rows(pattern, prefilter["theta"])
        if "k" in prefilter:
            pattern = truncate_rows(pattern, prefilter["k"])
    pattern.data = np.ones_like(pattern.data)
    pattern.sort_indices()

    rootnode = Cpt_params is not None and Cpt_params[0]
    if rootnode:
        params = Cpt_params[1]
        I_F = params["I_F"]
        P_I = params["P_I"]

    # weighted preconditioner for the energy iteration
    if weighting == "diagonal":
        dinv = get_diagonal(Acsr, inv=True)
    elif weighting == "local":
        d = np.asarray(np.abs(Acsr).sum(axis=1)).ravel()
        with np.errstate(divide="ignore", invalid="ignore"):
            dinv = np.where(d != 0, 1.0 / d, 0.0)
    else:
        dinv = get_diagonal(Acsr, inv=True)

    # Gram pseudo-inverses for the constraint projection over the pattern
    BtBinv = compute_BtBinv(B, pattern)

    P = T.copy()

    def project(U):
        U = satisfy_constraints(U, B, BtBinv)
        if rootnode:
            U = sp.csr_matrix(I_F @ U)
        return U

    if krylov == "cg":
        # preconditioned steepest-descent/CG in the A-energy functional,
        # matricized over all columns of P at once
        R = _masked_spgemm(Acsr, P, pattern)       # residual = A P  (target 0)
        R = sp.csr_matrix(-R)
        R = project(R)
        oldsum = 0.0
        Pk = None
        for it in range(int(maxiter)):
            Z = scale_rows(R, dinv, copy=True)      # preconditioned residual
            newsum = _fro_inner(R, Z)
            if newsum <= tol * tol or abs(newsum) < 1e-300:
                break
            if it == 0:
                Pk = Z
            else:
                beta = newsum / oldsum
                Pk = sp.csr_matrix(Z + beta * Pk)
            oldsum = newsum
            APk = _masked_spgemm(Acsr, Pk, pattern)
            APk = project(APk)
            denom = _fro_inner(Pk, APk)
            if abs(denom) < 1e-300:
                break
            alpha = newsum / denom
            P = sp.csr_matrix(P + alpha * Pk)
            R = sp.csr_matrix(R - alpha * APk)
        P = sp.csr_matrix(P)
    elif krylov in ("cgnr",):
        AH = conj_transpose_csr(Acsr)
        R = _masked_spgemm(Acsr, P, pattern)
        R = sp.csr_matrix(-R)
        oldsum = 0.0
        Pk = None
        for it in range(int(maxiter)):
            Z = _masked_spgemm(AH, R, pattern)
            Z = project(Z)
            newsum = _fro_inner(Z, Z)
            if newsum <= tol * tol or abs(newsum) < 1e-300:
                break
            if it == 0:
                Pk = Z
            else:
                Pk = sp.csr_matrix(Z + (newsum / oldsum) * Pk)
            oldsum = newsum
            APk = _masked_spgemm(Acsr, Pk, pattern)
            denom = _fro_inner(APk, APk)
            if abs(denom) < 1e-300:
                break
            alpha = newsum / denom
            P = sp.csr_matrix(P + alpha * Pk)
            R = sp.csr_matrix(R - alpha * APk)
    elif krylov == "gmres":
        # one-shot minimal-residual iterations (restarted GMRES(1) per step)
        R = sp.csr_matrix(-_masked_spgemm(Acsr, P, pattern))
        R = project(R)
        for _ in range(int(maxiter)):
            Z = scale_rows(R, dinv, copy=True)
            AZ = _masked_spgemm(Acsr, Z, pattern)
            AZ = project(AZ)
            denom = _fro_inner(AZ, AZ)
            if abs(denom) < 1e-300:
                break
            alpha = _fro_inner(AZ, R) / denom
            P = sp.csr_matrix(P + alpha * Z)
            R = sp.csr_matrix(R - alpha * AZ)
    else:
        raise ValueError(f"unknown krylov method {krylov}")

    if rootnode:
        P = sp.csr_matrix(I_F @ P + P_I)
    if postfilter:
        from ..util.utils import filter_matrix_rows, truncate_rows, filter_operator
        if "theta" in postfilter:
            P = filter_operator(P, filter_matrix_rows(P, postfilter["theta"]), B, Bf)
        if "k" in postfilter:
            P = filter_operator(P, truncate_rows(P, postfilter["k"]), B, Bf)
    P.eliminate_zeros()
    P.sort_indices()
    return P


def _fro_inner(X, Y):
    """Frobenius inner product of two same-pattern sparse matrices."""
    Xc = sp.csr_matrix(X)
    Yc = sp.csr_matrix(Y)
    return float(np.real(Xc.multiply(Yc.conjugate()).sum()))

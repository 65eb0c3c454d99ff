"""Compatible relaxation (CR) coarsening.

Rebuild of [R] pyamg/classical/cr.py (SURVEY.md §2.2, (M)
confidence): measure how well relaxation alone reduces error on the
F points (habituated / concurrent variants); points where relaxation
stalls become C candidates.  Also ``binormalize`` row/column scaling.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .split import C_NODE, F_NODE

__all__ = ["CR", "binormalize"]


def CR(A, method="habituated", nu=3, thetacr=0.7, maxiter=20, seed=0):
    """Compatible-relaxation C/F splitting.

    For the current F set, run ``nu`` sweeps of (F-restricted) weighted
    Jacobi on A e = 0 from a random error; points whose error decays
    slower than ``thetacr`` per sweep are marked candidate C points
    (independent-set-filtered so C points are not adjacent).

    method='habituated': relaxation on the full system with C values
    pinned to zero.  method='concurrent': relaxation restricted to the
    F-F submatrix.
    """
    A = sp.csr_matrix(A)
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    splitting = np.full(n, F_NODE, dtype=np.int32)

    d = A.diagonal()
    with np.errstate(divide="ignore", invalid="ignore"):
        dinv = np.where(d != 0, 1.0 / d, 0.0)

    for _ in range(maxiter):
        F = splitting == F_NODE
        if not F.any():
            break
        e = rng.random(n) - 0.5
        e[~F] = 0.0
        norms0 = np.abs(e) + 1e-30
        for _sweep in range(nu):
            if method == "habituated":
                r = -(A @ e)
                e = e + 0.7 * dinv * r
                e[~F] = 0.0
            else:  # concurrent: F-F submatrix relaxation
                r = -(A @ (e * F))
                e = np.where(F, e + 0.7 * dinv * r, 0.0)
        # slow-to-converge F points: candidate C
        rate = (np.abs(e) / norms0) ** (1.0 / nu)
        candidates = F & (rate > thetacr)
        if not candidates.any():
            break
        # independent-set filter over candidates (no adjacent C points)
        weights = rate + rng.random(n) * 1e-3
        sub = A[candidates][:, candidates].tocsr()
        idx = np.flatnonzero(candidates)
        from ..graph import maximal_independent_set

        mis = maximal_independent_set(sub, algo="parallel",
                                      weights=weights[idx])
        splitting[idx[mis.astype(bool)]] = C_NODE
    return splitting


def binormalize(A, tol=1e-8, maxiter=10):
    """Binormalization scaling: find d so that diag(d) A diag(d) has
    unit row (and column) 2-norms.

    Rebuild of [R] pyamg/classical/cr.py::binormalize (Livne & Golub
    scaling); returns the scaled matrix.
    """
    A = sp.csr_matrix(A)
    n = A.shape[0]
    B = A.multiply(A.conjugate()).real.tocsr()  # |a_ij|^2
    d2 = np.ones(n)
    for _ in range(max(maxiter, 1) * 20):
        s = B @ d2
        with np.errstate(divide="ignore", invalid="ignore"):
            d2_new = np.sqrt(np.where(s > 0, d2 / np.maximum(s, 1e-300), d2))
        if np.max(np.abs(d2_new - d2)) < tol * np.max(np.abs(d2)):
            d2 = d2_new
            break
        d2 = d2_new
    d = np.sqrt(d2)
    D = sp.dia_matrix((d.reshape(1, -1), [0]), shape=A.shape)
    return sp.csr_matrix(D @ A @ D)

"""Linear-algebra utilities (host side, NumPy/SciPy).

Rebuild of the reference utilities described in
SURVEY.md §2.3 ("Linear-algebra utilities", anchor [R] pyamg/util/linalg.py).
All code here is written from scratch against the functional definitions in
the survey; nothing is copied from the reference (whose mount is empty).

The solve-phase device analogs live in :mod:`pyamg_tpu.engine`; these host
versions are the setup-phase workhorses (spectral-radius estimation drives
Jacobi/Chebyshev smoother scaling) and the golden references for tests.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.sparse as sp
from scipy.sparse.linalg import LinearOperator, aslinearoperator

__all__ = [
    "norm",
    "infinity_norm",
    "axpy",
    "approximate_spectral_radius",
    "condest",
    "cond",
    "ishermitian",
    "pinv_array",
]


def norm(x, pnorm="2"):
    """Vector norm.

    Equivalent of [R] pyamg/util/linalg.py::norm. ``pnorm`` may be '2',
    '1', 'inf', or a float p. Flattens the input. For complex input the
    2-norm uses conjugate inner products.
    """
    x = np.ravel(x)
    if pnorm == "2":
        # dot-based 2-norm (faster + matches reference semantics)
        return np.sqrt(np.inner(x.conj(), x).real)
    if pnorm == "1":
        return np.sum(np.abs(x))
    if pnorm in ("inf", np.inf):
        return np.max(np.abs(x))
    return np.sum(np.abs(x) ** float(pnorm)) ** (1.0 / float(pnorm))


def infinity_norm(A):
    """Infinity norm (max absolute row sum) of a sparse matrix.

    Equivalent of [R] pyamg/util/linalg.py::infinity_norm.
    """
    if sp.issparse(A):
        return max(abs(A).sum(axis=1).max(), 0.0)
    return np.max(np.sum(np.abs(np.asarray(A)), axis=1))


def axpy(x, y, a=1.0):
    """y += a*x in place."""
    y += a * x
    return y


def _as_operator(A):
    if sp.issparse(A):
        return A
    if isinstance(A, LinearOperator):
        return A
    return np.asarray(A)


def approximate_spectral_radius(
    A, tol=0.01, maxiter=15, restart=5, symmetric=None, initial_guess=None,
    return_vector=False,
):
    """Approximate the spectral radius of ``A`` with restarted Arnoldi/Lanczos.

    Equivalent of [R] pyamg/util/linalg.py::approximate_spectral_radius —
    the setup-phase workhorse used to scale Jacobi omega and Chebyshev
    intervals.  A cached value is stored on sparse inputs as ``A._rho`` so
    repeated smoother setup does not re-run Arnoldi (mirrors reference
    behavior).

    Parameters
    ----------
    A : sparse matrix / ndarray / LinearOperator, shape (n, n)
    tol : float
        Relative stopping tolerance between restarts.
    maxiter : int
        Arnoldi subspace dimension per restart.
    restart : int
        Number of restarts.
    symmetric : bool, optional
        Unused hint (Lanczos == Arnoldi numerically here); kept for API parity.

    Returns
    -------
    float (or (float, vec) when return_vector=True)
    """
    if not hasattr(A, "shape") or A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    cached = getattr(A, "_rho", None)
    if cached is not None and not return_vector:
        return cached

    n = A.shape[0]
    dtype = np.promote_types(getattr(A, "dtype", np.float64), np.float32)
    if dtype.kind in "iu":
        dtype = np.float64
    Aop = _as_operator(A)

    if n <= 2:
        Ad = Aop.toarray() if sp.issparse(Aop) else np.asarray(Aop)
        ev = scipy.linalg.eigvals(Ad)
        rho = float(np.max(np.abs(ev))) if ev.size else 0.0
        vec = np.ones((n,), dtype=dtype)
        if sp.issparse(A):
            try:
                A._rho = rho
            except AttributeError:
                pass
        return (rho, vec) if return_vector else rho

    rng = np.random.default_rng(3571)
    if initial_guess is None:
        v0 = rng.standard_normal(n).astype(dtype, copy=False)
        if np.issubdtype(dtype, np.complexfloating):
            v0 = v0 + 1j * rng.standard_normal(n).astype(dtype, copy=False)
    else:
        v0 = np.asarray(initial_guess, dtype=dtype).ravel().copy()

    rho_old = 0.0
    rho = 0.0
    ritz_vec = v0
    for _restart in range(max(restart, 1)):
        m = int(min(n, maxiter))
        V = np.zeros((m + 1, n), dtype=dtype)
        H = np.zeros((m + 1, m), dtype=dtype)
        beta = norm(v0)
        if beta == 0:
            v0 = rng.standard_normal(n).astype(dtype, copy=False)
            beta = norm(v0)
        V[0] = v0 / beta
        k_eff = m
        breakdown = False
        converged_inner = False
        for j in range(m):
            w = Aop @ V[j]
            w = np.asarray(w).ravel().astype(dtype, copy=False)
            # modified Gram-Schmidt (blocked inner products: one GEMV
            # against the stored basis instead of j+1 numpy passes)
            h = V[: j + 1].conj() @ w
            H[: j + 1, j] = h
            w -= h @ V[: j + 1]
            # second MGS pass for the tail only (re-orthogonalization)
            h2 = V[: j + 1].conj() @ w
            H[: j + 1, j] += h2
            w -= h2 @ V[: j + 1]
            hn = norm(w)
            H[j + 1, j] = hn
            if hn < 1e-12 * max(abs(H).max(), 1.0):
                k_eff = j + 1
                breakdown = True
                break
            V[j + 1] = w / hn
            # in-loop Ritz convergence ([R] upstream checks the residual
            # bound |h_{j+1,j} * y_m| each iteration): stop as soon as
            # the dominant Ritz value is resolved — saves most SpMVs on
            # the large fine levels
            if j >= 2:
                Hj = H[: j + 1, : j + 1]
                evj, evecj = scipy.linalg.eig(Hj)
                ij = int(np.argmax(np.abs(evj)))
                resid = abs(hn * evecj[-1, ij])
                rho_j = float(np.abs(evj[ij]))
                if rho_j > 0 and resid <= tol * rho_j:
                    k_eff = j + 1
                    converged_inner = True
                    break
        Hk = H[:k_eff, :k_eff]
        evals, evecs = scipy.linalg.eig(Hk)
        idx = int(np.argmax(np.abs(evals)))
        rho = float(np.abs(evals[idx]))
        y = evecs[:, idx]
        ritz_vec = (V[:k_eff].T @ y).ravel()
        v0 = np.ascontiguousarray(ritz_vec)
        if np.issubdtype(dtype, np.floating):
            v0 = np.real(v0).astype(dtype, copy=False)
        if breakdown or converged_inner or (
                rho_old > 0 and abs(rho - rho_old) <= tol * rho):
            break
        rho_old = rho

    if sp.issparse(A):
        try:
            A._rho = rho
        except AttributeError:
            pass
    if return_vector:
        return rho, ritz_vec
    return rho


def condest(A, maxiter=25, symmetric=False):
    """Rough 2-norm condition estimate via Arnoldi Ritz values.

    Equivalent of [R] pyamg/util/linalg.py::condest.
    """
    Ad = A.toarray() if sp.issparse(A) else np.asarray(A)
    ev = scipy.linalg.eigvals(Ad)
    ev = np.abs(ev)
    small = ev.min()
    if small == 0:
        return np.inf
    return float(ev.max() / small)


def cond(A):
    """Exact 2-norm condition number (dense; small matrices only)."""
    Ad = A.toarray() if sp.issparse(A) else np.asarray(A)
    s = scipy.linalg.svdvals(Ad)
    if s.min() == 0:
        return np.inf
    return float(s.max() / s.min())


def ishermitian(A, fast_check=True, tol=1e-6, verbose=False):
    """Test whether ``A`` is (numerically) Hermitian.

    Equivalent of [R] pyamg/util/linalg.py::ishermitian; the fast check
    compares ``x^H A y`` with ``conj(y^H A x)`` for random x, y instead of
    forming ``A - A^H``.
    """
    if A.shape[0] != A.shape[1]:
        return False
    anorm = infinity_norm(A) if sp.issparse(A) else np.abs(np.asarray(A)).max()
    if anorm == 0:
        return True
    if fast_check:
        rng = np.random.default_rng(17)
        x = rng.random(A.shape[0])
        y = rng.random(A.shape[0])
        if np.issubdtype(np.dtype(A.dtype), np.complexfloating):
            x = x + 1j * rng.random(A.shape[0])
            y = y + 1j * rng.random(A.shape[0])
        diff = np.abs(np.inner(x.conj(), A @ y) - np.conj(np.inner(y.conj(), A @ x)))
        scale = max(np.abs(np.inner(x.conj(), A @ y)), 1e-300)
        return bool(diff / scale < tol * max(anorm, 1.0))
    if sp.issparse(A):
        diff = (A - A.conjugate().T).tocoo()
        resid = np.abs(diff.data).max() if diff.nnz else 0.0
    else:
        Ad = np.asarray(A)
        resid = np.abs(Ad - Ad.conj().T).max()
    return bool(resid < tol * anorm)


def pinv_array(a, tol=None):
    """In-place batched pseudo-inverse of a stack of small dense matrices.

    Equivalent of [R] pyamg/util/linalg.py::pinv_array backed by
    amg_core/linalg.h::pinv_array (SURVEY.md §2.4); here implemented as a
    vectorized batched NumPy pinv.  ``a`` has shape (n, m, m) and is
    overwritten with pseudo-inverses.
    """
    a = np.asarray(a)
    if a.ndim != 3:
        raise ValueError("expected (n, m, m) array")
    m = a.shape[1]
    if m == 1:
        d = a[:, 0, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(d != 0, 1.0 / d, 0.0)
        a[:, 0, 0] = inv
        return a
    try:
        inv = np.linalg.pinv(a, rcond=1e-12 if tol is None else tol)
    except np.linalg.LinAlgError:
        inv = np.stack([np.linalg.pinv(ai) for ai in a])
    a[...] = inv
    return a

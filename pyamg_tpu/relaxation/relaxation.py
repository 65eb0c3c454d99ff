"""Stationary relaxation methods (host reference implementations).

Rebuild of [R] pyamg/relaxation/relaxation.py backed by
amg_core/relaxation.h (SURVEY.md §2.3 / §2.4).  These host versions have
*exact sequential semantics* (true lexicographic Gauss-Seidel etc.) and are
the golden references for the device smoothers in
:mod:`pyamg_tpu.engine.relaxation` (which use Jacobi/Chebyshev/multicolor
forms, the parallel equivalents named in BASELINE.json:2).

Sequential sweeps are expressed as sparse triangular solves:
forward GS:  (D + L) x_new = b - U x_old   — identical arithmetic to the
reference's row loop, but executed by compiled SciPy kernels.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve_triangular

from ..util.utils import conj_transpose_csr, get_block_diag, get_diagonal, upcast

__all__ = [
    "make_system",
    "jacobi",
    "weighted_jacobi",
    "gauss_seidel",
    "sor",
    "block_jacobi",
    "block_gauss_seidel",
    "polynomial",
    "gauss_seidel_indexed",
    "jacobi_indexed",
    "jacobi_ne",
    "gauss_seidel_ne",
    "gauss_seidel_nr",
    "schwarz",
    "cf_jacobi",
    "fc_jacobi",
    "cf_block_jacobi",
    "fc_block_jacobi",
]


def make_system(A, x, b, formats=None):
    """Validate and canonicalize a relaxation system (A, x, b).

    Rebuild of [R] pyamg/relaxation/relaxation.py::make_system: checks
    shapes/squareness, ravels x and b, upcasts dtypes, and converts A to an
    accepted sparse format.
    """
    if formats is None:
        pass
    elif formats == ["csr"]:
        if not (sp.issparse(A) and A.format == "csr"):
            A = sp.csr_matrix(A)
    else:
        if not (sp.issparse(A) and A.format in formats):
            A = sp.csr_matrix(A)
    if not sp.issparse(A):
        A = sp.csr_matrix(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    x = np.ravel(np.asarray(x))
    b = np.ravel(np.asarray(b))
    if x.shape[0] != A.shape[0] or b.shape[0] != A.shape[0]:
        raise ValueError("x and b must match dimensions of A")
    if upcast(A.dtype, x.dtype, b.dtype) != x.dtype:
        raise TypeError("x must have a dtype containing A and b dtypes")
    return A, x, b


# ---------------------------------------------------------------------------
# pointwise methods
# ---------------------------------------------------------------------------

def jacobi(A, x, b, iterations=1, omega=1.0):
    """Weighted Jacobi: x <- x + omega D^{-1} (b - A x), in place.

    [R] pyamg/relaxation/relaxation.py::jacobi (amg_core jacobi /
    bsr_jacobi).  BSR input uses the scalar diagonal (matching reference
    ``jacobi``; use :func:`block_jacobi` for block-diagonal weighting).
    """
    A, x, b = make_system(A, x, b, formats=None)
    Acsr = A.tocsr() if A.format != "csr" else A
    dinv = get_diagonal(Acsr, inv=True)
    one_minus = np.asarray(omega, dtype=x.dtype)
    for _ in range(int(iterations)):
        x += one_minus * (dinv * (b - Acsr @ x))
    return x


weighted_jacobi = jacobi


def _tri_parts(A, lower):
    """Cache (D+L) [or (D+U)] and the complementary strict triangle."""
    key = "_amg_tri_lower" if lower else "_amg_tri_upper"
    cached = getattr(A, key, None)
    if cached is not None:
        return cached
    Acsr = A.tocsr() if A.format != "csr" else A
    if lower:
        DL = sp.tril(Acsr, k=0, format="csr")
        U = sp.triu(Acsr, k=1, format="csr")
        pair = (DL, U)
    else:
        DU = sp.triu(Acsr, k=0, format="csr")
        L = sp.tril(Acsr, k=-1, format="csr")
        pair = (DU, L)
    try:
        setattr(A, key, pair)
    except AttributeError:
        pass
    return pair


def gauss_seidel(A, x, b, iterations=1, sweep="forward"):
    """Gauss-Seidel relaxation with exact sequential semantics, in place.

    [R] pyamg/relaxation/relaxation.py::gauss_seidel (amg_core
    gauss_seidel).  sweep in {'forward', 'backward', 'symmetric'}.
    """
    A, x, b = make_system(A, x, b, formats=["csr", "bsr"])
    if sweep not in ("forward", "backward", "symmetric"):
        raise ValueError("sweep must be forward/backward/symmetric")
    iters = int(iterations)
    if sweep == "symmetric":
        for _ in range(iters):
            gauss_seidel(A, x, b, iterations=1, sweep="forward")
            gauss_seidel(A, x, b, iterations=1, sweep="backward")
        return x
    lower = sweep == "forward"
    # native row-loop sweep when available (exact reference semantics);
    # fall back to the triangular-solve formulation otherwise
    _native = None
    if (A.format == "csr" and x.dtype == np.float64
            and not np.iscomplexobj(A.data)):
        try:
            from ..amg_core import gauss_seidel as _native
        except Exception:
            _native = None
    if _native is not None:
        n = A.shape[0]
        # cache the int64 index views on the matrix: the ctypes ABI takes
        # i64 and scipy stores i32, and re-upcasting 10M+ indices on every
        # sweep measurably drags SA setup (profiled: ~0.5 s of the
        # improve_candidates stage at 4.2M unknowns)
        cache = getattr(A, "_amgcore_i64", None)
        if cache is None or cache[0] is not A.indptr:
            cache = (A.indptr,
                     np.ascontiguousarray(A.indptr, dtype=np.int64),
                     np.ascontiguousarray(A.indices, dtype=np.int64))
            try:
                A._amgcore_i64 = cache
            except AttributeError:
                pass
        _, ip64, ix64 = cache
        for _ in range(iters):
            if lower:
                _native(ip64, ix64, A.data, x, b, 0, n, 1)
            else:
                _native(ip64, ix64, A.data, x, b, n - 1, -1, -1)
        return x
    Tri, Opp = _tri_parts(A, lower)
    for _ in range(iters):
        rhs = b - Opp @ x
        x[:] = spsolve_triangular(Tri, rhs, lower=lower, overwrite_b=True)
    return x


def sor(A, x, b, omega, iterations=1, sweep="forward"):
    """Successive over-relaxation, exact sequential semantics, in place.

    [R] pyamg/relaxation/relaxation.py::sor:
    (D/omega + L) x_new = b - (U - (1/omega - 1) D) x_old.
    """
    A, x, b = make_system(A, x, b, formats=["csr"])
    if sweep == "symmetric":
        for _ in range(int(iterations)):
            sor(A, x, b, omega, iterations=1, sweep="forward")
            sor(A, x, b, omega, iterations=1, sweep="backward")
        return x
    lower = sweep == "forward"
    Acsr = A.tocsr() if A.format != "csr" else A
    d = Acsr.diagonal()
    D = sp.dia_matrix((d.reshape(1, -1), [0]), shape=A.shape).tocsr()
    if lower:
        Tri = sp.tril(Acsr, k=-1, format="csr") + D.multiply(1.0 / omega)
        Opp = sp.triu(Acsr, k=1, format="csr") - (1.0 / omega - 1.0) * D
    else:
        Tri = sp.triu(Acsr, k=1, format="csr") + D.multiply(1.0 / omega)
        Opp = sp.tril(Acsr, k=-1, format="csr") - (1.0 / omega - 1.0) * D
    Tri = sp.csr_matrix(Tri)
    for _ in range(int(iterations)):
        rhs = b - Opp @ x
        x[:] = spsolve_triangular(Tri, rhs, lower=lower, overwrite_b=True)
    return x


# ---------------------------------------------------------------------------
# block methods
# ---------------------------------------------------------------------------

def _resolve_blocksize(A, blocksize):
    if blocksize is None:
        if sp.issparse(A) and A.format == "bsr":
            return A.blocksize[0]
        return 1
    return int(blocksize)


def block_jacobi(A, x, b, Dinv=None, blocksize=None, iterations=1, omega=1.0):
    """Block weighted Jacobi: x <- x + omega Dblk^{-1} (b - A x), in place.

    [R] pyamg/relaxation/relaxation.py::block_jacobi (amg_core block_jacobi).
    """
    A, x, b = make_system(A, x, b)
    bs = _resolve_blocksize(A, blocksize)
    if bs == 1:
        return jacobi(A, x, b, iterations=iterations, omega=omega)
    if Dinv is None:
        Dinv = get_block_diag(A, bs, inv_flag=True)
    Acsr = sp.csr_matrix(A)
    n_blocks = A.shape[0] // bs
    for _ in range(int(iterations)):
        r = (b - Acsr @ x).reshape(n_blocks, bs)
        x += omega * np.einsum("nij,nj->ni", Dinv, r).ravel()
    return x


def block_gauss_seidel(A, x, b, iterations=1, sweep="forward", blocksize=None,
                       Dinv=None):
    """Block Gauss-Seidel with exact sequential block semantics, in place.

    [R] pyamg/relaxation/relaxation.py::block_gauss_seidel (amg_core
    block_gauss_seidel).  Implemented as a block triangular solve:
    (Dblk + Lblk) x_new = b - Ublk x_old, with the block-diagonal solves
    applied via precomputed block inverses.
    """
    A, x, b = make_system(A, x, b)
    bs = _resolve_blocksize(A, blocksize)
    if bs == 1:
        return gauss_seidel(A, x, b, iterations=iterations, sweep=sweep)
    if sweep == "symmetric":
        for _ in range(int(iterations)):
            block_gauss_seidel(A, x, b, 1, "forward", bs, Dinv)
            block_gauss_seidel(A, x, b, 1, "backward", bs, Dinv)
        return x
    if Dinv is None:
        Dinv = get_block_diag(A, bs, inv_flag=True)
    Ab = A.tobsr(blocksize=(bs, bs)) if not (sp.issparse(A) and A.format == "bsr" and A.blocksize == (bs, bs)) else A
    n_blocks = A.shape[0] // bs
    indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
    lower = sweep == "forward"
    xb = x.reshape(n_blocks, bs)
    bb = b.reshape(n_blocks, bs)
    order = range(n_blocks) if lower else range(n_blocks - 1, -1, -1)
    for _ in range(int(iterations)):
        for i in order:
            s, e = indptr[i], indptr[i + 1]
            cols = indices[s:e]
            rsum = np.einsum("kij,kj->i", data[s:e], xb[cols])
            dmask = cols == i
            if dmask.any():
                rsum = rsum - data[s:e][dmask][0] @ xb[i]
            xb[i] = Dinv[i] @ (bb[i] - rsum)
    return x


# ---------------------------------------------------------------------------
# polynomial methods
# ---------------------------------------------------------------------------

def polynomial(A, x, b, coefficients, iterations=1):
    """Polynomial relaxation: x <- x + p(A) r via Horner on the residual.

    [R] pyamg/relaxation/relaxation.py::polynomial.  ``coefficients`` are
    the polynomial coefficients of p in *descending* order (reference
    convention); used with :mod:`pyamg_tpu.relaxation.chebyshev`.
    """
    A, x, b = make_system(A, x, b)
    for _ in range(int(iterations)):
        residual = b - A @ x
        h = coefficients[0] * residual
        for c in coefficients[1:]:
            h = c * residual + A @ h
        x += h
    return x


# ---------------------------------------------------------------------------
# indexed variants
# ---------------------------------------------------------------------------

def gauss_seidel_indexed(A, x, b, indices, iterations=1, sweep="forward"):
    """Gauss-Seidel over a custom index list, exact sequential order.

    [R] pyamg/relaxation/relaxation.py::gauss_seidel_indexed (amg_core
    gauss_seidel_indexed).  Small Python loop — used on index subsets
    (C/F sweeps); C++ fast path provided by pyamg_tpu.amg_core when built.
    """
    A, x, b = make_system(A, x, b, formats=["csr"])
    indices = np.asarray(indices, dtype=np.int64)
    if sweep == "symmetric":
        for _ in range(int(iterations)):
            gauss_seidel_indexed(A, x, b, indices, 1, "forward")
            gauss_seidel_indexed(A, x, b, indices, 1, "backward")
        return x
    order = indices if sweep == "forward" else indices[::-1]
    try:
        from ..amg_core import gauss_seidel_indexed as _native
    except Exception:
        _native = None
    for _ in range(int(iterations)):
        if _native is not None:
            _native(A.indptr, A.indices, A.data, x, b, order)
            continue
        indptr, cols, data = A.indptr, A.indices, A.data
        for i in order:
            s, e = indptr[i], indptr[i + 1]
            row_cols = cols[s:e]
            row_data = data[s:e]
            diag = 0.0
            rsum = 0.0
            dmask = row_cols == i
            diag = row_data[dmask].sum()
            rsum = np.inner(row_data, x[row_cols]) - diag * x[i]
            if diag != 0:
                x[i] = (b[i] - rsum) / diag
    return x


def jacobi_indexed(A, x, b, indices, iterations=1, omega=1.0):
    """Weighted Jacobi applied only at ``indices`` rows, in place.

    [R] pyamg/relaxation/relaxation.py::jacobi_indexed.
    """
    A, x, b = make_system(A, x, b, formats=["csr"])
    indices = np.asarray(indices, dtype=np.int64)
    dinv = get_diagonal(A, inv=True)
    for _ in range(int(iterations)):
        r = b[indices] - (A[indices] @ x)
        x[indices] += omega * (dinv[indices] * r)
    return x


# ---------------------------------------------------------------------------
# normal-equation variants (nonsymmetric / least squares)
# ---------------------------------------------------------------------------

def jacobi_ne(A, x, b, iterations=1, omega=1.0):
    """Jacobi on the normal equations A A^H y = b (Cimmino-like), in place.

    [R] pyamg/relaxation/relaxation.py::jacobi_ne (amg_core jacobi_ne):
    x <- x + omega A^H D^{-1} (b - A x) with D = diag(A A^H).
    """
    A, x, b = make_system(A, x, b, formats=["csr"])
    d = get_diagonal(A, norm_eq=2, inv=True)  # diag of A A^H, inverted
    AH = conj_transpose_csr(A)
    for _ in range(int(iterations)):
        x += omega * (AH @ (d * (b - A @ x)))
    return x


def gauss_seidel_ne(A, x, b, iterations=1, sweep="forward", omega=1.0):
    """Gauss-Seidel on the normal equations A A^H (Kaczmarz), in place.

    [R] pyamg/relaxation/relaxation.py::gauss_seidel_ne (amg_core
    gauss_seidel_ne): sequential row projections
    x <- x + omega * (b_i - A_i x)/||A_i||^2 * A_i^H.
    """
    A, x, b = make_system(A, x, b, formats=["csr"])
    indptr, cols, data = A.indptr, A.indices, A.data
    row_norms = np.asarray(A.multiply(A.conjugate()).sum(axis=1)).ravel().real
    n = A.shape[0]
    if sweep == "symmetric":
        for _ in range(int(iterations)):
            gauss_seidel_ne(A, x, b, 1, "forward", omega)
            gauss_seidel_ne(A, x, b, 1, "backward", omega)
        return x
    order = range(n) if sweep == "forward" else range(n - 1, -1, -1)
    try:
        from ..amg_core import gauss_seidel_ne as _native
    except Exception:
        _native = None
    for _ in range(int(iterations)):
        if _native is not None:
            _native(indptr, cols, data, x, b, row_norms,
                    1 if sweep == "forward" else -1, float(omega))
            continue
        for i in order:
            s, e = indptr[i], indptr[i + 1]
            if row_norms[i] == 0:
                continue
            ri = b[i] - np.inner(data[s:e], x[cols[s:e]])
            x[cols[s:e]] += omega * (ri / row_norms[i]) * np.conjugate(data[s:e])
    return x


def gauss_seidel_nr(A, x, b, iterations=1, sweep="forward", omega=1.0):
    """Gauss-Seidel on the normal equations A^H A (column action), in place.

    [R] pyamg/relaxation/relaxation.py::gauss_seidel_nr (amg_core
    gauss_seidel_nr): sequential column corrections minimizing the
    residual along each column of A.
    """
    A, x, b = make_system(A, x, b, formats=["csr"])
    Acsc = A.tocsc()
    indptr, rows, data = Acsc.indptr, Acsc.indices, Acsc.data
    col_norms = np.asarray(A.multiply(A.conjugate()).sum(axis=0)).ravel().real
    n = A.shape[1]
    if sweep == "symmetric":
        for _ in range(int(iterations)):
            gauss_seidel_nr(A, x, b, 1, "forward", omega)
            gauss_seidel_nr(A, x, b, 1, "backward", omega)
        return x
    order = range(n) if sweep == "forward" else range(n - 1, -1, -1)
    r = np.ascontiguousarray(b - A @ x)
    _native = None
    if x.dtype == np.float64 and not np.iscomplexobj(data):
        try:
            from ..amg_core import gauss_seidel_nr as _native
        except Exception:
            _native = None
    for _ in range(int(iterations)):
        if _native is not None and x.flags.c_contiguous:
            _native(indptr, rows, data, x, r, col_norms,
                    1 if sweep == "forward" else -1, float(omega))
            continue
        for j in order:
            s, e = indptr[j], indptr[j + 1]
            if col_norms[j] == 0:
                continue
            delta = omega * np.inner(np.conjugate(data[s:e]), r[rows[s:e]]) / col_norms[j]
            x[j] += delta
            r[rows[s:e]] -= delta * data[s:e]
    return x


# ---------------------------------------------------------------------------
# Schwarz
# ---------------------------------------------------------------------------

def schwarz_parameters(A, subdomain=None, subdomain_ptr=None,
                       inv_subblock=None, inv_subblock_ptr=None):
    """Compute (and cache on A) overlapping Schwarz subdomains + inverses.

    [R] pyamg/relaxation/relaxation.py::schwarz_parameters: default
    subdomain for row i is its neighborhood (pattern of row i); the dense
    subblocks A[sub, sub] are pseudo-inverted up front.
    """
    cached = getattr(A, "_amg_schwarz", None)
    if cached is not None and subdomain is None:
        return cached
    Acsr = sp.csr_matrix(A)
    if subdomain is None or subdomain_ptr is None:
        subdomain_ptr = Acsr.indptr.copy()
        subdomain = Acsr.indices.copy()
    if inv_subblock is None or inv_subblock_ptr is None:
        n_dom = len(subdomain_ptr) - 1
        sizes = np.diff(subdomain_ptr)
        inv_subblock_ptr = np.zeros(n_dom + 1, dtype=np.int64)
        np.cumsum(sizes ** 2, out=inv_subblock_ptr[1:])
        inv_subblock = np.zeros(inv_subblock_ptr[-1], dtype=Acsr.dtype)
        Ad = None
        for i in range(n_dom):
            idx = subdomain[subdomain_ptr[i]: subdomain_ptr[i + 1]]
            block = Acsr[idx][:, idx].toarray()
            inv = np.linalg.pinv(block)
            inv_subblock[inv_subblock_ptr[i]: inv_subblock_ptr[i + 1]] = inv.ravel()
    params = (subdomain, subdomain_ptr, inv_subblock, inv_subblock_ptr)
    try:
        A._amg_schwarz = params
    except AttributeError:
        pass
    return params


def schwarz(A, x, b, iterations=1, subdomain=None, subdomain_ptr=None,
            inv_subblock=None, inv_subblock_ptr=None, sweep="forward"):
    """Overlapping multiplicative Schwarz relaxation, in place.

    [R] pyamg/relaxation/relaxation.py::schwarz (amg_core
    overlapping_schwarz_csr): sequentially solve each subdomain's dense
    subproblem against the current residual.
    """
    A, x, b = make_system(A, x, b, formats=["csr"])
    subdomain, subdomain_ptr, inv_subblock, inv_subblock_ptr = schwarz_parameters(
        A, subdomain, subdomain_ptr, inv_subblock, inv_subblock_ptr
    )
    n_dom = len(subdomain_ptr) - 1
    if sweep == "symmetric":
        for _ in range(int(iterations)):
            schwarz(A, x, b, 1, subdomain, subdomain_ptr, inv_subblock,
                    inv_subblock_ptr, "forward")
            schwarz(A, x, b, 1, subdomain, subdomain_ptr, inv_subblock,
                    inv_subblock_ptr, "backward")
        return x
    order = range(n_dom) if sweep == "forward" else range(n_dom - 1, -1, -1)
    for _ in range(int(iterations)):
        for i in order:
            idx = subdomain[subdomain_ptr[i]: subdomain_ptr[i + 1]]
            m = len(idx)
            inv = inv_subblock[inv_subblock_ptr[i]: inv_subblock_ptr[i + 1]].reshape(m, m)
            r = b[idx] - (A[idx] @ x)
            x[idx] += inv @ r
    return x


# ---------------------------------------------------------------------------
# C/F ordered Jacobi (AIR smoothers)
# ---------------------------------------------------------------------------

def _indexed_jacobi_pass(A, x, b, idx, dinv, omega, iterations):
    for _ in range(int(iterations)):
        r = b[idx] - (A[idx] @ x)
        x[idx] += omega * (dinv[idx] * r)


def cf_jacobi(A, x, b, Cpts, Fpts, iterations=1, f_iterations=1,
              c_iterations=1, omega=1.0):
    """C-then-F ordered Jacobi ([R] relaxation.py::cf_jacobi, AIR smoother)."""
    A, x, b = make_system(A, x, b, formats=["csr"])
    Cpts = np.asarray(Cpts, dtype=np.int64)
    Fpts = np.asarray(Fpts, dtype=np.int64)
    dinv = get_diagonal(A, inv=True)
    for _ in range(int(iterations)):
        _indexed_jacobi_pass(A, x, b, Cpts, dinv, omega, c_iterations)
        _indexed_jacobi_pass(A, x, b, Fpts, dinv, omega, f_iterations)
    return x


def fc_jacobi(A, x, b, Cpts, Fpts, iterations=1, f_iterations=1,
              c_iterations=1, omega=1.0):
    """F-then-C ordered Jacobi ([R] relaxation.py::fc_jacobi — the AIR
    default postsmoother, SURVEY.md §2.2)."""
    A, x, b = make_system(A, x, b, formats=["csr"])
    Cpts = np.asarray(Cpts, dtype=np.int64)
    Fpts = np.asarray(Fpts, dtype=np.int64)
    dinv = get_diagonal(A, inv=True)
    for _ in range(int(iterations)):
        _indexed_jacobi_pass(A, x, b, Fpts, dinv, omega, f_iterations)
        _indexed_jacobi_pass(A, x, b, Cpts, dinv, omega, c_iterations)
    return x


def _indexed_block_jacobi_pass(Acsr, x, b, idx, Dinv, bs, omega, iterations):
    for _ in range(int(iterations)):
        rows = (idx[:, None] * bs + np.arange(bs)[None, :]).ravel()
        r = (b[rows] - (Acsr[rows] @ x)).reshape(len(idx), bs)
        x[rows] += omega * np.einsum("nij,nj->ni", Dinv[idx], r).ravel()


def cf_block_jacobi(A, x, b, Cpts, Fpts, blocksize=None, iterations=1,
                    f_iterations=1, c_iterations=1, omega=1.0):
    """Block C-then-F Jacobi ([R] relaxation.py::cf_block_jacobi)."""
    A, x, b = make_system(A, x, b)
    bs = _resolve_blocksize(A, blocksize)
    Dinv = get_block_diag(A, bs, inv_flag=True)
    Acsr = sp.csr_matrix(A)
    Cpts = np.asarray(Cpts, dtype=np.int64)
    Fpts = np.asarray(Fpts, dtype=np.int64)
    for _ in range(int(iterations)):
        _indexed_block_jacobi_pass(Acsr, x, b, Cpts, Dinv, bs, omega, c_iterations)
        _indexed_block_jacobi_pass(Acsr, x, b, Fpts, Dinv, bs, omega, f_iterations)
    return x


def fc_block_jacobi(A, x, b, Cpts, Fpts, blocksize=None, iterations=1,
                    f_iterations=1, c_iterations=1, omega=1.0):
    """Block F-then-C Jacobi ([R] relaxation.py::fc_block_jacobi)."""
    A, x, b = make_system(A, x, b)
    bs = _resolve_blocksize(A, blocksize)
    Dinv = get_block_diag(A, bs, inv_flag=True)
    Acsr = sp.csr_matrix(A)
    Cpts = np.asarray(Cpts, dtype=np.int64)
    Fpts = np.asarray(Fpts, dtype=np.int64)
    for _ in range(int(iterations)):
        _indexed_block_jacobi_pass(Acsr, x, b, Fpts, Dinv, bs, omega, f_iterations)
        _indexed_block_jacobi_pass(Acsr, x, b, Cpts, Dinv, bs, omega, c_iterations)
    return x

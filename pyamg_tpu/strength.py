"""Strength-of-connection measures (setup phase, host side).

Rebuild of [R] pyamg/strength.py (SURVEY.md §2.3).  All measures
are implemented as vectorized NumPy/SciPy passes over CSR rows — the direct
analog of the rowwise amg_core kernels (classical_strength_of_connection_abs
/ _min, symmetric_strength_of_connection, maximum_row_value; SURVEY.md §2.4
ruge_stuben.h) with no per-element Python loops.

Every measure returns a CSR matrix S with the *same shape* as A whose
pattern marks strong connections; data holds the (positive) strength
measure, row-scaled so each row's largest entry is 1 (reference
convention).  Diagonal entries are kept (value 1 after scaling) —
downstream splitting/aggregation ignore self-loops explicitly.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .util.utils import blocksize, scale_rows_by_largest_entry
from .util.linalg import approximate_spectral_radius

__all__ = [
    "classical_strength_of_connection",
    "symmetric_strength_of_connection",
    "evolution_strength_of_connection",
    "energy_based_strength_of_connection",
    "distance_strength_of_connection",
    "algebraic_distance",
    "affinity_distance",
    "relaxation_vectors",
]


def _block_amalgamate(A, norm="fro"):
    """Collapse a BSR matrix to scalar CSR of block norms."""
    A = A.tobsr() if A.format != "bsr" else A
    bs_r, bs_c = A.blocksize
    n = A.shape[0] // bs_r
    m = A.shape[1] // bs_c
    if norm == "abs":
        vals = np.abs(A.data).max(axis=(1, 2))
    elif norm == "min":
        vals = A.data.min(axis=(1, 2))
    else:  # 'fro'
        vals = np.sqrt((np.abs(A.data) ** 2).sum(axis=(1, 2)))
    return sp.csr_matrix((vals, A.indices.copy(), A.indptr.copy()), shape=(n, m))


def _row_reduce(data, indptr, nrows, op, empty=0.0):
    """Per-row reduction over CSR data (vectorized via ufunc.reduceat)."""
    out = np.full(nrows, empty, dtype=data.dtype if data.size else np.float64)
    nz = np.diff(indptr) > 0
    if data.size:
        out[nz] = op.reduceat(data, indptr[:-1][nz])
    return out


def classical_strength_of_connection(A, theta=0.25, block=True, norm="abs"):
    """Classical Ruge-Stuben strength of connection.

    Rebuild of [R] pyamg/strength.py::classical_strength_of_connection
    (amg_core classical_strength_of_connection_abs/_min).

    norm='abs':  j strong for i  iff  |A_ij| >= theta * max_{k != i} |A_ik|
    norm='min':  j strong for i  iff  -A_ij  >= theta * max_{k != i} (-A_ik)
      (only negative couplings count — the AIR default, SURVEY.md §2.2).
    """
    if sp.issparse(A) and A.format == "bsr" and block:
        if A.blocksize == (1, 1):
            A = A.tocsr()
            S = classical_strength_of_connection(A, theta, block=False, norm=norm)
            return S
        Asc = _block_amalgamate(A, norm="fro" if norm == "fro" else "abs")
        return classical_strength_of_connection(Asc, theta, block=False, norm="abs")

    A = sp.csr_matrix(A)
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    offdiag = A.indices != rows

    if norm == "min":
        measure = np.where(offdiag, -np.real(A.data), 0.0)
        measure = np.maximum(measure, 0.0)
    else:
        measure = np.where(offdiag, np.abs(A.data), 0.0)

    rowmax = _row_reduce(measure, A.indptr, n, np.maximum)
    strong = (measure >= theta * rowmax[rows]) & (measure > 0) & offdiag
    keep = strong | ~offdiag  # keep diagonal
    data = np.where(offdiag, measure, 0.0)

    S = sp.csr_matrix(
        (data[keep], A.indices[keep], _recount_indptr(keep, A.indptr, n)),
        shape=A.shape,
    )
    # give diagonal entries weight so they survive row scaling as 1 later;
    # first scale off-diagonals, then set diagonal to the max (=1 post-scale)
    S = scale_rows_by_largest_entry(S)
    S = _set_diagonal_to(S, 1.0)
    return S


def _recount_indptr(keep, indptr, n):
    # reduceat only at nonempty rows: an empty trailing row would put
    # indptr[i] == len(keep) in the offset list, which reduceat rejects
    # (and empty mid-rows would alias the next row's first element).
    nz = np.diff(indptr) > 0
    counts = np.zeros(n, np.int64)
    if keep.size and nz.any():
        counts[nz] = np.add.reduceat(keep.astype(np.int64), indptr[:-1][nz])
    new_indptr = np.zeros(n + 1, dtype=indptr.dtype)
    np.cumsum(counts, out=new_indptr[1:])
    return new_indptr


def _set_diagonal_to(S, value):
    S = S.tocsr()
    n = S.shape[0]
    rows = np.repeat(np.arange(n), np.diff(S.indptr))
    diag_mask = S.indices == rows
    if np.count_nonzero(diag_mask) == n:
        # every diagonal entry stored: set in place (the sparse-add
        # fallback below costs two format conversions + a full SpAdd)
        S.data[diag_mask] = value
        return S
    d = S.diagonal()
    S = S + sp.dia_matrix(((value - d).reshape(1, -1), [0]), shape=S.shape)
    S = S.tocsr()
    S.sort_indices()
    return S


def symmetric_strength_of_connection(A, theta=0):
    """Symmetric strength: |A_ij| >= theta * sqrt(|A_ii| * |A_jj|).

    Rebuild of [R] pyamg/strength.py::symmetric_strength_of_connection
    (amg_core symmetric_strength_of_connection, SURVEY.md §2.4
    smoothed_aggregation.h).  theta=0 keeps the full pattern (the SA
    default).  BSR input is amalgamated by block Frobenius norm.
    """
    if theta < 0:
        raise ValueError("expected theta >= 0")
    if sp.issparse(A) and A.format == "bsr" and A.blocksize != (1, 1):
        Asc = _block_amalgamate(A, norm="fro")
        # block norms are all >= 0; diagonal blocks give the scaling
        return symmetric_strength_of_connection(Asc, theta)

    A = sp.csr_matrix(A)
    n = A.shape[0]

    if not np.iscomplexobj(A.data):
        try:
            from .amg_core import symmetric_strength as _native
        except ImportError:
            _native = None
        if _native is not None:
            data_out, keep, n_diag = _native(A.indptr, A.indices, A.data,
                                             theta)
            if n_diag == n:       # every diagonal stored: single pass
                if theta == 0:
                    # COPY the structure arrays: S aliasing A's indices
                    # corrupts A when a downstream sort_indices() on S
                    # reorders the shared array without A's data
                    # (observed: level-1 RAP output is unsorted, and the
                    # aliased sort silently destroyed A1)
                    return sp.csr_matrix(
                        (data_out, A.indices.copy(), A.indptr.copy()),
                        shape=A.shape)
                kb = keep.view(bool)
                return sp.csr_matrix(
                    (data_out[kb], A.indices[kb],
                     _recount_indptr(kb, A.indptr, n)), shape=A.shape)
            # rows without stored diagonal: vectorized fallback below

    if theta == 0:
        # SA-default fast path: |A| row-scaled with unit diagonal, built
        # in three passes over data with no intermediate matrices
        indptr = A.indptr
        data = np.abs(A.data)
        rowmax = _row_reduce(data, indptr, n, np.maximum)
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = np.where(rowmax != 0, 1.0 / rowmax, 0.0)
        data *= np.repeat(scale, np.diff(indptr))
        S = sp.csr_matrix((data, A.indices.copy(), indptr.copy()),
                          shape=A.shape)
        return _set_diagonal_to(S, 1.0)
    d = np.abs(A.diagonal())
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    offdiag = A.indices != rows
    thresh = theta * np.sqrt(d[rows] * d[A.indices])
    strong = (np.abs(A.data) >= thresh) & offdiag
    keep = strong | ~offdiag
    data = np.where(offdiag, np.abs(A.data), 0.0)
    S = sp.csr_matrix(
        (data[keep], A.indices[keep], _recount_indptr(keep, A.indptr, n)),
        shape=A.shape,
    )
    S = scale_rows_by_largest_entry(S)
    return _set_diagonal_to(S, 1.0)


def distance_strength_of_connection(A, V, theta=2.0, relative_drop=True):
    """Distance-based strength from vertex coordinates V.

    Rebuild of [R] pyamg/strength.py::distance_strength_of_connection.
    Connection (i, j) is strong when dist(i, j) <= theta (absolute) or
    dist(i, j) <= theta * min_k dist(i, k) (relative).  Returned measure is
    inverse distance, row-scaled to max 1.
    """
    A = sp.csr_matrix(A) if A.format != "bsr" else _block_amalgamate(A)
    V = np.asarray(V, dtype=np.float64)
    if V.shape[0] != A.shape[0]:
        raise ValueError("coordinate count must match matrix dimension")
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    dist = np.sqrt(((V[rows] - V[cols]) ** 2).sum(axis=1))
    offdiag = rows != cols
    if relative_drop:
        big = np.where(offdiag, dist, np.inf)
        rowmin = _row_reduce(big, A.indptr, n, np.minimum, empty=np.inf)
        keep = offdiag & (dist <= theta * rowmin[rows])
    else:
        keep = offdiag & (dist <= theta)
    with np.errstate(divide="ignore"):
        inv = np.where(dist > 0, 1.0 / np.maximum(dist, 1e-300), 0.0)
    data = np.where(keep, inv, 0.0)
    keep_all = keep | ~offdiag
    S = sp.csr_matrix(
        (data[keep_all], cols[keep_all], _recount_indptr(keep_all, A.indptr, n)),
        shape=(n, n),
    )
    S = scale_rows_by_largest_entry(S)
    return _set_diagonal_to(S, 1.0)


def relaxation_vectors(A, R, k, alpha):
    """R test vectors relaxed k times with weighted Jacobi on A x = 0.

    Rebuild of [R] pyamg/strength.py::relaxation_vectors — the shared
    helper behind algebraic/affinity distance.
    """
    A = sp.csr_matrix(A)
    n = A.shape[0]
    rng = np.random.default_rng(7)
    x = rng.random((n, R)) - 0.5
    d = A.diagonal()
    with np.errstate(divide="ignore", invalid="ignore"):
        dinv = np.where(d != 0, 1.0 / d, 0.0)
    for _ in range(k):
        x = x - alpha * (dinv[:, None] * (A @ x))
    return x


def algebraic_distance(A, alpha=0.5, R=5, k=20, theta=0.1, p=2):
    """Algebraic-distance strength measure.

    Rebuild of [R] pyamg/strength.py::algebraic_distance:
    d_ij = (sum_r |x_r(i) - x_r(j)|^p)^(1/p) over relaxed test vectors;
    strength = 1/d, with entries dropped below theta * row max.
    """
    A = sp.csr_matrix(A) if A.format != "bsr" else _block_amalgamate(A)
    x = relaxation_vectors(A, R, k, alpha)
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    diff = np.abs(x[rows] - x[cols])
    if p == np.inf:
        d = diff.max(axis=1)
    else:
        d = (diff ** p).sum(axis=1) ** (1.0 / p)
    return _drop_by_inverse_measure(A, rows, cols, d, theta)


def affinity_distance(A, alpha=0.5, R=5, k=20, theta=0.1):
    """Affinity-distance strength measure.

    Rebuild of [R] pyamg/strength.py::affinity_distance:
    affinity c_ij = |<x_i, x_j>|^2 / (<x_i, x_i> <x_j, x_j>); distance is
    1/c; entries dropped below theta * row max of the strength 1/d.
    """
    A = sp.csr_matrix(A) if A.format != "bsr" else _block_amalgamate(A)
    x = relaxation_vectors(A, R, k, alpha)
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    num = (x[rows] * x[cols]).sum(axis=1) ** 2
    den = (x[rows] ** 2).sum(axis=1) * (x[cols] ** 2).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(den > 0, num / den, 0.0)
        d = np.where(c > 0, 1.0 / c, np.inf)
    return _drop_by_inverse_measure(A, rows, cols, d, theta)


def _drop_by_inverse_measure(A, rows, cols, d, theta):
    n = A.shape[0]
    offdiag = rows != cols
    with np.errstate(divide="ignore"):
        strength = np.where((d > 0) & np.isfinite(d), 1.0 / np.maximum(d, 1e-300), 0.0)
    strength = np.where(offdiag, strength, 0.0)
    rowmax = _row_reduce(strength, A.indptr, n, np.maximum)
    keep = offdiag & (strength >= theta * rowmax[rows]) & (strength > 0)
    keep_all = keep | ~offdiag
    data = np.where(keep, strength, 0.0)
    S = sp.csr_matrix(
        (data[keep_all], cols[keep_all], _recount_indptr(keep_all, A.indptr, n)),
        shape=(n, n),
    )
    S = scale_rows_by_largest_entry(S)
    return _set_diagonal_to(S, 1.0)


def _incomplete_mat_mult(X, Y, pattern):
    """(X @ Y) restricted to the sparsity pattern of ``pattern``.

    Reference counterpart: amg_core incomplete_mat_mult_csr (SURVEY.md
    §2.4 evolution_strength.h).  Computed as the scipy product masked to
    the pattern — numerically identical entries, traded for scipy's C
    SpGEMM speed (the full product of evolution operators has bounded
    fill: ~(2k+1)^d entries/row on stencil graphs).
    """
    full = sp.csr_matrix(X @ Y)
    mask = sp.csr_matrix(
        (np.ones(pattern.nnz), pattern.indices, pattern.indptr),
        shape=pattern.shape)
    out = sp.csr_matrix(full.multiply(mask))
    # multiply() drops pattern entries where the product is exactly 0;
    # that is fine for a strength measure (a zero entry is a zero entry)
    out.sort_indices()
    return out


def evolution_strength_of_connection(
    A, B=None, epsilon=4.0, k=2, proj_type="l2", symmetrize_measure=True,
    weighting="diagonal",
):
    """Evolution (ODE-based) strength of connection — exact algorithm.

    Rebuild of [R] pyamg/strength.py::evolution_strength_of_connection
    (Olson, Schroder, Tuminaro, "A new perspective on strength measures
    in algebraic multigrid", 2010; amg_core evolution_strength_helper +
    incomplete_mat_mult_csr + min_blocks, SURVEY.md:128, :159).

    Algorithm (scalar level; BSR input is handled by running the scalar
    problem and amalgamating with per-block minimum at the end):

    1. ``S = I - (1/rho(D^-1 A)) D^-1 A`` — one step of the scaled time
       evolution operator (data-dependent dt = 1/rho).
    2. ``Atilde = S^k`` with the FINAL product restricted to the pattern
       of A via incomplete (masked) SpGEMM: full squarings for the first
       floor(log2 k)-1 doublings, masked product last, then masked
       incremental products for any non-power-of-two remainder.  Each
       row i of Atilde is the evolved delta function delta_i sampled on
       A's pattern.
    3. Constrained least-squares measure against the near-nullspace B
       (the "angle" measure): for each row i with pattern J and evolved
       values z, solve

           min_a sum_{j in J} w_j |B[j]·a − z_j|^2   s.t.  B[i]·a = z_i

       with w_j = 1 (proj_type='l2') or |A_jj| (proj_type='D_A'); the
       DISTANCE of connection (i,j) is d_ij = |B[j]·a − z_j| (small =
       strong; d_ii = 0 by the constraint).
    4. ``symmetrize_measure``: d <- (d + d^T)/2 elementwise.
    5. BSR: amalgamate the scalar DISTANCES with per-block MINIMUM
       (min_blocks): a block connection is as strong (small-distance)
       as its strongest stored scalar entry; absent entries are inf.
    6. Drop weak entries: keep j with d_ij <= epsilon * min_{l != i}
       d_il (epsilon >= 1; the apply_distance_filter semantics).
    7. Invert surviving distances (large = strong), scale each row by
       its largest entry, set the diagonal to 1.
    """
    if epsilon < 1:
        raise ValueError("expected epsilon >= 1 (drop relative to row min)")
    if k < 1:
        raise ValueError("expected k >= 1 time steps")
    bs = blocksize(A)
    Acsr = sp.csr_matrix(A)
    # BSR->CSR conversion stores the zero-padding inside blocks; those are
    # not connections and must not enter the evolution pattern
    Acsr.eliminate_zeros()
    Acsr.sort_indices()
    n = Acsr.shape[0]
    if B is None:
        B = np.ones((n, 1), dtype=float)
    B = np.asarray(B, dtype=float)
    if B.ndim == 1:
        B = B.reshape(-1, 1)
    nb = B.shape[1]

    # --- 1-2: evolved deltas on A's pattern ---------------------------
    d = Acsr.diagonal()
    with np.errstate(divide="ignore", invalid="ignore"):
        dinv = np.where(d != 0, 1.0 / d, 0.0)
    DinvA = sp.csr_matrix(Acsr.multiply(dinv[:, None]))
    rho = approximate_spectral_radius(DinvA)
    if rho == 0:
        rho = 1.0
    S = sp.identity(n, format="csr", dtype=np.float64) - (
        1.0 / rho) * DinvA.real.astype(np.float64)

    nsquare = int(np.log2(k)) if k > 1 else 0
    ninc = k - 2 ** nsquare
    Atilde = S
    if nsquare > 0:
        for _ in range(nsquare - 1):
            Atilde = sp.csr_matrix(Atilde @ Atilde)
        Atilde = _incomplete_mat_mult(Atilde, Atilde, Acsr)
    for _ in range(ninc):
        Atilde = _incomplete_mat_mult(Atilde, S, Acsr)
    if k == 1:
        Atilde = _incomplete_mat_mult(
            Atilde, sp.identity(n, format="csr"), Acsr)
    Atilde.sort_indices()

    # --- 3: constrained LS distance measure ---------------------------
    indptr = Atilde.indptr
    cols = Atilde.indices
    z = np.real(Atilde.data).astype(np.float64)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    if proj_type == "D_A":
        w_all = np.abs(d).astype(np.float64)
    else:
        w_all = np.ones(n)
    Wv = w_all[cols]

    Bc = B[cols]                                    # (nnz, nb)
    # per-row G = sum_j w_j B_j B_j^T and g = sum_j w_j B_j z_j
    contrib_G = (Wv[:, None, None] * Bc[:, :, None] * Bc[:, None, :])
    contrib_g = Wv[:, None] * Bc * z[:, None]
    nz = np.diff(indptr) > 0
    G = np.zeros((n, nb, nb))
    g = np.zeros((n, nb))
    if len(cols) and nz.any():
        starts = indptr[:-1][nz]
        G[nz] = np.add.reduceat(contrib_G, starts, axis=0)
        g[nz] = np.add.reduceat(contrib_g, starts, axis=0)

    # KKT system for the exact-at-i constraint B[i]·a = z_i
    diag_entry = np.zeros(n)
    is_diag = rows == cols
    diag_entry[rows[is_diag]] = z[is_diag]
    K = np.zeros((n, nb + 1, nb + 1))
    K[:, :nb, :nb] = G
    K[:, :nb, nb] = B
    K[:, nb, :nb] = B
    rhs = np.concatenate([g, diag_entry[:, None]], axis=1)
    # batched pseudo-inverse: the KKT system goes singular whenever the
    # candidate columns are linearly dependent on a small neighborhood
    # (common for rigid-body modes near boundaries); pinv gives the
    # deterministic min-norm fit there
    sol = np.einsum("nij,nj->ni", np.linalg.pinv(K), rhs)
    alpha = sol[:, :nb]

    fit = np.einsum("ek,ek->e", Bc, alpha[rows])
    dist = np.abs(fit - z)
    dist[is_diag] = 0.0

    Dm = sp.csr_matrix((dist, cols.copy(), indptr.copy()), shape=(n, n))

    # --- 4: symmetrize the measure ------------------------------------
    if symmetrize_measure:
        Dm = sp.csr_matrix(0.5 * (Dm + Dm.T))
        Dm.sort_indices()

    # --- 5: BSR amalgamation by per-block MINIMUM distance (min_blocks):
    # a block connection is as strong as its strongest scalar entry;
    # absent scalar entries inside a stored block count as inf, NOT 0
    if bs > 1:
        present = sp.csr_matrix(
            (np.ones(Dm.nnz), Dm.indices, Dm.indptr), shape=Dm.shape)
        Db = Dm.tobsr(blocksize=(bs, bs))
        Pb = present.tobsr(blocksize=(bs, bs))
        blockdist = np.where(Pb.data > 0, Db.data, np.inf).min(axis=(1, 2))
        n = n // bs
        Dm = sp.csr_matrix(
            (blockdist, Db.indices, Db.indptr), shape=(n, n))
        Dm.sort_indices()

    # --- 6: epsilon drop relative to the row minimum ------------------
    indptr = Dm.indptr
    cols = Dm.indices
    dist = Dm.data
    rows = np.repeat(np.arange(n), np.diff(indptr))
    offdiag = rows != cols
    big = np.where(offdiag, dist, np.inf)
    big = np.where(big > 0, big, np.inf)   # exact fits count as strongest
    rowmin = _row_reduce(big, indptr, n, np.minimum, empty=np.inf)
    finite_min = np.where(np.isfinite(rowmin), rowmin, 0.0)
    keep = (offdiag & np.isfinite(dist)
            & (dist <= epsilon * np.maximum(finite_min[rows], 1e-300)))

    # --- 7: invert, scale, unit diagonal ------------------------------
    with np.errstate(divide="ignore"):
        strength = np.where(keep, 1.0 / np.maximum(dist, 1e-14), 0.0)
    keep_all = keep | ~offdiag
    S_sc = sp.csr_matrix(
        (strength[keep_all], cols[keep_all],
         _recount_indptr(keep_all, indptr, n)),
        shape=(n, n))
    S_sc = scale_rows_by_largest_entry(S_sc)
    return _set_diagonal_to(S_sc, 1.0)


def energy_based_strength_of_connection(A, theta=0.0, k=2):
    """Energy-based strength of connection.

    Rebuild of [R] pyamg/strength.py::energy_based_strength_of_connection.
    Approximates, for each connection (i, j), how much energy is lost when
    the delta function at j is approximated within row i's neighborhood
    after ``k`` weighted-Jacobi iterations on A z = 0 restricted to the
    pattern of A — a cheaper cousin of the evolution measure.
    """
    A = sp.csr_matrix(A) if A.format != "bsr" else _block_amalgamate(A)
    n = A.shape[0]
    d = A.diagonal()
    with np.errstate(divide="ignore", invalid="ignore"):
        dinv = np.where(d != 0, 1.0 / d, 0.0)
    DinvA = sp.csr_matrix(A.multiply(dinv[:, None]))
    rho = approximate_spectral_radius(DinvA)
    omega = 1.0 / max(rho, 1e-300)
    # Z approximates A^{-1} restricted to pattern: k Jacobi sweeps on AZ=I
    Z = sp.identity(n, format="csr", dtype=np.float64) .multiply(dinv[:, None])
    Z = sp.csr_matrix(Z)
    pattern = sp.csr_matrix((np.ones(A.nnz), A.indices, A.indptr), shape=A.shape)
    for _ in range(k):
        Znew = Z + omega * sp.csr_matrix((sp.identity(n, format="csr") - A @ Z).multiply(dinv[:, None]))
        Z = sp.csr_matrix(Znew.multiply(pattern))  # masked (incomplete) product
    # strength = |Z_ij| scaled by sqrt(Z_ii Z_jj)
    rows = np.repeat(np.arange(n), np.diff(Z.indptr))
    cols = Z.indices
    zd = np.abs(Z.diagonal())
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = np.sqrt(np.maximum(zd[rows] * zd[cols], 1e-300))
        measure = np.abs(Z.data) / denom
    offdiag = rows != cols
    rowmax = _row_reduce(np.where(offdiag, measure, 0.0), Z.indptr, n, np.maximum)
    keep = offdiag & (measure >= theta * rowmax[rows]) & (measure > 0)
    keep_all = keep | ~offdiag
    data = np.where(keep, measure, 0.0)
    S = sp.csr_matrix(
        (data[keep_all], cols[keep_all], _recount_indptr(keep_all, Z.indptr, n)),
        shape=(n, n),
    )
    S = scale_rows_by_largest_entry(S)
    return _set_diagonal_to(S, 1.0)

"""General sparse/plumbing utilities (host side).

Rebuild of [R] pyamg/util/utils.py (SURVEY.md §2.3, "General
utilities").  Written from scratch against the survey's functional
definitions; vectorized NumPy/SciPy throughout (no per-element Python).

These run in the setup phase on the host.  The solve-phase device engine
(:mod:`pyamg_tpu.engine`) consumes their outputs as padded device buffers.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from .linalg import approximate_spectral_radius, norm, pinv_array

__all__ = [
    "set_tol",
    "upcast",
    "to_type",
    "asfptype",
    "diag_sparse",
    "get_diagonal",
    "get_block_diag",
    "scale_rows",
    "scale_columns",
    "symmetric_rescaling",
    "symmetric_rescaling_sa",
    "amalgamate",
    "unamal",
    "filter_matrix_rows",
    "filter_matrix_columns",
    "truncate_rows",
    "eliminate_diag_dom_nodes",
    "remove_diagonal",
    "scale_rows_by_largest_entry",
    "levelize_strength_or_aggregation",
    "levelize_smooth_or_improve_candidates",
    "blocksize",
    "get_Cpt_params",
    "scale_T",
    "compute_BtBinv",
    "filter_operator",
    "profile_solver",
    "galerkin_product",
]


def galerkin_product(R, A, P):
    """A_c = R @ A @ P through the native parallel SpGEMM when available
    (the SA/classical setup hot spot, SURVEY.md §3.1); scipy otherwise.

    CSR inputs, CSR output with sorted row indices (native) or scipy's
    ordering (fallback)."""
    import scipy.sparse as _sp

    A = _sp.csr_matrix(A)
    R = _sp.csr_matrix(R)
    P = _sp.csr_matrix(P)
    if not any(np.iscomplexobj(M.data) for M in (R, A, P)):
        try:
            from ..amg_core import spgemm as _spgemm
        except ImportError:
            _spgemm = None
        if _spgemm is not None:
            AP = _spgemm(A, P)
            if AP is not None:
                Ac = _spgemm(R, AP)
                if Ac is not None:
                    return Ac
    return _sp.csr_matrix(R @ (A @ P))


def set_tol(dtype):
    """Numerical drop tolerance for a dtype ([R] pyamg/util/utils.py::set_tol)."""
    dtype = np.dtype(dtype)
    if dtype in (np.float64, np.complex128):
        return 1e-12
    if dtype in (np.float32, np.complex64):
        return 1e-6
    raise ValueError(f"tolerance undefined for dtype {dtype}")


def upcast(*dtypes):
    """Smallest float/complex type containing all arguments."""
    result = np.dtype(np.float32)
    for t in dtypes:
        result = np.promote_types(result, np.dtype(t))
    if result.kind not in "fc":
        result = np.dtype(np.float64)
    return result


def to_type(upcast_type, varlist):
    """Cast each array in ``varlist`` to ``upcast_type`` (no copies if same)."""
    return [np.asarray(v, dtype=upcast_type) for v in varlist]


def asfptype(A):
    """Upcast sparse matrix to a floating-point dtype if needed."""
    if np.dtype(A.dtype).kind in "fc":
        return A
    return A.astype(np.float64)


def blocksize(A):
    """Row blocksize of A (1 unless BSR)."""
    if sp.issparse(A) and A.format == "bsr":
        return A.blocksize[0]
    return 1


def diag_sparse(A):
    """If A is sparse return its diagonal; if A is a vector return spdiags.

    [R] pyamg/util/utils.py::diag_sparse.
    """
    if sp.issparse(A):
        return A.diagonal()
    a = np.asarray(A).ravel()
    return sp.dia_matrix((a.reshape(1, -1), [0]), shape=(len(a), len(a))).tocsr()


def get_diagonal(A, norm_eq=False, inv=False):
    """Diagonal of A, A^H A (norm_eq=1) or A A^H (norm_eq=2); optionally inverted.

    [R] pyamg/util/utils.py::get_diagonal.
    """
    if norm_eq in (1, True):
        d = np.asarray(A.multiply(A.conjugate()).sum(axis=0)).ravel()
    elif norm_eq == 2:
        d = np.asarray(A.multiply(A.conjugate()).sum(axis=1)).ravel()
    else:
        d = A.diagonal()
    if np.iscomplexobj(d) and norm_eq:
        d = d.real
    if inv:
        with np.errstate(divide="ignore", invalid="ignore"):
            dinv = np.where(d != 0, 1.0 / d, 0.0)
        return dinv.astype(upcast(A.dtype))
    return d


def get_block_diag(A, blocksize, inv_flag=True):
    """Block diagonal of A as (n/bs, bs, bs) array, optionally inverted.

    [R] pyamg/util/utils.py::get_block_diag.  Vectorized: extracts each
    (i, i) block from CSR/BSR via fancy indexing; inversion is a batched
    pseudo-inverse (amg_core pinv_array analog, SURVEY.md §2.4 linalg.h).
    """
    if A.shape[0] % blocksize != 0:
        raise ValueError("matrix dimension must be divisible by blocksize")
    nblocks = A.shape[0] // blocksize
    if sp.issparse(A) and A.format == "bsr" and A.blocksize == (blocksize, blocksize):
        Ab = A
    else:
        Ab = sp.csr_matrix(A).tobsr(blocksize=(blocksize, blocksize))
    out = np.zeros((nblocks, blocksize, blocksize), dtype=Ab.dtype)
    indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
    # find diagonal block in each block-row (vectorized over present blocks)
    rows = np.repeat(np.arange(nblocks), np.diff(indptr))
    mask = indices == rows
    out[rows[mask]] = data[mask]
    if inv_flag:
        pinv_array(out)
    return out


def scale_rows(A, v, copy=True):
    """Scale row i of A by v[i] ([R] pyamg/util/utils.py::scale_rows)."""
    v = np.ravel(np.asarray(v))
    if sp.issparse(A):
        A = A.tocsr(copy=copy) if A.format != "csr" else (A.copy() if copy else A)
        if len(v) != A.shape[0]:
            raise ValueError("vector length must match rows of A")
        reps = np.diff(A.indptr)
        A.data *= np.repeat(v, reps)
        return A
    A = np.array(A, copy=copy)
    return v[:, None] * A


def scale_columns(A, v, copy=True):
    """Scale column j of A by v[j] ([R] pyamg/util/utils.py::scale_columns)."""
    v = np.ravel(np.asarray(v))
    if sp.issparse(A):
        A = A.tocsr(copy=copy) if A.format != "csr" else (A.copy() if copy else A)
        if len(v) != A.shape[1]:
            raise ValueError("vector length must match columns of A")
        A.data *= v[A.indices]
        return A
    A = np.array(A, copy=copy)
    return A * v[None, :]


def symmetric_rescaling(A, copy=True):
    """Return (D_sqrt, D_sqrt_inv, D^{-1/2} A D^{-1/2}).

    [R] pyamg/util/utils.py::symmetric_rescaling.
    """
    d = np.abs(A.diagonal())
    D_sqrt = np.sqrt(d)
    with np.errstate(divide="ignore", invalid="ignore"):
        D_sqrt_inv = np.where(D_sqrt != 0, 1.0 / D_sqrt, 0.0)
    DAD = scale_rows(scale_columns(A, D_sqrt_inv, copy=copy), D_sqrt_inv, copy=False)
    return D_sqrt, D_sqrt_inv, DAD


def symmetric_rescaling_sa(A, B, BH=None):
    """Symmetrically rescale A and transform candidates B accordingly.

    [R] pyamg/util/utils.py::symmetric_rescaling_sa.
    """
    D_sqrt, D_sqrt_inv, DAD = symmetric_rescaling(A)
    B = D_sqrt[:, None] * np.asarray(B)
    if BH is not None:
        BH = D_sqrt[:, None] * np.asarray(BH)
    return DAD, B, BH


def amalgamate(A, bs):
    """Collapse bs×bs blocks of A to scalars (nonzero block -> 1).

    [R] pyamg/util/utils.py::amalgamate.
    """
    if bs == 1:
        return A
    Ab = sp.csr_matrix(A).tobsr(blocksize=(bs, bs))
    n = Ab.shape[0] // bs
    data = np.ones(Ab.indices.shape[0], dtype=A.dtype)
    return sp.csr_matrix((data, Ab.indices.copy(), Ab.indptr.copy()), shape=(n, Ab.shape[1] // bs))


def unamal(A, rows_per_block, cols_per_block):
    """Expand scalar sparsity of A into dense blocks of ones (UnAmal).

    [R] pyamg/util/utils.py::UnAmal.
    """
    A = sp.csr_matrix(A)
    data = np.ones((A.nnz, rows_per_block, cols_per_block), dtype=A.dtype)
    return sp.bsr_matrix(
        (data, A.indices, A.indptr),
        shape=(rows_per_block * A.shape[0], cols_per_block * A.shape[1]),
    ).tocsr()


def remove_diagonal(A):
    """Return A with zeroed diagonal (pattern removed)."""
    A = sp.csr_matrix(A)
    D = sp.dia_matrix((A.diagonal().reshape(1, -1), [0]), shape=A.shape)
    C = (A - D).tocsr()
    C.eliminate_zeros()
    return C


def scale_rows_by_largest_entry(A):
    """Scale each row of A by its largest-magnitude entry.

    [R] pyamg/util/utils.py::scale_rows_by_largest_entry (used by strength
    measures to normalize S).
    """
    A = sp.csr_matrix(A)
    nnz_per_row = np.diff(A.indptr)
    absdata = np.abs(A.data)
    rowmax = np.zeros(A.shape[0], dtype=absdata.dtype)
    nz_rows = nnz_per_row > 0
    if A.nnz:
        rowmax[nz_rows] = np.maximum.reduceat(absdata, A.indptr[:-1][nz_rows])
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(rowmax != 0, 1.0 / rowmax, 0.0)
    return scale_rows(A, scale, copy=True)


def filter_matrix_rows(A, theta, diagonal=False, lump=False):
    """Drop entries |A_ij| < theta * max_{k != i} |A_ik| per row.

    [R] pyamg/util/utils.py::filter_matrix_rows.  With ``lump`` the dropped
    mass is added to the diagonal; with ``diagonal`` the diagonal is exempt
    from filtering.
    """
    A = sp.csr_matrix(A, copy=True)
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    offdiag = A.indices != rows
    absdata = np.where(offdiag, np.abs(A.data), 0.0)
    rowmax = np.zeros(A.shape[0])
    nz = np.diff(A.indptr) > 0
    if A.nnz:
        rowmax[nz] = np.maximum.reduceat(absdata, A.indptr[:-1][nz])
    weak = (np.abs(A.data) < theta * rowmax[rows]) & offdiag
    if lump:
        lumped = np.zeros(A.shape[0], dtype=A.dtype)
        np.add.at(lumped, rows[weak], A.data[weak])
    A.data[weak] = 0
    A.eliminate_zeros()
    if lump:
        A = A + sp.dia_matrix((lumped.reshape(1, -1), [0]), shape=A.shape)
        A = A.tocsr()
    return A


def filter_matrix_columns(A, theta):
    """Column analog of :func:`filter_matrix_rows`."""
    return filter_matrix_rows(A.T.tocsr(), theta).T.tocsr()


def truncate_rows(A, nz_per_row):
    """Keep only the ``nz_per_row`` largest-magnitude entries of each row.

    [R] pyamg/util/utils.py::truncate_rows (amg_core truncate_rows_csr
    analog, SURVEY.md §2.4).
    """
    A = sp.csr_matrix(A, copy=True)
    n = A.shape[0]
    indptr = A.indptr
    keep = np.zeros(A.nnz, dtype=bool)
    lens = np.diff(indptr)
    # vectorized per-row top-k via argpartition on padded magnitude matrix
    for i in np.flatnonzero(lens > nz_per_row):
        s, e = indptr[i], indptr[i + 1]
        idx = np.argpartition(np.abs(A.data[s:e]), lens[i] - nz_per_row)
        keep[s + idx[lens[i] - nz_per_row:]] = True
    small = lens <= nz_per_row
    for i in np.flatnonzero(small):
        keep[indptr[i]: indptr[i + 1]] = True
    A.data[~keep] = 0
    A.eliminate_zeros()
    return A


def eliminate_diag_dom_nodes(A, C, theta=1.02):
    """Remove strongly diagonally dominant rows/cols from strength graph C.

    [R] pyamg/util/utils.py::eliminate_diag_dom_nodes: node i is dominant if
    A_ii > theta * (sum_j |A_ij| - |A_ii|); dominant nodes become isolated
    in C so they are not aggregated (handled well by relaxation alone).
    """
    A = sp.csr_matrix(A) if A.format != "bsr" else A
    bs = blocksize(A)
    Asc = sp.csr_matrix(A) if bs == 1 else amalgamate(A, bs).tocsr()
    d = np.abs(Asc.diagonal())
    rowsum = np.asarray(np.abs(Asc).sum(axis=1)).ravel() - d
    dom = d > theta * np.maximum(rowsum, 1e-300)
    keep = ~dom
    C = sp.csr_matrix(C, copy=True)
    mask_rows = keep[np.repeat(np.arange(C.shape[0]), np.diff(C.indptr))]
    mask_cols = keep[C.indices]
    rows_all = np.repeat(np.arange(C.shape[0]), np.diff(C.indptr))
    diag_entries = rows_all == C.indices
    C.data *= np.where((mask_rows & mask_cols) | diag_entries, 1.0, 0.0)
    C.eliminate_zeros()
    return C


def levelize_strength_or_aggregation(to_levelize, max_levels, max_coarse):
    """Normalize a strength/aggregate spec into a per-level list.

    [R] pyamg/util/utils.py::levelize_strength_or_aggregation.  Accepts
    'name', ('name', kwargs), None, or a list of those; 'predefined' specs
    pin max_levels.
    Returns (max_levels, max_coarse, levelized_list).
    """
    if isinstance(to_levelize, tuple):
        if to_levelize[0] == "predefined":
            to_levelize = [to_levelize]
            max_levels = 2
            max_coarse = 0
        else:
            to_levelize = [to_levelize for _ in range(max_levels - 1)]
    elif isinstance(to_levelize, str):
        if to_levelize == "predefined":
            raise ValueError("predefined requires a tuple with the operators")
        to_levelize = [to_levelize for _ in range(max_levels - 1)]
    elif to_levelize is None:
        to_levelize = [(None, {}) for _ in range(max_levels - 1)]
    elif isinstance(to_levelize, list):
        if isinstance(to_levelize[-1], tuple) and to_levelize[-1][0] == "predefined":
            max_levels = len(to_levelize) + 1
            max_coarse = 0
        else:
            if len(to_levelize) < max_levels - 1:
                mini = to_levelize[-1]
                to_levelize.extend(
                    [mini for _ in range(max_levels - 1 - len(to_levelize))]
                )
        to_levelize = [(lvl, {}) if lvl is None else lvl for lvl in to_levelize]
    else:
        raise ValueError(f"invalid spec: {to_levelize}")
    return max_levels, max_coarse, to_levelize


def levelize_smooth_or_improve_candidates(to_levelize, max_levels):
    """Normalize a smooth/improve_candidates spec into a per-level list.

    [R] pyamg/util/utils.py::levelize_smooth_or_improve_candidates.
    """
    if isinstance(to_levelize, tuple) and not (
        len(to_levelize) and isinstance(to_levelize[0], str)
    ):
        # tuple-of-specs, e.g. (('block_gauss_seidel', {...}), None):
        # treat as a per-level list (reference default convention)
        to_levelize = list(to_levelize)
    if isinstance(to_levelize, (str, tuple)):
        return [to_levelize for _ in range(max_levels)]
    if to_levelize is None:
        return [None for _ in range(max_levels)]
    if isinstance(to_levelize, list):
        if len(to_levelize) < max_levels:
            to_levelize.extend(
                [to_levelize[-1] for _ in range(max_levels - len(to_levelize))]
            )
        return to_levelize
    raise ValueError(f"invalid spec: {to_levelize}")


# ---------------------------------------------------------------------------
# Rootnode helpers
# ---------------------------------------------------------------------------

def get_Cpt_params(A, Cnodes, AggOp, T):
    """Return rootnode bookkeeping operators.

    [R] pyamg/util/utils.py::get_Cpt_params.  Given root C-nodes (one per
    aggregate), builds:

    - ``'P_I'``  : (n, ncoarse) injection, identity block at each C-point row
    - ``'I_F'``  : (n, n) identity restricted to F-point dofs
    - ``'I_C'``  : (n, n) identity restricted to C-point dofs
    - ``'Cpts'`` : C-point dof indices
    - ``'Fpts'`` : F-point dof indices
    """
    bs = blocksize(A)
    Cnodes = np.asarray(Cnodes, dtype=np.int64)
    n = A.shape[0]
    ncoarse = T.shape[1]
    n_agg = AggOp.shape[1]
    if ncoarse % n_agg != 0:
        raise ValueError("T column count must be a multiple of #aggregates")
    k = ncoarse // n_agg          # candidates per aggregate
    if k > bs:
        raise ValueError(
            f"rootnode requires #candidates ({k}) <= blocksize ({bs}); "
            "truncate B first")
    # each aggregate's root node owns its k coarse dofs (first k dofs of
    # the root node's block)
    Cpts = (bs * Cnodes[:, None] + np.arange(k)[None, :]).ravel()
    mask = np.zeros(n, dtype=bool)
    mask[Cpts] = True
    Fpts = np.flatnonzero(~mask)

    cols = (np.arange(n_agg)[:, None] * k + np.arange(k)[None, :]).ravel()
    rows = (bs * Cnodes[:, None] + np.arange(k)[None, :]).ravel()
    P_I = sp.csr_matrix(
        (np.ones(len(rows), dtype=T.dtype), (rows, cols)), shape=(n, ncoarse)
    )
    I_F = sp.csr_matrix(
        (np.ones(len(Fpts), dtype=T.dtype), (Fpts, Fpts)), shape=(n, n)
    )
    I_C = sp.csr_matrix(
        (np.ones(len(Cpts), dtype=T.dtype), (Cpts, Cpts)), shape=(n, n)
    )
    return {"P_I": P_I, "I_F": I_F, "I_C": I_C, "Cpts": Cpts, "Fpts": Fpts}


def scale_T(T, P_I, I_F):
    """Scale tentative prolongator so C-point rows are identity.

    [R] pyamg/util/utils.py::scale_T: with T the tentative prolongator and
    P_I injection at root nodes, compute ``T <- I_F T (P_I^T T)^{-1} + P_I``
    where ``P_I^T T`` is the (block-diagonal) restriction of T to root rows.
    """
    T = sp.csr_matrix(T)
    ncoarse = T.shape[1]
    Tc = sp.coo_matrix(P_I.T @ T)  # (ncoarse, ncoarse), block diagonal
    # Tc is block diagonal with k x k blocks (k = candidates/aggregate):
    # invert batched (amg_core pinv_array analog)
    if Tc.nnz == 0:
        return T
    # infer k: largest block extent where row//k == col//k for all entries
    k = 1
    while k < 8 and not (Tc.row // k == Tc.col // k).all():
        k += 1
    if not (Tc.row // k == Tc.col // k).all():
        # irregular structure: fall back to sparse triangular-ish solve
        import scipy.sparse.linalg as spla

        Tcinv = sp.csr_matrix(np.linalg.pinv(Tc.toarray()))
        out = ((I_F @ T) @ Tcinv + P_I).tocsr()
        out.eliminate_zeros()
        return out
    nb = ncoarse // k
    blocks = np.zeros((nb, k, k), dtype=T.dtype)
    blocks[Tc.row // k, Tc.row % k, Tc.col % k] = Tc.data
    pinv_array(blocks)
    rows = (np.arange(nb)[:, None, None] * k + np.arange(k)[None, :, None])
    cols = (np.arange(nb)[:, None, None] * k + np.arange(k)[None, None, :])
    rows = np.broadcast_to(rows, (nb, k, k)).ravel()
    cols = np.broadcast_to(cols, (nb, k, k)).ravel()
    Tcinv = sp.csr_matrix((blocks.ravel(), (rows, cols)),
                          shape=(ncoarse, ncoarse))
    out = ((I_F @ T) @ Tcinv + P_I).tocsr()
    out.eliminate_zeros()
    return out


def compute_BtBinv(B, C):
    """Batched (B_i^H B_i)^{-1} over the neighborhood of each row of C.

    [R] pyamg/util/utils.py::compute_BtBinv: for each row i of sparsity
    matrix C, gather the rows of B indexed by the column pattern of row i
    and pseudo-invert the little Gram matrix.  Used by energy-minimization
    prolongation smoothing and filter_operator.  Vectorized via padding to
    the max row degree.
    """
    B = np.asarray(B)
    if B.ndim == 1:
        B = B.reshape(-1, 1)
    k = B.shape[1]
    C = sp.csr_matrix(C)
    nrows = C.shape[0]
    lens = np.diff(C.indptr)
    maxlen = int(lens.max()) if nrows else 0
    # padded neighbor index matrix; pad with 0 + zero-mask
    pad_idx = np.zeros((nrows, maxlen), dtype=np.int64)
    mask = np.arange(maxlen)[None, :] < lens[:, None]
    if C.nnz:
        pad_idx[mask] = C.indices
    Bn = B[pad_idx]                      # (nrows, maxlen, k)
    Bn = np.where(mask[:, :, None], Bn, 0)
    G = np.einsum("rmk,rml->rkl", Bn.conj(), Bn)  # (nrows, k, k)
    pinv_array(G)
    return G


def filter_operator(A, C, B, Bf, BtBinv=None):
    """Filter A to sparsity C while preserving A @ B = Bf row-wise.

    [R] pyamg/util/utils.py::filter_operator: restrict each row of A to the
    pattern of C, then add a least-squares row correction so that the mode
    interpolation constraint ``(A B)_i = (Bf)_i`` still holds.  Used by
    rootnode to filter the prolongator.
    """
    A = sp.csr_matrix(A, copy=True)
    C = sp.csr_matrix(C)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B.reshape(-1, 1)
    Bf = np.asarray(Bf)
    if Bf.ndim == 1:
        Bf = Bf.reshape(-1, 1)
    # restrict A to pattern of C
    pattern = C.copy()
    pattern.data = np.ones_like(pattern.data)
    A = A.multiply(pattern).tocsr()
    A.sort_indices()
    if BtBinv is None:
        BtBinv = compute_BtBinv(B, A)
    # row-wise correction: for row i with pattern J_i,
    #   r_i = Bf[i] - A[i,J] B[J]  ;  dA[i,J] = r_i (BtBinv_i B[J]^H)
    lens = np.diff(A.indptr)
    maxlen = int(lens.max()) if A.shape[0] else 0
    mask = np.arange(maxlen)[None, :] < lens[:, None]
    pad_idx = np.zeros((A.shape[0], maxlen), dtype=np.int64)
    pad_val = np.zeros((A.shape[0], maxlen), dtype=A.dtype)
    if A.nnz:
        pad_idx[mask] = A.indices
        pad_val[mask] = A.data
    Bn = np.where(mask[:, :, None], B[pad_idx], 0)      # (n, m, k)
    AB = np.einsum("nm,nmk->nk", pad_val, Bn)            # current A B rows
    r = Bf - AB                                          # residual (n, k)
    corr = np.einsum("nk,nkl,nml->nm", r, BtBinv, Bn.conj())
    pad_val = pad_val + np.where(mask, corr, 0)
    if A.nnz:
        A.data = pad_val[mask]
    A.eliminate_zeros()
    return A


def profile_solver(ml, accel=None, **kwargs):
    """Estimate work-per-digit-of-accuracy for a multilevel solver.

    [R] pyamg/util/utils.py::profile_solver: solve with a random RHS,
    return cycle complexity divided by digits gained per iteration.
    """
    A = ml.levels[0].A
    rng = np.random.default_rng(42)
    b = A @ rng.random(A.shape[0])
    residuals = []
    if accel is None:
        ml.solve(b, residuals=residuals, **kwargs)
    else:
        ml.solve(b, residuals=residuals, accel=accel, **kwargs)
    residuals = np.asarray(residuals)
    if len(residuals) < 2 or residuals[0] == 0:
        return np.inf
    factor = (residuals[-1] / residuals[0]) ** (1.0 / (len(residuals) - 1))
    if factor >= 1.0:
        return np.inf
    return ml.cycle_complexity() / (-np.log10(factor))


def conj_transpose_csr(M):
    """M^H as CSR without the gratuitous conjugate COPY on real data.

    ``M.conjugate()`` always copies nnz-sized arrays in scipy; on real
    matrices the conjugate is the identity, and at multi-million nnz the
    copies measurably dominate SA setup (profiled: 2.7 s of 11 s at 4.2M
    unknowns).  Reference counterpart: the P.H / A.H products in [R]
    pyamg/aggregation/aggregation.py::_extend_hierarchy.
    """
    import numpy as np
    import scipy.sparse as sp

    M = M if sp.issparse(M) else sp.csr_matrix(M)
    if np.iscomplexobj(M.data):
        return M.conjugate().T.tocsr()
    return M.T.tocsr()

"""Classical interpolation operators + approximate ideal restriction.

Rebuild of [R] pyamg/classical/interpolate.py (SURVEY.md §2.2)
backed by amg_core rs_direct_interpolation_pass1/2,
rs_classical_interpolation_pass1/2, one_point_interpolation, and
approx_ideal_restriction_pass1/2 (§2.4 ruge_stuben.h / air.h).

Direct interpolation is fully vectorized (two-pass symbolic/numeric as
masked reductions); classical/distance-two run a per-F-row pass (host
setup; the C++ extension accelerates when built); local AIR batches the
per-row dense solves by neighborhood size (the §2.4 air.h plan:
"per-F-row batched dense solves, pad to max neighborhood").
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..strength import _recount_indptr
from .split import C_NODE, F_NODE

__all__ = [
    "direct_interpolation",
    "classical_interpolation",
    "distance_two_interpolation",
    "injection_interpolation",
    "one_point_interpolation",
    "local_air",
]


def _coarse_index_map(splitting):
    splitting = np.asarray(splitting)
    cmap = -np.ones(len(splitting), dtype=np.int64)
    cpts = np.flatnonzero(splitting == C_NODE)
    cmap[cpts] = np.arange(len(cpts))
    return cmap, cpts


def _strong_pattern(C):
    C = sp.csr_matrix(C)
    C = C.copy()
    C.setdiag(0)
    C.eliminate_zeros()
    C.sort_indices()
    return C


def direct_interpolation(A, C, splitting):
    """Direct interpolation (separate +/- coupling sums).

    Rebuild of [R] pyamg/classical/interpolate.py::direct_interpolation:
    for an F point i with strong C neighbors j,

        w_ij = -(alpha_i * a_ij) / a_ii        (a_ij < 0)
        w_ij = -(beta_i  * a_ij) / a_ii        (a_ij > 0)

    alpha_i = sum of all negative off-diagonal a_ik over the sum of
    negative strong-C a_ij (beta likewise for positive); when a row has
    no positive strong-C entries the positive mass is lumped onto the
    diagonal.  C rows are identity.  Fully vectorized.
    """
    A = sp.csr_matrix(A)
    S = _strong_pattern(C)
    splitting = np.asarray(splitting)
    n = A.shape[0]
    cmap, cpts = _coarse_index_map(splitting)
    nc = len(cpts)

    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    offd = A.indices != rows
    a = A.data
    isC = splitting[A.indices] == C_NODE
    # mark strong entries of A by membership in S's pattern
    strong = _pattern_membership(A, S)
    strongC = strong & isC & offd

    neg = offd & (np.real(a) < 0)
    pos = offd & (np.real(a) > 0)

    def rowsum(mask):
        out = np.zeros(n, dtype=A.dtype)
        np.add.at(out, rows[mask], a[mask])
        return out

    sum_neg_all = rowsum(neg)
    sum_pos_all = rowsum(pos)
    sum_neg_sc = rowsum(neg & strongC)
    sum_pos_sc = rowsum(pos & strongC)

    diag = A.diagonal().astype(A.dtype).copy()
    # lump positive mass into the diagonal when no positive strong-C
    no_pos_sc = sum_pos_sc == 0
    diag = diag + np.where(no_pos_sc, sum_pos_all, 0)

    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = np.where(sum_neg_sc != 0, sum_neg_all / np.where(
            sum_neg_sc == 0, 1, sum_neg_sc), 0)
        beta = np.where(sum_pos_sc != 0, sum_pos_all / np.where(
            sum_pos_sc == 0, 1, sum_pos_sc), 0)
        inv_diag = np.where(diag != 0, 1.0 / np.where(diag == 0, 1, diag), 0)

    coef = np.where(neg, alpha[rows], np.where(pos, beta[rows], 0))
    w = -coef * a * inv_diag[rows]

    isF_row = splitting[rows] == F_NODE
    keep = strongC & isF_row & (w != 0)
    P_rows = rows[keep]
    P_cols = cmap[A.indices[keep]]
    P_vals = w[keep]
    # C rows: identity
    P_rows = np.concatenate([P_rows, cpts])
    P_cols = np.concatenate([P_cols, cmap[cpts]])
    P_vals = np.concatenate([P_vals, np.ones(nc, dtype=A.dtype)])
    P = sp.csr_matrix((P_vals, (P_rows, P_cols)), shape=(n, nc))
    P.sort_indices()
    return P


def _pattern_membership(A, S):
    """Boolean mask over A.data: entry also present in S's pattern
    (vectorized via flattened (row, col) key matching)."""
    A = sp.csr_matrix(A)
    S = sp.csr_matrix(S)
    n = A.shape[1]
    rowsA = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                      np.diff(A.indptr))
    rowsS = np.repeat(np.arange(S.shape[0], dtype=np.int64),
                      np.diff(S.indptr))
    keysA = rowsA * n + A.indices
    keysS = rowsS * n + S.indices
    return np.isin(keysA, keysS, assume_unique=False)


def classical_interpolation(A, C, splitting, modified=True):
    """Classical (Ruge-Stuben) interpolation with F-F distribution.

    Rebuild of [R] pyamg/classical/interpolate.py::classical_interpolation
    (amg_core rs_classical_interpolation_pass1/2).  For F point i:

        w_ij = -(a_ij + sum_{m in Fs_i} a_im a_mj / d_m) / d_i
        d_m  = sum_{k in C_i} a_mk     (distribution denominator)
        d_i  = a_ii + sum over weak neighbors a_in (lumped)

    ``modified=True`` drops strong F-F connections without a common C
    point into the diagonal (the robust default).
    """
    A = sp.csr_matrix(A)
    A.sort_indices()
    S = _strong_pattern(C)
    splitting = np.asarray(splitting)
    n = A.shape[0]
    cmap, cpts = _coarse_index_map(splitting)
    nc = len(cpts)
    strong = _pattern_membership(A, S)

    if not np.iscomplexobj(A.data):
        try:
            from ..amg_core import rs_classical_interpolation as _native
        except Exception:
            _native = None
        if _native is not None:
            return _native(A.indptr, A.indices, A.data, strong, splitting,
                           cmap, nc, modified=modified)

    indptr, indices, a = A.indptr, A.indices, A.data

    P_rows, P_cols, P_vals = [], [], []
    for i in range(n):
        if splitting[i] == C_NODE:
            P_rows.append(np.array([i]))
            P_cols.append(np.array([cmap[i]]))
            P_vals.append(np.ones(1, dtype=A.dtype))
            continue
        s0, s1 = indptr[i], indptr[i + 1]
        cols = indices[s0:s1]
        vals = a[s0:s1]
        stg = strong[s0:s1]
        isdiag = cols == i
        isC = splitting[cols] == C_NODE
        isF = (splitting[cols] == F_NODE) & ~isdiag
        Ci = cols[stg & isC]
        if len(Ci) == 0:
            # no strong C neighbors: zero row (handled by smoothing)
            continue
        Ci_set = set(Ci.tolist())
        diag = vals[isdiag].sum()
        # weak connections lumped to diagonal
        weak = ~stg & ~isdiag
        diag = diag + vals[weak].sum()
        wrow = {j: -v for j, v in zip(cols[stg & isC], vals[stg & isC])}
        # distribute strong F-F connections
        for m, a_im in zip(cols[stg & isF], vals[stg & isF]):
            m0, m1 = indptr[m], indptr[m + 1]
            mcols = indices[m0:m1]
            mvals = a[m0:m1]
            inCi = np.isin(mcols, Ci)
            denom = mvals[inCi].sum()
            if denom == 0 or not inCi.any():
                # no common C point: lump into diagonal (modified) or skip
                if modified:
                    diag = diag + a_im
                continue
            scale = a_im / denom
            for j, a_mj in zip(mcols[inCi], mvals[inCi]):
                wrow[j] = wrow.get(j, 0) - scale * a_mj
        if diag == 0:
            continue
        jcols = np.fromiter(wrow.keys(), dtype=np.int64, count=len(wrow))
        jvals = np.fromiter((wrow[j] for j in jcols),
                            dtype=np.result_type(A.dtype, np.float64),
                            count=len(jcols))
        P_rows.append(np.full(len(jcols), i))
        P_cols.append(cmap[jcols])
        P_vals.append(jvals / diag)

    P = sp.csr_matrix(
        (np.concatenate(P_vals), (np.concatenate(P_rows),
                                  np.concatenate(P_cols))),
        shape=(n, nc),
    )
    P.sort_indices()
    return P


def distance_two_interpolation(A, C, splitting):
    """Extended+i (distance-two) interpolation.

    Rebuild of [R] pyamg/classical/interpolate.py::
    distance_two_interpolation: like classical interpolation but the
    interpolatory set also includes C points at distance two (through
    strong F neighbors), improving coarse convergence for aggressive
    coarsenings.
    """
    A = sp.csr_matrix(A)
    A.sort_indices()
    S = _strong_pattern(C)
    splitting = np.asarray(splitting)
    n = A.shape[0]
    cmap, cpts = _coarse_index_map(splitting)
    nc = len(cpts)
    strong = _pattern_membership(A, S)

    if not np.iscomplexobj(A.data):
        try:
            from ..amg_core import rs_distance_two_interpolation as _native
        except Exception:
            _native = None
        if _native is not None:
            return _native(A.indptr, A.indices, A.data, strong, splitting,
                           cmap, nc, modified=True)

    indptr, indices, a = A.indptr, A.indices, A.data
    P_rows, P_cols, P_vals = [], [], []
    for i in range(n):
        if splitting[i] == C_NODE:
            P_rows.append(np.array([i]))
            P_cols.append(np.array([cmap[i]]))
            P_vals.append(np.ones(1, dtype=A.dtype))
            continue
        s0, s1 = indptr[i], indptr[i + 1]
        cols = indices[s0:s1]
        vals = a[s0:s1]
        stg = strong[s0:s1]
        isdiag = cols == i
        isC = splitting[cols] == C_NODE
        isF = (splitting[cols] == F_NODE) & ~isdiag
        # interpolatory set: strong C at distance 1 + C via strong F
        Ci = set(cols[stg & isC].tolist())
        for m in cols[stg & isF]:
            m0, m1 = indptr[m], indptr[m + 1]
            mc = indices[m0:m1]
            Ci.update(mc[(splitting[mc] == C_NODE)].tolist())
        if not Ci:
            continue
        Ci_arr = np.fromiter(Ci, dtype=np.int64, count=len(Ci))
        diag = vals[isdiag].sum() + vals[~stg & ~isdiag].sum()
        wrow = {j: 0.0 for j in Ci_arr}
        for j, v in zip(cols[stg & isC], vals[stg & isC]):
            wrow[j] -= v
        for m, a_im in zip(cols[stg & isF], vals[stg & isF]):
            m0, m1 = indptr[m], indptr[m + 1]
            mcols = indices[m0:m1]
            mvals = a[m0:m1]
            inCi = np.isin(mcols, Ci_arr)
            denom = mvals[inCi].sum()
            if denom == 0 or not inCi.any():
                diag = diag + a_im
                continue
            scale = a_im / denom
            for j, a_mj in zip(mcols[inCi], mvals[inCi]):
                wrow[j] -= scale * a_mj
        if diag == 0:
            continue
        jcols = np.fromiter(wrow.keys(), dtype=np.int64, count=len(wrow))
        jvals = np.fromiter((wrow[j] for j in jcols),
                            dtype=np.result_type(A.dtype, np.float64),
                            count=len(jcols))
        nzm = jvals != 0
        P_rows.append(np.full(nzm.sum(), i))
        P_cols.append(cmap[jcols[nzm]])
        P_vals.append(jvals[nzm] / diag)

    P = sp.csr_matrix(
        (np.concatenate(P_vals), (np.concatenate(P_rows),
                                  np.concatenate(P_cols))),
        shape=(n, nc),
    )
    P.sort_indices()
    return P


def injection_interpolation(A, C, splitting):
    """P = injection at C points ([R] interpolate.py::injection_interpolation)."""
    n = A.shape[0]
    cmap, cpts = _coarse_index_map(np.asarray(splitting))
    return sp.csr_matrix(
        (np.ones(len(cpts)), (cpts, np.arange(len(cpts)))),
        shape=(n, len(cpts)),
    )


def one_point_interpolation(A, C, splitting):
    """Each F point interpolates (weight 1) from its strongest C neighbor.

    Rebuild of [R] pyamg/classical/interpolate.py::one_point_interpolation
    (amg_core one_point_interpolation) — the AIR default P.
    """
    A = sp.csr_matrix(A)
    S = sp.csr_matrix(C)
    S.sort_indices()
    splitting = np.asarray(splitting)
    n = A.shape[0]
    cmap, cpts = _coarse_index_map(splitting)
    # vectorized strongest-C-neighbor argmax per row
    srows = np.repeat(np.arange(n), np.diff(S.indptr))
    eligible = (splitting[S.indices] == C_NODE) & (S.indices != srows)
    meas = np.where(eligible, np.abs(S.data), -1.0)
    best_val = np.full(n, -1.0)
    np.maximum.at(best_val, srows, meas)
    # first entry attaining the row max (ties -> lowest index by argmax scan)
    hit = eligible & (meas == best_val[srows]) & (best_val[srows] > -1.0)
    # keep only the first hit per row
    first = np.zeros(len(hit), dtype=bool)
    if hit.any():
        hit_rows = srows[hit]
        idx_hit = np.flatnonzero(hit)
        keep_first = np.ones(len(idx_hit), dtype=bool)
        keep_first[1:] = hit_rows[1:] != hit_rows[:-1]
        first[idx_hit[keep_first]] = True
    frows = srows[first]
    fmask = splitting[frows] == F_NODE
    rows = np.concatenate([cpts, frows[fmask]])
    cols = np.concatenate([cmap[cpts], cmap[S.indices[first][fmask]]])
    vals = np.ones(len(rows))
    P = sp.csr_matrix((vals, (rows, cols)), shape=(n, len(cpts)))
    P.sort_indices()
    return P


def local_air(A, splitting, theta=0.1, degree=1):
    """Local approximate ideal restriction (lAIR).

    Rebuild of [R] pyamg/classical/interpolate.py::local_air (amg_core
    approx_ideal_restriction_pass1/2): for each C point c, choose the
    F neighborhood N within graph distance ``degree`` (entries filtered
    by ``theta`` relative to the row max) and solve the local ideal
    restriction condition

        R[c, N] = -A[c, N] @ inv(A[N, N]),   R[c, c] = 1

    so that (R A)|_F ~ 0.  Solves are batched by neighborhood size.
    """
    A = sp.csr_matrix(A)
    A.sort_indices()
    splitting = np.asarray(splitting)
    n = A.shape[0]
    cmap, cpts = _coarse_index_map(splitting)
    nc = len(cpts)

    indptr, indices, adata = A.indptr, A.indices, A.data
    absdata = np.abs(adata)

    # thresholded F-column adjacency W (per-row relative threshold),
    # then neighborhoods via boolean sparse products:
    #   degree 1: N = W[Cpts];  degree 2: N = (W[Cpts] + W[Cpts] @ W_FF)
    arows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    rowmax = np.zeros(n)
    np.maximum.at(rowmax, arows, absdata)
    keep = ((absdata >= theta * rowmax[arows])
            & (splitting[indices] == F_NODE) & (indices != arows))
    W = sp.csr_matrix(
        (np.ones(int(keep.sum()), dtype=np.int8),
         indices[keep], _recount_indptr(keep, indptr, n)),
        shape=(n, n))
    N1 = W[cpts]
    if degree >= 2:
        U = ((N1 + N1 @ W) > 0).tocsr()
        # N1 @ W may reach C columns through F; drop non-F columns
        colmask = np.ones(U.nnz, dtype=bool)
        colmask &= splitting[U.indices] == F_NODE
        U = sp.csr_matrix(
            (np.ones(int(colmask.sum()), dtype=np.int8), U.indices[colmask],
             _recount_indptr(colmask, U.indptr, nc)), shape=(nc, n))
    else:
        U = (N1 > 0).tocsr()
    U.sort_indices()
    nbhds = [U.indices[U.indptr[i]: U.indptr[i + 1]] for i in range(nc)]
    sizes = np.diff(U.indptr)
    R_rows, R_cols, R_vals = [np.asarray(cmap[cpts])], [np.asarray(cpts)], [
        np.ones(nc)]
    # global sorted (row, col) keys of A for vectorized block extraction
    arows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    akeys = arows * n + indices

    def lookup(qrows, qcols):
        """A[qrows, qcols] for equal-shape index arrays (0 where absent)."""
        q = qrows.astype(np.int64) * n + qcols
        pos = np.searchsorted(akeys, q.ravel())
        pos = np.minimum(pos, len(akeys) - 1)
        hit = akeys[pos] == q.ravel()
        out = np.where(hit, adata[pos], 0.0)
        return out.reshape(q.shape)

    # batch by neighborhood size
    for m in np.unique(sizes):
        if m == 0:
            continue
        sel = np.flatnonzero(sizes == m)
        idxs = np.stack([nbhds[s] for s in sel])          # (nb, m)
        # local systems (solve w A[N,N] = -A[c,N]  =>  A[N,N]^T w^T = ...)
        blocks = lookup(idxs[:, :, None], idxs[:, None, :])        # (nb,m,m)
        blocks = np.swapaxes(blocks, 1, 2)                         # transpose
        rhs = -lookup(np.asarray(cpts)[sel][:, None], idxs)        # (nb, m)
        try:
            w = np.linalg.solve(blocks, rhs[..., None])[..., 0]
        except np.linalg.LinAlgError:
            w = np.stack([np.linalg.lstsq(blocks[bi], rhs[bi], rcond=None)[0]
                          for bi in range(len(sel))])
        R_rows.append(np.repeat(cmap[np.asarray(cpts)[sel]], m))
        R_cols.append(idxs.ravel())
        R_vals.append(w.ravel())

    R = sp.csr_matrix(
        (np.concatenate(R_vals), (np.concatenate(R_rows),
                                  np.concatenate(R_cols))),
        shape=(nc, n),
    )
    R.sort_indices()
    return R

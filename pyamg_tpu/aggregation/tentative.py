"""Tentative prolongator via per-aggregate QR (setup phase, host side).

Rebuild of [R] pyamg/aggregation/tentative.py::fit_candidates
(amg_core fit_candidates, SURVEY.md §2.2).  The reference runs one small
QR per aggregate in C++; here aggregates are bucketed by size and solved
with *batched* NumPy QR — the same batching structure the device path
uses (`jnp.linalg.qr` over padded aggregates).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["fit_candidates"]


def fit_candidates(AggOp, B, tol=1e-10):
    """Fit near-nullspace candidates B into the aggregation structure.

    Parameters
    ----------
    AggOp : csr_matrix, (n_nodes, n_agg)
        0/1 node-to-aggregate map (possibly with empty rows for
        unaggregated nodes).
    B : array, (n_dof, k)
        Near-nullspace candidates; ``n_dof`` must be a multiple of
        ``n_nodes`` (the implicit blocksize).
    tol : float
        Drop tolerance for near-linearly-dependent local candidates.

    Returns
    -------
    T : csr_matrix, (n_dof, n_agg * k)
        Tentative prolongator with orthonormal columns per aggregate.
    coarse_B : array, (n_agg * k, k)
        Coarse-grid representation of the candidates (the R factors).
    """
    AggOp = sp.csr_matrix(AggOp)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B.reshape(-1, 1)
    n_nodes, n_agg = AggOp.shape
    n_dof, k = B.shape
    if n_dof % n_nodes != 0:
        raise ValueError("B row count must be a multiple of AggOp row count")
    bs = n_dof // n_nodes
    dtype = np.promote_types(B.dtype, np.float32)

    if k == 1 and bs == 1 and not np.iscomplexobj(B):
        # single scalar candidate: per-aggregate norm + scale — the QR
        # degenerates to v/||v||, so skip the bucketed batched QR
        # entirely (the common SA default; ~4x faster at 4.2M rows).
        # Exact parity with the general path incl. the zero-norm
        # dependent-drop case (column zeroed, coarse_B 0).
        has = np.diff(AggOp.indptr) > 0
        agg_of_row = np.zeros(n_nodes, dtype=np.int64)
        agg_of_row[has] = AggOp.indices
        b = B[:, 0]
        w = (np.abs(b) ** 2) * has
        norms = np.sqrt(np.bincount(agg_of_row[has], weights=w[has],
                                    minlength=n_agg))
        coarse_B = norms.reshape(-1, 1).astype(dtype)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(norms > 0, 1.0 / np.where(norms > 0, norms, 1),
                           0.0)
        data = b.astype(dtype)[has] * inv[AggOp.indices].astype(dtype)
        T = sp.csr_matrix((data, AggOp.indices.copy(),
                           AggOp.indptr.copy()), shape=(n_dof, n_agg))
        T.eliminate_zeros()
        T.sort_indices()
        return T, coarse_B

    Agg_csc = AggOp.tocsc()
    indptr, indices = Agg_csc.indptr, Agg_csc.indices
    sizes = np.diff(indptr)                      # nodes per aggregate

    coarse_B = np.zeros((n_agg * k, k), dtype=dtype)
    # COO triplets for T
    out_rows = []
    out_cols = []
    out_vals = []

    for m in np.unique(sizes):
        if m == 0:
            continue
        aggs = np.flatnonzero(sizes == m)
        # node indices per aggregate in this bucket: (n_b, m)
        node_idx = indices[
            (indptr[aggs][:, None] + np.arange(m)[None, :]).ravel()
        ].reshape(len(aggs), m)
        # dof indices: (n_b, m*bs)
        dof_idx = (node_idx[:, :, None] * bs + np.arange(bs)[None, None, :]).reshape(
            len(aggs), m * bs
        )
        Blocal = B[dof_idx].astype(dtype)        # (n_b, m*bs, k)
        p = m * bs
        mn = min(p, k)
        q, r = np.linalg.qr(Blocal, mode="reduced")  # q: (n_b, p, mn), r: (n_b, mn, k)
        # deterministic sign: diag(r) >= 0
        diag = np.einsum("bii->bi", r[:, :mn, :mn]).copy()
        signs = np.where(diag >= 0, 1.0, -1.0)
        if np.iscomplexobj(r):
            ph = np.where(np.abs(diag) > 0, diag / np.maximum(np.abs(diag), 1e-300), 1.0)
            signs = ph.conj()
        q = q * signs[:, None, :]
        r = r * np.conj(signs)[:, :, None] if np.iscomplexobj(r) else r * signs[:, :, None]
        # drop near-dependent local candidates
        col_scale = np.sqrt((np.abs(Blocal) ** 2).sum(axis=1))  # (n_b, k)
        dep = np.abs(np.einsum("bii->bi", r[:, :mn, :mn])) < tol * np.maximum(
            col_scale[:, :mn], 1e-300
        )
        if dep.any():
            qmask = ~dep  # (n_b, mn)
            q = q * qmask[:, None, :]
            r = r * qmask[:, :, None]
        # scatter: Q into T, R into coarse_B
        Qfull = np.zeros((len(aggs), p, k), dtype=dtype)
        Qfull[:, :, :mn] = q
        Rfull = np.zeros((len(aggs), k, k), dtype=dtype)
        Rfull[:, :mn, :] = r
        coarse_rows = (aggs[:, None] * k + np.arange(k)[None, :])  # (n_b, k)
        coarse_B[coarse_rows.ravel()] = Rfull.reshape(-1, k)
        rows = np.broadcast_to(dof_idx[:, :, None], (len(aggs), p, k))
        cols = np.broadcast_to(
            (aggs[:, None, None] * k + np.arange(k)[None, None, :]),
            (len(aggs), p, k),
        )
        out_rows.append(rows.ravel())
        out_cols.append(cols.ravel())
        out_vals.append(Qfull.ravel())

    if out_rows:
        rows = np.concatenate(out_rows)
        cols = np.concatenate(out_cols)
        vals = np.concatenate(out_vals)
    else:
        rows = cols = np.array([], dtype=np.int64)
        vals = np.array([], dtype=dtype)
    T = sp.csr_matrix((vals, (rows, cols)), shape=(n_dof, n_agg * k))
    T.eliminate_zeros()
    T.sort_indices()
    return T, coarse_B

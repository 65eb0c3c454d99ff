"""Aggregate visualization.

Rebuild of [R] pyamg/vis/vis_coarse.py (SURVEY.md §2.3, (M)):
export aggregate groupings over a mesh for inspection in ParaView
(vis_aggregate_groups) or return matplotlib-ready segments.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .vtk_writer import write_basic_mesh

__all__ = ["vis_aggregate_groups"]


def vis_aggregate_groups(V, E2V, AggOp, mesh_type="tri", fname=None):
    """Write (or return) aggregate-membership cell data for a mesh.

    Each vertex's aggregate id becomes point data; each element is
    labelled by the aggregate containing the majority of its vertices.

    Parameters
    ----------
    V : (n, 2) vertices; E2V : (ne, k) elements; AggOp : (n, n_agg) CSR.
    fname : output .vtu path; if None, returns (point_agg, cell_agg).
    """
    V = np.asarray(V, dtype=float)
    E2V = np.asarray(E2V, dtype=np.int64)
    AggOp = sp.csr_matrix(AggOp)
    n = V.shape[0]
    point_agg = np.full(n, -1, dtype=np.int64)
    assigned = np.diff(AggOp.indptr) > 0
    point_agg[assigned] = AggOp.indices[AggOp.indptr[:-1][assigned]]

    elt_aggs = point_agg[E2V]                      # (ne, k)
    cell_agg = np.empty(E2V.shape[0], dtype=np.int64)
    for e in range(E2V.shape[0]):
        vals, counts = np.unique(elt_aggs[e], return_counts=True)
        cell_agg[e] = vals[np.argmax(counts)]

    if fname is None:
        return point_agg, cell_agg
    write_basic_mesh(fname, V, E2V, mesh_type=mesh_type,
                     pdata={"aggregate": point_agg.astype(float)},
                     cdata={"aggregate": cell_agg.astype(float)})
    return point_agg, cell_agg

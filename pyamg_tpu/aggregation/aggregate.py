"""Aggregation algorithms (setup phase, host side).

Rebuild of [R] pyamg/aggregation/aggregate.py backed by
amg_core standard_aggregation / naive_aggregation / pairwise_aggregation
(SURVEY.md §2.2 / §2.4).  The serial-semantics algorithms (standard,
naive, pairwise) follow the reference's ordered-greedy behavior exactly —
these are setup-phase host passes, optionally accelerated by the C++
amg_core extension (:mod:`pyamg_tpu.amg_core`).  Lloyd-based aggregation
is vectorized-parallel and is the preferred device-friendly path.

All functions return ``(AggOp, Cpts)`` where AggOp is an (n, n_agg) CSR
0/1 matrix mapping nodes to aggregates and Cpts are root/seed nodes.
Nodes left unaggregated (isolated) have empty AggOp rows, matching the
reference convention.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..graph import asgraph, lloyd_cluster, balanced_lloyd_cluster

__all__ = [
    "standard_aggregation",
    "naive_aggregation",
    "lloyd_aggregation",
    "balanced_lloyd_aggregation",
    "pairwise_aggregation",
]


def _aggop_from_assignment(assignment, n_agg, dtype=np.float64):
    """Build the (n, n_agg) 0/1 CSR AggOp from a node->aggregate map."""
    n = len(assignment)
    assigned = assignment >= 0
    rows = np.flatnonzero(assigned)
    cols = assignment[assigned]
    data = np.ones(len(rows), dtype=dtype)
    return sp.csr_matrix((data, (rows, cols)), shape=(n, max(n_agg, 1)))


def standard_aggregation(C):
    """Standard (VMB) greedy aggregation — serial two-pass + leftovers.

    Rebuild of [R] pyamg/aggregation/aggregate.py::standard_aggregation
    (amg_core standard_aggregation).  Semantics:

    - Pass 1: visit nodes in order; if node i and all its strong neighbors
      are unaggregated, create a new aggregate containing all of them
      (i is the root).
    - Pass 2: each remaining unaggregated node joins a neighboring
      *pass-1* aggregate (first found in neighbor order).
    - Pass 3: remaining nodes seed new aggregates with their unaggregated
      neighbors.
    """
    C = asgraph(C)
    try:
        from ..amg_core import standard_aggregation as _native
    except Exception:
        _native = None
    if _native is not None:
        assignment, roots = _native(C.indptr, C.indices)
        n_agg = len(roots)
        return _aggop_from_assignment(assignment, n_agg), np.asarray(roots)
    return _standard_aggregation_py(C)


def _standard_aggregation_py(C):
    n = C.shape[0]
    indptr, indices = C.indptr, C.indices
    x = np.full(n, -1, dtype=np.int64)      # aggregate index per node
    from_pass1 = np.zeros(n, dtype=bool)
    roots = []

    # pass 1
    for i in range(n):
        if x[i] != -1:
            continue
        nbrs = indices[indptr[i]: indptr[i + 1]]
        nbrs = nbrs[nbrs != i]
        if (x[nbrs] == -1).all():
            a = len(roots)
            x[i] = a
            x[nbrs] = a
            from_pass1[i] = True
            from_pass1[nbrs] = True
            roots.append(i)

    # pass 2: join neighboring pass-1 aggregates (do not cascade)
    join = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        if x[i] != -1:
            continue
        for j in indices[indptr[i]: indptr[i + 1]]:
            if j != i and x[j] != -1 and from_pass1[j]:
                join[i] = x[j]
                break
    upd = join != -1
    x[upd] = join[upd]

    # pass 3: leftovers seed new aggregates with unaggregated neighbors
    for i in range(n):
        if x[i] != -1:
            continue
        a = len(roots)
        roots.append(i)
        x[i] = a
        nbrs = indices[indptr[i]: indptr[i + 1]]
        for j in nbrs:
            if j != i and x[j] == -1:
                x[j] = a

    n_agg = len(roots)
    return _aggop_from_assignment(x, n_agg), np.asarray(roots, dtype=np.int64)


def naive_aggregation(C):
    """One-pass greedy aggregation.

    Rebuild of [R] pyamg/aggregation/aggregate.py::naive_aggregation
    (amg_core naive_aggregation): visit nodes in order; an unaggregated
    node seeds a new aggregate and absorbs its unaggregated neighbors.
    """
    C = asgraph(C)
    try:
        from ..amg_core import naive_aggregation as _native
    except Exception:
        _native = None
    if _native is not None:
        assignment, roots = _native(C.indptr, C.indices)
        return _aggop_from_assignment(assignment, len(roots)), np.asarray(roots)
    n = C.shape[0]
    indptr, indices = C.indptr, C.indices
    x = np.full(n, -1, dtype=np.int64)
    roots = []
    for i in range(n):
        if x[i] != -1:
            continue
        a = len(roots)
        roots.append(i)
        x[i] = a
        nbrs = indices[indptr[i]: indptr[i + 1]]
        for j in nbrs:
            if x[j] == -1:
                x[j] = a
    return _aggop_from_assignment(x, len(roots)), np.asarray(roots, dtype=np.int64)


def lloyd_aggregation(C, ratio=0.03, distance="unit", maxiter=10, seed=0):
    """Lloyd-clustering aggregation.

    Rebuild of [R] pyamg/aggregation/aggregate.py::lloyd_aggregation:
    pick ``ratio * n`` seeds, run Lloyd clustering on the strength graph
    with the chosen edge-distance model, and turn clusters into aggregates.
    This is the naturally-parallel aggregation (Bellman-Ford fixed point),
    mirrored on device in :mod:`pyamg_tpu.parallel`.

    distance: 'unit' (hop count), 'abs' (|C_ij|), 'inv' (1/|C_ij|),
              'sub' / 'same' kept for API parity (alias of 'unit').
    """
    C = asgraph(C)
    n = C.shape[0]
    G = C.copy()
    G.setdiag(0)
    G.eliminate_zeros()
    if distance == "unit":
        G.data = np.ones_like(G.data)
    elif distance == "abs":
        G.data = np.abs(G.data)
    elif distance == "inv":
        with np.errstate(divide="ignore"):
            G.data = 1.0 / np.maximum(np.abs(G.data), 1e-300)
    else:
        G.data = np.ones_like(G.data)
    nseeds = int(min(max(np.ceil(ratio * n), 1), n))
    rng = np.random.default_rng(seed)
    seeds = rng.choice(n, size=nseeds, replace=False)
    dist, clusters, seeds = lloyd_cluster(G, seeds, maxiter=maxiter)
    # unreachable nodes become their own aggregates
    unassigned = np.flatnonzero(clusters < 0)
    if unassigned.size:
        extra = np.arange(len(seeds), len(seeds) + unassigned.size)
        clusters = clusters.copy()
        clusters[unassigned] = extra
        seeds = np.concatenate([seeds, unassigned])
    n_agg = int(clusters.max()) + 1 if len(clusters) else 0
    return _aggop_from_assignment(clusters, n_agg), np.asarray(seeds, dtype=np.int64)


def balanced_lloyd_aggregation(C, num_clusters=None, maxiter=10):
    """Balanced-Lloyd aggregation ([R] aggregate.py::balanced_lloyd_aggregation)."""
    C = asgraph(C)
    n = C.shape[0]
    if num_clusters is None:
        num_clusters = max(n // 10, 1)
    G = C.copy()
    G.setdiag(0)
    G.eliminate_zeros()
    G.data = np.ones_like(G.data)
    dist, clusters, seeds = balanced_lloyd_cluster(G, num_clusters, maxiter=maxiter)
    unassigned = np.flatnonzero(clusters < 0)
    if unassigned.size:
        extra = np.arange(len(seeds), len(seeds) + unassigned.size)
        clusters = clusters.copy()
        clusters[unassigned] = extra
        seeds = np.concatenate([seeds, unassigned])
    n_agg = int(clusters.max()) + 1 if len(clusters) else 0
    return _aggop_from_assignment(clusters, n_agg), np.asarray(seeds, dtype=np.int64)


def pairwise_aggregation(A, matchings=2, theta=0.25, norm="min", compute_P=False):
    """Notay-style pairwise-matching aggregation.

    Rebuild of [R] pyamg/aggregation/aggregate.py::pairwise_aggregation
    (amg_core pairwise_aggregation): ``matchings`` rounds of greedy
    strongest-negative-coupling pairing; between rounds the operator is
    coarsened with the unsmoothed Galerkin product so pairs compose into
    aggregates of size 2^matchings.
    """
    A = sp.csr_matrix(A)
    n = A.shape[0]
    AggOp = sp.identity(n, format="csr", dtype=A.dtype)
    Acur = A
    roots = np.arange(n)
    for _ in range(int(matchings)):
        pairs = _one_pairwise_matching(Acur, theta=theta, norm=norm)
        n_agg = int(pairs.max()) + 1 if len(pairs) else 0
        P = _aggop_from_assignment(pairs, n_agg, dtype=A.dtype)
        AggOp = sp.csr_matrix(AggOp @ P)
        Acur = sp.csr_matrix(P.T @ Acur @ P)
    # root of each aggregate = lowest-index member
    AggT = sp.csc_matrix(AggOp)
    roots = np.array(
        [AggT.indices[AggT.indptr[j]] if AggT.indptr[j] < AggT.indptr[j + 1] else -1
         for j in range(AggOp.shape[1])],
        dtype=np.int64,
    )
    if compute_P:
        return AggOp, roots, AggOp
    return AggOp, roots


def _one_pairwise_matching(A, theta=0.25, norm="min"):
    """One greedy matching round: pair node with strongest negative coupling."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices
    data = np.real(A.data)
    assignment = np.full(n, -1, dtype=np.int64)
    # visit in order of increasing number of strong couplings (Notay's mu)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    offd = indices != rows
    neg = np.where(offd, -data, 0.0)
    rowmin = np.zeros(n)
    nz = np.diff(indptr) > 0
    if data.size:
        rowmin[nz] = np.maximum.reduceat(neg, indptr[:-1][nz])
    strong = offd & (neg >= theta * np.maximum(rowmin[rows], 1e-300)) & (neg > 0)
    n_strong = np.zeros(n, dtype=np.int64)
    np.add.at(n_strong, rows[strong], 1)
    order = np.argsort(n_strong, kind="stable")
    try:
        from ..amg_core import pairwise_matching as _native
    except Exception:
        _native = None
    if _native is not None and not np.iscomplexobj(data):
        assignment, _count = _native(indptr, indices, data, order)
        return assignment
    count = 0
    for i in order:
        if assignment[i] != -1:
            continue
        s, e = indptr[i], indptr[i + 1]
        best_j, best_v = -1, 0.0
        for idx in range(s, e):
            j = indices[idx]
            if j == i or assignment[j] != -1:
                continue
            v = -data[idx]
            if v > best_v:
                best_v, best_j = v, j
        assignment[i] = count
        if best_j >= 0:
            assignment[best_j] = count
        count += 1
    return assignment

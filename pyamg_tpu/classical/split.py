"""C/F splitting algorithms (setup phase, host side).

Rebuild of [R] pyamg/classical/split.py (SURVEY.md §2.2)
backed by amg_core rs_cf_splitting / cljp_naive_splitting (§2.4).

Convention (reference): ``S`` is the strength matrix with row i listing
the points that *i strongly depends on*.  Splitting array: F_NODE=0,
C_NODE=1 (U_NODE=2 transient).  The serial RS algorithm runs in the C++
amg_core extension (bucket priority queue) with a NumPy fallback; the
parallel-flavored splittings (PMIS/PMISc/CLJP/CLJPc) are vectorized
fixed-point rounds — the forms that port to device (SURVEY.md §7 step 5).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..graph import maximal_independent_set, vertex_coloring

__all__ = ["RS", "PMIS", "PMISc", "CLJP", "CLJPc", "MIS",
           "F_NODE", "C_NODE", "U_NODE"]

F_NODE = 0
C_NODE = 1
U_NODE = 2


def _strength_pattern(S):
    """CSR pattern of S with the diagonal removed."""
    S = sp.csr_matrix(S)
    S = S.copy()
    S.setdiag(0)
    S.eliminate_zeros()
    S.sort_indices()
    return S


def RS(S, second_pass=False):
    """Classic serial Ruge-Stuben two-pass splitting.

    Rebuild of [R] pyamg/classical/split.py::RS (amg_core
    rs_cf_splitting + rs_cf_splitting_pass2): points with many strong
    dependents become C first (bucket priority queue); the optional
    second pass enforces the strong F-F common-C condition.
    """
    S = _strength_pattern(S)
    T = S.T.tocsr()
    T.sort_indices()
    try:
        from ..amg_core import rs_cf_splitting as _native
    except Exception:
        _native = None
    if _native is not None:
        return _native(S.indptr, S.indices, T.indptr, T.indices,
                       second_pass=second_pass).astype(np.int32)
    return _rs_py(S, T, second_pass)


def _rs_py(S, T, second_pass):
    """Pure-python RS (fallback; quadratic-free but slower)."""
    n = S.shape[0]
    splitting = np.full(n, U_NODE, dtype=np.int32)
    lam = np.diff(T.indptr).astype(np.int64).copy()
    import heapq

    heap = [(-lam[i], i) for i in range(n)]
    heapq.heapify(heap)
    stamp = lam.copy()
    while heap:
        negl, i = heapq.heappop(heap)
        if splitting[i] != U_NODE or -negl != stamp[i]:
            continue
        splitting[i] = C_NODE
        for j in T.indices[T.indptr[i]: T.indptr[i + 1]]:
            if splitting[j] == U_NODE:
                splitting[j] = F_NODE
                for k in S.indices[S.indptr[j]: S.indptr[j + 1]]:
                    if splitting[k] == U_NODE:
                        stamp[k] += 1
                        heapq.heappush(heap, (-stamp[k], k))
        for j in S.indices[S.indptr[i]: S.indptr[i + 1]]:
            if splitting[j] == U_NODE and stamp[j] > 0:
                stamp[j] -= 1
                heapq.heappush(heap, (-stamp[j], j))
    splitting[splitting == U_NODE] = C_NODE
    if second_pass:
        _second_pass_py(S, splitting)
    return splitting


def _second_pass_py(S, splitting):
    n = S.shape[0]
    marker = np.full(n, -1, dtype=np.int64)
    indptr, indices = S.indptr, S.indices
    for i in range(n):
        if splitting[i] != F_NODE:
            continue
        for c in indices[indptr[i]: indptr[i + 1]]:
            if splitting[c] == C_NODE:
                marker[c] = i
        for j in indices[indptr[i]: indptr[i + 1]]:
            if j == i or splitting[j] != F_NODE:
                continue
            ok = False
            for c in indices[indptr[j]: indptr[j + 1]]:
                if splitting[c] == C_NODE and marker[c] == i:
                    ok = True
                    break
            if not ok:
                splitting[i] = C_NODE
                break
    return splitting


def _parallel_weights(T, seed, coloring=None):
    n = T.shape[0]
    lam = np.diff(T.indptr).astype(np.float64)
    if coloring is not None:
        ncolors = coloring.max() + 1
        frac = (coloring.astype(np.float64) + 1.0) / (ncolors + 1.0)
    else:
        rng = np.random.default_rng(seed)
        frac = rng.random(n)
    return lam + frac


def PMIS(S, seed=0, weights=None):
    """Parallel modified independent set splitting.

    Rebuild of [R] pyamg/classical/split.py::PMIS: C points are chosen
    as rounds of weighted maximal independent sets over the symmetrized
    strength graph; undecided points adjacent to a new C become F.
    Naturally parallel — this is the device-preferred splitting.
    """
    S = _strength_pattern(S)
    T = S.T.tocsr()
    G = ((S + T) > 0).astype(np.int8).tocsr()   # symmetrized adjacency
    G.setdiag(0)
    G.eliminate_zeros()
    n = S.shape[0]
    if weights is None:
        weights = _parallel_weights(T, seed)
    splitting = np.full(n, U_NODE, dtype=np.int32)
    # isolated points (no strong connections at all) become F directly
    iso = (np.diff(G.indptr) == 0)
    nonzero_lam = np.diff(T.indptr) + np.diff(S.indptr)
    splitting[iso & (nonzero_lam == 0)] = F_NODE

    indptr, indices = G.indptr, G.indices
    rows = np.repeat(np.arange(n), np.diff(indptr))
    while (splitting == U_NODE).any():
        undecided = splitting == U_NODE
        w = np.where(undecided, weights, -np.inf)
        nbr_max = np.full(n, -np.inf)
        np.maximum.at(nbr_max, rows, w[indices])
        winners = undecided & (w > nbr_max)
        if not winners.any():
            winners = undecided & (w >= nbr_max)
        splitting[winners] = C_NODE
        # undecided neighbors of new C points become F
        newC_edges = winners[rows]
        fcands = np.unique(indices[newC_edges])
        fcands = fcands[splitting[fcands] == U_NODE]
        splitting[fcands] = F_NODE
    return splitting


def PMISc(S, method="JP"):
    """PMIS with deterministic coloring-based weights
    ([R] split.py::PMISc)."""
    S = _strength_pattern(S)
    T = S.T.tocsr()
    G = ((S + T) > 0).astype(np.int8).tocsr()
    colors = vertex_coloring(G, method=method)
    weights = _parallel_weights(T, 0, coloring=colors)
    return PMIS(S, weights=weights)


def CLJP(S, seed=17, color=False):
    """Cleary-Luby-Jones-Plassmann parallel splitting.

    Rebuild of [R] pyamg/classical/split.py::CLJP (amg_core
    cljp_naive_splitting): iterative independent-set selection with
    weight decrements as strength edges become satisfied; a point whose
    weight drops below 1 has all its influence accounted for -> F.
    """
    S = _strength_pattern(S)
    n = S.shape[0]
    T = S.T.tocsr()
    if color:
        G = ((S + T) > 0).astype(np.int8).tocsr()
        colors = vertex_coloring(G, method="JP")
        weights = _parallel_weights(T, seed, coloring=colors)
    else:
        weights = _parallel_weights(T, seed)

    splitting = np.full(n, U_NODE, dtype=np.int32)
    # active dependency edges (i -> j: i strongly depends on j)
    E = S.copy().astype(np.int8)
    E.data[:] = 1
    w = weights.copy()

    for _round in range(n + 2):
        # F: no remaining influence credit
        undecided = splitting == U_NODE
        splitting[undecided & (w < 1.0)] = F_NODE
        undecided = splitting == U_NODE
        if not undecided.any():
            break
        # local maxima of w over the symmetrized active graph
        G = ((E + E.T) > 0).tocsr()
        rows = np.repeat(np.arange(n), np.diff(G.indptr))
        wv = np.where(undecided, w, -np.inf)
        nbr_max = np.full(n, -np.inf)
        if G.nnz:
            np.maximum.at(nbr_max, rows, wv[G.indices])
        winners = undecided & (wv > nbr_max)
        if not winners.any():
            winners = undecided & (wv >= nbr_max)
        splitting[winners] = C_NODE
        newC = np.flatnonzero(winners)

        rowsE = np.repeat(np.arange(n), np.diff(E.indptr))
        colsE = E.indices
        active = E.data.astype(bool)
        # H1: new C points need no interpolation — edges c->k removed,
        # each target k loses dependent c
        e1 = active & winners[rowsE]
        np.add.at(w, colsE[e1], -1.0)
        # H2: j, k undecided both depending on a common new C point c:
        # edge j->k removed, k loses dependent j
        Wdep = sp.csr_matrix(
            (active.astype(np.int8), colsE, E.indptr), shape=(n, n)
        )[:, newC]                                 # j depends on which new C
        common = (Wdep @ Wdep.T).tocsr()           # share a new C point
        # membership of each active undecided-undecided edge in `common`
        und_edge = active & undecided[rowsE] & undecided[colsE]
        if und_edge.any():
            keysE = rowsE[und_edge].astype(np.int64) * n + colsE[und_edge]
            rowsC = np.repeat(np.arange(n), np.diff(common.indptr))
            maskC = common.data > 0
            keysC = rowsC[maskC].astype(np.int64) * n + common.indices[maskC]
            shared = np.isin(keysE, keysC)
            e2 = np.zeros_like(active)
            e2[np.flatnonzero(und_edge)[shared]] = True
        else:
            e2 = np.zeros_like(active)
        np.add.at(w, colsE[e2], -1.0)
        # edges into decided points are also settled (j -> c with c
        # decided): drop so the active graph shrinks
        e3 = active & (splitting[colsE] != U_NODE)
        E.data[e1 | e2 | e3] = 0
        E.eliminate_zeros()
    splitting[splitting == U_NODE] = F_NODE
    return splitting


def CLJPc(S, seed=17):
    """CLJP with coloring-based weights ([R] split.py::CLJPc)."""
    return CLJP(S, seed=seed, color=True)


def MIS(G, weights=None, maxiter=None):
    """Maximal independent set (reference API wrapper).

    Rebuild of [R] pyamg/classical/split.py::MIS — thin wrapper over the
    graph module's Luby MIS.
    """
    return maximal_independent_set(G, algo="parallel", weights=weights)

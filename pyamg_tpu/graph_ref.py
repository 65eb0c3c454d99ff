"""Pure-Python reference implementations of the graph kernels.

Rebuild of [R] pyamg/graph_ref.py (SURVEY.md §2.3): slow,
obviously-correct versions used as golden references in tests (the
reference's institutionalized testing idiom, SURVEY.md §4 item 1).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = [
    "maximal_independent_set_ref",
    "vertex_coloring_ref",
    "bellman_ford_ref",
    "is_independent_set",
    "is_maximal_independent_set",
    "is_valid_coloring",
]


def _adj(G):
    G = sp.csr_matrix(G)
    G = G.copy()
    G.setdiag(0)
    G.eliminate_zeros()
    return G


def maximal_independent_set_ref(G):
    """Greedy MIS in natural order (matches graph.maximal_independent_set
    with algo='serial')."""
    G = _adj(G)
    n = G.shape[0]
    state = np.full(n, -1, dtype=np.int8)
    for i in range(n):
        if state[i] == -1:
            state[i] = 1
            for j in G.indices[G.indptr[i]: G.indptr[i + 1]]:
                if j != i:
                    state[j] = max(state[j], 0)
    return (state == 1).astype(np.int32)


def vertex_coloring_ref(G):
    """Greedy first-fit coloring in natural order."""
    G = _adj(G)
    n = G.shape[0]
    colors = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        used = {colors[j] for j in G.indices[G.indptr[i]: G.indptr[i + 1]]
                if colors[j] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


def bellman_ford_ref(G, seeds):
    """O(n*m) textbook Bellman-Ford from multiple seeds."""
    G = sp.csr_matrix(G)
    n = G.shape[0]
    dist = np.full(n, np.inf)
    nearest = np.full(n, -1, dtype=np.int64)
    for s_idx, s in enumerate(np.asarray(seeds)):
        dist[s] = 0.0
        nearest[s] = s_idx
    for _ in range(n):
        changed = False
        for i in range(n):
            if not np.isfinite(dist[i]):
                continue
            for kk in range(G.indptr[i], G.indptr[i + 1]):
                j = G.indices[kk]
                w = abs(G.data[kk])
                if dist[i] + w < dist[j]:
                    dist[j] = dist[i] + w
                    nearest[j] = nearest[i]
                    changed = True
        if not changed:
            break
    return dist, nearest


def is_independent_set(G, mis):
    """No two selected vertices are adjacent."""
    G = _adj(G)
    mis = np.asarray(mis).astype(bool)
    rows = np.repeat(np.arange(G.shape[0]), np.diff(G.indptr))
    return not (mis[rows] & mis[G.indices]).any()


def is_maximal_independent_set(G, mis):
    """Independent and maximal (every unselected vertex has a selected
    neighbor)."""
    G = _adj(G)
    mis = np.asarray(mis).astype(bool)
    if not is_independent_set(G, mis):
        return False
    n = G.shape[0]
    for i in range(n):
        if not mis[i]:
            nbrs = G.indices[G.indptr[i]: G.indptr[i + 1]]
            if not mis[nbrs].any():
                return False
    return True


def is_valid_coloring(G, colors):
    """Adjacent vertices have different colors; all vertices colored."""
    G = _adj(G)
    colors = np.asarray(colors)
    if (colors < 0).any():
        return False
    rows = np.repeat(np.arange(G.shape[0]), np.diff(G.indptr))
    mask = rows != G.indices
    return not (colors[rows[mask]] == colors[G.indices[mask]]).any()

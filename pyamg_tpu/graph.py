"""Graph algorithms for coarsening, coloring, and clustering (host side).

Rebuild of [R] pyamg/graph.py backed by amg_core/graph.h
(SURVEY.md §2.3 / §2.4).  The parallel-flavored algorithms (Luby MIS,
Jones-Plassmann coloring, Bellman-Ford) are implemented as vectorized
fixed-point rounds over the whole vertex set — exactly the form that maps
onto the device versions in :mod:`pyamg_tpu.parallel` (jnp.while_loop
fixed points).  Serial-semantics variants are kept for reference parity.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

__all__ = [
    "maximal_independent_set",
    "vertex_coloring",
    "bellman_ford",
    "lloyd_cluster",
    "balanced_lloyd_cluster",
    "breadth_first_search",
    "connected_components",
    "symmetric_rcm",
    "pseudo_peripheral_node",
    "asgraph",
]


def asgraph(G):
    """Return a CSR adjacency matrix with sorted indices."""
    G = sp.csr_matrix(G)
    G.sort_indices()
    return G


def _random_weights(n, seed):
    rng = np.random.default_rng(seed)
    # unique tie-breaking weights (random permutation keeps them distinct)
    return rng.permutation(n).astype(np.float64) + 1.0


def maximal_independent_set(G, algo="serial", k=None, weights=None, seed=0):
    """Maximal independent set of the graph of G.

    Rebuild of [R] pyamg/graph.py::maximal_independent_set
    (amg_core maximal_independent_set_serial / _parallel / _k_parallel).

    algo='serial'   : greedy in natural order (deterministic, matches the
                      serial reference semantics).
    algo='parallel' : Luby's algorithm — vectorized rounds; a node joins
                      the MIS when its weight beats all undecided
                      neighbors.  This is the form the device path uses.
    k               : if given, distance-k MIS (no two MIS nodes within
                      graph distance k); implemented by MIS on G^k's
                      pattern.

    Returns an int array: 1 = in MIS, 0 = not.
    """
    G = asgraph(G)
    n = G.shape[0]
    if k is not None and k > 1:
        Gk = G.copy()
        Gk.data = np.ones_like(Gk.data)
        P = Gk
        for _ in range(k - 1):
            P = sp.csr_matrix((P @ Gk) + P)
            P.data = np.ones_like(P.data)
        G = asgraph(P)

    if algo == "serial":
        state = np.full(n, -1, dtype=np.int8)  # -1 undecided, 1 MIS, 0 excluded
        indptr, indices = G.indptr, G.indices
        for i in range(n):
            if state[i] == -1:
                state[i] = 1
                nbrs = indices[indptr[i]: indptr[i + 1]]
                state[nbrs[nbrs != i]] = 0
        return (state == 1).astype(np.int32)

    if algo == "parallel":
        if weights is None:
            weights = _random_weights(n, seed)
        state = np.full(n, -1, dtype=np.int8)
        Gp = G.copy()
        Gp.setdiag(0)
        Gp.eliminate_zeros()
        indptr, indices = Gp.indptr, Gp.indices
        rows = np.repeat(np.arange(n), np.diff(indptr))
        while True:
            undecided = state == -1
            if not undecided.any():
                break
            # neighbor max weight among undecided neighbors
            w = np.where(undecided, weights, -np.inf)
            nbr_w = w[indices]
            nbr_max = np.full(n, -np.inf)
            np.maximum.at(nbr_max, rows, nbr_w)
            winners = undecided & (w > nbr_max)
            if not winners.any():
                # isolated ties can only happen with duplicate weights
                winners = undecided & (w >= nbr_max)
            state[winners] = 1
            # exclude neighbors of winners
            excluded = np.zeros(n, dtype=bool)
            win_rows = winners[rows]
            excluded[indices[win_rows]] = True
            state[excluded & (state == -1)] = 0
        return (state == 1).astype(np.int32)

    raise ValueError(f"unknown algo {algo}")


def vertex_coloring(G, method="JP", seed=0):
    """Vertex coloring of the graph of G.

    Rebuild of [R] pyamg/graph.py::vertex_coloring (amg_core
    vertex_coloring_mis / _jones_plassmann / _LDF).

    method='MIS' : repeated maximal independent sets, one color per MIS.
    method='JP'  : Jones-Plassmann — random priorities, greedy rounds.
    method='LDF' : largest-degree-first priorities + JP rounds.

    Returns an int32 array of colors (0-based).
    """
    G = asgraph(G)
    n = G.shape[0]
    Gp = G.copy()
    Gp.setdiag(0)
    Gp.eliminate_zeros()
    indptr, indices = Gp.indptr, Gp.indices
    rows = np.repeat(np.arange(n), np.diff(indptr))

    if method == "MIS":
        colors = np.full(n, -1, dtype=np.int32)
        color = 0
        remaining = np.arange(n)
        Gcur = Gp
        while remaining.size:
            mis = maximal_independent_set(Gcur, algo="parallel", seed=seed + color)
            chosen = remaining[mis.astype(bool)]
            colors[chosen] = color
            color += 1
            keep = ~mis.astype(bool)
            remaining = remaining[keep]
            Gcur = Gcur[keep][:, keep].tocsr()
        return colors

    if method in ("JP", "LDF"):
        if method == "LDF":
            degrees = np.diff(indptr).astype(np.float64)
            weights = degrees * n + _random_weights(n, seed)  # degree-major
        else:
            weights = _random_weights(n, seed)
        colors = np.full(n, -1, dtype=np.int32)
        while (colors == -1).any():
            undecided = colors == -1
            w = np.where(undecided, weights, -np.inf)
            nbr_max = np.full(n, -np.inf)
            np.maximum.at(nbr_max, rows, w[indices])
            winners = undecided & (w > nbr_max)
            if not winners.any():
                winners = undecided & (w >= nbr_max)
            # each winner takes the smallest color not used by its neighbors
            for i in np.flatnonzero(winners):
                nbr_colors = colors[indices[indptr[i]: indptr[i + 1]]]
                nbr_colors = nbr_colors[nbr_colors >= 0]
                c = 0
                used = set(nbr_colors.tolist())
                while c in used:
                    c += 1
                colors[i] = c
        return colors

    raise ValueError(f"unknown method {method}")


def bellman_ford(G, seeds, maxiter=None):
    """Multi-seed Bellman-Ford shortest path.

    Rebuild of [R] pyamg/graph.py::bellman_ford (amg_core bellman_ford):
    distances and nearest-seed assignment from a set of seed vertices,
    computed as iterated min-plus relaxation rounds — the same fixed-point
    form used on device.  Edge weights are G.data (must be >= 0).

    Returns (distances, nearest_seed_index).
    """
    G = asgraph(G)
    n = G.shape[0]
    seeds = np.asarray(seeds, dtype=np.int64)
    dist = np.full(n, np.inf)
    dist[seeds] = 0.0
    indptr, indices = G.indptr, G.indices
    data = np.abs(G.data).astype(np.float64)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    if maxiter is None:
        maxiter = n
    for _ in range(maxiter):
        cand = dist[rows] + data          # relax every edge (row -> col)
        new_dist = dist.copy()
        np.minimum.at(new_dist, indices, cand)
        if not (new_dist < dist).any():
            break
        dist = new_dist
    # settle nearest-seed ownership along shortest-path edges
    nearest = np.full(n, -1, dtype=np.int64)
    nearest[seeds] = np.arange(len(seeds))
    for _ in range(maxiter):
        achieves = (nearest[rows] >= 0) & np.isclose(
            dist[indices], dist[rows] + data, rtol=1e-12, atol=1e-12
        )
        upd = achieves & (nearest[indices] == -1)
        if not upd.any():
            break
        nearest[indices[upd]] = nearest[rows[upd]]
    return dist, nearest


def breadth_first_search(G, seed):
    """BFS levels and order from a seed vertex.

    Rebuild of [R] pyamg/graph.py::breadth_first_search.
    Returns (order, level) arrays; unreachable vertices have level -1.
    """
    G = asgraph(G)
    n = G.shape[0]
    level = np.full(n, -1, dtype=np.int64)
    order = []
    frontier = np.array([seed], dtype=np.int64)
    level[seed] = 0
    depth = 0
    indptr, indices = G.indptr, G.indices
    while frontier.size:
        order.append(frontier)
        depth += 1
        nbrs = np.unique(
            np.concatenate([indices[indptr[i]: indptr[i + 1]] for i in frontier])
        ) if frontier.size else np.array([], dtype=np.int64)
        new = nbrs[level[nbrs] == -1]
        level[new] = depth
        frontier = new
    return np.concatenate(order) if order else np.array([], dtype=np.int64), level


def connected_components(G):
    """Connected components labelling ([R] pyamg/graph.py::connected_components)."""
    G = asgraph(G)
    _, labels = csgraph.connected_components(G, directed=False)
    return labels.astype(np.int32)


def symmetric_rcm(A):
    """Reverse Cuthill-McKee permutation of symmetric A applied to A.

    Rebuild of [R] pyamg/graph.py::symmetric_rcm.
    """
    A = sp.csr_matrix(A)
    perm = csgraph.reverse_cuthill_mckee(A, symmetric_mode=True)
    return A[perm][:, perm].tocsr()


def pseudo_peripheral_node(A):
    """Find a pseudo-peripheral node via repeated BFS eccentricity sweeps.

    Rebuild of [R] pyamg/graph.py::pseudo_peripheral_node.
    Returns (node, order, level).
    """
    G = asgraph(A)
    x = 0
    order, level = breadth_first_search(G, x)
    ecc = level.max()
    while True:
        last_level = np.flatnonzero(level == ecc)
        # pick min-degree node in the last level
        degrees = np.diff(G.indptr)
        y = last_level[np.argmin(degrees[last_level])]
        order_y, level_y = breadth_first_search(G, y)
        if level_y.max() <= ecc:
            return y, order_y, level_y
        x, order, level, ecc = y, order_y, level_y, level_y.max()


def lloyd_cluster(G, seeds, maxiter=10):
    """Lloyd clustering on a graph.

    Rebuild of [R] pyamg/graph.py::lloyd_cluster (amg_core lloyd_cluster):
    alternate (1) Bellman-Ford assignment of vertices to nearest seed and
    (2) recentering each seed to the most interior vertex of its cluster
    (max distance from the cluster boundary).

    Parameters
    ----------
    G : sparse matrix — edge weights (abs taken)
    seeds : int array of initial seed vertices (or int count)
    Returns (distances, clusters, seeds).
    """
    G = asgraph(G)
    n = G.shape[0]
    if np.isscalar(seeds):
        rng = np.random.default_rng(0)
        seeds = rng.choice(n, size=int(seeds), replace=False)
    seeds = np.asarray(seeds, dtype=np.int64).copy()

    indptr, indices = G.indptr, G.indices
    rows = np.repeat(np.arange(n), np.diff(indptr))
    dist = clusters = None
    for _ in range(maxiter):
        dist, clusters = bellman_ford(G, seeds)
        # boundary vertices: any neighbor in a different cluster
        diff_edge = clusters[rows] != clusters[indices]
        boundary = np.zeros(n, dtype=bool)
        boundary[rows[diff_edge]] = True
        boundary[seeds] |= False
        if not boundary.any():
            break
        # distance from boundary within own cluster
        mask_same = clusters[rows] == clusters[indices]
        Gin = sp.csr_matrix(
            (np.abs(G.data) * mask_same, indices.copy(), indptr.copy()),
            shape=G.shape,
        )
        Gin.eliminate_zeros()
        bdist, _ = bellman_ford(Gin, np.flatnonzero(boundary))
        bdist[~np.isfinite(bdist)] = -1  # interior-only comps: keep old seed
        new_seeds = seeds.copy()
        for c in range(len(seeds)):
            members = np.flatnonzero(clusters == c)
            if members.size:
                new_seeds[c] = members[np.argmax(bdist[members])]
        if np.array_equal(new_seeds, seeds):
            break
        seeds = new_seeds
    dist, clusters = bellman_ford(G, seeds)
    return dist, clusters, seeds


def balanced_lloyd_cluster(G, num_clusters, maxiter=10, rebalance_iters=3):
    """Balanced Lloyd clustering.

    Rebuild of [R] pyamg/graph.py::balanced_lloyd_cluster (amg_core
    bellman_ford_balanced helpers): Lloyd iterations with a balancing term
    that penalizes large clusters so cluster sizes equalize.
    """
    G = asgraph(G)
    n = G.shape[0]
    rng = np.random.default_rng(1)
    seeds = rng.choice(n, size=int(num_clusters), replace=False)
    dist = clusters = None
    for _ in range(rebalance_iters):
        dist, clusters, seeds = lloyd_cluster(G, seeds, maxiter=maxiter)
        sizes = np.bincount(clusters[clusters >= 0], minlength=len(seeds))
        if sizes.size == 0 or (sizes.max() <= 2 * max(sizes.min(), 1)):
            break
        # split the largest cluster at its farthest vertex, merge smallest
        big = int(np.argmax(sizes))
        small = int(np.argmin(sizes))
        members = np.flatnonzero(clusters == big)
        far = members[np.argmax(dist[members])]
        seeds[small] = far
    dist, clusters, seeds = lloyd_cluster(G, seeds, maxiter=maxiter)
    return dist, clusters, seeds

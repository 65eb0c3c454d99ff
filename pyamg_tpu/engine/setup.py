"""Device (jitted) setup-phase graph primitives.

BASELINE.json:5 names "setup-phase graph algorithms (strength,
aggregation, splitting) as parallel JAX primitives" as a subsystem that
changes.  The reference's serial graph loops (SURVEY.md §2.4 graph.h /
ruge_stuben.h) become fixed-point iterations here, with one key device
twist: neighbor access happens over the **DIA structure by rolling**, so
every primitive is gather-free (see DESIGN.md for why gathers are
banned) and static-shape:

- strength:   per-entry boolean mask over the DIA slots;
- Luby MIS / JP coloring / PMIS splitting: lax.while_loop rounds where
  "max over neighbors" = max over diagonals of rolled weight vectors;
- Bellman-Ford: iterated min-plus over rolled distance vectors (drives
  Lloyd aggregation).

Outputs are static-shape device arrays (masks / assignments); the
variable-shape hierarchy assembly (P construction, RAP) remains on host
(SURVEY.md §7 hard parts 1-2).  Randomized tie-breaking uses hashed
per-vertex weights so results are deterministic given the seed.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..sparse import DIAMatrix

__all__ = [
    "neighbor_reduce_max",
    "neighbor_reduce_min_plus",
    "device_strength_mask",
    "device_luby_mis",
    "device_jp_coloring",
    "device_pmis_splitting",
    "device_bellman_ford",
]


def _adjacency_masks(dia: DIAMatrix):
    """Per-diagonal off-diagonal adjacency masks (data != 0, off != 0)."""
    masks = []
    for d, off in enumerate(dia.offsets):
        if off == 0:
            masks.append(None)
        else:
            masks.append(dia.data[d] != 0)
    return masks


def neighbor_reduce_max(dia: DIAMatrix, x, fill=-jnp.inf):
    """max over strong neighbors j of x[j], per vertex (gather-free)."""
    out = jnp.full(dia.n_pad, fill, dtype=x.dtype)
    for d, off in enumerate(dia.offsets):
        if off == 0:
            continue
        mask = dia.data[d] != 0
        out = jnp.maximum(out, jnp.where(mask, jnp.roll(x, -off), fill))
    return out


def neighbor_reduce_min_plus(dia: DIAMatrix, dist, weights=None):
    """min over neighbors j of dist[j] + w(i, j) (one Bellman-Ford round)."""
    out = dist
    for d, off in enumerate(dia.offsets):
        if off == 0:
            continue
        w = jnp.abs(dia.data[d]) if weights is None else weights[d]
        cand = jnp.where(dia.data[d] != 0, jnp.roll(dist, -off) + w, jnp.inf)
        out = jnp.minimum(out, cand)
    return out


def device_strength_mask(dia: DIAMatrix, theta=0.25, norm="abs"):
    """Classical strength mask over the DIA slots.

    Device analog of strength.classical_strength_of_connection: entry
    (d, i) is strong iff |data[d, i]| >= theta * max_k |data[k, i]|
    (off-diagonals only; 'min' norm uses -data).  Returns a boolean array
    shaped like dia.data.
    """
    offd = np.array([o != 0 for o in dia.offsets])
    offd_dev = jnp.asarray(offd)[:, None]
    if norm == "min":
        measure = jnp.maximum(jnp.where(offd_dev, -dia.data, 0), 0)
    else:
        measure = jnp.where(offd_dev, jnp.abs(dia.data), 0)
    rowmax = jnp.max(measure, axis=0)
    return (measure >= theta * rowmax[None, :]) & (measure > 0)


def _hash_weights(n_pad, seed):
    """Deterministic pseudo-random tie-breaker weights in [0, 1)."""
    i = jnp.arange(n_pad, dtype=jnp.uint32)
    z = (i + jnp.uint32(seed) * jnp.uint32(0x9E3779B9))
    z = (z ^ (z >> 16)) * jnp.uint32(0x85EBCA6B)
    z = (z ^ (z >> 13)) * jnp.uint32(0xC2B2AE35)
    z = z ^ (z >> 16)
    return z.astype(jnp.float32) / jnp.float32(2 ** 32)


def device_luby_mis(dia: DIAMatrix, seed=0, valid=None):
    """Luby's maximal independent set over the DIA adjacency.

    state: -1 undecided, 1 in MIS, 0 excluded.  Each round, undecided
    vertices whose weight beats every undecided neighbor join the MIS;
    their neighbors are excluded.  Returns int8 (n_pad,) with padding
    rows excluded.
    """
    n_pad = dia.n_pad
    w = _hash_weights(n_pad, seed)
    if valid is None:
        valid = dia.diagonal() != 0
    state0 = jnp.where(valid, jnp.int8(-1), jnp.int8(0))

    def cond(state):
        return jnp.any(state == -1)

    def body(state):
        undecided = state == -1
        wv = jnp.where(undecided, w, -jnp.inf)
        nbr_max = neighbor_reduce_max(dia, wv)
        winners = undecided & (wv > nbr_max)
        state = jnp.where(winners, jnp.int8(1), state)
        # exclude neighbors of winners: a vertex with any winning neighbor
        excl = neighbor_reduce_max(
            dia, winners.astype(jnp.float32)) > 0.5
        state = jnp.where((state == -1) & excl, jnp.int8(0), state)
        return state

    return lax.while_loop(cond, body, state0)


def device_jp_coloring(dia: DIAMatrix, seed=0, max_colors=32):
    """Jones-Plassmann vertex coloring (smallest free color per round)."""
    n_pad = dia.n_pad
    w = _hash_weights(n_pad, seed)
    valid = dia.diagonal() != 0
    colors0 = jnp.where(valid, jnp.int32(-1), jnp.int32(-2))

    def cond(colors):
        return jnp.any(colors == -1)

    def body(colors):
        undecided = colors == -1
        wv = jnp.where(undecided, w, -jnp.inf)
        nbr_max = neighbor_reduce_max(dia, wv)
        winners = undecided & (wv > nbr_max)
        # smallest color unused by decided neighbors: bitmask of used
        # colors per vertex, folded over diagonals
        used = jnp.zeros(n_pad, dtype=jnp.uint32)
        for d, off in enumerate(dia.offsets):
            if off == 0:
                continue
            nbr_c = jnp.roll(colors, -off)
            has = (dia.data[d] != 0) & (nbr_c >= 0)
            shift = nbr_c.clip(0, max_colors - 1).astype(jnp.uint32)
            bit = jnp.where(has, jnp.uint32(1) << shift, jnp.uint32(0))
            used = used | bit
        # first zero bit
        free = jnp.zeros(n_pad, dtype=jnp.int32)
        taken = jnp.ones(n_pad, dtype=bool)
        for c in range(max_colors):
            bit_set = (used >> jnp.uint32(c)) & jnp.uint32(1)
            hit = taken & (bit_set == 0)
            free = jnp.where(hit, jnp.int32(c), free)
            taken = taken & ~hit
        return jnp.where(winners, free, colors)

    return lax.while_loop(cond, body, colors0)


def device_pmis_splitting(dia: DIAMatrix, strength_mask=None, seed=0):
    """PMIS C/F splitting over the DIA strength graph.

    Weights = (#strong dependents) + hash tie-breaker; rounds of weighted
    MIS -> C, neighbors -> F.  Returns int8: 0=F, 1=C (padding rows F).
    """
    if strength_mask is None:
        strength_mask = device_strength_mask(dia)
    sd = DIAMatrix(data=jnp.where(strength_mask, dia.data, 0),
                   offsets=dia.offsets, shape=dia.shape, nnz=dia.nnz)
    n_pad = dia.n_pad
    # lambda_i = number of strong dependents = column counts of S =
    # row counts of S^T; via rolls: sum over diagonals of shifted masks
    lam = jnp.zeros(n_pad, dtype=jnp.float32)
    for d, off in enumerate(sd.offsets):
        if off == 0:
            continue
        # entry (i, i+off) strong means i depends on j=i+off: j gains a
        # dependent -> scatter-free via roll in the opposite direction
        lam = lam + jnp.roll((sd.data[d] != 0).astype(jnp.float32), off)
    w = lam + _hash_weights(n_pad, seed)
    valid = dia.diagonal() != 0
    state0 = jnp.where(valid, jnp.int8(-1), jnp.int8(0))  # -1 und, 1 C, 0 F

    # symmetrized strong adjacency for the MIS rounds
    sym_masks = []
    for d, off in enumerate(sd.offsets):
        sym_masks.append(sd.data[d] != 0)

    def nbr_max_sym(x):
        out = jnp.full(n_pad, -jnp.inf, dtype=x.dtype)
        for d, off in enumerate(sd.offsets):
            if off == 0:
                continue
            m = sym_masks[d]
            out = jnp.maximum(out, jnp.where(m, jnp.roll(x, -off), -jnp.inf))
            # reverse edges (S^T)
            out = jnp.maximum(
                out, jnp.roll(jnp.where(m, x, -jnp.inf), off))
        return out

    def cond(state):
        return jnp.any(state == -1)

    def body(state):
        undecided = state == -1
        wv = jnp.where(undecided, w, -jnp.inf)
        winners = undecided & (wv > nbr_max_sym(wv))
        state = jnp.where(winners, jnp.int8(1), state)
        winf = winners.astype(jnp.float32)
        excl = nbr_max_sym(jnp.where(winners, winf, -jnp.inf)) > 0.5
        state = jnp.where((state == -1) & excl, jnp.int8(0), state)
        return state

    state = lax.while_loop(cond, body, state0)
    return jnp.where(state == 1, jnp.int8(1), jnp.int8(0))


def device_bellman_ford(dia: DIAMatrix, seed_mask, maxiter=None):
    """Multi-seed shortest-path distances by iterated min-plus rounds.

    seed_mask: boolean (n_pad,).  Returns distances (inf where
    unreachable).  The aggregation driver (Lloyd) assigns each vertex to
    the seed that attains its distance — recovered host-side.
    """
    n_pad = dia.n_pad
    dist0 = jnp.where(seed_mask, 0.0, jnp.inf)
    if maxiter is None:
        maxiter = n_pad

    def cond(carry):
        it, dist, changed = carry
        return changed & (it < maxiter)

    def body(carry):
        it, dist, _ = carry
        new = neighbor_reduce_min_plus(dia, dist)
        return (it + 1, new, jnp.any(new < dist))

    _, dist, _ = lax.while_loop(cond, body, (0, dist0, jnp.asarray(True)))
    return dist

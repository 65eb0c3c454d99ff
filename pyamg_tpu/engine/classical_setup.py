"""Device (jitted) classical Ruge-Stüben setup — on-device hierarchy
construction for the CLASSICAL AMG family on grid stencils.

The companion of :mod:`engine.device_setup` (SA) for the reference's
classical solver family (reference counterpart: [R]
pyamg/classical/classical.py::ruge_stuben_solver + split.py +
interpolate.py, SURVEY.md §2.2): strength-guided C/F coarsening, direct
interpolation from C neighbors, R = P^T, Galerkin RAP — all as ONE
jitted XLA program of rolls/reshapes/reduce-windows (zero gathers, zero
host round-trips; DESIGN.md rule 1).

A re-design for the device, not a port.  The reference's serial two-pass RS
splitting and per-row interpolation loops become, on a regular grid:

- **C/F splitting**: C-points are the stride-2 sublattice of the
  COARSENED dims (per-dim strides support SEMICOARSENING: a weakly
  coupled dim keeps stride 1 — the structured analog of only splitting
  along strong connections, [R] pyamg/classical/split.py semantics on a
  grid-aligned strength graph).  ``stride='auto'`` reads per-dim
  coupling strengths off the stencil exactly like ``device_sa_setup``.
- **multi-pass direct interpolation**: F-points with m off-sublattice
  coords interpolate in pass m from points with fewer (pass 1 = the
  reference's direct interpolation from C neighbors; later passes are
  the structured form of distance-two/standard interpolation, [R]
  pyamg/classical/interpolate.py::distance_two_interpolation — an
  (odd,odd) point on a 5-point stencil has NO C neighbor, the classic
  reason the reference grows interpolation through F-F connections).
  Each pass is an EMBEDDED fine-grid DIA operator S_m (identity on
  finished rows, interpolation weights on pass-m rows); the prolongator
  is the product P = S_dim · … · S_1 · D_C via `dia_spgemm` — pure
  rolls + FMAs.  Weights follow rs_direct_interpolation_pass2's
  positive/negative split: alpha = Σ_all a^- / Σ_targets a^-,
  beta = Σ_all a^+ / Σ_targets a^+ (positives lumped into the diagonal
  when no positive target exists), w_ij = -(alpha|beta)·a_ij / a_ii.
- **Galerkin RAP**: R = P^T by diagonal rolls; R·(A·P) through the
  static center-offset filter + strided compaction shared with the SA
  path.  The coarse stencil stays ≤ 3^d points at every level (P spans
  ±1 fine cell per dim, so RAP spans ≤ ±3, and only even offsets
  survive compaction — deltas ∈ {0, ±2} fine = {0, ±1} coarse).

Scope: scalar stencil operators on rectangular grids (2-D/3-D), the
classical family's structured problems (BASELINE config 3).  Grid-less
operators auto-route to the UNSTRUCTURED classical device pipeline
(round 5, :mod:`engine.unstructured_classical`: PMIS + modified
interpolation / Neumann AIR on windowed operators); the host path
(`ruge_stuben_solver` + `compile_hierarchy`) remains the parity
reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..sparse import DIAMatrix, dia_from_scipy
from ..sparse.dia import DenseOperator
from . import relaxation as device_relaxation
from .device_setup import (StructuredDeviceSolver, _compact_dia,
                           _compact_fine, _dia_spgemm_filtered,
                           _embed_coarse, _grid_pad_vec,
                           _grid_unpad_vec, _ns_pinv, _offset_to_coords,
                           _padded_grid, _power_rho,
                           _relayout_dia, _relayout_jit,
                           _smoother_device_arrays, _smoother_wrap,
                           _spec_key, _tup, dia_transpose)
from .hierarchy import DeviceHierarchy, DeviceLevel

__all__ = ["device_rs_setup", "device_air_setup", "EmbeddedProlongator",
           "EmbeddedRestrictor"]


# ---------------------------------------------------------------------------
# solve-phase transfer pytrees (materialized embedded P / R)
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class EmbeddedProlongator:
    """P stored as an embedded fine-grid DIA (columns live on C-point
    positions): P @ xc = P_emb @ embed(xc).  ≤3^d diagonals, so the
    apply is a handful of rolls — same data movement as the reference's
    CSR P apply ([R] pyamg/multilevel.py __solve), gather-free."""

    P_emb: DIAMatrix
    fine_grid_p: Tuple[int, ...]
    coarse_grid: Tuple[int, ...]
    coarse_grid_p: Tuple[int, ...]
    stride: Tuple[int, ...]
    center: Tuple[int, ...]

    def tree_flatten(self):
        return (self.P_emb,), (self.fine_grid_p, self.coarse_grid,
                               self.coarse_grid_p, self.stride, self.center)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (P_emb,) = children
        f, c, cp, s, ctr = aux
        return cls(P_emb=P_emb, fine_grid_p=f, coarse_grid=c,
                   coarse_grid_p=cp, stride=s, center=ctr)

    @property
    def nnz(self):
        # structural estimate for complexity reporting: every fine row
        # holds at most ndiags interpolation entries
        return int(np.prod(self.fine_grid_p)) * self.P_emb.ndiags

    @property
    def shape(self):
        return (int(np.prod(self.fine_grid_p)),
                int(np.prod(self.coarse_grid_p)))

    def __matmul__(self, xc):
        # the grid semantics live in the leading prod(coarse_grid_p)
        # entries of xc
        xc = xc[: int(np.prod(self.coarse_grid_p))]
        xc = _grid_unpad_vec(xc, self.coarse_grid, self.coarse_grid_p)
        e = _embed_coarse(xc, self.coarse_grid, self.stride, self.center)
        nf = int(np.prod(self.fine_grid_p))
        if self.P_emb.n_pad != nf:
            e = jnp.pad(e, (0, self.P_emb.n_pad - nf))
        return self.P_emb @ e


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class EmbeddedRestrictor:
    """R = P^T, applied as R_emb @ r then strided compaction at the
    C-point positions."""

    R_emb: DIAMatrix
    fine_grid_p: Tuple[int, ...]
    coarse_grid: Tuple[int, ...]
    coarse_grid_p: Tuple[int, ...]
    stride: Tuple[int, ...]
    center: Tuple[int, ...]

    def tree_flatten(self):
        return (self.R_emb,), (self.fine_grid_p, self.coarse_grid,
                               self.coarse_grid_p, self.stride, self.center)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (R_emb,) = children
        f, c, cp, s, ctr = aux
        return cls(R_emb=R_emb, fine_grid_p=f, coarse_grid=c,
                   coarse_grid_p=cp, stride=s, center=ctr)

    @property
    def nnz(self):
        return int(np.prod(self.fine_grid_p)) * self.R_emb.ndiags

    @property
    def shape(self):
        return (int(np.prod(self.coarse_grid_p)),
                int(np.prod(self.fine_grid_p)))

    @property
    def n_pad(self):
        return int(np.prod(self.coarse_grid_p))

    def __matmul__(self, r):
        y = (self.R_emb @ r)[: int(np.prod(self.fine_grid_p))]
        yc = _compact_fine(y, self.coarse_grid, self.stride, self.center)
        return _grid_pad_vec(yc, self.coarse_grid, self.coarse_grid_p)


# ---------------------------------------------------------------------------
# splitting + interpolation (traced)
# ---------------------------------------------------------------------------

def _oddness_masks(grid_p, stride, center):
    """Flat masks by pass class: mask[m] = points whose number of
    COARSENED dims with coord != center (mod stride) equals m.

    m = 0 is the C sublattice; m = 1..n_coarse_dims are the F passes
    (the structured C/F splitting — [R] pyamg/classical/split.py's
    F_NODE/C_NODE arrays become static-iota parity masks)."""
    dim = len(grid_p)
    ss = _tup(stride, dim)
    cc = _tup(center, dim)
    n_coarse_dims = sum(1 for s in ss if s > 1)
    oddness = jnp.zeros(grid_p, dtype=jnp.int32)
    for d in range(dim):
        if ss[d] == 1:
            continue
        od = (jnp.arange(grid_p[d]) % ss[d] != cc[d]).astype(jnp.int32)
        shape = [1] * dim
        shape[d] = grid_p[d]
        oddness = oddness + od.reshape(shape)
    flat = oddness.reshape(-1)
    return [(flat == m) for m in range(n_coarse_dims + 1)], n_coarse_dims


def _pass_interp(A_p: DIAMatrix, fmask, tmask, dtype):
    """One interpolation pass as an embedded DIA operator S.

    Pass-m rows (fmask) hold direct-interpolation weights toward target
    points (tmask: C and earlier-pass points); all other rows are
    identity.  Weight formula = rs_direct_interpolation_pass2 ([R]
    pyamg/amg_core/ruge_stuben.h, SURVEY.md §2.4) with 'targets' in
    place of 'strong C neighbors':

        alpha_i = Σ_{j≠i} a_ij^-  /  Σ_{j targets} a_ij^-
        beta_i  = Σ_{j≠i} a_ij^+  /  Σ_{j targets} a_ij^+
        w_ij = -(alpha_i | beta_i) · a_ij / ã_ii,

    positives lumped into the diagonal when no positive target exists
    (ã_ii = a_ii + Σ a^+); negatives likewise guarded (stencil rows
    always have a negative target in practice)."""
    diag = A_p.diagonal()
    neg_all = jnp.zeros_like(diag)
    pos_all = jnp.zeros_like(diag)
    neg_t = jnp.zeros_like(diag)
    pos_t = jnp.zeros_like(diag)
    t_ind = []
    for d, o in enumerate(A_p.offsets):
        if o == 0:
            t_ind.append(None)
            continue
        a = A_p.data[d]
        neg_all = neg_all + jnp.minimum(a, 0)
        pos_all = pos_all + jnp.maximum(a, 0)
        ind = jnp.roll(tmask, -o)          # entry (i, i+o) lands on target
        t_ind.append(ind)
        at = jnp.where(ind, a, 0)
        neg_t = neg_t + jnp.minimum(at, 0)
        pos_t = pos_t + jnp.maximum(at, 0)

    alpha = jnp.where(neg_t != 0,
                      neg_all / jnp.where(neg_t != 0, neg_t, 1), 0.0)
    beta = jnp.where(pos_t != 0,
                     pos_all / jnp.where(pos_t != 0, pos_t, 1), 0.0)
    # lump couplings with no usable target into the diagonal
    diag_eff = (diag + jnp.where(pos_t == 0, pos_all, 0)
                + jnp.where(neg_t == 0, neg_all, 0))
    diag_eff = jnp.where(diag_eff != 0, diag_eff, 1.0)

    rows = []
    offsets = []
    for d, o in enumerate(A_p.offsets):
        if o == 0:
            continue
        a = A_p.data[d]
        scale = jnp.where(a < 0, alpha, beta)
        w = jnp.where(fmask & t_ind[d], -(scale * a) / diag_eff, 0.0)
        offsets.append(o)
        rows.append(w.astype(dtype))
    # identity on non-pass rows, zero diagonal on pass rows
    offsets.append(0)
    rows.append(jnp.where(fmask, 0.0, 1.0).astype(dtype))
    order = np.argsort(offsets)
    n = A_p.n_pad
    return DIAMatrix(data=jnp.stack([rows[i] for i in order]),
                     offsets=tuple(int(offsets[i]) for i in order),
                     shape=(n, n), nnz=n * len(offsets))


def _span_filter(A: DIAMatrix, B: DIAMatrix, grid_p, bound):
    """Offset-sum candidates of A·B whose per-dim delta magnitude stays
    within ``bound`` (per-dim).  dia_spgemm keeps every STRUCTURAL offset
    sum; without pruning, structurally-zero diagonals (parity-forbidden
    interpolation paths) inflate the span and compound per level — the
    offset count explodes and compile time with it (measured: 32² hung).
    The parity argument (module docstring): with per-dim stencil span
    a_d, interpolation moves each dim at most once by ≤ a_d, so
    |delta_d| ≤ a_d exactly for a_d = 1 stencils (conservative for
    wider — multi-hop distance-3 paths are dropped; document)."""
    cand = set()
    for oa in A.offsets:
        for ob in B.offsets:
            oc = oa + ob
            try:
                coords = _offset_to_coords(oc, grid_p)
            except ValueError:
                continue
            if all(abs(c) <= b for c, b in zip(coords, bound)):
                cand.add(oc)
    return cand


def _rs_coarsen_level(A_p: DIAMatrix, grid_p, stride, center, dtype):
    """One device classical coarsening step: masks → multi-pass P →
    R = P^T → filtered Galerkin RAP → compaction."""
    masks, n_passes = _oddness_masks(grid_p, stride, center)
    cmask = masks[0]
    ss = _tup(stride, len(grid_p))
    # per-dim span of the fine stencil (bounds every interpolation move)
    a_span = [0] * len(grid_p)
    for o in A_p.offsets:
        for d, c in enumerate(_offset_to_coords(o, grid_p)):
            a_span[d] = max(a_span[d], abs(c))
    p_bound = tuple(a if s > 1 else 0 for a, s in zip(a_span, ss))
    # P = S_n · … · S_1 · D_C  (D_C = injection at the C sublattice)
    n = A_p.n_pad
    P_emb = DIAMatrix(
        data=jnp.where(cmask, 1.0, 0.0).astype(dtype)[None, :],
        offsets=(0,), shape=(n, n), nnz=n)
    tmask = cmask
    for m in range(1, n_passes + 1):
        S_m = _pass_interp(A_p, masks[m], tmask, dtype)
        P_emb = _dia_spgemm_filtered(
            S_m, P_emb, _span_filter(S_m, P_emb, grid_p, p_bound))
        tmask = tmask | masks[m]
    R_emb = dia_transpose(P_emb)
    rap_bound = tuple(max(s, a) for s, a in zip(ss, a_span))
    AP = _dia_spgemm_filtered(
        A_p, P_emb, _span_filter(A_p, P_emb, grid_p, rap_bound))
    cand = set()
    for oa in R_emb.offsets:
        for ob in AP.offsets:
            oc = oa + ob
            try:
                coords = _offset_to_coords(oc, grid_p)
            except ValueError:
                continue
            if all(c % s == 0 and abs(c) <= b
                   for c, s, b in zip(coords, ss, rap_bound)):
                cand.add(oc)
    Ac_emb = _dia_spgemm_filtered(R_emb, AP, cand)
    A_c = _compact_dia(Ac_emb, grid_p, stride, center)
    return P_emb, R_emb, A_c


@partial(jax.jit, static_argnames=("plan", "dtype", "pre_key", "post_key"))
def _rs_setup_pipeline(A_in, *, plan, dtype, pre_key, post_key):
    """The ENTIRE multi-level classical setup as ONE XLA program (same
    rationale as device_setup._setup_pipeline)."""
    cur = A_in
    out_levels = []
    for (grid, grid_p, strides) in plan:
        center = tuple(0 for _ in strides)
        A_p = _relayout_dia(cur, grid, grid_p)
        P_emb, R_emb, A_c = _rs_coarsen_level(A_p, grid_p, strides,
                                              center, dtype)
        diag = A_p.diagonal()
        dinv = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag, 1), 0)
        rho = _power_rho(A_p, dinv)
        pre_arr = _smoother_device_arrays(pre_key, A_p, dinv, rho, dtype)
        post_arr = _smoother_device_arrays(post_key, A_p, dinv, rho, dtype)
        out_levels.append((A_p, P_emb, R_emb, rho, pre_arr, post_arr))
        cur = A_c
    Ac_dense = cur @ jnp.eye(cur.n_pad, dtype=dtype)
    coarse_inv = _ns_pinv(Ac_dense)
    return tuple(out_levels), Ac_dense, coarse_inv


# ---------------------------------------------------------------------------
# AIR: one-point prolongation + local approximate ideal restriction
# ---------------------------------------------------------------------------

def _pass_onepoint(A_p: DIAMatrix, fmask, tmask, dtype):
    """One one-point-interpolation pass as an embedded DIA operator.

    Pass rows place a SINGLE 1 at their strongest target neighbor
    (|a_ij| max, first-wins tie break) — the structured form of [R]
    pyamg/classical/interpolate.py::one_point_interpolation (SURVEY.md
    §2.2 AIR row): P carries values, R does the work."""
    offs = [o for o in A_p.offsets if o != 0]
    scores = []
    for o in offs:
        d = A_p.offsets.index(o)
        ind = jnp.roll(tmask, -o)
        scores.append(jnp.where(ind, jnp.abs(A_p.data[d]), 0.0))
    smax = scores[0]
    for s in scores[1:]:
        smax = jnp.maximum(smax, s)
    rows = []
    offsets = []
    taken = jnp.zeros_like(fmask)        # first-wins tie break
    for o, s in zip(offs, scores):
        win = fmask & (~taken) & (s > 0) & (s == smax)
        taken = taken | win
        offsets.append(o)
        rows.append(jnp.where(win, 1.0, 0.0).astype(dtype))
    offsets.append(0)
    rows.append(jnp.where(fmask, 0.0, 1.0).astype(dtype))
    order = np.argsort(offsets)
    n = A_p.n_pad
    return DIAMatrix(data=jnp.stack([rows[i] for i in order]),
                     offsets=tuple(int(offsets[i]) for i in order),
                     shape=(n, n), nnz=n * len(offsets))


def _unrolled_solve(M, b, eps=1e-30):
    """Batched k×k dense solve, UNROLLED Gaussian elimination (no
    pivoting — the AIR neighborhoods are diagonally dominant;
    zero/missing pivots are guarded to identity rows).  Pure elementwise
    ops: exact in the working precision, with no tiny batched dots whose
    default precision may be reduced (TF32 on the GPU) and no batched
    LU.  Device analog of [R]
    pyamg/amg_core/air.h approx_ideal_restriction_pass2's per-row
    ``gelss``-style local solves (SURVEY.md §2.4)."""
    k = b.shape[1]
    rows = [[M[:, i, j] for j in range(k)] for i in range(k)]
    rhs = [b[:, i] for i in range(k)]
    pivs = []
    for p in range(k):
        piv = rows[p][p]
        ok = jnp.abs(piv) > eps
        piv = jnp.where(ok, piv, 1.0)
        pivs.append(piv)
        # zero out the row (and rhs) when the pivot is missing
        rhs[p] = jnp.where(ok, rhs[p], 0.0)
        for j in range(p + 1, k):
            rows[p][j] = jnp.where(ok, rows[p][j], 0.0)
        inv = 1.0 / piv
        for i in range(p + 1, k):
            f = rows[i][p] * inv
            for j in range(p + 1, k):
                rows[i][j] = rows[i][j] - f * rows[p][j]
            rhs[i] = rhs[i] - f * rhs[p]
    x = [None] * k
    for p in range(k - 1, -1, -1):
        acc = rhs[p]
        for j in range(p + 1, k):
            acc = acc - rows[p][j] * x[j]
        x[p] = acc / pivs[p]
    return jnp.stack(x, axis=1)


def _air_slots(A_p: DIAMatrix, grid_p, degree, span_cap=2):
    """Neighborhood slot offsets for local AIR of the given degree:
    distance-1 stencil offsets, plus (degree 2) their pairwise sums —
    the F points reachable through one F-F connection ([R]
    pyamg/classical/interpolate.py::local_air degree semantics).
    Per-dim spans are capped at ``span_cap`` so the neighborhood (and
    with it the coarse stencil) stays bounded level over level."""
    offs1 = [o for o in A_p.offsets if o != 0]
    slots = list(offs1)
    if degree >= 2:
        for oa in offs1:
            for ob in offs1:
                oc = oa + ob
                if oc == 0 or oc in slots:
                    continue
                try:
                    coords = _offset_to_coords(oc, grid_p)
                except ValueError:
                    continue
                if all(abs(c) <= span_cap for c in coords):
                    slots.append(oc)
    return slots


def _local_air_restriction(A_p: DIAMatrix, cmask, grid_p, dtype,
                           degree=2):
    """Local AIR as an embedded DIA operator.

    For every C point c with F-neighbor slots {c+o_p} (distance ≤ degree
    through the stencil graph, landing on F points), solve the local
    ideal-restriction system

        A_ff(N,N)^T r = -A_cf(c, N)^T,   R[c, c] = 1, R[c, c+o_p] = r_p

    ([R] pyamg/classical/interpolate.py::local_air +
    amg_core/air.h approx_ideal_restriction_pass2, SURVEY.md §2.2/2.4).
    Every quantity assembles by rolls: A[c+o_p, c+o_q] is diagonal
    (o_q - o_p) rolled by -o_p; missing couplings are stored zeros.
    On pure upwind advection with stride-2 splitting the F-F chains have
    depth 2, so the degree-2 neighborhood captures A_ff^{-1} EXACTLY and
    the two-level reduction is exact — the reference's signature
    behavior."""
    offs = _air_slots(A_p, grid_p, degree)
    k = len(offs)
    dlook = {o: d for d, o in enumerate(A_p.offsets)}
    diag = A_p.diagonal()
    fmask_any = ~cmask
    # slot validity: the neighbor exists (its diagonal is nonzero — real
    # row) and is an F point
    valid = []
    for o in offs:
        valid.append(jnp.roll(fmask_any & (diag != 0), -o))
    # M[:, p, q] = A[x+o_p, x+o_q] for rows x (only C rows used)
    Mcols = []
    for p, op in enumerate(offs):
        row = []
        for q, oq in enumerate(offs):
            rel = oq - op
            if p == q:
                a = jnp.roll(diag, -op)
            elif rel in dlook:
                a = jnp.roll(A_p.data[dlook[rel]], -op)
            else:
                a = jnp.zeros_like(diag)
            a = jnp.where(valid[p] & valid[q], a, 0.0)
            # missing slot -> identity row (guarded pivot keeps r_p = 0)
            if p == q:
                a = jnp.where(valid[p], a, 1.0)
            row.append(a)
        Mcols.append(row)
    # transpose the local system: solve A_ff^T r = -A_cf^T
    Mt = jnp.stack([jnp.stack([Mcols[q][p] for q in range(k)], axis=1)
                    for p in range(k)], axis=1)          # (n, k, k), M^T
    zero = jnp.zeros_like(diag)
    rhs = jnp.stack(
        [jnp.where(valid[p],
                   -A_p.data[dlook[op]] if op in dlook else zero, 0.0)
         for p, op in enumerate(offs)], axis=1)          # -A_cf row
    r = _unrolled_solve(Mt, rhs)
    n = A_p.n_pad
    rows = []
    offsets = []
    for p, op in enumerate(offs):
        offsets.append(op)
        rows.append(jnp.where(cmask & (diag != 0), r[:, p],
                              0.0).astype(dtype))
    offsets.append(0)
    rows.append(jnp.where(cmask & (diag != 0), 1.0, 0.0).astype(dtype))
    order = np.argsort(offsets)
    return DIAMatrix(data=jnp.stack([rows[i] for i in order]),
                     offsets=tuple(int(offsets[i]) for i in order),
                     shape=(n, n), nnz=n * len(offsets))


def _air_coarsen_level(A_p: DIAMatrix, grid_p, stride, center, dtype,
                       degree=2):
    """One device AIR coarsening step: one-point P, local AIR R,
    nonsymmetric (R ≠ P^T) Galerkin triple product.  The RAP span is
    capped at 2 coarse cells per dim (the degree-2 R reach) — the
    structured analog of the reference's strength-theta truncation of
    R/A_c ([R] pyamg/classical/air.py theta/degree controls), keeping
    the coarse stencil bounded level over level."""
    masks, n_passes = _oddness_masks(grid_p, stride, center)
    cmask = masks[0]
    ss = _tup(stride, len(grid_p))
    a_span = [0] * len(grid_p)
    for o in A_p.offsets:
        for d, c in enumerate(_offset_to_coords(o, grid_p)):
            a_span[d] = max(a_span[d], abs(c))
    p_bound = tuple(a if s > 1 else 0 for a, s in zip(a_span, ss))
    n = A_p.n_pad
    P_emb = DIAMatrix(
        data=jnp.where(cmask, 1.0, 0.0).astype(dtype)[None, :],
        offsets=(0,), shape=(n, n), nnz=n)
    tmask = cmask
    for m in range(1, n_passes + 1):
        S_m = _pass_onepoint(A_p, masks[m], tmask, dtype)
        P_emb = _dia_spgemm_filtered(
            S_m, P_emb, _span_filter(S_m, P_emb, grid_p, p_bound))
        tmask = tmask | masks[m]
    R_emb = _local_air_restriction(A_p, cmask, grid_p, dtype,
                                   degree=degree)
    rap_bound = tuple(2 * s if s > 1 else a for s, a in zip(ss, a_span))
    AP = _dia_spgemm_filtered(
        A_p, P_emb, _span_filter(A_p, P_emb, grid_p, rap_bound))
    cand = set()
    for oa in R_emb.offsets:
        for ob in AP.offsets:
            oc = oa + ob
            try:
                coords = _offset_to_coords(oc, grid_p)
            except ValueError:
                continue
            if all(c % s == 0 and abs(c) <= b
                   for c, s, b in zip(coords, ss, rap_bound)):
                cand.add(oc)
    Ac_emb = _dia_spgemm_filtered(R_emb, AP, cand)
    A_c = _compact_dia(Ac_emb, grid_p, stride, center)
    return P_emb, R_emb, A_c, cmask


@partial(jax.jit, static_argnames=("grid", "grid_p", "strides", "dtype",
                                   "degree"))
def _air_level_stage(cur, *, grid, grid_p, strides, dtype, degree):
    """ONE level of the AIR setup as its own XLA program.

    Round 4 (VERDICT item 6): the round-3 design fused the whole
    multi-level setup into one program, and XLA compile time grew
    steeply with level count (7-level 1024^2 did not finish in 40 min).
    Per-level programs compile near-linearly in depth — no host sync is
    lost because level boundaries exchange only device arrays with
    host-known (planned) shapes, so Python dispatches each stage
    asynchronously."""
    center = tuple(0 for _ in strides)
    A_p = _relayout_dia(cur, grid, grid_p)
    P_emb, R_emb, A_c, cmask = _air_coarsen_level(
        A_p, grid_p, strides, center, dtype, degree=degree)
    diag = A_p.diagonal()
    dinv = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag, 1), 0)
    fmask = (~cmask) & (diag != 0)
    cmask_r = cmask & (diag != 0)
    return (A_p, P_emb, R_emb, dinv, fmask, cmask_r), A_c


@partial(jax.jit, static_argnames=("dtype",))
def _air_coarse_stage(cur, *, dtype):
    Ac_dense = cur @ jnp.eye(cur.n_pad, dtype=dtype)
    return Ac_dense, _ns_pinv(Ac_dense)


def _air_setup_pipeline(A_in, *, plan, dtype, f_iterations, c_iterations,
                        omega, degree):
    """Multi-level AIR setup as a chain of per-level XLA programs."""
    del omega, f_iterations, c_iterations  # bound host-side
    cur = A_in
    out_levels = []
    for (grid, grid_p, strides) in plan:
        lvl, cur = _air_level_stage(cur, grid=grid, grid_p=grid_p,
                                    strides=strides, dtype=dtype,
                                    degree=degree)
        out_levels.append(lvl)
    Ac_dense, coarse_inv = _air_coarse_stage(cur, dtype=dtype)
    return tuple(out_levels), Ac_dense, coarse_inv


def device_air_setup(A, grid=None, dtype=jnp.float32, stride=2,
                     max_coarse=400, max_levels=4, degree=2,
                     f_iterations=2, c_iterations=1, omega=1.0,
                     mixed_precision=False):
    """Build an AIR (approximate ideal restriction) hierarchy ON DEVICE
    for a grid-stencil operator — the nonsymmetric classical family.

    Device companion of ``air_solver`` ([R] pyamg/classical/air.py,
    SURVEY.md §2.2 — the fork owner's signature algorithm): one-point
    prolongation (strongest-neighbor routing through the parity passes),
    degree-1 local AIR restriction via batched UNROLLED dense
    neighborhood solves (elementwise — no gathers, no reduced-precision
    dots), nonsymmetric Galerkin R·A·P, and the reference's
    F-then-C Jacobi post-smoothing (device ``masked_jacobi``).

    Defaults mirror the reference: postsmoother fc_jacobi with
    ``f_iterations=2, c_iterations=1``, no presmoother.  Use
    ``accel='fgmres'`` or ``'bicgstab'`` (nonsymmetric) when solving.

    **Depth guidance (measured):** the fixed-lattice splitting keeps the
    degree-2 restriction near-exact for ≤3 coarsenings (256² advection:
    first V-cycle drops the residual 1.6e6x with ``max_levels=4``); at
    4+ coarsenings the truncated local solves on the Galerkin coarse
    operators degrade (9.7x/cycle at ``max_levels=5`` — the reference's
    RS splitting adapts its C/F pattern to the flow, a lattice cannot).
    Hence ``max_levels=4`` by default: the ≤8k-point coarsest solves
    exactly through the dense pseudo-inverse.  For deeper
    hierarchies use ``cycle='W'`` or ``cycle='AMLI', amli_depth=3``
    with ``accel='fgmres'`` (measured at depth 5: 150x/W-cycle,
    1.3e3x first AMLI-3 cycle, 27 vs 22 fgmres iterations to 1e-10)
    or the host ``air_solver``.

    **Scale guidance:** a ONE-program setup compiled superlinearly in
    depth; the per-level split (:func:`_air_level_stage`) compiles one
    program per level (compile time on the GPU not measured yet).  The
    7-level 1024^2 setup (advection theta=pi/4) solves with
    ``cycle='W', accel='fgmres'`` in 30 iterations to 7e-9.  The
    near-exact single-cycle reductions still hold only <=3 coarsenings
    (the fixed-lattice C/F pattern, above); at depth, always
    Krylov-wrap.  For nonsymmetric problems where total wall time
    matters more than AIR semantics, :func:`device_rs_setup` remains
    faster end-to-end (recirc 1024^2: 0.5 s warm setup + 0.48 s mixed
    FGMRES to true 3e-10).
    """
    if jnp.dtype(dtype).itemsize == 8:
        jax.config.update("jax_enable_x64", True)
    if grid is None:
        if not (sp.issparse(A) or isinstance(A, np.ndarray)):
            raise ValueError("grid= is required for DIAMatrix inputs")
        from .device_setup import detect_grid
        try:
            grid = detect_grid(A)
        except ValueError:
            # not a grid stencil: route to unstructured AIR (round 5 —
            # PMIS + one-point P + Neumann ideal restriction on
            # windowed operators, engine/unstructured_classical.py)
            from .unstructured_classical import \
                device_unstructured_air_setup
            return device_unstructured_air_setup(
                A, dtype=dtype, degree=degree, max_coarse=max_coarse,
                max_levels=max_levels, f_iterations=f_iterations,
                c_iterations=c_iterations, omega=omega,
                mixed_precision=mixed_precision)
    grid = tuple(int(g) for g in grid)
    dim = len(grid)
    n = int(np.prod(grid))
    if sp.issparse(A) or isinstance(A, np.ndarray):
        if A.shape[0] != n:
            raise ValueError(f"grid {grid} does not match A {A.shape}")
        A_dia = dia_from_scipy(sp.csr_matrix(A), dtype=dtype, row_pad=1)
    elif isinstance(A, DIAMatrix):
        A_dia = A
    else:
        raise TypeError("A must be scipy sparse or DIAMatrix")

    plan = []
    cur_grid = grid
    while int(np.prod(cur_grid)) > max_coarse and len(plan) < max_levels - 1:
        strides = _tup(stride, dim)
        grid_p = _padded_grid(cur_grid, strides)
        if not all(gp >= 3 * s for gp, s in zip(grid_p, strides) if s > 1):
            break
        plan.append((cur_grid, grid_p, strides))
        cur_grid = tuple(g // s for g, s in zip(grid_p, strides))
    if not plan:
        raise ValueError(
            f"grid {grid} is below the coarsening threshold "
            f"(max_coarse={max_coarse}); use the host setup path")
    nlev = len(plan)

    out_levels, Ac_dense, coarse_inv = _air_setup_pipeline(
        A_dia, plan=tuple(plan), dtype=dtype,
        f_iterations=int(f_iterations), c_iterations=int(c_iterations),
        omega=float(omega), degree=int(degree))

    dev_levels = []
    infos = []
    for i, ((lv_grid, grid_p, strides),
            (A_p, P_emb, R_emb, dinv, fmask, cmask_r)) in enumerate(
                zip(plan, out_levels)):
        centers = tuple(0 for _ in strides)
        coarse_grid = tuple(g // s for g, s in zip(grid_p, strides))
        coarse_grid_p = (plan[i + 1][1] if i + 1 < nlev else coarse_grid)
        P = EmbeddedProlongator(
            P_emb=P_emb, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=strides, center=centers)
        R = EmbeddedRestrictor(
            R_emb=R_emb, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=strides, center=centers)
        # reference AIR: presmoother None, postsmoother fc_jacobi
        pre = device_relaxation.identity()
        post = device_relaxation.masked_jacobi(
            dinv, (fmask, cmask_r),
            iters_per_mask=(int(f_iterations), int(c_iterations)),
            omega=float(omega))
        npad_lvl = int(np.prod(grid_p))
        dev_levels.append(DeviceLevel(
            A=A_p, P=P, R=R, pre=pre, post=post, n=npad_lvl,
            n_pad=int(A_p.n_pad)))
        infos.append({"level": i, "n": npad_lvl, "strides": strides,
                      "ndiags": A_p.ndiags})

    nc = int(np.prod(cur_grid))
    ident = device_relaxation.identity()
    Ac_op = DenseOperator(data=Ac_dense, shape=(nc, nc), nnz=nc * nc)
    dev_levels.append(DeviceLevel(A=Ac_op, P=None, R=None, pre=ident,
                                  post=ident, n=nc, n_pad=nc))

    A64 = None
    if mixed_precision:
        jax.config.update("jax_enable_x64", True)
        A64_dia = dia_from_scipy(sp.csr_matrix(A), dtype=jnp.float64,
                                 row_pad=1)
        A64 = _relayout_jit(A64_dia, grid=grid, grid_p=plan[0][1])

    hier = DeviceHierarchy(levels=dev_levels, coarse_inv=coarse_inv,
                           nc=nc, nc_pad=nc, dtype=dtype, A64=A64)
    return StructuredDeviceSolver(
        hier, grid, plan[0][1],
        setup_info={"levels": infos, "nlevels": nlev + 1,
                    "family": "air"})


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def device_rs_setup(A, grid=None, dtype=jnp.float32, stride="auto",
                    max_coarse=400, max_levels=12,
                    presmoother=("jacobi", {"omega": 4.0 / 3.0}),
                    postsmoother=("jacobi", {"omega": 4.0 / 3.0}),
                    mixed_precision=False):
    """Build a classical (Ruge-Stüben) hierarchy ON DEVICE for a
    grid-stencil operator.

    The device companion of ``ruge_stuben_solver`` ([R]
    pyamg/classical/classical.py, SURVEY.md §2.2) for structured
    problems: C/F splitting = stride-2 sublattice of the strongly
    coupled dims, interpolation = multi-pass direct interpolation (see
    module docstring), R = P^T, Galerkin coarse operators, smoothers
    from on-device spectral-radius estimates.

    ``stride`` is 2, a per-dim tuple of 1/2 (semicoarsening), or
    ``'auto'`` (default): per-dim coupling read off the stencil, dims
    within 4x of the strongest coarsen (couplings rescale by 1/s² per
    level — the 1/h² law).  On grid-aligned anisotropy this reproduces
    the reference's strength-guided one-dimensional splitting.

    Smoothers: 'jacobi' / 'richardson' / 'chebyshev' specs — the device
    substitution for the reference's Gauss-Seidel default (DESIGN.md:
    multicolor GS belongs to the host-compiled path; the fused-Jacobi /
    Chebyshev forms are the device smoothers here).

    Returns a :class:`StructuredDeviceSolver`.
    """
    if jnp.dtype(dtype).itemsize == 8:
        jax.config.update("jax_enable_x64", True)
    if grid is None:
        if not (sp.issparse(A) or isinstance(A, np.ndarray)):
            raise ValueError("grid= is required for DIAMatrix inputs")
        from .device_setup import detect_grid
        try:
            grid = detect_grid(A)
        except ValueError:
            # not a grid stencil: route to the UNSTRUCTURED classical
            # device pipeline (round 5 — PMIS + modified interpolation
            # on windowed operators, engine/unstructured_classical.py).
            # Raises ValueError itself when not windowable either
            # (caller falls back to host setup).
            from .unstructured_classical import \
                device_unstructured_rs_setup
            kw = {}
            # pass smoothers through only when the caller overrode this
            # function's defaults — otherwise let the unstructured
            # pipeline use its own (jacobi x2, the symmetric-GS work
            # parity point measured round 5)
            _default = ("jacobi", {"omega": 4.0 / 3.0})
            if presmoother != _default:
                kw["presmoother"] = presmoother
            if postsmoother != _default:
                kw["postsmoother"] = postsmoother
            return device_unstructured_rs_setup(
                A, dtype=dtype, max_coarse=max_coarse,
                max_levels=max_levels, mixed_precision=mixed_precision,
                **kw)
    grid = tuple(int(g) for g in grid)
    dim = len(grid)
    n = int(np.prod(grid))
    if sp.issparse(A) or isinstance(A, np.ndarray):
        if A.shape[0] != n:
            raise ValueError(f"grid {grid} does not match A {A.shape}")
        A_dia = dia_from_scipy(sp.csr_matrix(A), dtype=dtype, row_pad=1)
    elif isinstance(A, DIAMatrix):
        A_dia = A
    else:
        raise TypeError("A must be scipy sparse or DIAMatrix")

    couple = None
    if stride == "auto":
        couple = []
        offs = dict(zip(A_dia.offsets, range(len(A_dia.offsets))))
        for d in range(dim):
            delta = int(np.prod(grid[d + 1:]))
            s_d = 0.0
            for o in (delta, -delta):
                if o in offs:
                    s_d = max(s_d, float(jnp.mean(jnp.abs(
                        A_dia.data[offs[o]]))))
            couple.append(s_d)
        if max(couple) == 0:
            couple = None

    def _level_strides(cpl):
        if cpl is None:
            return _tup(2 if stride == "auto" else stride, dim)
        smax = max(cpl)
        return tuple(2 if c * 4.0 >= smax else 1 for c in cpl)

    plan = []
    cur_grid = grid
    cur_couple = couple
    while int(np.prod(cur_grid)) > max_coarse and len(plan) < max_levels - 1:
        strides = _level_strides(cur_couple)
        grid_p = _padded_grid(cur_grid, strides)
        if not all(gp >= 3 * s for gp, s in zip(grid_p, strides) if s > 1):
            break
        plan.append((cur_grid, grid_p, strides))
        cur_grid = tuple(g // s for g, s in zip(grid_p, strides))
        if cur_couple is not None:
            cur_couple = [c / (s * s) for c, s in zip(cur_couple, strides)]
    if not plan:
        raise ValueError(
            f"grid {grid} is below the coarsening threshold "
            f"(max_coarse={max_coarse}); use the host setup path")
    nlev = len(plan)

    pre_key = _spec_key(presmoother)
    post_key = _spec_key(postsmoother)

    out_levels, Ac_dense, coarse_inv = _rs_setup_pipeline(
        A_dia, plan=tuple(plan), dtype=dtype, pre_key=pre_key,
        post_key=post_key)

    dev_levels = []
    infos = []
    for i, ((lv_grid, grid_p, strides),
            (A_p, P_emb, R_emb, rho, pre_arr, post_arr)) in enumerate(
                zip(plan, out_levels)):
        centers = tuple(0 for _ in strides)
        coarse_grid = tuple(g // s for g, s in zip(grid_p, strides))
        coarse_grid_p = (plan[i + 1][1] if i + 1 < nlev else coarse_grid)
        P = EmbeddedProlongator(
            P_emb=P_emb, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=strides, center=centers)
        R = EmbeddedRestrictor(
            R_emb=R_emb, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=strides, center=centers)
        pre = _smoother_wrap(pre_key, pre_arr)
        post = _smoother_wrap(post_key, post_arr)
        npad_lvl = int(np.prod(grid_p))
        dev_levels.append(DeviceLevel(
            A=A_p, P=P, R=R, pre=pre, post=post, n=npad_lvl,
            n_pad=int(A_p.n_pad)))
        infos.append({"level": i, "n": npad_lvl, "strides": strides,
                      "ndiags": A_p.ndiags, "rho_D_inv_A": rho})

    nc = int(np.prod(cur_grid))
    ident = device_relaxation.identity()
    Ac_op = DenseOperator(data=Ac_dense, shape=(nc, nc), nnz=nc * nc)
    dev_levels.append(DeviceLevel(A=Ac_op, P=None, R=None, pre=ident,
                                  post=ident, n=nc, n_pad=nc))

    A64 = None
    if mixed_precision:
        jax.config.update("jax_enable_x64", True)
        A64_dia = dia_from_scipy(sp.csr_matrix(A), dtype=jnp.float64,
                                 row_pad=1)
        A64 = _relayout_jit(A64_dia, grid=grid, grid_p=plan[0][1])

    hier = DeviceHierarchy(levels=dev_levels, coarse_inv=coarse_inv,
                           nc=nc, nc_pad=nc, dtype=dtype, A64=A64)
    return StructuredDeviceSolver(
        hier, grid, plan[0][1],
        setup_info={"levels": infos, "nlevels": nlev + 1,
                    "family": "classical"})

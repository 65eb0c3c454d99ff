"""Device SA setup for UNSTRUCTURED (non-grid) operators.

Every other device setup path requires a detectable stencil grid; FEM
meshes, graph Laplacians and friends would fall back to host setup.  This
module builds the SA hierarchy ON DEVICE for any operator with *bounded
column windows* under its ordering (the WindowedELL admissibility
condition — satisfied by naturally-ordered meshes; reorder with
``pyamg_tpu.graph.symmetric_rcm`` first otherwise).

Reference counterpart: [R] pyamg/aggregation/aggregation.py
_extend_hierarchy + amg_core standard_aggregation / fit_candidates +
scipy csr_matmat RAP (SURVEY.md §3.1).  The device design is NOT a
port — every stage is rebuilt on the windowed format:

- **graph passes** (strength, Luby-MIS roots, aggregate assignment) are
  elementwise functions of :meth:`WindowedELL.select` outputs — the
  "read x at my column" gather; neighbor reductions are maxima
  over the k slot axis.  Luby MIS roots + distance<=2 joining is the
  parallel equivalent of the reference's serial standard_aggregation
  (SURVEY.md §7 hard part 3: convergence-factor parity, not bitwise).
- **tentative/smoothed P** are constructed column-index-wise: the
  aggregate's coarse index is PROPAGATED through window selects,
  normalization uses one windowed transpose apply
  (norms^2 = T0^T B — fit_candidates' single-column QR), and
  P = (I - w D^-1 A) T materializes as k_A+1 slots per row with
  duplicate columns left unmerged (windowed applies sum duplicates).
- **RAP by banded chain probing**: A_c = P^T A P has host-plannable
  bounded row windows; probing with period P_e >= max window width
  recovers EXACT columns — Yall[:, d] = P^T(A(P v_d)) with
  v_d[c] = 1[c = d (mod P_e)] touches, per row, at most one supported
  column per residue, so every probe entry is a true A_c value or an
  exact zero.  The probes run as K=32 multi-RHS chains: the FIRST
  stage (P @ v_d) is pure elementwise work over P's own slots (the
  residue pattern is static), the rest through the K-lane
  matmat/rmatmat applies, and the banded layout is recovered with one
  per-block one-hot einsum.  Duplicate-column P slots are merged first
  (_merge_slots) — slot count multiplies every windowed apply.
  No SpGEMM.

Host involvement per level: ONE small D2H pull (the root mask) for the
static window planning, plus one scalar (coarse row-nnz bound).  All
values stay device-resident.

Scope: structurally-symmetric sparsity pattern (FEM/graph Laplacians;
the window plan bounds neighbor hulls through the pattern), real dtypes,
n < 2^24 (coarse indices ride f32-exact integer payloads through the
selections).
"""

from __future__ import annotations

from dataclasses import dataclass as _dataclass
from functools import partial

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax import lax

from ..sparse import TransposedWindowed, WindowedELL, pad_to, \
    windowed_from_scipy
from ..sparse.dia import DenseOperator
from . import relaxation as device_relaxation
from .device_setup import (_ns_pinv, _power_rho, _smoother_device_arrays,
                           _smoother_wrap, _spec_key)
from .hierarchy import DeviceHierarchy, DeviceLevel
from .setup import _hash_weights
from .solver import DeviceMultilevelSolver

__all__ = ["device_unstructured_sa_setup"]

_LANES = 128
# RAP probe chunk width (per-chunk fixed costs amortize over the K
# lanes; the per-lane work is constant)
_PROBE_K = 64


# ---------------------------------------------------------------------------
# host-side structural planning (pure numpy interval arithmetic)
# ---------------------------------------------------------------------------

_SPAN_GR = 64   # rows per span group (host planning granularity)


class _SpanPlan:
    """Host-side structural column-span tracker for hull planning.

    Per GROUP of ``gr`` consecutive rows, the min/max column index the
    operator's pattern touches — much tighter than the WindowedELL's
    per-block (1024-8192 row) windows, whose quantization inflated the
    probing period to ~nc on small block counts.  Level 0 builds spans
    from the host CSR; coarser levels derive them from the banded RAP
    plan (cstarts at bc granularity), so no coarse operator ever
    returns to host."""

    def __init__(self, n, gr, lo, hi):
        self.n = n
        self.gr = gr
        self.lo = lo        # (ngroups,) int64 min col (n if empty row)
        self.hi = hi        # (ngroups,) int64 max col + 1 (0 if empty)
        # sparse tables for EXACT O(1) range min/max (a prefix/suffix
        # trick is wrong here: min(suffix_min[g0], prefix_min[g1])
        # covers [0,g1] U [g0,end] = the whole axis, which degenerated
        # every hull to [0, n) and the probing period to ~nc)
        ng = len(lo)
        levels = max(int(np.log2(max(ng, 1))) + 1, 1)
        self._tmin = [lo]
        self._tmax = [hi]
        for j in range(1, levels):
            h = 1 << (j - 1)
            prev_min, prev_max = self._tmin[-1], self._tmax[-1]
            if h >= len(prev_min):
                break
            self._tmin.append(np.minimum(prev_min[:-h], prev_min[h:]))
            self._tmax.append(np.maximum(prev_max[:-h], prev_max[h:]))

    def _range_minmax(self, g0, g1):
        """Elementwise exact min(lo[g0..g1]), max(hi[g0..g1])."""
        length = g1 - g0 + 1
        j = np.clip(np.int64(np.log2(np.maximum(length, 1))), 0,
                    len(self._tmin) - 1)
        # guard: 2^j must be <= length; floating log2 can overshoot on
        # exact powers represented inexactly
        j = np.where((np.int64(1) << j) > length, j - 1, j)
        tm = self._tmin
        tM = self._tmax
        sz = np.array([len(t) for t in tm])
        g0b = np.minimum(g0, sz[j] - 1)
        g1b = np.clip(g1 - (np.int64(1) << j) + 1, 0, None)
        g1b = np.minimum(g1b, sz[j] - 1)
        out_lo = np.empty(len(g0), dtype=np.int64)
        out_hi = np.empty(len(g0), dtype=np.int64)
        for jj in np.unique(j):
            m = j == jj
            out_lo[m] = np.minimum(tm[jj][g0b[m]], tm[jj][g1b[m]])
            out_hi[m] = np.maximum(tM[jj][g0b[m]], tM[jj][g1b[m]])
        return out_lo, out_hi

    @classmethod
    def from_csr(cls, A, gr=_SPAN_GR):
        n = A.shape[0]
        ng = -(-max(n, 1) // gr)
        lo = np.full(ng * gr, np.int64(A.shape[1]))
        hi = np.zeros(ng * gr, dtype=np.int64)
        lens = np.diff(A.indptr)
        nz = lens > 0
        if A.nnz:
            lo[:n][nz] = A.indices[A.indptr[:-1][nz]]
            hi[:n][nz] = A.indices[A.indptr[1:][nz] - 1] + 1
        return cls(n, gr, lo.reshape(ng, gr).min(axis=1),
                   hi.reshape(ng, gr).max(axis=1))

    @classmethod
    def from_band(cls, nc, bc, band_lo, band_hi):
        """Next-level spans from the RAP band plan: coarse block b's
        rows touch coarse columns [band_lo[b], band_hi[b])."""
        return cls(nc, bc, band_lo.astype(np.int64),
                   band_hi.astype(np.int64))

    def _expand_once(self, lo, hi):
        ng = len(self.lo)
        g0 = np.clip(lo // self.gr, 0, ng - 1)
        g1 = np.clip((hi - 1) // self.gr, 0, ng - 1)
        out_lo, out_hi = self._range_minmax(g0.astype(np.int64),
                                            g1.astype(np.int64))
        return np.minimum(out_lo, lo), np.maximum(out_hi, hi)

    def hull(self, lo, hi, dist):
        for _ in range(dist):
            lo, hi = self._expand_once(lo, hi)
        return np.clip(lo, 0, self.n), np.clip(hi, 0, self.n)


def _plan_windows(cum, lo, hi):
    """Map fine-index intervals [lo, hi) to coarse-index intervals via
    the host cumsum of the root mask (cum[p] = #roots in [0, p])."""
    clo = cum[lo]                      # first coarse index at/after lo
    chi = cum[hi]                      # one past the last root < hi
    return clo, np.maximum(chi, clo + 1)


def _pick_geometry(col_lo, col_hi, block_rows, m_cols):
    """Choose (w2, starts) for a WindowedELL whose row block b must see
    columns [col_lo[b], col_hi[b]).  w2 = pow2 >= max width (>= 1024),
    starts[b] = clip(floor(col_lo/w2))."""
    width = int((col_hi - col_lo).max()) if len(col_lo) else 1
    w2 = 1024
    while w2 < width:
        w2 *= 2
    starts = np.minimum(col_lo // w2,
                        np.maximum((col_hi - 1) // w2 - 1, 0))
    starts = np.maximum(starts, 0).astype(np.int32)
    m_chunks = max(pad_to(max(m_cols, 1), w2) // w2,
                   int(starts.max()) + 2)
    return int(w2), starts, int(m_chunks)


# ---------------------------------------------------------------------------
# device stage A: strength + Luby MIS roots (jitted per geometry)
# ---------------------------------------------------------------------------

def _flat(v3, n_pad):
    """(nb, k, BLOCK) -> slot-wise (k, n) layout helpers collapse the
    block axis; rows are laid out block-major: flat = b*BLOCK + r."""
    nb, k, B = v3.shape
    return jnp.moveaxis(v3, 1, 0).reshape(k, nb * B)[:, :n_pad]


def _strength_mask(W: WindowedELL, theta):
    """Symmetric SA strength over the window slots:
    |a_ij| >= theta * sqrt(|a_ii a_jj|), off-diagonal, nonzero.
    Returns ((k, n) bool mask, (k, n) |a_ij| measure, (k, n) col)."""
    n_pad = W.n_pad
    diag = W.diagonal()
    gidx = (W.starts[:, None, None] * W.w2 + W.idx)      # (nb, k, BLOCK)
    rows = (jnp.arange(W.block)[None, None, :]
            + (jnp.arange(W.data.shape[0]) * W.block)[:, None, None])
    seld = W.select(diag)                                # a_jj per slot
    data = _flat(W.data, n_pad)
    col = _flat(gidx, n_pad)
    row = _flat(rows, n_pad)
    ajj = _flat(seld, n_pad)
    aii = diag[None, :] * jnp.ones((1,), dtype=diag.dtype)
    offd = (col != row) & (data != 0)
    thr = theta * jnp.sqrt(jnp.abs(jnp.broadcast_to(diag[None, :],
                                                    data.shape))
                           * jnp.abs(ajj))
    mask = offd & (jnp.abs(data) >= thr) & (jnp.abs(data) > 0)
    return mask, jnp.abs(data), col


@partial(jax.jit, static_argnames=("theta", "seed", "densify"))
def _stage_roots(W: WindowedELL, theta=0.0, seed=0, densify=True):
    """Strength + DISTANCE-2 Luby MIS over the windowed adjacency —
    the parallel analog of the reference's standard_aggregation, whose
    aggregate roots are distance-2 separated (every non-root ends up
    within 2 strong hops of a root, which is what _assign_cval's two
    joining rounds and the distance-2 T window hulls assume).  Returns
    the root mask (n,) f32 (1.0 at aggregate roots).

    ``densify=False`` skips the shell-promotion pass below: aggregates
    grow to radius 2 (AGGRESSIVE coarsening, ratio ~8-10 on 2-D meshes
    vs ~3 densified) — fewer/smaller coarse levels at a measured ~+4 CG
    iteration cost; _assign_cval's round 2 still covers every node the
    strength graph connects, and the T/P hulls are planned for the same
    two hops either way."""
    n_pad = W.n_pad
    diag = W.diagonal()
    valid = diag != 0
    mask, _, _ = _strength_mask(W, theta)
    w = _hash_weights(n_pad, seed)

    # "absent" rides the sentinel -1.0 (all weights live in [0, 1), all
    # indicator payloads in {0, 1}); the masked slot reduction below
    # uses -inf.
    def nbr_max(x):
        sel = _flat(W.select(x), n_pad)                  # (k, n)
        return jnp.max(jnp.where(mask, sel, -jnp.inf), axis=0)

    state0 = jnp.where(valid, jnp.int8(-1), jnp.int8(0))

    # Luby terminates in O(log n) rounds w.h.p.; the cap turns any
    # payload bug (e.g. NaN weights — comparisons all-false, no
    # winners, no progress) into a degraded aggregation instead of an
    # unkillable on-device infinite loop (a round-4 prototype hung the
    # chip exactly this way).  Capped leftovers stay non-root and relax
    # through smoothing.
    _MAX_ROUNDS = 64

    def cond(carry):
        it, state = carry
        return (it < _MAX_ROUNDS) & jnp.any(state == -1)

    def body(carry):
        it, state = carry
        und = state == -1
        wv = jnp.where(und, w, -1.0)
        # distance<=2 undecided max; the round trip through a neighbor
        # makes it self-inclusive, so winners compare with >= (hash
        # collisions at distance<=2 are vanishingly rare and only cost
        # two nearby roots, never correctness)
        m2 = nbr_max(jnp.maximum(wv, jnp.maximum(nbr_max(wv), -1.0)))
        winners = und & (wv >= m2)
        state = jnp.where(winners, jnp.int8(1), state)
        e1 = nbr_max(jnp.where(winners, 1.0, 0.0)) > 0.5
        e2 = nbr_max(jnp.where(e1, 1.0, 0.0)) > 0.5
        return it + 1, jnp.where((state == -1) & (e1 | e2), jnp.int8(0),
                                 state)

    _, state = lax.while_loop(cond, body, (0, state0))
    root = state == 1
    if not densify:
        return root.astype(jnp.float32)

    # DENSIFY (convergence parity with the reference's greedy pass,
    # measured +4 CG iters without it): the MIS-2 random packing leaves
    # many nodes at distance exactly 2 from every root, where greedy
    # standard_aggregation leaves every node ADJACENT to its root after
    # pass 1.  Promote a maximal independent subset (distance-1 Luby)
    # of the uncovered shell S = {valid, non-root, no root neighbor} to
    # secondary roots — afterwards every node is within one strong hop
    # of a root, matching the reference's aggregate granularity.
    adj_root = nbr_max(jnp.where(root, 1.0, 0.0)) > 0.5
    shell = valid & ~root & ~adj_root
    state2_0 = jnp.where(shell, jnp.int8(-1), jnp.int8(0))

    def body2(carry):
        it, s = carry
        und = s == -1
        wv = jnp.where(und, w, -1.0)
        winners = und & (wv >= jnp.maximum(nbr_max(wv), -1.0))
        s = jnp.where(winners, jnp.int8(1), s)
        e1 = nbr_max(jnp.where(winners, 1.0, 0.0)) > 0.5
        return it + 1, jnp.where((s == -1) & e1, jnp.int8(0), s)

    _, state2 = lax.while_loop(cond, body2, (0, state2_0))
    return (root | (state2 == 1)).astype(jnp.float32)


# ---------------------------------------------------------------------------
# device stage B: assignment, tentative, smoothed P (jitted per plan)
# ---------------------------------------------------------------------------

def _assign_cval(W, mask, root_f, theta_unused, maxrounds=2):
    """Aggregate coarse index per node, propagated through window
    selects: roots take their own cumsum index; round 1 joins the
    strongest adjacent root; round 2 joins the strongest ASSIGNED
    neighbor's aggregate (the reference's leftover pass).  MIS-2
    maximality bounds every reachable node at distance<=2 from a root,
    so exactly two rounds assign everything the strength graph connects
    — and the T/P window hulls are planned for those two hops
    (maxrounds MUST NOT exceed the driver's hull distances).  Returns
    (cval f32 (n,), assigned bool (n,))."""
    n_pad = W.n_pad
    diag = W.diagonal()
    valid = diag != 0
    cum = jnp.cumsum(root_f) - root_f          # coarse index at roots
    cval = jnp.where(root_f > 0.5, cum, -1.0)
    absd = _flat(jnp.abs(W.data), n_pad)

    def round_(cval):
        selc = _flat(W.select(cval), n_pad)              # neighbor cval
        cand = jnp.where(mask & (selc >= 0), absd, -jnp.inf)
        best = jnp.max(cand, axis=0)
        # first slot attaining the max (iota tie-break)
        k = cand.shape[0]
        is_best = (cand == best[None, :]) & jnp.isfinite(cand)
        first = jnp.argmax(is_best, axis=0)
        sel_best = jnp.sum(
            jnp.where(jnp.arange(k)[:, None] == first[None, :], selc, 0.0),
            axis=0)
        newly = (cval < 0) & valid & jnp.isfinite(best)
        return jnp.where(newly, sel_best, cval)

    def cond(carry):
        it, cval = carry
        return (it < maxrounds) & jnp.any((cval < 0)
                                          & valid)

    def body(carry):
        it, cval = carry
        return it + 1, round_(cval)

    _, cval = lax.while_loop(cond, body, (0, cval))
    # stragglers (disconnected under the strength mask): self-aggregate
    # is impossible without becoming a root — park them on the nearest
    # root index 0 with ZERO tentative weight (they relax via smoothing)
    assigned = cval >= 0
    cval = jnp.where(assigned, cval, 0.0)
    return cval, assigned & valid


def _make_windowed(vals_kn, cols_kn, n, geometry, dtype, nnz):
    """Assemble a WindowedELL from slot-wise (k, n) value/column arrays
    (device) + host geometry (block, w2, starts, m_chunks)."""
    block, w2, starts, m_chunks = geometry
    n_pad = pad_to(n, block)
    k = vals_kn.shape[0]
    padw = n_pad - vals_kn.shape[1]
    if padw:
        vals_kn = jnp.pad(vals_kn, ((0, 0), (0, padw)))
        cols_kn = jnp.pad(cols_kn, ((0, 0), (0, padw)))
    nb = n_pad // block
    starts_dev = jnp.asarray(starts, dtype=jnp.int32)
    base = (starts_dev.astype(jnp.float32) * w2)[:, None, None]
    v3 = jnp.moveaxis(vals_kn.reshape(k, nb, block), 1, 0)
    c3 = jnp.moveaxis(cols_kn.reshape(k, nb, block), 1, 0)
    local = c3 - base
    # zero slots may carry garbage columns — clamp them in range
    local = jnp.clip(jnp.where(v3 != 0, local, 0.0), 0, 2 * w2 - 1)
    idx = jnp.round(local).astype(jnp.int32)
    return WindowedELL(data=v3.astype(dtype), idx=idx,
                       starts=starts_dev, shape=(n, geometry_cols(
                           m_chunks, w2)),
                       block=block, w2=w2, m_chunks=m_chunks, nnz=nnz)


def geometry_cols(m_chunks, w2):
    return m_chunks * w2


@partial(jax.jit, static_argnames=("theta", "omega", "dtype", "t_geom",
                                   "p_geom", "improve_iters", "s_geom"))
def _stage_build_p(W, root_f, B_in, *, theta, omega, dtype, t_geom,
                   p_geom, improve_iters=0, s_geom=None):
    """Assignment + tentative + smoothed prolongator, one XLA program.

    ``s_geom`` (round 5, aggressive-mode quality): when given (A's own
    window geometry), additionally build the SECOND smoothing factor
    S = I - omega D^-1 A as a windowed operator sharing A's pattern —
    the caller composes P2 = S . P (ComposedWindowed) for a
    double-smoothed prolongator without any SpGEMM.  The identity rides
    a DEDICATED extra slot (clamped zero-pad slots can alias the
    diagonal position; a shared slot would double-count).

    Returns (T, P, dinv, rho, Bc_padded, cval, S_or_None)."""
    n = W.shape[0]
    n_pad = W.n_pad
    diag = W.diagonal()
    valid = diag != 0
    dinv = jnp.where(valid, 1.0 / jnp.where(valid, diag, 1), 0)
    mask, _, _ = _strength_mask(W, theta)
    cval, assigned = _assign_cval(W, mask, root_f, theta)

    Bv = (jnp.where(valid, 1.0, 0.0) if B_in is None
          else jnp.where(valid, B_in, 0.0))
    rho = _power_rho(W, dinv)
    if improve_iters:
        om_i = 1.0 / jnp.maximum(rho, 1e-30)
        for _ in range(improve_iters):
            Bv = Bv - om_i * (dinv * (W @ Bv))
        Bv = Bv / jnp.maximum(jnp.max(jnp.abs(Bv)), 1e-30)

    tvals = jnp.where(assigned, Bv, 0.0)
    # unnormalized tentative T0: row i -> column cval(i), value B_i
    T0 = _make_windowed(tvals[None, :], cval[None, :], n, t_geom, dtype,
                        nnz=n)
    # fit_candidates single-column QR: norms^2 = T0^T B, coarse B = norms
    norms2 = T0.rmatvec(jnp.pad(tvals.astype(dtype),
                                (0, T0.n_pad - n_pad)))
    norms = jnp.sqrt(jnp.maximum(norms2, 0.0))
    seln = _flat(T0.select(norms.astype(jnp.float32)), n_pad)[0]
    tv = jnp.where(seln > 0, tvals / jnp.where(seln > 0, seln, 1), 0.0)
    T = _make_windowed(tv[None, :], cval[None, :], n, t_geom, dtype,
                       nnz=n)

    # P = (I - omega D^-1 A) T: k_A slots (columns cval(j), values
    # -omega dinv_i a_ij tv_j) + 1 slot (cval(i), tv_i); duplicates
    # unmerged (windowed applies sum duplicate columns)
    om = omega / jnp.maximum(rho, 1e-30)
    sel_cval = _flat(W.select(cval), n_pad)              # (k, n)
    sel_tv = _flat(W.select(tv.astype(jnp.float32)), n_pad)
    data = _flat(W.data, n_pad)
    pvals = -(om * dinv)[None, :] * data * sel_tv
    pcols = jnp.where(data != 0, sel_cval, 0.0)
    pvals = jnp.where(data != 0, pvals, 0.0)
    pvals_all = jnp.concatenate([tv[None, :], pvals], axis=0)
    pcols_all = jnp.concatenate([cval[None, :], pcols], axis=0)
    P = _make_windowed(pvals_all, pcols_all, n, p_geom, dtype,
                       nnz=int((W.nnz + n)))
    S = None
    if s_geom is not None:
        gidx = (W.starts[:, None, None] * W.w2 + W.idx)
        rows3 = (jnp.arange(W.block)[None, None, :]
                 + (jnp.arange(W.data.shape[0])
                    * W.block)[:, None, None])
        colf = _flat(gidx, n_pad).astype(jnp.float32)
        rowf = _flat(rows3, n_pad).astype(jnp.float32)
        ident = jnp.where(valid, 1.0 - om * dinv * diag, 1.0)
        offv = jnp.where((colf != rowf) & (data != 0),
                         -(om * dinv)[None, :] * data, 0.0)
        own_col = jnp.arange(n_pad, dtype=jnp.float32)
        s_vals = jnp.concatenate([ident[None, :], offv], axis=0)
        s_cols = jnp.concatenate([own_col[None, :], colf], axis=0)
        S = _make_windowed(s_vals, s_cols, n, s_geom, dtype,
                           nnz=int(W.nnz + n))
    return T, P, dinv.astype(dtype), rho, norms, cval, S


# ---------------------------------------------------------------------------
# RAP by banded chain probing
# ---------------------------------------------------------------------------

@jax.jit
def _max_distinct(P: WindowedELL):
    """Max over rows of the number of DISTINCT live columns (device
    scalar; one tiny pull decides whether slot-merging pays)."""
    n_pad = P.n_pad
    vals = _flat(P.data, n_pad)
    cols = _flat((P.starts[:, None, None] * P.w2 + P.idx), n_pad)
    live = vals != 0
    k = vals.shape[0]
    same = (cols[None, :, :] == cols[:, None, :]) \
        & live[None, :, :] & live[:, None, :]
    earlier = jnp.arange(k)[None, :, None] < jnp.arange(k)[:, None, None]
    first = live & ~jnp.any(same & earlier, axis=1)
    return jnp.max(jnp.sum(first.astype(jnp.int32), axis=0))


@partial(jax.jit, static_argnames=("k_new", "geometry", "dtype"))
def _merge_slots(P: WindowedELL, *, k_new, geometry, dtype):
    """Merge duplicate-column slots and compact to ``k_new`` slots.

    The smoothed prolongator materializes one slot per A-entry, but
    neighbors in the same aggregate share a coarse column — at a 640k
    FEM level 1 that is 26 slots holding ~8 distinct columns, and slot
    count multiplies the cost of EVERY windowed apply (probe chains and
    solve-phase transfers alike).  Merge = k x k same-column pass
    (elementwise), compact = k_new rounds of top-|value| one-hot
    extraction; with k_new = the measured max distinct count nothing is
    dropped, so the merged operator is exactly equal (up to f32
    summation order of duplicate slots, which the apply kernels were
    summing anyway)."""
    n = P.shape[0]
    n_pad = P.n_pad
    vals = _flat(P.data, n_pad)
    cols = _flat((P.starts[:, None, None] * P.w2 + P.idx), n_pad)
    live = vals != 0
    k = vals.shape[0]
    same = (cols[None, :, :] == cols[:, None, :]) \
        & live[None, :, :] & live[:, None, :]
    earlier = jnp.arange(k)[None, :, None] < jnp.arange(k)[:, None, None]
    first = live & ~jnp.any(same & earlier, axis=1)
    merged = jnp.sum(jnp.where(same, vals[None, :, :], 0), axis=1)
    mvals = jnp.where(first, merged, 0.0)
    out_v = []
    out_c = []
    cur = mvals
    ki = jnp.arange(k)[:, None]
    for _ in range(k_new):
        a = jnp.abs(cur)
        m = jnp.max(a, axis=0)
        hit = (ki == jnp.argmax(a == m[None, :], axis=0)[None, :]) \
            & (a > 0)
        out_v.append(jnp.sum(jnp.where(hit, cur, 0.0), axis=0))
        out_c.append(jnp.sum(jnp.where(hit, cols, 0), axis=0))
        cur = jnp.where(hit, 0.0, cur)
    return _make_windowed(jnp.stack(out_v),
                          jnp.stack(out_c).astype(jnp.float32), n,
                          geometry, dtype, nnz=int(n * k_new))


@partial(jax.jit, static_argnames=("key", "dtype"))
def _smoother_arrays_jit(key, A_w, dinv, rho, *, dtype):
    """Jitted smoother-array construction for the unstructured drivers.

    The structured pipelines build smoother arrays INSIDE their one
    setup program; the unstructured drivers called
    _smoother_device_arrays eagerly — harmless for jacobi (no compute)
    but the chebyshev branch runs a 40-step power iteration whose
    eager dispatch is one small program per step."""
    return _smoother_device_arrays(key, A_w, dinv, rho, dtype)


def _p_residue_matmat(P, d0, K, period, nc_pad, n_pad):
    """P @ V_d for residue one-hot probes WITHOUT a windowed apply.

    V_d's columns are c ≡ d (mod period), c < nc_pad — so P @ V_d is a
    pure elementwise reduction over P's own slots:
    Y[i, lane] = Σ_slots pval · 1[pcol ≡ d0+lane (mod period)].
    The probe vectors' pattern is KNOWN statically, so the first chain
    stage is O(k·K) elementwise work over P's slots."""
    if isinstance(P, ComposedWindowed):
        Y = _p_residue_matmat(P.factors[-1], d0, K, period, nc_pad,
                              P.factors[-1].n_pad)
        for f in reversed(P.factors[:-1]):
            Y = f.matmat(Y)
        return Y[:n_pad]
    lane = d0 + jnp.arange(K)
    pcol = (P.starts[:, None, None] * P.w2 + P.idx)       # (nb,k,B)
    hit = ((pcol[..., None] % np.int32(period))
           == lane[None, None, None, :])
    hit = hit & (pcol[..., None] < nc_pad)
    hit = hit & (P.data[..., None] != 0)
    Y = jnp.sum(jnp.where(hit, P.data[..., None], 0), axis=1)
    return Y.reshape(-1, K)[:n_pad]                       # (n_pad, K)


@partial(jax.jit, static_argnames=("period", "K", "nc_pad", "bc",
                                   "dtype"))
def _probe_rap(A_w, P, cstarts, *, period, K, nc_pad, bc, dtype):
    """A_c = P^T A P recovered exactly by banded probing (module
    docstring).  ``cstarts`` (nb_c,) int32 = per-coarse-block window
    starts; returns banded A_band (nb_c, bc, period).

    Memory shape: the probe results are PLACED into the band as they
    stream — each K-probe chunk lands via an exact one-hot product
    (full precision; one nonzero term per output) — so only
    A_band (nc_pad x period) is ever resident, never a second
    (nc_pad x period) residue matrix plus its doubled copy."""
    n_pad = A_w.n_pad
    nchunks = -(-period // K)
    nb_c = nc_pad // bc
    w_iota = jnp.arange(period)

    def chain(d0):
        Y1 = _p_residue_matmat(P, d0, K, period, nc_pad, n_pad)
        Y2 = A_w.matmat(Y1)
        Y3 = P.rmatmat(Y2[: P.n_pad] if P.n_pad <= n_pad
                       else jnp.pad(Y2, ((0, P.n_pad - n_pad), (0, 0))))
        return Y3[:nc_pad]                               # (nc_pad, K)

    def body(c, A_band):
        Yc = chain(c * K).astype(jnp.float32)            # (nc_pad, K)
        Y3 = Yc.reshape(nb_c, bc, K)
        # placement one-hot: residue d = c*K + j lands at band position
        # w = (d - cstart_b) mod period for coarse block b; probe
        # columns beyond `period` (K-padding) place nowhere
        d = c * K + jnp.arange(K)
        oh = ((jnp.remainder(d[None, :, None] - cstarts[:, None, None],
                             np.int32(period)) == w_iota[None, None, :])
              & (d[None, :, None] < period))             # (nb_c, K, Pw)
        # exact placement: one nonzero term per output, full precision
        acc = jnp.einsum("brj,bjw->brw", Y3, oh.astype(jnp.float32),
                         precision=lax.Precision.HIGHEST)
        return A_band + acc.astype(dtype)

    A_band = jnp.zeros((nb_c, bc, period), dtype=dtype)
    return lax.fori_loop(0, nchunks, body, A_band)


@partial(jax.jit, static_argnames=("kc",))
def _extract_topk(A_band, kc):
    """Top-|kc| extraction per row of the banded coarse operator:
    kc rounds of (argmax |value|, record, mask) — gather-free.  Returns
    (vals (kc, nb_c*bc), ws (kc, nb_c*bc) band positions)."""
    nb_c, bc, W = A_band.shape
    flat = A_band.reshape(nb_c * bc, W)
    vals = []
    ws = []
    cur = flat
    wi = jnp.arange(W)[None, :]
    for _ in range(kc):
        a = jnp.abs(cur)
        m = jnp.max(a, axis=1)
        first = jnp.argmax(a == m[:, None], axis=1)
        hit = wi == first[:, None]
        v = jnp.sum(jnp.where(hit, cur, 0.0), axis=1)
        v = jnp.where(m > 0, v, 0.0)
        vals.append(v)
        ws.append(jnp.where(m > 0, first, 0))
        cur = jnp.where(hit, 0.0, cur)
    return jnp.stack(vals), jnp.stack(ws).astype(jnp.float32)


@jax.jit
def _band_nnz_max(A_band):
    return jnp.max(jnp.sum((A_band != 0).astype(jnp.int32), axis=-1))


@partial(jax.jit, static_argnames=("gr",))
def _col_bounds(vals, cols, *, gr):
    """Per-``gr``-row-group [min, max] column of the extracted coarse
    operator (device; two tiny vectors for the host pull).  Empty
    groups return (+inf, -inf) — the host clamps them.

    The hull-planned coarse windows overestimated the true A_c support
    ~4x (640k FEM: level-1 w2 4096 where the measured band fits in w2
    1024).  Measuring the support costs one
    ~nb-element D2H pull per level and shrinks both the next level's
    apply cost and its probe period."""
    kc, n = vals.shape
    ng = -(-n // gr)
    pad = ng * gr - n
    if pad:
        vals = jnp.pad(vals, ((0, 0), (0, pad)))
        cols = jnp.pad(cols, ((0, 0), (0, pad)))
    live = vals != 0
    cm = jnp.where(live, cols, jnp.inf).reshape(kc, ng, gr)
    cM = jnp.where(live, cols, -jnp.inf).reshape(kc, ng, gr)
    return jnp.min(cm, axis=(0, 2)), jnp.max(cM, axis=(0, 2))


@partial(jax.jit, static_argnames=("nc", "nc_pad"))
def _band_to_dense(A_band, cstarts, *, nc, nc_pad):
    """Materialize the (small) coarsest banded operator densely:
    dense[b*bc + r, cstart_b + w] = A_band[b, r, w] via one-hot einsum."""
    nb_c, bc, W = A_band.shape
    cols = jnp.arange(nc_pad)
    oh = ((cstarts[:, None, None] + jnp.arange(W)[None, :, None])
          == cols[None, None, :]).astype(A_band.dtype)   # (nb_c, W, nc)
    dense = jnp.einsum("brw,bwc->brc", A_band, oh,
                       precision=lax.Precision.HIGHEST)
    return dense.reshape(nb_c * bc, nc_pad)[:nc_pad]


def _rcm_perm(A):
    """RCM permutation over the symmetrized structure |A| + |A^T|
    (host planning only; handles nonsymmetric patterns)."""
    from scipy.sparse import csgraph
    Aa = sp.csr_matrix((np.abs(A.data), A.indices, A.indptr),
                       shape=A.shape)
    S = (Aa + Aa.T).tocsr()
    return np.asarray(csgraph.reverse_cuthill_mckee(
        S, symmetric_mode=True)).astype(np.int64)


class ReorderedSolver:
    """Solve-phase wrapper for hierarchies built in RCM-permuted space
    (round 5, VERDICT r4 item 4): when an operator is not windowable
    under its native ordering, the unstructured setups reorder with RCM
    (``graph.symmetric_rcm`` semantics), build on device in permuted
    space, and this wrapper permutes b / un-permutes x around each
    solve.  The permutation itself runs HOST-side (NumPy fancy
    indexing).  The residual history is
    ordering-invariant, so convergence behavior matches a manual
    pre-reordering exactly."""

    def __init__(self, inner, perm):
        self._inner = inner
        self._perm = np.asarray(perm)
        self._iperm = np.argsort(self._perm)
        self.hierarchy = inner.hierarchy
        self.setup_info = dict(getattr(inner, "setup_info", {}))
        self.setup_info["reordered"] = "rcm"

    def solve(self, b, x0=None, **kw):
        if kw.get("device_out"):
            raise ValueError(
                "device_out is unsupported on auto-reordered solves "
                "(the un-permutation runs host-side); reorder the "
                "operator yourself to keep the solution on device")
        bp = np.asarray(b)[self._perm]
        if x0 is not None:
            x0 = np.asarray(x0)[self._perm]
        out = self._inner.solve(bp, x0=x0, **kw)
        if isinstance(out, tuple):          # return_info=True
            x, info = out
            return np.asarray(x)[self._iperm], info
        return np.asarray(out)[self._iperm]


def _unflat(v_kn, nb, block, n_pad):
    """(k, n) slot-wise -> (nb, k, BLOCK) block layout (inverse of
    :func:`unstructured_setup._flat`)."""
    k = v_kn.shape[0]
    pad = nb * block - v_kn.shape[1]
    if pad:
        v_kn = jnp.pad(v_kn, ((0, 0), (0, pad)))
    return jnp.moveaxis(v_kn.reshape(k, nb, block), 0, 1)


@jax.tree_util.register_pytree_node_class
@_dataclass(frozen=True)
class ComposedWindowed:
    """Product of windowed factors, applied right-to-left: P = F0 · F1
    (P @ x = F0 @ (F1 @ x)).  The device form of the reference's modified
    classical interpolation ([R] amg_core
    rs_classical_interpolation_pass2): instead of materializing the
    distance-two product by SpGEMM (whose unstructured windowed form
    doesn't exist), keep the factors and compose applies — the banded
    RAP probe and the solve-phase transfers only ever need matvec/
    matmat, and duplicate-column summation is the windowed kernels'
    native behavior."""

    factors: tuple          # (F0, F1, ...) applied right-to-left

    def tree_flatten(self):
        return (self.factors,), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        (factors,) = children
        return cls(factors=factors)

    @property
    def shape(self):
        return (self.factors[0].shape[0], self.factors[-1].shape[1])

    @property
    def nnz(self):
        # structural estimate (complexity reporting): the composed row
        # support is bounded by the product of factor row supports
        k = 1
        for f in self.factors:
            k *= max(f.nnz // max(f.shape[0], 1), 1)
        return int(self.shape[0] * k)

    @property
    def n_pad(self):
        return self.factors[0].n_pad

    @property
    def m_chunks(self):
        return self.factors[-1].m_chunks

    @property
    def w2(self):
        return self.factors[-1].w2

    def matvec(self, x):
        for f in reversed(self.factors):
            x = f.matvec(x)
        return x

    def matmat(self, X):
        for f in reversed(self.factors):
            X = f.matmat(X)
        return X

    def rmatvec(self, x):
        for f in self.factors:
            x = f.rmatvec(x)
        return x

    def rmatmat(self, X):
        for f in self.factors:
            X = f.rmatmat(X)
        return X

    def __matmul__(self, x):
        if x.ndim == 2:
            return self.matmat(x)
        return self.matvec(x)


def _next_from_band(A_band, cstarts, nc, nc_pad, bc, dtype):
    """Banded coarse operator -> next-level WindowedELL + its span plan.

    Shared tail of every unstructured coarsening step (SA round 4;
    classical round 5): top-k extraction of the band, then next-level
    windowed geometry from the MEASURED support (two tiny D2H pulls) —
    the hull plan overestimates ~4x."""
    kc = max(int(_band_nnz_max(A_band)), 1)
    vals, ws = _extract_topk(A_band, kc)                 # (kc, nc_pad)
    # columns = cstart(block) + w
    cs_rows = jnp.repeat(cstarts.astype(jnp.float32), bc)[:nc_pad]
    cols = ws + cs_rows[None, :]
    # block size by windowed_from_scipy's heuristic cost: smaller
    # blocks can SHRINK the measured window at more blocks
    best = None
    for c_block in ((1024, 512, 256) if nc >= 4096 else (256,)):
        nb2 = pad_to(nc, c_block) // c_block
        blo_d, bhi_d = _col_bounds(vals, cols, gr=c_block)
        blo_h = np.asarray(blo_d)[:nb2]
        bhi_h = np.asarray(bhi_d)[:nb2]
        ok_b = np.isfinite(blo_h)
        g_lo = np.where(ok_b, blo_h, 0).astype(np.int64)
        g_hi = np.maximum(np.where(ok_b, bhi_h, 0).astype(np.int64)
                          + 1, g_lo + 1)
        c_w2, c_starts, c_mch = _pick_geometry(g_lo, g_hi, c_block, nc)
        cost = nb2 * 0.15e-6 + kc * nc * (2 * c_w2 / 128) * 8e-12
        if best is None or cost < best[0]:
            best = (cost, c_block, c_w2, c_starts, c_mch)
    _, c_block, c_w2, c_starts, c_mch = best
    slo_d, shi_d = _col_bounds(vals, cols, gr=bc)
    c_geom = (c_block, c_w2, tuple(c_starts.tolist()), c_mch)
    cur = _make_windowed(vals[:, :nc], cols[:, :nc], nc, c_geom,
                         dtype, nnz=int(kc * nc))
    slo_h = np.asarray(slo_d)
    shi_h = np.asarray(shi_d)
    ok_s = np.isfinite(slo_h)
    spans = _SpanPlan(
        nc, bc,
        np.where(ok_s, slo_h, nc).astype(np.int64),
        np.where(ok_s, shi_h + 1, 0).astype(np.int64))
    return cur, spans


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def device_unstructured_sa_setup(A, B=None, dtype=jnp.float32, theta=0.0,
                                 omega=4.0 / 3.0, max_coarse=1500,
                                 max_levels=10,
                                 presmoother=("jacobi",
                                              {"omega": 4.0 / 3.0}),
                                 postsmoother=("jacobi",
                                               {"omega": 4.0 / 3.0}),
                                 improve_candidates_iters=0,
                                 mixed_precision=False, seed=0,
                                 aggregate="standard", reorder="auto",
                                 smooth_passes=None, profile=None):
    """Build an SA hierarchy ON DEVICE for an unstructured operator.

    ``A``: scipy sparse, structurally-symmetric pattern, windowable
    under its ordering (RCM-reorder first if not; raises ValueError
    otherwise).  Everything value-carrying stays on device; the host
    sees one root-mask pull + one scalar per level for static window
    planning.  Returns a DeviceMultilevelSolver.

    ``aggregate``: 'standard' (densified MIS-2 roots, reference-parity
    aggregate granularity ~3 nodes on 2-D meshes) or 'aggressive'
    (radius-2 aggregates, coarsening ratio ~8-10: coarse levels shrink
    ~3x, cutting the windowed apply cost on every level below
    the finest, at a measured ~+4 Krylov-iteration cost — the better
    end-to-end trade when coarse-level applies dominate cycle time).
    """
    if aggregate not in ("standard", "aggressive"):
        raise ValueError(f"unknown aggregate mode {aggregate!r}")
    # smooth_passes (round 5): optional second prolongation-smoothing
    # pass as a composed factor S = I - w D^-1 A (no SpGEMM).  At 640k
    # aggressive it cut 14 -> 12 iterations, but the composed P doubles
    # every transfer apply, so the default stays 1 everywhere; pass
    # smooth_passes=2 when iteration count is the binding constraint.
    if smooth_passes is None:
        smooth_passes = 1
    if smooth_passes not in (1, 2):
        raise ValueError("smooth_passes must be 1 or 2")
    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    if n >= 2 ** 24:
        raise ValueError("unstructured device setup requires n < 2^24 "
                         "(f32-exact index payloads)")
    W = windowed_from_scipy(A, dtype=dtype, block=1024)
    if W is None:
        if reorder == "auto":
            # round 5 (VERDICT r4 item 4): RCM-reorder and retry
            # instead of raising; the solver wrapper permutes b /
            # un-permutes x host-side (ReorderedSolver)
            perm = _rcm_perm(A)
            Ap = A[perm][:, perm].tocsr()
            if windowed_from_scipy(Ap, dtype=dtype, block=1024) \
                    is not None:
                Bp = None if B is None else np.asarray(B).ravel()[perm]
                inner = device_unstructured_sa_setup(
                    Ap, B=Bp, dtype=dtype, theta=theta, omega=omega,
                    max_coarse=max_coarse, max_levels=max_levels,
                    presmoother=presmoother, postsmoother=postsmoother,
                    improve_candidates_iters=improve_candidates_iters,
                    mixed_precision=mixed_precision, seed=seed,
                    aggregate=aggregate, smooth_passes=smooth_passes,
                    reorder=False)
                return ReorderedSolver(inner, perm)
        raise ValueError(
            "operator is not windowable under its ordering (even after "
            "RCM reordering); use the host setup path")
    A64 = None
    if mixed_precision:
        # f64 finest operator for the f64 outer Krylov loop
        jax.config.update("jax_enable_x64", True)
        A64 = windowed_from_scipy(A, dtype=jnp.float64, block=1024)
    spans = _SpanPlan.from_csr(A)
    B_dev = None
    if B is not None:
        B_dev = jnp.asarray(np.asarray(B).ravel()[:n], dtype=jnp.float32)

    pre_key = _spec_key(presmoother)
    post_key = _spec_key(postsmoother)

    import time as _time

    def _mark(label, lev, t0, sync=None):
        # opt-in stage profiling (pass profile={}): waits for the stage
        # (block_until_ready) and records wall seconds under
        # profile[f"L{lev}.{label}"]
        if profile is None:
            return _time.perf_counter()
        if sync is not None:
            jax.block_until_ready(sync)
        t1 = _time.perf_counter()
        profile[f"L{lev}.{label}"] = round(t1 - t0, 3)
        return t1

    levels = []
    infos = []
    cur = W
    cur_n = n
    Bv = B_dev
    for lev in range(max_levels - 1):
        if cur_n <= max_coarse:
            break
        _t = _time.perf_counter()
        # ---- stage A: roots on device; ONE small host pull ------------
        root_f = _stage_roots(cur, theta=float(theta), seed=seed + lev,
                              densify=(aggregate == "standard"))
        root_host = np.asarray(root_f) > 0.5
        _t = _mark("roots", lev, _t)
        nc = int(root_host.sum())
        if nc == 0 or nc >= cur_n:
            break
        cum = np.zeros(cur_n + 1, dtype=np.int64)
        np.cumsum(root_host[:cur_n], out=cum[1:])

        # ---- host window planning (structural span hulls) --------------
        nb = cur.data.shape[0]
        blo = np.arange(nb, dtype=np.int64) * cur.block
        bhi = np.minimum(blo + cur.block, cur_n)
        bhi = np.maximum(bhi, blo + 1)
        # T columns: roots within distance<=2 of block rows
        lo2, hi2 = spans.hull(blo, bhi, 2)
        tlo, thi = _plan_windows(cum, lo2, hi2)
        # P1 columns: distance<=3 (tentative 2 + one smoothing hop);
        # the second smoothing pass is a separate composed factor with
        # A's own geometry, so p_geom stays at reach 3
        lo3, hi3 = spans.hull(blo, bhi, 3)
        plo, phi = _plan_windows(cum, lo3, hi3)
        t_w2, t_starts, t_mch = _pick_geometry(tlo, thi, cur.block, nc)
        p_w2, p_starts, p_mch = _pick_geometry(plo, phi, cur.block, nc)
        t_geom = (cur.block, t_w2, tuple(t_starts.tolist()), t_mch)
        p_geom = (cur.block, p_w2, tuple(p_starts.tolist()), p_mch)

        # coarse block structure + A_c windows: P reach = 2 + passes,
        # A_c = P^T A P reach = 2*(2 + passes) + 1 (7 single-smoothed)
        bc = 256
        nc_pad = pad_to(nc, bc)
        roots_pos = np.flatnonzero(root_host[:cur_n])
        cb_lo_fine = roots_pos[np.arange(0, nc, bc)]
        cb_hi_fine = roots_pos[np.minimum(np.arange(0, nc, bc) + bc - 1,
                                          nc - 1)] + 1
        clo7, chi7 = spans.hull(cb_lo_fine.astype(np.int64),
                                cb_hi_fine.astype(np.int64),
                                2 * (2 + smooth_passes) + 1)
        ac_lo, ac_hi = _plan_windows(cum, clo7, chi7)
        period = int((ac_hi - ac_lo).max())
        period = max(pad_to(period, 16), 32)
        cstarts_host = ac_lo.astype(np.int32)

        _t = _mark("plan", lev, _t)
        # ---- stage B: T/P/smoother arrays on device --------------------
        Bt = None if Bv is None else Bv[:cur.n_pad] if Bv.shape[0] \
            >= cur.n_pad else jnp.pad(Bv, (0, cur.n_pad - Bv.shape[0]))
        s_geom = None
        if smooth_passes == 2:
            s_geom = (cur.block, cur.w2,
                      tuple(np.asarray(cur.starts).tolist()),
                      cur.m_chunks)
        T, P, dinv, rho, norms, cval, S2 = _stage_build_p(
            cur, root_f, Bt, theta=float(theta), omega=float(omega),
            dtype=jnp.dtype(dtype).name, t_geom=t_geom,
            p_geom=p_geom, improve_iters=int(improve_candidates_iters),
            s_geom=s_geom)
        # merge duplicate-column P slots (same-aggregate neighbors):
        # slot count multiplies every windowed apply — measured 640k L1
        # holds ~8 distinct columns in 26 slots (docstring of
        # _merge_slots); the tiny scalar pull decides if it pays
        if P.k > 3:
            kd = int(_max_distinct(P))
            if kd < P.k - 1:
                P = _merge_slots(P, k_new=kd, geometry=p_geom,
                                 dtype=jnp.dtype(dtype).name)
        if S2 is not None:
            P = ComposedWindowed(factors=(S2, P))
        _t = _mark("build_p", lev, _t, sync=dinv)

        # ---- RAP probing ----------------------------------------------
        cstarts = jnp.asarray(cstarts_host)
        A_band = _probe_rap(cur, P, cstarts, period=period,
                            K=_PROBE_K,
                            nc_pad=nc_pad, bc=bc, dtype=dtype)
        # drop structurally-padded coarse rows (beyond nc)
        rowi = jnp.arange(nc_pad).reshape(-1, bc)
        A_band = jnp.where((rowi < nc)[:, :, None], A_band, 0.0)
        _t = _mark("probe_rap", lev, _t, sync=A_band)

        # ---- smoothers + level assembly --------------------------------
        pre_arr = _smoother_arrays_jit(pre_key, cur, dinv, rho,
                                       dtype=jnp.dtype(dtype).name)
        post_arr = _smoother_arrays_jit(post_key, cur, dinv, rho,
                                        dtype=jnp.dtype(dtype).name)
        R = TransposedWindowed(P)
        levels.append(DeviceLevel(
            A=cur, P=P, R=R,
            pre=_smoother_wrap(pre_key, pre_arr),
            post=_smoother_wrap(post_key, post_arr),
            n=cur_n, n_pad=cur.n_pad))
        infos.append({"level": lev, "n": cur_n, "nc": nc,
                      "period": period, "k": cur.k,
                      "A_w2": cur.w2, "P_w2": p_w2, "T_w2": t_w2})

        # ---- next-level operator ---------------------------------------
        if nc <= max_coarse:
            Ac_dense = _band_to_dense(A_band, cstarts, nc=nc,
                                      nc_pad=nc_pad)
            coarse_inv = _ns_pinv(Ac_dense)
            cur = DenseOperator(data=Ac_dense, shape=(nc, nc),
                                nnz=nc * nc)
            cur_n = nc
            ident = device_relaxation.identity()
            levels.append(DeviceLevel(A=cur, P=None, R=None, pre=ident,
                                      post=ident, n=nc, n_pad=nc_pad))
            hier = DeviceHierarchy(levels=levels, coarse_inv=coarse_inv,
                                   nc=nc, nc_pad=nc_pad, dtype=dtype,
                                   A64=A64)
            dml = DeviceMultilevelSolver(hier)
            dml.setup_info = {"levels": infos}
            return dml

        cur, spans = _next_from_band(A_band, cstarts, nc, nc_pad, bc,
                                     dtype)
        _t = _mark("extract", lev, _t, sync=cur.data)
        cur_n = nc
        # coarse candidate = per-aggregate norms (fit_candidates)
        Bv = norms[:nc].astype(jnp.float32)

    # loop exit: coarsest by max_coarse/max_levels — dense solve on cur
    nc = cur_n
    nc_pad = cur.n_pad if hasattr(cur, "n_pad") else pad_to(nc, 8)
    eyeK = jnp.eye(nc_pad, dtype=dtype)
    Ac_dense = cur @ eyeK if not isinstance(cur, DenseOperator) \
        else cur.data
    coarse_inv = _ns_pinv(Ac_dense)
    ident = device_relaxation.identity()
    levels.append(DeviceLevel(A=cur if isinstance(cur, DenseOperator)
                              else DenseOperator(data=Ac_dense,
                                                 shape=(nc, nc),
                                                 nnz=nc * nc),
                              P=None, R=None, pre=ident, post=ident,
                              n=nc, n_pad=nc_pad))
    hier = DeviceHierarchy(levels=levels, coarse_inv=coarse_inv, nc=nc,
                           nc_pad=nc_pad, dtype=dtype, A64=A64)
    dml = DeviceMultilevelSolver(hier)
    dml.setup_info = {"levels": infos}
    return dml

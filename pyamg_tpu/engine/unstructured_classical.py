"""Device CLASSICAL (Ruge-Stüben + AIR) setup for UNSTRUCTURED operators.

Round 5 (VERDICT r4 item 3): the round-4 windowed pipeline made SA setup
grid-free; this module does the same for the classical family — the
reference's RS and AIR run on arbitrary CSR ([R]
pyamg/classical/classical.py::ruge_stuben_solver, split.py::PMIS,
interpolate.py::direct_interpolation/one_point_interpolation/local_air,
SURVEY.md §2.2 S:111-114), and AIR's natural habitat is unstructured
upwind advection.  Everything value-carrying stays on device; the host
sees one C/F-mask pull + a handful of scalars per level for static
window planning (same contract as ``device_unstructured_sa_setup``).

A design for the device, not a port:

- **C/F splitting = select-based PMIS.**  The reference's serial RS
  two-pass walk has no parallel form; PMIS ([R] pyamg/classical/split.py
  ::PMIS, amg_core cljp-family) is the reference's own parallel
  splitting and maps 1:1 onto the windowed Luby machinery: weights
  λ_j + rand where λ_j = #{i : i strongly depends on j} (one windowed
  TRANSPOSE apply of the strength indicator), rounds of
  "win if my weight beats every undecided strong out-neighbor", then
  F-mark the nodes covered by a new C out-neighbor.  Out-edge-only
  independence (in-edges would need a transpose max-reduce the kernel
  doesn't have) can keep the occasional one-directional C-C strong
  pair — harmless for classical AMG (C-C connections are simply not
  interpolated through) and guarantees the property interpolation
  needs: every F point keeps at least one strong C OUT-neighbor.
- **Direct interpolation** ([R] amg_core
  rs_direct_interpolation_pass2 semantics) is row-local arithmetic over
  window slots: targets = strong C out-neighbors (select of the C
  indicator), alpha/beta = negative/positive row-sum ratios, positives
  lumped into the diagonal when no positive target exists.  Coarse
  column indices propagate through selects exactly like the SA path
  (f32-exact integer payloads, n < 2^24).
- **RAP by banded chain probing** (shared with SA): R = P^T probes
  through ``P.rmatmat``; the nonsymmetric AIR triple product R·A·P
  probes through the composed Neumann restriction below.
- **AIR restriction = truncated NEUMANN series (nAIR).**  The
  reference's local_air solves a dense A_ff neighborhood system per C
  row — a per-row gather/LAPACK pattern with no gather-free windowed
  form (the structured path can roll stencil neighborhoods;
  an unstructured neighborhood cannot be enumerated without gathers).
  The device equivalent is the nAIR variant ([R]
  pyamg/classical/air.py 'nAIR' restrict option): A_ff^{-1} ≈ degree-d
  Jacobi series, so R r = inject_C(r - A z) with z = d F-masked Jacobi
  sweeps on A_ff z = r_F — nothing but windowed applies and masks.  On
  upwind flows A_ff is (numerically) triangular along the flow, the
  series is exact for F-chains of length ≤ d, and the same two-level
  reduction argument as the structured degree-2 path applies.

Scope: real dtypes, n < 2^24, windowable orderings (auto-RCM fallback
is handled by the callers' routing); the sparsity pattern may be
NONSYMMETRIC (upwind advection) — hull planning symmetrizes the
structure host-side, which only widens windows, never misses support.
"""

from __future__ import annotations

import dataclasses
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
from . import unstructured_setup as _us
from .unstructured_setup import (ComposedWindowed, ReorderedSolver,
                                 _SpanPlan, _flat, _make_windowed,
                                 _next_from_band, _p_residue_matmat,
                                 _pick_geometry, _plan_windows,
                                 _probe_rap, _rcm_perm, _unflat)

__all__ = ["device_unstructured_rs_setup",
           "device_unstructured_air_setup", "NeumannAIRRestriction"]


def _slot_fields(W: WindowedELL):
    """(data, col, row, offd) slot-wise (k, n) views of a windowed op."""
    n_pad = W.n_pad
    gidx = (W.starts[:, None, None] * W.w2 + W.idx)
    rows = (jnp.arange(W.block)[None, None, :]
            + (jnp.arange(W.data.shape[0]) * W.block)[:, None, None])
    data = _flat(W.data, n_pad)
    col = _flat(gidx, n_pad)
    row = _flat(rows, n_pad)
    offd = (col != row) & (data != 0)
    return data, col, row, offd


def _cls_strength_mask(W: WindowedELL, theta, norm):
    """Classical strength over window slots ([R] amg_core
    classical_strength_of_connection_abs/_min, strength.py:60-90):

    norm='abs':  |a_ij| >= theta * max_{k != i} |a_ik|
    norm='min':  -a_ij  >= theta * max_{k != i} (-a_ik)
    """
    data, col, row, offd = _slot_fields(W)
    if norm == "min":
        meas = jnp.where(offd, jnp.maximum(-data, 0.0), 0.0)
    else:
        meas = jnp.where(offd, jnp.abs(data), 0.0)
    rowmax = jnp.max(meas, axis=0)
    mask = offd & (meas >= theta * rowmax[None, :]) & (meas > 0)
    return mask, data, col, row


# ---------------------------------------------------------------------------
# stage A: PMIS C/F splitting
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("theta", "seed", "norm"))
def _stage_pmis(W: WindowedELL, theta=0.25, seed=0, norm="abs"):
    """PMIS splitting on the windowed strength graph (module docstring).

    Returns the C mask as (n_pad,) f32 (1.0 at C points)."""
    n_pad = W.n_pad
    diag = W.diagonal()
    valid = diag != 0
    mask, _, _, _ = _cls_strength_mask(W, theta, norm)

    # λ_j = column count of the strength mask = #rows depending on j:
    # one windowed transpose apply of the indicator values
    Ws = dataclasses.replace(
        W, data=_unflat(mask.astype(W.data.dtype), W.data.shape[0],
                        W.block, n_pad))
    lam = Ws.rmatvec(jnp.ones(Ws.m_chunks * Ws.w2,
                              dtype=W.data.dtype))[:n_pad]
    w = jnp.where(valid, lam.astype(jnp.float32)
                  + _hash_weights(n_pad, seed), 0.0)

    def nbr_max(x):
        sel = _flat(W.select(x), n_pad)
        return jnp.max(jnp.where(mask, sel, -jnp.inf), axis=0)

    state0 = jnp.where(valid, jnp.int8(-1), jnp.int8(0))
    _MAX_ROUNDS = 64          # CLAUDE.md: BOUND every while_loop

    def cond(carry):
        it, s = carry
        return (it < _MAX_ROUNDS) & jnp.any(s == -1)

    def body(carry):
        it, s = carry
        und = s == -1
        wv = jnp.where(und, w, -1.0)
        winners = und & (wv >= jnp.maximum(nbr_max(wv), 0.0))
        s = jnp.where(winners, jnp.int8(1), s)
        covered = nbr_max(jnp.where(winners, 1.0, 0.0)) > 0.5
        return it + 1, jnp.where((s == -1) & covered, jnp.int8(0), s)

    _, state = lax.while_loop(cond, body, (0, state0))
    # round-capped leftovers promote to C (always safe; never strands an
    # F point without a strong C out-neighbor)
    cmask = ((state == 1) | (state == -1)) & valid
    return cmask.astype(jnp.float32)


# ---------------------------------------------------------------------------
# stage B: interpolation operators
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("theta", "norm", "dtype", "p_geom"))
def _stage_build_p_rs(W: WindowedELL, c_f, *, theta, norm, dtype,
                      p_geom):
    """Direct interpolation P from the PMIS splitting ([R] amg_core
    rs_direct_interpolation_pass2 weight formula — the same
    positive/negative split as the structured ``_pass_interp``):

        alpha_i = Σ_{j≠i} a_ij^-  /  Σ_{j targets} a_ij^-
        beta_i  = Σ_{j≠i} a_ij^+  /  Σ_{j targets} a_ij^+
        w_ij = -(alpha_i | beta_i) · a_ij / ã_ii

    with targets = strong C out-neighbors, positives lumped into the
    diagonal when no positive target exists.  Returns
    (P, dinv, rho, cval)."""
    n = W.shape[0]
    n_pad = W.n_pad
    diag = W.diagonal()
    valid = diag != 0
    mask, data, col, row = _cls_strength_mask(W, theta, norm)
    is_c = c_f > 0.5
    cum = jnp.cumsum(c_f) - c_f
    cval = jnp.where(is_c, cum, 0.0)
    selC = _flat(W.select(c_f), n_pad)
    selcv = _flat(W.select(cval.astype(jnp.float32)), n_pad)
    offd = (col != row) & (data != 0)
    target = mask & (selC > 0.5)

    neg_all = jnp.sum(jnp.where(offd, jnp.minimum(data, 0.0), 0.0),
                      axis=0)
    pos_all = jnp.sum(jnp.where(offd, jnp.maximum(data, 0.0), 0.0),
                      axis=0)
    neg_t = jnp.sum(jnp.where(target, jnp.minimum(data, 0.0), 0.0),
                    axis=0)
    pos_t = jnp.sum(jnp.where(target, jnp.maximum(data, 0.0), 0.0),
                    axis=0)
    alpha = jnp.where(neg_t != 0,
                      neg_all / jnp.where(neg_t != 0, neg_t, 1), 0.0)
    beta = jnp.where(pos_t != 0,
                     pos_all / jnp.where(pos_t != 0, pos_t, 1), 0.0)
    diag_eff = (diag + jnp.where(pos_t == 0, pos_all, 0)
                + jnp.where(neg_t == 0, neg_all, 0))
    diag_eff = jnp.where(diag_eff != 0, diag_eff, 1.0)

    f_row = valid & ~is_c
    scale = jnp.where(data < 0, alpha[None, :], beta[None, :])
    w_slots = jnp.where(target & f_row[None, :],
                        -(scale * data) / diag_eff[None, :], 0.0)
    own = jnp.where(is_c, 1.0, 0.0)
    pvals = jnp.concatenate([own[None, :], w_slots], axis=0)
    pcols = jnp.concatenate([cval[None, :],
                             jnp.where(target, selcv, 0.0)], axis=0)
    P = _make_windowed(pvals, pcols, n, p_geom, dtype,
                       nnz=int(W.nnz + n))
    dinv = jnp.where(valid, 1.0 / jnp.where(valid, diag, 1), 0)
    rho = _power_rho(W, dinv)
    return P, dinv.astype(dtype), rho, cval


@partial(jax.jit, static_argnames=("theta", "norm", "dtype", "p_geom"))
def _stage_build_p_onepoint(W: WindowedELL, c_f, *, theta, norm, dtype,
                            p_geom):
    """One-point prolongation ([R]
    pyamg/classical/interpolate.py::one_point_interpolation): each F row
    places a single 1 at its strongest strong-C out-neighbor; C rows
    inject.  Single-slot windowed P — the AIR convention (P carries
    structure, R does the work).  Returns (P, Tinj, dinv, fmask,
    cval)."""
    n = W.shape[0]
    n_pad = W.n_pad
    diag = W.diagonal()
    valid = diag != 0
    mask, data, col, row = _cls_strength_mask(W, theta, norm)
    is_c = c_f > 0.5
    cum = jnp.cumsum(c_f) - c_f
    cval = jnp.where(is_c, cum, 0.0)
    selC = _flat(W.select(c_f), n_pad)
    selcv = _flat(W.select(cval.astype(jnp.float32)), n_pad)
    target = mask & (selC > 0.5)

    cand = jnp.where(target, jnp.abs(data), -jnp.inf)
    best = jnp.max(cand, axis=0)
    k = cand.shape[0]
    first = jnp.argmax(cand == best[None, :], axis=0)
    hit = (jnp.arange(k)[:, None] == first[None, :]) & jnp.isfinite(
        cand)
    chosen = jnp.sum(jnp.where(hit, selcv, 0.0), axis=0)
    has_t = jnp.isfinite(best)

    f_row = valid & ~is_c
    pval = jnp.where(is_c, 1.0, jnp.where(f_row & has_t, 1.0, 0.0))
    pcol = jnp.where(is_c, cval, jnp.where(f_row & has_t, chosen, 0.0))
    P = _make_windowed(pval[None, :], pcol[None, :], n, p_geom, dtype,
                       nnz=n)
    # injection (C rows only) — the R front-end
    ival = jnp.where(is_c, 1.0, 0.0)
    Tinj = _make_windowed(ival[None, :], cval[None, :], n, p_geom,
                          dtype, nnz=n)
    dinv = jnp.where(valid, 1.0 / jnp.where(valid, diag, 1), 0)
    fmask = f_row
    return P, Tinj, dinv.astype(dtype), fmask, cval


@partial(jax.jit, static_argnames=("theta", "norm", "dtype", "p_geom"))
def _stage_build_m_mod(W: WindowedELL, c_f, *, theta, norm, dtype,
                       p_geom):
    """Modified-classical distribution factor M + direct P ([R] amg_core
    rs_classical_interpolation_pass2 semantics, device form — see
    ComposedWindowed): P_mod = M · P_direct where M redistributes each F
    row over ALL its strong neighbors (C and F) with the direct-weight
    formula, and P_direct then maps every row's mass to coarse indices.
    F-F strong paths thus interpolate through the neighbor's own strong
    C set — the distance-two family PMIS needs for classical-rate
    parity.  M shares A's sparsity/geometry (slot-value replacement
    only); returns (M, P_direct, dinv, rho)."""
    Pd, dinv, rho, _ = _stage_build_p_rs(W, c_f, theta=theta, norm=norm,
                                         dtype=dtype, p_geom=p_geom)
    n_pad = W.n_pad
    diag = W.diagonal()
    valid = diag != 0
    mask, data, col, row = _cls_strength_mask(W, theta, norm)
    is_c = c_f > 0.5
    offd = (col != row) & (data != 0)
    neg_all = jnp.sum(jnp.where(offd, jnp.minimum(data, 0.0), 0.0),
                      axis=0)
    pos_all = jnp.sum(jnp.where(offd, jnp.maximum(data, 0.0), 0.0),
                      axis=0)
    neg_s = jnp.sum(jnp.where(mask, jnp.minimum(data, 0.0), 0.0),
                    axis=0)
    pos_s = jnp.sum(jnp.where(mask, jnp.maximum(data, 0.0), 0.0),
                    axis=0)
    alpha = jnp.where(neg_s != 0,
                      neg_all / jnp.where(neg_s != 0, neg_s, 1), 0.0)
    beta = jnp.where(pos_s != 0,
                     pos_all / jnp.where(pos_s != 0, pos_s, 1), 0.0)
    diag_eff = (diag + jnp.where(pos_s == 0, pos_all, 0)
                + jnp.where(neg_s == 0, neg_all, 0))
    diag_eff = jnp.where(diag_eff != 0, diag_eff, 1.0)
    f_row = valid & ~is_c
    scale = jnp.where(data < 0, alpha[None, :], beta[None, :])
    mvals = jnp.where(mask & f_row[None, :],
                      -(scale * data) / diag_eff[None, :], 0.0)
    # C rows: identity at the diagonal slot
    mvals = jnp.where((col == row) & is_c[None, :], 1.0, mvals)
    M = dataclasses.replace(
        W, data=_unflat(mvals.astype(W.data.dtype), W.data.shape[0],
                        W.block, n_pad))
    return M, Pd, dinv, rho


# ---------------------------------------------------------------------------
# Neumann AIR restriction (nAIR)
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class NeumannAIRRestriction:
    """R r = inject_C(r - A z),  z = ``degree`` F-masked Jacobi sweeps
    on A_ff z = r_F (module docstring; [R] pyamg/classical/air.py nAIR
    restrict semantics).  Composes windowed applies + elementwise masks
    only — gather-free, and probe-able by the banded RAP chains."""

    A: WindowedELL
    Tinj: WindowedELL       # 1-slot injection (C rows -> coarse index)
    dinv_f: jnp.ndarray     # (n_pad,) 1/a_ii on F rows, 0 elsewhere
    shape: tuple
    nnz: int
    degree: int

    def tree_flatten(self):
        return (self.A, self.Tinj, self.dinv_f), (self.shape, self.nnz,
                                                  self.degree)

    @classmethod
    def tree_unflatten(cls, aux, children):
        A, Tinj, dinv_f = children
        shape, nnz, degree = aux
        return cls(A=A, Tinj=Tinj, dinv_f=dinv_f, shape=shape, nnz=nnz,
                   degree=degree)

    @property
    def n_pad(self):
        return self.shape[0]

    def _z(self, rf_masked):
        z = self.dinv_f * rf_masked
        for _ in range(self.degree - 1):
            z = z + self.dinv_f * (rf_masked - (self.A @ z))
        return z

    def matvec(self, r):
        n_pad = self.A.n_pad
        if r.shape[0] < n_pad:
            r = jnp.pad(r, (0, n_pad - r.shape[0]))
        r = r[:n_pad]
        if self.degree > 0:
            fm = self.dinv_f != 0
            z = self._z(jnp.where(fm, r, 0.0))
            y = r - (self.A @ z)
        else:
            y = r
        return self.Tinj.rmatvec(y)

    def matmat(self, X):
        n_pad = self.A.n_pad
        if X.shape[0] < n_pad:
            X = jnp.pad(X, ((0, n_pad - X.shape[0]), (0, 0)))
        X = X[:n_pad]
        if self.degree > 0:
            fm = (self.dinv_f != 0)[:, None]
            Xf = jnp.where(fm, X, 0.0)
            Z = self.dinv_f[:, None] * Xf
            for _ in range(self.degree - 1):
                Z = Z + self.dinv_f[:, None] * (Xf - self.A.matmat(Z))
            Y = X - self.A.matmat(Z)
        else:
            Y = X
        return self.Tinj.rmatmat(Y)

    def __matmul__(self, x):
        if x.ndim == 2:
            return self.matmat(x)
        return self.matvec(x)


@partial(jax.jit, static_argnames=("period", "K", "nc_pad", "bc",
                                   "dtype"))
def _probe_rap_r(A_w, P, R, cstarts, *, period, K, nc_pad, bc, dtype):
    """Nonsymmetric banded RAP probing: A_c = R(A(P v_d)) with residue
    probes v_d — the AIR triple product through the composed Neumann
    restriction (same placement/one-hot scheme as
    ``unstructured_setup._probe_rap``, which hardcodes R = P^T)."""
    n_pad = A_w.n_pad
    nchunks = -(-period // K)
    nb_c = nc_pad // bc
    w_iota = jnp.arange(period)

    def chain(d0):
        Y1 = _p_residue_matmat(P, d0, K, period, nc_pad, n_pad)
        Y2 = A_w.matmat(Y1)
        return R.matmat(Y2)[:nc_pad]                     # (nc_pad, K)

    def body(c, A_band):
        Yc = chain(c * K).astype(jnp.float32)
        Y3 = Yc.reshape(nb_c, bc, K)
        d = c * K + jnp.arange(K)
        oh = ((jnp.remainder(d[None, :, None] - cstarts[:, None, None],
                             np.int32(period)) == w_iota[None, None, :])
              & (d[None, :, None] < period))
        # exact placement: one nonzero term per output, full precision
        acc = jnp.einsum("brj,bjw->brw", Y3, oh.astype(jnp.float32),
                         precision=lax.Precision.HIGHEST)
        return A_band + acc.astype(dtype)

    A_band = jnp.zeros((nb_c, bc, period), dtype=dtype)
    return lax.fori_loop(0, nchunks, body, A_band)


# ---------------------------------------------------------------------------
# shared driver skeleton
# ---------------------------------------------------------------------------

def _sym_spans(A):
    """Span plan over the SYMMETRIZED structure |A| + |A^T| — covers
    transpose-direction reach on nonsymmetric patterns (upwind
    advection); on symmetric patterns it equals the plain plan."""
    Aa = sp.csr_matrix((np.abs(A.data), A.indices, A.indptr),
                       shape=A.shape)
    S = (Aa + Aa.T).tocsr()
    S.sort_indices()
    return _SpanPlan.from_csr(S)


def _prep(A, dtype, reorder, retry):
    """CSR-normalize, window, and span-plan; returns (A, W, spans) or,
    when not windowable and ``reorder='auto'``, retries RCM-permuted
    via ``retry(Ap, perm)`` (which returns the wrapped solver)."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    if n >= 2 ** 24:
        raise ValueError("unstructured device setup requires n < 2^24 "
                         "(f32-exact index payloads)")
    W = windowed_from_scipy(A, dtype=dtype, block=1024)
    if W is None:
        if reorder == "auto":
            perm = _rcm_perm(A)
            Ap = A[perm][:, perm].tocsr()
            if windowed_from_scipy(Ap, dtype=dtype, block=1024) \
                    is not None:
                return retry(Ap, perm)
        raise ValueError(
            "operator is not windowable under its ordering (even "
            "after RCM reordering); use the host setup path")
    return A, W, _sym_spans(A)


def device_unstructured_rs_setup(A, dtype=jnp.float32, theta=0.25,
                                 norm="abs", interpolation="modified",
                                 max_coarse=1500, max_levels=12,
                                 presmoother=("jacobi",
                                              {"omega": 4.0 / 3.0,
                                               "iterations": 2}),
                                 postsmoother=("jacobi",
                                               {"omega": 4.0 / 3.0,
                                                "iterations": 2}),
                                 mixed_precision=False, seed=0,
                                 reorder="auto"):
    """Build a classical (RS) hierarchy ON DEVICE for an unstructured
    operator: PMIS splitting + direct/modified-classical interpolation
    + chain-probed Galerkin RAP (module docstring).

    ``interpolation``: 'modified' (default — P = M · P_direct composed
    factors, the distance-two family that restores classical rates
    under PMIS; solve-phase transfers cost two windowed applies) or
    'direct' (single-factor, cheapest applies; the composed-P probe
    chains pay M and M^T windowed passes the SA pipeline doesn't).
    Returns a DeviceMultilevelSolver."""
    if interpolation not in ("modified", "direct"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if mixed_precision:
        raise NotImplementedError(
            "mixed precision is not wired into this setup (no f64 finest "
            "operator is built); use the f32 device solve or a host "
            "outer loop around aspreconditioner()")
    def _retry(Ap, perm):
        inner = device_unstructured_rs_setup(
            Ap, dtype=dtype, theta=theta, norm=norm,
            interpolation=interpolation, max_coarse=max_coarse,
            max_levels=max_levels, presmoother=presmoother,
            postsmoother=postsmoother, mixed_precision=mixed_precision,
            seed=seed, reorder=False)
        return ReorderedSolver(inner, perm)

    prep = _prep(A, dtype, reorder, _retry)
    if isinstance(prep, ReorderedSolver):
        return prep
    A, W, spans = prep
    p_reach = 2 if interpolation == "modified" else 1
    n = A.shape[0]
    pre_key = _spec_key(presmoother)
    post_key = _spec_key(postsmoother)
    levels = []
    infos = []
    cur = W
    cur_n = n
    for lev in range(max_levels - 1):
        if cur_n <= max_coarse:
            break
        c_f = _stage_pmis(cur, theta=float(theta), seed=seed + lev,
                          norm=norm)
        c_host = np.asarray(c_f) > 0.5
        nc = int(c_host[:cur_n].sum())
        if nc == 0 or nc >= cur_n:
            break
        cum = np.zeros(cur_n + 1, dtype=np.int64)
        np.cumsum(c_host[:cur_n], out=cum[1:])

        nb = cur.data.shape[0]
        blo = np.arange(nb, dtype=np.int64) * cur.block
        bhi = np.minimum(blo + cur.block, cur_n)
        bhi = np.maximum(bhi, blo + 1)
        # P columns: C points within distance 1
        lo1, hi1 = spans.hull(blo, bhi, 1)
        plo, phi = _plan_windows(cum, lo1, hi1)
        p_w2, p_starts, p_mch = _pick_geometry(plo, phi, cur.block, nc)
        p_geom = (cur.block, p_w2, tuple(p_starts.tolist()), p_mch)

        # coarse blocks: A_c = P^T A P reaches C points within fine
        # distance 2*p_reach + 1
        bc = 256
        nc_pad = pad_to(nc, bc)
        roots_pos = np.flatnonzero(c_host[:cur_n])
        cb_lo_fine = roots_pos[np.arange(0, nc, bc)]
        cb_hi_fine = roots_pos[np.minimum(np.arange(0, nc, bc) + bc - 1,
                                          nc - 1)] + 1
        clo, chi = spans.hull(cb_lo_fine.astype(np.int64),
                              cb_hi_fine.astype(np.int64),
                              2 * p_reach + 1)
        ac_lo, ac_hi = _plan_windows(cum, clo, chi)
        period = int((ac_hi - ac_lo).max())
        period = max(pad_to(period, 16), 32)
        cstarts_host = ac_lo.astype(np.int32)

        if interpolation == "modified":
            M, Pd, dinv, rho = _stage_build_m_mod(
                cur, c_f, theta=float(theta), norm=norm,
                dtype=jnp.dtype(dtype).name, p_geom=p_geom)
            P = ComposedWindowed(factors=(M, Pd))
        else:
            P, dinv, rho, _ = _stage_build_p_rs(
                cur, c_f, theta=float(theta), norm=norm,
                dtype=jnp.dtype(dtype).name, p_geom=p_geom)

        cstarts = jnp.asarray(cstarts_host)
        A_band = _probe_rap(cur, P, cstarts, period=period,
                            K=_us._PROBE_K,
                            nc_pad=nc_pad, bc=bc, dtype=dtype)
        rowi = jnp.arange(nc_pad).reshape(-1, bc)
        A_band = jnp.where((rowi < nc)[:, :, None], A_band, 0.0)

        pre_arr = _us._smoother_arrays_jit(pre_key, cur, dinv, rho,
                                           dtype=jnp.dtype(dtype).name)
        post_arr = _us._smoother_arrays_jit(post_key, cur, dinv, rho,
                                            dtype=jnp.dtype(dtype).name)
        R = TransposedWindowed(P)
        levels.append(DeviceLevel(
            A=cur, P=P, R=R,
            pre=_smoother_wrap(pre_key, pre_arr),
            post=_smoother_wrap(post_key, post_arr),
            n=cur_n, n_pad=cur.n_pad))
        infos.append({"level": lev, "n": cur_n, "nc": nc,
                      "period": period, "k": cur.k, "A_w2": cur.w2,
                      "P_w2": p_w2, "family": "rs"})

        cur, spans = _next_from_band(A_band, cstarts, nc, nc_pad, bc,
                                     dtype)
        cur_n = nc

    return _finish_dense(levels, infos, cur, cur_n, dtype)


def device_unstructured_air_setup(A, dtype=jnp.float32, theta=0.25,
                                  norm="min", degree=2, max_coarse=1500,
                                  max_levels=6, f_iterations=2,
                                  c_iterations=1, omega=1.0,
                                  mixed_precision=False, seed=0,
                                  reorder="auto"):
    """Build an AIR hierarchy ON DEVICE for an unstructured operator
    (possibly nonsymmetric pattern — upwind advection FEM/DG): PMIS
    splitting on 'min' strength, one-point P, degree-``degree`` Neumann
    ideal restriction (nAIR), F-then-C Jacobi post-smoothing, and the
    nonsymmetric chain-probed R·A·P.  Solve with ``accel='fgmres'`` or
    ``'bicgstab'``.  Returns a DeviceMultilevelSolver."""
    if mixed_precision:
        raise NotImplementedError(
            "mixed precision is not wired into this setup (no f64 finest "
            "operator is built); use the f32 device solve or a host "
            "outer loop")
    def _retry(Ap, perm):
        inner = device_unstructured_air_setup(
            Ap, dtype=dtype, theta=theta, norm=norm, degree=degree,
            max_coarse=max_coarse, max_levels=max_levels,
            f_iterations=f_iterations, c_iterations=c_iterations,
            omega=omega, mixed_precision=mixed_precision, seed=seed,
            reorder=False)
        return ReorderedSolver(inner, perm)

    prep = _prep(A, dtype, reorder, _retry)
    if isinstance(prep, ReorderedSolver):
        return prep
    A, W, spans = prep
    n = A.shape[0]
    degree = int(degree)
    levels = []
    infos = []
    cur = W
    cur_n = n
    for lev in range(max_levels - 1):
        if cur_n <= max_coarse:
            break
        c_f = _stage_pmis(cur, theta=float(theta), seed=seed + lev,
                          norm=norm)
        c_host = np.asarray(c_f) > 0.5
        nc = int(c_host[:cur_n].sum())
        if nc == 0 or nc >= cur_n:
            break
        cum = np.zeros(cur_n + 1, dtype=np.int64)
        np.cumsum(c_host[:cur_n], out=cum[1:])

        nb = cur.data.shape[0]
        blo = np.arange(nb, dtype=np.int64) * cur.block
        bhi = np.minimum(blo + cur.block, cur_n)
        bhi = np.maximum(bhi, blo + 1)
        lo1, hi1 = spans.hull(blo, bhi, 1)
        plo, phi = _plan_windows(cum, lo1, hi1)
        p_w2, p_starts, p_mch = _pick_geometry(plo, phi, cur.block, nc)
        p_geom = (cur.block, p_w2, tuple(p_starts.tolist()), p_mch)

        # A_c = R A P reaches C points within fine distance degree+2
        bc = 256
        nc_pad = pad_to(nc, bc)
        roots_pos = np.flatnonzero(c_host[:cur_n])
        cb_lo_fine = roots_pos[np.arange(0, nc, bc)]
        cb_hi_fine = roots_pos[np.minimum(np.arange(0, nc, bc) + bc - 1,
                                          nc - 1)] + 1
        clo, chi = spans.hull(cb_lo_fine.astype(np.int64),
                              cb_hi_fine.astype(np.int64), degree + 2)
        ac_lo, ac_hi = _plan_windows(cum, clo, chi)
        period = int((ac_hi - ac_lo).max())
        period = max(pad_to(period, 16), 32)
        cstarts_host = ac_lo.astype(np.int32)

        P, Tinj, dinv, fmask, _ = _stage_build_p_onepoint(
            cur, c_f, theta=float(theta), norm=norm,
            dtype=jnp.dtype(dtype).name, p_geom=p_geom)
        dinv_f = jnp.where(fmask, dinv, 0).astype(dtype)
        R = NeumannAIRRestriction(
            A=cur, Tinj=Tinj, dinv_f=dinv_f,
            shape=(nc_pad, cur.n_pad),
            nnz=int(cur.nnz * max(degree, 1)), degree=degree)

        cstarts = jnp.asarray(cstarts_host)
        A_band = _probe_rap_r(cur, P, R, cstarts, period=period,
                              K=_us._PROBE_K,
                              nc_pad=nc_pad, bc=bc, dtype=dtype)
        rowi = jnp.arange(nc_pad).reshape(-1, bc)
        A_band = jnp.where((rowi < nc)[:, :, None], A_band, 0.0)

        # reference AIR smoothing: no presmoother, F-then-C Jacobi post
        cmask_r = (~fmask) & (dinv != 0)
        pre = device_relaxation.identity()
        post = device_relaxation.masked_jacobi(
            dinv, (fmask, cmask_r),
            iters_per_mask=(int(f_iterations), int(c_iterations)),
            omega=float(omega))
        levels.append(DeviceLevel(A=cur, P=P, R=R, pre=pre, post=post,
                                  n=cur_n, n_pad=cur.n_pad))
        infos.append({"level": lev, "n": cur_n, "nc": nc,
                      "period": period, "k": cur.k, "A_w2": cur.w2,
                      "P_w2": p_w2, "family": "air"})

        cur, spans = _next_from_band(A_band, cstarts, nc, nc_pad, bc,
                                     dtype)
        cur_n = nc

    return _finish_dense(levels, infos, cur, cur_n, dtype)


def _finish_dense(levels, infos, cur, cur_n, dtype):
    """Coarsest-level dense solve + hierarchy assembly (shared tail)."""
    nc = cur_n
    nc_pad = cur.n_pad if hasattr(cur, "n_pad") else pad_to(nc, 8)
    if isinstance(cur, DenseOperator):
        Ac_dense = cur.data
    else:
        Ac_dense = cur @ jnp.eye(nc_pad, dtype=dtype)
    coarse_inv = _ns_pinv(Ac_dense)
    ident = device_relaxation.identity()
    levels.append(DeviceLevel(
        A=cur if isinstance(cur, DenseOperator)
        else DenseOperator(data=Ac_dense, shape=(nc, nc), nnz=nc * nc),
        P=None, R=None, pre=ident, post=ident, n=nc, n_pad=nc_pad))
    hier = DeviceHierarchy(levels=levels, coarse_inv=coarse_inv, nc=nc,
                           nc_pad=nc_pad, dtype=dtype)
    dml = DeviceMultilevelSolver(hier)
    dml.setup_info = {"levels": infos}
    return dml

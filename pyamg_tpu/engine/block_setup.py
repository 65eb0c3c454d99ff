"""Block / multi-candidate device SA setup — on-device hierarchy
construction for BSR operators and multi-column near-nullspaces.

Round-2 gap closed here (CLAUDE.md roadmap): ``device_sa_setup`` covered
only scalar grid-stencil operators with the single ones-candidate;
elasticity (BSR bs=2, three rigid-body candidates) and any multi-
candidate SA setup fell back to host.  This module generalizes the
structured pipeline (engine/device_setup.py) to block unknowns and
``m``-column candidate blocks while keeping its invariants: everything
is rolls / reduce-windows / batched tiny matmuls — ZERO gathers
(DESIGN.md rule 1), static shapes, ONE fused XLA program for the whole
multi-level setup.

Reference counterparts: [R] pyamg/aggregation/tentative.py::
fit_candidates (per-aggregate QR of the (agg*bs, m) candidate block) and
[R] pyamg/aggregation/aggregation.py::_extend_hierarchy (SURVEY.md
§2.2, §3.1).  The device re-design of the QR: per-aggregate **Gram
matrices** G = B_agg^H B_agg assembled with reduce-window block sums,
factored by a batched UNROLLED Cholesky (m <= 4 is static), giving
Q = B_agg L^{-T} evaluated pointwise — the orthonormalization never
materializes per-aggregate row blocks, so no interleaved reshapes and no
gathers.  Coarse-level candidates are the R factors (= L^T), exactly as
fit_candidates returns them.

Level structure: the finest level carries the input block size ``bs``;
every coarser level has square blocks of size ``m`` (one coarse unknown
per candidate per aggregate — the standard SA block recursion).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax import lax

from ..sparse import BlockDIAMatrix, pad_to
from . import relaxation as device_relaxation
from .device_setup import (_broadcast_coarse, _block_sum, _compact_fine,
                           _coords_to_offset, _embed_coarse, _grid_pad_vec,
                           _grid_unpad_vec, _ns_pinv, _offset_to_coords,
                           _padded_grid, _spec_key, StructuredDeviceSolver)
from .hierarchy import DeviceHierarchy, DeviceLevel
from .setup import _hash_weights

__all__ = ["device_sa_setup_block", "BlockStructuredProlongator",
           "BlockStructuredRestrictor"]


# ---------------------------------------------------------------------------
# rectangular block-DIA (setup-transient): data (ndiags, nb_pad, r, c)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _BDia:
    data: Tuple  # jnp (ndiags, nb_pad, r, c)
    offsets: Tuple[int, ...]


def _bspgemm(A: _BDia, B: _BDia, keep=None) -> _BDia:
    """C = A @ B for embedded block-DIA operands on a shared node grid:

        C_data[oa+ob] += A_data[oa] @_batched roll(B_data[ob], -oa)

    (the block generalization of sparse.dia.dia_spgemm; wrap-around
    terms vanish because out-of-range blocks store zero).  ``keep``
    optionally restricts output offsets (structural center filter)."""
    acc = {}
    for da, oa in enumerate(A.offsets):
        a = A.data[da]
        for db, ob in enumerate(B.offsets):
            oc = oa + ob
            if keep is not None and oc not in keep:
                continue
            term = jnp.einsum("npq,nqr->npr", a,
                              jnp.roll(B.data[db], -oa, axis=0),
                              precision=lax.Precision.HIGHEST)
            acc[oc] = acc[oc] + term if oc in acc else term
    offsets = tuple(sorted(acc.keys()))
    return _BDia(data=jnp.stack([acc[o] for o in offsets]),
                 offsets=offsets)


def _btranspose(A: _BDia) -> _BDia:
    """A^T of an embedded block-DIA: negate offsets, transpose blocks,
    roll rows (one fused program like device_setup.dia_transpose)."""
    lookup = {o: d for d, o in enumerate(A.offsets)}
    out_offsets = tuple(sorted(-o for o in A.offsets))
    data = jnp.stack([
        jnp.roll(jnp.swapaxes(A.data[lookup[-p]], -1, -2), -p, axis=0)
        for p in out_offsets])
    return _BDia(data=data, offsets=out_offsets)


# ---------------------------------------------------------------------------
# batched small-matrix kernels (unrolled over the static block size)
# ---------------------------------------------------------------------------

def _chol_small(G, eps=0.0):
    """Batched Cholesky of (N, m, m) SPD(-ish) matrices, unrolled over
    the static m (<= 4).  Rank-deficient / all-zero (padded aggregate)
    pivots produce zero rows — mirroring fit_candidates' tol handling of
    degenerate aggregates — so downstream products stay finite."""
    m = G.shape[-1]
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = G[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                good = s > eps
                L[i][j] = jnp.where(good, jnp.sqrt(jnp.where(good, s, 1)),
                                    0.0)
            else:
                d = L[j][j]
                L[i][j] = jnp.where(d > 0, s / jnp.where(d > 0, d, 1), 0.0)
    rows = [jnp.stack([L[i][j] if j <= i else jnp.zeros_like(G[:, 0, 0])
                       for j in range(m)], axis=-1) for i in range(m)]
    return jnp.stack(rows, axis=-2)          # (N, m, m) lower


def _tri_inv_small(L):
    """Batched inverse of lower-triangular (N, m, m) by unrolled forward
    substitution; zero diagonal rows (degenerate aggregates) invert to
    zero rows."""
    m = L.shape[-1]
    X = [[None] * m for _ in range(m)]
    for i in range(m):
        d = L[:, i, i]
        dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 0.0)
        for j in range(i + 1):
            if i == j:
                X[i][j] = dinv
            else:
                s = jnp.zeros_like(d)
                for k in range(j, i):
                    s = s + L[:, i, k] * X[k][j]
                X[i][j] = -dinv * s
    rows = [jnp.stack([X[i][j] if j <= i else jnp.zeros_like(L[:, 0, 0])
                       for j in range(m)], axis=-1) for i in range(m)]
    return jnp.stack(rows, axis=-2)


def _spd_inv_small(D):
    """Batched inverse of (N, bs, bs) SPD diagonal blocks via Cholesky:
    D^-1 = L^-T L^-1 (elasticity/SA diagonal blocks are SPD; zero
    blocks — padding — invert to zero)."""
    L = _chol_small(D)
    Li = _tri_inv_small(L)
    return jnp.einsum("nki,nkj->nij", Li, Li,
                      precision=lax.Precision.HIGHEST)


# ---------------------------------------------------------------------------
# per-channel grid transforms (channels vmapped over the scalar helpers)
# ---------------------------------------------------------------------------

def _block_sum_ch(fields, coarse_grid, stride):
    """fields (C, n_fine_pad) -> (C, n_agg) per-aggregate sums."""
    return jax.vmap(lambda v: _block_sum(v, coarse_grid, stride))(fields)


def _broadcast_ch(fields_c, coarse_grid, stride, center):
    """fields_c (C, n_agg) -> (C, n_fine_pad) aggregate broadcast."""
    return jax.vmap(
        lambda v: _broadcast_coarse(v, coarse_grid, stride, center))(
            fields_c)


# ---------------------------------------------------------------------------
# tentative prolongator (Gram-QR form) on the padded node grid
# ---------------------------------------------------------------------------

def _fit_candidates_gram(B, grid_p, stride, dtype):
    """Per-aggregate orthonormalization of the candidate block.

    B: (nb_pad, bs, m) node-wise candidate values.  Returns
    (Qv, Bc) with Qv (nb_pad, bs, m) the pointwise Q = B_agg L^{-T}
    values and Bc (n_agg, m, m) the coarse candidates Bc[a,i,j] =
    R[a][i,j] = L^T (exactly fit_candidates' coarse output)."""
    nb_pad = B.shape[0]
    bs, m = B.shape[1], B.shape[2]
    coarse_grid = tuple(g // stride for g in grid_p)
    # Gram fields: G_ij = sum_comp B[:,comp,i] * B[:,comp,j]
    pairs = [(i, j) for i in range(m) for j in range(i + 1)]
    g_fields = jnp.stack([
        jnp.sum(B[:, :, i] * B[:, :, j], axis=1) for (i, j) in pairs])
    g_agg = _block_sum_ch(g_fields, coarse_grid, stride)   # (P, n_agg)
    n_agg = g_agg.shape[1]
    G = jnp.zeros((n_agg, m, m), dtype=B.dtype)
    for p, (i, j) in enumerate(pairs):
        G = G.at[:, i, j].set(g_agg[p])
        if i != j:
            G = G.at[:, j, i].set(g_agg[p])
    L = _chol_small(G)
    Li = _tri_inv_small(L)                                 # (n_agg, m, m)
    # broadcast L^{-T}[i,j] = Li[j,i] to fine nodes, multiply pointwise
    li_fields = jnp.stack([Li[:, j, i] for i in range(m)
                           for j in range(m)])             # (m*m, n_agg)
    li_f = _broadcast_ch(li_fields, coarse_grid, stride,
                         stride // 2).reshape(m, m, -1)    # [i, j, node]
    # Qv[n, c, j] = sum_i B[n, c, i] * LinvT[agg(n), i, j]
    Qv = jnp.einsum("nci,ijn->ncj", B, li_f,
                    precision=lax.Precision.HIGHEST).astype(dtype)
    # coarse candidates: Bc[a, i, j] = (L^T)[a, i, j] = L[a, j, i]
    Bc = jnp.swapaxes(L, -1, -2).astype(dtype)
    return Qv, Bc


def _tentative_bdia(Qv, grid_p, stride, center, dtype) -> _BDia:
    """Embedded tentative prolongator T as a rectangular block-DIA on
    the fine node grid: T[node, root(node)] = Qv[node] (bs x m block),
    offsets selected by static position-within-aggregate masks (the
    block generalization of device_setup._tentative_emb)."""
    dim = len(grid_p)
    pos = [jnp.arange(g) % stride for g in grid_p]
    offsets = []
    blocks = []
    for combo in np.ndindex(*([2 * stride - 1] * dim)):
        coords = tuple(int(c) - (stride - 1) for c in combo)
        masks = []
        ok = True
        for d in range(dim):
            want = center - coords[d]
            if not (0 <= want < stride):
                ok = False
                break
            masks.append(pos[d] == want)
        if not ok:
            continue
        shape = [1] * dim
        shape[0] = grid_p[0]
        msk = masks[0].reshape(shape)
        for d in range(1, dim):
            shape = [1] * dim
            shape[d] = grid_p[d]
            msk = msk & masks[d].reshape(shape)
        offsets.append(_coords_to_offset(coords, grid_p))
        blocks.append(jnp.where(msk.reshape(-1)[:, None, None], Qv,
                                0).astype(dtype))
    order = np.argsort(offsets)
    return _BDia(data=jnp.stack([blocks[i] for i in order]),
                 offsets=tuple(int(offsets[i]) for i in order))


# ---------------------------------------------------------------------------
# block operator plumbing
# ---------------------------------------------------------------------------

def _relayout_block(A: BlockDIAMatrix, grid, grid_p) -> BlockDIAMatrix:
    """Re-lay a block-DIA operator from node grid onto the padded node
    grid (block generalization of device_setup._relayout_dia)."""
    if tuple(grid) == tuple(grid_p) and A.nb_pad == int(np.prod(grid)):
        return A
    nb = int(np.prod(grid))
    bs = A.bs
    rows = []
    offsets = []
    for d, o in enumerate(A.offsets):
        coords = _offset_to_coords(o, grid)
        offsets.append(_coords_to_offset(coords, grid_p))
        blk = A.data[d][:nb].reshape(nb, bs * bs)
        padded = jax.vmap(lambda v: _grid_pad_vec(v, grid, grid_p),
                          in_axes=1, out_axes=1)(blk)
        rows.append(padded.reshape(-1, bs, bs))
    order = np.argsort(offsets)
    nbp = int(np.prod(grid_p))
    return BlockDIAMatrix(
        data=jnp.stack([rows[i] for i in order]),
        offsets=tuple(int(offsets[i]) for i in order),
        shape=(nbp * bs, nbp * bs), bs=bs, nnz=A.nnz)


def _compact_bdia(C: _BDia, grid_p, stride, center, m, nnz) -> BlockDIAMatrix:
    """Extract the coarse block operator from its fine-node embedding
    (center rows, offsets divided by stride per dim)."""
    coarse_grid = tuple(g // stride for g in grid_p)
    out_offsets = []
    rows = []
    for d, o in enumerate(C.offsets):
        coords = _offset_to_coords(o, grid_p)
        assert all(c % stride == 0 for c in coords), (o, coords)
        cc = tuple(c // stride for c in coords)
        out_offsets.append(_coords_to_offset(cc, coarse_grid))
        blk = C.data[d].reshape(C.data[d].shape[0], m * m)
        comp = jax.vmap(
            lambda v: _compact_fine(v, coarse_grid, stride, center),
            in_axes=1, out_axes=1)(blk)
        rows.append(comp.reshape(-1, m, m))
    order = np.argsort(out_offsets)
    nc = int(np.prod(coarse_grid))
    return BlockDIAMatrix(
        data=jnp.stack([rows[i] for i in order]),
        offsets=tuple(int(out_offsets[i]) for i in order),
        shape=(nc * m, nc * m), bs=m, nnz=nnz)


def _block_power_rho(A: BlockDIAMatrix, Dinv, iters=40):
    """rho(D^-1 A) by power iteration with the batched block D^-1
    (device analog of relaxation.smoothing.rho_block_D_inv_A)."""
    n_pad = A.n_pad
    v0 = (_hash_weights(n_pad, 12345).astype(A.dtype) - 0.5)
    v0 = jnp.where(A.diagonal() != 0, v0, 0)
    v0 = v0 / jnp.maximum(jnp.linalg.norm(v0), 1e-30)
    bs = A.bs

    def dapply(w):
        from .relaxation import _block_apply
        return _block_apply(Dinv, w.reshape(-1, bs)).reshape(-1)

    def body(_, v):
        w = dapply(A @ v)
        nrm = jnp.linalg.norm(w)
        return w / jnp.where(nrm == 0, 1, nrm)

    v = lax.fori_loop(0, iters, body, v0)
    return jnp.linalg.norm(dapply(A @ v))


# ---------------------------------------------------------------------------
# solve-phase factored block transfers (pytrees)
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class BlockStructuredProlongator:
    """P = S_smooth · T applied factored on block node grids:

        (T @ xc)[node, comp] = sum_j Qv[node, comp, j] * xc[agg(node), j]
        P @ xc = S @ (T @ xc)

    — m aggregate-broadcasts + one pointwise einsum + one block-DIA
    SpMV, the block generalization of StructuredProlongator."""

    S: BlockDIAMatrix
    Qv: jnp.ndarray                  # (nb_fine_pad, bs, m)
    fine_grid_p: Tuple[int, ...]
    coarse_grid: Tuple[int, ...]
    coarse_grid_p: Tuple[int, ...]
    stride: int
    center: int

    def tree_flatten(self):
        return (self.S, self.Qv), (self.fine_grid_p, self.coarse_grid,
                                   self.coarse_grid_p, self.stride,
                                   self.center)

    @classmethod
    def tree_unflatten(cls, aux, children):
        S, Qv = children
        f, c, cp, s, ctr = aux
        return cls(S=S, Qv=Qv, fine_grid_p=f, coarse_grid=c,
                   coarse_grid_p=cp, stride=s, center=ctr)

    @property
    def m(self):
        return self.Qv.shape[2]

    @property
    def nnz(self):
        return int(np.prod(self.fine_grid_p)) * self.S.ndiags * \
            self.S.bs * self.m

    @property
    def shape(self):
        return (int(np.prod(self.fine_grid_p)) * self.Qv.shape[1],
                int(np.prod(self.coarse_grid_p)) * self.m)

    def __matmul__(self, xc):
        m = self.m
        xcb = xc.reshape(-1, m)
        chans = []
        for j in range(m):
            v = _grid_unpad_vec(xcb[:, j].reshape(-1), self.coarse_grid,
                                self.coarse_grid_p)
            chans.append(_broadcast_coarse(v, self.coarse_grid,
                                           self.stride, self.center))
        t = jnp.stack(chans, axis=-1)                   # (nb_fine, m)
        cols = [t[:, j] for j in range(m)]
        y = jnp.stack(
            [sum(self.Qv[:, c, j] * cols[j] for j in range(m))
             for c in range(self.Qv.shape[1])], axis=1).reshape(-1)
        return self.S @ y


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class BlockStructuredRestrictor:
    """R = P^T = T^T · S^T applied factored:

        z = S^T @ r;  R@r[(a,j)] = blocksum_a( sum_comp Qv[:,comp,j]*z )
    """

    St: BlockDIAMatrix
    Qv: jnp.ndarray
    fine_grid_p: Tuple[int, ...]
    coarse_grid: Tuple[int, ...]
    coarse_grid_p: Tuple[int, ...]
    stride: int
    center: int

    def tree_flatten(self):
        return (self.St, self.Qv), (self.fine_grid_p, self.coarse_grid,
                                    self.coarse_grid_p, self.stride,
                                    self.center)

    @classmethod
    def tree_unflatten(cls, aux, children):
        St, Qv = children
        f, c, cp, s, ctr = aux
        return cls(St=St, Qv=Qv, fine_grid_p=f, coarse_grid=c,
                   coarse_grid_p=cp, stride=s, center=ctr)

    @property
    def m(self):
        return self.Qv.shape[2]

    @property
    def nnz(self):
        return int(np.prod(self.fine_grid_p)) * self.St.ndiags * \
            self.St.bs * self.m

    @property
    def shape(self):
        return (int(np.prod(self.coarse_grid_p)) * self.m,
                int(np.prod(self.fine_grid_p)) * self.Qv.shape[1])

    @property
    def n_pad(self):
        return int(np.prod(self.coarse_grid_p)) * self.m

    def __matmul__(self, r):
        m = self.m
        bs = self.Qv.shape[1]
        z = (self.St @ r).reshape(-1, bs)
        cols = []
        for j in range(m):
            f = jnp.sum(self.Qv[:, :, j] * z, axis=1)
            yc = _block_sum(f, self.coarse_grid, self.stride)
            cols.append(_grid_pad_vec(yc, self.coarse_grid,
                                      self.coarse_grid_p))
        return jnp.stack(cols, axis=-1).reshape(-1)


# ---------------------------------------------------------------------------
# the fused setup pipeline
# ---------------------------------------------------------------------------

def _coarsen_level_block(A_p: BlockDIAMatrix, B, grid_p, stride, center,
                         omega, m, dtype):
    """One block SA coarsening step (the block analog of
    device_setup._coarsen_level).  B: (nb_pad, bs, m)."""
    bs = A_p.bs
    Dblk = A_p.block_diagonal()
    Dinv = _spd_inv_small(Dblk)
    Qv, Bc_blocks = _fit_candidates_gram(B, grid_p, stride, dtype)
    T = _tentative_bdia(Qv, grid_p, stride, center, dtype)
    rho = _block_power_rho(A_p, Dinv)
    # S = I - (omega/rho) D^-1 A  (block row-scaled A + identity bump)
    scale = -(omega / jnp.where(rho == 0, 1, rho))
    s_data = scale * jnp.einsum("nij,dnjk->dnik", Dinv, A_p.data,
                                precision=lax.Precision.HIGHEST)
    valid = (jnp.einsum("nii->n", jnp.abs(Dblk)) > 0)
    eye_b = valid[:, None, None] * jnp.eye(bs, dtype=s_data.dtype)
    if 0 in A_p.offsets:
        d0 = A_p.offsets.index(0)
        s_data = s_data.at[d0].add(eye_b)
        S = BlockDIAMatrix(data=s_data, offsets=A_p.offsets,
                           shape=A_p.shape, bs=bs, nnz=A_p.nnz)
    else:
        S = BlockDIAMatrix(
            data=jnp.concatenate([s_data, eye_b[None]]),
            offsets=A_p.offsets + (0,), shape=A_p.shape, bs=bs,
            nnz=A_p.nnz)
    S_b = _BDia(data=S.data, offsets=S.offsets)
    A_b = _BDia(data=A_p.data, offsets=A_p.offsets)
    P_emb = _bspgemm(S_b, T)
    R_emb = _btranspose(P_emb)
    AP = _bspgemm(A_b, P_emb)
    cand = set()
    for oa in R_emb.offsets:
        for ob in AP.offsets:
            oc = oa + ob
            try:
                coords = _offset_to_coords(oc, grid_p)
            except ValueError:
                continue
            if all(c % stride == 0 for c in coords):
                cand.add(oc)
    Ac_emb = _bspgemm(R_emb, AP, keep=cand)
    nb_c = int(np.prod(grid_p)) // stride ** len(grid_p)
    A_c = _compact_bdia(Ac_emb, grid_p, stride, center, m,
                        nnz=nb_c * m * m * len(Ac_emb.offsets))
    St = BlockDIAMatrix(data=_btranspose(S_b).data,
                        offsets=tuple(sorted(-o for o in S.offsets)),
                        shape=A_p.shape, bs=bs, nnz=S.nnz)
    return S, St, Qv, Dinv, A_c, Bc_blocks, rho


def _block_smoother_arrays(key, A_p, Dinv, rho, dtype):
    """Device arrays for the per-level smoother spec (block forms).

    'jacobi' and 'block_jacobi' both map to the block-Jacobi sweep with
    the batched block-diagonal inverse; 'richardson'/'chebyshev' reuse
    the scalar polynomial forms (they only need A @ x)."""
    if key is None:
        return ()
    name, kw = key
    kw = dict(kw)
    if name in ("jacobi", "block_jacobi"):
        omega = jnp.asarray(float(kw.get("omega", 1.0)), dtype=dtype)
        if kw.get("withrho", True):
            omega = omega / jnp.maximum(rho, 1e-30)
        return (Dinv, omega)
    if name == "richardson":
        rho_A = _block_power_rho(A_p, jnp.broadcast_to(
            jnp.eye(A_p.bs, dtype=A_p.dtype),
            (A_p.nb_pad, A_p.bs, A_p.bs)))
        omega = jnp.asarray(float(kw.get("omega", 1.0)),
                            dtype=dtype) / jnp.maximum(rho_A, 1e-30)
        return (omega,)
    if name == "chebyshev":
        from ..relaxation.chebyshev import chebyshev_polynomial_coefficients

        lower = float(kw.get("lower_bound", 1.0 / 30.0))
        upper = float(kw.get("upper_bound", 1.1))
        degree = int(kw.get("degree", 3))
        c_unit = np.asarray(
            chebyshev_polynomial_coefficients(lower, upper, degree))
        rho_A = _block_power_rho(A_p, jnp.broadcast_to(
            jnp.eye(A_p.bs, dtype=A_p.dtype),
            (A_p.nb_pad, A_p.bs, A_p.bs)))
        exps = degree - np.arange(degree)
        coeffs = jnp.asarray(c_unit, dtype=dtype) * (
            jnp.maximum(rho_A, 1e-30) ** jnp.asarray(-exps, dtype=dtype))
        return (coeffs,)
    raise ValueError(
        f"block device setup supports jacobi/block_jacobi/richardson/"
        f"chebyshev, got {name!r}")


def _block_smoother_wrap(key, arrays):
    if key is None:
        return device_relaxation.identity()
    name, kw = key
    kw = dict(kw)
    iterations = int(kw.get("iterations", 1))
    if name in ("jacobi", "block_jacobi"):
        return device_relaxation.block_jacobi_dyn(arrays[0], arrays[1],
                                                  iterations)
    if name == "richardson":
        return device_relaxation.richardson_dyn(arrays[0], iterations)
    if name == "chebyshev":
        return device_relaxation.polynomial_dyn(arrays[0], iterations)
    raise ValueError(name)


@partial(jax.jit, static_argnames=("plan", "stride", "omega", "m",
                                   "dtype", "pre_key", "post_key"))
def _setup_pipeline_block(A_in, B_in, *, plan, stride, omega, m, dtype,
                          pre_key, post_key):
    """The ENTIRE block multi-level SA setup as ONE XLA program (see
    device_setup._setup_pipeline)."""
    center = stride // 2
    cur = A_in
    B = B_in                               # (nb, bs, m) node-grid layout
    out_levels = []
    for (grid, grid_p) in plan:
        A_p = _relayout_block(cur, grid, grid_p)
        nbp = int(np.prod(grid_p))
        bs = A_p.bs
        nb = int(np.prod(grid))
        Bp = jax.vmap(lambda v: _grid_pad_vec(v, grid, grid_p),
                      in_axes=1, out_axes=1)(
            B[:nb].reshape(nb, bs * m)).reshape(nbp, bs, m)
        S, St, Qv, Dinv, A_c, Bc, rho = _coarsen_level_block(
            A_p, Bp, grid_p, stride, center, omega, m, dtype)
        pre_arr = _block_smoother_arrays(pre_key, A_p, Dinv, rho, dtype)
        post_arr = _block_smoother_arrays(post_key, A_p, Dinv, rho, dtype)
        out_levels.append((A_p, S, St, Qv, rho, pre_arr, post_arr))
        cur = A_c
        B = Bc                              # (n_agg, m, m)
    Ac_dense = cur.matmat(jnp.eye(cur.n_pad, dtype=dtype))
    coarse_inv = _ns_pinv(Ac_dense)
    return tuple(out_levels), Ac_dense, coarse_inv


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class BlockStructuredDeviceSolver(StructuredDeviceSolver):
    """StructuredDeviceSolver whose fine vectors carry ``bs`` components
    per node (scipy BSR scalar layout, node-major)."""

    def __init__(self, hierarchy, grid, grid_p, bs, setup_info=None):
        super().__init__(hierarchy, grid, grid_p, setup_info)
        self.bs = int(bs)

    def _encode(self, v):
        # device arrays re-lay ON device (reshape+pad) — no host
        # round-trip; see StructuredDeviceSolver._encode
        xp = jnp if isinstance(v, jnp.ndarray) else np
        v = v if isinstance(v, jnp.ndarray) else np.asarray(v)
        v = v.reshape(self.grid + (self.bs,))
        pads = [(0, gp - g) for g, gp in zip(self.grid, self.grid_p)]
        return xp.pad(v, pads + [(0, 0)]).reshape(-1)

    def _decode(self, v):
        v = v if isinstance(v, jnp.ndarray) else np.asarray(v)
        v = v.reshape(self.grid_p + (self.bs,))
        sl = tuple(slice(0, g) for g in self.grid) + (slice(None),)
        return v[sl].reshape(-1)


def device_sa_setup_block(A, grid, B, dtype=jnp.float32, omega=4.0 / 3.0,
                          stride=3, max_coarse=400, max_levels=12,
                          presmoother=("block_jacobi",
                                       {"omega": 4.0 / 3.0}),
                          postsmoother=("block_jacobi",
                                        {"omega": 4.0 / 3.0}),
                          mixed_precision=False):
    """Build a BLOCK / multi-candidate SA hierarchy on device.

    ``A``: scipy BSR (square blocks, node-major rows on the row-major
    node ``grid``) or CSR (treated as bs=1).  ``B``: (n, m) candidate
    block (m <= 4) — e.g. rigid-body modes for elasticity.  Smoothers:
    jacobi/block_jacobi (block-diagonal-inverse sweeps), richardson,
    chebyshev.  See device_sa_setup for the structured-aggregation
    contract; coarser levels carry square blocks of size m.

    Reference counterpart: smoothed_aggregation_solver with a BSR A and
    multi-column B ([R] pyamg/aggregation/aggregation.py, SURVEY.md
    §2.2) — host setup remains the parity reference.
    """
    if jnp.dtype(dtype).itemsize == 8:
        jax.config.update("jax_enable_x64", True)   # else silent f32
    grid = tuple(int(g) for g in grid)
    nb = int(np.prod(grid))
    if sp.issparse(A):
        Absr = A.tobsr() if A.format != "bsr" else A
        bs = Absr.blocksize[0]
        if Absr.blocksize[0] != Absr.blocksize[1]:
            raise ValueError("square blocks required")
        if Absr.shape[0] != nb * bs:
            raise ValueError(f"grid {grid} (x bs) does not match A "
                             f"{Absr.shape}")
        from ..sparse import block_dia_from_scipy

        A_bd = block_dia_from_scipy(Absr, dtype=dtype, max_diags=600)
        if A_bd is None:
            raise ValueError("operator is not block-banded on this grid")
    elif isinstance(A, BlockDIAMatrix):
        A_bd = A
        bs = A.bs
    else:
        raise TypeError("A must be scipy sparse or BlockDIAMatrix")

    B = np.asarray(B, dtype=np.float64)
    if B.ndim == 1:
        B = B[:, None]
    m = B.shape[1]
    if m > 4:
        raise ValueError("block device setup supports m <= 4 candidates")
    if B.shape[0] != nb * bs:
        raise ValueError("B rows must equal n")

    # ---- static coarsening plan (node grid) --------------------------
    plan = []
    cur_grid = grid
    while (int(np.prod(cur_grid)) * max(bs, m) > max_coarse
           and len(plan) < max_levels - 1
           and min(_padded_grid(cur_grid, stride)) >= 3 * stride):
        grid_p = _padded_grid(cur_grid, stride)
        plan.append((cur_grid, grid_p))
        cur_grid = tuple(g // stride for g in grid_p)
    if not plan:
        raise ValueError(
            f"grid {grid} is below the coarsening threshold "
            f"(max_coarse={max_coarse}); use the host setup path")
    nlev = len(plan)

    pre_key = _spec_key(presmoother)
    post_key = _spec_key(postsmoother)

    B_dev = jnp.asarray(B.reshape(nb, bs, m), dtype=dtype)
    out_levels, Ac_dense, coarse_inv = _setup_pipeline_block(
        A_bd, B_dev, plan=tuple(plan), stride=stride, omega=omega, m=m,
        dtype=dtype, pre_key=pre_key, post_key=post_key)

    dev_levels = []
    infos = []
    for i, ((lv_grid, grid_p), (A_p, S, St, Qv, rho, pre_arr,
                                post_arr)) in enumerate(zip(plan,
                                                            out_levels)):
        coarse_grid = tuple(g // stride for g in grid_p)
        coarse_grid_p = (_padded_grid(coarse_grid, stride)
                         if i + 1 < nlev else coarse_grid)
        P = BlockStructuredProlongator(
            S=S, Qv=Qv, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=stride,
            center=stride // 2)
        R = BlockStructuredRestrictor(
            St=St, Qv=Qv, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=stride,
            center=stride // 2)
        npad_lvl = int(np.prod(grid_p)) * A_p.bs
        dev_levels.append(DeviceLevel(
            A=A_p, P=P, R=R, pre=_block_smoother_wrap(pre_key, pre_arr),
            post=_block_smoother_wrap(post_key, post_arr), n=npad_lvl,
            n_pad=npad_lvl))
        infos.append({"level": i, "n": npad_lvl, "bs": A_p.bs,
                      "ndiags": A_p.ndiags, "rho": rho})

    from ..sparse.dia import DenseOperator

    nc = int(np.prod(cur_grid)) * m
    ident = device_relaxation.identity()
    Ac_op = DenseOperator(data=Ac_dense, shape=(nc, nc), nnz=nc * nc)
    dev_levels.append(DeviceLevel(A=Ac_op, P=None, R=None, pre=ident,
                                  post=ident, n=nc, n_pad=nc))

    A64 = None
    if mixed_precision:
        jax.config.update("jax_enable_x64", True)
        if not sp.issparse(A):
            raise ValueError("mixed_precision needs the scipy operator "
                             "(f64 source data)")
        from ..sparse import block_dia_from_scipy as _bd64

        A64_bd = _bd64(Absr, dtype=jnp.float64, max_diags=600)
        A64 = _relayout_block(A64_bd, grid, plan[0][1])

    hierarchy = DeviceHierarchy(
        levels=dev_levels, coarse_inv=coarse_inv, nc=nc, nc_pad=nc,
        dtype=jnp.dtype(dtype), A64=A64)
    return BlockStructuredDeviceSolver(
        hierarchy, grid, plan[0][1], bs,
        setup_info={"levels": infos, "m": m, "stride": stride})

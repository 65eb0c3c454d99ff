"""Windowed ELL SpMV — the device format for transfer operators.

AMG transfer operators (P, R) and reordered operators touch, per
contiguous row block, only a narrow window of the source vector.  The
apply is a gather of x at each stored column followed by a per-row sum;
on the GPU the windowed (local) indices make the gather read from cache.
Square banded operators use DIA (sparse/dia.py) instead.

Layout (host-built):
- rows grouped into blocks of ``BLOCK``; block b's column window is
  [starts[b]*W2, starts[b]*W2 + W) with W = 2*W2, W2 a multiple of 128.
- per-entry indices are stored window-relative and packed as one word
  (chunk*128 + lane), so the global column is starts[b]*W2 + idx.

Reference counterpart: scipy csr_matvec for P/R products (SURVEY.md
§3.2 hot loop).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax import lax

from .formats import pad_to

__all__ = ["WindowedELL", "TransposedWindowed", "windowed_from_scipy",
           "ComplexWindowed", "complex_windowed_from_scipy"]

_LANES = 128


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class WindowedELL:
    """Window-blocked ELL matrix (see module docstring)."""

    data: jnp.ndarray      # (n_blocks, k, BLOCK) values, slot-major
    idx: jnp.ndarray       # (n_blocks, k, BLOCK) int32 window-relative
    #                        index, packed: idx = chunk*128 + lane
    starts: jnp.ndarray    # (n_blocks,) int32, window start in W2 units
    shape: Tuple[int, int]
    block: int             # rows per block (static)
    w2: int                # half-window in elements, multiple of 128
    m_chunks: int          # padded source length in W2 units (static)
    nnz: int

    def tree_flatten(self):
        return (self.data, self.idx, self.starts), (
            self.shape, self.block, self.w2, self.m_chunks, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, idx, starts = children
        shape, block, w2, m_chunks, nnz = aux
        return cls(data=data, idx=idx, starts=starts, shape=shape,
                   block=block, w2=w2, m_chunks=m_chunks, nnz=nnz)

    @property
    def n_pad(self):
        return self.data.shape[0] * self.block

    @property
    def k(self):
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    # ------------------------------------------------------------------

    def _x_padded(self, x):
        need = self.m_chunks * self.w2
        if x.shape[0] < need:
            x = jnp.pad(x, (0, need - x.shape[0]))
        elif x.shape[0] > need:
            x = x[:need]
        return x

    def _gidx(self):
        """Global source column of every stored slot, (n_blocks, k, BLOCK)."""
        return self.starts[:, None, None] * self.w2 + self.idx

    def matvec(self, x):
        """y = A @ x: gather x at each slot's column, sum over slots.
        Under jax.vmap the batch axis leads (the K-major layout of
        :meth:`matmat_k`)."""
        vals = jnp.take(self._x_padded(x), self._gidx(), axis=0)
        return jnp.sum(self.data * vals, axis=1).reshape(-1)

    def rmatvec(self, x):
        """A.T @ x by scatter-add.  On the GPU a scatter-add sums
        colliding entries with atomics, in an order that can change
        from run to run; the host-built hierarchy therefore stores its
        restrictions explicitly (engine/hierarchy.py) and applies them
        with :meth:`matvec`."""
        xb = x[: self.n_pad].reshape(self.data.shape[0], 1, self.block)
        y = jnp.zeros(self.m_chunks * self.w2, dtype=self.dtype)
        return y.at[self._gidx()].add(self.data * xb)

    def select(self, x):
        """Per-slot window selection: out[b, s, r] = x[starts[b]*w2
        + idx[b, s, r]] — the "read x at my column" primitive that
        powers the UNSTRUCTURED device setup (engine/
        unstructured_setup.py): strength measures, Luby MIS neighbor
        reductions, aggregate-root lookups and tentative-operator
        construction are all elementwise functions of selected vectors.
        Exact for any payload.  Setup-phase only."""
        return jnp.take(self._x_padded(x), self._gidx(), axis=0)

    def matmat(self, X):
        """Y = A @ X for a padded column stack X (m_pad, K)."""
        return self.matmat_k(X.T).T

    def matmat_k(self, Xk):
        """Y = A @ X for K-major lane stacks (K, m_pad) -> (K, n_pad)."""
        return jax.vmap(self.matvec)(Xk)

    def rmatmat(self, X):
        """A.T @ X for a column stack (n_pad, K)."""
        return self.rmatmat_k(X[: self.n_pad].T).T

    def rmatmat_k(self, Xk):
        """A.T @ X for K-major lane stacks (K, n_pad) -> (K, m_pad)."""
        return jax.vmap(self.rmatvec)(Xk)

    def __matmul__(self, x):
        if x.ndim != 1:
            return self.matmat(x)
        return self.matvec(x)

    def diagonal(self):
        rows = jnp.arange(self.n_pad).reshape(self.data.shape[0], 1,
                                              self.block)
        return jnp.sum(jnp.where(self._gidx() == rows, self.data, 0),
                       axis=1).reshape(-1)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class TransposedWindowed:
    """Lazy transpose of a WindowedELL: ``matvec`` is the base operator's
    transpose apply.

    The restriction form of the device-built unstructured hierarchies:
    R = P^T applied backwards through :meth:`WindowedELL.rmatvec`,
    sharing P's arrays.  The apply is a scatter-add, whose sum order can
    change from run to run on the GPU.  Reference counterpart: scipy
    ``P.T @ r`` inside MultilevelSolver.__solve (SURVEY.md §2.1)."""

    base: WindowedELL

    def tree_flatten(self):
        return (self.base,), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        (base,) = children
        return cls(base=children[0])

    @property
    def shape(self):
        return (self.base.shape[1], self.base.shape[0])

    @property
    def nnz(self):
        return self.base.nnz

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def n_pad(self):
        return self.base.m_chunks * self.base.w2

    def matvec(self, x):
        need = self.base.n_pad
        if x.shape[0] < need:
            x = jnp.pad(x, (0, need - x.shape[0]))
        elif x.shape[0] > need:
            x = x[:need]
        return self.base.rmatvec(x)

    def rmatvec(self, x):
        return self.base.matvec(x)

    def matmat(self, X):
        """R @ X for a column stack."""
        need = self.base.n_pad
        if X.shape[0] < need:
            X = jnp.pad(X, ((0, need - X.shape[0]), (0, 0)))
        elif X.shape[0] > need:
            X = X[:need]
        return self.base.rmatmat(X)

    def __matmul__(self, x):
        if x.ndim != 1:
            return self.matmat(x)
        return self.matvec(x)


# ---------------------------------------------------------------------------
# complex transfer operators: re/im split over REAL windowed kernels
# ---------------------------------------------------------------------------

def _cdtype_of(re_dtype):
    return (jnp.complex64 if jnp.dtype(re_dtype) == jnp.float32
            else jnp.complex128)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class ComplexWindowed:
    """Re/im-split complex windowed operator.

    A complex transfer operator A = Ar + i*Ai is stored as two REAL
    WindowedELL parts sharing ONE geometry (same idx/starts device
    buffers — the split happens after conversion, so patterns match
    structurally) and applied with four real passes:

        A @ x = (Ar xr - Ai xi) + i (Ar xi + Ai xr).

    Used by gauge-Laplacian-class hierarchies (SURVEY.md §2.3 gallery,
    complex Hermitian).  Reference counterpart: scipy complex
    csr_matvec (SURVEY.md §3.2)."""

    re: WindowedELL
    im: WindowedELL

    def tree_flatten(self):
        return (self.re, self.im), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(re=children[0], im=children[1])

    @property
    def shape(self):
        return self.re.shape

    @property
    def nnz(self):
        return self.re.nnz

    @property
    def n_pad(self):
        return self.re.n_pad

    @property
    def dtype(self):
        return _cdtype_of(self.re.dtype)

    def matvec(self, x):
        xr, xi = jnp.real(x), jnp.imag(x)
        yr = self.re.matvec(xr) - self.im.matvec(xi)
        yi = self.re.matvec(xi) + self.im.matvec(xr)
        return lax.complex(yr, yi)

    def rmatvec(self, x):
        """A.T @ x (plain transpose — conjugation is the wrapper's job)."""
        xr, xi = jnp.real(x), jnp.imag(x)
        yr = self.re.rmatvec(xr) - self.im.rmatvec(xi)
        yi = self.re.rmatvec(xi) + self.im.rmatvec(xr)
        return lax.complex(yr, yi)

    def matmat(self, X):
        cols = [self.matvec(X[:, j]) for j in range(X.shape[1])]
        return jnp.stack(cols, axis=1)

    def __matmul__(self, x):
        if x.ndim != 1:
            return self.matmat(x)
        return self.matvec(x)


def complex_windowed_from_scipy(A, dtype=jnp.complex64, block=None,
                                max_w2=16384):
    """Build a ComplexWindowed from a complex scipy sparse matrix.

    Converts ONCE on the full complex pattern (so both parts share
    geometry: block, w2, starts, idx), then splits the data into real
    WindowedELL parts.  Returns None when not windowable."""
    rdtype = (jnp.float32 if jnp.dtype(dtype) == jnp.complex64
              else jnp.float64)
    W = windowed_from_scipy(A, dtype=dtype, block=block, max_w2=max_w2)
    if W is None:
        return None

    def part(data):
        return WindowedELL(data=data, idx=W.idx, starts=W.starts,
                           shape=W.shape, block=W.block, w2=W.w2,
                           m_chunks=W.m_chunks, nnz=W.nnz)

    return ComplexWindowed(re=part(jnp.real(W.data).astype(rdtype)),
                           im=part(jnp.imag(W.data).astype(rdtype)))


def windowed_from_scipy(A, dtype=jnp.float32, block=None, max_w2=16384):
    """Build a WindowedELL from a scipy sparse matrix.

    ``block=None`` picks the row-block size from (8192, ..., 256) by a
    heuristic cost (a per-block term plus k*n times the window width):
    large blocks win whenever the window does not grow with the block.
    The gather apply is correct for any admissible choice.

    Returns None when some row block's column span exceeds ``max_w2``
    (operator not windowable under the current ordering — caller should
    reorder or fall back).
    """
    candidates = ((8192, 4096, 2048, 1024, 512, 256) if block is None
                  else (int(block),))
    A = sp.csr_matrix(A)
    A.sort_indices()
    n, m = A.shape
    n_pad_max = pad_to(max(n, 1), max(candidates))
    lens = np.diff(A.indptr)
    k = max(int(lens.max()) if n else 0, 1)

    # dense padded (row, slot) -> col/val — staged ONCE at the largest
    # candidate padding (empty padding rows never affect window spans)
    rows = np.repeat(np.arange(n), lens)
    slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], lens)
    cols = np.zeros((n_pad_max, k), dtype=np.int64)
    host_dt = (np.complex128 if jnp.issubdtype(jnp.dtype(dtype),
                                               jnp.complexfloating)
               else np.float64)
    vals = np.zeros((n_pad_max, k), dtype=host_dt)
    has = np.zeros((n_pad_max, k), dtype=bool)
    if A.nnz:
        cols[rows, slots] = A.indices
        vals[rows, slots] = A.data
        has[rows, slots] = True

    # per-group min/max at the finest candidate granularity; larger
    # blocks reduce over these groups (no re-staging per candidate)
    GR = min(candidates)
    g = n_pad_max // GR
    g_min = np.where(has, cols, np.iinfo(np.int64).max).reshape(
        g, -1).min(axis=1)
    g_max = np.where(has, cols, -1).reshape(g, -1).max(axis=1)

    # pick (block, w2): largest block whose window stays at the minimum
    # w2=1024, else minimize the heuristic cost
    best = None
    best_cost = None
    for blk in candidates:
        n_pad_c = pad_to(max(n, 1), blk)
        nb = n_pad_c // blk
        # bound one block's slab of data + idx
        if k * blk * 8 * 2 > 4 * 2**20:
            continue
        q = blk // GR
        gm = g_min[: n_pad_c // GR].reshape(nb, q).min(axis=1)
        gM = g_max[: n_pad_c // GR].reshape(nb, q).max(axis=1)
        empty = gM < 0
        gm[empty] = 0
        gM[empty] = 0
        # W2 must satisfy: for each block, span fits within 2*W2 when the
        # window starts at floor(min/W2)*W2.  Minimum 1024.
        w2_c = 1024
        while True:
            if (gM < (gm // w2_c + 2) * w2_c).all():
                break
            w2_c *= 2
            if w2_c > max_w2:
                w2_c = None
                break
        if w2_c is None:
            continue
        cost = nb * 0.15e-6 + k * n_pad_c * (2 * w2_c // _LANES) * 8e-12
        if best_cost is None or cost < best_cost:
            best = (blk, w2_c, n_pad_c, nb, gm)
            best_cost = cost
    if best is None:
        return None
    block, w2, n_pad, n_blocks, mins = best
    cols = cols[:n_pad]
    vals = vals[:n_pad]
    has = has[:n_pad]
    starts = mins // w2

    m_chunks = pad_to(max(m, 1), w2) // w2
    # starts+1 must be addressable
    m_chunks = max(m_chunks, int(starts.max()) + 2)

    local = cols - (starts[:, None] * w2).repeat(block, axis=0).reshape(n_pad, 1)
    local = np.where(has, local, 0)

    # ship the packed window-relative index (= chunk*128 + lane) as int16
    # — it fits (local < 2*max_w2 = 32768) and halves the upload of
    # multi-million-row hierarchies; one device-side cast widens it to
    # int32.
    idx16 = local.reshape(n_blocks, block, k).transpose(0, 2, 1).astype(
        np.int16)
    idx = jnp.asarray(idx16).astype(jnp.int32)

    return WindowedELL(
        data=jnp.asarray(
            vals.reshape(n_blocks, block, k).transpose(0, 2, 1), dtype=dtype),
        idx=idx,
        starts=jnp.asarray(starts, dtype=jnp.int32),
        shape=(n, m),
        block=block,
        w2=int(w2),
        m_chunks=int(m_chunks),
        nnz=int(A.nnz),
    )

"""DIA (diagonal) device format for banded operators.

AMG operators on lexicographically ordered grids are banded.  Stored by
diagonal, the SpMV is a sum of shifted elementwise multiplies

    y = sum_d  data[d, :] * x[i + offset[d]]

with no gather: each shifted read is a static slice of one zero-padded
copy of x, and XLA fuses the pad, the slices and the multiply-adds into
one loop.  The shifted re-reads of x are close together (at most one
grid plane apart), so they come from cache and the HBM traffic is about
(ndiags + 2) * n words.  DIA beats a gather whenever
fill = nnz / (ndiags * n) is not tiny, which holds for reordered AMG
operators.

This replaces the reference's CSR SpMV (scipy csr_matvec, SURVEY.md
§2.4 L0) on the device hot path.
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

from .formats import pad_to

__all__ = ["DIAMatrix", "dia_from_scipy", "dia_from_stencil",
           "DenseOperator", "dense_from_scipy"]


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class DIAMatrix:
    """Diagonal-stored sparse matrix over padded vectors.

    data[d, i] = A[i, i + offsets[d]] (zero where no entry / out of
    range), so padded rows and wrap-around positions contribute exactly
    zero — vectors stay clean without masks.
    """

    data: jnp.ndarray            # (ndiags, n_pad)
    offsets: Tuple[int, ...]     # static
    shape: Tuple[int, int]       # logical
    nnz: int

    def tree_flatten(self):
        return (self.data,), (self.offsets, self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (data,) = children
        offsets, shape, nnz = aux
        return cls(data=data, offsets=offsets, shape=shape, nnz=nnz)

    @property
    def n_pad(self):
        return self.data.shape[1]

    @property
    def ndiags(self):
        return len(self.offsets)

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x):
        """y = A @ x (1-D padded x): static slices of one zero-padded
        buffer.  Equal to the circular-roll form: out-of-range DIA slots
        store zero, so wrap-around (roll) and zero-fill (slice) agree.
        Under jax.vmap the batch axis leads, which is the K-major layout
        of :meth:`matmat_k`."""
        h = max(max(self.offsets), -min(self.offsets), 0)
        xp = jnp.pad(x, (h, h))
        n_pad = self.n_pad
        y = self.data[0] * lax.slice_in_dim(
            xp, h + self.offsets[0], h + self.offsets[0] + n_pad)
        for d in range(1, len(self.offsets)):
            off = self.offsets[d]
            y = y + self.data[d] * lax.slice_in_dim(
                xp, h + off, h + off + n_pad)
        return y

    def matmat(self, X):
        """Y = A @ X for a column stack (n_pad, K)."""
        Y = self.data[0][:, None] * jnp.roll(X, -self.offsets[0], axis=0)
        for d in range(1, len(self.offsets)):
            Y = Y + self.data[d][:, None] * jnp.roll(X, -self.offsets[d], axis=0)
        return Y

    def matmat_k(self, Xk):
        """Y = A @ X for K-major lane stacks (K, n_pad) -> (K, n_pad)."""
        return jax.vmap(self.matvec)(Xk)

    def rmatmat_k(self, Xk):
        """A.T @ X for K-major lane stacks (K, n_pad) -> (K, n_pad)."""
        return jax.vmap(self.rmatvec)(Xk)

    def rmatvec(self, x):
        """Transpose apply A.T @ x, still gather-free.

        data[d, i] = A[i, i+off[d]] contributes A[i,j]*x[i] to y[j] with
        j = i + off[d], i.e. y = sum_d roll(data[d] * x, +off[d]); padded
        and out-of-range slots hold zero, so wrap-around terms vanish.
        Powers the device NE/NR (Kaczmarz/Cimmino-form) smoothers.
        """
        y = jnp.roll(self.data[0] * x, self.offsets[0])
        for d in range(1, len(self.offsets)):
            y = y + jnp.roll(self.data[d] * x, self.offsets[d])
        return y

    def rmatmat(self, X):
        """A.T @ X for a column stack (n_pad, K) — rmatvec broadcast over
        the trailing RHS axis."""
        Y = jnp.roll(self.data[0][:, None] * X, self.offsets[0], axis=0)
        for d in range(1, len(self.offsets)):
            Y = Y + jnp.roll(self.data[d][:, None] * X, self.offsets[d],
                             axis=0)
        return Y

    def __matmul__(self, x):
        if x.ndim == 1:
            return self.matvec(x)
        return self.matmat(x)

    def diagonal(self):
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return jnp.zeros(self.n_pad, dtype=self.dtype)


def dia_from_scipy(A, dtype=jnp.float32, row_pad=8, max_diags=None):
    """Convert a square scipy sparse matrix to DIAMatrix.

    Returns None if the matrix has more distinct diagonals than
    ``max_diags`` (caller falls back to another format).
    """
    A = sp.coo_matrix(A)
    n, m = A.shape
    if n != m:
        raise ValueError("DIA requires a square matrix")
    n_pad = pad_to(max(n, 1), row_pad)
    offs_all = A.col - A.row
    offsets = np.unique(offs_all)
    if max_diags is not None and len(offsets) > max_diags:
        return None
    d_index = np.searchsorted(offsets, offs_all)
    host_dt = (np.complex128 if jnp.issubdtype(jnp.dtype(dtype),
                                               jnp.complexfloating)
               else np.float64)
    data = np.zeros((len(offsets), n_pad), dtype=host_dt)
    data[d_index, A.row] = A.data if data.size else 0
    return DIAMatrix(
        data=jnp.asarray(data, dtype=dtype),
        offsets=tuple(int(o) for o in offsets),
        shape=(n, m),
        nnz=int(A.nnz),
    )


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class DenseOperator:
    """Dense device operator for small (coarse) levels."""

    data: jnp.ndarray            # (n_pad, m_pad)
    shape: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return (self.data,), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (data,) = children
        shape, nnz = aux
        return cls(data=data, shape=shape, nnz=nnz)

    @property
    def n_pad(self):
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    # NOTE precision=HIGHEST: a default-precision f32 dot may run in TF32
    # on the GPU (about three decimal digits); coarse-level applies sit
    # inside every V-cycle, and a ~1e-3-relative coarse correction error
    # degrades the preconditioner.  Coarse dense sizes are <= ~2k, so the
    # full-precision dot is cheap.
    def matvec(self, x):
        return jnp.dot(self.data, x, preferred_element_type=self.data.dtype,
                       precision=lax.Precision.HIGHEST)

    def rmatvec(self, x):
        return jnp.dot(x, self.data, preferred_element_type=self.data.dtype,
                       precision=lax.Precision.HIGHEST)

    def __matmul__(self, x):
        if x.ndim == 1:
            return self.matvec(x)
        return jnp.dot(self.data, x, preferred_element_type=self.data.dtype,
                       precision=lax.Precision.HIGHEST)

    def diagonal(self):
        return jnp.diagonal(self.data) if self.data.shape[0] == self.data.shape[1] \
            else jnp.zeros(self.n_pad, dtype=self.dtype)


def dense_from_scipy(A, dtype=jnp.float32, row_pad=8):
    """Convert scipy sparse to a padded DenseOperator."""
    A = sp.csr_matrix(A)
    n, m = A.shape
    n_pad = pad_to(max(n, 1), row_pad)
    m_pad = pad_to(max(m, 1), row_pad)
    host_dt = (np.complex128 if jnp.issubdtype(jnp.dtype(dtype),
                                               jnp.complexfloating)
               else np.float64)
    data = np.zeros((n_pad, m_pad), dtype=host_dt)
    data[:n, :m] = A.toarray()
    return DenseOperator(
        data=jnp.asarray(data, dtype=dtype), shape=(n, m), nnz=int(A.nnz))


def dia_from_stencil(S, grid, dtype=jnp.float32):
    """Build a grid-stencil DIA operator DIRECTLY ON DEVICE.

    Device analog of gallery.stencil_grid (SURVEY.md §2.3 gallery): for a
    dense stencil array S (shape (3,)*d or (5,)*d ... centered), each
    nonzero stencil entry becomes one diagonal whose data is the constant
    value masked by boundary validity — computed from per-dim iotas, so
    nothing is built on or uploaded from the host (the host CSR->DIA
    conversion and upload of a 2048^2 Poisson operator take seconds).
    """
    S = np.asarray(S)
    grid = tuple(int(g) for g in grid)
    dim = len(grid)
    if S.ndim != dim:
        raise ValueError("stencil dim must match grid dim")
    center = tuple(s // 2 for s in S.shape)
    n = int(np.prod(grid))

    entries = []
    for idx in np.ndindex(*S.shape):
        v = S[idx]
        if v == 0:
            continue
        coords = tuple(int(i) - c for i, c in zip(idx, center))
        off = 0
        stride_acc = 1
        for d in range(dim - 1, -1, -1):
            off += coords[d] * stride_acc
            stride_acc *= grid[d]
        entries.append((int(off), coords, float(np.real(v))
                        if not np.iscomplexobj(S) else complex(v)))
    entries.sort(key=lambda e: e[0])

    nnz = 0
    for _off, coords, _v in entries:
        count = 1
        for d in range(dim):
            count *= grid[d] - abs(coords[d])
        nnz += count
    key = tuple((c, v) for _o, c, v in entries)
    data = _stencil_data(key, grid, jnp.dtype(dtype).name)
    return DIAMatrix(
        data=data,
        offsets=tuple(e[0] for e in entries),
        shape=(n, n),
        nnz=int(nnz),
    )


@partial(jax.jit, static_argnames=("entries", "grid", "dtype"))
def _stencil_data(entries, grid, dtype):
    dim = len(grid)
    rows = []
    for coords, v in entries:
        mask = None
        for d in range(dim):
            i = jnp.arange(grid[d])
            ok = (i + coords[d] >= 0) & (i + coords[d] < grid[d])
            shape = [1] * dim
            shape[d] = grid[d]
            ok = ok.reshape(shape)
            mask = ok if mask is None else (mask & ok)
        rows.append(jnp.where(mask, jnp.asarray(v, dtype=dtype),
                              0).reshape(-1))
    return jnp.stack(rows)


def dia_spgemm(A: DIAMatrix, B: DIAMatrix):
    """Gather-free device SpGEMM for banded operators: C = A @ B.

    The banded-times-banded product is a sum over offset pairs,

        C_data[oa + ob] += A_data[oa] * roll(B_data[ob], -oa),

    so the whole SpGEMM is rolls + elementwise FMAs — the gather-free
    form of the reference's csr_matmat for banded operands (SURVEY.md
    §2.4 L0; BASELINE.json:5 "SpGEMM for RAP and P^T A P").  Wrap-around
    terms vanish because out-of-range entries store zero.  Output offsets
    are the (static) sums of the input offsets; general RAP with windowed
    transfer operators remains a host-side product by design (DESIGN.md).
    """
    if A.shape[1] != B.shape[0]:
        raise ValueError("dimension mismatch")
    if A.n_pad != B.n_pad:
        raise ValueError("operands must share padding")
    acc = {}
    for da, oa in enumerate(A.offsets):
        a = A.data[da]
        for db, ob in enumerate(B.offsets):
            oc = oa + ob
            term = a * jnp.roll(B.data[db], -oa)
            if oc in acc:
                acc[oc] = acc[oc] + term
            else:
                acc[oc] = term
    offsets = tuple(sorted(acc.keys()))
    data = jnp.stack([acc[o] for o in offsets])
    nnz_est = min(A.nnz * max(len(B.offsets), 1), len(offsets) * A.shape[0])
    return DIAMatrix(data=data, offsets=offsets,
                     shape=(A.shape[0], B.shape[1]), nnz=int(nnz_est))

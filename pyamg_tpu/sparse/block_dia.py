"""Block-DIA device format — the device BSR solve path.

Round-1 verdict item 5: elasticity (BSR blocksize 2) ran devicewise as a
scalar DIA/windowed operator with scalar smoothers.  The block format
mirrors the scalar DIA insight (no gathers): a BSR operator on a
lexicographic grid is *block-banded*, so store it by BLOCK diagonal and
apply with block rolls:

    y_blk = sum_d  data[d] @_batched roll(x_blk, -offsets[d], axis=0)

where data[d] is (nb_pad, bs, bs) and @_batched is unrolled into
elementwise mul-adds (bs is tiny: 2-4).  Wrap-around and
padding contribute exact zeros, exactly like the scalar DIAMatrix.

Reference counterpart: scipy bsr_matvec (SURVEY.md §2.4 L0) and the
bsr_* relaxation sweeps (relaxation.h) — here the block smoothers
(engine.relaxation block_jacobi / block multicolor GS) compose with this
operator unchanged, since they only need ``A @ x`` and the block
diagonal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

__all__ = ["BlockDIAMatrix", "block_dia_from_scipy"]


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class BlockDIAMatrix:
    """Block-diagonal-stored BSR matrix over padded block vectors.

    data[d, i] = A_block[i, i + offsets[d]] (bs x bs; zero block where
    absent / out of range).  Offsets are in BLOCK units.
    """

    data: jnp.ndarray            # (ndiags, nb_pad, bs, bs)
    offsets: Tuple[int, ...]     # static, block units
    shape: Tuple[int, int]       # logical SCALAR shape
    bs: int                      # static block size
    nnz: int

    def tree_flatten(self):
        return (self.data,), (self.offsets, self.shape, self.bs, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (data,) = children
        offsets, shape, bs, nnz = aux
        return cls(data=data, offsets=offsets, shape=shape, bs=bs,
                   nnz=nnz)

    @property
    def nb_pad(self):
        return self.data.shape[1]

    @property
    def n_pad(self):
        return self.data.shape[1] * self.bs

    @property
    def ndiags(self):
        return len(self.offsets)

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x):
        # per-block products UNROLLED over the static bs as elementwise
        # mul-adds.  Not einsum: a tiny batched f32 dot at default
        # precision may run in TF32 on the GPU, and the mixed-precision
        # outer Krylov needs the f64 matvec exact.
        bs = self.bs
        xb = x.reshape(self.nb_pad, bs)
        cols = [xb[:, j] for j in range(bs)]
        out = [jnp.zeros(self.nb_pad, dtype=x.dtype) for _ in range(bs)]
        for d, off in enumerate(self.offsets):
            xr = [jnp.roll(c, -off) for c in cols]
            for i in range(bs):
                acc = out[i]
                for j in range(bs):
                    acc = acc + self.data[d][:, i, j] * xr[j]
                out[i] = acc
        return jnp.stack(out, axis=1).reshape(-1)

    def matmat(self, X):
        """Y = A @ X for a column stack (n_pad, K): unrolled elementwise
        block products per diagonal (used to densify coarse block
        operators on device; exact in f64 like matvec)."""
        K = X.shape[1]
        bs = self.bs
        Xb = X.reshape(self.nb_pad, bs, K)
        out = [jnp.zeros((self.nb_pad, K), dtype=X.dtype)
               for _ in range(bs)]
        for d, off in enumerate(self.offsets):
            Xr = jnp.roll(Xb, -off, axis=0)
            for i in range(bs):
                acc = out[i]
                for j in range(bs):
                    acc = acc + self.data[d][:, i, j, None] * Xr[:, j, :]
                out[i] = acc
        return jnp.stack(out, axis=1).reshape(-1, K)

    def __matmul__(self, x):
        if x.ndim != 1:
            return self.matmat(x)
        return self.matvec(x)

    def rmatvec(self, x):
        """A.T @ x by block rolls (transpose blocks, negate offsets);
        unrolled elementwise like matvec."""
        bs = self.bs
        xb = x.reshape(self.nb_pad, bs)
        cols = [xb[:, j] for j in range(bs)]
        out = [jnp.zeros(self.nb_pad, dtype=x.dtype) for _ in range(bs)]
        for d, off in enumerate(self.offsets):
            # contribution of block (i, i+off): data[d,i]^T x_blk[i] to
            # row i+off  ->  y_i = roll(sum_j data[:, j, i] * x_j, +off)
            for i in range(bs):
                acc = None
                for j in range(bs):
                    t = self.data[d][:, j, i] * cols[j]
                    acc = t if acc is None else acc + t
                out[i] = out[i] + jnp.roll(acc, off)
        return jnp.stack(out, axis=1).reshape(-1)

    def diagonal(self):
        """Scalar diagonal as a padded vector."""
        if 0 in self.offsets:
            d0 = self.offsets.index(0)
            return jnp.diagonal(self.data[d0], axis1=1,
                                axis2=2).reshape(-1)
        return jnp.zeros(self.n_pad, dtype=self.dtype)

    def block_diagonal(self):
        """(nb_pad, bs, bs) diagonal blocks (for block smoothers)."""
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return jnp.zeros((self.nb_pad, self.bs, self.bs),
                         dtype=self.dtype)


def block_dia_from_scipy(A, dtype=jnp.float32, n_pad=None, max_diags=600):
    """Convert a square scipy BSR matrix to BlockDIAMatrix.

    ``n_pad`` is the target SCALAR padding (must be a multiple of the
    block size); returns None when the matrix has more distinct block
    diagonals than ``max_diags`` (caller falls back to scalar formats).
    """
    A = A.tobsr() if not (sp.issparse(A) and A.format == "bsr") else A
    bs, bs2 = A.blocksize
    if bs != bs2:
        raise ValueError("square blocks required")
    n, m = A.shape
    if n != m:
        raise ValueError("block DIA requires a square matrix")
    nb = n // bs
    if n_pad is None:
        n_pad = n
    if n_pad % bs != 0:
        raise ValueError("n_pad must be a multiple of the block size")
    nb_pad = n_pad // bs

    Ab = A.copy()
    Ab.sort_indices()
    rows_b = np.repeat(np.arange(nb), np.diff(Ab.indptr))
    cols_b = Ab.indices
    offs_all = cols_b - rows_b
    offsets = np.unique(offs_all)
    if max_diags is not None and len(offsets) > max_diags:
        return None
    d_index = np.searchsorted(offsets, offs_all)
    data = np.zeros((len(offsets), nb_pad, bs, bs), dtype=np.float64)
    data[d_index, rows_b] = Ab.data
    return BlockDIAMatrix(
        data=jnp.asarray(data, dtype=dtype),
        offsets=tuple(int(o) for o in offsets),
        shape=(n, m),
        bs=int(bs),
        nnz=int(Ab.nnz),
    )

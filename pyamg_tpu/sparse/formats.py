"""Device-resident sparse formats (static-shape pytrees).

The device replacement for the reference's CSR/BSR containers
(SURVEY.md §2.4 "Implicit native dependency": scipy csr_matvec/csr_matmat
-> these).  Design (SURVEY.md §7 design stance):

- **ELL (padded-row) layout**: ``data``/``indices`` of static shape
  (n_pad, k) where k = max row nnz.  AMG operators from stencil-type
  problems have tightly bounded row degree, so ELL padding overhead is
  small (5-pt: k=5) and every tensor has a static shape XLA can tile.
- Padding rows carry index 0 / value 0, so SpMV contributions vanish and
  padded vector entries stay identically zero through every kernel — no
  masks needed in dots/norms.
- Block variant stores (nb_pad, k, br, bc) blocks for block gathers.

Host <-> device conversion is vectorized scipy -> numpy -> jnp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

__all__ = ["ELLMatrix", "BlockELLMatrix", "ell_from_scipy",
           "bsr_ell_from_scipy", "ell_to_scipy", "pad_to", "pad_vector"]


def pad_to(n, multiple):
    return int(-(-n // multiple) * multiple)


def pad_vector(x, n_pad):
    """Zero-pad a device/host vector (or column stack) to n_pad rows."""
    x = jnp.asarray(x)
    if x.shape[0] == n_pad:
        return x
    pad_width = [(0, n_pad - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class ELLMatrix:
    """Padded-row sparse matrix: y_i = sum_s data[i, s] * x[indices[i, s]].

    shape is the *logical* (unpadded) shape; data/indices have
    n_pad >= shape[0] rows.  Column indices address the padded column
    vector (entries < shape[1]); padding slots hold (0, 0.0).
    """

    data: jnp.ndarray        # (n_pad, k)
    indices: jnp.ndarray     # (n_pad, k) int32
    shape: Tuple[int, int]   # static logical shape
    nnz: int                 # static

    def tree_flatten(self):
        return (self.data, self.indices), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, indices = children
        shape, nnz = aux
        return cls(data=data, indices=indices, shape=shape, nnz=nnz)

    @property
    def n_pad(self):
        return self.data.shape[0]

    @property
    def k(self):
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x):
        """y = A @ x for x of padded length >= max col index + 1."""
        gathered = jnp.take(x, self.indices, axis=0)       # (n_pad, k)
        return jnp.sum(self.data * gathered, axis=1)

    def matmat(self, X):
        """Y = A @ X for X (ncol_pad, m)."""
        gathered = jnp.take(X, self.indices, axis=0)       # (n_pad, k, m)
        return jnp.einsum("nk,nkm->nm", self.data, gathered)

    def rmatvec(self, x, m_pad=None):
        """A.T @ x via scatter-add (CPU-grade fallback, like matvec)."""
        if m_pad is None:
            m_pad = pad_to(self.shape[1], 8)
        y = jnp.zeros(m_pad, dtype=self.dtype)
        return y.at[self.indices].add(self.data * x[:, None])

    def __matmul__(self, x):
        if x.ndim == 1:
            return self.matvec(x)
        return self.matmat(x)

    def diagonal(self):
        """Diagonal entries as a padded vector (square logical shape)."""
        n_pad = self.n_pad
        rows = jnp.arange(n_pad)[:, None]
        is_diag = (self.indices == rows) & (self.data != 0)
        # padding rows: index 0 == row only for row 0; data 0 excludes them
        return jnp.sum(jnp.where(is_diag, self.data, 0), axis=1)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class BlockELLMatrix:
    """Blocked ELL: data (nb_pad, k, br, bc), indices (nb_pad, k) of block
    columns.  Logical shape in scalar units."""

    data: jnp.ndarray
    indices: jnp.ndarray
    shape: Tuple[int, int]
    blocksize: Tuple[int, int]
    nnz: int

    def tree_flatten(self):
        return (self.data, self.indices), (self.shape, self.blocksize, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, indices = children
        shape, blocksize, nnz = aux
        return cls(data=data, indices=indices, shape=shape,
                   blocksize=blocksize, nnz=nnz)

    @property
    def nb_pad(self):
        return self.data.shape[0]

    @property
    def k(self):
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x):
        """x padded to nb_cols_pad * bc scalars."""
        br, bc = self.blocksize
        xb = x.reshape(-1, bc)
        gathered = jnp.take(xb, self.indices, axis=0)      # (nb_pad, k, bc)
        yb = jnp.einsum("nkab,nkb->na", self.data, gathered)
        return yb.reshape(-1)

    def __matmul__(self, x):
        return self.matvec(x)


def ell_from_scipy(A, dtype=jnp.float32, index_dtype=jnp.int32,
                   row_pad=8, k_pad=1):
    """Convert a scipy sparse matrix to a device ELLMatrix."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    n, m = A.shape
    lens = np.diff(A.indptr)
    k = max(int(lens.max()) if n else 0, 1)
    k = pad_to(k, k_pad)
    n_pad = pad_to(max(n, 1), row_pad)
    data = np.zeros((n_pad, k), dtype=np.float64)
    indices = np.zeros((n_pad, k), dtype=np.int64)
    if A.nnz:
        rows = np.repeat(np.arange(n), lens)
        slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], lens)
        data[rows, slots] = A.data
        indices[rows, slots] = A.indices
    return ELLMatrix(
        data=jnp.asarray(data, dtype=dtype),
        indices=jnp.asarray(indices, dtype=index_dtype),
        shape=(n, m),
        nnz=int(A.nnz),
    )


def bsr_ell_from_scipy(A, blocksize=None, dtype=jnp.float32,
                       index_dtype=jnp.int32, row_pad=8):
    """Convert scipy (any format) to a BlockELLMatrix with given blocksize."""
    if blocksize is None:
        if sp.issparse(A) and A.format == "bsr":
            blocksize = A.blocksize
        else:
            blocksize = (1, 1)
    br, bc = blocksize
    Ab = sp.csr_matrix(A).tobsr(blocksize=(br, bc))
    Ab.sort_indices()
    nb = Ab.shape[0] // br
    lens = np.diff(Ab.indptr)
    k = max(int(lens.max()) if nb else 0, 1)
    nb_pad = pad_to(max(nb, 1), row_pad)
    data = np.zeros((nb_pad, k, br, bc), dtype=np.float64)
    indices = np.zeros((nb_pad, k), dtype=np.int64)
    nnzb = Ab.indices.shape[0]
    if nnzb:
        rows = np.repeat(np.arange(nb), lens)
        slots = np.arange(nnzb) - np.repeat(Ab.indptr[:-1], lens)
        data[rows, slots] = Ab.data
        indices[rows, slots] = Ab.indices
    return BlockELLMatrix(
        data=jnp.asarray(data, dtype=dtype),
        indices=jnp.asarray(indices, dtype=index_dtype),
        shape=Ab.shape,
        blocksize=(br, bc),
        nnz=int(nnzb * br * bc),
    )


def ell_to_scipy(E):
    """Convert an ELLMatrix back to scipy CSR (drops padding)."""
    data = np.asarray(E.data)
    indices = np.asarray(E.indices)
    n, m = E.shape
    mask = data != 0
    rows = np.repeat(np.arange(E.n_pad), E.k).reshape(E.n_pad, E.k)[mask]
    cols = indices[mask]
    vals = data[mask]
    keep = rows < n
    return sp.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=(n, m))

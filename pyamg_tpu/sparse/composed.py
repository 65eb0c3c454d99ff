"""Composed device operator: a product of device operators applied
factor-by-factor.

The device form of FACTORED transfer operators.  A smoothed-aggregation
prolongator P = (I - w D^-1 A)^degree @ T is, materialized, a k~6
windowed operator with k gathers per row; as factors it is `degree`
DIA applies (bandwidth-bound) plus one k=1 windowed spread of the
tentative T.  The host smoothers record the factorization on P
(aggregation/smooth.py), engine/hierarchy.py compiles it to this class.

Reference counterpart: none — upstream pyamg applies the materialized
CSR P / P.T (SURVEY.md §2.1 MultilevelSolver.__solve); the factored
apply is numerically identical (same floating-point product structure
up to op reassociation) and exists for speed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = ["ComposedOperator"]


def _fit(v, n):
    """Slice/zero-pad to length n (factors may use different row pads;
    tail rows are structural-zero padding)."""
    if v.shape[0] == n:
        return v
    if v.shape[0] > n:
        return v[:n]
    return jnp.pad(v, (0, n - v.shape[0]))


def _expected_in(op):
    """matvec input length an operator requires, or None (self-pads)."""
    name = type(op).__name__
    if name == "DIAMatrix":
        return op.n_pad
    if name == "DenseOperator":
        return op.data.shape[1]
    return None  # WindowedELL / TransposedWindowed pad internally


def _expected_in_t(op):
    """rmatvec input length (the operator's padded ROW dimension)."""
    name = type(op).__name__
    if name == "DIAMatrix":
        return op.n_pad
    if name == "DenseOperator":
        return op.data.shape[0]
    if name == "WindowedELL":
        return op.n_pad
    if name == "TransposedWindowed":
        return op.base.m_chunks * op.base.w2
    return None


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class ComposedOperator:
    """Product ops[0] @ ops[1] @ ... @ ops[-1], applied right-to-left."""

    ops: Tuple
    shape: Tuple[int, int]
    nnz: int                     # nnz of the materialized product

    def tree_flatten(self):
        return (self.ops,), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, nnz = aux
        return cls(ops=children[0], shape=shape, nnz=nnz)

    @property
    def dtype(self):
        return self.ops[0].dtype

    @property
    def n_pad(self):
        return getattr(self.ops[0], "n_pad", self.shape[0])

    def matvec(self, x):
        for op in reversed(self.ops):
            need = _expected_in(op)
            if need is not None:
                x = _fit(x, need)
            x = op.matvec(x)
        return x

    def rmatvec(self, x):
        for op in self.ops:
            need = _expected_in_t(op)
            x = op.rmatvec(_fit(x, need) if need is not None else x)
        return x

    def matmat(self, X):
        cols = [self.matvec(X[:, j]) for j in range(X.shape[1])]
        return jnp.stack(cols, axis=1)

    def __matmul__(self, x):
        if x.ndim != 1:
            return self.matmat(x)
        return self.matvec(x)

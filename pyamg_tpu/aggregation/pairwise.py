"""Pairwise (unsmoothed) aggregation solver.

Rebuild of [R] pyamg/aggregation/pairwise.py (SURVEY.md §2.2):
Notay-style repeated pairwise matching with unsmoothed tentative
prolongators — cheap setup, modest convergence, usually Krylov-wrapped.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from ..multilevel import MultilevelSolver
from ..relaxation.smoothing import change_smoothers
from ..util.utils import conj_transpose_csr, asfptype, upcast
from .aggregate import pairwise_aggregation
from .tentative import fit_candidates

__all__ = ["pairwise_solver"]


def pairwise_solver(
    A,
    B=None,
    matchings=2,
    theta=0.25,
    norm="min",
    presmoother=("block_gauss_seidel", {"sweep": "symmetric"}),
    postsmoother=("block_gauss_seidel", {"sweep": "symmetric"}),
    max_levels=20,
    max_coarse=10,
    keep=False,
    **kwargs,
):
    """Create a pairwise-aggregation AMG solver.

    Rebuild of [R] pyamg/aggregation/pairwise.py::pairwise_solver.
    """
    if not sp.issparse(A) or A.format not in ("csr", "bsr"):
        A = sp.csr_matrix(A)
        warnings.warn("implicit conversion of A to CSR",
                      sp.SparseEfficiencyWarning)
    A = asfptype(sp.csr_matrix(A))
    n = A.shape[0]
    if B is None:
        B = np.ones((n, 1), dtype=A.dtype)
    else:
        B = np.asarray(B, dtype=upcast(A.dtype, np.asarray(B).dtype))
        if B.ndim == 1:
            B = B.reshape(-1, 1)

    levels = [MultilevelSolver.Level()]
    levels[-1].A = A
    levels[-1].B = B.copy()

    while len(levels) < max_levels and levels[-1].A.shape[0] > max_coarse:
        Acur = sp.csr_matrix(levels[-1].A)
        Bcur = levels[-1].B
        AggOp, Cpts = pairwise_aggregation(Acur, matchings=matchings,
                                           theta=theta, norm=norm)
        if AggOp.shape[1] >= Acur.shape[0]:
            break
        T, B_coarse = fit_candidates(AggOp, Bcur)
        P = sp.csr_matrix(T)
        R = conj_transpose_csr(P)
        levels[-1].P = P
        levels[-1].R = R
        if keep:
            levels[-1].AggOp = AggOp
        lvl = MultilevelSolver.Level()
        lvl.A = sp.csr_matrix(R @ (Acur @ P))
        lvl.B = B_coarse
        levels.append(lvl)

    ml = MultilevelSolver(levels, **kwargs)
    change_smoothers(ml, presmoother, postsmoother)
    return ml

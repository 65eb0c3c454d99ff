"""AIR — approximate ideal restriction AMG (nonsymmetric problems).

Rebuild of [R] pyamg/classical/air.py (SURVEY.md §2.2 / call
stack §3.4) — the fork owner's signature algorithm: R built by lAIR
(local dense solves so (RA)|_F ~ 0), P = one-point interpolation,
F-then-C Jacobi smoothing.  Canonical use: upwind advection
(gallery.advection_2d), BASELINE.json:11-style nonsymmetric operators.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from ..multilevel import MultilevelSolver
from ..relaxation.smoothing import change_smoothers
from ..util.utils import asfptype, levelize_strength_or_aggregation
from ..util.utils import galerkin_product
from . import split as split_module
from .classical import _INTERP_METHODS, _SPLIT_METHODS, _resolve_strength
from .interpolate import local_air

__all__ = ["air_solver"]


def air_solver(
    A,
    strength=("classical", {"theta": 0.3, "norm": "min"}),
    CF=("RS", {"second_pass": True}),
    interpolation="one_point",
    restrict=("air", {"theta": 0.05, "degree": 2}),
    presmoother=None,
    postsmoother=("fc_jacobi", {"omega": 1.0, "iterations": 1,
                                "f_iterations": 2, "c_iterations": 1}),
    max_levels=20,
    max_coarse=20,
    keep=False,
    **kwargs,
):
    """Create an AIR (nonsymmetric) AMG solver.

    Rebuild of [R] pyamg/classical/air.py::air_solver with the reference
    defaults (SURVEY.md §2.2).  R != P^T: genuinely nonsymmetric Galerkin.
    """
    if not sp.issparse(A) or A.format != "csr":
        A = sp.csr_matrix(A)
        warnings.warn("implicit conversion of A to CSR",
                      sp.SparseEfficiencyWarning)
    A = asfptype(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")

    max_levels, max_coarse, strength = levelize_strength_or_aggregation(
        strength, max_levels, max_coarse)

    levels = [MultilevelSolver.Level()]
    levels[-1].A = A

    while len(levels) < max_levels and levels[-1].A.shape[0] > max_coarse:
        n_before = levels[-1].A.shape[0]
        _extend_hierarchy(levels, strength, CF, interpolation, restrict, keep)
        if levels[-1].A.shape[0] >= n_before:
            levels.pop()
            break

    ml = MultilevelSolver(levels, **kwargs)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _extend_hierarchy(levels, strength, CF, interpolation, restrict, keep):
    A = levels[-1].A
    lvl_i = len(levels) - 1

    S = _resolve_strength(A, strength[min(lvl_i, len(strength) - 1)])

    cf_name, cf_kwargs = CF if isinstance(CF, tuple) else (CF, {})
    splitting = _SPLIT_METHODS[cf_name](S, **dict(cf_kwargs))
    if (splitting == split_module.C_NODE).all() or \
       (splitting == split_module.F_NODE).all():
        splitting = np.zeros(A.shape[0], dtype=np.int32)
        splitting[::2] = split_module.C_NODE

    interp_name = interpolation if isinstance(interpolation, str) else \
        interpolation[0]
    interp_kwargs = {} if isinstance(interpolation, str) else dict(
        interpolation[1])
    P = _INTERP_METHODS[interp_name](A, S, splitting, **interp_kwargs)

    r_name, r_kwargs = restrict if isinstance(restrict, tuple) else (
        restrict, {})
    if r_name == "air":
        R = local_air(A, splitting, **dict(r_kwargs))
    elif r_name == "transpose":
        R = P.T.tocsr()
    else:
        raise ValueError(f"unknown restriction {r_name!r}")

    levels[-1].P = P
    levels[-1].R = R
    levels[-1].splitting = splitting
    if keep:
        levels[-1].C = S

    A_coarse = galerkin_product(R, A, P)

    lvl = MultilevelSolver.Level()
    lvl.A = A_coarse
    levels.append(lvl)

"""Classical Ruge-Stuben AMG solver factory.

Rebuild of [R] pyamg/classical/classical.py (SURVEY.md §2.2 /
call stack §3.3): strength -> C/F splitting -> interpolation ->
R = P^T -> Galerkin RAP, per level.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from .. import strength as strength_module
from ..multilevel import MultilevelSolver
from ..relaxation.smoothing import change_smoothers
from ..util.utils import asfptype, levelize_strength_or_aggregation
from ..util.utils import galerkin_product
from . import split as split_module
from .interpolate import (
    classical_interpolation,
    direct_interpolation,
    distance_two_interpolation,
    injection_interpolation,
    one_point_interpolation,
)

__all__ = ["ruge_stuben_solver"]


_SPLIT_METHODS = {
    "RS": split_module.RS,
    "PMIS": split_module.PMIS,
    "PMISc": split_module.PMISc,
    "CLJP": split_module.CLJP,
    "CLJPc": split_module.CLJPc,
}

_INTERP_METHODS = {
    "classical": classical_interpolation,
    "direct": direct_interpolation,
    "distance_two": distance_two_interpolation,
    "standard": classical_interpolation,
    "injection": injection_interpolation,
    "one_point": one_point_interpolation,
}


def _resolve_strength(A, spec):
    from ..aggregation.aggregation import _strength_measure

    return _strength_measure(A, spec)


def ruge_stuben_solver(
    A,
    strength=("classical", {"theta": 0.25}),
    CF=("RS", {"second_pass": False}),
    interpolation="classical",
    presmoother=("gauss_seidel", {"sweep": "symmetric"}),
    postsmoother=("gauss_seidel", {"sweep": "symmetric"}),
    max_levels=30,
    max_coarse=20,
    keep=False,
    **kwargs,
):
    """Create a classical Ruge-Stuben AMG solver.

    Rebuild of [R] pyamg/classical/classical.py::ruge_stuben_solver with
    the reference defaults (SURVEY.md §2.2).  Returns a MultilevelSolver.
    """
    if not sp.issparse(A) or A.format not in ("csr", "bsr"):
        try:
            A = sp.csr_matrix(A)
            warnings.warn("implicit conversion of A to CSR",
                          sp.SparseEfficiencyWarning)
        except Exception as exc:
            raise TypeError("argument A must be convertible to "
                            "csr_matrix") from exc
    if A.format == "bsr":
        A = A.tocsr()
        warnings.warn("converting BSR to CSR for classical AMG")
    A = asfptype(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")

    max_levels, max_coarse, strength = levelize_strength_or_aggregation(
        strength, max_levels, max_coarse)

    levels = [MultilevelSolver.Level()]
    levels[-1].A = A

    while len(levels) < max_levels and levels[-1].A.shape[0] > max_coarse:
        n_before = levels[-1].A.shape[0]
        _extend_hierarchy(levels, strength, CF, interpolation, keep)
        if levels[-1].A.shape[0] >= n_before:
            levels.pop()
            break

    ml = MultilevelSolver(levels, **kwargs)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _extend_hierarchy(levels, strength, CF, interpolation, keep):
    """One level of the §3.3 pipeline."""
    A = levels[-1].A
    lvl_i = len(levels) - 1

    S = _resolve_strength(A, strength[min(lvl_i, len(strength) - 1)])

    cf_name, cf_kwargs = CF if isinstance(CF, tuple) else (CF, {})
    if cf_name not in _SPLIT_METHODS:
        raise ValueError(f"unknown C/F splitting method {cf_name!r}")
    splitting = _SPLIT_METHODS[cf_name](S, **dict(cf_kwargs))

    if (splitting == split_module.C_NODE).all() or \
       (splitting == split_module.F_NODE).all():
        # degenerate splitting: make every other point C
        splitting = np.zeros(A.shape[0], dtype=np.int32)
        splitting[::2] = split_module.C_NODE

    interp_name = interpolation if isinstance(interpolation, str) else \
        interpolation[0]
    interp_kwargs = {} if isinstance(interpolation, str) else dict(
        interpolation[1])
    if interp_name not in _INTERP_METHODS:
        raise ValueError(f"unknown interpolation method {interp_name!r}")
    P = _INTERP_METHODS[interp_name](A, S, splitting, **interp_kwargs)
    R = P.T.tocsr() if not np.iscomplexobj(A.data) else P.conjugate().T.tocsr()
    levels[-1].R_is_PT = not np.iscomplexobj(A.data)

    levels[-1].P = P
    levels[-1].R = R
    levels[-1].splitting = splitting
    if keep:
        levels[-1].C = S

    A_coarse = galerkin_product(R, A, P)

    lvl = MultilevelSolver.Level()
    lvl.A = A_coarse
    levels.append(lvl)

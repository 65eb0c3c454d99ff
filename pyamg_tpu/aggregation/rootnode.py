"""Rootnode smoothed-aggregation solver.

Rebuild of [R] pyamg/aggregation/rootnode.py (SURVEY.md §2.2):
SA variant that pins an identity block at each aggregate's root node, so
coarse dofs ARE fine dofs at the roots (point-value coarse variables),
combined with energy-minimization prolongation smoothing.  Better for
elasticity / anisotropy (BASELINE.json:10's config).

Divergence note: like the reference, the number of near-nullspace
candidates used must be <= the block size (the root block must carry an
identity); extra candidates are truncated with a warning.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from ..multilevel import MultilevelSolver
from ..relaxation.smoothing import change_smoothers
from ..util.utils import (conj_transpose_csr, galerkin_product, asfptype,
    blocksize,
    get_Cpt_params,
    levelize_smooth_or_improve_candidates,
    levelize_strength_or_aggregation,
    scale_T,
    upcast,
)
from .aggregation import _do_aggregate, _improve_candidates, _strength_measure
from .smooth import energy_prolongation_smoother, jacobi_prolongation_smoother
from .tentative import fit_candidates

__all__ = ["rootnode_solver"]


def rootnode_solver(
    A,
    B=None,
    BH=None,
    symmetry="hermitian",
    strength="evolution",
    aggregate="standard",
    smooth=("energy", {"krylov": "cg", "maxiter": 3, "degree": 1,
                       "weighting": "local"}),
    presmoother=("block_gauss_seidel", {"sweep": "symmetric"}),
    postsmoother=("block_gauss_seidel", {"sweep": "symmetric"}),
    improve_candidates=(("block_gauss_seidel",
                         {"sweep": "symmetric", "iterations": 4}), None),
    max_levels=10,
    max_coarse=10,
    keep=False,
    **kwargs,
):
    """Create a rootnode smoothed-aggregation AMG solver.

    Rebuild of [R] pyamg/aggregation/rootnode.py::rootnode_solver with the
    reference defaults (SURVEY.md §2.2).
    """
    if not sp.issparse(A) or A.format not in ("csr", "bsr"):
        try:
            A = sp.csr_matrix(A)
            warnings.warn("implicit conversion of A to CSR",
                          sp.SparseEfficiencyWarning)
        except Exception as exc:
            raise TypeError("argument A must be convertible to "
                            "csr_matrix") from exc
    A = asfptype(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    if symmetry not in ("symmetric", "hermitian", "nonsymmetric"):
        raise ValueError("expected symmetric, hermitian or nonsymmetric")
    A.symmetry = symmetry

    n = A.shape[0]
    bs = blocksize(A)
    if B is None:
        B = np.ones((n, 1), dtype=A.dtype)
    else:
        B = np.asarray(B, dtype=upcast(A.dtype, np.asarray(B).dtype))
        if B.ndim == 1:
            B = B.reshape(-1, 1)
    if B.shape[1] > bs:
        warnings.warn(
            f"rootnode uses at most blocksize={bs} candidates; truncating "
            f"B from {B.shape[1]}")
        B = B[:, :bs]
    B = B.copy()

    if symmetry == "nonsymmetric":
        BH = B.copy() if BH is None else np.asarray(BH, dtype=B.dtype).copy()
        if BH.ndim == 1:
            BH = BH.reshape(-1, 1)
        BH = BH[:, : B.shape[1]]

    max_levels, max_coarse, strength = levelize_strength_or_aggregation(
        strength, max_levels, max_coarse)
    max_levels, max_coarse, aggregate = levelize_strength_or_aggregation(
        aggregate, max_levels, max_coarse)
    improve_candidates = levelize_smooth_or_improve_candidates(
        improve_candidates, max_levels)
    smooth = levelize_smooth_or_improve_candidates(smooth, max_levels)

    levels = [MultilevelSolver.Level()]
    levels[-1].A = A
    levels[-1].B = B
    if symmetry == "nonsymmetric":
        levels[-1].BH = BH

    while (len(levels) < max_levels
           and levels[-1].A.shape[0] // max(blocksize(levels[-1].A), 1)
           > max_coarse):
        n_before = levels[-1].A.shape[0]
        _extend_hierarchy(levels, strength, aggregate, smooth,
                          improve_candidates, keep)
        if levels[-1].A.shape[0] >= n_before:
            levels.pop()
            break

    ml = MultilevelSolver(levels, **kwargs)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _extend_hierarchy(levels, strength, aggregate, smooth,
                      improve_candidates, keep):
    A = levels[-1].A
    B = levels[-1].B
    lvl_i = len(levels) - 1
    symmetry = getattr(A, "symmetry", "hermitian")

    C = _strength_measure(A, strength[min(lvl_i, len(strength) - 1)])
    AggOp, Cnodes = _do_aggregate(
        C, aggregate[min(lvl_i, len(aggregate) - 1)], A=A)

    B = _improve_candidates(
        A, B, improve_candidates[min(lvl_i, len(improve_candidates) - 1)])
    levels[-1].B = B

    T, _ = fit_candidates(AggOp, B)
    Cpt_params = get_Cpt_params(A, Cnodes, AggOp, T)
    T = scale_T(T, Cpt_params["P_I"], Cpt_params["I_F"])
    # coarse candidates are fine candidate values at the root dofs
    B_coarse = B[Cpt_params["Cpts"], :]

    if symmetry == "nonsymmetric":
        BH = levels[-1].BH
        BH = _improve_candidates(
            conj_transpose_csr(sp.csr_matrix(A)), BH,
            improve_candidates[min(lvl_i, len(improve_candidates) - 1)])
        levels[-1].BH = BH
        TH, _ = fit_candidates(AggOp, BH)
        TH = scale_T(TH, Cpt_params["P_I"], Cpt_params["I_F"])
        BH_coarse = BH[Cpt_params["Cpts"], :]

    smooth_spec = smooth[min(lvl_i, len(smooth) - 1)]
    name, skw = (smooth_spec if isinstance(smooth_spec, tuple)
                 else (smooth_spec, {}))
    skw = dict(skw or {})
    if name == "energy":
        P = energy_prolongation_smoother(
            A, T, C, B_coarse, B, Cpt_params=(True, Cpt_params), **skw)
    elif name == "jacobi":
        P = jacobi_prolongation_smoother(A, T, C, B, **skw)
    elif name is None:
        P = sp.csr_matrix(T)
    else:
        raise ValueError(f"unrecognized rootnode smoother {name!r}")

    if symmetry == "hermitian":
        R = conj_transpose_csr(P)
        levels[-1].R_is_PT = not np.iscomplexobj(P.data)
    elif symmetry == "symmetric":
        R = P.T.tocsr()
        levels[-1].R_is_PT = True
    else:
        AH = conj_transpose_csr(sp.csr_matrix(A))
        AH.symmetry = "nonsymmetric"
        CH = conj_transpose_csr(C)
        if name == "energy":
            RH = energy_prolongation_smoother(
                AH, TH, CH, BH_coarse, BH, Cpt_params=(True, Cpt_params),
                **skw)
        else:
            RH = jacobi_prolongation_smoother(AH, TH, CH, BH, **skw)
        R = conj_transpose_csr(RH)

    if keep:
        levels[-1].C = C
        levels[-1].AggOp = AggOp
        levels[-1].T = T
    levels[-1].Cnodes = np.asarray(Cnodes)
    levels[-1].Fpts = Cpt_params["Fpts"]
    levels[-1].Cpts = Cpt_params["Cpts"]

    levels[-1].P = P
    levels[-1].R = R

    A_coarse = galerkin_product(R, A, P)
    A_coarse.symmetry = symmetry
    k = B_coarse.shape[1]
    if k > 1 and A_coarse.shape[0] % k == 0:
        A_coarse = A_coarse.tobsr(blocksize=(k, k))
        A_coarse.symmetry = symmetry

    lvl = MultilevelSolver.Level()
    lvl.A = A_coarse
    lvl.B = B_coarse
    if symmetry == "nonsymmetric":
        lvl.BH = BH_coarse
    levels.append(lvl)

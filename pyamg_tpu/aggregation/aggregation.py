"""Smoothed-aggregation solver factory (setup phase, host side).

Rebuild of [R] pyamg/aggregation/aggregation.py (SURVEY.md
§2.2 / call stack §3.1).  Builds a MultilevelSolver whose per-level
operators are scipy matrices; the heavy kernels (strength, aggregation,
batched QR, SpGEMM Galerkin triple product) run as vectorized host passes
during setup.  The resulting hierarchy can be compiled to a device
(device-resident, jitted) solver via pyamg_tpu.engine.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from .. import strength as strength_module
from ..multilevel import MultilevelSolver
from ..relaxation import relaxation as relaxation_module
from ..relaxation.smoothing import change_smoothers
from ..util.utils import (conj_transpose_csr, galerkin_product, asfptype,
    blocksize,
    eliminate_diag_dom_nodes,
    levelize_smooth_or_improve_candidates,
    levelize_strength_or_aggregation,
    upcast,
)
from . import aggregate as aggregate_module
from .smooth import (
    energy_prolongation_smoother,
    jacobi_prolongation_smoother,
    richardson_prolongation_smoother,
)
from .tentative import fit_candidates

__all__ = ["smoothed_aggregation_solver"]


def _strength_measure(A, spec):
    """Resolve a strength spec ('name' | ('name', kwargs) | None) to C."""
    name, kwargs = (spec if isinstance(spec, tuple) else (spec, {}))
    if isinstance(kwargs, dict):
        kwargs = dict(kwargs)
    if name is None:
        # all connections strong: pattern of A (amalgamated if block)
        C = sp.csr_matrix(A) if blocksize(A) == 1 else strength_module._block_amalgamate(A.tobsr())
        C = sp.csr_matrix((np.ones(C.nnz), C.indices, C.indptr), shape=C.shape)
        return C
    if name == "predefined":
        return sp.csr_matrix(kwargs["C"])
    table = {
        "symmetric": strength_module.symmetric_strength_of_connection,
        "classical": strength_module.classical_strength_of_connection,
        "evolution": strength_module.evolution_strength_of_connection,
        "ode": strength_module.evolution_strength_of_connection,
        "energy_based": strength_module.energy_based_strength_of_connection,
        "distance": strength_module.distance_strength_of_connection,
        "algebraic_distance": strength_module.algebraic_distance,
        "affinity": strength_module.affinity_distance,
    }
    if name not in table:
        raise ValueError(f"unrecognized strength of connection: {name}")
    return table[name](A, **kwargs)


def _do_aggregate(C, spec, A=None):
    """Resolve an aggregate spec to (AggOp, Cpts)."""
    name, kwargs = (spec if isinstance(spec, tuple) else (spec, {}))
    if isinstance(kwargs, dict):
        kwargs = dict(kwargs)
    if name == "standard":
        return aggregate_module.standard_aggregation(C, **kwargs)
    if name == "naive":
        return aggregate_module.naive_aggregation(C, **kwargs)
    if name == "lloyd":
        return aggregate_module.lloyd_aggregation(C, **kwargs)
    if name in ("balanced lloyd", "balanced_lloyd"):
        return aggregate_module.balanced_lloyd_aggregation(C, **kwargs)
    if name == "pairwise":
        return aggregate_module.pairwise_aggregation(A if A is not None else C, **kwargs)
    if name == "predefined":
        AggOp = sp.csr_matrix(kwargs["AggOp"])
        Cpts = kwargs.get("Cpts", None)
        if Cpts is None:
            AggT = AggOp.tocsc()
            Cpts = np.array(
                [AggT.indices[AggT.indptr[j]] for j in range(AggOp.shape[1])
                 if AggT.indptr[j] < AggT.indptr[j + 1]],
                dtype=np.int64,
            )
        return AggOp, Cpts
    raise ValueError(f"unrecognized aggregation method: {name}")


def _improve_candidates(A, B, spec):
    """Relax on A z = 0 starting from the candidate columns (in place)."""
    if spec is None:
        return B
    name, kwargs = (spec if isinstance(spec, tuple) else (spec, {}))
    if name is None:
        return B
    method = getattr(relaxation_module, name, None)
    if method is None:
        raise ValueError(f"unknown improve_candidates smoother '{name}'")
    b = np.zeros(A.shape[0], dtype=B.dtype)
    for c in range(B.shape[1]):
        x = np.ascontiguousarray(B[:, c])
        method(A, x, b, **dict(kwargs))
        B[:, c] = x
    return B


def _smooth_prolongator(spec, A, T, C, B):
    """Resolve a smooth spec to the prolongator P."""
    name, kwargs = (spec if isinstance(spec, tuple) else (spec, {}))
    if isinstance(kwargs, dict):
        kwargs = dict(kwargs)
    if name is None:
        return sp.csr_matrix(T)
    if name == "jacobi":
        return jacobi_prolongation_smoother(A, T, C, B, **kwargs)
    if name == "richardson":
        return richardson_prolongation_smoother(A, T, **kwargs)
    if name == "energy":
        return energy_prolongation_smoother(
            A, T, C, B, B, Cpt_params=None, **kwargs
        )
    raise ValueError(f"unrecognized prolongation smoother: {name}")


def smoothed_aggregation_solver(
    A,
    B=None,
    BH=None,
    symmetry="hermitian",
    strength="symmetric",
    aggregate="standard",
    smooth=("jacobi", {"omega": 4.0 / 3.0}),
    presmoother=("block_gauss_seidel", {"sweep": "symmetric"}),
    postsmoother=("block_gauss_seidel", {"sweep": "symmetric"}),
    improve_candidates=(("block_gauss_seidel",
                         {"sweep": "symmetric", "iterations": 4}), None),
    max_levels=10,
    max_coarse=10,
    diagonal_dominance=False,
    keep=False,
    **kwargs,
):
    """Create a smoothed-aggregation AMG solver.

    Rebuild of [R] pyamg/aggregation/aggregation.py::
    smoothed_aggregation_solver with the reference defaults (SURVEY.md
    §2.2).  Returns a MultilevelSolver.
    """
    if not sp.issparse(A) or A.format not in ("csr", "bsr"):
        try:
            A = sp.csr_matrix(A)
            warnings.warn("implicit conversion of A to CSR", sp.SparseEfficiencyWarning)
        except Exception as exc:
            raise TypeError("argument A must have type csr_matrix or "
                            "bsr_matrix, or be convertible to csr_matrix") from exc
    A = asfptype(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")

    if symmetry not in ("symmetric", "hermitian", "nonsymmetric"):
        raise ValueError("expected symmetric, hermitian or nonsymmetric")
    A.symmetry = symmetry

    n = A.shape[0]
    if B is None:
        B = np.ones((n, 1), dtype=A.dtype)
    else:
        B = np.asarray(B, dtype=upcast(A.dtype, np.asarray(B).dtype))
        if B.ndim == 1:
            B = B.reshape(-1, 1)
        if B.shape[0] != n:
            raise ValueError("invalid candidate dimensions")
        if B.shape[1] > blocksize(A) and aggregate == "pairwise":
            warnings.warn("pairwise aggregation with multiple candidates is "
                          "untested")
    B = B.copy()

    if symmetry == "nonsymmetric":
        if BH is None:
            BH = B.copy()
        else:
            BH = np.asarray(BH, dtype=B.dtype)
            if BH.ndim == 1:
                BH = BH.reshape(-1, 1)
            if BH.shape != B.shape:
                raise ValueError("invalid left candidate dimensions")
        BH = BH.copy()

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
           and levels[-1].A.shape[0] // max(blocksize(levels[-1].A), 1) > max_coarse):
        sizes_before = levels[-1].A.shape[0]
        _extend_hierarchy(levels, strength, aggregate, smooth,
                          improve_candidates, diagonal_dominance, keep)
        if levels[-2].P.shape[1] == 0 or levels[-1].A.shape[0] == sizes_before:
            # aggregation failed to coarsen; drop the stalled level
            levels.pop()
            break

    ml = MultilevelSolver(levels, **kwargs)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _extend_hierarchy(levels, strength, aggregate, smooth, improve_candidates,
                      diagonal_dominance, keep):
    """Service routine implementing SURVEY.md §3.1's per-level pipeline."""
    A = levels[-1].A
    B = levels[-1].B
    bs = blocksize(A)
    lvl_i = len(levels) - 1

    # strength of connection (on the node graph for block matrices)
    C = _strength_measure(A, strength[min(lvl_i, len(strength) - 1)])
    if diagonal_dominance:
        C = eliminate_diag_dom_nodes(A, C)

    # aggregation
    AggOp, Cpts = _do_aggregate(C, aggregate[min(lvl_i, len(aggregate) - 1)], A=A)

    # improve candidates by relaxing on A z = 0
    B = _improve_candidates(
        A, B, improve_candidates[min(lvl_i, len(improve_candidates) - 1)])
    levels[-1].B = B

    # tentative prolongator via per-aggregate QR
    T, B_coarse = fit_candidates(AggOp, B)

    if getattr(A, "symmetry", "hermitian") == "nonsymmetric":
        BH = levels[-1].BH
        BH = _improve_candidates(
            conj_transpose_csr(A), BH,
            improve_candidates[min(lvl_i, len(improve_candidates) - 1)])
        levels[-1].BH = BH
        TH, BH_coarse = fit_candidates(AggOp, BH)

    # smoothed prolongator
    smooth_spec = smooth[min(lvl_i, len(smooth) - 1)]
    P = _smooth_prolongator(smooth_spec, A, T, C, B)

    # restriction
    symmetry = getattr(A, "symmetry", "hermitian")
    if symmetry == "hermitian":
        R = conj_transpose_csr(P)
        # real data: conj transpose == plain transpose; tag so the device
        # compiler can share P's arrays without a full numeric comparison
        levels[-1].R_is_PT = not np.iscomplexobj(P.data)
    elif symmetry == "symmetric":
        R = P.T.tocsr()
        levels[-1].R_is_PT = True
    else:  # nonsymmetric: smooth TH against A^H
        AH = conj_transpose_csr(sp.csr_matrix(A))
        AH.symmetry = "nonsymmetric"
        CH = conj_transpose_csr(C) if sp.issparse(C) else C
        RH = _smooth_prolongator(smooth_spec, AH, TH, CH, BH)
        R = conj_transpose_csr(RH)

    if keep:
        levels[-1].C = C
        levels[-1].AggOp = AggOp
        levels[-1].T = T
        levels[-1].Cpts = np.asarray(Cpts)

    levels[-1].P = P
    levels[-1].R = R

    # Galerkin triple product (SpGEMM x2 — the setup hot spot, SURVEY §3.1)
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

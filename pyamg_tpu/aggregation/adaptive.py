"""Adaptive smoothed aggregation (alpha-SA).

Rebuild of [R] pyamg/aggregation/adaptive.py (SURVEY.md §2.2):
bootstrap near-nullspace candidates by relaxing on A x = 0 (initial
stage), then improve them by running the current solver on the
homogeneous problem (general stages) — algebraically smooth error that
the hierarchy cannot reduce becomes the next candidate.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..relaxation import relaxation as relaxation_module
from ..util.linalg import norm
from ..util.utils import conj_transpose_csr, asfptype, blocksize
from .aggregation import smoothed_aggregation_solver

__all__ = ["adaptive_sa_solver"]


def _relax_homogeneous(A, x, iters, spec):
    name, kwargs = spec if isinstance(spec, tuple) else (spec, {})
    method = getattr(relaxation_module, name)
    b = np.zeros(A.shape[0], dtype=x.dtype)
    method(A, x, b, iterations=iters, **dict(kwargs))
    return x


def _initial_setup_stage(A, candidate_iters, prepostsmoother, strength,
                         aggregate, smooth, max_levels, max_coarse, rng):
    """The reference's staged initial setup ([R] pyamg/aggregation/
    adaptive.py::initial_setup_stage, SURVEY.md §2.2): construct a
    throwaway hierarchy level by level, relaxing the candidate on
    A_l x = 0 AT EVERY LEVEL on the way down (each level's relaxation
    exposes the smooth error that level cannot reduce), then interpolate
    back up with relaxation at every level.  Returns the bootstrapped
    fine-level candidate and the work spent (in units of finest nnz).
    """
    from .aggregation import (_do_aggregate, _smooth_prolongator,
                              _strength_measure)
    from .tentative import fit_candidates

    nnz0 = max(A.nnz, 1)
    work = 0.0
    path = []                       # (A_l, P) pairs, fine -> coarse
    A_l = A
    x = (rng.random(A_l.shape[0]) - 0.5).astype(
        np.promote_types(A.dtype, np.float64))
    _relax_homogeneous(A_l, x, candidate_iters, prepostsmoother)
    work += candidate_iters * A_l.nnz / nnz0

    while A_l.shape[0] > max_coarse and len(path) < max_levels - 1:
        C = _strength_measure(A_l, strength)
        AggOp, _ = _do_aggregate(C, aggregate, A=A_l)
        Bl = x.reshape(-1, 1)
        T, x_c = fit_candidates(AggOp, Bl)
        P = _smooth_prolongator(smooth, A_l, T, C, Bl)
        R = conj_transpose_csr(P)
        A_next = sp.csr_matrix(R @ (sp.csr_matrix(A_l) @ P))
        path.append((A_l, P))
        A_l = A_next
        x = np.asarray(x_c[:, 0]).copy()
        if A_l.shape[0] > 1:
            _relax_homogeneous(A_l, x, candidate_iters, prepostsmoother)
            work += candidate_iters * A_l.nnz / nnz0

    # interpolate the coarse candidate back up, relaxing per level
    for A_l, P in reversed(path):
        x = np.asarray(P @ x)
        _relax_homogeneous(A_l, x, candidate_iters, prepostsmoother)
        work += candidate_iters * A_l.nnz / nnz0
    return x, work


def adaptive_sa_solver(
    A,
    initial_candidates=None,
    symmetry="hermitian",
    pdef=True,
    num_candidates=1,
    candidate_iters=5,
    improvement_iters=0,
    epsilon=0.1,
    max_levels=10,
    max_coarse=10,
    aggregate="standard",
    prepostsmoother=("gauss_seidel", {"sweep": "symmetric"}),
    smooth=("jacobi", {"omega": 4.0 / 3.0}),
    strength="symmetric",
    coarse_solver="pinv",
    keep=True,
    **kwargs,
):
    """Create an adaptive SA solver; returns ``(ml, work)``.

    Rebuild of [R] pyamg/aggregation/adaptive.py::adaptive_sa_solver
    (initial_setup_stage + general_setup_stage internals folded in).
    ``work`` is the relative setup work estimate (units of fine nnz).
    """
    A = sp.csr_matrix(A) if not sp.issparse(A) else A
    A = asfptype(A.tocsr() if A.format not in ("csr", "bsr") else A)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    work = 0.0

    def build(Bmat):
        return smoothed_aggregation_solver(
            A, B=Bmat, symmetry=symmetry, strength=strength,
            aggregate=aggregate, smooth=smooth,
            presmoother=prepostsmoother, postsmoother=prepostsmoother,
            max_levels=max_levels, max_coarse=max_coarse, keep=keep,
            coarse_solver=coarse_solver, **kwargs)

    # ----- initial setup stage (staged, per-level — reference form) ----
    if initial_candidates is None:
        x, w = _initial_setup_stage(
            A, candidate_iters, prepostsmoother,
            strength if not isinstance(strength, list) else strength[0],
            aggregate if not isinstance(aggregate, list) else aggregate[0],
            smooth if not isinstance(smooth, list) else smooth[0],
            max_levels, max_coarse, rng)
        work += w
        nrm = norm(x)
        if nrm == 0:
            x = np.ones(n, dtype=x.dtype)
            nrm = norm(x)
        B = (x / nrm).reshape(-1, 1)
    else:
        B = np.asarray(initial_candidates, dtype=np.float64)
        if B.ndim == 1:
            B = B.reshape(-1, 1)
    ml = build(B)

    # test the bootstrapped hierarchy on A x = 0; ONLY if it still
    # converges slower than the epsilon target does the exposed slow mode
    # replace the candidate (replacing unconditionally would swap a good
    # candidate for the hierarchy's numerical-noise worst mode)
    if initial_candidates is None:
        resid = []
        x = _run_homogeneous(ml, B[:, 0].copy(), candidate_iters, resid)
        work += candidate_iters * ml.cycle_complexity()
        fac = ((resid[-1] / resid[0]) ** (1.0 / candidate_iters)
               if resid and resid[0] > 0 else 0.0)
        nrm = norm(x)
        if fac > epsilon and nrm > 0:
            B = (x / nrm).reshape(-1, 1)
            ml = build(B)

    # ----- general setup stages: add candidates -----
    while B.shape[1] < num_candidates:
        x = rng.random(n) - 0.5
        residuals = []
        x = _run_homogeneous(ml, x, candidate_iters, residuals)
        work += candidate_iters * ml.cycle_complexity()
        # converged quickly? candidates already capture the kernel
        if len(residuals) >= 2 and residuals[-1] < epsilon * residuals[0]:
            break
        nrm = norm(x)
        if nrm == 0:
            break
        B = np.hstack([B, (x / nrm).reshape(-1, 1)])
        ml = build(B)

    # ----- improvement iterations: re-derive each candidate -----
    for _ in range(int(improvement_iters)):
        for c in range(B.shape[1]):
            Bother = np.delete(B, c, axis=1)
            ml_tmp = build(Bother) if Bother.shape[1] else None
            x = B[:, c].copy()
            if ml_tmp is not None:
                resid = []
                x = _run_homogeneous(ml_tmp, x, candidate_iters, resid)
                work += candidate_iters * ml_tmp.cycle_complexity()
                fac = ((resid[-1] / resid[0]) ** (1.0 / candidate_iters)
                       if resid and resid[0] > 0 else 0.0)
                if fac <= epsilon:
                    continue  # the other candidates already suffice
            else:
                x = _relax_homogeneous(A, x, candidate_iters,
                                       prepostsmoother)
                work += candidate_iters
            nrm = norm(x)
            if nrm > 0:
                B[:, c] = x / nrm
        ml = build(B)

    return ml, work


def _run_homogeneous(ml, x, iters, residuals):
    """Run `iters` cycles of ml on A x = 0 starting from x."""
    A = ml.levels[0].A
    b = np.zeros(A.shape[0], dtype=np.promote_types(A.dtype, np.float64))
    residuals.append(norm(A @ x))
    x = ml.solve(b, x0=x, tol=1e-300, maxiter=iters, accel=None)
    residuals.append(norm(A @ x))
    return x

"""Blackbox zero-configuration solver API.

Rebuild of [R] pyamg/blackbox.py (SURVEY.md §2.3, layer L6 /
call stack §3.5): inspect the matrix, pick a sensible SA configuration,
and solve — ``solve(A, b)`` just works.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from .aggregation import smoothed_aggregation_solver
from .util.linalg import ishermitian, norm

__all__ = ["solve", "solver", "solver_configuration", "make_csr"]


def make_csr(A):
    """Convert A to CSR, warning on implicit conversion.

    [R] pyamg/blackbox.py::make_csr.
    """
    if sp.issparse(A) and A.format in ("csr", "bsr"):
        A = A.tocsr() if A.format != "csr" else A
    else:
        try:
            A = sp.csr_matrix(A)
            warnings.warn("implicit conversion of A to CSR in "
                          "pyamg_tpu.blackbox.make_csr")
        except Exception as exc:
            raise TypeError("argument A must have type csr_matrix or "
                            "bsr_matrix, or be convertible to csr_matrix"
                            ) from exc
    if A.shape[0] != A.shape[1]:
        raise TypeError("argument A must be a square matrix")
    return A


def solver_configuration(A, B=None, verb=True):
    """Infer a reasonable SA configuration for A.

    [R] pyamg/blackbox.py::solver_configuration: detect hermitian-ness,
    choose candidates, strength, aggregation and smoothers.
    Returns a config dict consumable by :func:`solver`.
    """
    A = make_csr(A)
    config = {}

    if ishermitian(A, fast_check=True):
        config["symmetry"] = "hermitian"
        smooth_default = ("energy", {"krylov": "cg", "maxiter": 3,
                                     "degree": 1, "weighting": "local"})
        config["accel"] = "cg"
        config["presmoother"] = ("block_gauss_seidel", {"sweep": "symmetric"})
        config["postsmoother"] = ("block_gauss_seidel", {"sweep": "symmetric"})
    else:
        config["symmetry"] = "nonsymmetric"
        smooth_default = ("energy", {"krylov": "cgnr", "maxiter": 2,
                                     "degree": 1, "weighting": "local"})
        # fgmres: right preconditioning stops on the TRUE residual
        config["accel"] = "fgmres"
        # plain Gauss-Seidel can diverge on nonsymmetric operators;
        # NR (least-squares) sweeps are unconditionally convergent
        config["presmoother"] = ("gauss_seidel_nr", {"sweep": "symmetric",
                                                     "iterations": 2})
        config["postsmoother"] = ("gauss_seidel_nr", {"sweep": "symmetric",
                                                      "iterations": 2})
    if verb:
        print(f"  Detected a {config['symmetry']} matrix")

    config["smooth"] = smooth_default

    if B is None:
        config["B"] = np.ones((A.shape[0], 1), dtype=A.dtype)
    else:
        B = np.asarray(B)
        if B.ndim == 1:
            B = B.reshape(-1, 1)
        if B.shape[0] != A.shape[0]:
            raise TypeError("invalid candidate dimensions")
        config["B"] = B
    config["BH"] = None

    config["strength"] = ("symmetric", {"theta": 0.0})
    config["aggregate"] = "standard"
    config["max_levels"] = 15
    config["max_coarse"] = 500
    config["improve_candidates"] = [("block_gauss_seidel",
                                     {"sweep": "symmetric",
                                      "iterations": 4}), None]
    config["keep"] = False
    return config


def solver(A, config):
    """Build a solver from a configuration dict ([R] blackbox.py::solver)."""
    A = make_csr(A)
    cfg = dict(config)
    cfg.pop("accel", None)
    try:
        return smoothed_aggregation_solver(
            A,
            B=cfg.pop("B", None),
            BH=cfg.pop("BH", None),
            **cfg,
        )
    except Exception as exc:
        raise TypeError(f"failed to generate smoothed_aggregation_solver: "
                        f"{exc}") from exc


def solve(A, b, x0=None, tol=1e-5, maxiter=400, return_solver=False,
          existing_solver=None, verb=True, accel=None, device=False):
    """Zero-config solve of A x = b ([R] pyamg/blackbox.py::solve).

    Builds (or reuses) an SA solver and runs Krylov-accelerated cycles.

    ``device=True`` (an addition, no reference counterpart):
    after the host setup, the whole hierarchy is compiled into ONE jitted
    XLA program (engine.as_device_solver) and the accelerated solve runs
    device-resident — f64 outer Krylov preconditioned by the f32 cycle
    (mixed precision), so any ``tol`` down to ~1e-12 is reachable at
    device speed.  Complex operators compile natively in complex128.
    With ``return_solver=True`` the returned solver is the device solver;
    pass it back as ``existing_solver`` to amortize setup+compile across
    solves (it is detected by its ``hierarchy`` attribute).
    """
    A = make_csr(A)
    b = np.asarray(b)
    if verb:
        print(f"Solving matrix of size {A.shape[0]} with {A.nnz} nonzeros")

    device_solver = (existing_solver is not None
                     and hasattr(existing_solver, "hierarchy"))
    if existing_solver is None:
        config = solver_configuration(A, verb=verb)
        ml = solver(A, config)
        chosen_accel = accel or config["accel"]
    else:
        ml = existing_solver
        chosen_accel = accel or ("cg" if ishermitian(A, fast_check=True)
                                 else "fgmres")
    if verb:
        print(ml)

    solve_kwargs = {}
    if device and not device_solver:
        from .engine import as_device_solver
        if np.iscomplexobj(A.data):
            import jax.numpy as jnp
            ml = as_device_solver(ml, dtype=jnp.complex128)
            solve_kwargs["precision"] = "native"
        else:
            ml = as_device_solver(ml, mixed_precision=True)
            solve_kwargs["precision"] = "mixed"
        device_solver = True
    if device_solver:
        if np.dtype(ml.hierarchy.dtype).kind != "c" and \
                getattr(ml.hierarchy, "A64", None) is not None:
            solve_kwargs.setdefault("precision", "mixed")
        if chosen_accel == "gmres":    # device engine spells it fgmres
            chosen_accel = "fgmres"

    residuals = []
    x = ml.solve(b, x0=x0, tol=tol, maxiter=maxiter, accel=chosen_accel,
                 residuals=residuals, **solve_kwargs)
    if verb:
        nb = norm(b)
        rel = norm(b - A @ x) / nb if nb != 0 else norm(b - A @ x)
        print(f"  Residuals ||r_k||/||b||: {rel:.2e} after "
              f"{len(residuals) - 1} iterations")
    if return_solver:
        return x, ml
    return x

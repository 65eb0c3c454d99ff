"""Multilevel hierarchy and cycling engine (host reference path).

Rebuild of [R] pyamg/multilevel.py (SURVEY.md §2.1, layer L4).
The class below is the *reference-semantics* host engine: exact V/W/F/AMLI
recursion over scipy operators, the correctness anchor for the jitted
device engine in :mod:`pyamg_tpu.engine` (which unrolls the same cycle
over a static level pytree and runs it on the device).  ``solve`` can
dispatch to the device engine via ``backend='device'`` once a hierarchy
is compiled.

Cycle semantics replicated exactly (SURVEY.md §2.1): 'V' one recursive
call, 'W' two, 'F' one F-recursion then one V, 'AMLI' coarse-level
Krylov-corrected cycles.  ``solve(..., accel=...)`` resolves the string
first against pyamg_tpu.krylov then scipy.sparse.linalg, and passes
``M = self.aspreconditioner(cycle)``.  Residual histories are appended to
a user-passed ``residuals`` list — the acceptance contract of
BASELINE.json:5.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.linalg
import scipy.sparse as sp
from scipy.sparse.linalg import LinearOperator, splu

from .util.linalg import norm
from .util.utils import upcast

__all__ = ["MultilevelSolver", "multilevel_solver", "coarse_grid_solver"]


class MultilevelSolver:
    """A multigrid hierarchy: list of levels + cycling/solve engine."""

    class Level:
        """One grid level.

        Always holds ``A``; non-coarsest levels hold ``P`` and ``R``.
        Setup methods may attach ``splitting``, ``AggOp``, ``C``, ``B``,
        ``T``, ``Fpts``/``Cpts`` etc. when ``keep=True`` (reference
        convention, SURVEY.md §2.1).
        """

        def __init__(self):
            self.A = None
            self.P = None
            self.R = None

        @property
        def nnz(self):
            return self.A.nnz if sp.issparse(self.A) else int(np.prod(self.A.shape))

    # legacy alias used by the reference
    level = Level

    def __init__(self, levels, coarse_solver="pinv"):
        self.levels = levels
        self.coarse_solver = coarse_grid_solver(coarse_solver)
        self.symmetric_smoothing = False
        self._device_hierarchy = None

    def __repr__(self):
        output = f"{type(self).__name__}\n"
        output += f"Number of Levels:     {len(self.levels)}\n"
        output += f"Operator Complexity: {self.operator_complexity():6.3f}\n"
        output += f"Grid Complexity:     {self.grid_complexity():6.3f}\n"
        output += f"Coarse Solver:        {self.coarse_solver.name()}\n"
        total_nnz = sum(lvl.A.nnz for lvl in self.levels)
        output += "  level   unknowns     nonzeros\n"
        for n, lvl in enumerate(self.levels):
            A = lvl.A
            ratio = 100 * A.nnz / max(total_nnz, 1)
            output += f"{n:>6} {A.shape[1]:>11} {A.nnz:>12} [{ratio:2.2f}%]\n"
        return output

    # ------------------------------------------------------------------
    # complexity metrics ([R] pyamg/multilevel.py, SURVEY.md §5)
    # ------------------------------------------------------------------

    def operator_complexity(self):
        """sum(nnz A_l) / nnz A_0."""
        return sum(lvl.A.nnz for lvl in self.levels) / float(self.levels[0].A.nnz)

    def grid_complexity(self):
        """sum(n_l) / n_0."""
        return sum(lvl.A.shape[0] for lvl in self.levels) / float(
            self.levels[0].A.shape[0]
        )

    def cycle_complexity(self, cycle="V"):
        """Approximate work of one cycle in units of finest-grid nnz.

        Counts, per level visit: pre+post smoothing sweeps (from the bound
        smoother specs when available, else 2), one residual computation,
        and the restrict/interpolate products.
        """
        cycle = str(cycle).upper()
        nlevels = len(self.levels)
        # visits per level for each cycle type
        visits = np.zeros(nlevels)

        def descend(lvl, mult, cyc):
            visits[lvl] += mult
            if lvl == nlevels - 1:
                return
            if cyc == "V":
                descend(lvl + 1, mult, "V")
            elif cyc == "W":
                descend(lvl + 1, 2 * mult, "W")
            elif cyc == "F":
                descend(lvl + 1, mult, "F")
                if lvl + 1 < nlevels - 1:
                    descend(lvl + 1, mult, "V")
            elif cyc == "AMLI":
                descend(lvl + 1, 2 * mult, "AMLI")
            else:
                raise ValueError(f"unrecognized cycle type {cycle}")

        descend(0, 1.0, cycle)

        flops = 0.0
        for i, lvl in enumerate(self.levels):
            if i < nlevels - 1:
                pre_spec = getattr(lvl, "presmoother_spec", ("gs", {}))
                post_spec = getattr(lvl, "postsmoother_spec", ("gs", {}))

                def _sweeps(spec):
                    if spec is None or spec[0] is None:
                        return 0
                    kwargs = spec[1] if len(spec) > 1 else {}
                    its = kwargs.get("iterations", 1)
                    sweep = kwargs.get("sweep", "forward")
                    deg = kwargs.get("degree", 1)
                    mult = 2 if sweep == "symmetric" else 1
                    return its * mult * max(deg, 1)

                smooth = _sweeps(pre_spec) + _sweeps(post_spec)
                work = smooth * lvl.A.nnz + lvl.A.nnz  # smoothing + residual
                if lvl.P is not None:
                    work += lvl.P.nnz + lvl.R.nnz
            else:
                work = lvl.A.nnz  # coarse solve proxy
            flops += visits[i] * work
        return flops / float(self.levels[0].A.nnz)

    # ------------------------------------------------------------------
    # preconditioner interface
    # ------------------------------------------------------------------

    def psolve(self, b):
        return self.solve(b, maxiter=1, cycle="V", tol=1e-12, accel=None)

    def aspreconditioner(self, cycle="V"):
        """Wrap one cycle as a scipy LinearOperator (M ~ A^{-1}).

        [R] pyamg/multilevel.py::aspreconditioner.
        """
        shape = self.levels[0].A.shape
        dtype = self.levels[0].A.dtype

        def matvec(b):
            return self.solve(b, maxiter=1, cycle=cycle, tol=1e-12, accel=None)

        return LinearOperator(shape, matvec, dtype=dtype)

    # ------------------------------------------------------------------
    # solve
    # ------------------------------------------------------------------

    def to_device(self, dtype=None, mixed_precision=False, row_pad=None,
                  coarse_cutoff=None):
        """Compile (and cache) this hierarchy for the device engine.

        Returns a pyamg_tpu.engine.DeviceMultilevelSolver; repeated calls
        with the same options reuse the compiled hierarchy.
        ``coarse_cutoff=n`` truncates the device hierarchy at the first
        level with <= n unknowns (dense pinv there) — saves per-cycle
        tiny-level overhead on deep hierarchies at the cost of exact
        host-parity of the residual history (see
        engine.compile_hierarchy).
        """
        from .engine import as_device_solver
        import jax
        import jax.numpy as jnp

        if dtype is None:
            dtype = jnp.float32
        if jnp.dtype(dtype) == jnp.dtype("float64"):
            # without x64 the arrays silently truncate to f32 and the
            # reported residual history becomes meaningless
            jax.config.update("jax_enable_x64", True)
        key = (str(jnp.dtype(dtype)), mixed_precision, row_pad,
               coarse_cutoff)
        cached = self._device_hierarchy
        if cached is not None and cached[0] == key:
            return cached[1]
        dml = as_device_solver(self, dtype=dtype,
                               mixed_precision=mixed_precision,
                               row_pad=row_pad, coarse_cutoff=coarse_cutoff)
        self._device_hierarchy = (key, dml)
        return dml

    def solve(self, b, x0=None, tol=1e-5, maxiter=100, cycle="V", accel=None,
              callback=None, residuals=None, return_info=False,
              cycles_per_level=1, backend="host", amli_depth=2):
        """Solve A x = b with multigrid cycling, optionally Krylov-wrapped.

        [R] pyamg/multilevel.py::solve.  ``residuals`` (a list) receives
        the 2-norm residual history including iteration 0.

        backend='device' routes through the jitted device engine
        (:meth:`to_device`, native f64; V/W/F cycles, cg/gmres/bicgstab
        accel, no callback support); 'host' (default) is the
        reference-semantics SciPy path.
        """
        if backend == "device":
            if callback is not None:
                raise ValueError("device backend does not support callbacks; "
                                 "use backend='host'")
            import jax.numpy as jnp

            dml = self.to_device(dtype=jnp.float64)
            return dml.solve(b, x0=x0, tol=tol,
                             maxiter=100 if maxiter is None else maxiter,
                             cycle=cycle, accel=accel, residuals=residuals,
                             return_info=return_info)
        A = self.levels[0].A
        if maxiter is None:
            maxiter = 100
        cycle = str(cycle).upper()

        b = np.asarray(b).ravel()
        if b.shape[0] != A.shape[0]:
            raise ValueError(
                f"b has incompatible dimension {b.shape[0]}; expected {A.shape[0]}"
            )
        dtype = upcast(A.dtype, b.dtype)
        if x0 is None:
            x = np.zeros(A.shape[0], dtype=dtype)
        else:
            x = np.asarray(x0, dtype=dtype).ravel().copy()

        if accel is not None:
            return self._accelerated_solve(
                b, x, tol, maxiter, cycle, accel, callback, residuals,
                return_info,
            )

        if residuals is None:
            residuals = []
        else:
            residuals[:] = []

        normb = norm(b)
        normr = norm(b - A @ x)
        residuals.append(normr)
        rtol = tol * (normb if normb != 0 else 1.0)

        if len(self.levels) == 1:
            x = self.coarse_solver(A, b)
            residuals.append(norm(b - A @ x))
            if callback is not None:
                callback(x)
            return (x, 0) if return_info else x

        it = 0
        while True:
            self.__solve(0, x, b, cycle, cycles_per_level, amli_depth)
            it += 1
            normr = norm(b - A @ x)
            residuals.append(normr)
            if callback is not None:
                callback(x)
            if normr < rtol:
                return (x, 0) if return_info else x
            if it >= maxiter:
                return (x, it) if return_info else x

    def _accelerated_solve(self, b, x, tol, maxiter, cycle, accel, callback,
                           residuals, return_info):
        A = self.levels[0].A
        from . import krylov as _krylov

        if callable(accel):
            kry = accel
        elif isinstance(accel, str) and hasattr(_krylov, accel):
            kry = getattr(_krylov, accel)
        else:
            import scipy.sparse.linalg as sla

            if isinstance(accel, str) and hasattr(sla, accel):
                kry = getattr(sla, accel)
            else:
                raise ValueError(f"unknown accelerator '{accel}'")

        M = self.aspreconditioner(cycle=cycle)

        if residuals is not None:
            residuals[:] = []

        try:
            x, info = kry(A, b, x0=x, tol=tol, maxiter=maxiter, M=M,
                          callback=callback, residuals=residuals)
            return (x, info) if return_info else x
        except TypeError:
            # scipy-style signature: no residuals/criteria kwargs
            history = []

            def cb(xk):
                history.append(norm(b - A @ xk))
                if callback is not None:
                    callback(xk)

            r0 = norm(b - A @ x)
            x, info = kry(A, b, x0=x, rtol=tol, maxiter=maxiter, M=M,
                          callback=cb)
            if residuals is not None:
                residuals[:] = [r0] + history
            return (x, info) if return_info else x

    def __solve(self, lvl, x, b, cycle, cycles_per_level=1, amli_depth=2):
        """One recursive cycle visit at level ``lvl`` (in-place on x).

        [R] pyamg/multilevel.py::__solve recursion (SURVEY.md §3.2).
        """
        A = self.levels[lvl].A
        self.levels[lvl].presmoother(A, x, b)

        residual = b - A @ x
        coarse_b = self.levels[lvl].R @ residual
        coarse_x = np.zeros_like(coarse_b)

        if lvl == len(self.levels) - 2:
            coarse_x[:] = self.coarse_solver(self.levels[-1].A, coarse_b)
        else:
            if cycle == "V":
                for _ in range(max(int(cycles_per_level), 1)):
                    self.__solve(lvl + 1, coarse_x, coarse_b, "V",
                                 cycles_per_level, amli_depth)
            elif cycle == "W":
                self.__solve(lvl + 1, coarse_x, coarse_b, cycle,
                             cycles_per_level, amli_depth)
                self.__solve(lvl + 1, coarse_x, coarse_b, cycle,
                             cycles_per_level, amli_depth)
            elif cycle == "F":
                self.__solve(lvl + 1, coarse_x, coarse_b, cycle,
                             cycles_per_level, amli_depth)
                self.__solve(lvl + 1, coarse_x, coarse_b, "V", 1, amli_depth)
            elif cycle == "AMLI":
                # coarse-level Krylov correction: nAMLI orthogonalized
                # preconditioned steps ([R] multilevel.py AMLI branch)
                nAMLI = max(int(amli_depth), 1)
                Ac = self.levels[lvl + 1].A
                p = np.zeros((nAMLI, coarse_b.shape[0]), dtype=coarse_b.dtype)
                beta = np.zeros((nAMLI, nAMLI), dtype=coarse_b.dtype)
                for k in range(nAMLI):
                    p[k, :] = 0
                    self.__solve(lvl + 1, p[k, :], coarse_b, cycle,
                                 cycles_per_level, amli_depth)
                    for j in range(k):
                        Apj = Ac @ p[j, :]
                        denom = np.inner(p[j, :].conj(), Apj)
                        if denom == 0:
                            continue
                        beta[k, j] = np.inner(p[j, :].conj(), Ac @ p[k, :]) / denom
                        p[k, :] -= beta[k, j] * p[j, :]
                    Apk = Ac @ p[k, :]
                    denom = np.inner(p[k, :].conj(), Apk)
                    if denom == 0:
                        continue
                    alpha = np.inner(p[k, :].conj(), coarse_b) / denom
                    coarse_x += alpha * p[k, :]
                    coarse_b = coarse_b - alpha * Apk
            else:
                raise ValueError(f"unrecognized cycle type {cycle}")

        x += self.levels[lvl].P @ coarse_x
        self.levels[lvl].postsmoother(A, x, b)


# legacy alias ([R] pyamg/multilevel.py::multilevel_solver)
multilevel_solver = MultilevelSolver


class _CoarseGridSolver:
    def __init__(self, name, fn):
        self._name = name
        self._fn = fn

    def name(self):
        return self._name

    def __call__(self, A, b):
        return self._fn(A, b)

    def __repr__(self):
        return f"coarse_grid_solver({self._name!r})"


def coarse_grid_solver(solver):
    """Return a coarse solver callable ``cs(A, b) -> x`` with cached
    factorizations.

    [R] pyamg/multilevel.py::coarse_grid_solver.  Accepts 'pinv', 'lu',
    'splu', 'cholesky', relaxation names ('jacobi', 'gauss_seidel', ...),
    a ('name', kwargs) tuple, or a callable f(A, b, **kwargs).
    """
    if isinstance(solver, tuple):
        name, kwargs = solver
    else:
        name, kwargs = solver, {}

    if callable(name):
        fn = name
        return _CoarseGridSolver(getattr(fn, "__name__", "callable"),
                                 lambda A, b: fn(A, b, **kwargs))

    if name is None:
        return _CoarseGridSolver("none", lambda A, b: np.zeros_like(b))

    if name == "pinv":
        def fn(A, b):
            cached = getattr(A, "_amg_pinv", None)
            if cached is None:
                Ad = A.toarray() if sp.issparse(A) else np.asarray(A)
                cached = scipy.linalg.pinv(Ad, **kwargs)
                try:
                    A._amg_pinv = cached
                except AttributeError:
                    pass
            return cached @ b
        return _CoarseGridSolver("pinv", fn)

    if name in ("lu", "splu"):
        def fn(A, b):
            cached = getattr(A, "_amg_splu", None)
            if cached is None:
                Ac = sp.csc_matrix(A)
                try:
                    cached = splu(Ac, **kwargs)
                except RuntimeError:
                    # singular: regularize slightly
                    eps = 1e-12 * abs(Ac.diagonal()).max()
                    cached = splu(
                        (Ac + eps * sp.identity(Ac.shape[0], format="csc",
                                                dtype=Ac.dtype)), **kwargs
                    )
                try:
                    A._amg_splu = cached
                except AttributeError:
                    pass
            return cached.solve(np.asarray(b, dtype=np.promote_types(A.dtype, np.float64)))
        return _CoarseGridSolver(name, fn)

    if name == "cholesky":
        def fn(A, b):
            cached = getattr(A, "_amg_chol", None)
            if cached is None:
                Ad = A.toarray() if sp.issparse(A) else np.asarray(A)
                cached = scipy.linalg.cho_factor(Ad, **kwargs)
                try:
                    A._amg_chol = cached
                except AttributeError:
                    pass
            return scipy.linalg.cho_solve(cached, b)
        return _CoarseGridSolver("cholesky", fn)

    # relaxation-as-coarse-solver
    from .relaxation import relaxation as _relax

    if isinstance(name, str) and hasattr(_relax, name):
        method = getattr(_relax, name)

        def fn(A, b):
            x = np.zeros_like(b)
            opts = dict(kwargs)
            opts.setdefault("iterations", 10)
            method(A, x, b, **opts)
            return x
        return _CoarseGridSolver(name, fn)

    # krylov-as-coarse-solver
    from . import krylov as _krylov

    if isinstance(name, str) and hasattr(_krylov, name):
        method = getattr(_krylov, name)

        def fn(A, b):
            opts = dict(kwargs)
            opts.setdefault("maxiter", 25)
            opts.setdefault("tol", 1e-12)
            x, _ = method(A, b, **opts)
            return x
        return _CoarseGridSolver(name, fn)

    raise ValueError(f"unknown coarse solver '{name}'")

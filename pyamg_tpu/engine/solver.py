"""Jitted multilevel solve engine.

The device counterpart of pyamg_tpu.multilevel.MultilevelSolver
(SURVEY.md §2.1 L4): cycles are unrolled over the static level count at
trace time, the accelerated solve is one lax.while_loop — the ENTIRE
preconditioned Krylov iteration executes on device per call.  The
DeviceHierarchy is passed to jit as an ARGUMENT pytree (never captured:
captured device arrays would be baked into the program as constants).

Mixed precision (SURVEY.md §7 hard part 4): run the hierarchy in f32 and
either (a) solve fully on device in f32 (fastest; rel. residual floor
~1e-6), (b) run the outer Krylov loop in f64 on device with the f32
cycle as preconditioner (``precision='mixed'``), or (c) compile the
hierarchy in f64 for full f64 on device.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..sparse import pad_vector
from .hierarchy import DeviceHierarchy, compile_hierarchy
from .krylov import (_freeze, _hist_set, _norm, _vdot, device_bicgstab,
                     device_cg, device_cgne, device_cgnr, device_cr,
                     device_fgmres, device_gmres,
                     device_minimal_residual, device_steepest_descent)

__all__ = ["DeviceMultilevelSolver", "as_device_solver"]


def _fitv(v, n):
    """Slice/zero-pad to length n (transfer-operator row paddings — the
    adaptive windowed block — may differ from the level's row padding;
    sliced tail rows are structural-zero padding)."""
    if v.shape[0] == n:
        return v
    if v.shape[0] > n:
        return v[:n]
    return jnp.pad(v, (0, n - v.shape[0]))


def _make_cycle(nlev, cycle, amli_depth=2):
    """Build the trace-time cycle recursion (SURVEY.md §7 step 3).
    ``amli_depth`` = number of A_c-orthogonalized coarse corrections per
    AMLI visit (host parity: MultilevelSolver.solve(amli_depth=...))."""

    if nlev == 1:
        # single-level hierarchy (problem already <= max_coarse, e.g. a
        # blackbox solve of a small matrix): the "cycle" is the direct
        # coarse solve — host parity: MultilevelSolver.__solve at lvl 0
        # == len(levels)-1 goes straight to coarse_solver
        def direct(h, x, b):
            return _fitv(h.coarse_solve(_fitv(b, h.nc_pad)), b.shape[0])

        direct.zero = lambda h, b: direct(h, None, b)
        return direct

    def visit(h, i, x, b, kind, xz=False):
        """``xz`` (static): x is KNOWN zero — the entry smoother takes
        its specialized zero_call (one elementwise op instead of a full
        sweep).  True for every coarse-level entry and for the finest
        level under preconditioner use."""
        lvl = h.levels[i]
        x = (lvl.pre.zero_call(lvl.A, b) if xz else lvl.pre(lvl.A, x, b))
        r = b - (lvl.A @ x)
        rc = _fitv(lvl.R @ r, h.levels[i + 1].n_pad)
        if i == nlev - 2:
            xc = h.coarse_solve(rc)
        else:
            xc = jnp.zeros(h.levels[i + 1].n_pad, dtype=b.dtype)
            if kind == "V":
                xc = visit(h, i + 1, xc, rc, "V", xz=True)
            elif kind == "W":
                xc = visit(h, i + 1, xc, rc, "W", xz=True)
                xc = visit(h, i + 1, xc, rc, "W")
            elif kind == "F":
                xc = visit(h, i + 1, xc, rc, "F", xz=True)
                xc = visit(h, i + 1, xc, rc, "V")
            elif kind == "AMLI":
                # two A_c-orthogonalized coarse corrections (static
                # unroll of the host AMLI branch, SURVEY.md §2.1)
                Ac = h.levels[i + 1].A
                rc_cur = rc
                p_prev = None
                Ap_prev = None
                for _k in range(max(int(amli_depth), 1)):
                    p = visit(h, i + 1,
                              jnp.zeros(h.levels[i + 1].n_pad,
                                        dtype=b.dtype),
                              rc_cur, "AMLI", xz=True)
                    if p_prev is not None:
                        denom = _vdot(p_prev, Ap_prev)
                        beta = _vdot(p_prev, Ac @ p) / jnp.where(
                            denom == 0, 1.0, denom)
                        beta = jnp.where(denom == 0, 0.0, beta)
                        p = p - beta * p_prev
                    Ap = Ac @ p
                    denom = _vdot(p, Ap)
                    alpha = _vdot(p, rc_cur) / jnp.where(
                        denom == 0, 1.0, denom)
                    alpha = jnp.where(denom == 0, 0.0, alpha)
                    xc = xc + alpha * p
                    rc_cur = rc_cur - alpha * Ap
                    p_prev, Ap_prev = p, Ap
            else:
                raise ValueError(f"unsupported device cycle {kind}")
        x = x + _fitv(lvl.P @ xc, x.shape[0])
        x = lvl.post(lvl.A, x, b)
        return x

    def one_cycle(h, x, b):
        return visit(h, 0, x, b, cycle)

    def one_cycle_zero(h, b):
        """The cycle from x = 0 (preconditioner application) — lets the
        finest entry smoother take its zero_call too."""
        return visit(h, 0, None, b, cycle, xz=True)

    one_cycle.zero = one_cycle_zero
    return one_cycle


class DeviceMultilevelSolver:
    """Solve engine over a compiled DeviceHierarchy."""

    def __init__(self, hierarchy: DeviceHierarchy):
        self.hierarchy = hierarchy
        self._jit_cache = {}

    def _get_compiled(self, cycle, accel, maxiter, restart,
                      precision="native", amli_depth=2, batched=False):
        key = (cycle, accel, maxiter, restart, precision, amli_depth,
               batched, jax.tree_util.tree_structure(self.hierarchy))
        fn = self._jit_cache.get(key)
        if fn is not None:
            return fn
        nlev = len(self.hierarchy.levels)
        one_cycle = _make_cycle(nlev, cycle, amli_depth)
        mixed = precision == "mixed"
        if mixed and self.hierarchy.A64 is None:
            raise ValueError("mixed precision requires a hierarchy compiled "
                             "with mixed_precision=True")

        def mk_ops(h, cycle_dtype):
            if mixed:
                # A64's row padding may differ from the level's (the f32
                # operator's adaptive windowed block sets n_pad)
                n_pad = h.levels[0].n_pad
                a64_pad = getattr(h.A64, "n_pad", n_pad)
                matvec = lambda v: _fitv(h.A64 @ _fitv(v, a64_pad), n_pad)
                rmatvec = lambda v: _fitv(
                    h.A64.rmatvec(_fitv(v, a64_pad)), n_pad)
                precond = lambda r: one_cycle.zero(
                    h, r.astype(cycle_dtype)).astype(r.dtype)
            else:
                matvec = lambda v: h.levels[0].A @ v
                rmatvec = lambda v: _fitv(h.levels[0].A.rmatvec(v),
                                          v.shape[0])
                precond = lambda r: one_cycle.zero(h, r)
            return matvec, rmatvec, precond

        if accel is None:
            def run(h, b, x0, tol):
                matvec, _, _ = mk_ops(h, h.dtype)
                rtol = tol * jnp.where(_norm(b) == 0, 1.0, _norm(b))
                r = b - matvec(x0)
                normr = _norm(r)
                history = jnp.full(maxiter + 1, jnp.nan,
                                   dtype=b.dtype).at[0].set(normr)

                def cond(state):
                    it, x, normr, history = state
                    return (normr >= rtol) & (it < maxiter)

                def body(state):
                    it, x, normr, history = state
                    active = (normr >= rtol) & (it < maxiter)
                    if mixed:
                        corr = one_cycle.zero(
                            h,
                            (b - matvec(x)).astype(h.dtype)).astype(x.dtype)
                        x2 = x + corr
                    else:
                        x2 = one_cycle(h, x, b)
                    normr2 = _norm(b - matvec(x2))
                    history2 = _hist_set(history, it + 1, normr2)
                    return _freeze(active, (it + 1, x2, normr2, history2),
                                   state)

                it, x, normr, history = jax.lax.while_loop(
                    cond, body, (jnp.asarray(0), x0, normr, history))
                return x, history, it
        elif accel in ("cg", "bicgstab", "cr", "minimal_residual",
                       "steepest_descent"):
            fn_k = {"cg": device_cg, "bicgstab": device_bicgstab,
                    "cr": device_cr,
                    "minimal_residual": device_minimal_residual,
                    "steepest_descent": device_steepest_descent}[accel]

            def run(h, b, x0, tol):
                matvec, _, precond = mk_ops(h, h.dtype)
                return fn_k(matvec, b, x0, tol=tol, maxiter=maxiter,
                            M=precond)
        elif accel == "gmres":
            # LEFT-preconditioned restarted GMRES — host gmres_mgs
            # semantics (preconditioned-residual history); the flexible
            # right-preconditioned form stays under accel='fgmres'
            def run(h, b, x0, tol):
                matvec, _, precond = mk_ops(h, h.dtype)
                return device_gmres(matvec, b, x0, tol=tol,
                                    maxiter=maxiter, M=precond,
                                    restart=restart)
        elif accel == "fgmres":
            def run(h, b, x0, tol):
                matvec, _, precond = mk_ops(h, h.dtype)
                return device_fgmres(matvec, b, x0, tol=tol, maxiter=maxiter,
                                     M=precond, restart=restart)
        elif accel in ("cgnr", "cgne"):
            fn_k = device_cgnr if accel == "cgnr" else device_cgne

            def run(h, b, x0, tol):
                matvec, rmatvec, precond = mk_ops(h, h.dtype)
                return fn_k(matvec, rmatvec, b, x0, tol=tol,
                            maxiter=maxiter, M=precond)
        else:
            raise ValueError(f"unsupported device accelerator '{accel}'")

        if batched:
            # multi-RHS: vmap the whole solve program over RHS lanes
            # (axis 0 of b/x0).  Every format apply is plain XLA, so the
            # batch runs as K-major (K, n_pad) passes — one A read
            # amortized over K right-hand sides; Krylov bodies self-freeze
            # converged lanes (engine/krylov.py::_freeze).
            run = jax.vmap(run, in_axes=(None, 0, 0, None))
        fn = jax.jit(run)
        self._jit_cache[key] = fn
        return fn

    # -- public API (mirrors host MultilevelSolver.solve) --

    def solve(self, b, x0=None, tol=1e-8, maxiter=100, cycle="V",
              accel=None, residuals=None, return_info=False, restart=30,
              precision="native", amli_depth=2, device_out=False):
        """precision='native' runs entirely in the hierarchy dtype;
        'mixed' runs the outer Krylov loop in f64 on device with the f32
        cycle as preconditioner (reaches 1e-10 at device speed; requires
        compile_hierarchy(mixed_precision=True)).

        ``device_out=True`` returns x as a device array (sliced view, no
        device-to-host copy) for device-resident pipelines where the
        solution feeds further device computation.
        ``b``/``x0`` may likewise be device arrays (no host staging).

        **Batched multi-RHS** (the SURVEY.md §2.5 data-parallel analog):
        ``b`` of shape (n, K) solves K systems in ONE compiled program —
        the solve is vmapped over RHS lanes, SpMV/transfer applies fuse
        into (n_pad, K) passes (one operator read amortized over K), and
        each lane stops at its own convergence point (converged lanes
        freeze while others iterate).  Returns x of shape (n, K);
        ``residuals`` receives a list of K per-lane history arrays."""
        h = self.hierarchy
        n = h.levels[0].n
        n_pad = h.levels[0].n_pad
        dtype = jnp.float64 if precision == "mixed" else h.dtype
        b_in = b if isinstance(b, jnp.ndarray) else np.asarray(b)
        batched = b_in.ndim == 2

        def _stage(v):
            if isinstance(v, jnp.ndarray):
                return pad_vector(v.ravel().astype(dtype), n_pad)
            return pad_vector(jnp.asarray(np.asarray(v).ravel(),
                                          dtype=dtype), n_pad)

        def _stage_cols(v):
            # (n, K) column stack -> (K, n_pad) vmap lanes
            if not isinstance(v, jnp.ndarray):
                v = jnp.asarray(np.asarray(v), dtype=dtype)
            v = v.astype(dtype)
            if v.shape[0] < n_pad:
                v = jnp.pad(v, ((0, n_pad - v.shape[0]), (0, 0)))
            return v.T

        if batched:
            b_dev = _stage_cols(b_in)
            x0_dev = (jnp.zeros(b_dev.shape, dtype=dtype) if x0 is None
                      else _stage_cols(x0))
        else:
            b_dev = _stage(b)
            x0_dev = (jnp.zeros(n_pad, dtype=dtype) if x0 is None
                      else _stage(x0))
        fn = self._get_compiled(str(cycle).upper(), accel, int(maxiter),
                                int(restart), precision, int(amli_depth),
                                batched=batched)
        rdtype = np.zeros((), dtype=np.dtype(dtype)).real.dtype
        x, history, it = fn(h, b_dev, x0_dev, jnp.asarray(tol, dtype=rdtype))
        if batched:
            x = x[:, :n].T if device_out else np.asarray(x)[:, :n].T
            hists = [hl[~np.isnan(hl)]
                     for hl in np.real(np.asarray(history))]
            if residuals is not None:
                residuals[:] = hists
            if return_info:
                normb = np.linalg.norm(np.asarray(b_dev), axis=1)
                conv = [len(hl) >= 1
                        and hl[-1] < tol * max(float(nb), 1e-300)
                        for hl, nb in zip(hists, normb)]
                return x, (0 if all(conv) else int(np.max(np.asarray(it))))
            return x
        x = x[:n] if device_out else np.asarray(x)[:n]
        hist = np.real(np.asarray(history))
        hist = hist[~np.isnan(hist)]
        if residuals is not None:
            residuals[:] = list(hist)
        if return_info:
            converged = len(hist) >= 1 and (
                hist[-1] < tol * max(float(jnp.linalg.norm(b_dev)), 1e-300)
            )
            return x, (0 if converged else int(it))
        return x

    # -- host-parity introspection (MultilevelSolver counterparts) -----

    def operator_complexity(self):
        """sum(nnz per level) / nnz(finest) — the host
        MultilevelSolver.operator_complexity over the device formats'
        (structural) nnz counters."""
        nnzs = [int(lvl.A.nnz) for lvl in self.hierarchy.levels]
        return sum(nnzs) / max(nnzs[0], 1)

    def grid_complexity(self):
        ns = [int(lvl.n) for lvl in self.hierarchy.levels]
        return sum(ns) / max(ns[0], 1)

    def __repr__(self):
        lines = [f"DeviceMultilevelSolver "
                 f"({jnp.dtype(self.hierarchy.dtype).name}, "
                 f"{len(self.hierarchy.levels)} levels"
                 + (", mixed-precision A64" if self.hierarchy.A64
                    is not None else "") + ")",
                 f"  operator complexity: "
                 f"{self.operator_complexity():.3f}",
                 f"  grid complexity:     {self.grid_complexity():.3f}",
                 "  level    unknowns      nnz   format"]
        for i, lvl in enumerate(self.hierarchy.levels):
            fmt = type(lvl.A).__name__
            lines.append(f"  {i:>5} {int(lvl.n):>11} {int(lvl.A.nnz):>8}"
                         f"   {fmt}")
        return "\n".join(lines)

    def cycle_operator(self, cycle="V", amli_depth=2):
        """Jitted one-cycle application: r (padded) -> M r (padded)."""
        one_cycle = _make_cycle(len(self.hierarchy.levels),
                                str(cycle).upper(), amli_depth)
        fn = jax.jit(lambda h, r: one_cycle.zero(h, r))
        return lambda r: fn(self.hierarchy, r)

    def aspreconditioner(self, cycle="V"):
        """Host-facing LinearOperator applying the jitted device cycle.

        This is the mixed-precision bridge: a host f64 Krylov loop
        (pyamg_tpu.krylov) preconditioned by the f32 device V-cycle.
        """
        from scipy.sparse.linalg import LinearOperator

        h = self.hierarchy
        n = h.levels[0].n
        n_pad = h.levels[0].n_pad
        cyc = self.cycle_operator(cycle)

        def matvec(r):
            r_dev = pad_vector(jnp.asarray(np.asarray(r).ravel(),
                                           dtype=h.dtype), n_pad)
            return np.asarray(cyc(r_dev))[:n].astype(np.asarray(r).dtype)

        return LinearOperator((n, n), matvec=matvec, dtype=np.float64)


def as_device_solver(ml, dtype=jnp.float32, row_pad=None,
                     mixed_precision=False, coarse_cutoff=None):
    """Compile a host MultilevelSolver into a DeviceMultilevelSolver."""
    kwargs = {} if row_pad is None else {"row_pad": row_pad}
    return DeviceMultilevelSolver(
        compile_hierarchy(ml, dtype=dtype, mixed_precision=mixed_precision,
                          coarse_cutoff=coarse_cutoff, **kwargs))


def profile_cycle(dml, b=None, trace_dir=None, repeats=10, cycle="V"):
    """Time (and optionally jax.profiler-trace) the jitted cycle.

    SURVEY.md §5 tracing analog: returns a dict with wall time and the
    nnz/s roofline counter (the BASELINE.json:2 headline metric).  When
    ``trace_dir`` is given, a jax.profiler trace of the steady-state
    calls is written there (viewable in TensorBoard/XProf).
    """
    import time as _time

    h = dml.hierarchy
    n_pad = h.levels[0].n_pad
    if b is None:
        b = jnp.ones(n_pad, dtype=h.dtype)
    else:
        b = pad_vector(jnp.asarray(np.asarray(b).ravel(), dtype=h.dtype),
                       n_pad)
    cyc = dml.cycle_operator(cycle)
    jax.block_until_ready(cyc(b))  # compile

    def timed():
        times = []
        for _ in range(repeats):
            t0 = _time.perf_counter()
            jax.block_until_ready(cyc(b))
            times.append(_time.perf_counter() - t0)
        return float(np.median(times))

    if trace_dir is not None:
        with jax.profiler.trace(str(trace_dir)):
            t = timed()
    else:
        t = timed()

    cycle_nnz = 0
    for lvl in h.levels[:-1]:
        cycle_nnz += 3 * lvl.A.nnz
        if lvl.P is not None:
            cycle_nnz += lvl.P.nnz + lvl.R.nnz
    cycle_nnz += h.nc * h.nc
    return {
        "cycle": cycle,
        "t_cycle_s": t,
        "cycle_nnz": int(cycle_nnz),
        "gnnz_per_s": cycle_nnz / t / 1e9,
    }


def profile_levels(dml, repeats=5):
    """Per-level, per-op timing breakdown of a compiled hierarchy.

    For every level: operator SpMV, presmoother sweep and one transfer
    apply (the average of an R-then-P roundtrip), each a jitted call
    timed to ``block_until_ready`` after one warm-up call.  Returns a
    list of per-level dicts (median seconds per application).  The
    where-does-the-cycle-time-go tool (SURVEY.md §5 profiling analog).
    """
    import time as _time

    h = dml.hierarchy

    def timed(step, v0):
        fn = jax.jit(step)
        jax.block_until_ready(fn(h, v0))
        ts = []
        for _ in range(repeats):
            t0 = _time.perf_counter()
            jax.block_until_ready(fn(h, v0))
            ts.append(_time.perf_counter() - t0)
        return float(np.median(ts))

    out = []
    for i, lvl in enumerate(h.levels):
        v = jnp.ones(lvl.n_pad, dtype=h.dtype)
        entry = {"level": i, "n": int(lvl.n), "nnz": int(lvl.A.nnz),
                 "format": type(lvl.A).__name__}
        entry["t_spmv_s"] = timed(
            lambda hh, u, i=i: _fitv(hh.levels[i].A @ u, u.shape[0]), v)
        entry["t_presmooth_s"] = timed(
            lambda hh, u, i=i: hh.levels[i].pre(hh.levels[i].A, u, u), v)
        if lvl.R is not None:
            nc_pad = h.levels[i + 1].n_pad
            entry["t_transfer_s"] = timed(
                lambda hh, u, i=i, nc=nc_pad: _fitv(
                    hh.levels[i].P
                    @ _fitv(hh.levels[i].R @ u, nc), u.shape[0]), v) / 2
        out.append(entry)
    return out

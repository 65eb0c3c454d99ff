"""Smoke run of pyamg_tpu's main solve paths on one NVIDIA GPU.

    python chip_smoke.py            # every phase below, one card
    python chip_smoke.py --multi    # the row-partitioned solve, four cards

Phases (one process; each phase is a plain function of its size, so the
CPU tests call them small):

1. device check: the first JAX device must be a GPU, else exit non-zero;
   the card's name and power limit come from ``nvidia-smi`` in a child
   process that does not import JAX;
2. operator parity at real width (2-D Poisson 2048^2) against scipy in
   float64, in f32 and f64: DIA matvec/rmatvec/matmat_k, the Jacobi
   sweep and the zero-entry sweep + residual the cycle runs, the
   structured P and R applies, the host-built hierarchy's windowed P and
   R, the dense coarse apply; the XLA SpMV's and Jacobi sweep's bytes/s
   against a device copy of the same bytes, and the restriction stored
   explicitly (gather) against the lazy transpose (scatter-add);
3. config 1 host-built: SA + Jacobi, mixed-precision CG to a true f64
   relative residual <= 1e-8, run twice (histories must be identical),
   iterations within 1 of the host scipy solve of the same hierarchy;
4. config 1 device-built (``device_sa_setup``), same checks;
5. ``MultilevelSolver.solve(backend='device')`` (native f64) to 1e-8;
6. K=8 right-hand sides through ``dml.solve(B)`` (vmapped K-major
   route), each column against its single-RHS solve;
7. the other device setups: block SA on elasticity 128^2, classical RS
   on recirculating flow 1024^2 with FGMRES, unstructured SA on a P1
   mesh of 640k dofs.

Every printed line carries the card's name and power limit.  The last
line of standard output is one JSON object with the device as JAX
reports it.  Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time

import numpy as np
import scipy.sparse as sp

import jax

jax.config.update("jax_enable_x64", True)   # before any array exists

import jax.numpy as jnp  # noqa: E402

F32, F64 = jnp.float32, jnp.float64
TOL = {F32: 1e-5, F64: 1e-12}     # relative 2-norm error vs scipy f64
CARD = "card not queried"


def log(phase, **kv):
    print(f"[{CARD}] {phase}: "
          + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_info():
    """``name, power.limit`` from nvidia-smi, read by a child process
    that does not import JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else "nvidia-smi printed nothing"


def device_check(count=1):
    """Phase 1: refuse anything but a GPU (no CPU fallback)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (JAX platform "
            f"{devs[0].platform!r}); nothing was run")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: {count} GPUs needed, "
                         f"{len(devs)} found")
    return devs


def relerr(got, want):
    got = np.asarray(got, dtype=np.result_type(got, np.float64))
    want = np.asarray(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-300))


def true_relres(A, b, x):
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def time_calls(fn, *args, reps=20, trials=5):
    """Median seconds per call: ``reps`` calls enqueued back to back,
    then one block_until_ready; the first call compiles and warms."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / reps)
    return float(np.median(ts))


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def _cast(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _poisson(n):
    from pyamg_tpu.gallery import poisson

    return poisson((n, n), format="csr")


@functools.lru_cache(maxsize=None)
def host_ml(n):
    """Config 1 host setup: SA with Jacobi smoothing on Poisson n^2."""
    import pyamg_tpu

    A = _poisson(n)
    t0 = time.perf_counter()
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    return A, ml, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def host_dml(n):
    """The host-built hierarchy compiled to the device (f32 cycle, f64
    finest operator for the mixed-precision outer loop)."""
    from pyamg_tpu.engine import as_device_solver

    _, ml, _ = host_ml(n)
    t0 = time.perf_counter()
    dml = as_device_solver(ml, mixed_precision=True)
    jax.block_until_ready(dml.hierarchy)
    return dml, time.perf_counter() - t0


def build_device_sa(n):
    """Config 1 device-built: ``device_sa_setup`` on the 5-point
    stencil built on device.  Returns (dsa, seconds)."""
    from pyamg_tpu.engine import device_sa_setup
    from pyamg_tpu.sparse import dia_from_stencil

    S = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], dtype=float)
    t0 = time.perf_counter()
    Ad = dia_from_stencil(S, (n, n), dtype=F32)
    dsa = device_sa_setup(Ad, grid=(n, n), dtype=F32)
    jax.block_until_ready(dsa.hierarchy)
    return dsa, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def device_sa(n):
    """The first (compiling) device_sa_setup call, kept for reuse."""
    return build_device_sa(n)


def dia_to_scipy(D):
    """scipy CSR of a DIAMatrix (f64), for reference applies."""
    data = np.asarray(D.data, dtype=np.float64)
    n = D.n_pad
    rows, cols, vals = [], [], []
    i = np.arange(n)
    for d, off in enumerate(D.offsets):
        j = i + off
        ok = (j >= 0) & (j < n) & (data[d] != 0)
        rows.append(i[ok])
        cols.append(j[ok])
        vals.append(data[d][ok])
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


def structured_reference(P):
    """scipy P = S @ T for a StructuredProlongator, built from its
    smoothing factor S and tentative values tv with numpy: T[f, c] =
    tv[f] for the aggregate c of fine point f.  Columns index the
    unpadded coarse grid."""
    fg = tuple(P.fine_grid_p)
    cg = tuple(P.coarse_grid)
    ss = (P.stride if isinstance(P.stride, tuple)
          else (P.stride,) * len(fg))
    nf = int(np.prod(fg))
    coords = np.unravel_index(np.arange(nf), fg)
    agg = np.ravel_multi_index(tuple(c // s for c, s in zip(coords, ss)),
                               cg)
    tv = np.asarray(P.tv, dtype=np.float64)[:nf]
    T = sp.csr_matrix((tv, (np.arange(nf), agg)),
                      shape=(nf, int(np.prod(cg))))
    S = dia_to_scipy(P.S)[:nf, :nf]
    return (S @ T).tocsr()


def _embed_coarse(xc, P):
    """Coarse unpadded-grid vector -> the coarse padded-grid layout."""
    cg, cgp = tuple(P.coarse_grid), tuple(P.coarse_grid_p)
    v = xc.reshape(cg)
    return np.pad(v, [(0, b - a) for a, b in zip(cg, cgp)]).ravel()


def _unembed_coarse(yc, P):
    cg, cgp = tuple(P.coarse_grid), tuple(P.coarse_grid_p)
    return np.asarray(yc)[: int(np.prod(cgp))].reshape(cgp)[
        tuple(slice(0, a) for a in cg)].ravel()


# ---------------------------------------------------------------------------
# phase 2: operator parity and bandwidth
# ---------------------------------------------------------------------------

def phase_operators(n, K=4, measure=True):
    """Each op the cycle runs, in f32 and f64, against scipy in f64."""
    from pyamg_tpu.engine import relaxation as rx
    from pyamg_tpu.sparse import dia_from_scipy
    from pyamg_tpu.sparse.window import TransposedWindowed

    A, ml, _ = host_ml(n)
    rng = np.random.default_rng(0)
    out = {}
    for dt in (F32, F64):
        name = jnp.dtype(dt).name
        tol = TOL[dt]
        D = dia_from_scipy(A, dtype=dt)
        npd = D.n_pad
        As = sp.csr_matrix(A, shape=A.shape)
        As.resize((npd, npd))

        def dev(v, dt=dt):
            return jnp.asarray(v, dtype=dt)

        def host(v, dt=dt):    # the device input, exactly, in f64
            return np.asarray(jnp.asarray(v, dtype=dt), dtype=np.float64)

        x, b = host(rng.random(npd)), host(rng.random(npd))
        X = host(rng.random((K, npd)))
        diag = As.diagonal()
        dinv = host(np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1),
                             0))
        omega = 0.8
        sm = rx.jacobi(dev(dinv), omega)
        errs = {
            "dia_matvec": relerr(jax.jit(lambda D, v: D.matvec(v))(
                D, dev(x)), As @ x),
            "dia_rmatvec": relerr(jax.jit(lambda D, v: D.rmatvec(v))(
                D, dev(x)), As.T @ x),
            "dia_matmat_k": relerr(jax.jit(lambda D, V: D.matmat_k(V))(
                D, dev(X)), (As @ X.T).T),
            "jacobi_sweep": relerr(jax.jit(lambda s, D, v, w: s(D, v, w))(
                sm, D, dev(x), dev(b)),
                x + omega * dinv * (b - As @ x)),
        }
        x0, r0 = jax.jit(lambda s, D, w: (lambda z: (z, w - D @ z))(
            s.zero_call(D, w)))(sm, D, dev(b))
        x0_ref = omega * dinv * b
        errs["jacobi_zero_entry"] = relerr(x0, x0_ref)
        errs["zero_entry_residual"] = relerr(r0, b - As @ host(x0))

        # structured P and R of the device-built hierarchy (f32 build;
        # the f64 check applies the same operator cast to f64)
        dsa, _ = device_sa(n)
        lvl = dsa.hierarchy.levels[0]
        Pd, Rd = _cast(lvl.P, dt), _cast(lvl.R, dt)
        Pref = structured_reference(Pd)
        xc = host(rng.random(Pref.shape[1]))
        errs["structured_P"] = relerr(
            np.asarray(jax.jit(lambda P, v: P @ v)(
                Pd, dev(_embed_coarse(xc, Pd))))[: Pref.shape[0]],
            Pref @ xc)
        r = host(rng.random(Pd.S.n_pad))
        errs["structured_R"] = relerr(
            _unembed_coarse(jax.jit(lambda R, v: R @ v)(Rd, dev(r)), Pd),
            Pref.T @ r[: Pref.shape[0]])

        # the host-built hierarchy's transfers and dense coarse apply
        h = (host_dml(n)[0].hierarchy if dt == F32
             else ml.to_device(dtype=F64).hierarchy)
        l0 = h.levels[0]
        Ph, Rh = ml.levels[0].P, ml.levels[0].R
        xc = host(rng.random(Ph.shape[1]))
        errs["hostbuilt_P"] = relerr(
            np.asarray(jax.jit(lambda P, v: P @ v)(l0.P, dev(xc)))[
                : Ph.shape[0]], Ph @ xc)
        r = host(rng.random(l0.n_pad))
        errs["hostbuilt_R"] = relerr(
            np.asarray(jax.jit(lambda R, v: R @ v)(l0.R, dev(r)))[
                : Rh.shape[0]], Rh @ r[: Rh.shape[1]])
        Lc = h.levels[-1]
        Ac = sp.csr_matrix(ml.levels[len(h.levels) - 1].A)
        xcc = host(rng.random(Lc.A.n_pad))
        errs["dense_coarse"] = relerr(
            np.asarray(jax.jit(lambda M, v: M @ v)(Lc.A, dev(xcc)))[
                : Ac.shape[0]], Ac @ xcc[: Ac.shape[1]])
        log("phase2", precision=name, tolerance=tol,
            **{k: repr(v) for k, v in errs.items()})
        for k, v in errs.items():
            check(v <= tol, f"{name} {k} relative error {v} > {tol}")
        out[name] = errs

    if not measure:
        return out

    # bandwidth: XLA forms against a device copy of the same bytes
    D = dia_from_scipy(A, dtype=F32)
    npd, nd = D.n_pad, D.ndiags
    x = jnp.asarray(rng.random(npd), dtype=F32)
    b = jnp.asarray(rng.random(npd), dtype=F32)
    diag = np.asarray(D.diagonal())
    sm = rx.jacobi(jnp.asarray(np.where(diag != 0, 1 / diag, 0), F32), 0.8)
    spmv = jax.jit(lambda D, v: D.matvec(v))
    sweep = jax.jit(lambda s, D, v, w: s(D, v, w))
    scale = jax.jit(lambda v, s: v * s)
    t_spmv = time_calls(spmv, D, x)
    t_jac = time_calls(sweep, sm, D, x, b)
    bytes_spmv = (nd + 2) * npd * 4
    bytes_jac = (nd + 4) * npd * 4
    buf = jnp.ones(bytes_spmv // 8, dtype=F32)
    t_copy = time_calls(scale, buf, jnp.asarray(1.0001, F32))
    copy_bps = 2 * buf.size * 4 / t_copy
    bw = {"copy_GBps": copy_bps / 1e9,
          "spmv_s": t_spmv, "spmv_GBps": bytes_spmv / t_spmv / 1e9,
          "spmv_share_of_copy": bytes_spmv / t_spmv / copy_bps,
          "jacobi_s": t_jac, "jacobi_GBps": bytes_jac / t_jac / 1e9,
          "jacobi_share_of_copy": bytes_jac / t_jac / copy_bps}
    log("phase2 bandwidth f32", n=npd, ndiags=nd,
        **{k: repr(v) for k, v in bw.items()})
    out["bandwidth"] = bw

    # restriction storage: explicit gather form against the scatter-add
    # transpose of P's windowed tentative factor (the old default)
    dml, _ = host_dml(n)
    l0 = dml.hierarchy.levels[0]
    T_w = l0.P.ops[-1]
    Tt_w = l0.R.ops[0]
    T_h = ml.levels[0].P._sa_factor["T"]
    r = jnp.asarray(rng.random(T_w.n_pad), dtype=F32)
    r_h = np.asarray(r, dtype=np.float64)[: T_h.shape[0]]
    gather = jax.jit(lambda W, v: W.matvec(v))
    scatter = jax.jit(lambda W, v: TransposedWindowed(W).matvec(v))
    rs = {}
    for label, fn, op in (("gather", gather, Tt_w),
                          ("scatter", scatter, T_w)):
        runs = [np.asarray(fn(op, r)) for _ in range(3)]
        rs[f"{label}_relerr"] = relerr(runs[0][: T_h.shape[1]],
                                       T_h.T @ r_h)
        rs[f"{label}_bitwise_repeat"] = all(
            np.array_equal(runs[0], v) for v in runs[1:])
        rs[f"{label}_s"] = time_calls(fn, op, r)
        check(rs[f"{label}_relerr"] <= TOL[F32],
              f"restriction {label} error {rs[f'{label}_relerr']}")
    log("phase2 restriction storage f32", **{k: repr(v)
                                              for k, v in rs.items()})
    check(rs["gather_bitwise_repeat"], "gather restriction not repeatable")
    out["restriction"] = rs
    return out


# ---------------------------------------------------------------------------
# phases 3-6: config 1 solves
# ---------------------------------------------------------------------------

def _twice(solve, A, b, tol):
    """Solve twice; check the true residual and identical histories."""
    r1, r2 = [], []
    x1, t1 = timed(solve, b, residuals=r1)
    x2, t2 = timed(solve, b, residuals=r2)
    rel = true_relres(A, b, np.asarray(x2))
    same = (len(r1) == len(r2)
            and np.array_equal(np.asarray(r1), np.asarray(r2)))
    check(rel <= tol, f"true relative residual {rel} > {tol}")
    check(same, "residual histories of two identical solves differ")
    return {"first_call_s": t1, "solve_s": t2, "iterations": len(r2) - 1,
            "true_relres": rel, "histories_identical": same}


def phase_host_built(n, tol=1e-8):
    """Config 1 host-built: mixed CG to a true f64 relres <= tol."""
    A, ml, t_setup = host_ml(n)
    dml, t_compile = host_dml(n)
    b = np.random.default_rng(1).random(A.shape[0])
    res = _twice(lambda v, residuals: dml.solve(
        v, tol=tol, accel="cg", precision="mixed", residuals=residuals),
        A, b, tol)
    rh = []
    ml.solve(b, tol=tol, accel="cg", residuals=rh)
    res.update(host_setup_s=t_setup, hierarchy_to_device_s=t_compile,
               host_iterations=len(rh) - 1,
               levels=len(dml.hierarchy.levels))
    log("phase3 config1 host-built", n=A.shape[0],
        **{k: repr(v) for k, v in res.items()})
    check(abs(res["iterations"] - res["host_iterations"]) <= 1,
          "device iterations differ from the host solve by more than 1")
    return res


def phase_device_built(n, tol=1e-8):
    """Config 1 device-built (device_sa_setup), mixed CG to tol."""
    from pyamg_tpu.engine import device_sa_setup

    A = _poisson(n)
    _, t_first = device_sa(n)
    _, t_warm = build_device_sa(n)
    # the mixed outer loop needs the f64 finest operator
    dsa = device_sa_setup(A, grid=(n, n), dtype=F32, mixed_precision=True)
    b = np.random.default_rng(2).random(A.shape[0])
    res = _twice(lambda v, residuals: dsa.solve(
        v, tol=tol, accel="cg", precision="mixed", residuals=residuals),
        A, b, tol)
    res.update(setup_first_call_s=t_first, setup_warm_s=t_warm,
               levels=len(dsa.hierarchy.levels))
    log("phase4 config1 device-built", n=A.shape[0],
        **{k: repr(v) for k, v in res.items()})
    return res


def phase_backend_device(n, tol=1e-8):
    """MultilevelSolver.solve(backend='device'): native f64 on device."""
    A, ml, _ = host_ml(n)
    b = np.random.default_rng(3).random(A.shape[0])
    res = _twice(lambda v, residuals: ml.solve(
        v, tol=tol, accel="cg", backend="device", residuals=residuals),
        A, b, tol)
    log("phase5 backend=device f64", n=A.shape[0],
        **{k: repr(v) for k, v in res.items()})
    return res


def phase_batched(n, K=8, tol=1e-8):
    """K right-hand sides through the vmapped K-major route, each column
    against its single-RHS solve."""
    A, _, _ = host_ml(n)
    dml, _ = host_dml(n)
    B = np.random.default_rng(4).random((A.shape[0], K))

    def batched(hists=None):
        return dml.solve(B, tol=tol, accel="cg", precision="mixed",
                         residuals=hists)

    hists = []
    _, t_first = timed(batched)
    X, t_batch = timed(batched, hists)
    rels, dx, dit = [], [], []
    t_single = 0.0
    for j in range(K):
        r1 = []
        x1, t = timed(dml.solve, B[:, j], tol=tol, accel="cg",
                      precision="mixed", residuals=r1)
        t_single += t
        rels.append(true_relres(A, B[:, j], X[:, j]))
        dx.append(relerr(X[:, j], x1))
        dit.append(abs(len(hists[j]) - len(r1)))
    res = {"K": K, "first_call_s": t_first, "batched_s": t_batch,
           "single_solves_s": t_single,
           "batched_over_single": t_batch / t_single,
           "max_true_relres": max(rels), "max_column_diff": max(dx),
           "max_iteration_diff": max(dit),
           "iterations": [len(hh) - 1 for hh in hists]}
    log("phase6 batched vmapped", n=A.shape[0],
        **{k: repr(v) for k, v in res.items()})
    check(max(rels) <= tol, f"batched true relres {max(rels)} > {tol}")
    check(max(dit) <= 1, "batched and single iteration counts differ")
    check(max(dx) <= 1e-5, f"batched column differs by {max(dx)}")
    return res


# ---------------------------------------------------------------------------
# phase 7: the other device setups
# ---------------------------------------------------------------------------

def _setup_and_solve(name, build, A, b, tol, **solve_kw):
    """Build twice (first call compiles; setups with scatter-adds may
    differ run to run), solve each, check the true residual."""
    out = {}
    for run in (1, 2):
        t0 = time.perf_counter()
        dev = build()
        jax.block_until_ready(dev.hierarchy)
        t_setup = time.perf_counter() - t0
        hist = []
        _, t_first = timed(dev.solve, b, tol=tol, precision="mixed",
                           **solve_kw)
        x, t_solve = timed(dev.solve, b, tol=tol, precision="mixed",
                           residuals=hist, **solve_kw)
        rel = true_relres(A, b, np.asarray(x))
        out[f"run{run}"] = {"setup_s": t_setup,
                            "solve_first_call_s": t_first,
                            "solve_s": t_solve,
                            "iterations": len(hist) - 1,
                            "true_relres": rel}
        out[f"_hist{run}"] = np.asarray(hist)
        check(rel <= tol, f"{name} true relres {rel} > {tol}")
    out["histories_identical"] = bool(
        np.array_equal(out.pop("_hist1"), out.pop("_hist2")))
    log(f"phase7 {name}", n=A.shape[0], tol=tol,
        **{k: repr(v) for k, v in out.items()})
    return out


def phase_other_setups(n_elastic=128, n_recirc=1024, n_mesh=800,
                       tol=1e-8):
    from pyamg_tpu.engine import (device_rs_setup, device_sa_setup_block,
                                  device_unstructured_sa_setup)
    from pyamg_tpu.gallery import (gradgradform, linear_elasticity,
                                   recirc_flow, regular_triangle_mesh)

    rng = np.random.default_rng(5)
    res = {}
    A4, B4 = linear_elasticity((n_elastic, n_elastic))
    grid4 = (n_elastic, A4.shape[0] // (2 * n_elastic))
    res["block_elasticity"] = _setup_and_solve(
        "block SA elasticity", lambda: device_sa_setup_block(
            A4, grid=grid4, B=B4, max_coarse=400, mixed_precision=True),
        A4.tocsr(), rng.random(A4.shape[0]), tol, accel="cg", maxiter=100)
    A5 = recirc_flow((n_recirc, n_recirc), epsilon=1e-2).tocsr()
    res["rs_recirc"] = _setup_and_solve(
        "classical RS recirculating flow", lambda: device_rs_setup(
            A5, grid=(n_recirc, n_recirc), max_coarse=400,
            mixed_precision=True),
        A5, rng.random(A5.shape[0]), tol, accel="fgmres", maxiter=300)
    V, E = regular_triangle_mesh(n_mesh, n_mesh)
    A6 = sp.csr_matrix(gradgradform(V, E))
    A6 = (A6 + 1e-2 * sp.eye(A6.shape[0], format="csr")).tocsr()
    res["unstructured_p1"] = _setup_and_solve(
        "unstructured SA P1 mesh", lambda: device_unstructured_sa_setup(
            A6, mixed_precision=True),
        A6, rng.random(A6.shape[0]), tol, accel="cg", maxiter=100)
    return res


# ---------------------------------------------------------------------------
# --multi: the row-partitioned solve on four cards
# ---------------------------------------------------------------------------

def phase_multi(n, ndev=4, tol=1e-8, rtol=1e-9):
    """Config 1 host-built in f64: single-card V+CG against the same
    hierarchy row-sharded over ``ndev`` cards."""
    from pyamg_tpu.engine import DeviceMultilevelSolver, compile_hierarchy
    from pyamg_tpu.parallel import (make_halo_dia_spmv, make_solver_mesh,
                                    shard_hierarchy)

    A, ml, _ = host_ml(n)
    h1 = compile_hierarchy(ml, dtype=F64, row_pad=8 * ndev)
    mesh = make_solver_mesh(ndev)
    hs = shard_hierarchy(h1, mesh)
    b = np.random.default_rng(6).random(A.shape[0])
    out = {}
    hists = {}
    for label, h in (("single", h1), ("sharded", hs)):
        dml = DeviceMultilevelSolver(h)
        r = []
        x, t_first = timed(dml.solve, b, tol=tol, accel="cg", residuals=r)
        x, t = timed(dml.solve, b, tol=tol, accel="cg", residuals=[])
        hists[label] = np.asarray(r)
        out[label] = {"first_call_s": t_first, "solve_s": t,
                      "iterations": len(r) - 1,
                      "true_relres": true_relres(A, b, np.asarray(x))}
        check(out[label]["true_relres"] <= tol,
              f"{label} true relres {out[label]['true_relres']}")
    check(len(hists["single"]) == len(hists["sharded"]),
          "sharded and single iteration counts differ")
    dev_h = float(np.max(np.abs(hists["sharded"] - hists["single"])
                         / hists["single"]))
    out["history_max_rel_diff"] = dev_h
    check(dev_h <= rtol, f"sharded history differs by {dev_h} > {rtol}")

    # collectives in the compiled sharded solve
    dml = DeviceMultilevelSolver(hs)
    fn = dml._get_compiled("V", "cg", 100, 30)
    n_pad = hs.levels[0].n_pad
    bd = jnp.pad(jnp.asarray(b), (0, n_pad - A.shape[0]))
    hlo = fn.lower(hs, bd, jnp.zeros_like(bd),
                   jnp.asarray(tol)).compile().as_text()
    out["hlo_collective_permute"] = "collective-permute" in hlo
    out["hlo_all_reduce"] = "all-reduce" in hlo
    check(out["hlo_collective_permute"], "no collective-permute in HLO")
    check(out["hlo_all_reduce"], "no all-reduce in HLO")

    # every level's operator spans all cards (sharded or replicated)
    alldev = set(mesh.devices.flat)
    spans = [len(jax.tree_util.tree_leaves(lvl.A)[0].sharding.device_set)
             for lvl in hs.levels]
    out["level_device_counts"] = spans
    check(all(jax.tree_util.tree_leaves(lvl.A)[0].sharding.device_set
              == alldev for lvl in hs.levels),
          "a level's operator does not span every card")

    # explicit ppermute halo SpMV against scipy
    from jax.sharding import NamedSharding, PartitionSpec as P

    D = h1.levels[0].A
    spmv, place = make_halo_dia_spmv(D, mesh)
    data = jax.device_put(D.data, NamedSharding(mesh, P(None, "x")))
    xh = np.random.default_rng(7).random(D.n_pad)
    out["halo_spmv_relerr"] = relerr(
        np.asarray(spmv(data, place(jnp.asarray(xh))))[: A.shape[0]],
        A @ xh[: A.shape[0]])
    check(out["halo_spmv_relerr"] <= TOL[F64], "halo SpMV mismatch")
    log(f"multi {ndev} cards config1 f64", n=A.shape[0],
        **{k: repr(v) for k, v in out.items()})
    return out


def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card row-partitioned solve")
    ap.add_argument("--n", type=int, default=2048,
                    help="Poisson grid side for config 1 (default 2048)")
    args = ap.parse_args(argv)
    ndev = 4 if args.multi else 1
    devs = device_check(ndev)
    CARD = card_info()
    print(f"nvidia-smi name, power.limit: {CARD}", flush=True)

    from pyamg_tpu.amg_core import _loader
    from pyamg_tpu.compile_cache import enable_compile_cache

    log("phase1 device", platform=devs[0].platform,
        kind=repr(devs[0].device_kind), count=len(devs),
        compile_cache=enable_compile_cache(),
        amg_core=("native" if _loader.get_native() is not None
                  else "numpy fallback"))
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(args.n, ndev)
    else:
        phase_operators(args.n)
        phase_host_built(args.n)
        phase_device_built(args.n)
        phase_backend_device(args.n)
        phase_batched(args.n)
        phase_other_setups()
    log("done", wall_s=repr(time.perf_counter() - t0))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()

"""Benchmark of the five BASELINE.json configs on one NVIDIA GPU.

    python bench.py [--grid N]

For each config the hierarchy is built on the host (the scipy/C++ path)
and, where a device setup exists, on the device; then the
mixed-precision device solve (f32 cycle, f64 outer Krylov loop) runs to
a true 1e-8 relative residual, checked in f64 on the host.  Times come
from the host clock around the real call ending in block_until_ready,
after one untimed call that compiles.  Config 1 also reports the
V-cycle and the finest SpMV.  One line per config, then one JSON line
with everything, device and card included.  Without a GPU the script
exits non-zero; it never falls back to the CPU or shrinks a grid.

Cells, regression bounds and trace-derived per-layer metrics are the
benchmark redesign's job (ROADMAP S1).
"""

from __future__ import annotations

import argparse
import json
import time
import warnings

import numpy as np

import jax
import jax.numpy as jnp

from chip_smoke import (card_info, device_check, time_calls, timed,
                        true_relres)

TOL = 1e-8


def _solve(solver, A, b, **kw):
    """Compile (untimed), then time one solve; check the true residual."""
    solver.solve(b, tol=TOL, precision="mixed", **kw)
    res = []
    x, t = timed(solver.solve, b, tol=TOL, precision="mixed",
                 residuals=res, **kw)
    rel = true_relres(A, b, np.asarray(x))
    return {"solve_s": t, "iterations": len(res) - 1, "true_relres": rel,
            "converged": rel <= TOL}


def _setup(build):
    """(solver, first-call seconds, warm seconds) of a device setup."""
    _, t_first = timed(lambda: build().hierarchy)
    t0 = time.perf_counter()
    solver = build()
    jax.block_until_ready(solver.hierarchy)
    return solver, t_first, time.perf_counter() - t0


def _host(build):
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ml = build()
    return ml, time.perf_counter() - t0


def _to_device(ml):
    from pyamg_tpu.engine import as_device_solver

    dml, t = timed(lambda: as_device_solver(ml, mixed_precision=True))
    return dml, t


def config1(n):
    import pyamg_tpu
    from pyamg_tpu.engine import device_sa_setup
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.sparse import dia_from_stencil

    A = poisson((n, n), format="csr")
    ml, t_host = _host(lambda: pyamg_tpu.smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0})))
    dml, t_dev = _to_device(ml)
    b = np.random.default_rng(0).random(A.shape[0])
    out = {"problem": f"2D Poisson {n}^2, SA + Jacobi, CG", "n": A.shape[0],
           "host_setup_s": t_host, "to_device_s": t_dev,
           **_solve(dml, A, b, accel="cg")}
    h = dml.hierarchy
    r = jnp.ones(h.levels[0].n_pad, dtype=h.dtype)
    out["vcycle_s"] = time_calls(dml.cycle_operator("V"), r)
    A0 = h.levels[0].A
    out["spmv_s"] = time_calls(jax.jit(lambda M, v: M @ v), A0, r)
    out["spmv_GBps"] = (A0.ndiags + 2) * A0.n_pad * 4 / out["spmv_s"] / 1e9
    S = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], dtype=float)
    dsa, t1, t2 = _setup(lambda: device_sa_setup(
        dia_from_stencil(S, (n, n), dtype=jnp.float32), grid=(n, n)))
    dsa = device_sa_setup(A, grid=(n, n), mixed_precision=True)
    out["device_built"] = {"setup_first_call_s": t1, "setup_s": t2,
                           **_solve(dsa, A, b, accel="cg")}
    return out


def config2():
    import pyamg_tpu
    from pyamg_tpu.engine import device_sa_setup
    from pyamg_tpu.gallery import poisson

    A = poisson((64, 64, 64), format="csr")
    ml, t_host = _host(lambda: pyamg_tpu.smoothed_aggregation_solver(
        A, presmoother=("gauss_seidel", {"sweep": "symmetric"}),
        postsmoother=("gauss_seidel", {"sweep": "symmetric"})))
    dml, t_dev = _to_device(ml)
    b = np.random.default_rng(1).random(A.shape[0])
    out = {"problem": "3D Poisson 64^3, SA + symmetric GS, W-cycle",
           "n": A.shape[0], "host_setup_s": t_host, "to_device_s": t_dev,
           **_solve(dml, A, b, cycle="W", maxiter=30)}
    dsa, t1, t2 = _setup(lambda: device_sa_setup(
        A, grid=(64, 64, 64), max_coarse=400, mixed_precision=True))
    out["device_built"] = {"setup_first_call_s": t1, "setup_s": t2,
                           **_solve(dsa, A, b, cycle="W", accel="cg",
                                    maxiter=40)}
    return out


def config3():
    import pyamg_tpu
    from pyamg_tpu.engine import device_rs_setup, device_sa_setup
    from pyamg_tpu.gallery import diffusion_stencil_2d, stencil_grid

    A = stencil_grid(diffusion_stencil_2d(epsilon=1e-3, theta=0.0,
                                          type="FD"), (512, 512)).tocsr()
    ml, t_host = _host(lambda: pyamg_tpu.ruge_stuben_solver(A))
    dml, t_dev = _to_device(ml)
    b = np.random.default_rng(2).random(A.shape[0])
    out = {"problem": "anisotropic diffusion 512^2 (eps=1e-3), RS, GMRES",
           "n": A.shape[0], "host_setup_s": t_host, "to_device_s": t_dev,
           **_solve(dml, A, b, accel="gmres", maxiter=60)}
    dsa, t1, t2 = _setup(lambda: device_sa_setup(
        A, grid=(512, 512), max_coarse=400, stride="auto",
        mixed_precision=True))
    out["device_built_sa"] = {"setup_first_call_s": t1, "setup_s": t2,
                              **_solve(dsa, A, b, accel="cg", maxiter=60)}
    drs, t1, t2 = _setup(lambda: device_rs_setup(
        A, grid=(512, 512), max_coarse=400, mixed_precision=True))
    out["device_built_rs"] = {"setup_first_call_s": t1, "setup_s": t2,
                              **_solve(drs, A, b, accel="cg", maxiter=60)}
    return out


def config4():
    import pyamg_tpu
    from pyamg_tpu.engine import device_sa_setup_block
    from pyamg_tpu.gallery import linear_elasticity

    A, B = linear_elasticity((128, 128))
    ml, t_host = _host(lambda: pyamg_tpu.rootnode_solver(
        A, B=B, strength="symmetric"))
    dml, t_dev = _to_device(ml)
    b = np.random.default_rng(3).random(A.shape[0])
    Ac = A.tocsr()
    out = {"problem": "2D elasticity 128^2 (BSR bs=2), rootnode SA, CG",
           "n": A.shape[0], "host_setup_s": t_host, "to_device_s": t_dev,
           **_solve(dml, Ac, b, accel="cg", maxiter=60)}
    dsb, t1, t2 = _setup(lambda: device_sa_setup_block(
        A, grid=(128, A.shape[0] // 256), B=B, max_coarse=400,
        mixed_precision=True))
    out["device_built"] = {"setup_first_call_s": t1, "setup_s": t2,
                           **_solve(dsb, Ac, b, accel="cg", maxiter=100)}
    return out


def config5():
    import pyamg_tpu
    from pyamg_tpu.engine import device_rs_setup
    from pyamg_tpu.gallery import recirc_flow

    A = recirc_flow((1024, 1024), epsilon=1e-2).tocsr()
    ml, t_host = _host(lambda: pyamg_tpu.smoothed_aggregation_solver(
        A, symmetry="nonsymmetric", strength="symmetric",
        smooth=("energy", {"krylov": "gmres", "maxiter": 3, "degree": 1}),
        improve_candidates=(("gauss_seidel_nr",
                             {"sweep": "symmetric", "iterations": 4}),
                            None),
        presmoother=("gauss_seidel_nr", {"sweep": "symmetric",
                                         "iterations": 2}),
        postsmoother=("gauss_seidel_nr", {"sweep": "symmetric",
                                          "iterations": 2})))
    dml, t_dev = _to_device(ml)
    b = np.random.default_rng(4).random(A.shape[0])
    out = {"problem": "recirculating flow 1024^2, nonsymmetric energy SA, "
                      "BiCGStab", "n": A.shape[0], "host_setup_s": t_host,
           "to_device_s": t_dev,
           **_solve(dml, A, b, accel="bicgstab", maxiter=100)}
    drs, t1, t2 = _setup(lambda: device_rs_setup(
        A, grid=(1024, 1024), max_coarse=400, mixed_precision=True))
    out["device_built_rs"] = {"setup_first_call_s": t1, "setup_s": t2,
                              **_solve(drs, A, b, accel="fgmres",
                                       maxiter=300)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=2048,
                    help="config 1 grid side (default 2048)")
    args = ap.parse_args(argv)
    devs = device_check()
    card = card_info()
    from pyamg_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(f"nvidia-smi name, power.limit: {card}", flush=True)
    detail = {"device": {"platform": devs[0].platform,
                         "kind": devs[0].device_kind, "count": len(devs)},
              "card": card}
    for name, fn in (("config1", lambda: config1(args.grid)),
                     ("config2", config2), ("config3", config3),
                     ("config4", config4), ("config5", config5)):
        detail[name] = fn()
        print(f"[{card}] {name}: {json.dumps(detail[name], default=float)}",
              flush=True)
    print(json.dumps(detail, default=float))


if __name__ == "__main__":
    main()

"""BASELINE.json:7-11 acceptance configs (SURVEY.md §7 step 8).

The five driver configs, at test-friendly sizes (same operators and
solver configurations; bench.py runs full sizes on the GPU).  Acceptance is
behavioral: convergence factors in the reference's asserted ranges
(SURVEY.md §6) and 1e-8 relative residuals.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

import pyamg_tpu
from pyamg_tpu.engine import DeviceMultilevelSolver, compile_hierarchy
from pyamg_tpu.gallery import (
    diffusion_stencil_2d,
    linear_elasticity,
    poisson,
    recirc_flow,
    stencil_grid,
)


def factor(res):
    res = np.asarray(res)
    return (res[-1] / res[0]) ** (1.0 / max(len(res) - 1, 1))


def test_config1_poisson2d_sa_cg_jacobi():
    """2D 5-pt Poisson 256x256, SA V-cycle + CG, Jacobi relaxation."""
    A = poisson((256, 256), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A,
        presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}),
    )
    b = np.random.default_rng(0).random(A.shape[0])
    res = []
    x = ml.solve(b, tol=1e-8, accel="cg", residuals=res)
    assert res[-1] / res[0] < 1e-8
    assert len(res) - 1 <= 25
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7
    assert ml.operator_complexity() < 1.5
    # device engine (virtual CPU) parity: same config through the jitted path
    dml = DeviceMultilevelSolver(
        compile_hierarchy(ml, dtype=jnp.float64, row_pad=8))
    res_d = []
    xd = dml.solve(b, tol=1e-8, maxiter=40, accel="cg", residuals=res_d)
    assert np.linalg.norm(b - A @ xd) / np.linalg.norm(b) < 1e-7
    assert abs(len(res_d) - len(res)) <= 3  # same convergence behavior


def test_config2_poisson3d_sa_gs_wcycle():
    """3D 7-pt Poisson (64^3 in bench; 24^3 here), SA + symmetric GS, W-cycle."""
    A = poisson((24, 24, 24), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A,
        presmoother=("gauss_seidel", {"sweep": "symmetric"}),
        postsmoother=("gauss_seidel", {"sweep": "symmetric"}),
    )
    b = np.random.default_rng(1).random(A.shape[0])
    res = []
    ml.solve(b, tol=1e-8, maxiter=30, cycle="W", residuals=res)
    assert res[-1] / res[0] < 1e-8
    f = factor(res)
    assert f < 0.2, f"3D SA W-cycle factor {f}"


def test_config3_anisotropic_rs_gmres():
    """Rotated anisotropic diffusion (eps=1e-3), classical RS + GMRES."""
    S = diffusion_stencil_2d(epsilon=1e-3, theta=0.0, type="FD")
    A = stencil_grid(S, (128, 128)).tocsr()
    ml = pyamg_tpu.ruge_stuben_solver(A)
    b = np.random.default_rng(2).random(A.shape[0])
    res = []
    x = ml.solve(b, tol=1e-8, maxiter=60, accel="gmres", residuals=res)
    assert res[-1] / res[0] < 1e-8
    assert len(res) - 1 <= 30
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-6


def test_config4_elasticity_rootnode_cg():
    """2D linear elasticity (BSR bs=2), rootnode SA + CG."""
    import warnings

    A, B = linear_elasticity((24, 24))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ml = pyamg_tpu.rootnode_solver(A, B=B, strength="symmetric")
    b = np.random.default_rng(3).random(A.shape[0])
    res = []
    x = ml.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=res)
    assert res[-1] / res[0] < 1e-8
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-6
    assert ml.operator_complexity() < 2.0


def test_config5_recirc_nonsymmetric_bicgstab_partitioned():
    """Nonsymmetric recirculating advection-diffusion, nonsymmetric
    energy-min SA + BiCGStab, row-partitioned over the 8-device mesh."""
    A = recirc_flow((48, 48), epsilon=1e-2)
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A,
        symmetry="nonsymmetric",
        smooth=("energy", {"krylov": "gmres", "maxiter": 3, "degree": 1}),
        strength="symmetric",
        improve_candidates=(("gauss_seidel_nr",
                             {"sweep": "symmetric", "iterations": 4}),
                            None),
        presmoother=("gauss_seidel_nr", {"sweep": "symmetric",
                                         "iterations": 2}),
        postsmoother=("gauss_seidel_nr", {"sweep": "symmetric",
                                          "iterations": 2}),
    )
    b = np.random.default_rng(4).random(A.shape[0])
    res = []
    x = ml.solve(b, tol=1e-8, maxiter=100, accel="bicgstab", residuals=res)
    assert res[-1] / res[0] < 1e-7
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-6

    # multi-device partitioned device solve (BASELINE: "multi-host
    # partitioned"), on the virtual 8-device CPU mesh
    if jax.device_count() >= 8:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pyamg_tpu.parallel import make_solver_mesh, shard_hierarchy
        from pyamg_tpu.sparse import pad_vector

        mesh = make_solver_mesh(8)
        hier = compile_hierarchy(ml, dtype=jnp.float64, row_pad=8 * 8)
        dml = DeviceMultilevelSolver(shard_hierarchy(hier, mesh))
        n_pad = dml.hierarchy.levels[0].n_pad
        sharding = NamedSharding(mesh, P("x"))
        b_dev = jax.device_put(
            pad_vector(jnp.asarray(b, dtype=jnp.float64), n_pad), sharding)
        x0 = jax.device_put(jnp.zeros(n_pad, dtype=jnp.float64), sharding)
        run = dml._get_compiled("V", "bicgstab", 60, 30)
        xs, history, it = run(dml.hierarchy, b_dev, x0,
                              jnp.asarray(1e-8, jnp.float64))
        xs = np.asarray(xs)[: A.shape[0]]
        relres = np.linalg.norm(b - A @ xs) / np.linalg.norm(b)
        assert relres < 1e-6, relres


def test_config5_bench_recipe_device_path_quality():
    """Pins the config5 bench recipe through the path the bench actually
    times (round 5, VERDICT items 1a/1c).

    The round-4 pin compared energy-smoothing degrees on 96^2 HOST
    solves (exact sequential GS-NR) — but the bench's time-to-1e-8 is a
    DEVICE solve where gauss_seidel_nr is substituted by the parallel
    Cimmino sweep (engine/hierarchy.py:178), and under Cimmino the
    degree-2 trend INVERTS (probe, device path at 256^2: degree-1
    25 iters / conv 0.434, degree-2 28 / 0.473; at 1024^2 degree-2 hit
    the maxiter cap at relres 3.3e-5).  So this test (a) runs the exact
    bench.py recipe, (b) through compile_hierarchy mixed + device
    BiCGStab — same substitution as the bench — and (c) asserts true
    1e-8 convergence with a conv factor that predicted 1024^2 behavior
    (degree-2's device conv at this scale, 0.473, fails this bound)."""
    A = recirc_flow((256, 256), epsilon=1e-2)
    b = np.random.default_rng(4).random(A.shape[0])
    with pytest.warns(UserWarning, match="Cimmino"):
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, symmetry="nonsymmetric",
            smooth=("energy", {"krylov": "gmres", "maxiter": 3,
                               "degree": 1}),
            strength="symmetric",
            improve_candidates=(("gauss_seidel_nr",
                                 {"sweep": "symmetric", "iterations": 4}),
                                None),
            presmoother=("gauss_seidel_nr", {"sweep": "symmetric",
                                             "iterations": 2}),
            postsmoother=("gauss_seidel_nr", {"sweep": "symmetric",
                                              "iterations": 2}))
        dml = DeviceMultilevelSolver(
            compile_hierarchy(ml, dtype=jnp.float32,
                              mixed_precision=True, coarse_cutoff=1024))
    res = []
    dml.solve(b, tol=1e-8, maxiter=60, accel="bicgstab",
              precision="mixed", residuals=res)
    rel = res[-1] / res[0]
    conv = rel ** (1.0 / (len(res) - 1))
    assert rel <= 1e-8, (rel, len(res) - 1)
    assert conv < 0.46, conv

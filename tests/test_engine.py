"""Device engine: ELL formats, jitted cycles, device Krylov, sharding.

Runs on the virtual 8-device CPU mesh (conftest sets JAX_PLATFORMS=cpu and
xla_force_host_platform_device_count=8) — SURVEY.md §4's multi-host test
strategy.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from pyamg_tpu.aggregation import smoothed_aggregation_solver
from pyamg_tpu.engine import (
    DeviceMultilevelSolver,
    as_device_solver,
    compile_hierarchy,
)
from pyamg_tpu.gallery import linear_elasticity, poisson
from pyamg_tpu.sparse import (
    bsr_ell_from_scipy,
    ell_from_scipy,
    ell_to_scipy,
    pad_vector,
)


def test_ell_roundtrip_and_matvec():
    rng = np.random.default_rng(0)
    A = sp.random(37, 23, density=0.2, random_state=7, format="csr")
    E = ell_from_scipy(A, dtype=jnp.float64)
    x = rng.random(23)
    x_pad = pad_vector(jnp.asarray(x), 24)
    y = np.asarray(E @ x_pad)[:37]
    np.testing.assert_allclose(y, A @ x, atol=1e-12)
    A2 = ell_to_scipy(E)
    assert abs(A2 - A).max() < 1e-14


def test_ell_matmat():
    A = poisson((10, 10), format="csr")
    E = ell_from_scipy(A, dtype=jnp.float64)
    X = np.random.default_rng(1).random((100, 3))
    X_pad = pad_vector(jnp.asarray(X), E.n_pad)
    Y = np.asarray(E @ X_pad)[:100]
    np.testing.assert_allclose(Y, A @ X, atol=1e-12)


def test_block_ell_matvec():
    A, _ = linear_elasticity((5, 5))
    E = bsr_ell_from_scipy(A, dtype=jnp.float64)
    n = A.shape[0]
    x = np.random.default_rng(2).random(n)
    nb_pad = E.nb_pad
    x_pad = pad_vector(jnp.asarray(x), nb_pad * 2)
    y = np.asarray(E @ x_pad)[:n]
    np.testing.assert_allclose(y, A @ x, rtol=1e-10)


def test_ell_diagonal():
    A = poisson((8, 8), format="csr")
    E = ell_from_scipy(A, dtype=jnp.float64)
    d = np.asarray(E.diagonal())[:64]
    np.testing.assert_allclose(d, A.diagonal(), atol=1e-14)


@pytest.fixture(scope="module")
def device_solver():
    A = poisson((32, 32), format="csr")
    ml = smoothed_aggregation_solver(A, max_coarse=10)
    dml = as_device_solver(ml, dtype=jnp.float64)
    b = np.random.default_rng(3).random(A.shape[0])
    return A, ml, dml, b


def test_device_vcycle_matches_host(device_solver):
    """f64 device V-cycle == host V-cycle up to multicolor-GS reordering:
    same convergence behavior (SURVEY.md §7 hard part 3)."""
    A, ml, dml, b = device_solver
    res_d = []
    dml.solve(b, tol=1e-10, maxiter=40, residuals=res_d)
    res_h = []
    ml.solve(b, tol=1e-10, maxiter=40, residuals=res_h)
    fac_d = (res_d[-1] / res_d[0]) ** (1.0 / (len(res_d) - 1))
    fac_h = (res_h[-1] / res_h[0]) ** (1.0 / (len(res_h) - 1))
    assert fac_d < 0.35, f"device V-cycle factor {fac_d}"
    assert fac_d < max(2.5 * fac_h, 0.3), (fac_d, fac_h)


def test_device_jacobi_hierarchy_matches_host_exactly():
    """With Jacobi smoothing (order-free) the device f64 cycle must match
    the host cycle to rounding."""
    A = poisson((16, 16), format="csr")
    ml = smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 1.0}),
        postsmoother=("jacobi", {"omega": 1.0}), max_coarse=10)
    dml = as_device_solver(ml, dtype=jnp.float64)
    b = np.random.default_rng(4).random(A.shape[0])
    x_host = ml.solve(b, maxiter=1, tol=1e-300)
    x_dev = dml.solve(b, maxiter=1, tol=1e-300)
    np.testing.assert_allclose(x_dev, x_host, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("accel", [None, "cg", "bicgstab", "gmres"])
def test_device_accels(device_solver, accel):
    A, ml, dml, b = device_solver
    res = []
    x = dml.solve(b, tol=1e-8, maxiter=60, accel=accel, residuals=res,
                  restart=20)
    relres = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert relres < 1e-6, f"{accel}: {relres}"


@pytest.mark.parametrize("cycle", ["V", "W", "F", "AMLI"])
def test_device_cycles(device_solver, cycle):
    A, ml, dml, b = device_solver
    res = []
    x = dml.solve(b, tol=1e-8, maxiter=40, cycle=cycle, residuals=res)
    assert res[-1] / res[0] < 1e-7, f"cycle {cycle}"


def test_mixed_precision_path(device_solver):
    """Host f64 CG + f32 device cycle preconditioner reaches 1e-10."""
    A, ml, dml, b = device_solver
    f32 = as_device_solver(ml, dtype=jnp.float32)
    from pyamg_tpu import krylov

    M = f32.aspreconditioner()
    res = []
    x, info = krylov.cg(A, b, tol=1e-10, maxiter=100, M=M, residuals=res)
    assert info == 0
    assert res[-1] / res[0] < 1e-9
    assert len(res) < 30


def test_device_elasticity_block():
    A, B = linear_elasticity((8, 8))
    ml = smoothed_aggregation_solver(A, B=B, max_coarse=10)
    dml = as_device_solver(ml, dtype=jnp.float64)
    b = np.random.default_rng(5).random(A.shape[0])
    res = []
    x = dml.solve(b, tol=1e-8, maxiter=80, accel="cg", residuals=res)
    relres = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert relres < 1e-6


def test_sharded_hierarchy_runs():
    """Row-sharded hierarchy over the 8-device CPU mesh executes and
    converges (multi-chip dry-run path)."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pyamg_tpu.parallel import make_solver_mesh, shard_hierarchy

    ndev = 8
    mesh = make_solver_mesh(ndev)
    A = poisson((32, 32), format="csr")
    ml = smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}), max_coarse=10)
    hier = compile_hierarchy(ml, dtype=jnp.float32, row_pad=8 * ndev)
    dml = DeviceMultilevelSolver(shard_hierarchy(hier, mesh))
    n_pad = dml.hierarchy.levels[0].n_pad
    sharding = NamedSharding(mesh, P("x"))
    b_np = np.random.default_rng(6).random(A.shape[0])
    b = jax.device_put(
        pad_vector(jnp.asarray(b_np, dtype=jnp.float32), n_pad), sharding)
    x0 = jax.device_put(jnp.zeros(n_pad, dtype=jnp.float32), sharding)
    run = dml._get_compiled("V", "cg", 20, 30)
    x, history, it = run(dml.hierarchy, b, x0, jnp.asarray(1e-5, jnp.float32))
    x = np.asarray(x)[: A.shape[0]]
    relres = np.linalg.norm(b_np - A @ x) / np.linalg.norm(b_np)
    assert relres < 1e-3, relres


def test_sharded_collectives_in_hlo():
    """Pin communication behavior: compiled sharded SpMV contains
    collective/partition ops (SNIPPETS.md HLO-pattern idiom)."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    import re

    from jax.sharding import NamedSharding, PartitionSpec as P

    from pyamg_tpu.parallel import make_solver_mesh

    mesh = make_solver_mesh(8)
    A = poisson((16, 16), format="csr")
    E = ell_from_scipy(A, dtype=jnp.float32, row_pad=64)
    rows = NamedSharding(mesh, P("x", None))
    vec = NamedSharding(mesh, P("x"))
    data = jax.device_put(E.data, rows)
    idx = jax.device_put(E.indices, rows)
    x = jax.device_put(jnp.ones(E.n_pad, dtype=jnp.float32), vec)

    def spmv(data, idx, x):
        return jnp.sum(data * jnp.take(x, idx, axis=0), axis=1)

    lowered = jax.jit(spmv).lower(data, idx, x).compile()
    hlo = lowered.as_text()
    assert re.search(r"(all-gather|all-reduce|collective-permute|dynamic-slice)",
                     hlo), "no collectives in sharded SpMV HLO"


def test_device_air_hierarchy():
    """AIR hierarchies (windowed R, masked fc-Jacobi smoothers) run on
    the device engine and keep the near-exact advection behavior."""
    from pyamg_tpu import air_solver
    from pyamg_tpu.gallery import advection_2d

    A, rhs = advection_2d((24, 24))
    ml = air_solver(A)
    dml = as_device_solver(ml, dtype=jnp.float64, row_pad=8)
    res = []
    x = dml.solve(rhs, tol=1e-10, maxiter=40, residuals=res)
    assert len(res) - 1 <= 3
    np.testing.assert_allclose(x, 1.0, atol=1e-10)


def test_device_classical_hierarchy():
    """Classical RS hierarchies (multicolor GS) on the device engine."""
    from pyamg_tpu import ruge_stuben_solver

    A = poisson((24, 24), format="csr")
    ml = ruge_stuben_solver(A)
    dml = as_device_solver(ml, dtype=jnp.float64, row_pad=8)
    b = np.random.default_rng(11).random(A.shape[0])
    res = []
    x = dml.solve(b, tol=1e-8, maxiter=40, accel="cg", residuals=res)
    relres = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert relres < 1e-7


def test_device_setup_primitives():
    """Gather-free device setup primitives (MIS, coloring, PMIS, BF)
    produce valid results matching host-side validity checkers."""
    from pyamg_tpu import graph_ref
    from pyamg_tpu.engine import setup as dsetup
    from pyamg_tpu.sparse import dia_from_scipy

    A = poisson((16, 16), format="csr")
    dia = dia_from_scipy(A, dtype=jnp.float64, row_pad=8)
    n = A.shape[0]

    mis = np.asarray(dsetup.device_luby_mis(dia))[:n]
    assert graph_ref.is_maximal_independent_set(A, mis == 1)

    colors = np.asarray(dsetup.device_jp_coloring(dia))[:n]
    assert graph_ref.is_valid_coloring(A, colors)
    assert colors.max() + 1 <= 8

    smask = np.asarray(dsetup.device_strength_mask(dia, theta=0.25))
    # strength mask marks only existing off-diagonal entries
    offd = np.array([o != 0 for o in dia.offsets])[:, None]
    data = np.asarray(dia.data)
    assert not (smask & ~((data != 0) & offd)).any()
    assert smask.any()

    splitting = np.asarray(dsetup.device_pmis_splitting(dia))[:n]
    assert set(np.unique(splitting)) == {0, 1}
    assert 0 < splitting.sum() < n
    # C points form an independent set in the strong graph
    from pyamg_tpu.graph_ref import is_independent_set
    assert is_independent_set(A, splitting == 1)

    seeds = np.zeros(dia.n_pad, dtype=bool)
    seeds[[0, 100, 200]] = True
    dist = np.asarray(dsetup.device_bellman_ford(dia, jnp.asarray(seeds)))
    d_ref, _ = graph_ref.bellman_ford_ref(
        A.multiply(abs(A) > 0), [0, 100, 200])
    # same graph distances (weights |A|)
    np.testing.assert_allclose(dist[:n], d_ref, atol=1e-10)


def test_solve_backend_device():
    """MultilevelSolver.solve(backend='device') routes through the
    jitted engine and reproduces the host residual history (jacobi
    smoothing is order-free, so f64 histories agree to rounding)."""
    A = poisson((20, 20), format="csr")
    ml = smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 1.0}),
        postsmoother=("jacobi", {"omega": 1.0}), max_coarse=10)
    b = np.random.default_rng(12).random(A.shape[0])
    res_h, res_d = [], []
    ml.solve(b, tol=1e-8, maxiter=25, residuals=res_h)
    ml.solve(b, tol=1e-8, maxiter=25, residuals=res_d, backend="device")
    assert len(res_h) == len(res_d)
    np.testing.assert_allclose(res_d, res_h, rtol=3e-8)
    # cached device hierarchy is reused
    dml1 = ml.to_device(dtype=jnp.float64)
    dml2 = ml.to_device(dtype=jnp.float64)
    assert dml1 is dml2


def test_dia_spgemm_matches_scipy():
    """Gather-free banded SpGEMM (rolls) == scipy csr_matmat."""
    from pyamg_tpu.sparse import dia_from_scipy, dia_spgemm, ell_to_scipy

    A = poisson((12, 12), format="csr")
    dia = dia_from_scipy(A, dtype=jnp.float64, row_pad=8)
    C = dia_spgemm(dia, dia)
    ref = (A @ A).toarray()
    # reconstruct dense from DIA
    n = A.shape[0]
    out = np.zeros((C.n_pad, C.n_pad))
    data = np.asarray(C.data)
    for d, off in enumerate(C.offsets):
        for i in range(C.n_pad):
            j = i + off
            if 0 <= j < C.n_pad:
                out[i, j] = data[d, i]
    np.testing.assert_allclose(out[:n, :n], ref, atol=1e-12)


def test_device_rootnode_hierarchy():
    """Rootnode (energy-min P) hierarchies compile to windowed operators
    and solve on the device engine."""
    from pyamg_tpu import rootnode_solver

    A = poisson((24, 24), format="csr")
    ml = rootnode_solver(A, strength="symmetric")
    dml = as_device_solver(ml, dtype=jnp.float64, row_pad=8)
    b = np.random.default_rng(13).random(A.shape[0])
    res = []
    x = dml.solve(b, tol=1e-8, maxiter=40, accel="cg", residuals=res)
    relres = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert relres < 1e-7


def test_rmatvec_formats():
    """Transpose apply (NE/NR smoother engine) matches scipy A.T @ x."""
    from pyamg_tpu.sparse import (dense_from_scipy, dia_from_scipy,
                                  windowed_from_scipy)

    rng = np.random.default_rng(11)
    A = poisson((12, 12), format="csr")
    A.data = A.data * (1.0 + 0.1 * rng.random(A.nnz))  # nonsymmetric
    n = A.shape[0]
    x = rng.random(n)
    want = A.T @ x

    D = dia_from_scipy(A, dtype=jnp.float64, row_pad=8)
    xp = pad_vector(jnp.asarray(x), D.n_pad)
    np.testing.assert_allclose(np.asarray(D.rmatvec(xp))[:n], want,
                               atol=1e-12)

    De = dense_from_scipy(A, dtype=jnp.float64, row_pad=8)
    np.testing.assert_allclose(
        np.asarray(De.rmatvec(pad_vector(jnp.asarray(x), De.n_pad)))[:n],
        want, atol=1e-12)

    W = windowed_from_scipy(A, dtype=jnp.float64, block=8)
    np.testing.assert_allclose(
        np.asarray(W.rmatvec(pad_vector(jnp.asarray(x), W.n_pad)))[:n],
        want, atol=1e-12)


def test_block_dia_matvec_golden():
    """BlockDIAMatrix (gather-free BSR path) vs scipy BSR matvec."""
    from pyamg_tpu.sparse import block_dia_from_scipy

    A, _ = linear_elasticity((9, 7))
    A = A.tobsr()
    n = A.shape[0]
    D = block_dia_from_scipy(A, dtype=jnp.float64, n_pad=n + 6)
    rng = np.random.default_rng(3)
    x = rng.random(n)
    xp = pad_vector(jnp.asarray(x), D.n_pad)
    np.testing.assert_allclose(np.asarray(D @ xp)[:n], A @ x, atol=1e-11)
    np.testing.assert_allclose(np.asarray(D.rmatvec(xp))[:n], A.T @ x,
                               atol=1e-11)
    np.testing.assert_allclose(np.asarray(D.diagonal())[:n], A.diagonal(),
                               atol=1e-14)


def test_device_elasticity_block_dia_path():
    """Config-4 style elasticity runs BLOCKED on device (round-1 verdict
    item 5): level-0 operator is BlockDIAMatrix, solve matches host."""
    import warnings as _w

    import pyamg_tpu
    from pyamg_tpu.sparse import BlockDIAMatrix

    A, B = linear_elasticity((48, 48))
    with _w.catch_warnings():
        _w.simplefilter("ignore")
        ml = pyamg_tpu.rootnode_solver(A, B=B, strength="symmetric")
    b = np.random.default_rng(5).random(A.shape[0])
    res_h = []
    ml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_h)

    dml = as_device_solver(ml, dtype=jnp.float64, row_pad=8)
    assert isinstance(dml.hierarchy.levels[0].A, BlockDIAMatrix), \
        type(dml.hierarchy.levels[0].A)
    res_d = []
    xd = dml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_d)
    assert np.linalg.norm(b - A @ xd) / np.linalg.norm(b) < 1e-7
    # multicolor block GS vs sequential block GS: factor parity band
    assert abs(len(res_d) - len(res_h)) <= 6, (len(res_d), len(res_h))


def test_device_solver_repr_and_complexity():
    """Host-parity introspection: __repr__ table + operator/grid
    complexity on the device pytree's structural counters."""
    import pyamg_tpu
    from pyamg_tpu.engine import as_device_solver
    from pyamg_tpu.gallery import poisson

    A = poisson((64, 64), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A)
    dml = as_device_solver(ml)
    oc = dml.operator_complexity()
    assert 1.0 < oc < 2.5
    assert 1.0 < dml.grid_complexity() < 2.0
    text = repr(dml)
    assert "operator complexity" in text and "DIAMatrix" in text


def test_profile_levels():
    import pyamg_tpu
    from pyamg_tpu.engine import as_device_solver
    from pyamg_tpu.engine.solver import profile_levels
    from pyamg_tpu.gallery import poisson

    A = poisson((32, 32), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A)
    dml = as_device_solver(ml)
    prof = profile_levels(dml, repeats=1)
    assert len(prof) == len(dml.hierarchy.levels)
    assert all(p["t_spmv_s"] > 0 and p["t_presmooth_s"] > 0
               for p in prof)
    assert all("t_transfer_s" in p for p in prof[:-1])


def test_single_level_device_hierarchy():
    """A hierarchy whose finest level is already <= max_coarse compiles
    to ONE device level; the cycle degenerates to the direct coarse
    solve (host parity: MultilevelSolver.__solve at the last level).
    Regression: blackbox solve of a small matrix with device=True hit
    'NoneType @ tracer' in _make_cycle (round 3)."""
    import pyamg_tpu
    from pyamg_tpu.engine import as_device_solver
    from pyamg_tpu.gallery import poisson

    A = poisson((12, 12), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=200)
    assert len(ml.levels) == 1
    dml = as_device_solver(ml)
    b = np.random.default_rng(3).random(A.shape[0])
    for accel in (None, "cg"):
        res = []
        x = dml.solve(b, tol=1e-6, maxiter=20, accel=accel, residuals=res)
        assert np.linalg.norm(b - A @ x) <= 1e-5 * np.linalg.norm(b)


def test_coarse_cutoff_truncation():
    """compile_hierarchy(coarse_cutoff=n) truncates at the first level
    with <= n unknowns and solves there exactly (dense pinv); the
    truncated hierarchy converges at least as fast as the full one."""
    import pyamg_tpu
    from pyamg_tpu.gallery import poisson

    A = poisson((64, 64), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=10)
    assert len(ml.levels) >= 4
    dml_full = ml.to_device()
    dml_cut = ml.to_device(coarse_cutoff=600)
    assert len(dml_cut.hierarchy.levels) < len(dml_full.hierarchy.levels)
    assert dml_cut.hierarchy.levels[-1].n <= 600
    b = np.random.default_rng(5).random(A.shape[0])
    res_f, res_c = [], []
    dml_full.solve(b, tol=1e-6, maxiter=30, accel="cg", residuals=res_f)
    dml_cut.solve(b, tol=1e-6, maxiter=30, accel="cg", residuals=res_c)
    assert res_c[-1] / res_c[0] < 1e-6
    assert len(res_c) <= len(res_f) + 1
    # caching key includes the cutoff
    assert ml.to_device(coarse_cutoff=600) is dml_cut
    assert ml.to_device() is not dml_cut

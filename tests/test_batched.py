"""Batched multi-RHS device solves (SURVEY.md §2.5 data-parallel analog).

``DeviceMultilevelSolver.solve(b)`` with b of shape (n, K) runs K systems
in one compiled program: the solve is vmapped over RHS lanes (every
format apply is plain XLA, so the batch runs K-major), and the Krylov
bodies freeze converged lanes (engine/krylov.py::_freeze) so each lane
keeps its own residual history and iteration count.

Parity tolerances: within one dtype the batched and single solves differ
only by XLA reduction/fusion reassociation — ~1e-6 relative for f32
trajectories, ~1e-14 for the f64 mixed-precision outer loop.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import pyamg_tpu
from pyamg_tpu.engine import compile_hierarchy
from pyamg_tpu.engine.solver import DeviceMultilevelSolver
from pyamg_tpu.gallery import linear_elasticity, poisson
from pyamg_tpu.sparse import dia_from_scipy, windowed_from_scipy


@pytest.fixture(scope="module")
def poisson_dml():
    A = poisson((64, 64), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A)
    return A, DeviceMultilevelSolver(
        compile_hierarchy(ml, mixed_precision=True))


@pytest.mark.parametrize("accel", [None, "cg", "bicgstab", "gmres"])
def test_batched_matches_single(poisson_dml, accel):
    A, dml = poisson_dml
    n = A.shape[0]
    rng = np.random.default_rng(0)
    B = rng.random((n, 3))

    res_b = []
    Xb = dml.solve(B, tol=1e-5, maxiter=40, accel=accel, residuals=res_b)
    assert Xb.shape == (n, 3)
    assert len(res_b) == 3
    for j in range(3):
        res1 = []
        x1 = dml.solve(B[:, j], tol=1e-5, maxiter=40, accel=accel,
                       residuals=res1)
        dx = np.max(np.abs(Xb[:, j] - x1)) / np.max(np.abs(x1))
        assert dx < 3e-5, (accel, j, dx)
        # same per-lane iteration count (modulo a threshold-crossing
        # rounding flip)
        assert abs(len(res_b[j]) - len(res1)) <= 1, (accel, j)


def test_batched_mixed_precision_true_residual(poisson_dml):
    A, dml = poisson_dml
    n = A.shape[0]
    rng = np.random.default_rng(1)
    B = rng.random((n, 4))
    res_b = []
    Xb = dml.solve(B, tol=1e-9, maxiter=60, accel="cg", precision="mixed",
                   residuals=res_b)
    # TRUE residual (host f64) per column beats 5e-9
    r = np.linalg.norm(B - A @ Xb, axis=0) / np.linalg.norm(B, axis=0)
    assert (r < 5e-9).all(), r
    # f64 outer loop: batched == single to near machine precision
    x1 = dml.solve(B[:, 2], tol=1e-9, maxiter=60, accel="cg",
                   precision="mixed")
    assert np.max(np.abs(Xb[:, 2] - x1)) / np.max(np.abs(x1)) < 1e-12


def test_per_lane_freeze(poisson_dml):
    """A zero RHS lane converges at iteration 0 and must freeze (x stays
    0, history length 1) while the other lanes keep iterating."""
    A, dml = poisson_dml
    n = A.shape[0]
    rng = np.random.default_rng(2)
    B = np.stack([rng.random(n), np.zeros(n), rng.random(n)], axis=1)
    res_b = []
    Xb = dml.solve(B, tol=1e-6, maxiter=50, accel="cg", residuals=res_b)
    assert np.all(Xb[:, 1] == 0.0)
    assert len(res_b[1]) == 1          # never entered the loop body
    assert len(res_b[0]) > 3 and len(res_b[2]) > 3
    # non-zero lanes unaffected by the frozen lane
    x0 = dml.solve(B[:, 0], tol=1e-6, maxiter=50, accel="cg")
    assert np.max(np.abs(Xb[:, 0] - x0)) / np.max(np.abs(x0)) < 3e-5


def test_batched_return_info_and_device_out(poisson_dml):
    A, dml = poisson_dml
    n = A.shape[0]
    B = np.random.default_rng(3).random((n, 2))
    x, info = dml.solve(B, tol=1e-5, maxiter=40, accel="cg",
                        return_info=True)
    assert info == 0
    x_dev = dml.solve(B, tol=1e-5, maxiter=40, accel="cg", device_out=True)
    assert isinstance(x_dev, jnp.ndarray) and x_dev.shape == (n, 2)
    np.testing.assert_allclose(np.asarray(x_dev), x, rtol=0, atol=0)


def test_batched_block_hierarchy():
    """Elasticity (BSR -> block-DIA device operators + block smoothers)
    through the batched path: block smoother reshapes vmap cleanly."""
    A, B0 = linear_elasticity((24, 24))
    ml = pyamg_tpu.smoothed_aggregation_solver(sp.bsr_matrix(A), B=B0)
    dml = DeviceMultilevelSolver(compile_hierarchy(ml))
    n = A.shape[0]
    rhs = np.random.default_rng(4).random((n, 3))
    res = []
    X = dml.solve(rhs, tol=1e-6, maxiter=60, accel="cg", residuals=res)
    for j in range(3):
        x1 = dml.solve(rhs[:, j], tol=1e-6, maxiter=60, accel="cg")
        assert np.max(np.abs(X[:, j] - x1)) / np.max(np.abs(x1)) < 1e-4


def test_dia_matmat_rmatmat_vs_scipy():
    """Unit check of the 2-D forms the batch rules route to."""
    rng = np.random.default_rng(5)
    A = sp.random(100, 100, density=0.1, random_state=7, format="csr")
    A = A + sp.eye(100)
    dia = dia_from_scipy(sp.csr_matrix(A), dtype=jnp.float64)
    X = rng.random((dia.n_pad, 4))
    Y = np.asarray(dia.matmat(jnp.asarray(X)))
    Yt = np.asarray(dia.rmatmat(jnp.asarray(X)))
    np.testing.assert_allclose(Y[:100], (A @ X[:dia.shape[1]])[:100],
                               rtol=1e-13)
    np.testing.assert_allclose(Yt[:100], (A.T @ X[:dia.shape[1]])[:100],
                               rtol=1e-13)


def test_windowed_matmat_rmatmat_vs_scipy():
    P = sp.random(300, 80, density=0.05, random_state=9, format="csr")
    W = windowed_from_scipy(P, dtype=jnp.float64)
    assert W is not None
    rng = np.random.default_rng(6)
    Xc = rng.random((W.m_chunks * W.w2, 3))
    Y = np.asarray(W.matmat(jnp.asarray(Xc)))
    np.testing.assert_allclose(Y[:300], P @ Xc[:80], rtol=1e-13)
    Xf = rng.random((W.n_pad, 3))
    Yt = np.asarray(W.rmatmat(jnp.asarray(Xf)))
    np.testing.assert_allclose(Yt[:80], P.T @ Xf[:300], rtol=1e-13)


def test_batched_gmres_multi_restart(poisson_dml):
    """Multiple GMRES restarts under vmap: the outer while_loop freeze
    must keep early-converging lanes intact across later restarts."""
    A, dml = poisson_dml
    n = A.shape[0]
    rng = np.random.default_rng(9)
    B = np.stack([rng.random(n), np.zeros(n), rng.random(n)], axis=1)
    res_b = []
    Xb = dml.solve(B, tol=1e-6, maxiter=24, accel="gmres", restart=4,
                   residuals=res_b)
    assert len(res_b[1]) == 1              # zero lane froze at entry
    for j in (0, 2):
        res1 = []
        x1 = dml.solve(B[:, j], tol=1e-6, maxiter=24, accel="gmres",
                       restart=4, residuals=res1)
        assert abs(len(res_b[j]) - len(res1)) <= 1
        dx = np.max(np.abs(Xb[:, j] - x1)) / np.max(np.abs(x1))
        assert dx < 3e-5, (j, dx)


def test_kmajor_matches_column_stack_dia():
    """matmat_k/rmatmat_k (K-major, the zero-transpose vmap layout) ==
    matmat/rmatmat on the transposed stack, and == scipy."""
    import scipy.sparse as sp
    from pyamg_tpu.sparse import dia_from_scipy
    from pyamg_tpu.gallery import poisson
    A = poisson((48, 48), format="csr")
    D = dia_from_scipy(A, row_pad=128)
    rng = np.random.default_rng(5)
    X = jnp.asarray(rng.standard_normal((D.n_pad, 6)), dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(D.matmat_k(X.T)),
                               np.asarray(D.matmat(X)).T, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(D.rmatmat_k(X.T)),
                               np.asarray(D.rmatmat(X)).T, rtol=1e-6)
    want = (A @ np.asarray(X, dtype=np.float64)[: A.shape[0]])
    got = np.asarray(D.matmat_k(X.T)).T[: A.shape[0]]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_kmajor_matches_column_stack_windowed():
    import scipy.sparse as sp
    from pyamg_tpu.sparse import windowed_from_scipy
    rng = np.random.default_rng(7)
    n, m = 2048, 700
    rows = np.repeat(np.arange(n), 3)
    cols = np.clip(rows // 3 + rng.integers(-20, 21, rows.shape), 0, m - 1)
    P = sp.csr_matrix((rng.standard_normal(rows.shape), (rows, cols)),
                      shape=(n, m))
    W = windowed_from_scipy(P, block=256)
    assert W is not None
    Xc = jnp.asarray(rng.standard_normal((W.m_chunks * W.w2, 5)),
                     dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(W.matmat_k(Xc.T)),
                               np.asarray(W.matmat(Xc)).T, rtol=1e-6)
    Xr = jnp.asarray(rng.standard_normal((W.n_pad, 5)), dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(W.rmatmat_k(Xr.T)),
                               np.asarray(W.rmatmat(Xr)).T, rtol=1e-6)
    # scipy golden through the transposed-windowed matmat (fused path)
    from pyamg_tpu.sparse import TransposedWindowed
    R = TransposedWindowed(W)
    got = np.asarray(R.matmat(Xr))[: P.shape[1]]
    want = P.T @ np.asarray(Xr, dtype=np.float64)[: P.shape[0]]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lane_align", [False, True])
def test_batched_cg_routes_to_vmapped(lane_align):
    """Batched f32 V+CG solves — the flagship batched configuration,
    lane-aligned or not — take the vmapped K-major program (one jit
    entry keyed batched=True) and match per-column solves."""
    from pyamg_tpu.engine import device_sa_setup

    A = poisson((96, 96), format="csr")
    dsa = device_sa_setup(A, grid=(96, 96), dtype=jnp.float32,
                          max_coarse=60, lane_align=lane_align)
    rng = np.random.default_rng(11)
    B = rng.random((A.shape[0], 4))
    res = []
    X = dsa.solve(B, tol=1e-6, maxiter=60, accel="cg", residuals=res)
    keys = list(dsa._jit_cache)
    assert len(keys) == 1 and keys[0][6] is True     # batched=True
    for j in range(B.shape[1]):
        r1 = []
        x1 = dsa.solve(B[:, j], tol=1e-6, maxiter=60, accel="cg",
                       residuals=r1)
        assert abs(len(res[j]) - len(r1)) <= 1
        assert np.max(np.abs(X[:, j] - x1)) / np.max(np.abs(x1)) < 1e-4

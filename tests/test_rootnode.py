"""Rootnode / adaptive / pairwise solver families + blackbox API."""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp

import pyamg_tpu
from pyamg_tpu import (
    adaptive_sa_solver,
    pairwise_solver,
    rootnode_solver,
)
from pyamg_tpu.gallery import linear_elasticity, poisson


def avg_factor(res):
    res = np.asarray(res)
    return (res[-1] / res[0]) ** (1.0 / (len(res) - 1))


def test_rootnode_poisson():
    A = poisson((32, 32), format="csr")
    ml = rootnode_solver(A, strength="symmetric")
    b = np.random.default_rng(0).random(A.shape[0])
    res = []
    ml.solve(b, tol=1e-10, maxiter=60, accel="cg", residuals=res)
    assert res[-1] / res[0] < 1e-9
    assert len(res) < 20


def test_rootnode_identity_at_roots():
    """T/P rows at root C-points are identity (the defining property)."""
    A = poisson((16, 16), format="csr")
    ml = rootnode_solver(A, strength="symmetric", keep=True)
    lvl = ml.levels[0]
    P = sp.csr_matrix(lvl.P)
    rows = P[lvl.Cpts].toarray()
    expected = np.zeros_like(rows)
    expected[np.arange(len(lvl.Cpts)), np.arange(len(lvl.Cpts))] = 1.0
    np.testing.assert_allclose(rows, expected, atol=1e-10)


def test_rootnode_elasticity():
    """BASELINE config-4 shape: BSR elasticity + rootnode + CG."""
    A, B = linear_elasticity((12, 12))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ml = rootnode_solver(A, B=B, strength="symmetric")
    b = np.random.default_rng(1).random(A.shape[0])
    res = []
    ml.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=res)
    assert res[-1] / res[0] < 1e-7
    assert ml.operator_complexity() < 2.0


def test_rootnode_evolution_default():
    A = poisson((24, 24), format="csr")
    ml = rootnode_solver(A)  # strength='evolution' default
    b = np.random.default_rng(2).random(A.shape[0])
    res = []
    ml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
    assert res[-1] / res[0] < 1e-7


def test_adaptive_sa():
    A = poisson((24, 24), format="csr")
    ml, work = adaptive_sa_solver(A, num_candidates=2, candidate_iters=4)
    assert work > 0
    b = np.random.default_rng(3).random(A.shape[0])
    res = []
    ml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
    assert res[-1] / res[0] < 1e-7
    # bootstrapping adds candidates only while the solver is still weak
    assert 1 <= ml.levels[0].B.shape[1] <= 2


def test_adaptive_sa_improvement():
    A = poisson((16, 16), format="csr")
    ml, work = adaptive_sa_solver(A, num_candidates=1, candidate_iters=4,
                                  improvement_iters=2)
    b = np.random.default_rng(4).random(A.shape[0])
    res = []
    ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
    assert avg_factor(res) < 0.5


def test_pairwise_solver():
    A = poisson((30, 30), format="csr")
    ml = pairwise_solver(A, matchings=2)
    assert len(ml.levels) > 2
    b = np.random.default_rng(5).random(A.shape[0])
    res = []
    ml.solve(b, tol=1e-8, maxiter=200, accel="cg", residuals=res)
    assert res[-1] / res[0] < 1e-7
    # unsmoothed aggregation: low operator complexity
    assert ml.operator_complexity() < 1.5


def test_blackbox_solve():
    A = poisson((24, 24), format="csr")
    b = np.random.default_rng(6).random(A.shape[0])
    x = pyamg_tpu.solve(A, b, verb=False, tol=1e-8)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-6


def test_blackbox_nonsymmetric():
    from pyamg_tpu.gallery import recirc_flow

    A = recirc_flow((20, 20), epsilon=1e-2)
    b = np.random.default_rng(7).random(A.shape[0])
    x, ml = pyamg_tpu.solve(A, b, verb=False, tol=1e-8, return_solver=True)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-6
    # reuse the solver
    b2 = np.random.default_rng(8).random(A.shape[0])
    x2 = pyamg_tpu.solve(A, b2, verb=False, tol=1e-8, existing_solver=ml)
    assert np.linalg.norm(b2 - A @ x2) / np.linalg.norm(b2) < 1e-6


def test_blackbox_device_solve():
    """device=True: zero-config device-engine solve (mixed precision) plus
    device-solver reuse through existing_solver."""
    A = poisson((24, 24), format="csr")
    b = np.random.default_rng(9).random(A.shape[0])
    x, dml = pyamg_tpu.solve(A, b, verb=False, tol=1e-9, device=True,
                             return_solver=True)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-8
    # returned solver is the DEVICE solver; reuse skips setup+compile
    assert hasattr(dml, "hierarchy")
    b2 = np.random.default_rng(10).random(A.shape[0])
    x2 = pyamg_tpu.solve(A, b2, verb=False, tol=1e-9, existing_solver=dml)
    assert np.linalg.norm(b2 - A @ x2) / np.linalg.norm(b2) < 1e-8


def test_blackbox_device_nonsymmetric():
    """device=True routes the nonsymmetric config through device fgmres."""
    from pyamg_tpu.gallery import recirc_flow

    A = recirc_flow((20, 20), epsilon=1e-2)
    b = np.random.default_rng(11).random(A.shape[0])
    x = pyamg_tpu.solve(A, b, verb=False, tol=1e-8, device=True)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


def test_blackbox_config_roundtrip():
    A = poisson((16, 16), format="csr")
    config = pyamg_tpu.solver_configuration(A, verb=False)
    assert config["symmetry"] == "hermitian"
    ml = pyamg_tpu.solver(A, config)
    b = np.ones(A.shape[0])
    res = []
    ml.solve(b, tol=1e-8, accel="cg", residuals=res)
    assert res[-1] / res[0] < 1e-7


def test_blackbox_rejects_nonsquare():
    with pytest.raises(TypeError):
        pyamg_tpu.blackbox.make_csr(np.ones((3, 4)))


def test_adaptive_recovers_scaled_poisson():
    """Round-1 verdict item 6: on a diagonally-scaled Poisson the
    ones-candidate hierarchy fails (the near-nullspace is D^-1*ones, not
    ones); the staged adaptive setup must recover rho < 0.3."""
    import scipy.sparse as sp

    from pyamg_tpu.aggregation import smoothed_aggregation_solver

    A = poisson((32, 32), format="csr")
    rng = np.random.default_rng(7)
    # sign flips make the true near-nullspace (D^-1 ones) oscillatory —
    # the case the ones candidate cannot represent at all
    d = rng.choice([-1.0, 1.0], A.shape[0]) * 10.0 ** rng.uniform(
        -1, 1, A.shape[0])
    D = sp.diags(d)
    As = sp.csr_matrix(D @ A @ D)
    b = np.zeros(As.shape[0])
    x0 = rng.random(As.shape[0])

    def factor(ml):
        res = []
        ml.solve(b, x0=x0.copy(), tol=1e-12, maxiter=20, residuals=res,
                 accel=None)
        return (res[-1] / res[0]) ** (1.0 / (len(res) - 1))

    ml_ones = smoothed_aggregation_solver(
        As, presmoother=("gauss_seidel", {"sweep": "symmetric"}),
        postsmoother=("gauss_seidel", {"sweep": "symmetric"}))
    f_ones = factor(ml_ones)

    ml_ad, work = adaptive_sa_solver(As, num_candidates=1,
                                     candidate_iters=6)
    f_ad = factor(ml_ad)
    assert f_ones > 0.5, f"ones-candidate unexpectedly works: {f_ones}"
    assert f_ad < 0.3, f"adaptive failed to recover: {f_ad} (ones {f_ones})"
    assert work > 0

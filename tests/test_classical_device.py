"""Device classical (Ruge-Stüben) setup — engine/classical_setup.py.

Golden strategy (SURVEY.md §4): a dense numpy re-implementation of the
structured multi-pass direct interpolation validates the embedded-DIA
algebra entrywise; convergence tests pin the classical-family rates
(reference counterpart: [R] pyamg/classical/classical.py tests).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pyamg_tpu.engine import device_rs_setup
from pyamg_tpu.gallery import diffusion_stencil_2d, poisson, stencil_grid


# ---------------------------------------------------------------------------
# dense golden: structured multi-pass direct interpolation
# ---------------------------------------------------------------------------

def golden_structured_rs(A_csr, grid, stride):
    """Dense reference for the device pipeline's P and Galerkin A_c."""
    A = np.asarray(A_csr.todense(), dtype=np.float64)
    n = A.shape[0]
    dim = len(grid)
    ss = (stride,) * dim if np.isscalar(stride) else tuple(stride)
    coords = np.stack(np.unravel_index(np.arange(n), grid), axis=1)
    oddness = np.zeros(n, dtype=int)
    for d in range(dim):
        if ss[d] > 1:
            oddness += (coords[:, d] % ss[d] != 0).astype(int)
    n_passes = sum(1 for s in ss if s > 1)

    # P rows start as injection on C, filled pass by pass
    c_idx = np.flatnonzero(oddness == 0)
    nc = len(c_idx)
    P = np.zeros((n, nc))
    P[c_idx, np.arange(nc)] = 1.0
    done = oddness == 0
    for m in range(1, n_passes + 1):
        targets = oddness < m
        newP = P.copy()
        for i in np.flatnonzero(oddness == m):
            row = A[i].copy()
            row[i] = 0.0
            neg_all = row[row < 0].sum()
            pos_all = row[row > 0].sum()
            tr = np.where(targets, row, 0.0)
            neg_t = tr[tr < 0].sum()
            pos_t = tr[tr > 0].sum()
            alpha = neg_all / neg_t if neg_t != 0 else 0.0
            beta = pos_all / pos_t if pos_t != 0 else 0.0
            diag = A[i, i]
            if pos_t == 0:
                diag += pos_all
            if neg_t == 0:
                diag += neg_all
            if diag == 0:
                diag = 1.0
            for j in np.flatnonzero(tr != 0):
                w = -(alpha if A[i, j] < 0 else beta) * A[i, j] / diag
                newP[i] += w * P[j]
        P = newP
        done |= oddness == m
    Ac = P.T @ A @ P
    return P, Ac, c_idx


def _device_P_dense(ds):
    """Materialize the level-0 device prolongator column by column."""
    lvl = ds.hierarchy.levels[0]
    ncp = int(np.prod(lvl.P.coarse_grid_p))
    cols = []
    for c in range(ncp):
        e = jnp.zeros(ncp, dtype=jnp.float64).at[c].set(1.0)
        cols.append(np.asarray(lvl.P @ e))
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("stencil", ["fd5", "fe9"])
def test_golden_interpolation_and_rap(stencil):
    grid = (8, 8)
    if stencil == "fd5":
        A = poisson(grid, format="csr")
    else:
        A = stencil_grid(
            diffusion_stencil_2d(epsilon=1.0, theta=0.0, type="FE"),
            grid).tocsr()
    ds = device_rs_setup(A, grid=grid, max_coarse=20, dtype=jnp.float64)
    P_dev = _device_P_dense(ds)
    P_gold, Ac_gold, c_idx = golden_structured_rs(A, grid, 2)
    assert P_dev.shape == P_gold.shape
    np.testing.assert_allclose(P_dev, P_gold, atol=1e-12)
    # Galerkin coarse operator parity (device DIA -> dense)
    Ac_dia = ds.hierarchy.levels[1].A
    nc = Ac_dia.n_pad
    Ac_dev = np.asarray(Ac_dia @ jnp.eye(nc, dtype=jnp.float64))
    np.testing.assert_allclose(Ac_dev, Ac_gold, atol=1e-11)


def test_golden_semicoarsening():
    """Per-dim stride (2, 1): interpolation only along dim 0; the weak
    dim's couplings are lumped through the alpha correction."""
    grid = (8, 6)
    S = diffusion_stencil_2d(epsilon=1e-2, theta=0.0, type="FD")
    A = stencil_grid(S, grid).tocsr()
    ds = device_rs_setup(A, grid=grid, stride=(2, 1), max_coarse=10,
                         dtype=jnp.float64, max_levels=2)
    P_dev = _device_P_dense(ds)
    P_gold, Ac_gold, _ = golden_structured_rs(A, grid, (2, 1))
    np.testing.assert_allclose(P_dev, P_gold, atol=1e-12)


def test_constants_preserved_interior():
    """Direct interpolation reproduces constants away from the boundary:
    (P @ 1)_i = 1 for interior fine points (zero-row-sum rows)."""
    grid = (16, 16)
    A = poisson(grid, format="csr")
    ds = device_rs_setup(A, grid=grid, max_coarse=30, dtype=jnp.float64)
    lvl = ds.hierarchy.levels[0]
    ncp = int(np.prod(lvl.P.coarse_grid_p))
    ones = np.asarray(lvl.P @ jnp.ones(ncp, dtype=jnp.float64))
    interior = np.zeros(grid, dtype=bool)
    interior[2:-2, 2:-2] = True
    np.testing.assert_allclose(ones[interior.reshape(-1)], 1.0, atol=1e-12)


def test_poisson_convergence():
    grid = (64, 64)
    A = poisson(grid, format="csr")
    ds = device_rs_setup(A, grid=grid, max_coarse=200)
    assert all(i["ndiags"] <= 9 for i in ds.setup_info["levels"])
    b = np.random.default_rng(0).random(A.shape[0])
    res = []
    ds.solve(b, tol=1e-7, maxiter=40, accel="cg", residuals=res)
    rho = (res[-1] / res[0]) ** (1.0 / (len(res) - 1))
    assert rho < 0.28, rho


def test_anisotropic_semicoarsening_plan():
    grid = (64, 64)
    S = diffusion_stencil_2d(epsilon=1e-3, theta=0.0, type="FD")
    A = stencil_grid(S, grid).tocsr()
    ds = device_rs_setup(A, grid=grid, max_coarse=200)
    strides = [i["strides"] for i in ds.setup_info["levels"]]
    assert strides[0] in ((1, 2), (2, 1))       # semicoarsens first
    assert strides[-1] == (2, 2) or len(strides) < 5   # evens out deep
    b = np.random.default_rng(1).random(A.shape[0])
    res = []
    ds.solve(b, tol=1e-7, maxiter=40, accel="cg", residuals=res)
    rho = (res[-1] / res[0]) ** (1.0 / (len(res) - 1))
    assert rho < 0.35, rho


def test_3d_poisson():
    grid = (12, 12, 12)
    A = poisson(grid, format="csr")
    ds = device_rs_setup(A, grid=grid, max_coarse=250)
    assert all(i["ndiags"] <= 27 for i in ds.setup_info["levels"])
    b = np.random.default_rng(2).random(A.shape[0])
    res = []
    ds.solve(b, tol=1e-6, maxiter=40, accel="cg", residuals=res)
    rho = (res[-1] / res[0]) ** (1.0 / (len(res) - 1))
    assert rho < 0.35, rho


def test_mixed_precision_true_residual():
    grid = (64, 64)
    A = poisson(grid, format="csr")
    ds = device_rs_setup(A, grid=grid, max_coarse=200,
                         mixed_precision=True)
    b = np.random.default_rng(3).random(A.shape[0])
    res = []
    x = ds.solve(b, tol=1e-9, maxiter=60, accel="cg", precision="mixed",
                 residuals=res)
    true = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert true < 5e-9, true


def test_air_ideal_restriction_annihilates_F():
    """Degree-2 local AIR on upwind advection captures A_ff^{-1}
    exactly: (R·A)[c, f] = 0 for every C row and F column (the defining
    property of ideal restriction, [R] pyamg/classical/air.py)."""
    from pyamg_tpu.engine import device_air_setup
    from pyamg_tpu.gallery import advection_2d

    grid = (8, 8)
    A, _ = advection_2d(grid, theta=np.pi / 4)
    ds = device_air_setup(A, grid=grid, max_coarse=10, dtype=jnp.float64,
                          max_levels=2)
    lvl = ds.hierarchy.levels[0]
    n = A.shape[0]
    R_dense = np.stack(
        [np.asarray(lvl.R.R_emb @ jnp.zeros(n).at[j].set(1.0))
         for j in range(n)], axis=1)
    RA = R_dense @ np.asarray(A.todense())
    coords = np.stack(np.unravel_index(np.arange(n), grid), axis=1)
    cpts = (coords % 2 == 0).all(axis=1)
    # local AIR zeroes (R·A)[c, f] exactly on the degree-2 slot
    # neighborhood (upwind singles + their pairwise sums); F columns
    # beyond the neighborhood are the F-smoother's job
    slot_deltas = [(0, -1), (-1, 0), (0, -2), (-1, -1), (-2, 0)]
    worst = 0.0
    for c in np.flatnonzero(cpts):
        cy, cx = coords[c]
        for dy, dx in slot_deltas:
            fy, fx = cy + dy, cx + dx
            if not (0 <= fy < grid[0] and 0 <= fx < grid[1]):
                continue
            f = fy * grid[1] + fx
            if cpts[f]:
                continue
            worst = max(worst, abs(RA[c, f]))
    assert worst < 1e-11, worst


def test_air_advection_near_exact():
    """One AIR cycle reduces the advection residual by >1e5 (the
    reference air_solver's signature near-exact behavior)."""
    from pyamg_tpu.engine import device_air_setup
    from pyamg_tpu.gallery import advection_2d

    grid = (64, 64)
    A, rhs = advection_2d(grid, theta=np.pi / 4)
    ds = device_air_setup(A, grid=grid, max_coarse=200)
    res = []
    ds.solve(rhs, tol=1e-8, maxiter=5, residuals=res)
    assert res[1] / res[0] < 1e-5, res[:2]
    # accelerated: tight tolerance in a handful of iterations
    res = []
    x = ds.solve(rhs, tol=1e-10, maxiter=30, accel="fgmres",
                 residuals=res)
    assert len(res) - 1 <= 20
    true = np.linalg.norm(rhs - A @ x) / np.linalg.norm(rhs)
    assert true < 5e-6        # f32 floor


def test_air_mixed_precision():
    from pyamg_tpu.engine import device_air_setup
    from pyamg_tpu.gallery import advection_2d

    grid = (32, 32)
    A, rhs = advection_2d(grid, theta=np.pi / 3)
    ds = device_air_setup(A, grid=grid, max_coarse=100,
                          mixed_precision=True)
    res = []
    x = ds.solve(rhs, tol=1e-11, maxiter=40, precision="mixed",
                 residuals=res)
    true = np.linalg.norm(rhs - A @ x) / np.linalg.norm(rhs)
    assert true < 1e-10, true


def test_batched_rs_solve():
    """Cross-feature: classical device hierarchy through the batched
    multi-RHS path."""
    grid = (32, 32)
    A = poisson(grid, format="csr")
    ds = device_rs_setup(A, grid=grid, max_coarse=60)
    n = A.shape[0]
    B = np.random.default_rng(4).random((n, 2))
    # StructuredDeviceSolver grid-encodes (n, K) column stacks directly
    X = ds.solve(B, tol=1e-6, maxiter=40, accel="cg")
    assert X.shape == (n, 2)
    r = np.linalg.norm(B - A @ X, axis=0) / np.linalg.norm(B, axis=0)
    assert (r < 1e-4).all(), r


def test_air_local_restriction_golden():
    """Dense numpy golden for the degree-2 local AIR solve: for every C
    point, r solves A_ff(N,N)^T r = -A_cf(c,N)^T over the slot
    neighborhood — the embedded-DIA assembly (rolled views + unrolled
    Gaussian elimination) must match entrywise."""
    from pyamg_tpu.engine import device_air_setup
    from pyamg_tpu.engine.classical_setup import _air_slots
    from pyamg_tpu.gallery import advection_2d
    from pyamg_tpu.sparse import dia_from_scipy
    import scipy.sparse as sp

    grid = (8, 8)
    A, _ = advection_2d(grid, theta=np.pi / 3)
    ds = device_air_setup(A, grid=grid, max_coarse=10, dtype=jnp.float64,
                          max_levels=2)
    lvl = ds.hierarchy.levels[0]
    n = A.shape[0]
    R_dev = np.stack(
        [np.asarray(lvl.R.R_emb @ jnp.zeros(n).at[j].set(1.0))
         for j in range(n)], axis=1)

    Ad = np.asarray(A.todense())
    D = dia_from_scipy(sp.csr_matrix(A), dtype=jnp.float64, row_pad=1)
    slots = _air_slots(D, grid, degree=2)
    coords = np.stack(np.unravel_index(np.arange(n), grid), axis=1)
    cpts = (coords % 2 == 0).all(axis=1)

    R_gold = np.zeros((n, n))
    for c in np.flatnonzero(cpts):
        R_gold[c, c] = 1.0
        nbrs = []
        for o in slots:
            f = c + o          # flat-offset arithmetic, same as the DIA
            if 0 <= f < n and not cpts[f] and Ad[f, f] != 0:
                nbrs.append(f)
        if not nbrs:
            continue
        M = Ad[np.ix_(nbrs, nbrs)]
        rhs = -Ad[c, nbrs]
        r = np.linalg.solve(M.T, rhs)
        R_gold[c, nbrs] = r
    np.testing.assert_allclose(R_dev, R_gold, atol=1e-11)


def test_device_rs_recirc_nonsymmetric():
    """Device classical RS handles the nonsymmetric recirculating-flow
    operator (BASELINE config 5's matrix family): multi-pass direct
    interpolation on the upwind stencil + FGMRES converges (at 1024^2,
    chip_smoke.py phase 7: 43 mixed FGMRES iterations to a true
    1.3e-11)."""
    import numpy as np

    from pyamg_tpu.engine import device_rs_setup
    from pyamg_tpu.gallery import recirc_flow

    A = recirc_flow((64, 64), epsilon=1e-2)
    b = np.random.default_rng(4).random(A.shape[0])
    ds = device_rs_setup(A, grid=(64, 64), max_coarse=200)
    res = []
    ds.solve(b, tol=1e-6, maxiter=60, accel="fgmres", residuals=res)
    assert res[-1] / res[0] < 1e-6
    assert len(res) - 1 < 50

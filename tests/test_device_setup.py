"""Device SA setup (engine/device_setup.py): golden parity + convergence.

SURVEY.md §4 idiom 1: every device kernel is validated against a slow
host (NumPy/SciPy) re-implementation written next to the test.  The
golden here is the *same structured algorithm* run through scipy sparse
algebra — it pins the embedded-DIA transfer operators, the transpose,
the filtered SpGEMM RAP, and the compaction, entry by entry.
"""

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from pyamg_tpu.aggregation import smoothed_aggregation_solver
from pyamg_tpu.engine import device_sa_setup
from pyamg_tpu.engine.device_setup import dia_transpose
from pyamg_tpu.gallery import poisson
from pyamg_tpu.sparse import dia_from_scipy


def _embed_matrix(A, grid, grid_p):
    """Host embedding of A onto the padded grid (index permutation)."""
    n = int(np.prod(grid))
    n_p = int(np.prod(grid_p))
    coords = np.indices(grid)
    lin = np.zeros(grid, dtype=np.int64)
    stride_acc = 1
    for d in range(len(grid) - 1, -1, -1):
        lin += coords[d] * stride_acc
        stride_acc *= grid_p[d]
    rows = lin.reshape(-1)
    E = sp.csr_matrix((np.ones(n), (rows, np.arange(n))), shape=(n_p, n))
    return (E @ sp.csr_matrix(A) @ E.T).tocsr(), E


def _host_structured_sa(A, grid, stride, omega, rho):
    """Golden: structured SA level step via scipy (dense-logic clarity)."""
    grid_p = tuple(stride * -(-g // stride) for g in grid)
    A_p, E = _embed_matrix(A, grid, grid_p)
    n_p = A_p.shape[0]
    coarse_grid = tuple(g // stride for g in grid_p)
    nc = int(np.prod(coarse_grid))
    # aggregate of each padded point; valid points only carry B=1
    coords = np.indices(grid_p)
    agg = np.zeros(grid_p, dtype=np.int64)
    sa = 1
    for d in range(len(grid_p) - 1, -1, -1):
        agg += (coords[d] // stride) * sa
        sa *= coarse_grid[d]
    agg = agg.reshape(-1)
    valid = np.asarray(A_p.diagonal() != 0).ravel()
    B = valid.astype(float)
    counts = np.bincount(agg[valid], minlength=nc).astype(float)
    norms = np.sqrt(counts)
    tvals = np.where(valid & (norms[agg] > 0), B / np.where(
        norms[agg] > 0, norms[agg], 1), 0.0)
    T = sp.csr_matrix((tvals, (np.arange(n_p), agg)), shape=(n_p, nc))
    d = A_p.diagonal()
    dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 0)
    S = sp.eye(n_p) - (omega / rho) * sp.diags(dinv) @ A_p
    # identity rows only where valid (device S zeroes padding rows)
    S = sp.diags(valid.astype(float)) @ S
    P = (S @ T).tocsr()
    A_c = (P.T @ A_p @ P).tocsr()
    return A_p, P, A_c, E


def _dia_to_scipy(D):
    n = D.n_pad
    rows = []
    cols = []
    vals = []
    data = np.asarray(D.data)
    for k, off in enumerate(D.offsets):
        i = np.arange(n)
        j = i + off
        ok = (j >= 0) & (j < n)
        rows.append(i[ok])
        cols.append(j[ok])
        vals.append(data[k][ok])
    M = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    M.eliminate_zeros()
    return M


def test_dia_transpose():
    A = poisson((7, 9), format="csr")
    A.data = A.data * (1 + 0.3 * np.random.default_rng(0).random(A.nnz))
    D = dia_from_scipy(A, dtype=jnp.float64, row_pad=1)
    Dt = dia_transpose(D)
    np.testing.assert_allclose(_dia_to_scipy(Dt).toarray(),
                               A.T.toarray(), atol=1e-14)


def test_structured_rap_golden():
    """Device P/R/RAP/compaction matches the scipy golden entrywise."""
    for grid in [(9, 12), (8, 10), (9, 9, 9)]:
        A = poisson(grid, format="csr")
        dml = device_sa_setup(A, grid=grid, dtype=jnp.float64,
                              max_coarse=2, max_levels=2)
        lvl0 = dml.hierarchy.levels[0]
        rho = float(dml.setup_info["levels"][0]["rho_D_inv_A"])
        A_p, P_host, A_c_host, E = _host_structured_sa(
            A, grid, stride=3, omega=4.0 / 3.0, rho=rho)

        # P application parity on random coarse vectors
        nc = P_host.shape[1]
        rng = np.random.default_rng(1)
        xc = rng.random(nc)
        dev = np.asarray(lvl0.P @ jnp.asarray(xc))
        np.testing.assert_allclose(dev, P_host @ xc, atol=1e-12)

        # R = P^T application parity
        r = rng.random(A_p.shape[0])
        dev_r = np.asarray(lvl0.R @ jnp.asarray(r))
        np.testing.assert_allclose(dev_r, P_host.T @ r, atol=1e-12)

        # Galerkin coarse operator parity (device DIA -> dense)
        A_c_dev = dml.hierarchy.levels[1].A
        dense_dev = np.asarray(A_c_dev @ jnp.eye(A_c_dev.n_pad))
        np.testing.assert_allclose(dense_dev, A_c_host.toarray(),
                                   atol=1e-11)


def test_device_setup_convergence_vs_host():
    """Convergence-factor parity band vs the host SA path (SURVEY.md §7
    hard part 3: parallel-equivalent setup, factor-parity acceptance)."""
    grid = (64, 64)
    A = poisson(grid, format="csr")
    b = np.random.default_rng(0).random(A.shape[0])

    ml = smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    rh = []
    ml.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=rh)

    dml = device_sa_setup(A, grid=grid, dtype=jnp.float64, max_coarse=100)
    rd = []
    x = dml.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=rd)

    f_host = (rh[-1] / rh[0]) ** (1.0 / (len(rh) - 1))
    f_dev = (rd[-1] / rd[0]) ** (1.0 / (len(rd) - 1))
    assert f_dev < 0.45, f_dev
    assert len(rd) - 1 <= (len(rh) - 1) + 8, (len(rd), len(rh))
    # converged against the TRUE operator (not just the embedded one)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


def test_device_setup_3d_and_nondivisible():
    for grid in [(14, 14, 14), (50, 47)]:
        A = poisson(grid, format="csr")
        b = np.random.default_rng(1).random(A.shape[0])
        dml = device_sa_setup(A, grid=grid, dtype=jnp.float64,
                              max_coarse=100)
        rd = []
        x = dml.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=rd)
        f_dev = (rd[-1] / rd[0]) ** (1.0 / (len(rd) - 1))
        assert f_dev < 0.5, (grid, f_dev)
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


def test_device_setup_chebyshev_smoother():
    grid = (48, 48)
    A = poisson(grid, format="csr")
    b = np.ones(A.shape[0])
    dml = device_sa_setup(
        A, grid=grid, dtype=jnp.float64, max_coarse=100,
        presmoother=("chebyshev", {"degree": 3}),
        postsmoother=("chebyshev", {"degree": 3}))
    rd = []
    dml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=rd)
    assert rd[-1] / rd[0] < 1e-7


def test_ns_pinv_matches_numpy():
    """Gather-free Newton-Schulz pinv (coarse solve) vs np.linalg.pinv."""
    from pyamg_tpu.engine.device_setup import _ns_pinv

    A = poisson((5, 5), format="csr").toarray()
    # pad with zero rows/cols like the compacted coarse operator
    Ap = np.zeros((27, 27))
    Ap[:25, :25] = A
    X = np.asarray(_ns_pinv(jnp.asarray(Ap)))
    want = np.linalg.pinv(Ap)
    np.testing.assert_allclose(X, want, atol=1e-8)
    # defining property on a singular matrix too
    As = np.zeros((8, 8))
    As[:4, :4] = np.array([[2., -1, 0, 0], [-1, 2, -1, 0],
                           [0, -1, 2, -1], [0, 0, -1, 2]])
    Xs = np.asarray(_ns_pinv(jnp.asarray(As)))
    np.testing.assert_allclose(As @ Xs @ As, As, atol=1e-9)


def test_semicoarsening_anisotropic_diffusion():
    """stride='auto' reads the stencil anisotropy and semicoarsens:
    grid-aligned anisotropic diffusion (eps=1e-3) drops from a ~0.93
    isotropic-stride factor to <0.25, with the plan switching to full
    coarsening once the aspect has evened out (1/h^2 law).  Directional
    smoothing keeps the per-level stencil bounded (ndiags <= 9)."""
    from pyamg_tpu.gallery import diffusion_stencil_2d, stencil_grid

    S = diffusion_stencil_2d(epsilon=1e-3, theta=0.0, type="FD")
    g = (128, 128)
    A = stencil_grid(S, g).tocsr()
    ds = device_sa_setup(A, grid=g, max_coarse=400, dtype=jnp.float64,
                         stride="auto")
    strides = [i["strides"] for i in ds.setup_info["levels"]]
    assert strides[0] == (1, 3)          # weak y-coupling: coarsen x only
    assert all(i["ndiags"] <= 9 for i in ds.setup_info["levels"])
    b = np.random.default_rng(0).random(A.shape[0])
    res = []
    x = ds.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
    factor = (res[-1] / res[0]) ** (1.0 / (len(res) - 1))
    assert factor < 0.25
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


def test_explicit_per_dim_strides():
    """Explicit per-dim stride tuples are honored and converge."""
    from pyamg_tpu.gallery import diffusion_stencil_2d, stencil_grid

    S = diffusion_stencil_2d(epsilon=1e-3, theta=0.0, type="FD")
    g = (48, 48)
    A = stencil_grid(S, g).tocsr()
    ds = device_sa_setup(A, grid=g, max_coarse=200, dtype=jnp.float64,
                         stride=(1, 3))
    assert ds.setup_info["levels"][0]["strides"] == (1, 3)
    b = np.random.default_rng(1).random(A.shape[0])
    res = []
    x = ds.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


def test_detect_grid_and_auto_setup():
    """detect_grid infers row-major grid shapes from stencil offsets;
    grid=None setups route through it."""
    from pyamg_tpu.engine import device_rs_setup, device_sa_setup
    from pyamg_tpu.engine.device_setup import detect_grid
    from pyamg_tpu.gallery import diffusion_stencil_2d, poisson, \
        stencil_grid

    assert detect_grid(poisson((48, 96), format="csr")) == (48, 96)
    assert detect_grid(poisson((8, 12, 20), format="csr")) == (8, 12, 20)
    A9 = stencil_grid(diffusion_stencil_2d(epsilon=1.0, type="FE"),
                      (32, 40)).tocsr()
    assert detect_grid(A9) == (32, 40)

    A = poisson((48, 48), format="csr")
    b = np.random.default_rng(0).random(A.shape[0])
    for setup in (device_sa_setup, device_rs_setup):
        ds = setup(A, max_coarse=150)            # no grid argument
        x = ds.solve(b, tol=1e-5, maxiter=40, accel="cg")
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-4


def test_improve_candidates_rescaled():
    """In-pipeline candidate improvement (the host improve_candidates
    analog): on a diagonally rescaled Poisson operator — whose
    near-nullspace is D^{-1/2}·1, not ones — the improvement sweeps
    recover most of the exact-candidate convergence."""
    import scipy.sparse as sp

    from pyamg_tpu.engine import device_sa_setup
    from pyamg_tpu.gallery import poisson

    grid = (48, 48)
    A = poisson(grid, format="csr")
    rng = np.random.default_rng(0)
    d = 10.0 ** rng.uniform(-2, 2, A.shape[0])
    Dh = sp.diags(np.sqrt(d))
    As = (Dh @ A @ Dh).tocsr()
    b = rng.random(As.shape[0])

    def iters(**kw):
        ds = device_sa_setup(As, grid=grid, max_coarse=150, **kw)
        res = []
        ds.solve(b, tol=1e-5, maxiter=60, accel="cg", residuals=res)
        return len(res) - 1

    it0 = iters(improve_candidates_iters=0)
    it8 = iters(improve_candidates_iters=8)
    it_exact = iters(B=1.0 / np.sqrt(d))
    assert it8 < it0 - 10, (it0, it8)          # big win from improvement
    assert it_exact <= it8, (it_exact, it8)    # exact candidate is best


def test_large_level_exact_padding():
    """Levels >= 65536 unknowns keep their exact padded-grid length (no
    extra solve-phase padding) and the hierarchy solves correctly."""
    import numpy as np
    import jax.numpy as jnp
    from pyamg_tpu.engine import device_sa_setup
    from pyamg_tpu.gallery import poisson

    A = poisson((256, 260), format="csr")      # 66560 >= 65536
    dsa = device_sa_setup(A, grid=(256, 260), dtype=jnp.float32,
                          max_coarse=200)
    for lvl in dsa.hierarchy.levels[:-1]:
        assert lvl.n_pad == lvl.n
        assert lvl.A.n_pad == lvl.n_pad
        assert lvl.pre.arrays[0].shape == (lvl.n_pad,)
    b = np.random.default_rng(9).random(A.shape[0])
    res = []
    dsa.solve(b, tol=1e-5, maxiter=40, accel="cg", residuals=res)
    assert res[-1] / res[0] < 1e-5


def test_device_adaptive_sa():
    """Device alpha-SA (round 3): stage-0 relaxed-ones candidate
    recovers the rescaled near-nullspace (iters ~ exact-candidate
    setup); stage 2 ACCUMULATES a cycled-out candidate through the
    multi-candidate block pipeline and must not regress.  Candidate
    REPLACEMENT (instead of accumulation) was measured worse than no
    adaptivity — this test pins the accumulating design."""
    import scipy.sparse as sp

    from pyamg_tpu.engine import device_adaptive_sa_setup, device_sa_setup
    from pyamg_tpu.gallery import poisson

    grid = (48, 48)
    A = poisson(grid, format="csr")
    rng = np.random.default_rng(0)
    d = 10.0 ** rng.uniform(-2, 2, A.shape[0])
    Dh = sp.diags(np.sqrt(d))
    As = (Dh @ A @ Dh).tocsr()
    b = rng.random(As.shape[0])

    def iters(ds):
        res = []
        ds.solve(b, tol=1e-5, maxiter=80, accel="cg", residuals=res)
        assert res[-1] / res[0] < 1e-5
        return len(res) - 1

    i0 = iters(device_sa_setup(As, grid=grid, max_coarse=150))
    ia1 = iters(device_adaptive_sa_setup(As, grid=grid, max_coarse=150,
                                         stages=1, candidate_iters=8))
    ia2 = iters(device_adaptive_sa_setup(As, grid=grid, max_coarse=150,
                                         stages=2, candidate_iters=8,
                                         cycle_iters=6))
    ie = iters(device_sa_setup(As, grid=grid, max_coarse=150,
                               B=1.0 / np.sqrt(d)))
    assert ia1 < i0 - 15, (i0, ia1)      # adaptivity recovers the mode
    assert ia2 <= ia1 + 3, (ia1, ia2)    # accumulation never regresses
    assert ia1 <= ie + 5, (ia1, ie)      # close to the exact candidate

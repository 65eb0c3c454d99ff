"""Dtype coverage (SURVEY.md §4 idiom 3: complex + index dtypes)."""

import numpy as np
import pytest
import scipy.sparse as sp

import pyamg_tpu
from pyamg_tpu.gallery import gauge_laplacian, poisson


def test_complex_sa_solve():
    """Complex Hermitian (gauge Laplacian) through SA + CG (host path)."""
    A = gauge_laplacian(16, beta=0.05).tocsr()
    ml = pyamg_tpu.smoothed_aggregation_solver(A, symmetry="hermitian")
    b = (np.random.default_rng(0).random(A.shape[0])
         + 1j * np.random.default_rng(1).random(A.shape[0]))
    res = []
    x = ml.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=res)
    assert res[-1] / res[0] < 1e-7
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-6


def test_complex_classical_strength():
    A = gauge_laplacian(8, beta=0.05).tocsr()
    S = pyamg_tpu.classical_strength_of_connection(A, theta=0.1)
    assert S.nnz > A.shape[0]
    assert not np.iscomplexobj(S.data)  # measures are real magnitudes


def test_int32_indices():
    A = poisson((20, 20), format="csr")
    A32 = sp.csr_matrix(
        (A.data, A.indices.astype(np.int32), A.indptr.astype(np.int32)),
        shape=A.shape)
    ml = pyamg_tpu.smoothed_aggregation_solver(A32)
    b = np.ones(A.shape[0])
    res = []
    ml.solve(b, tol=1e-8, residuals=res)
    assert res[-1] / res[0] < 1e-7


def test_float32_input():
    A = poisson((16, 16), format="csr").astype(np.float32)
    ml = pyamg_tpu.smoothed_aggregation_solver(A)
    b = np.ones(A.shape[0], dtype=np.float32)
    x = ml.solve(b, tol=1e-5)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-3


def test_integer_matrix_upcast():
    A = poisson((10, 10)).astype(np.int64).tocsr()
    ml = pyamg_tpu.ruge_stuben_solver(A)
    b = np.ones(A.shape[0])
    x = ml.solve(b, tol=1e-8)
    assert np.linalg.norm(b - A.astype(float) @ x) < 1e-4


def test_complex_classical_interpolation_weights():
    """Regression (ADVICE r1): the Python path of classical/distance-two
    interpolation built jvals with dtype=float64, silently discarding the
    imaginary parts of complex interpolation weights."""
    from pyamg_tpu.classical.interpolate import (classical_interpolation,
                                                 distance_two_interpolation)
    from pyamg_tpu.classical.split import RS

    A = poisson((8, 8), format="csr").astype(complex)
    # complex shift keeps A Hermitian-ish structure but complex weights
    A = (A + 0.1j * sp.eye(A.shape[0], format="csr")).tocsr()
    S = pyamg_tpu.classical_strength_of_connection(A, theta=0.25)
    splitting = RS(S)
    for interp in (classical_interpolation, distance_two_interpolation):
        P = interp(A, S, splitting)
        assert np.iscomplexobj(P.data)
        assert np.abs(P.data.imag).max() > 0, "imaginary parts lost"


def test_serialize_numpy_kwargs(tmp_path):
    """Regression (ADVICE r1): smoother kwargs holding numpy scalars or
    arrays crashed json.dumps at save time."""
    from pyamg_tpu.util.serialize import load_hierarchy, save_hierarchy

    from pyamg_tpu.relaxation.chebyshev import (
        chebyshev_polynomial_coefficients)
    from pyamg_tpu.util.linalg import approximate_spectral_radius

    A = poisson((12, 12), format="csr")
    rho = approximate_spectral_radius(A)
    coeff = np.asarray(
        chebyshev_polynomial_coefficients(rho / 30.0, 1.1 * rho, 3))
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A,
        presmoother=("jacobi", {"omega": np.float64(0.8),
                                "withrho": True}),
        postsmoother=("polynomial", {"coefficients": coeff}),
    )
    path = tmp_path / "h.npz"
    save_hierarchy(ml, path)
    ml2 = load_hierarchy(path)
    # ndarray kwarg survived as a list
    assert isinstance(
        ml2.levels[0].postsmoother_spec[1]["coefficients"], list)
    b = np.ones(A.shape[0])
    res = []
    ml2.solve(b, tol=1e-8, residuals=res)
    assert res[-1] / res[0] < 1e-7


def test_complex_device_solve():
    """Complex Hermitian device path (gauge Laplacian) matches host: DIA/
    dense/windowed staging, smoothers, Krylov all complex-aware (round-1
    verdict item 8 engine hole)."""
    import jax.numpy as jnp

    from pyamg_tpu.engine import as_device_solver

    A = gauge_laplacian(48, beta=0.05).tocsr()   # n = 2304 -> DIA path
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, symmetry="hermitian",
        presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    rng = np.random.default_rng(0)
    b = rng.random(A.shape[0]) + 1j * rng.random(A.shape[0])
    res_h = []
    ml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_h)

    dml = as_device_solver(ml, dtype=jnp.complex128, row_pad=8)
    res_d = []
    x = dml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_d)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7
    # jacobi is order-free: histories match to rounding
    m = min(len(res_h), len(res_d))
    np.testing.assert_allclose(res_d[:m], res_h[:m], rtol=1e-8)


def test_complex_windowed_split_device_solve():
    """LARGE complex hierarchy (gauge Laplacian 64^2): transfers compile
    to the re/im-SPLIT windowed forms, with R = P^H stored explicitly in
    the same form (a gather apply, never a scatter-add transpose), and
    the device solve matches the host history."""
    import jax.numpy as jnp

    from pyamg_tpu.engine import as_device_solver
    from pyamg_tpu.sparse import ComplexWindowed

    A = gauge_laplacian(64, beta=0.05).tocsr()   # n = 4096 > dense cutoff
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, symmetry="hermitian",
        presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    dml = as_device_solver(ml, dtype=jnp.complex128, row_pad=8)

    big = [lvl for lvl in dml.hierarchy.levels[:-1]
           if max(lvl.P.shape) > 2048]
    assert big, "expected at least one windowed-scale level"
    for lvl in big:
        assert isinstance(lvl.P, ComplexWindowed)
        assert isinstance(lvl.R, ComplexWindowed)   # R = P^H explicit

    rng = np.random.default_rng(0)
    b = rng.random(A.shape[0]) + 1j * rng.random(A.shape[0])
    res_h, res_d = [], []
    ml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_h)
    x = dml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_d)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7
    m = min(len(res_h), len(res_d))
    np.testing.assert_allclose(res_d[:m], res_h[:m], rtol=1e-8)


def test_complex_transposed_windowed_parity():
    """ComplexWindowed applies == scipy for a random complex rectangular
    operator: P @ x, the plain transpose P^T r, and P^H r through
    conjugation."""
    import jax.numpy as jnp

    from pyamg_tpu.sparse import complex_windowed_from_scipy

    rng = np.random.default_rng(5)
    n, m, per_row = 4096, 1500, 3
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip((rows * m) // n
                   + rng.integers(-40, 41, len(rows)), 0, m - 1)
    vals = rng.standard_normal(len(rows)) + 1j * rng.standard_normal(
        len(rows))
    P = sp.csr_matrix((vals, (rows, cols)), shape=(n, m))
    W = complex_windowed_from_scipy(P, dtype=jnp.complex128)
    assert W is not None
    x = rng.random(W.re.m_chunks * W.re.w2) * (1 + 0j)
    x += 1j * rng.random(W.re.m_chunks * W.re.w2)
    got = np.asarray(W.matvec(jnp.asarray(x)))[:n]
    np.testing.assert_allclose(got, P @ x[:m], rtol=1e-12, atol=1e-12)

    r = rng.random(n) + 1j * rng.random(n)
    rp = jnp.asarray(np.pad(r, (0, W.n_pad - n)))
    got_t = np.asarray(W.rmatvec(rp))[:m]
    np.testing.assert_allclose(got_t, P.T @ r, rtol=1e-12, atol=1e-12)
    got_h = np.conj(np.asarray(W.rmatvec(jnp.conj(rp))))[:m]
    np.testing.assert_allclose(got_h, P.conj().T @ r, rtol=1e-12,
                               atol=1e-12)

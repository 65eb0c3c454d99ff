"""NUMERICS of the XLA operator forms the device cycle runs.

DIA SpMV / transpose / K-major matmat, the Jacobi sweep and the
zero-entry sweep + residual, the structured transfer applies, and the
windowed gather/scatter applies — each against scipy in float64 on the
exact device inputs, plus the host-built hierarchy's transfer storage.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from pyamg_tpu.engine import relaxation as rx
from pyamg_tpu.gallery import poisson
from pyamg_tpu.sparse import pad_vector
from pyamg_tpu.sparse.dia import dia_from_scipy
from pyamg_tpu.sparse.window import (TransposedWindowed, WindowedELL,
                                     windowed_from_scipy)


def _random_rect(n, m, per_row, spread, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip((rows * m) // n + rng.integers(-spread, spread + 1,
                                                  len(rows)), 0, m - 1)
    vals = rng.standard_normal(len(rows))
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, m))


def _padded(A, n_pad):
    """scipy A embedded in the (n_pad, n_pad) padded index space."""
    M = sp.csr_matrix(A, copy=True)
    M.resize((n_pad, n_pad))
    return M


def _f64(v):
    return np.asarray(v, dtype=np.float64)


def _dinv(D):
    d = D.diagonal()
    return jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 0.0)


def _rand(rng, shape, n_pad=None):
    v = jnp.asarray(rng.random(shape), dtype=jnp.float32)
    return v if n_pad is None else pad_vector(v, n_pad)


def test_dia_matvec_vs_scipy():
    """Shifted-slice DIA SpMV == scipy, including lane-crossing offsets
    (+-1) and grid-row offsets (+-gridwidth); == the roll form bitwise."""
    A = poisson((64, 64), format="csr")
    D = dia_from_scipy(A, dtype=jnp.float32, row_pad=1024)
    x = _rand(np.random.default_rng(0), A.shape[0], D.n_pad)
    got = np.asarray(D.matvec(x))
    np.testing.assert_allclose(got, _padded(A, D.n_pad) @ _f64(x),
                               rtol=2e-6, atol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(D.matmat(x[:, None]))[:, 0])


def test_dia_jacobi_step_vs_scipy():
    """Jacobi sweep x + w*dinv*(b - A@x) == scipy, static and
    device-resident omega (jacobi_dyn)."""
    A = poisson((64, 64), format="csr")
    D = dia_from_scipy(A, dtype=jnp.float32, row_pad=1024)
    rng = np.random.default_rng(1)
    x = _rand(rng, A.shape[0], D.n_pad)
    b = _rand(rng, A.shape[0], D.n_pad)
    dinv = _dinv(D)
    want = _f64(x) + 0.85 * _f64(dinv) * (_f64(b)
                                         - _padded(A, D.n_pad) @ _f64(x))
    got = np.asarray(rx.jacobi(dinv, 0.85)(D, x, b))
    np.testing.assert_allclose(got, want, atol=2e-6)
    got_dyn = np.asarray(rx.jacobi_dyn(
        dinv, jnp.asarray(0.85, dtype=jnp.float32))(D, x, b))
    np.testing.assert_allclose(got_dyn, want, atol=2e-6)


def test_dia_matvec_jacobi_512():
    """SpMV and Jacobi sweep at 512^2 (wide offsets, both array ends)."""
    A = poisson((512, 512), format="csr")
    D = dia_from_scipy(A, dtype=jnp.float32)
    rng = np.random.default_rng(13)
    x = _rand(rng, A.shape[0], D.n_pad)
    b = _rand(rng, A.shape[0], D.n_pad)
    Ap = _padded(A, D.n_pad)
    np.testing.assert_allclose(np.asarray(jax.jit(D.matvec)(x)),
                               Ap @ _f64(x), rtol=2e-6, atol=1e-6)
    dinv = _dinv(D)
    want = _f64(x) + 0.85 * _f64(dinv) * (_f64(b) - Ap @ _f64(x))
    got = np.asarray(jax.jit(lambda v, w: rx.jacobi(dinv, 0.85)(D, v, w))(
        x, b))
    np.testing.assert_allclose(got, want, atol=3e-6)


@pytest.mark.parametrize("block", [256, 1024, 2048])
def test_windowed_matvec_vs_scipy(block):
    """Windowed gather SpMV == scipy, multiple row-block sizes."""
    P = _random_rect(4096, 1500, per_row=3, spread=40, seed=2)
    W = windowed_from_scipy(P, block=block)
    assert W is not None and W.block == block
    x = jnp.asarray(np.random.default_rng(3).random(W.m_chunks * W.w2),
                    dtype=jnp.float32)
    got = np.asarray(jax.jit(W.matvec)(x))[: P.shape[0]]
    np.testing.assert_allclose(got, P @ _f64(x)[: P.shape[1]], rtol=2e-6,
                               atol=1e-6)


@pytest.mark.parametrize("K", [2, 8])
def test_windowed_matmat_k_vs_scipy(K):
    """K-major windowed apply (vmap of the gather) == scipy A @ X."""
    P = _random_rect(4096, 1500, per_row=3, spread=40, seed=7)
    W = windowed_from_scipy(P, block=256)
    Xk = jnp.asarray(
        np.random.default_rng(8).random((K, W.m_chunks * W.w2)),
        dtype=jnp.float32)
    got = np.asarray(W.matmat_k(Xk))[:, : P.shape[0]]
    want = (P @ _f64(Xk)[:, : P.shape[1]].T).T
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_windowed_rmatvec_vs_scipy():
    """Scatter-add transpose apply == scipy A.T @ r across overlapping
    windows (adaptive block)."""
    P = _random_rect(8192, 2600, per_row=4, spread=60, seed=4)
    W = windowed_from_scipy(P)
    assert W is not None
    r = jnp.asarray(np.random.default_rng(5).random(W.n_pad),
                    dtype=jnp.float32)
    got = np.asarray(W.rmatvec(r))[: P.shape[1]]
    np.testing.assert_allclose(got, P.T @ _f64(r)[: P.shape[0]],
                               rtol=2e-6, atol=1e-6)


def test_restriction_shares_prolongator():
    """compile_hierarchy compiles large SA transfers to the FACTORED form
    (ComposedOperator: DIA smoothing factor + windowed tentative); R
    keeps the factored form with T^T stored EXPLICITLY (a gather, never
    a scatter-add transpose of P's tentative), and the device solve
    matches the host solve history."""
    import pyamg_tpu
    from pyamg_tpu.engine import DeviceMultilevelSolver, compile_hierarchy
    from pyamg_tpu.sparse.composed import ComposedOperator

    A = poisson((48, 48), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, presmoother=("jacobi", {"omega": 4.0 / 3.0}),
        postsmoother=("jacobi", {"omega": 4.0 / 3.0}),
        max_coarse=100)
    h = compile_hierarchy(ml, dtype=jnp.float64, row_pad=8)
    big = [lvl for lvl in h.levels[:-1] if max(lvl.R.shape) > 2048]
    assert big
    for lvl, hl in zip(h.levels[:-1], ml.levels):
        if max(lvl.R.shape) <= 2048:
            continue
        assert isinstance(lvl.P, ComposedOperator)
        assert isinstance(lvl.R, ComposedOperator)
        Tt = lvl.R.ops[0]
        assert isinstance(Tt, WindowedELL)
        assert not any(isinstance(op, TransposedWindowed)
                       for op in lvl.R.ops)
        T = hl.P._sa_factor["T"]
        r = np.random.default_rng(0).random(Tt.m_chunks * Tt.w2)
        np.testing.assert_allclose(
            np.asarray(Tt.matvec(jnp.asarray(r)))[: T.shape[1]],
            T.T @ r[: T.shape[0]], rtol=1e-13, atol=1e-13)

    dml = DeviceMultilevelSolver(h)
    b = np.random.default_rng(6).random(A.shape[0])
    res_d, res_h = [], []
    dml.solve(b, tol=1e-10, maxiter=25, accel="cg", residuals=res_d)
    ml.solve(b, tol=1e-10, maxiter=25, accel="cg", residuals=res_h)
    assert len(res_d) == len(res_h)
    np.testing.assert_allclose(res_d, res_h, rtol=1e-8)


def test_factored_transfer_parity():
    """Factored device P/R (S^d·T composed ops) == scipy P/R applies to
    f64 rounding, for degree 1 and 2 jacobi prolongation smoothing."""
    import pyamg_tpu
    from pyamg_tpu.engine import compile_hierarchy
    from pyamg_tpu.sparse.composed import ComposedOperator

    A = poisson((96, 96), format="csr")
    for degree in (1, 2):
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, smooth=("jacobi", {"degree": degree}), max_levels=2)
        Ph = ml.levels[0].P
        assert hasattr(Ph, "_sa_factor")
        fac = Ph._sa_factor
        assert fac["degree"] == degree
        # rebuild S from the recipe and check P == S^degree @ T exactly
        A0 = sp.csr_matrix(ml.levels[0].A)
        Dinv = sp.dia_matrix((fac["dinv"].reshape(1, -1), [0]),
                             shape=A0.shape)
        S = (sp.identity(A0.shape[0]) - fac["omega"] * (Dinv @ A0)).tocsr()
        T = fac["T"]
        err = abs((S @ (S @ T) if degree == 2 else S @ T) - Ph).max()
        assert err < 1e-14
        h = compile_hierarchy(ml, dtype=jnp.float64, row_pad=8)
        l0 = h.levels[0]
        assert isinstance(l0.P, ComposedOperator)
        assert len(l0.P.ops) == degree + 1
        xc = np.random.default_rng(10).random(Ph.shape[1])
        got = np.asarray(l0.P @ jnp.asarray(xc))[: Ph.shape[0]]
        np.testing.assert_allclose(got, Ph @ xc, rtol=1e-13, atol=1e-13)
        r = np.random.default_rng(11).random(Ph.shape[0])
        got_r = np.asarray(l0.R @ pad_vector(jnp.asarray(r),
                                             l0.n_pad))[: Ph.shape[1]]
        np.testing.assert_allclose(got_r, ml.levels[0].R @ r,
                                   rtol=1e-13, atol=1e-13)


def test_nonsymmetric_restriction_transposed_windowed():
    """When R != P^T (nonsymmetric SA), R is stored explicitly as its own
    windowed operator (gather apply) and matches scipy."""
    from pyamg_tpu.engine.hierarchy import _restriction_operator, \
        _transfer_operator

    P = _random_rect(6144, 2100, per_row=3, spread=30, seed=7)
    R = _random_rect(2100, 6144, per_row=5, spread=90, seed=8).T.T
    P_dev = _transfer_operator(P, jnp.float64, 8)
    R_dev = _restriction_operator(sp.csr_matrix(R), P, P_dev, jnp.float64, 8)
    assert not isinstance(R_dev, TransposedWindowed)
    r = np.random.default_rng(9).random(6144)
    got = np.asarray(R_dev @ jnp.asarray(r))[:2100]
    np.testing.assert_allclose(got, R @ r, atol=1e-10)


@pytest.mark.parametrize("K", [2, 8])
def test_dia_matmat_vs_scipy(K):
    """Column-stack and K-major DIA applies == scipy A @ X at 512^2."""
    A = poisson((512, 512), format="csr")
    D = dia_from_scipy(sp.csr_matrix(A), dtype=jnp.float32)
    X = jnp.asarray(np.random.default_rng(0).random((D.n_pad, K)),
                    dtype=jnp.float32)
    want = _padded(A, D.n_pad) @ _f64(X)
    np.testing.assert_allclose(np.asarray(D.matmat(X)), want, rtol=3e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(D.matmat_k(X.T)).T, want,
                               rtol=3e-6, atol=1e-6)


def test_dia_jacobi_step_batched():
    """vmapped K-lane Jacobi sweep == scipy per lane (K-major lanes)."""
    A = poisson((512, 512), format="csr")
    D = dia_from_scipy(sp.csr_matrix(A), dtype=jnp.float32)
    rng = np.random.default_rng(2)
    K = 4
    Xk = jnp.asarray(rng.random((K, D.n_pad)), dtype=jnp.float32)
    Bk = jnp.asarray(rng.random((K, D.n_pad)), dtype=jnp.float32)
    dinv = _dinv(D)
    sm = rx.jacobi(dinv, 0.8)
    got = np.asarray(jax.vmap(lambda x, b: sm(D, x, b))(Xk, Bk))
    Ap = _padded(A, D.n_pad)
    for k in range(K):
        want = _f64(Xk[k]) + 0.8 * _f64(dinv) * (_f64(Bk[k])
                                                 - Ap @ _f64(Xk[k]))
        np.testing.assert_allclose(got[k], want, atol=3e-6)


@pytest.mark.parametrize("K", [2, 8])
def test_windowed_rmatmat_k_vs_scipy(K):
    """K-major transpose apply (vmap of the scatter-add) == scipy A.T @ X."""
    P = _random_rect(4096, 1500, per_row=3, spread=40, seed=11)
    W = windowed_from_scipy(P, block=256)
    Xk = jnp.asarray(np.random.default_rng(12).random((K, W.n_pad)),
                     dtype=jnp.float32)
    got = np.asarray(W.rmatmat_k(Xk))[:, : P.shape[1]]
    want = (P.T @ _f64(Xk)[:, : P.shape[0]].T).T
    np.testing.assert_allclose(got, want, rtol=3e-6, atol=1e-6)


def test_windowed_select_exact():
    """Per-slot window selection (unstructured setup's graph-pass
    primitive): out[b, s, r] == x[column(b, s, r)] exactly."""
    P = _random_rect(4096, 4096, per_row=5, spread=70, seed=21)
    W = windowed_from_scipy(P, block=256)
    rng = np.random.default_rng(22)
    x = jnp.asarray(rng.integers(0, 2 ** 23, W.m_chunks * W.w2),
                    dtype=jnp.float32)
    got = np.asarray(jax.jit(W.select)(x))
    gidx = (np.asarray(W.starts)[:, None, None] * W.w2
            + np.asarray(W.idx))
    np.testing.assert_array_equal(got, np.asarray(x)[gidx])


def test_windowed_select_f32_payloads():
    """Arbitrary f32 payloads (and non-finite ones) come back exactly:
    the selection is a plain gather."""
    P = _random_rect(4096, 4096, per_row=5, spread=70, seed=23)
    W = windowed_from_scipy(P, block=256)
    rng = np.random.default_rng(24)
    xh = (rng.standard_normal(W.m_chunks * W.w2) * 1e3).astype(np.float32)
    xh[::97] = np.inf
    got = np.asarray(W.select(jnp.asarray(xh)))
    gidx = (np.asarray(W.starts)[:, None, None] * W.w2
            + np.asarray(W.idx))
    np.testing.assert_array_equal(got, xh[gidx])


def _structured_level(n=48):
    from pyamg_tpu.engine import device_sa_setup
    from pyamg_tpu.sparse import dia_from_stencil

    S1 = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], dtype=float)
    Ad = dia_from_stencil(S1, (n, n), dtype=jnp.float32)
    dsa = device_sa_setup(Ad, grid=(n, n), dtype=jnp.float32,
                          max_coarse=100)
    return dsa.hierarchy


def test_structured_transfers_vs_scipy():
    """Structured P = S·spread(tv) and R = P^T applies == scipy P, P^T
    built from the factor's data (the cycle's prolongation add and
    restriction tv-scale run through these)."""
    from chip_smoke import _embed_coarse, _unembed_coarse, \
        structured_reference

    lvl = _structured_level().levels[0]
    P, R = lvl.P, lvl.R
    Pref = structured_reference(P)
    rng = np.random.default_rng(31)
    xc = rng.standard_normal(Pref.shape[1]).astype(np.float32)
    got = np.asarray(P @ jnp.asarray(_embed_coarse(xc, P)))
    np.testing.assert_allclose(got[: Pref.shape[0]], Pref @ _f64(xc),
                               rtol=1e-5, atol=1e-5)
    x = jnp.asarray(rng.standard_normal(lvl.n_pad), dtype=jnp.float32)
    got = x + P @ jnp.asarray(_embed_coarse(xc, P))
    np.testing.assert_allclose(
        np.asarray(got)[: Pref.shape[0]],
        _f64(x)[: Pref.shape[0]] + Pref @ _f64(xc), rtol=1e-5, atol=1e-5)
    r = jnp.asarray(rng.standard_normal(lvl.n_pad), dtype=jnp.float32)
    np.testing.assert_allclose(
        _unembed_coarse(R @ r, P), Pref.T @ _f64(r)[: Pref.shape[0]],
        rtol=1e-5, atol=1e-5)


def test_jacobi_zero_call_residual_vs_scipy():
    """Zero-entry sweep + residual (x, r) = (w*dinv*b, b - A@x) ==
    scipy, static and device-resident omega."""
    A = poisson((512, 512), format="csr")
    D = dia_from_scipy(A, dtype=jnp.float32, row_pad=32768)
    b = _rand(np.random.default_rng(7), A.shape[0], D.n_pad)
    dinv = _dinv(D)
    Ap = _padded(A, D.n_pad)
    for sm in (rx.jacobi(dinv, 0.85),
               rx.jacobi_dyn(dinv, jnp.asarray(0.85, dtype=jnp.float32))):
        x = sm.zero_call(D, b)
        r = b - D @ x
        np.testing.assert_allclose(np.asarray(x),
                                   0.85 * _f64(dinv) * _f64(b), atol=2e-6)
        np.testing.assert_allclose(np.asarray(r), _f64(b) - Ap @ _f64(x),
                                   atol=2e-5)


def test_zero_call_matches_full_sweep():
    """DeviceSmoother.zero_call == the full sweep from x = 0, single and
    vmapped over b lanes; multi-sweep smoothers too."""
    A = poisson((32, 32), format="csr")
    D = dia_from_scipy(A, dtype=jnp.float32, row_pad=128)
    b = _rand(np.random.default_rng(3), A.shape[0], D.n_pad)
    dinv = _dinv(D)
    for iters in (1, 2):
        sm = rx.jacobi(dinv, 0.85, iterations=iters)
        np.testing.assert_allclose(
            np.asarray(sm.zero_call(D, b)),
            np.asarray(sm(D, jnp.zeros_like(b), b)), atol=1e-6)
    sm = rx.jacobi(dinv, 0.85)
    Bk = jnp.stack([b, 2.0 * b, -b])
    xk = jax.vmap(lambda bb: sm.zero_call(D, bb))(Bk)
    for k in range(3):
        np.testing.assert_allclose(np.asarray(xk[k]),
                                   np.asarray(sm.zero_call(D, Bk[k])),
                                   atol=1e-6)


def test_jacobi_sweep_residual_vs_scipy():
    """Nonzero-entry sweep + residual (y, r) = (x + w*dinv*(b - A@x),
    b - A@y) == scipy at 512^2."""
    A = poisson((512, 512), format="csr")
    D = dia_from_scipy(A, dtype=jnp.float32, row_pad=32768)
    rng = np.random.default_rng(11)
    x = _rand(rng, A.shape[0], D.n_pad)
    b = _rand(rng, A.shape[0], D.n_pad)
    dinv = _dinv(D)
    Ap = _padded(A, D.n_pad)
    y = rx.jacobi(dinv, 0.85)(D, x, b)
    r = b - D @ y
    y_want = _f64(x) + 0.85 * _f64(dinv) * (_f64(b) - Ap @ _f64(x))
    np.testing.assert_allclose(np.asarray(y), y_want, atol=2e-6)
    np.testing.assert_allclose(np.asarray(r), _f64(b) - Ap @ _f64(y),
                               atol=2e-5)


def test_smoother_sweep_vmapped():
    """A vmapped smoother sweep == per-lane sweeps (K-major lanes)."""
    A = poisson((32, 32), format="csr")
    D = dia_from_scipy(A, dtype=jnp.float32, row_pad=128)
    rng = np.random.default_rng(5)
    x = _rand(rng, A.shape[0], D.n_pad)
    b = _rand(rng, A.shape[0], D.n_pad)
    sm = rx.jacobi(_dinv(D), 0.85)
    Xk = jnp.stack([x, -x, 0.0 * x])
    Bk = jnp.stack([b, 2.0 * b, b])
    yk = jax.vmap(lambda xx, bb: sm(D, xx, bb))(Xk, Bk)
    for k in range(3):
        np.testing.assert_allclose(np.asarray(yk[k]),
                                   np.asarray(sm(D, Xk[k], Bk[k])),
                                   atol=1e-6)


def test_dia_matmat_k_vs_scipy():
    """K-major matmat and transpose matmat == scipy per lane."""
    A = poisson((64, 64), format="csr")
    D = dia_from_scipy(A, dtype=jnp.float32, row_pad=1024)
    Xk = jnp.asarray(np.random.default_rng(13).random((4, D.n_pad)),
                     dtype=jnp.float32)
    Ap = _padded(A, D.n_pad)
    np.testing.assert_allclose(np.asarray(D.matmat_k(Xk)),
                               (Ap @ _f64(Xk).T).T, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(np.asarray(D.rmatmat_k(Xk)),
                               (Ap.T @ _f64(Xk).T).T, rtol=2e-6, atol=2e-6)


def test_jacobi_zero_call_batched_vs_scipy():
    """vmapped zero-entry sweep + residual == scipy per lane."""
    A = poisson((64, 64), format="csr")
    D = dia_from_scipy(A, dtype=jnp.float32, row_pad=1024)
    Bk = jnp.asarray(np.random.default_rng(17).random((4, D.n_pad)),
                     dtype=jnp.float32)
    dinv = _dinv(D)
    sm = rx.jacobi(dinv, 0.85)
    Xg, Rg = jax.vmap(lambda b: (lambda x: (x, b - D @ x))(
        sm.zero_call(D, b)))(Bk)
    Ap = _padded(A, D.n_pad)
    for k in range(4):
        xw = 0.85 * _f64(dinv) * _f64(Bk[k])
        np.testing.assert_allclose(np.asarray(Xg[k]), xw, atol=2e-6)
        np.testing.assert_allclose(np.asarray(Rg[k]),
                                   _f64(Bk[k]) - Ap @ _f64(Xg[k]),
                                   atol=2e-5)


def test_cycle_zero_entry_front_end_vs_scipy():
    """The cycle's zero-entry level front-end (x, rc) = (w*dinv*b,
    R (b - A x)) on a device-built level == scipy."""
    from chip_smoke import _unembed_coarse, dia_to_scipy, \
        structured_reference

    lvl = _structured_level().levels[0]
    b = jnp.asarray(np.random.default_rng(23).random(lvl.n_pad),
                    dtype=jnp.float32)
    x = lvl.pre.zero_call(lvl.A, b)
    rc = lvl.R @ (b - lvl.A @ x)
    dinv, omega = lvl.pre.arrays
    np.testing.assert_allclose(np.asarray(x),
                               float(omega) * _f64(dinv) * _f64(b),
                               rtol=1e-6, atol=1e-6)
    Pref = structured_reference(lvl.P)
    nf = Pref.shape[0]
    r = _f64(b) - dia_to_scipy(lvl.A) @ _f64(x)
    np.testing.assert_allclose(_unembed_coarse(rc, lvl.P),
                               Pref.T @ r[:nf], rtol=1e-4, atol=1e-4)


def test_zero_chain_cycle_equivalence():
    """The vmapped zero-entry V-cycle on a device-built hierarchy equals
    per-lane single cycles (the batched solves' K-major route)."""
    from pyamg_tpu.engine.solver import _make_cycle

    h = _structured_level()
    b = jnp.asarray(np.random.default_rng(3).random(h.levels[0].n_pad),
                    dtype=jnp.float32)
    oc = _make_cycle(len(h.levels), "V")
    Bk = jnp.stack([b, 2.0 * b, -0.5 * b])
    yk = jax.vmap(lambda v: oc.zero(h, v))(Bk)
    for k in range(3):
        yw = oc.zero(h, Bk[k])
        np.testing.assert_allclose(np.asarray(yk[k]), np.asarray(yw),
                                   rtol=1e-4, atol=1e-4)


def test_cycle_front_end_batched():
    """vmapped front-end (x, R (b - A x)) over K=4 lanes == per lane."""
    lvl = _structured_level().levels[0]
    Bk = jnp.asarray(np.random.default_rng(29).random((4, lvl.n_pad)),
                     dtype=jnp.float32)

    def front(b):
        x = lvl.pre.zero_call(lvl.A, b)
        return x, lvl.R @ (b - lvl.A @ x)

    Xg, Yg = jax.vmap(front)(Bk)
    for k in range(4):
        xw, yw = front(Bk[k])
        np.testing.assert_allclose(np.asarray(Xg[k]), np.asarray(xw),
                                   atol=2e-6)
        np.testing.assert_allclose(np.asarray(Yg[k]), np.asarray(yw),
                                   atol=2e-5)

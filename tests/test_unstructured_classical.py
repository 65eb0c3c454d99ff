"""Device UNSTRUCTURED classical setup (engine/unstructured_classical.py,
round 5, VERDICT r4 item 3).

Validates the grid-free classical device pipeline: PMIS splitting
properties, entrywise-exact chain-probed RAP on the direct-interp P,
iteration parity vs host RS (±3, the done-criterion), auto-routing from
device_rs_setup / device_air_setup, and unstructured AIR on a
nonsymmetric-pattern advection operator.  Reference counterpart: [R]
pyamg/classical/ (SURVEY.md §2.2 S:111-114)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import pyamg_tpu
from pyamg_tpu.engine import (device_air_setup, device_rs_setup,
                              device_unstructured_air_setup,
                              device_unstructured_rs_setup)
from pyamg_tpu.engine.unstructured_classical import (_stage_pmis,
                                                     _cls_strength_mask,
                                                     _flat)
from pyamg_tpu.gallery import (advection_2d, gradgradform,
                               regular_triangle_mesh)
from pyamg_tpu.sparse import windowed_from_scipy


def _fem_matrix(nx):
    V, E = regular_triangle_mesh(nx, nx)
    A = sp.csr_matrix(gradgradform(V, E))
    return (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()


def _windowed_to_scipy(W):
    data = np.asarray(W.data)
    idx = np.asarray(W.idx)
    starts = np.asarray(W.starts)
    nb, k, B = data.shape
    rows = np.broadcast_to(
        (np.arange(nb) * B)[:, None, None]
        + np.arange(B)[None, None, :], data.shape).ravel()
    cols = (starts[:, None, None] * W.w2 + idx).ravel()
    vals = data.ravel()
    keep = (vals != 0) & (rows < W.shape[0])
    ncols = max(W.shape[1], int(cols[keep].max()) + 1 if keep.any() else 1)
    M = sp.coo_matrix((vals[keep], (rows[keep], cols[keep])),
                      shape=(W.shape[0], ncols))
    return sp.csr_matrix(M)


class TestPMIS:
    def test_every_f_has_strong_c_neighbor(self):
        """The property direct interpolation requires: each F point
        keeps >= 1 strong C OUT-neighbor."""
        A = _fem_matrix(30)
        W = windowed_from_scipy(A, dtype=jnp.float32, block=1024)
        c_f = np.asarray(_stage_pmis(W, theta=0.25, seed=0, norm="abs"))
        n = A.shape[0]
        is_c = c_f[:n] > 0.5
        assert 0 < is_c.sum() < n
        # host-side strength graph (classical, abs)
        S = pyamg_tpu.classical_strength_of_connection(
            A, theta=0.25, norm="abs")
        S = sp.csr_matrix(S)
        covered = np.asarray(
            (S @ is_c.astype(float)) > 0).ravel()
        f_pts = ~is_c
        assert covered[f_pts].all()

    def test_strength_mask_matches_host(self):
        A = _fem_matrix(20)
        W = windowed_from_scipy(A, dtype=jnp.float32, block=1024)
        mask, data, col, row = _cls_strength_mask(W, 0.25, "abs")
        n = A.shape[0]
        mask = np.asarray(mask)[:, :n]
        col_h = np.asarray(col)[:, :n]
        S_dev = set()
        for s in range(mask.shape[0]):
            for i in np.flatnonzero(mask[s]):
                S_dev.add((i, int(col_h[s, i])))
        S = sp.coo_matrix(pyamg_tpu.classical_strength_of_connection(
            A, theta=0.25, norm="abs"))
        S_host = {(int(i), int(j)) for i, j, v in
                  zip(S.row, S.col, S.data) if i != j and v != 0}
        assert S_dev == S_host


class TestUnstructuredRS:
    def test_rap_entrywise_exact_direct(self):
        """The banded probe recovers P^T A P EXACTLY for the direct
        interpolation P (same invariant as the SA pipeline test)."""
        A = _fem_matrix(24)
        dml = device_unstructured_rs_setup(A, max_coarse=100,
                                           interpolation="direct",
                                           max_levels=2)
        lvl0 = dml.hierarchy.levels[0]
        P = _windowed_to_scipy(lvl0.P)[:A.shape[0]]
        nc = dml.hierarchy.levels[1].n
        P = P[:, :nc]
        Ac_exact = (P.T @ A @ P).toarray()
        Ac_dev = np.asarray(dml.hierarchy.levels[1].A.data)[:nc, :nc]
        assert np.allclose(Ac_dev, Ac_exact, rtol=2e-5, atol=1e-6)

    @pytest.mark.parametrize("nx", [40, 80])
    def test_iteration_parity_vs_host_rs(self, nx):
        """Done-criterion (VERDICT r4 item 3): iteration parity ±3 vs
        host RS on the FEM problem."""
        A = _fem_matrix(nx)
        b = np.random.default_rng(0).random(A.shape[0])
        ml = pyamg_tpu.ruge_stuben_solver(A, max_coarse=200)
        res_h = []
        ml.solve(b, tol=1e-6, maxiter=60, accel="cg", residuals=res_h)
        dml = device_unstructured_rs_setup(A, max_coarse=200)
        res_d = []
        dml.solve(b, tol=1e-6, maxiter=60, accel="cg", residuals=res_d)
        assert res_d[-1] / res_d[0] < 1e-6
        assert len(res_d) - 1 <= len(res_h) - 1 + 3, (
            len(res_d) - 1, len(res_h) - 1)

    def test_autoroute_from_device_rs_setup(self):
        """device_rs_setup(grid=None) on a non-stencil operator routes
        to the unstructured pipeline.  (The raw regular-mesh FEM matrix
        IS a detectable stencil; RCM-permuting keeps windows bounded
        but kills the constant-offset structure.)"""
        A = sp.csr_matrix(pyamg_tpu.graph.symmetric_rcm(_fem_matrix(30)))
        b = np.random.default_rng(1).random(A.shape[0])
        dml = device_rs_setup(A, max_coarse=200)
        res = []
        dml.solve(b, tol=1e-6, maxiter=40, accel="cg", residuals=res)
        assert res[-1] / res[0] < 1e-6
        assert dml.setup_info["levels"][0]["family"] == "rs"

    def test_modified_beats_or_ties_direct(self):
        A = _fem_matrix(40)
        b = np.random.default_rng(2).random(A.shape[0])
        iters = {}
        for interp in ("direct", "modified"):
            dml = device_unstructured_rs_setup(A, max_coarse=200,
                                               interpolation=interp)
            res = []
            dml.solve(b, tol=1e-6, maxiter=60, accel="cg",
                      residuals=res)
            iters[interp] = len(res) - 1
        assert iters["modified"] <= iters["direct"]


class TestUnstructuredAIR:
    def test_advection_nonsymmetric_pattern(self):
        """Unstructured AIR on upwind advection: the pattern is
        nonsymmetric (the structured path's windowed planning would be
        wrong without host-side symmetrization); a single cycle must
        drop the residual by >= 1e4 and FGMRES must converge fast."""
        A, b = advection_2d((64, 64), theta=np.pi / 4)
        A = sp.csr_matrix(A)
        assert ((A != 0) != (A.T != 0)).nnz > 0     # really nonsymmetric
        dml = device_unstructured_air_setup(A, max_coarse=200)
        res = []
        dml.solve(b, tol=1e-8, maxiter=2, residuals=res)
        assert res[0] / res[1] > 1e4, res[:2]
        res = []
        dml.solve(b, tol=1e-8, maxiter=30, accel="fgmres",
                  residuals=res)
        assert res[-1] / res[0] < 1e-8
        assert len(res) - 1 <= 10

    def test_autoroute_from_device_air_setup(self):
        """device_air_setup(grid=None) on a non-stencil nonsymmetric
        operator routes to unstructured AIR."""
        A, b = advection_2d((48, 48), theta=np.pi / 3)
        A = sp.csr_matrix(A)
        # advection_2d IS a stencil grid — RCM-permute so detect_grid
        # fails and the call must route (b permutes with the rows)
        from scipy.sparse import csgraph
        perm = csgraph.reverse_cuthill_mckee(
            sp.csr_matrix(abs(A) + abs(A.T)), symmetric_mode=True)
        A = sp.csr_matrix(A[perm][:, perm])
        b = np.asarray(b)[perm]
        from pyamg_tpu.engine.device_setup import detect_grid
        with pytest.raises(ValueError):
            detect_grid(A)
        dml = device_air_setup(A, max_coarse=200)
        res = []
        dml.solve(b, tol=1e-8, maxiter=30, accel="fgmres",
                  residuals=res)
        assert res[-1] / res[0] < 1e-8

    def test_degree_improves_convergence(self):
        """The Neumann-series degree buys Krylov iterations (measured:
        degree 0/1/2 -> 17/5/4 FGMRES iters at 48^2; the first-cycle
        drop alone is NOT monotone — the F/C smoothing dominates it at
        small sizes)."""
        A, b = advection_2d((48, 48), theta=np.pi / 4)
        A = sp.csr_matrix(A)
        iters = {}
        for degree in (0, 2):
            dml = device_unstructured_air_setup(A, max_coarse=100,
                                                degree=degree)
            res = []
            dml.solve(b, tol=1e-8, maxiter=40, accel="fgmres",
                      residuals=res)
            assert res[-1] / res[0] < 1e-8
            iters[degree] = len(res) - 1
        assert iters[2] < iters[0], iters
        assert iters[2] <= 8, iters


class TestAutoReorder:
    """Round 5 (VERDICT r4 item 4): non-windowable orderings auto-RCM
    instead of raising; residual history matches a manual reorder.

    Windows span up to 2*max_w2 columns, so with the production
    max_w2=16384 only n > 32768 can be non-windowable — too slow for a
    CPU test.  The fixture caps max_w2 at 1024 (the minimum window), so
    a scrambled 6400-dof FEM matrix is non-windowable while its RCM
    reordering (bandwidth ~2*nx) is."""

    @pytest.fixture(autouse=True)
    def _small_windows(self, monkeypatch):
        import functools
        from pyamg_tpu.engine import (unstructured_classical,
                                      unstructured_setup)
        from pyamg_tpu.sparse import windowed_from_scipy as wfs
        small = functools.partial(wfs, max_w2=2048)
        monkeypatch.setattr(unstructured_setup, "windowed_from_scipy",
                            small)
        monkeypatch.setattr(unstructured_classical,
                            "windowed_from_scipy", small)

    @staticmethod
    def _scrambled_fem(nx, seed=7):
        A = _fem_matrix(nx)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(A.shape[0])
        return sp.csr_matrix(A[perm][:, perm])

    def test_sa_auto_reorder_history_parity(self):
        import functools
        from pyamg_tpu.engine import device_unstructured_sa_setup
        from pyamg_tpu.engine.unstructured_setup import (ReorderedSolver,
                                                         _rcm_perm)
        from pyamg_tpu.sparse import windowed_from_scipy
        A = self._scrambled_fem(80)         # 6400 dofs > one 4096 window
        assert windowed_from_scipy(A, dtype=jnp.float32,
                                   max_w2=2048) is None
        b = np.random.default_rng(3).random(A.shape[0])
        dml = device_unstructured_sa_setup(A, max_coarse=600)
        assert isinstance(dml, ReorderedSolver)
        assert dml.setup_info["reordered"] == "rcm"
        res_a = []
        x = dml.solve(b, tol=1e-5, maxiter=40, accel="cg",
                      residuals=res_a)
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-4
        # manual pre-reorder: identical residual history
        perm = _rcm_perm(A)
        Ap = sp.csr_matrix(A[perm][:, perm])
        dml_m = device_unstructured_sa_setup(Ap, max_coarse=600)
        res_m = []
        dml_m.solve(b[perm], tol=1e-5, maxiter=40, accel="cg",
                    residuals=res_m)
        assert len(res_a) == len(res_m)
        np.testing.assert_allclose(res_a, res_m, rtol=1e-5)

    def test_rs_auto_reorder(self):
        A = self._scrambled_fem(80)
        b = np.random.default_rng(4).random(A.shape[0])
        dml = device_unstructured_rs_setup(A, max_coarse=600)
        assert dml.setup_info.get("reordered") == "rcm"
        res = []
        x = dml.solve(b, tol=1e-5, maxiter=40, accel="cg",
                      residuals=res)
        assert res[-1] / res[0] < 1e-5
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-4

    def test_device_out_rejected(self):
        from pyamg_tpu.engine import device_unstructured_sa_setup
        A = self._scrambled_fem(80)
        dml = device_unstructured_sa_setup(A, max_coarse=600)
        with pytest.raises(ValueError, match="device_out"):
            dml.solve(np.ones(A.shape[0]), device_out=True)

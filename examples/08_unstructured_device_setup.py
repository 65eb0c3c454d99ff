"""Unstructured on-device SA setup: FEM meshes without a grid.

Every other device pipeline (example 06) detects a stencil GRID.  This
one builds the SA hierarchy on device for ARBITRARY operators whose
ordering admits bounded column windows (naturally-ordered meshes; use
``pyamg_tpu.graph.symmetric_rcm`` first otherwise), through windowed
selections:

- strength + distance-2 Luby-MIS aggregation as elementwise functions
  of window selects,
- tentative/smoothed P assembled column-index-wise,
- the Galerkin RAP by banded CHAIN PROBING (multi-RHS probe vectors
  through K-lane windowed applies recover exact coarse columns).

Two aggregation modes:
- 'standard'   reference-parity granularity (aggregates ~3 nodes);
- 'aggressive' radius-2 aggregates (~7x coarsening): fewer, smaller
  coarse levels, cheaper setup and V-cycles at ~2x the Krylov
  iterations.

Run: python examples/08_unstructured_device_setup.py
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from pyamg_tpu.engine import device_sa_setup
from pyamg_tpu.engine.unstructured_setup import device_unstructured_sa_setup
from pyamg_tpu.gallery import gradgradform, regular_triangle_mesh

# ---- P1 stiffness matrix on a triangle mesh (no grid structure) -------
nx = 120
V, E = regular_triangle_mesh(nx, nx)
A = sp.csr_matrix(gradgradform(V, E))
A = (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()
n = A.shape[0]
rng = np.random.default_rng(0)
b = rng.standard_normal(n)
print(f"P1 FEM stiffness: n={n}, nnz={A.nnz}")

for mode in ("standard", "aggressive"):
    dsa = device_unstructured_sa_setup(A, max_coarse=200, aggregate=mode)
    ns = [lv["n"] for lv in dsa.setup_info["levels"]]
    ncs = [lv["nc"] for lv in dsa.setup_info["levels"]]
    res = []
    x = dsa.solve(jnp.asarray(b, dtype=jnp.float32), tol=1e-6,
                  maxiter=60, accel="cg", residuals=res)
    res = [r for r in np.asarray(res) if not np.isnan(r)]
    true = np.linalg.norm(b - A @ np.asarray(x[:n], dtype=np.float64))
    print(f"{mode:>10}: levels {ns + [ncs[-1]]}, "
          f"{len(res) - 1} CG iters, true relres "
          f"{true / np.linalg.norm(b):.2e}")

# device_sa_setup auto-routes to the unstructured pipeline when grid
# detection fails.  This regular triangle mesh is lattice-ordered, so
# detection SUCCEEDS (structured pipeline); a genuinely irregular mesh
# (the airfoil Laplacian) takes the unstructured route automatically.
auto = device_sa_setup(A, dtype=jnp.float32, max_coarse=200)
print(f"regular mesh  -> {type(auto).__name__} "
      f"({len(auto.hierarchy.levels)} levels; lattice detected)")

from pyamg_tpu.gallery import load_example

Aa = sp.csr_matrix(load_example("airfoil")["A"]).astype(np.float64)
Aa = (Aa + 1e-2 * sp.eye(Aa.shape[0], format="csr")).tocsr()
auto2 = device_sa_setup(Aa, max_coarse=100)
print(f"airfoil mesh  -> {type(auto2).__name__} "
      f"({len(auto2.hierarchy.levels)} levels; unstructured route)")

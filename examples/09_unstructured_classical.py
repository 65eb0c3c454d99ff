"""Example 09: UNSTRUCTURED classical AMG on device (round 5).

The classical family — Ruge-Stüben and AIR — built entirely on device
for grid-less operators: PMIS splitting, modified-classical
interpolation (composed windowed factors), chain-probed Galerkin RAP,
and for nonsymmetric advection a truncated-Neumann ideal restriction
(nAIR).  Mirrors the reference's `ruge_stuben_solver` / `air_solver`
on arbitrary CSR (SURVEY.md §2.2 S:111-114).

Run: python examples/09_unstructured_classical.py   (CPU or GPU)
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import numpy as np
import scipy.sparse as sp

import pyamg_tpu
from pyamg_tpu.engine import (device_air_setup, device_rs_setup,
                              device_unstructured_air_setup,
                              device_unstructured_rs_setup)
from pyamg_tpu.gallery import (advection_2d, gradgradform,
                               regular_triangle_mesh)

# ---- P1 FEM stiffness (SPD, unstructured-style mesh matrix) -----------
V, E = regular_triangle_mesh(64, 64)
A = sp.csr_matrix(gradgradform(V, E))
A = (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()
n = A.shape[0]
b = np.random.default_rng(0).random(n)

# host reference
ml = pyamg_tpu.ruge_stuben_solver(A, max_coarse=200)
res_h = []
ml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_h)
print(f"host RS       : {len(res_h) - 1} CG iters")

# device RS, modified-classical interpolation (default)
dml = device_unstructured_rs_setup(A, max_coarse=200)
res = []
x = dml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
true = np.linalg.norm(b - A @ np.asarray(x[:n], dtype=np.float64))
print(f"device RS     : {len(res) - 1} CG iters, true relres "
      f"{true / np.linalg.norm(b):.2e}, levels "
      f"{[i['n'] for i in dml.setup_info['levels']]}")

# direct interpolation variant (single-factor P, cheapest applies)
dml_d = device_unstructured_rs_setup(A, max_coarse=200,
                                     interpolation="direct")
res_d = []
dml_d.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_d)
print(f"device RS/dir : {len(res_d) - 1} CG iters")

# device_rs_setup auto-routes: an RCM-permuted (non-stencil) operator
# takes the unstructured pipeline automatically
Ar = sp.csr_matrix(pyamg_tpu.graph.symmetric_rcm(A))
auto = device_rs_setup(Ar, max_coarse=200)
print(f"auto-routed   : {type(auto).__name__}, family "
      f"{auto.setup_info['levels'][0].get('family')}")

# ---- nonsymmetric-pattern advection: unstructured AIR -----------------
Aa, ba = advection_2d((64, 64), theta=np.pi / 4)
Aa = sp.csr_matrix(Aa)
print(f"\nadvection 64^2: pattern symmetric = "
      f"{((Aa != 0) != (Aa.T != 0)).nnz == 0}")
dair = device_unstructured_air_setup(Aa, max_coarse=200, degree=2)
res = []
dair.solve(ba, tol=1e-10, maxiter=2, residuals=res)
print(f"device nAIR   : first cycle drops residual "
      f"{res[0] / res[1]:.1e}x")
res = []
xa = dair.solve(ba, tol=1e-8, maxiter=30, accel="fgmres", residuals=res)
print(f"device nAIR   : FGMRES {len(res) - 1} iters to "
      f"{res[-1] / res[0]:.1e}")

# with grid= given, the same operator takes the structured AIR path
dair2 = device_air_setup(Aa, grid=(64, 64), max_coarse=200)
print(f"structured AIR (same operator, grid given): "
      f"{type(dair2).__name__}")

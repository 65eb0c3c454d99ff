"""Batched multi-RHS device solves + device-solver checkpointing.

Production serving pattern:

1. build the hierarchy once (host or on-device setup),
2. ``save_device_solver`` the compiled pytree,
3. serving processes ``load_device_solver`` straight onto their chip,
4. solve K right-hand sides per call — ONE compiled program, vmapped
   over RHS lanes; the operator read is amortized over K (the SpMV and
   transfer applies fuse into (n, K) passes), and each lane stops at its
   own convergence point.

Run: python examples/07_batched_and_checkpoint.py
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import tempfile

import numpy as np

import pyamg_tpu
from pyamg_tpu.engine import compile_hierarchy
from pyamg_tpu.engine.solver import DeviceMultilevelSolver
from pyamg_tpu.gallery import poisson
from pyamg_tpu.util.serialize import load_device_solver, save_device_solver

# ---- build once -------------------------------------------------------
A = poisson((256, 256), format="csr")
ml = pyamg_tpu.smoothed_aggregation_solver(A)
dml = DeviceMultilevelSolver(compile_hierarchy(ml, mixed_precision=True))

# ---- checkpoint / reload ---------------------------------------------
with tempfile.TemporaryDirectory() as d:
    path = f"{d}/poisson256.solver"
    save_device_solver(dml, path)
    served = load_device_solver(path)
    print(f"checkpoint round-trip: {path.split('/')[-1]} "
          f"({len(served.hierarchy.levels)} levels)")

# ---- batched multi-RHS solve -----------------------------------------
K = 4
rng = np.random.default_rng(0)
B = rng.random((A.shape[0], K))
B[:, 0] = 0.0                       # lane 0 converges instantly (frozen)
res = []
X = served.solve(B, tol=1e-8, maxiter=60, accel="cg", precision="mixed",
                 residuals=res)
true = np.linalg.norm(B - A @ X, axis=0) / np.maximum(
    np.linalg.norm(B, axis=0), 1e-300)
for j in range(K):
    print(f"lane {j}: {len(res[j]) - 1:2d} iters, "
          f"true relres {true[j]:.2e}")

# ---- batched solves on a device-built hierarchy ----------------------
# The same vmapped K-major route serves device-built hierarchies.
from pyamg_tpu.engine import device_sa_setup

A2 = poisson((512, 512), format="csr")
dsa = device_sa_setup(A2, grid=(512, 512), max_coarse=400,
                      mixed_precision=True)
B2 = rng.random((A2.shape[0], K))
res2 = []
X2 = dsa.solve(B2, tol=1e-8, maxiter=60, accel="cg", precision="mixed",
               residuals=res2)
true2 = np.linalg.norm(B2 - A2 @ X2, axis=0) / np.maximum(
    np.linalg.norm(B2, axis=0), 1e-300)
print("device-built lanes (mixed):",
      [f"{len(r) - 1} iters / true {t:.1e}"
       for r, t in zip(res2, true2)])

"""Smoothed aggregation on 2D Poisson — the 60-second tour.

Host setup -> device-compiled solve, mirroring the reference's README
example ([R] upstream README usage, SURVEY.md §6).
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os
import sys


import numpy as np

import pyamg_tpu

A = pyamg_tpu.gallery.poisson((500, 500), format="csr")   # n = 250,000
b = np.random.default_rng(0).random(A.shape[0])

ml = pyamg_tpu.smoothed_aggregation_solver(A)
print(ml)

residuals = []
x = ml.solve(b, tol=1e-10, accel="cg", residuals=residuals)
print(f"host solve: {len(residuals) - 1} iterations, "
      f"relative residual {residuals[-1] / residuals[0]:.2e}")

# same hierarchy, jitted device engine (one XLA program per solve)
residuals = []
x = ml.solve(b, tol=1e-8, accel="cg", residuals=residuals,
             backend="device")
print(f"device solve: {len(residuals) - 1} iterations, "
      f"relative residual {residuals[-1] / residuals[0]:.2e}")

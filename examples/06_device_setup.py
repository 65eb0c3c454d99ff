"""On-device hierarchy construction: SA (scalar/semicoarsening/block)
and the classical family (Ruge-Stüben + AIR).

Five flavors of the on-device setup pipeline (everything — strength,
splitting/aggregation, interpolation, Galerkin RAP, coarse
pseudo-inverse — is ONE jitted XLA program; zero host round-trips):

1. scalar grid stencil (2-D/3-D Poisson)           device_sa_setup
2. anisotropic + stride='auto' SEMICOARSENING      device_sa_setup
3. BSR + multi-candidate (elasticity, rigid-body)  device_sa_setup_block
4. classical RS (multi-pass direct interpolation)  device_rs_setup
5. AIR on upwind advection (near-exact reduction)  device_air_setup

Run: python examples/06_device_setup.py
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import jax.numpy as jnp

from pyamg_tpu.engine import (device_air_setup, device_rs_setup,
                              device_sa_setup, device_sa_setup_block)
from pyamg_tpu.gallery import (advection_2d, diffusion_stencil_2d,
                               linear_elasticity, poisson, stencil_grid)

# ---- 1. scalar Poisson ------------------------------------------------
grid = (256, 256)
A = poisson(grid, format="csr")
ds = device_sa_setup(A, grid=grid, max_coarse=400)
b = np.random.default_rng(0).random(A.shape[0])
res = []
x = ds.solve(b, tol=1e-5, maxiter=40, accel="cg", residuals=res)
print(f"poisson {grid}: {len(res)-1} CG iters, "
      f"relres {res[-1]/res[0]:.2e}")

# ---- 2. grid-aligned anisotropy: automatic semicoarsening -------------
S = diffusion_stencil_2d(epsilon=1e-3, theta=0.0, type="FD")
A2 = stencil_grid(S, grid).tocsr()
ds2 = device_sa_setup(A2, grid=grid, max_coarse=400, stride="auto")
print("semicoarsening plan:",
      [i["strides"] for i in ds2.setup_info["levels"]])
res = []
x2 = ds2.solve(b, tol=1e-5, maxiter=40, accel="cg", residuals=res)
print(f"anisotropic eps=1e-3: {len(res)-1} CG iters "
      f"(isotropic-stride aggregation stalls at rho~0.93)")

# ---- 3. elasticity: BSR bs=2, three rigid-body candidates -------------
A3, B3 = linear_elasticity((64, 64))          # left edge clamped
ds3 = device_sa_setup_block(A3, grid=(64, 63), B=B3,
                            mixed_precision=True)
b3 = np.random.default_rng(1).random(A3.shape[0])
res = []
x3 = ds3.solve(b3, tol=1e-8, maxiter=60, accel="cg", residuals=res,
               precision="mixed")
true_rel = np.linalg.norm(b3 - A3 @ x3) / np.linalg.norm(b3)
print(f"elasticity 64^2 (bs=2, m=3): {len(res)-1} mixed CG iters, "
      f"TRUE relres {true_rel:.2e}")
print("coarse block sizes:",
      [getattr(l.A, "bs", None) for l in ds3.hierarchy.levels])

# ---- 4. classical Ruge-Stüben (multi-pass direct interpolation) -------
ds4 = device_rs_setup(A2, grid=grid, max_coarse=400)    # aniso again
print("RS semicoarsening plan:",
      [i["strides"] for i in ds4.setup_info["levels"]])
res = []
x4 = ds4.solve(b, tol=1e-6, maxiter=40, accel="cg", residuals=res)
print(f"classical RS anisotropic: {len(res)-1} CG iters, "
      f"relres {res[-1]/res[0]:.2e}")

# ---- 5. AIR: one-point P + degree-2 local ideal restriction -----------
A5, rhs5 = advection_2d(grid, theta=np.pi / 4)
ds5 = device_air_setup(A5, grid=grid, max_coarse=400)
res = []
x5 = ds5.solve(rhs5, tol=1e-8, maxiter=20, residuals=res)
print(f"AIR advection: first cycle drops residual "
      f"{res[0]/max(res[1], 1e-300):.1e}x (near-exact reduction)")

# ---- 6. adaptive SA (alpha-SA): bootstrap the near-nullspace ----------
# (round 3) When the near-nullspace is unknown — e.g. a diagonally
# rescaled operator where B=ones is wrong — the adaptive setup finds it
# on device: stage 0 relaxes ones on A z = 0; further stages expose the
# error the current hierarchy cannot remove and ACCUMULATE it as extra
# candidates through the multi-candidate block pipeline.
import scipy.sparse as sp
from pyamg_tpu.engine import device_adaptive_sa_setup

A6 = poisson((64, 64), format="csr")
d6 = 10.0 ** np.random.default_rng(3).uniform(-2, 2, A6.shape[0])
D6 = sp.diags(np.sqrt(d6))
A6 = (D6 @ A6 @ D6).tocsr()                   # near-nullspace = D^-1/2
b6 = np.random.default_rng(5).random(A6.shape[0])
for label, ds6 in (
        ("B=ones   ", device_sa_setup(A6, grid=(64, 64), max_coarse=150)),
        ("adaptive ", device_adaptive_sa_setup(A6, grid=(64, 64),
                                               max_coarse=150, stages=2))):
    res = []
    ds6.solve(b6, tol=1e-6, maxiter=80, accel="cg", residuals=res)
    print(f"rescaled Poisson, {label}: {len(res)-1} CG iters")

# ---- 7. nonsymmetric device setup (recirculating flow) ----------------
# device_rs_setup also handles nonsymmetric operators (chip_smoke.py
# phase 7 runs it at 1024^2 with mixed FGMRES to a true 1e-8).
from pyamg_tpu.gallery import recirc_flow

A7 = recirc_flow((128, 128), epsilon=1e-2)
b7 = np.random.default_rng(6).random(A7.shape[0])
ds7 = device_rs_setup(A7, grid=(128, 128), max_coarse=400)
res = []
ds7.solve(b7, tol=1e-8, maxiter=100, accel="fgmres", residuals=res)
print(f"recirc flow 128^2 (nonsym): {len(res)-1} FGMRES iters, "
      f"relres {res[-1]/res[0]:.2e}")

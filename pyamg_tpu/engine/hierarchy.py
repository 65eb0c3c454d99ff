"""Compile a host MultilevelSolver into a device-resident hierarchy.

This is the bridge between the two halves of the framework (SURVEY.md §7
design stance): the setup phase produces scipy operators; this module
converts them once into padded DIA/dense/windowed pytrees + static
smoother configs, and the solve phase (:mod:`pyamg_tpu.engine.solver`)
traces ONE XLA program over the static level structure — cycles unrolled
over the level count, Krylov as lax.while_loop — so an entire
preconditioned solve runs on device with no host round-trips (the
reference's per-level Python<->C++ crossings, SURVEY.md §3.2, disappear).

Everything device-resident is a pytree LEAF (operators, diagonal
inverses, colorings, masks) and the whole DeviceHierarchy is passed as a
jit *argument* — closure-captured device arrays would become constants
baked into each compiled program, so nothing may be captured.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..graph import vertex_coloring
from ..relaxation.chebyshev import chebyshev_polynomial_coefficients
from ..relaxation.smoothing import rho_D_inv_A, rho_block_D_inv_A
from ..sparse import pad_to, select_operator, windowed_from_scipy
from ..sparse.dia import dense_from_scipy
from ..util.linalg import approximate_spectral_radius
from ..util.utils import get_block_diag
from . import relaxation as device_relaxation

__all__ = ["DeviceLevel", "DeviceHierarchy", "compile_hierarchy"]

_ROW_PAD = 1024
_MAX_GS_COLORS = 16


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceLevel:
    """Device operators + smoothers for one level (a pytree)."""

    A: Any
    P: Optional[Any]
    R: Optional[Any]
    pre: device_relaxation.DeviceSmoother
    post: device_relaxation.DeviceSmoother
    n: int                   # logical size (static)
    n_pad: int               # padded size (static)

    def tree_flatten(self):
        return (self.A, self.P, self.R, self.pre, self.post), (
            self.n, self.n_pad)

    @classmethod
    def tree_unflatten(cls, aux, children):
        A, P, R, pre, post = children
        n, n_pad = aux
        return cls(A=A, P=P, R=R, pre=pre, post=post, n=n, n_pad=n_pad)

    def presmooth(self, A, x, b):
        return self.pre(A, x, b)

    def postsmooth(self, A, x, b):
        return self.post(A, x, b)


@jax.tree_util.register_pytree_node_class
class DeviceHierarchy:
    """Pytree of DeviceLevels + dense coarse inverse.

    ``A64`` (optional) holds the finest operator in f64 for the
    full-device mixed-precision outer Krylov loop (f64 matvec + dots,
    f32 V-cycle preconditioner) — the SURVEY.md §7 "f32 V-cycle + f64
    Krylov outer" strategy executed entirely on device.
    """

    def __init__(self, levels, coarse_inv, nc, nc_pad, dtype, A64=None):
        self.levels = list(levels)
        self.coarse_inv = coarse_inv    # (nc_pad, nc_pad) device array
        self.nc = nc
        self.nc_pad = nc_pad
        self.dtype = dtype
        self.A64 = A64

    def tree_flatten(self):
        return (tuple(self.levels), self.coarse_inv, self.A64), (
            self.nc, self.nc_pad, str(jnp.dtype(self.dtype)))

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, coarse_inv, A64 = children
        nc, nc_pad, dtype = aux
        return cls(levels=list(levels), coarse_inv=coarse_inv, nc=nc,
                   nc_pad=nc_pad, dtype=jnp.dtype(dtype), A64=A64)

    def coarse_solve(self, bc):
        # coarse_inv is stored padded (nc_pad, nc_pad) with zero rows/cols
        # beyond nc, so the padded product is exact and shape-stable.
        # precision=HIGHEST: under vmap (batched multi-RHS) this matvec
        # becomes a matmul, which at default precision may run in TF32
        # on the GPU (~1e-3 relative error in the coarse correction).
        return jnp.dot(self.coarse_inv, bc,
                       precision=jax.lax.Precision.HIGHEST)


def _device_dinv(A_scipy, n_pad, dtype):
    d = A_scipy.diagonal()
    with np.errstate(divide="ignore", invalid="ignore"):
        dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 0.0)
    out = np.zeros(n_pad, dtype=dinv.dtype)
    out[: len(dinv)] = dinv
    return jnp.asarray(out, dtype=dtype)


def _device_block_dinv(A_scipy, bs, nb_pad, dtype):
    Dinv = get_block_diag(A_scipy, bs, inv_flag=True)
    out = np.zeros((nb_pad, bs, bs), dtype=np.float64)
    out[: Dinv.shape[0]] = Dinv
    return jnp.asarray(out, dtype=dtype)


def _colors_for(A_scipy, n_pad):
    """JP coloring of the scalar connectivity graph, padded with -1."""
    pattern = sp.csr_matrix(A_scipy)
    colors = vertex_coloring(pattern, method="JP")
    out = np.full(n_pad, -1, dtype=np.int64)
    out[: len(colors)] = colors
    return jnp.asarray(out, dtype=jnp.int32), int(colors.max()) + 1


def _block_colors_for(A_scipy, bs, nb_pad):
    from ..util.utils import amalgamate

    node_graph = (amalgamate(sp.csr_matrix(A_scipy), bs) if bs > 1
                  else sp.csr_matrix(A_scipy))
    colors = vertex_coloring(node_graph, method="JP")
    out = np.full(nb_pad, -1, dtype=np.int64)
    out[: len(colors)] = colors
    return jnp.asarray(out, dtype=jnp.int32), int(colors.max()) + 1


def _compile_smoother(lvl, spec, dtype, n_pad):
    """Map a resolved host smoother spec onto its device-parallel form.

    Sequential-semantics smoothers become their hybrid (multicolor)
    equivalents; convergence-factor parity (not bitwise parity) is the
    acceptance criterion (SURVEY.md §7 hard part 3).
    """
    A = lvl.A
    # keep the SAME object when already CSR so spectral-radius caches
    # (_rho, _rho_D_inv) computed during host setup are reused
    Acsr = A if (sp.issparse(A) and A.format == "csr") else sp.csr_matrix(A)
    name, kwargs = spec if spec is not None else (None, {})
    kwargs = dict(kwargs or {})

    if name is None or name == "none":
        return device_relaxation.identity()

    iterations = int(kwargs.get("iterations", 1))

    if name == "jacobi":
        omega = float(kwargs.get("omega", 1.0))
        if kwargs.get("withrho", True):
            omega = omega / rho_D_inv_A(Acsr)
        dinv = _device_dinv(Acsr, n_pad, dtype)
        return device_relaxation.jacobi(dinv, omega, iterations)

    if name in ("jacobi_ne", "gauss_seidel_ne", "gauss_seidel_nr"):
        # Device NE/NR forms target the same normal equations as the
        # reference (amg_core jacobi_ne / gauss_seidel_ne/nr) but in the
        # parallel Cimmino form: x += omega * A^T Dinv (b - A x).
        # Sequential Kaczmarz (gauss_seidel_ne/nr) has no parallel
        # equivalent that preserves ordering — substitute the Jacobi-NE/NR
        # sweep and say so (convergence-factor, not bitwise, parity).
        if name != "jacobi_ne":
            warnings.warn(
                f"smoother '{name}' (sequential Kaczmarz) has no device "
                "form; substituting the parallel Jacobi normal-equation "
                "sweep (Cimmino) targeting the same normal equations")
        omega = float(kwargs.get("omega", 1.0))
        sq = Acsr.copy()
        sq.data = np.abs(sq.data) ** 2
        if name == "gauss_seidel_nr":
            colnorm2 = np.asarray(sq.sum(axis=0)).ravel()
            with np.errstate(divide="ignore", invalid="ignore"):
                dvals = np.where(colnorm2 != 0, 1.0 / colnorm2, 0.0)
        else:
            rownorm2 = np.asarray(sq.sum(axis=1)).ravel()
            with np.errstate(divide="ignore", invalid="ignore"):
                dvals = np.where(rownorm2 != 0, 1.0 / rownorm2, 0.0)
        if name != "jacobi_ne":
            # Kaczmarz converges for any omega in (0,2); Cimmino needs
            # omega < 2/rho(A^H D^-1 A).  Scale like withrho-Jacobi so
            # the substituted sweep is unconditionally a smoother:
            # rho(A^H D^-1 A) = ||D^-1/2 A||_2^2 (= rho(B^H B), B=D^-1/2 A).
            scale = np.sqrt(np.where(dvals > 0, dvals, 0.0))
            B = sp.diags(scale) @ Acsr if name == "gauss_seidel_ne" \
                else Acsr @ sp.diags(scale)
            rho_ne = approximate_spectral_radius((B.conj().T @ B).tocsr())
            omega = omega / max(rho_ne, 1e-300)
        out = np.zeros(n_pad, dtype=np.float64)
        out[: len(dvals)] = dvals
        dinv = jnp.asarray(out, dtype=dtype)
        if (name != "jacobi_ne"
                and kwargs.get("sweep", "forward") == "symmetric"):
            # work parity: one SYMMETRIC Kaczmarz sweep performs 2n row
            # updates (forward + backward); one Cimmino pass performs n.
            # Doubling keeps the substituted smoother at the same row-
            # update budget (measured on 48^2 recirc FGMRES: factor
            # 0.54 vs 0.66 undoubled, host Kaczmarz 0.26 — pinned in
            # tests/test_device_krylov.py::test_cimmino_nr_equivalence)
            iterations *= 2
        if name == "gauss_seidel_nr":
            return device_relaxation.jacobi_nr(dinv, omega, iterations)
        return device_relaxation.jacobi_ne(dinv, omega, iterations)

    if name == "richardson":
        omega = float(kwargs.get("omega", 1.0))
        omega = omega / max(approximate_spectral_radius(Acsr), 1e-300)
        return device_relaxation.richardson(omega, iterations)

    def _mcgs_or_chebyshev(sweep):
        """Multicolor GS, unless the level needs so many colors (dense-ish
        coarse graphs) that a Chebyshev sweep smooths equally well in a
        fraction of the matvecs (each color costs one full SpMV)."""
        colors, ncolors = _colors_for(Acsr, n_pad)
        if ncolors <= _MAX_GS_COLORS:
            dinv = _device_dinv(Acsr, n_pad, dtype)
            return device_relaxation.multicolor_gs(
                dinv, colors, ncolors, sweep=sweep, iterations=iterations)
        rho = approximate_spectral_radius(Acsr)
        coefficients = chebyshev_polynomial_coefficients(
            rho / 30.0, 1.1 * rho, 4)
        return device_relaxation.polynomial(coefficients, iterations)

    if name in ("gauss_seidel", "sor", "gauss_seidel_ne", "gauss_seidel_nr"):
        return _mcgs_or_chebyshev(kwargs.get("sweep", "forward"))

    if name == "block_gauss_seidel":
        bs = kwargs.get("blocksize")
        if bs is None:
            bs = A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1
        if bs == 1 or n_pad % bs != 0:
            return _mcgs_or_chebyshev(kwargs.get("sweep", "forward"))
        nb_pad = n_pad // bs
        colors, ncolors = _block_colors_for(A, bs, nb_pad)
        if ncolors > _MAX_GS_COLORS:
            return _mcgs_or_chebyshev(kwargs.get("sweep", "forward"))
        Dinv = _device_block_dinv(A, bs, nb_pad, dtype)
        return device_relaxation.block_multicolor_gs(
            Dinv, colors, ncolors, sweep=kwargs.get("sweep", "forward"),
            iterations=iterations)

    if name == "block_jacobi":
        bs = kwargs.get("blocksize")
        if bs is None:
            bs = A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1
        omega = float(kwargs.get("omega", 1.0))
        if bs == 1 or n_pad % bs != 0:
            if kwargs.get("withrho", True):
                omega = omega / rho_D_inv_A(Acsr)
            dinv = _device_dinv(Acsr, n_pad, dtype)
            return device_relaxation.jacobi(dinv, omega, iterations)
        nb_pad = n_pad // bs
        Dinv_host = get_block_diag(A, bs, inv_flag=True)
        if kwargs.get("withrho", True):
            omega = omega / rho_block_D_inv_A(Acsr, Dinv_host)
        Dinv = np.zeros((nb_pad, bs, bs))
        Dinv[: Dinv_host.shape[0]] = Dinv_host
        return device_relaxation.block_jacobi(
            jnp.asarray(Dinv, dtype=dtype), omega, iterations)

    if name == "chebyshev":
        rho = approximate_spectral_radius(Acsr)
        lower = kwargs.get("lower_bound", 1.0 / 30.0)
        upper = kwargs.get("upper_bound", 1.1)
        degree = int(kwargs.get("degree", 3))
        coefficients = chebyshev_polynomial_coefficients(
            rho * lower, rho * upper, degree)
        return device_relaxation.polynomial(coefficients, iterations)

    if name == "polynomial":
        return device_relaxation.polynomial(kwargs["coefficients"], iterations)

    if name in ("cf_jacobi", "fc_jacobi", "cf_block_jacobi", "fc_block_jacobi"):
        splitting = getattr(lvl, "splitting", None)
        if splitting is None:
            raise ValueError(f"{name} requires lvl.splitting")
        splitting = np.asarray(splitting)
        bs = A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1
        cmask = np.zeros(n_pad, dtype=bool)
        fmask = np.zeros(n_pad, dtype=bool)
        cnodes = np.flatnonzero(splitting == 1)
        fnodes = np.flatnonzero(splitting == 0)
        cmask[(cnodes[:, None] * bs + np.arange(bs)[None, :]).ravel()] = True
        fmask[(fnodes[:, None] * bs + np.arange(bs)[None, :]).ravel()] = True
        omega = float(kwargs.get("omega", 1.0))
        f_it = int(kwargs.get("f_iterations", 1))
        c_it = int(kwargs.get("c_iterations", 1))
        dinv = _device_dinv(Acsr, n_pad, dtype)
        if name.startswith("cf"):
            masks = (jnp.asarray(cmask), jnp.asarray(fmask))
            iters = (c_it, f_it)
        else:
            masks = (jnp.asarray(fmask), jnp.asarray(cmask))
            iters = (f_it, c_it)
        return device_relaxation.masked_jacobi(dinv, masks, iters,
                                               omega=omega,
                                               iterations=iterations)

    if name in ("schwarz", "strength_based_schwarz"):
        # device form: contiguous sliding windows instead of the
        # reference's strength-based per-node subdomains (gather-free;
        # convergence-equivalent overlapping Schwarz)
        warnings.warn(
            f"'{name}': substituting windowed overlapping Schwarz "
            "(contiguous sliding subdomains — the gather-free device form)")
        w = int(kwargs.get("window", 16))
        s = int(kwargs.get("stride", 8))
        if w % s != 0:
            raise ValueError("schwarz window must be a multiple of stride")
        if n_pad % s != 0:
            return _mcgs_or_chebyshev(kwargs.get("sweep", "symmetric"))
        inv_blocks = _windowed_schwarz_blocks(Acsr, n_pad, w, s)
        return device_relaxation.windowed_schwarz(
            jnp.asarray(inv_blocks, dtype=dtype), w, s,
            omega=float(kwargs.get("omega", 1.0)), iterations=iterations)

    warnings.warn(
        f"smoother '{name}' has no device form; substituting hybrid "
        "multicolor Gauss-Seidel (convergence-equivalent device smoother)")
    return _mcgs_or_chebyshev(kwargs.get("sweep", "symmetric"))


def _windowed_schwarz_blocks(Acsr, n_pad, w, s):
    """Batched pseudo-inverses of the circular sliding-window subblocks
    A[i*s : i*s+w, i*s : i*s+w], built from the matrix diagonals
    (vectorized — no per-window sparse slicing)."""
    n = Acsr.shape[0]
    nwin = n_pad // s
    blocks = np.zeros((nwin, w, w))
    for k in range(-(w - 1), w):
        dk = np.asarray(Acsr.diagonal(k)).ravel()
        if dk.size == 0:
            continue
        val = np.zeros(n_pad)
        if k >= 0:
            val[: n - k] = dk          # val[r] = A[r, r+k]
        else:
            val[-k: n] = dk            # val[r] = A[r, r+k], r >= |k|
        ext = np.concatenate([val, val[: w]])   # circular windows
        V = np.lib.stride_tricks.sliding_window_view(ext, w)[::s][:nwin]
        ps = np.arange(max(0, -k), min(w, w - k))
        blocks[:, ps, ps + k] = V[:, ps]
    return np.linalg.pinv(blocks)


def _smoothing_factor_dia(A_dev, A_host, fac, dtype):
    """Device DIA form of S_sm = I - omega * diag(dinv) @ A, built by
    scaling the ALREADY-CONVERTED DIA of A on device — no host SpGEMM,
    no extra conversion, no extra upload beyond dinv.  Returns None when
    A's device form isn't a plain same-dtype DIA (BSR, windowed,
    bf16-compressed storage), in which case the caller materializes S on
    host instead."""
    from ..sparse import DIAMatrix

    if not isinstance(A_dev, DIAMatrix) or A_dev.dtype != jnp.dtype(dtype):
        return None
    n = A_host.shape[0]
    n_pad = A_dev.n_pad
    dinv = fac["dinv"]
    if dinv is None:                      # richardson: identity scaling
        scale = np.full(n_pad, -fac["omega"])
    else:
        scale = np.zeros(n_pad)
        scale[:n] = -fac["omega"] * dinv
    data = A_dev.data * jnp.asarray(scale, dtype=dtype)[None, :]
    bump = jnp.asarray((np.arange(n_pad) < n).astype(np.float64),
                       dtype=dtype)
    if 0 in A_dev.offsets:
        d0 = A_dev.offsets.index(0)
        data = data.at[d0].add(bump)
        offsets = A_dev.offsets
    else:
        data = jnp.concatenate([data, bump[None, :]])
        offsets = A_dev.offsets + (0,)
    return DIAMatrix(data=data, offsets=offsets, shape=A_host.shape,
                     nnz=A_host.nnz + n)


def _smoothing_factor_host(A_host, fac):
    """Materialized host CSR of S_sm = I - omega * diag(dinv) @ A
    (fallback when A has no plain-DIA device form)."""
    from ..util.utils import scale_rows

    A_csr = sp.csr_matrix(A_host)
    dinv = fac["dinv"]
    scaled = (A_csr * (-fac["omega"]) if dinv is None
              else scale_rows(A_csr, -fac["omega"] * dinv, copy=True))
    return (scaled + sp.identity(A_csr.shape[0], dtype=scaled.dtype,
                                 format="csr")).tocsr()


def _factored_transfer(M, fac, A_dev, A_host, dtype, row_pad):
    """Compile P = S^degree @ T from the recipe the host smoother
    recorded (aggregation/smooth.py).  `degree` DIA applies + one k~1
    windowed spread beat the fused k~6 windowed P by ~4x at 4.2M rows.
    Returns None when the factors don't map to cheap device forms
    (S not DIA-able, T not windowable, complex dtype)."""
    if fac is None or A_host is None:
        return None
    degree = fac["degree"]
    if degree < 1 or degree > 3:
        return None
    if jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
        return None  # transpose sharing below would need conj handling
    from ..sparse import dia_from_scipy
    from ..sparse.composed import ComposedOperator

    S_dev = _smoothing_factor_dia(A_dev, A_host, fac, dtype)
    if S_dev is None:
        # cap the factor's diagonal count: an unstructured level's S has
        # A's (scattered) pattern, and a low-fill many-diagonal DIA is
        # worse than the fused windowed P on every axis — apply cost
        # (one rolled op per diagonal), HBM footprint (ndiags*n_pad*4B
        # for nnz ~ 30*n), and upload volume (measured: 64^3 SA level-1
        # S stored as ~1540 diagonals = 200 MB and dominated the
        # W-cycle).  Structured-grid factors have ndiags ~ stencil size.
        S_dev = dia_from_scipy(_smoothing_factor_host(A_host, fac),
                               dtype=dtype, row_pad=row_pad, max_diags=64)
    if S_dev is None:
        return None
    T_dev = windowed_from_scipy(sp.csr_matrix(fac["T"]), dtype=dtype)
    if T_dev is None:
        return None
    return ComposedOperator(ops=(S_dev,) * degree + (T_dev,),
                            shape=M.shape, nnz=int(M.nnz))


def _transfer_operator(M, dtype, row_pad, fac=None, A_dev=None,
                       A_host=None):
    """Device form of a prolongator (fine-rows transfer operator): dense
    when small, else factored S^d·T when the host smoother recorded the
    factorization, else adaptive-block windowed (narrow fine-row
    windows).  Complex transfers take the re/im-split windowed form
    (sparse/window.py::ComplexWindowed)."""
    if max(M.shape) <= 2048:
        return dense_from_scipy(M, dtype=dtype, row_pad=row_pad)
    if jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
        from ..sparse import complex_windowed_from_scipy

        W = complex_windowed_from_scipy(M, dtype=dtype)
        if W is not None:
            return W
        return select_operator(M, dtype=dtype, row_pad=row_pad)
    F = _factored_transfer(M, fac, A_dev, A_host, dtype, row_pad)
    if F is not None:
        return F
    W = windowed_from_scipy(M, dtype=dtype)
    if W is not None:
        return W
    return select_operator(M, dtype=dtype, row_pad=row_pad)


def _is_transpose_of(R, P):
    """R == P^T to rounding, cheaply.  Deliberately the PLAIN transpose:
    the factored restriction applies the transposed factors, so a
    complex-hermitian R = P^H must NOT match."""
    if P is None or R.shape != sp.csr_matrix(P).shape[::-1]:
        return False
    D = (R - sp.csr_matrix(P).T).tocsr()
    scale = max(np.abs(R.data).max() if R.nnz else 0.0, 1e-300)
    return D.nnz == 0 or np.abs(D.data).max() <= 1e-14 * scale


def _gather_form(M, dtype, row_pad):
    """Explicit device form of a transfer operator that no cheaper
    structured form covers: windowed when its row blocks have narrow
    column windows, else select_operator's choice."""
    W = windowed_from_scipy(M, dtype=dtype)
    if W is not None:
        return W
    return select_operator(M, dtype=dtype, row_pad=row_pad)


def _restriction_operator(R, P, P_dev, dtype, row_pad, fac=None,
                          r_is_pt=False):
    """Device form of a restriction operator.

    R is stored EXPLICITLY and applied by gathers, never as a lazy
    transpose of P: a transpose apply is a scatter-add, whose sum order
    on the GPU changes from run to run, and the residual history of a
    solve would then not repeat.  When P is the factored S^d·T and
    R == P^T, R keeps the factored form T^T·(S^T)^d with T^T explicit.
    """
    if max(R.shape) <= 2048:
        return dense_from_scipy(R, dtype=dtype, row_pad=row_pad)
    if jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
        from ..sparse import complex_windowed_from_scipy

        W = complex_windowed_from_scipy(R, dtype=dtype)
        if W is not None:
            return W
        return select_operator(R, dtype=dtype, row_pad=row_pad)
    from ..sparse.composed import ComposedOperator

    if (isinstance(P_dev, ComposedOperator)
            and (r_is_pt or _is_transpose_of(R, P))):
        # R = (S^d T)^T = T^T S^(T,d); S^T is a device DIA transpose
        from .device_setup import dia_transpose

        Tt_dev = _gather_form(sp.csr_matrix(fac["T"]).T.tocsr(), dtype,
                              row_pad)
        St_dev = dia_transpose(P_dev.ops[0])
        return ComposedOperator(
            ops=(Tt_dev,) + (St_dev,) * fac["degree"],
            shape=R.shape, nnz=int(R.nnz))
    return _gather_form(sp.csr_matrix(R), dtype, row_pad)


def compile_hierarchy(ml, dtype=jnp.float32, row_pad=_ROW_PAD,
                      mixed_precision=False, dia_storage=None,
                      coarse_cutoff=None):
    """Convert a host MultilevelSolver into a DeviceHierarchy.

    All level operators become padded DIA/dense/windowed device pytrees in
    ``dtype``; smoother specs resolve to DeviceSmoother pytrees; the
    coarsest level gets a dense pseudo-inverse.  With
    ``mixed_precision=True`` the finest operator is additionally stored in
    f64 for the on-device mixed-precision Krylov loop (requires
    jax_enable_x64).  ``dia_storage=jnp.bfloat16`` stores DIA diagonal
    data in bf16 (half the HBM traffic of the bandwidth-bound rolled
    SpMV) while vectors and accumulation stay in ``dtype`` via promotion.

    ``coarse_cutoff=n`` truncates the DEVICE hierarchy at the first level
    with <= n unknowns, solving there with the dense pseudo-inverse
    instead of descending further.  Every extra level costs a fixed
    tiny-op overhead per cycle while a <=1024-unknown dense pinv matvec
    is nearly free (the cut-off on the GPU is not measured yet: ROADMAP
    S4); the exact coarse solve can only improve convergence.  Default
    None preserves bitwise host-parity of residual histories (the host
    recursion depth is kept).  The returned object is consumed by
    DeviceMultilevelSolver (pyamg_tpu.engine.solver).
    """
    from ..sparse import DIAMatrix

    def _maybe_compress(op):
        if dia_storage is not None and isinstance(op, DIAMatrix):
            return DIAMatrix(data=op.data.astype(dia_storage),
                             offsets=op.offsets, shape=op.shape, nnz=op.nnz)
        return op
    from ..sparse.block_dia import block_dia_from_scipy

    host_levels = ml.levels
    if coarse_cutoff is not None:
        for cut, lvl in enumerate(host_levels):
            if lvl.A.shape[0] <= int(coarse_cutoff):
                host_levels = host_levels[: cut + 1]
                break
    levels = []
    for i, lvl in enumerate(host_levels[:-1]):
        A = sp.csr_matrix(lvl.A)
        n = A.shape[0]
        n_pad = pad_to(n, row_pad)
        A_dev = None
        # BSR operators (elasticity & friends) go through the gather-free
        # block-DIA path so block smoothers run blocked on device
        # (round-2; SURVEY.md §7 design stance "padded BSR for
        # solve-phase speed")
        if (sp.issparse(lvl.A) and lvl.A.format == "bsr"
                and lvl.A.blocksize[0] == lvl.A.blocksize[1]
                and lvl.A.blocksize[0] > 1
                and n > 2048
                and n_pad % lvl.A.blocksize[0] == 0):
            A_dev = block_dia_from_scipy(lvl.A, dtype=dtype, n_pad=n_pad,
                                         max_diags=600)
        if A_dev is None:
            A_dev = _maybe_compress(select_operator(A, dtype=dtype,
                                                    row_pad=row_pad))
        # the level's vector length follows the compiled operator's row
        # padding (the adaptive windowed row block may exceed row_pad)
        n_pad = int(getattr(A_dev, "n_pad", n_pad))
        fac = getattr(lvl.P, "_sa_factor", None)
        # setup tags R == P^T (real symmetric/hermitian hierarchies) so
        # the 4.2M-nnz numeric comparison is skipped on the hot path
        r_is_pt = (bool(getattr(lvl, "R_is_PT", False))
                   and not np.iscomplexobj(A.data))
        P_dev = _transfer_operator(sp.csr_matrix(lvl.P), dtype, row_pad,
                                   fac=fac, A_dev=A_dev, A_host=lvl.A)
        R_dev = _restriction_operator(sp.csr_matrix(lvl.R), lvl.P, P_dev,
                                      dtype, row_pad, fac=fac,
                                      r_is_pt=r_is_pt)
        pre = _compile_smoother(lvl, getattr(lvl, "presmoother_spec", None),
                                dtype, n_pad)
        post = _compile_smoother(lvl, getattr(lvl, "postsmoother_spec", None),
                                 dtype, n_pad)
        levels.append(DeviceLevel(A=A_dev, P=P_dev, R=R_dev, pre=pre,
                                  post=post, n=n, n_pad=n_pad))

    Ac = sp.csr_matrix(host_levels[-1].A)
    nc = Ac.shape[0]
    nc_pad = pad_to(nc, row_pad)
    pinv_c = np.linalg.pinv(Ac.toarray())
    coarse_inv = np.zeros((nc_pad, nc_pad), dtype=pinv_c.dtype)
    coarse_inv[:nc, :nc] = pinv_c
    Ac_dev = select_operator(Ac, dtype=dtype, row_pad=row_pad)
    ident = device_relaxation.identity()
    levels.append(DeviceLevel(A=Ac_dev, P=None, R=None, pre=ident,
                              post=ident, n=nc, n_pad=nc_pad))
    A64 = None
    if mixed_precision:
        jax.config.update("jax_enable_x64", True)
        A64 = select_operator(sp.csr_matrix(host_levels[0].A),
                              dtype=jnp.float64, row_pad=row_pad)
    return DeviceHierarchy(
        levels=levels,
        coarse_inv=jnp.asarray(coarse_inv, dtype=dtype),
        nc=nc, nc_pad=nc_pad, dtype=dtype, A64=A64,
    )

"""Smoother spec resolution — bind ('name', kwargs) specs to level closures.

Rebuild of [R] pyamg/relaxation/smoothing.py (SURVEY.md §2.3).
``change_smoothers(ml, pre, post)`` translates the reference's uniform
('name', kwargs) spec convention into per-level pre/post smoother
closures, computing spectral-radius-scaled omegas and Chebyshev
coefficients exactly as the reference does.  The device engine reuses the
resolved (name, kwargs, derived constants) records stored on each level
(``lvl.presmoother_spec``) to build its jitted smoothers.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import scipy.sparse as sp

from ..util.linalg import approximate_spectral_radius
from ..util.utils import get_block_diag, get_diagonal
from . import relaxation
from .chebyshev import chebyshev_polynomial_coefficients

__all__ = [
    "change_smoothers",
    "rho_D_inv_A",
    "rho_block_D_inv_A",
]

DEFAULT_SWEEP = "forward"
DEFAULT_NITER = 1


def rho_D_inv_A(A):
    """Spectral radius of D^{-1} A (cached on A).

    [R] pyamg/relaxation/smoothing.py::rho_D_inv_A.
    """
    cached = getattr(A, "_rho_D_inv", None)
    if cached is not None:
        return cached
    dinv = get_diagonal(A, inv=True)
    Acsr = sp.csr_matrix(A)
    # row scaling via in-place data multiply (scipy's broadcasting
    # .multiply() walks a much slower generic path)
    DinvA = Acsr.copy()
    DinvA.data = DinvA.data * np.repeat(dinv, np.diff(DinvA.indptr))
    rho = approximate_spectral_radius(DinvA)
    try:
        A._rho_D_inv = rho
    except AttributeError:
        pass
    return rho


def rho_block_D_inv_A(A, Dinv):
    """Spectral radius of block-D^{-1} A (cached on A).

    [R] pyamg/relaxation/smoothing.py::rho_block_D_inv_A.
    """
    cached = getattr(A, "_rho_block_D_inv", None)
    if cached is not None:
        return cached
    bs = Dinv.shape[1]
    from ..aggregation.smooth import _blockdiag_csr
    Dinv_mat = _blockdiag_csr(Dinv)
    DinvA = sp.csr_matrix(Dinv_mat @ sp.csr_matrix(A))
    rho = approximate_spectral_radius(DinvA)
    try:
        A._rho_block_D_inv = rho
    except AttributeError:
        pass
    return rho


def _unpack_spec(spec):
    if spec is None:
        return None, {}
    if isinstance(spec, str):
        return spec, {}
    if isinstance(spec, tuple):
        name, kwargs = spec
        return name, dict(kwargs)
    if callable(spec):
        return spec, {}
    raise ValueError(f"invalid smoother spec: {spec!r}")


def _setup_gauss_seidel(lvl, iterations=DEFAULT_NITER, sweep=DEFAULT_SWEEP):
    def smoother(A, x, b):
        relaxation.gauss_seidel(A, x, b, iterations=iterations, sweep=sweep)
    return smoother


def _setup_jacobi(lvl, iterations=DEFAULT_NITER, omega=1.0, withrho=True):
    omega_eff = omega / rho_D_inv_A(lvl.A) if withrho else omega

    def smoother(A, x, b):
        relaxation.jacobi(A, x, b, iterations=iterations, omega=omega_eff)
    return smoother


def _setup_richardson(lvl, iterations=DEFAULT_NITER, omega=1.0):
    rho = approximate_spectral_radius(lvl.A)
    omega_eff = omega / max(rho, 1e-300)

    def smoother(A, x, b):
        for _ in range(iterations):
            x += omega_eff * (b - A @ x)
    return smoother


def _setup_sor(lvl, omega=1.0, iterations=DEFAULT_NITER, sweep=DEFAULT_SWEEP):
    def smoother(A, x, b):
        relaxation.sor(A, x, b, omega, iterations=iterations, sweep=sweep)
    return smoother


def _setup_chebyshev(lvl, lower_bound=1.0 / 30.0, upper_bound=1.1, degree=3,
                     iterations=DEFAULT_NITER):
    rho = approximate_spectral_radius(lvl.A)
    a = rho * lower_bound
    b = rho * upper_bound
    coefficients = chebyshev_polynomial_coefficients(a, b, degree)

    def smoother(A, x, b_):
        relaxation.polynomial(A, x, b_, coefficients=coefficients,
                              iterations=iterations)
    return smoother


def _setup_polynomial(lvl, coefficients=None, iterations=DEFAULT_NITER):
    if coefficients is None:
        raise ValueError("polynomial smoother requires coefficients")

    def smoother(A, x, b):
        relaxation.polynomial(A, x, b, coefficients=coefficients,
                              iterations=iterations)
    return smoother


def _setup_block_jacobi(lvl, iterations=DEFAULT_NITER, omega=1.0,
                        Dinv=None, blocksize=None, withrho=True):
    A = lvl.A
    if blocksize is None:
        blocksize = A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1
    if blocksize == 1:
        return _setup_jacobi(lvl, iterations=iterations, omega=omega,
                             withrho=withrho)
    if Dinv is None:
        Dinv = get_block_diag(A, blocksize, inv_flag=True)
    omega_eff = omega / rho_block_D_inv_A(A, Dinv) if withrho else omega

    def smoother(A_, x, b):
        relaxation.block_jacobi(A_, x, b, Dinv=Dinv, blocksize=blocksize,
                                iterations=iterations, omega=omega_eff)
    return smoother


def _setup_block_gauss_seidel(lvl, iterations=DEFAULT_NITER,
                              sweep=DEFAULT_SWEEP, Dinv=None, blocksize=None):
    A = lvl.A
    if blocksize is None:
        blocksize = A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1
    if blocksize == 1:
        return _setup_gauss_seidel(lvl, iterations=iterations, sweep=sweep)
    if Dinv is None:
        Dinv = get_block_diag(A, blocksize, inv_flag=True)

    def smoother(A_, x, b):
        relaxation.block_gauss_seidel(A_, x, b, iterations=iterations,
                                      sweep=sweep, blocksize=blocksize,
                                      Dinv=Dinv)
    return smoother


def _setup_jacobi_ne(lvl, iterations=DEFAULT_NITER, omega=1.0):
    def smoother(A, x, b):
        relaxation.jacobi_ne(A, x, b, iterations=iterations, omega=omega)
    return smoother


def _setup_gauss_seidel_ne(lvl, iterations=DEFAULT_NITER, sweep=DEFAULT_SWEEP,
                           omega=1.0):
    def smoother(A, x, b):
        relaxation.gauss_seidel_ne(A, x, b, iterations=iterations,
                                   sweep=sweep, omega=omega)
    return smoother


def _setup_gauss_seidel_nr(lvl, iterations=DEFAULT_NITER, sweep=DEFAULT_SWEEP,
                           omega=1.0):
    def smoother(A, x, b):
        relaxation.gauss_seidel_nr(A, x, b, iterations=iterations,
                                   sweep=sweep, omega=omega)
    return smoother


def _setup_schwarz(lvl, iterations=DEFAULT_NITER, subdomain=None,
                   subdomain_ptr=None, inv_subblock=None,
                   inv_subblock_ptr=None, sweep=DEFAULT_SWEEP):
    def smoother(A, x, b):
        relaxation.schwarz(A, x, b, iterations=iterations,
                           subdomain=subdomain, subdomain_ptr=subdomain_ptr,
                           inv_subblock=inv_subblock,
                           inv_subblock_ptr=inv_subblock_ptr, sweep=sweep)
    return smoother


def _setup_strength_based_schwarz(lvl, iterations=DEFAULT_NITER,
                                  sweep=DEFAULT_SWEEP):
    # subdomains from the strength matrix C if present, else from A
    C = getattr(lvl, "C", None)
    if C is None:
        C = lvl.A
    C = sp.csr_matrix(C)
    subdomain_ptr = C.indptr.copy()
    subdomain = C.indices.copy()

    def smoother(A, x, b):
        relaxation.schwarz(A, x, b, iterations=iterations,
                           subdomain=subdomain, subdomain_ptr=subdomain_ptr,
                           sweep=sweep)
    return smoother


def _setup_cf_jacobi(lvl, **kwargs):
    Cpts, Fpts = _get_cf(lvl)

    def smoother(A, x, b):
        relaxation.cf_jacobi(A, x, b, Cpts, Fpts, **kwargs)
    return smoother


def _setup_fc_jacobi(lvl, **kwargs):
    Cpts, Fpts = _get_cf(lvl)

    def smoother(A, x, b):
        relaxation.fc_jacobi(A, x, b, Cpts, Fpts, **kwargs)
    return smoother


def _setup_cf_block_jacobi(lvl, **kwargs):
    Cpts, Fpts = _get_cf(lvl, block=True)

    def smoother(A, x, b):
        relaxation.cf_block_jacobi(A, x, b, Cpts, Fpts, **kwargs)
    return smoother


def _setup_fc_block_jacobi(lvl, **kwargs):
    Cpts, Fpts = _get_cf(lvl, block=True)

    def smoother(A, x, b):
        relaxation.fc_block_jacobi(A, x, b, Cpts, Fpts, **kwargs)
    return smoother


def _get_cf(lvl, block=False):
    splitting = getattr(lvl, "splitting", None)
    if splitting is None:
        raise ValueError("cf/fc smoothers need lvl.splitting (run a "
                         "classical/AIR setup with keep of splitting)")
    splitting = np.asarray(splitting)
    Cpts = np.flatnonzero(splitting == 1).astype(np.int64)
    Fpts = np.flatnonzero(splitting == 0).astype(np.int64)
    return Cpts, Fpts


def _setup_krylov(name):
    def setup(lvl, iterations=DEFAULT_NITER, **kwargs):
        from .. import krylov

        method = getattr(krylov, name)

        def smoother(A, x, b):
            xk, _ = method(A, b, x0=x, maxiter=iterations, tol=1e-12, **kwargs)
            x[:] = xk
        return smoother
    return setup


def _setup_none(lvl):
    def smoother(A, x, b):
        return
    return smoother


_SETUP = {
    "gauss_seidel": _setup_gauss_seidel,
    "jacobi": _setup_jacobi,
    "richardson": _setup_richardson,
    "sor": _setup_sor,
    "chebyshev": _setup_chebyshev,
    "polynomial": _setup_polynomial,
    "block_jacobi": _setup_block_jacobi,
    "block_gauss_seidel": _setup_block_gauss_seidel,
    "jacobi_ne": _setup_jacobi_ne,
    "gauss_seidel_ne": _setup_gauss_seidel_ne,
    "gauss_seidel_nr": _setup_gauss_seidel_nr,
    "schwarz": _setup_schwarz,
    "strength_based_schwarz": _setup_strength_based_schwarz,
    "cf_jacobi": _setup_cf_jacobi,
    "fc_jacobi": _setup_fc_jacobi,
    "cf_block_jacobi": _setup_cf_block_jacobi,
    "fc_block_jacobi": _setup_fc_block_jacobi,
    "gmres": _setup_krylov("gmres"),
    "cg": _setup_krylov("cg"),
    "cgne": _setup_krylov("cgne"),
    "cgnr": _setup_krylov("cgnr"),
    "none": _setup_none,
}


def _resolve(lvl, spec):
    name, kwargs = _unpack_spec(spec)
    if name is None:
        return _setup_none(lvl), (None, {})
    if callable(name):
        fn = name

        def smoother(A, x, b):
            fn(A, x, b, **kwargs)
        return smoother, (fn, kwargs)
    if name not in _SETUP:
        raise ValueError(f"unknown smoother '{name}'")
    return _SETUP[name](lvl, **kwargs), (name, kwargs)


def change_smoothers(ml, presmoother, postsmoother):
    """Bind pre/post smoother closures onto every level of ``ml``.

    Rebuild of [R] pyamg/relaxation/smoothing.py::change_smoothers.
    Accepts a single spec or a per-level list of specs; the last spec is
    repeated for deeper levels.  Also records the resolved
    ``(name, kwargs)`` on each level (``presmoother_spec`` /
    ``postsmoother_spec``) for the device engine to consume.
    """
    if not isinstance(presmoother, list):
        presmoother = [presmoother]
    if not isinstance(postsmoother, list):
        postsmoother = [postsmoother]
    nlev = len(ml.levels) - 1  # coarsest level uses the coarse solver
    for i, lvl in enumerate(ml.levels[:-1] if nlev > 0 else ml.levels):
        pre_spec = presmoother[min(i, len(presmoother) - 1)]
        post_spec = postsmoother[min(i, len(postsmoother) - 1)]
        lvl.presmoother, lvl.presmoother_spec = _resolve(lvl, pre_spec)
        lvl.postsmoother, lvl.postsmoother_spec = _resolve(lvl, post_spec)
    return ml

"""Chebyshev / MLS polynomial smoother coefficients.

Rebuild of [R] pyamg/relaxation/chebyshev.py (SURVEY.md §2.3).
Pure NumPy polynomial arithmetic; consumed by the polynomial smoother both
on host and in the device engine (where polynomial relaxation is the
device-preferred smoother: pure SpMV, no sequential dependence).
"""

from __future__ import annotations

import numpy as np

__all__ = ["chebyshev_polynomial_coefficients", "mls_polynomial_coefficients"]


def chebyshev_polynomial_coefficients(a, b, degree):
    """Chebyshev smoother coefficients on the spectral interval [a, b].

    Rebuild of [R] pyamg/relaxation/chebyshev.py::
    chebyshev_polynomial_coefficients.  Returns the coefficients (in
    descending order, constant term last) of the polynomial p such that the
    error propagator of ``x <- x + p(A) r`` is the scaled-and-shifted
    Chebyshev polynomial minimizing the max error over [a, b] subject to
    q(0) = 1, where q(t) = 1 - t p(t).
    """
    if a >= b:
        raise ValueError("expected a < b")
    degree = int(degree)
    if degree < 1:
        raise ValueError("expected degree >= 1")
    # roots of the shifted Chebyshev polynomial on [a, b]
    std_roots = np.cos(np.pi * (np.arange(degree) + 0.5) / degree)
    roots = 0.5 * (b - a) * (std_roots + 1.0) + a
    # q(t) = prod (t - r_i) / prod (0 - r_i)  => q(0) = 1
    monic = np.poly(roots)              # descending, monic, length degree+1
    q = monic / monic[-1]               # normalize constant term to 1
    # p(t) = (1 - q(t)) / t  => drop constant term, negate
    p = -q[:-1]
    return p


def mls_polynomial_coefficients(rho, degree):
    """MLS (multilevel smoother) polynomial coefficients.

    Rebuild of [R] pyamg/relaxation/chebyshev.py::mls_polynomial_coefficients
    (Brezina et al. energy-minimizing smoother used with SA).  Returns
    (coefficients_descending, roots) of the degree-``degree`` MLS smoother
    polynomial for an operator with spectral radius ``rho``.

    The MLS smoother combines the SPAI-like first kind polynomial with
    Chebyshev roots over [rho/9, rho] (the standard SA smoothing interval
    with coarsening-by-3 assumption).
    """
    degree = int(degree)
    # Chebyshev roots on [rho/9, rho] — 'smooth' part of the spectrum is
    # handled by coarse grid; target the upper 8/9 of the spectrum.
    a = rho / 9.0
    b = rho
    std_roots = np.cos(np.pi * (np.arange(degree) + 0.5) / degree)
    roots = 0.5 * (b - a) * (std_roots + 1.0) + a
    monic = np.poly(roots)
    q = monic / monic[-1]
    p = -q[:-1]
    return p, roots

"""Device (jitted) smoothers — the parallel relaxation forms.

Device equivalents of amg_core/relaxation.h (SURVEY.md §2.4):

- weighted Jacobi / block Jacobi / Richardson: pure SpMV + elementwise —
  embarrassingly parallel, the preferred device smoothers;
- **multicolor (hybrid) Gauss-Seidel**: the reference's sequential GS is
  replaced by coloring the graph (host, Jones-Plassmann) and sweeping
  colors in order, updating all rows of one color in parallel —
  BASELINE.json:2 names "hybrid Gauss-Seidel" as the parallel form;
- Chebyshev / polynomial: residual Horner, pure SpMV;
- cf/fc Jacobi: masked Jacobi over C/F index sets (AIR smoothers).

Representation: a :class:`DeviceSmoother` pytree whose *static config*
(kind, omega, iterations, ...) is aux data and whose device arrays
(dinv, colors, block inverses, masks) are pytree LEAVES: closure-captured
device arrays would become constants baked into each compiled program,
so everything flows as jit arguments.  Padded entries have dinv == 0 /
color == -1 so they stay identically zero.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["DeviceSmoother", "apply_smoother", "apply_smoother_zero"]


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class DeviceSmoother:
    """kind + static scalars (aux) and device arrays (leaves)."""

    config: Tuple            # (kind, ...static params...)
    arrays: Tuple            # tuple of jnp arrays

    def tree_flatten(self):
        return (self.arrays,), (self.config,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (arrays,) = children
        (config,) = aux
        return cls(config=config, arrays=tuple(arrays))

    def __call__(self, A, x, b):
        return apply_smoother(self.config, self.arrays, A, x, b)

    def zero_call(self, A, b):
        """Apply with a KNOWN-zero initial guess.

        Every coarse-level entry smoother — and the finest one under
        preconditioner use — starts from x = 0; the specialized first
        sweep replaces a full sweep with one elementwise op (jacobi:
        x1 = w D^-1 b) or skips the first residual SpMV (polynomial:
        r0 = b)."""
        return apply_smoother_zero(self.config, self.arrays, A, b)


def identity():
    return DeviceSmoother(config=("identity",), arrays=())


def jacobi(dinv, omega, iterations=1):
    return DeviceSmoother(config=("jacobi", float(omega), int(iterations)),
                          arrays=(dinv,))


def richardson(omega, iterations=1):
    return DeviceSmoother(config=("richardson", float(omega), int(iterations)),
                          arrays=())


def block_jacobi(Dinv, omega, iterations=1):
    return DeviceSmoother(config=("block_jacobi", float(omega), int(iterations)),
                          arrays=(Dinv,))


def multicolor_gs(dinv, colors, ncolors, sweep="forward", iterations=1):
    return DeviceSmoother(
        config=("mcgs", int(ncolors), str(sweep), int(iterations)),
        arrays=(dinv, colors))


def block_multicolor_gs(Dinv, colors, ncolors, sweep="forward", iterations=1):
    return DeviceSmoother(
        config=("block_mcgs", int(ncolors), str(sweep), int(iterations)),
        arrays=(Dinv, colors))


def polynomial(coefficients, iterations=1):
    coefficients = tuple(float(c) for c in np.asarray(coefficients))
    return DeviceSmoother(config=("poly", coefficients, int(iterations)),
                          arrays=())


def jacobi_dyn(dinv, omega, iterations=1):
    """Weighted Jacobi with a DEVICE-RESIDENT omega (0-d array leaf).

    Used by the one-program device setup pipeline: keeping omega on
    device avoids a device-to-host pull per scalar during setup."""
    return DeviceSmoother(config=("jacobi_dyn", int(iterations)),
                          arrays=(dinv, omega))


def richardson_dyn(omega, iterations=1):
    return DeviceSmoother(config=("richardson_dyn", int(iterations)),
                          arrays=(omega,))


def block_jacobi_dyn(Dinv, omega, iterations=1):
    """Block Jacobi with DEVICE-RESIDENT omega (block analog of
    jacobi_dyn, for the one-program block device setup pipeline)."""
    return DeviceSmoother(config=("block_jacobi_dyn", int(iterations)),
                          arrays=(Dinv, omega))


def polynomial_dyn(coefficients, iterations=1):
    """Polynomial (Chebyshev) smoother with device-resident coefficients
    (1-d array leaf, static length)."""
    return DeviceSmoother(config=("poly_dyn", int(iterations)),
                          arrays=(coefficients,))


def jacobi_ne(dinv_ne, omega, iterations=1):
    """Cimmino form of the reference's NE (Kaczmarz) smoothers: Jacobi on
    the normal equations A A^H y = b, x = A^H y, i.e.

        x += omega * A^T (D_ne^{-1} (b - A x)),  D_ne = diag(A A^T).

    ``dinv_ne[i] = 1/||A_i,:||^2`` (zero on padded rows).  Pure SpMV +
    transpose-SpMV — gather-free via DIAMatrix.rmatvec."""
    return DeviceSmoother(
        config=("jacobi_ne", float(omega), int(iterations)),
        arrays=(dinv_ne,))


def jacobi_nr(dinv_nr, omega, iterations=1):
    """Jacobi on the normal residual equations A^H A x = A^H b:

        x += omega * D_nr^{-1} (A^T (b - A x)),  D_nr = diag(A^T A).

    ``dinv_nr[j] = 1/||A_:,j||^2`` (zero on padded columns)."""
    return DeviceSmoother(
        config=("jacobi_nr", float(omega), int(iterations)),
        arrays=(dinv_nr,))


def windowed_schwarz(inv_blocks, window, stride, omega=1.0, iterations=1):
    """Damped additive overlapping Schwarz over CONTIGUOUS windows.

    The device form of the reference's overlapping Schwarz smoother
    (amg_core overlapping_schwarz_csr, SURVEY.md §2.4 relaxation.h):
    instead of strength-based per-node subdomains (whose application
    needs gathers), subdomains are the circular sliding windows
    [i*stride, i*stride + window); extraction and overlap-add are pure
    rolls/reshapes, the dense subdomain solves are one batched einsum.
    Each point lies in exactly window/stride subdomains, so the additive
    update is damped by stride/window (partition of unity).
    """
    return DeviceSmoother(
        config=("win_schwarz", int(window), int(stride), float(omega),
                int(iterations)),
        arrays=(inv_blocks,))


def masked_jacobi(dinv, masks, iters_per_mask, omega=1.0, iterations=1):
    """Ordered masked Jacobi (device cf/fc_jacobi): masks applied in
    order, each with its own sweep count."""
    return DeviceSmoother(
        config=("masked_jacobi", tuple(int(i) for i in iters_per_mask),
                float(omega), int(iterations)),
        arrays=(dinv,) + tuple(masks))


def _block_apply(Dinv, r2):
    """(n, bs, bs) @ (n, bs) batched, UNROLLED over the static bs as
    elementwise mul-adds — exact in the working precision, where a tiny
    batched f32 einsum at default precision may run in TF32 on the
    GPU."""
    bs = r2.shape[1]
    cols = [r2[:, j] for j in range(bs)]
    return jnp.stack(
        [sum(Dinv[:, i, j] * cols[j] for j in range(bs))
         for i in range(bs)], axis=1)


def _fit_len(v, n):
    """Slice/zero-pad a padded vector to length n (format paddings of
    rmatvec outputs can differ from the level's row padding)."""
    if v.shape[0] == n:
        return v
    if v.shape[0] > n:
        return v[:n]
    return jnp.pad(v, (0, n - v.shape[0]))


def _jacobi_step(A, x, b, dinv, omega):
    """One weighted-Jacobi sweep.  XLA fuses the SpMV and the update into
    one loop; under jax.vmap the batch axis leads (K-major lanes)."""
    return x + omega * (dinv * (b - (A @ x)))


def apply_smoother_zero(config, arrays, A, b):
    """apply_smoother with x = 0: the first sweep collapses (see
    DeviceSmoother.zero_call); remaining sweeps run the generic path."""
    kind = config[0]

    if kind == "identity":
        return jnp.zeros_like(b)

    if kind in ("jacobi", "jacobi_dyn"):
        if kind == "jacobi":
            _, omega, iterations = config
            (dinv,) = arrays
        else:
            _, iterations = config
            dinv, omega = arrays
        x = omega * (dinv * b)
        for _ in range(iterations - 1):
            x = _jacobi_step(A, x, b, dinv, omega)
        return x

    if kind in ("richardson", "richardson_dyn"):
        if kind == "richardson":
            _, omega, iterations = config
        else:
            _, iterations = config
            (omega,) = arrays
        x = omega * b
        for _ in range(iterations - 1):
            x = x + omega * (b - (A @ x))
        return x

    if kind in ("block_jacobi", "block_jacobi_dyn"):
        if kind == "block_jacobi":
            _, omega, iterations = config
            (Dinv,) = arrays
        else:
            _, iterations = config
            Dinv, omega = arrays
        bs = Dinv.shape[1]
        x = omega * _block_apply(Dinv, b.reshape(-1, bs)).reshape(-1)
        for _ in range(iterations - 1):
            r = (b - (A @ x)).reshape(-1, bs)
            x = x + omega * _block_apply(Dinv, r).reshape(-1)
        return x

    if kind in ("poly", "poly_dyn"):
        # first iteration: r = b - A@0 = b (one SpMV saved)
        if kind == "poly":
            _, coefficients, iterations = config
            h = coefficients[0] * b
            for c in coefficients[1:]:
                h = c * b + (A @ h)
        else:
            _, iterations = config
            (coefficients,) = arrays
            h = coefficients[0] * b
            for c in range(1, coefficients.shape[0]):
                h = coefficients[c] * b + (A @ h)
        x = h
        rest = ((config[0], config[1], iterations - 1)
                if kind == "poly" else ("poly_dyn", iterations - 1))
        if iterations > 1:
            x = apply_smoother(rest, arrays, A, x, b)
        return x

    return apply_smoother(config, arrays, A, jnp.zeros_like(b), b)


def apply_smoother(config, arrays, A, x, b):
    kind = config[0]

    if kind == "identity":
        return x

    if kind == "jacobi":
        _, omega, iterations = config
        (dinv,) = arrays
        for _ in range(iterations):
            x = _jacobi_step(A, x, b, dinv, omega)
        return x

    if kind == "richardson":
        _, omega, iterations = config
        for _ in range(iterations):
            x = x + omega * (b - (A @ x))
        return x

    if kind == "block_jacobi":
        _, omega, iterations = config
        (Dinv,) = arrays
        bs = Dinv.shape[1]
        for _ in range(iterations):
            r = (b - (A @ x)).reshape(-1, bs)
            x = x + omega * _block_apply(Dinv, r).reshape(-1)
        return x

    if kind == "mcgs":
        _, ncolors, sweep, iterations = config
        dinv, colors = arrays

        def one_color(x, c):
            r = b - (A @ x)
            return jnp.where(colors == c, x + dinv * r, x)

        for _ in range(iterations):
            if sweep in ("forward", "symmetric"):
                for c in range(ncolors):
                    x = one_color(x, c)
            if sweep in ("backward", "symmetric"):
                for c in range(ncolors - 1, -1, -1):
                    x = one_color(x, c)
        return x

    if kind == "block_mcgs":
        _, ncolors, sweep, iterations = config
        Dinv, colors = arrays
        bs = Dinv.shape[1]

        def one_color(x, c):
            r = (b - (A @ x)).reshape(-1, bs)
            upd = x.reshape(-1, bs) + _block_apply(Dinv, r)
            return jnp.where((colors == c)[:, None], upd,
                             x.reshape(-1, bs)).reshape(-1)

        for _ in range(iterations):
            if sweep in ("forward", "symmetric"):
                for c in range(ncolors):
                    x = one_color(x, c)
            if sweep in ("backward", "symmetric"):
                for c in range(ncolors - 1, -1, -1):
                    x = one_color(x, c)
        return x

    if kind == "poly":
        _, coefficients, iterations = config
        for _ in range(iterations):
            r = b - (A @ x)
            h = coefficients[0] * r
            for c in coefficients[1:]:
                h = c * r + (A @ h)
            x = x + h
        return x

    if kind == "jacobi_dyn":
        _, iterations = config
        dinv, omega = arrays
        for _ in range(iterations):
            x = _jacobi_step(A, x, b, dinv, omega)
        return x

    if kind == "richardson_dyn":
        _, iterations = config
        (omega,) = arrays
        for _ in range(iterations):
            x = x + omega * (b - (A @ x))
        return x

    if kind == "block_jacobi_dyn":
        _, iterations = config
        Dinv, omega = arrays
        bs = Dinv.shape[1]
        for _ in range(iterations):
            r = (b - (A @ x)).reshape(-1, bs)
            x = x + omega * _block_apply(Dinv, r).reshape(-1)
        return x

    if kind == "poly_dyn":
        _, iterations = config
        (coefficients,) = arrays
        k = coefficients.shape[0]
        for _ in range(iterations):
            r = b - (A @ x)
            h = coefficients[0] * r
            for c in range(1, k):
                h = coefficients[c] * r + (A @ h)
            x = x + h
        return x

    if kind == "jacobi_ne":
        _, omega, iterations = config
        (dinv,) = arrays
        for _ in range(iterations):
            upd = A.rmatvec(dinv * (b - (A @ x)))
            x = x + omega * _fit_len(upd, x.shape[0])
        return x

    if kind == "jacobi_nr":
        _, omega, iterations = config
        (dinv,) = arrays
        for _ in range(iterations):
            upd = A.rmatvec(b - (A @ x))
            x = x + omega * (dinv * _fit_len(upd, x.shape[0]))
        return x

    if kind == "win_schwarz":
        _, w, s, omega, iterations = config
        (inv_blocks,) = arrays
        q = w // s
        nwin = inv_blocks.shape[0]
        for _ in range(iterations):
            r = b - (A @ x)
            Wn = jnp.concatenate(
                [jnp.roll(r, -c * s).reshape(nwin, s) for c in range(q)],
                axis=1)                                   # (nwin, w)
            u = jnp.einsum("nij,nj->ni", inv_blocks, Wn,
                               precision=jax.lax.Precision.HIGHEST)
            upd = jnp.zeros_like(r)
            for c in range(q):
                upd = upd + jnp.roll(
                    u[:, c * s:(c + 1) * s].reshape(-1), c * s)
            x = x + (omega / q) * upd
        return x

    if kind == "masked_jacobi":
        _, iters_per_mask, omega, iterations = config
        dinv = arrays[0]
        masks = arrays[1:]
        for _ in range(iterations):
            for mask, k in zip(masks, iters_per_mask):
                for _ in range(k):
                    r = b - (A @ x)
                    x = jnp.where(mask, x + omega * dinv * r, x)
        return x

    raise ValueError(f"unknown device smoother kind {kind!r}")

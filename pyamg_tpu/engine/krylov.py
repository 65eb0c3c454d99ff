"""Device (lax.while_loop) Krylov methods.

Device solve-phase analogs of pyamg_tpu.krylov (SURVEY.md §2.3 L5):
the whole preconditioned iteration is one XLA program; residual norms are
captured into a fixed-size history buffer (maxiter+1, NaN-padded) so the
reference's ``residuals`` list contract survives jit (BASELINE.json:5).

All methods take ``matvec``/``precond`` closures over padded vectors and
return ``(x, history, iterations)``.  Real arithmetic (f32/f64); complex
systems use the host path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["device_cg", "device_bicgstab", "device_fgmres",
           "device_gmres", "device_cgnr", "device_cgne", "device_cr",
           "device_minimal_residual", "device_steepest_descent"]


def _vdot(a, b):
    """Inner product as elementwise multiply + tree sum.

    An elementwise multiply + sum is one bandwidth-bound fusion with no
    precision setting to get wrong; a default-precision f32 dot may run
    in TF32 on the GPU.  The mixed-precision outer Krylov loop depends on
    full f64 accuracy here."""
    return jnp.sum(jnp.conj(a) * b)


def _norm(a):
    return jnp.sqrt(jnp.real(jnp.sum(jnp.conj(a) * a)))


def _rtol_of(b, tol):
    normb = _norm(b)
    return tol * jnp.where(normb == 0, 1.0, normb)


def _hist_set(history, idx, value):
    """history with history[idx] = value, as a where-over-iota instead of
    a dynamic_update_slice: under vmap (batched multi-RHS solves) ``idx``
    is per-lane, and a batched dynamic_update_slice lowers to a scatter.
    The iota form is a tiny elementwise select in both the 1-D and
    batched cases."""
    iota = lax.iota(jnp.int32, history.shape[0])
    return jnp.where(iota == idx, value.astype(history.dtype), history)


def _freeze(active, new, old):
    """Per-lane convergence freeze: lax.while_loop under vmap keeps
    running the body lock-step until EVERY lane's cond is False, so each
    state update must be masked for lanes that already converged.  In the
    unbatched case ``active`` is True whenever the body runs (the loop
    cond guarantees it), so this is a no-op select that XLA folds."""
    return jax.tree_util.tree_map(
        lambda n, o: jnp.where(active, n, o), new, old)


def device_cg(matvec, b, x0, tol=1e-8, maxiter=100, M=None):
    """Preconditioned CG; see pyamg_tpu/krylov/_cg.py for the host form."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)

    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = _vdot(r, z)
    normr = _norm(r)
    rtol = _rtol_of(b, tol)
    history = jnp.full(maxiter + 1, jnp.nan, dtype=b.dtype).at[0].set(normr)

    def cond(state):
        it, x, r, p, rz, normr, history = state
        return (normr >= rtol) & (it < maxiter)

    def body(state):
        it, x, r, p, rz, normr, history = state
        active = (normr >= rtol) & (it < maxiter)
        Ap = matvec(p)
        pAp = _vdot(p, Ap)
        alpha = rz / jnp.where(pAp == 0, 1.0, pAp)
        alpha = jnp.where(pAp == 0, 0.0, alpha)
        x2 = x + alpha * p
        r2 = r - alpha * Ap
        normr2 = _norm(r2)
        history2 = _hist_set(history, it + 1, normr2)
        z = precond(r2)
        rz2 = _vdot(r2, z)
        beta = rz2 / jnp.where(rz == 0, 1.0, rz)
        beta = jnp.where(rz == 0, 0.0, beta)
        p2 = z + beta * p
        return _freeze(active,
                       (it + 1, x2, r2, p2, rz2, normr2, history2), state)

    state = (jnp.asarray(0), x0, r, p, rz, normr, history)
    it, x, r, p, rz, normr, history = lax.while_loop(cond, body, state)
    return x, history, it


def device_bicgstab(matvec, b, x0, tol=1e-8, maxiter=100, M=None):
    """Preconditioned BiCGStab; host form: pyamg_tpu/krylov/_bicgstab.py."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)

    r = b - matvec(x0)
    normr = _norm(r)
    rtol = _rtol_of(b, tol)
    history = jnp.full(maxiter + 1, jnp.nan, dtype=b.dtype).at[0].set(normr)
    rstar = r
    p = r
    rrstar = _vdot(rstar, r)

    def cond(state):
        it, x, r, p, rrstar, normr, history, breakdown = state
        return (normr >= rtol) & (it < maxiter) & (~breakdown)

    def body(state):
        it, x, r, p, rrstar, normr, history, breakdown = state
        active = (normr >= rtol) & (it < maxiter) & (~breakdown)
        Mp = precond(p)
        AMp = matvec(Mp)
        denom = _vdot(rstar, AMp)
        bad1 = denom == 0
        alpha = rrstar / jnp.where(bad1, 1.0, denom)
        s = r - alpha * AMp
        Ms = precond(s)
        AMs = matvec(Ms)
        denom2 = _vdot(AMs, AMs)
        bad2 = denom2 == 0
        omega = _vdot(AMs, s) / jnp.where(bad2, 1.0, denom2)
        x2 = x + jnp.where(bad1 | bad2, 0.0, 1.0) * (alpha * Mp + omega * Ms)
        r_new = s - omega * AMs
        r2 = jnp.where(bad1 | bad2, r, r_new)
        normr2 = _norm(r2)
        history2 = _hist_set(history, it + 1, normr2)
        rrstar2 = _vdot(rstar, r2)
        bad3 = (rrstar == 0) | (omega == 0)
        beta = (rrstar2 / jnp.where(rrstar == 0, 1.0, rrstar)) * \
               (alpha / jnp.where(omega == 0, 1.0, omega))
        p2 = r2 + jnp.where(bad3, 0.0, beta) * (p - omega * AMp)
        return _freeze(active,
                       (it + 1, x2, r2, p2, rrstar2, normr2, history2,
                        bad1 | bad2 | bad3), state)

    state = (jnp.asarray(0), x0, r, p, rrstar, normr, history,
             jnp.asarray(False))
    out = lax.while_loop(cond, body, state)
    it, x = out[0], out[1]
    history = out[6]
    return x, history, it


def device_fgmres(matvec, b, x0, tol=1e-8, maxiter=100, M=None, restart=30):
    """Right-preconditioned flexible GMRES(restart).

    Orthogonalization: CGS2 (classical Gram-Schmidt with one
    reorthogonalization) — two (m+1, n) matmuls per step instead of the
    reference's sequential MGS dots (amg_core apply_givens analog runs as
    a fori_loop over the rotation pairs).  Numerically CGS2 is as robust
    as MGS.  Inner steps run as lax.fori_loop with masked updates; outer
    restarts as lax.while_loop.  History holds the Givens true-residual
    estimates.  Host form: pyamg_tpu/krylov/_fgmres.py.
    """
    maxiter = int(maxiter)
    m = int(min(restart, maxiter))
    max_outer = -(-maxiter // m)
    precond = M if M is not None else (lambda v: v)
    n = b.shape[0]
    dtype = b.dtype

    rtol = _rtol_of(b, tol)
    r0 = b - matvec(x0)
    normr0 = _norm(r0)
    history = jnp.full(maxiter + 1, jnp.nan, dtype=dtype).at[0].set(normr0)

    def one_cycle(x, history, it):
        r = b - matvec(x)
        beta = _norm(r)
        safe_beta = jnp.where(beta == 0, 1.0, beta)
        V0 = jnp.zeros((m + 1, n), dtype=dtype).at[0].set(r / safe_beta)
        Z0 = jnp.zeros((m, n), dtype=dtype)
        H0 = jnp.zeros((m + 1, m), dtype=dtype)
        cs0 = jnp.zeros(m, dtype=dtype)
        sn0 = jnp.zeros(m, dtype=dtype)
        g0 = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)

        def inner(j, carry):
            V, Z, H, cs, sn, g, history, normr = carry
            z = precond(V[j])
            w = matvec(z)
            Z = Z.at[j].set(z)
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            # CGS2: project, then re-project the remainder.  f64 basis
            # products as broadcast-multiply + axis reductions (see
            # _vdot).
            if dtype == jnp.float64:
                proj = lambda M_, v: jnp.sum(M_ * v, axis=1)
                comb = lambda c_, M_: jnp.sum(c_[:, None] * M_, axis=0)
            else:
                # HIGHEST: the Gram dots set the Hessenberg entries; a
                # default-precision f32 dot may run in TF32 on the GPU
                # (the basis reads are bandwidth-bound either way)
                proj = lambda M_, v: jnp.dot(
                    M_, v, precision=jax.lax.Precision.HIGHEST)
                comb = lambda c_, M_: jnp.dot(
                    c_, M_, precision=jax.lax.Precision.HIGHEST)
            h1 = proj(V, w) * mask
            w = w - comb(h1, V)
            h2 = proj(V, w) * mask
            w = w - comb(h2, V)
            hcol = h1 + h2
            wnorm = _norm(w)
            hcol = hcol.at[j + 1].set(wnorm)

            def rot(i, h):
                t = cs[i] * h[i] + sn[i] * h[i + 1]
                h = h.at[i + 1].set(-sn[i] * h[i] + cs[i] * h[i + 1])
                return h.at[i].set(t)

            hcol = lax.fori_loop(0, j, rot, hcol)
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            safe = denom > 0
            denom_s = jnp.where(safe, denom, 1.0)
            c = jnp.where(safe, hcol[j] / denom_s, 1.0)
            s = jnp.where(safe, hcol[j + 1] / denom_s, 0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            hcol = hcol.at[j].set(c * hcol[j] + s * hcol[j + 1])
            hcol = hcol.at[j + 1].set(0.0)
            H = H.at[:, j].set(hcol)
            gj1 = -s * g[j]
            g = g.at[j + 1].set(gj1)
            g = g.at[j].set(c * g[j])
            normr_new = jnp.abs(gj1)
            active = normr >= rtol
            iota = lax.iota(jnp.int32, history.shape[0])
            history = jnp.where(active & (iota == it + j + 1),
                                normr_new.astype(history.dtype), history)
            normr = jnp.where(active, normr_new, normr)
            V = V.at[j + 1].set(
                jnp.where(wnorm > 0, w / jnp.where(wnorm > 0, wnorm, 1.0), 0.0)
            )
            return (V, Z, H, cs, sn, g, history, normr)

        V, Z, H, cs, sn, g, history, normr = lax.fori_loop(
            0, m, inner, (V0, Z0, H0, cs0, sn0, g0, history, beta))

        # back-substitution on the (possibly singular-tail) triangular H
        Hm = H[:m, :m]
        diag = jnp.diagonal(Hm)
        Hm = Hm + jnp.diag(jnp.where(jnp.abs(diag) > 0, 0.0, 1.0))
        g_eff = jnp.where(jnp.abs(diag) > 0, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Hm, g_eff, lower=False)
        if dtype == jnp.float64:
            x = x + jnp.sum(y[:, None] * Z, axis=0)
        else:
            x = x + jnp.dot(y, Z, precision=lax.Precision.HIGHEST)
        return x, history, it + m, normr

    def cond(state):
        x, history, it, normr, outer = state
        return (normr >= rtol) & (outer < max_outer)

    def body(state):
        x, history, it, normr, outer = state
        active = (normr >= rtol) & (outer < max_outer)
        x2, history2, it2, normr2 = one_cycle(x, history, it)
        return _freeze(active, (x2, history2, it2, normr2, outer + 1),
                       state)

    state = (x0, history, jnp.asarray(0), normr0, jnp.asarray(0))
    x, history, it, normr, outer = lax.while_loop(cond, body, state)
    return x, history, jnp.minimum(it, maxiter)


def device_gmres(matvec, b, x0, tol=1e-8, maxiter=100, M=None, restart=30):
    """LEFT-preconditioned restarted GMRES — the device analog of the
    host gmres_mgs (pyamg_tpu/krylov/_gmres_mgs.py; reference [R]
    pyamg/krylov/_gmres_mgs.py, SURVEY.md §2.3): the Krylov space is
    built on M·A, the residual history holds the Givens estimates of the
    PRECONDITIONED residual norm, and rtol references ||M b|| (the host
    'rr' criterion).  Orthogonalization is CGS2 (two batched basis
    matmuls per step instead of MGS's sequential dots — numerically as
    robust; see device_fgmres).  Histories match
    the host to orthogonalization rounding."""
    maxiter = int(maxiter)
    m = int(min(restart, maxiter))
    max_outer = -(-maxiter // m)
    precond = M if M is not None else (lambda v: v)
    n = b.shape[0]
    dtype = b.dtype

    Mb = precond(b)
    rtol = tol * jnp.where(_norm(Mb) == 0, 1.0, _norm(Mb))
    z0 = precond(b - matvec(x0))
    normr0 = _norm(z0)
    history = jnp.full(maxiter + 1, jnp.nan, dtype=dtype).at[0].set(normr0)

    def one_cycle(x, history, it):
        z = precond(b - matvec(x))
        beta = _norm(z)
        safe_beta = jnp.where(beta == 0, 1.0, beta)
        V0 = jnp.zeros((m + 1, n), dtype=dtype).at[0].set(z / safe_beta)
        H0 = jnp.zeros((m + 1, m), dtype=dtype)
        cs0 = jnp.zeros(m, dtype=dtype)
        sn0 = jnp.zeros(m, dtype=dtype)
        g0 = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)

        def inner(j, carry):
            V, H, cs, sn, g, history, normr = carry
            w = precond(matvec(V[j]))
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            if dtype == jnp.float64:
                # f64 basis products as reductions (see _vdot)
                proj = lambda M_, v: jnp.sum(M_ * v, axis=1)
                comb = lambda c_, M_: jnp.sum(c_[:, None] * M_, axis=0)
            else:
                proj = lambda M_, v: jnp.dot(
                    M_, v, precision=jax.lax.Precision.HIGHEST)
                comb = lambda c_, M_: jnp.dot(
                    c_, M_, precision=jax.lax.Precision.HIGHEST)
            h1 = proj(V, w) * mask
            w = w - comb(h1, V)
            h2 = proj(V, w) * mask
            w = w - comb(h2, V)
            hcol = h1 + h2
            wnorm = _norm(w)
            hcol = hcol.at[j + 1].set(wnorm)

            def rot(i, h):
                t = cs[i] * h[i] + sn[i] * h[i + 1]
                h = h.at[i + 1].set(-sn[i] * h[i] + cs[i] * h[i + 1])
                return h.at[i].set(t)

            hcol = lax.fori_loop(0, j, rot, hcol)
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            safe = denom > 0
            denom_s = jnp.where(safe, denom, 1.0)
            c = jnp.where(safe, hcol[j] / denom_s, 1.0)
            s = jnp.where(safe, hcol[j + 1] / denom_s, 0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            hcol = hcol.at[j].set(c * hcol[j] + s * hcol[j + 1])
            hcol = hcol.at[j + 1].set(0.0)
            H = H.at[:, j].set(hcol)
            gj1 = -s * g[j]
            g = g.at[j + 1].set(gj1)
            g = g.at[j].set(c * g[j])
            normr_new = jnp.abs(gj1)
            active = normr >= rtol
            iota = lax.iota(jnp.int32, history.shape[0])
            history = jnp.where(active & (iota == it + j + 1),
                                normr_new.astype(history.dtype), history)
            normr = jnp.where(active, normr_new, normr)
            V = V.at[j + 1].set(
                jnp.where(wnorm > 0,
                          w / jnp.where(wnorm > 0, wnorm, 1.0), 0.0))
            return (V, H, cs, sn, g, history, normr)

        V, H, cs, sn, g, history, normr = lax.fori_loop(
            0, m, inner, (V0, H0, cs0, sn0, g0, history, beta))

        Hm = H[:m, :m]
        diag = jnp.diagonal(Hm)
        Hm = Hm + jnp.diag(jnp.where(jnp.abs(diag) > 0, 0.0, 1.0))
        g_eff = jnp.where(jnp.abs(diag) > 0, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Hm, g_eff, lower=False)
        if dtype == jnp.float64:
            x = x + jnp.sum(y[:, None] * V[:m], axis=0)
        else:
            x = x + jnp.dot(y, V[:m], precision=lax.Precision.HIGHEST)
        return x, history, it + m, normr

    def cond(state):
        x, history, it, normr, outer = state
        return (normr >= rtol) & (outer < max_outer)

    def body(state):
        x, history, it, normr, outer = state
        active = (normr >= rtol) & (outer < max_outer)
        x2, history2, it2, normr2 = one_cycle(x, history, it)
        return _freeze(active, (x2, history2, it2, normr2, outer + 1),
                       state)

    state = (x0, history, jnp.asarray(0), normr0, jnp.asarray(0))
    x, history, it, normr, outer = lax.while_loop(cond, body, state)
    return x, history, jnp.minimum(it, maxiter)


def device_cgnr(matvec, rmatvec, b, x0, tol=1e-8, maxiter=100, M=None):
    """CG on the normal equations A^H A x = A^H b (residual-minimizing);
    host form pyamg_tpu/krylov/_cgnr.py.  ``rmatvec`` applies A^T (real
    arithmetic on device — the hierarchy dtypes here are f32/f64).
    This is also the native home for gauss_seidel_nr-class normal-
    equation solves (SURVEY.md §2.3)."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)

    r = b - matvec(x0)
    normr = _norm(r)
    rtol = _rtol_of(b, tol)
    history = jnp.full(maxiter + 1, jnp.nan, dtype=b.dtype).at[0].set(normr)
    z = rmatvec(precond(r))
    p = z
    zz = _vdot(z, z)

    def cond(state):
        it, x, r, p, zz, normr, history = state
        return (normr >= rtol) & (it < maxiter)

    def body(state):
        it, x, r, p, zz, normr, history = state
        active = (normr >= rtol) & (it < maxiter)
        Ap = matvec(p)
        App = _vdot(Ap, Ap)
        alpha = zz / jnp.where(App == 0, 1.0, App)
        alpha = jnp.where(App == 0, 0.0, alpha)
        x2 = x + alpha * p
        r2 = r - alpha * Ap
        normr2 = _norm(r2)
        history2 = _hist_set(history, it + 1, normr2)
        z2 = rmatvec(precond(r2))
        zz2 = _vdot(z2, z2)
        beta = zz2 / jnp.where(zz == 0, 1.0, zz)
        beta = jnp.where(zz == 0, 0.0, beta)
        p2 = z2 + beta * p
        return _freeze(active,
                       (it + 1, x2, r2, p2, zz2, normr2, history2), state)

    state = (jnp.asarray(0), x0, r, p, zz, normr, history)
    out = lax.while_loop(cond, body, state)
    return out[1], out[6], out[0]


def device_cgne(matvec, rmatvec, b, x0, tol=1e-8, maxiter=100, M=None):
    """CG on A A^H y = b, x = A^H y (error-minimizing normal-equation
    form); host form pyamg_tpu/krylov/_cgne.py."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)

    r = b - matvec(x0)
    normr = _norm(r)
    rtol = _rtol_of(b, tol)
    history = jnp.full(maxiter + 1, jnp.nan, dtype=b.dtype).at[0].set(normr)
    z = precond(r)
    p = rmatvec(z)
    rz = _vdot(r, z)

    def cond(state):
        it, x, r, p, rz, normr, history = state
        return (normr >= rtol) & (it < maxiter)

    def body(state):
        it, x, r, p, rz, normr, history = state
        active = (normr >= rtol) & (it < maxiter)
        pp = _vdot(p, p)
        alpha = rz / jnp.where(pp == 0, 1.0, pp)
        alpha = jnp.where(pp == 0, 0.0, alpha)
        x2 = x + alpha * p
        r2 = r - alpha * matvec(p)
        normr2 = _norm(r2)
        history2 = _hist_set(history, it + 1, normr2)
        z2 = precond(r2)
        rz2 = _vdot(r2, z2)
        beta = rz2 / jnp.where(rz == 0, 1.0, rz)
        beta = jnp.where(rz == 0, 0.0, beta)
        p2 = rmatvec(z2) + beta * p
        return _freeze(active,
                       (it + 1, x2, r2, p2, rz2, normr2, history2), state)

    state = (jnp.asarray(0), x0, r, p, rz, normr, history)
    out = lax.while_loop(cond, body, state)
    return out[1], out[6], out[0]


def device_cr(matvec, b, x0, tol=1e-8, maxiter=100, M=None):
    """Conjugate residual for Hermitian (possibly indefinite) systems;
    host form pyamg_tpu/krylov/_cr.py."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)

    r = b - matvec(x0)
    z = precond(r)
    p = z
    Az = matvec(z)
    Ap = Az
    rAz = _vdot(z, Az)
    normr = _norm(r)
    rtol = _rtol_of(b, tol)
    history = jnp.full(maxiter + 1, jnp.nan, dtype=b.dtype).at[0].set(normr)

    def cond(state):
        it, x, r, p, Ap, rAz, normr, history = state
        return (normr >= rtol) & (it < maxiter)

    def body(state):
        it, x, r, p, Ap, rAz, normr, history = state
        active = (normr >= rtol) & (it < maxiter)
        MAp = precond(Ap)
        ApAp = _vdot(Ap, MAp)
        alpha = rAz / jnp.where(ApAp == 0, 1.0, ApAp)
        alpha = jnp.where(ApAp == 0, 0.0, alpha)
        x2 = x + alpha * p
        r2 = r - alpha * Ap
        z2 = precond(r2)
        normr2 = _norm(r2)
        history2 = _hist_set(history, it + 1, normr2)
        Az2 = matvec(z2)
        rAz2 = _vdot(z2, Az2)
        beta = rAz2 / jnp.where(rAz == 0, 1.0, rAz)
        beta = jnp.where(rAz == 0, 0.0, beta)
        p2 = z2 + beta * p
        Ap2 = Az2 + beta * Ap
        return _freeze(
            active, (it + 1, x2, r2, p2, Ap2, rAz2, normr2, history2),
            state)

    state = (jnp.asarray(0), x0, r, p, Ap, rAz, normr, history)
    out = lax.while_loop(cond, body, state)
    return out[1], out[7], out[0]


def device_minimal_residual(matvec, b, x0, tol=1e-8, maxiter=100, M=None):
    """One-dimensional residual-minimizing iteration; host form
    pyamg_tpu/krylov/_minimal_residual.py."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)

    r = b - matvec(x0)
    normr = _norm(r)
    rtol = _rtol_of(b, tol)
    history = jnp.full(maxiter + 1, jnp.nan, dtype=b.dtype).at[0].set(normr)

    def cond(state):
        it, x, r, normr, history = state
        return (normr >= rtol) & (it < maxiter)

    def body(state):
        it, x, r, normr, history = state
        active = (normr >= rtol) & (it < maxiter)
        p = precond(r)
        Ap = matvec(p)
        denom = _vdot(Ap, Ap)
        alpha = _vdot(Ap, r) / jnp.where(denom == 0, 1.0, denom)
        alpha = jnp.where(denom == 0, 0.0, alpha)
        x2 = x + alpha * p
        r2 = r - alpha * Ap
        normr2 = _norm(r2)
        history2 = _hist_set(history, it + 1, normr2)
        return _freeze(active, (it + 1, x2, r2, normr2, history2), state)

    state = (jnp.asarray(0), x0, r, normr, history)
    out = lax.while_loop(cond, body, state)
    return out[1], out[4], out[0]


def device_steepest_descent(matvec, b, x0, tol=1e-8, maxiter=100, M=None):
    """Energy-minimizing steepest descent for SPD systems; host form
    pyamg_tpu/krylov/_steepest_descent.py."""
    maxiter = int(maxiter)
    precond = M if M is not None else (lambda v: v)

    r = b - matvec(x0)
    normr = _norm(r)
    rtol = _rtol_of(b, tol)
    history = jnp.full(maxiter + 1, jnp.nan, dtype=b.dtype).at[0].set(normr)

    def cond(state):
        it, x, r, normr, history = state
        return (normr >= rtol) & (it < maxiter)

    def body(state):
        it, x, r, normr, history = state
        active = (normr >= rtol) & (it < maxiter)
        z = precond(r)
        Az = matvec(z)
        denom = _vdot(z, Az)
        alpha = _vdot(r, z) / jnp.where(denom == 0, 1.0, denom)
        alpha = jnp.where(denom == 0, 0.0, alpha)
        x2 = x + alpha * z
        r2 = r - alpha * Az
        normr2 = _norm(r2)
        history2 = _hist_set(history, it + 1, normr2)
        return _freeze(active, (it + 1, x2, r2, normr2, history2), state)

    state = (jnp.asarray(0), x0, r, normr, history)
    out = lax.while_loop(cond, body, state)
    return out[1], out[4], out[0]

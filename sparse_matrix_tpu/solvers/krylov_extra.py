"""BiCG, CGS, QMR, TFQMR: the remaining classical nonsymmetric Krylov
solvers.

North-star scope (the Rust reference ends at SpGEMM,
``/root/reference/spam_csr/src/mul_hash.rs``): these four complete the
scipy.sparse.linalg iterative-solver surface next to the existing CG /
BiCGStab / GMRES / MINRES / LSQR / LSMR. Same discipline as :mod:`.cg`:
pluggable matvecs (device SpMV operators or any jax-traceable callable),
one jitted ``lax.while_loop`` per solve — no host round-trips per
iteration.

Recurrences follow the standard formulations (Templates, Barrett et al.
1994; Freund 1993 for TFQMR; Freund & Nachtigal 1991 for QMR without
look-ahead), validated differentially against scipy in
``tests/test_krylov_extra.py``. First-iteration special cases are folded
into the loop by zero/unit initial values (p = q = d = s = 0, eps = 1)
so every body is branch-free under jit.

Breakdown handling matches the house style (:mod:`.bicgstab`): divisions
are guarded, a breakdown collapses the ``ok`` flag and the loop returns
the current iterate with its residual — callers observe non-convergence
through ``residual_norm``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .cg import CgResult

__all__ = ["bicg_solve", "cgs_solve", "qmr_solve", "tfqmr_solve"]

_EPS = 1e-30


def _guard(d):
    """Divide-safe denominator (preserves sign)."""
    return jnp.where(jnp.abs(d) < _EPS, jnp.where(d < 0, -_EPS, _EPS), d)


def bicg_solve(
    matvec: Callable,
    rmatvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    m_inv: Callable = None,
    m_inv_t: Callable = None,
) -> CgResult:
    """Bi-Conjugate Gradients: CG's two-sided recurrence for general
    square ``A``; needs ``rmatvec(v) = A^T v`` (one device transpose plan,
    see :mod:`..ops.device_sorted`). ``m_inv``/``m_inv_t`` apply an
    approximate inverse of A and its transpose (for symmetric
    preconditioners pass the same callable twice)."""
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    if m_inv is None:
        m_inv = lambda v: v  # noqa: E731
    if m_inv_t is None:
        m_inv_t = m_inv

    r = b - matvec(x)
    rt = r
    b_norm2 = jnp.vdot(b, b).real
    tol2 = jnp.asarray(tol, b_norm2.dtype) ** 2 * jnp.where(b_norm2 > 0, b_norm2, 1.0)
    p = jnp.zeros_like(b)
    pt = jnp.zeros_like(b)
    rho = jnp.ones((), b_norm2.dtype)

    def cond(st):
        _x, _r, _rt, _p, _pt, _rho, rr, ok, k = st
        return jnp.logical_and(jnp.logical_and(rr > tol2, ok), k < maxiter)

    def body(st):
        x, r, rt, p, pt, rho_prev, _rr, _ok, k = st
        z = m_inv(r)
        zt = m_inv_t(rt)
        rho = jnp.vdot(rt, z).real
        beta = rho / _guard(rho_prev)
        p = z + beta * p
        pt = zt + beta * pt
        q = matvec(p)
        qt = rmatvec(pt)
        denom = jnp.vdot(pt, q).real
        alpha = rho / _guard(denom)
        # breakdown: keep the previous iterate (the loop exits on !ok;
        # committing a NaN/inf step would corrupt the returned x)
        ok = jnp.logical_and(jnp.abs(rho) > _EPS, jnp.abs(denom) > _EPS)
        x = jnp.where(ok, x + alpha * p, x)
        r = jnp.where(ok, r - alpha * q, r)
        rt = rt - alpha * qt
        return x, r, rt, p, pt, rho, jnp.vdot(r, r).real, ok, k + 1

    x, r, rt, p, pt, rho, rr, ok, k = jax.lax.while_loop(
        cond,
        body,
        (x, r, rt, p, pt, rho, jnp.vdot(r, r).real, jnp.bool_(True), jnp.int32(0)),
    )
    return CgResult(x=x, iterations=k, residual_norm=jnp.sqrt(rr))


def cgs_solve(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    m_inv: Callable = None,
) -> CgResult:
    """Conjugate Gradient Squared (Sonneveld): transpose-free BiCG with
    squared contraction — faster when BiCG converges, rougher when it
    doesn't. ``m_inv`` preconditions the search directions (the recurrence
    tracks the TRUE residual)."""
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    if m_inv is None:
        m_inv = lambda v: v  # noqa: E731

    r = b - matvec(x)
    rt = r
    b_norm2 = jnp.vdot(b, b).real
    tol2 = jnp.asarray(tol, b_norm2.dtype) ** 2 * jnp.where(b_norm2 > 0, b_norm2, 1.0)
    z = jnp.zeros_like(b)
    rho = jnp.ones((), b_norm2.dtype)

    def cond(st):
        _x, _r, _p, _q, _rho, rr, ok, k = st
        return jnp.logical_and(jnp.logical_and(rr > tol2, ok), k < maxiter)

    def body(st):
        x, r, p, q, rho_prev, _rr, _ok, k = st
        rho = jnp.vdot(rt, r).real
        beta = rho / _guard(rho_prev)
        u = r + beta * q
        p = u + beta * (q + beta * p)
        phat = m_inv(p)
        v = matvec(phat)
        denom = jnp.vdot(rt, v).real
        alpha = rho / _guard(denom)
        q = u - alpha * v
        uq = m_inv(u + q)
        ok = jnp.logical_and(jnp.abs(rho) > _EPS, jnp.abs(denom) > _EPS)
        x = jnp.where(ok, x + alpha * uq, x)
        r = jnp.where(ok, r - alpha * matvec(uq), r)
        return x, r, p, q, rho, jnp.vdot(r, r).real, ok, k + 1

    x, r, p, q, rho, rr, ok, k = jax.lax.while_loop(
        cond,
        body,
        (x, r, z, z, rho, jnp.vdot(r, r).real, jnp.bool_(True), jnp.int32(0)),
    )
    return CgResult(x=x, iterations=k, residual_norm=jnp.sqrt(rr))


def qmr_solve(
    matvec: Callable,
    rmatvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    m1_solve: Callable = None,
    m1t_solve: Callable = None,
    m2_solve: Callable = None,
    m2t_solve: Callable = None,
) -> CgResult:
    """Quasi-Minimal Residual (Freund & Nachtigal, no look-ahead):
    Lanczos biorthogonalization with a quasi-minimizing Givens update —
    BiCG's subspace with MINRES-smooth convergence. Split M1/M2
    preconditioning (Templates fig. 2.9; scipy's ``qmr(M1=, M2=)``):
    ``m1_solve``/``m2_solve`` apply the left/right approximate-inverse
    factors, ``m1t_solve``/``m2t_solve`` their transposes — all four
    default to identity (pass matching pairs or the dual Lanczos sequence
    loses biorthogonality)."""
    ident = lambda v: v  # noqa: E731
    m1s = m1_solve or ident
    m1ts = m1t_solve or ident
    m2s = m2_solve or ident
    m2ts = m2t_solve or ident
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    r = b - matvec(x)
    b_norm2 = jnp.vdot(b, b).real
    tol2 = jnp.asarray(tol, b_norm2.dtype) ** 2 * jnp.where(b_norm2 > 0, b_norm2, 1.0)
    vt = r
    y0 = m1s(vt)
    rho = jnp.sqrt(jnp.vdot(y0, y0).real)
    wt = r
    z0 = m2ts(wt)
    xi = jnp.sqrt(jnp.vdot(z0, z0).real)
    zero = jnp.zeros_like(b)
    one = jnp.ones((), b_norm2.dtype)

    # state: x, r, vt, y, wt, z, p, q, d, s, rho, xi, gamma, eta, theta,
    # eps, rr, ok, k — first-iteration cases fold away via p=q=d=s=0,
    # eps=1, gamma=1, eta=-1, theta=0 (same algebra as the branchy form).
    def cond(st):
        rr, ok, k = st[16], st[17], st[18]
        return jnp.logical_and(jnp.logical_and(rr > tol2, ok), k < maxiter)

    def body(st):
        (x, r, vt, yc, wt, zc, p, q, d, s, rho, xi, gamma, eta, theta, eps,
         _rr, _ok, k) = st
        v = vt / _guard(rho)
        y = yc / _guard(rho)
        w = wt / _guard(xi)
        z = zc / _guard(xi)
        delta = jnp.vdot(z, y).real
        p = m2s(y) - (xi * delta / _guard(eps)) * p
        q = m1ts(z) - (rho * delta / _guard(eps)) * q
        pt = matvec(p)
        eps = jnp.vdot(q, pt).real
        beta = eps / _guard(delta)
        vt = pt - beta * v
        y_new = m1s(vt)
        rho_prev = rho
        rho = jnp.sqrt(jnp.vdot(y_new, y_new).real)
        wt = rmatvec(q) - beta * w
        z_new = m2ts(wt)
        xi = jnp.sqrt(jnp.vdot(z_new, z_new).real)
        gamma_prev = gamma
        theta_prev = theta
        theta = rho / _guard(gamma_prev * jnp.abs(beta))
        gamma = 1.0 / jnp.sqrt(1.0 + theta * theta)
        eta = -eta * (rho_prev / _guard(beta)) * (gamma / _guard(gamma_prev)) ** 2
        fac = (theta_prev * gamma) ** 2
        ok = (
            (jnp.abs(rho_prev) > _EPS)
            & (jnp.abs(rho) > _EPS)
            & (jnp.abs(xi) > _EPS)
            & (jnp.abs(delta) > _EPS)
            & (jnp.abs(eps) > _EPS)
            & (jnp.abs(beta) > _EPS)
        )
        d = jnp.where(ok, eta * p + fac * d, d)
        s = jnp.where(ok, eta * pt + fac * s, s)
        x = jnp.where(ok, x + d, x)
        r = jnp.where(ok, r - s, r)
        return (x, r, vt, y_new, wt, z_new, p, q, d, s, rho, xi, gamma,
                eta, theta, eps, jnp.vdot(r, r).real, ok, k + 1)

    st0 = (x, r, vt, y0, wt, z0, zero, zero, zero, zero, rho, xi, one,
           -one, jnp.zeros((), b_norm2.dtype), one, jnp.vdot(r, r).real,
           jnp.bool_(True), jnp.int32(0))
    st = jax.lax.while_loop(cond, body, st0)
    return CgResult(x=st[0], iterations=st[18], residual_norm=jnp.sqrt(st[16]))


def tfqmr_solve(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 2000,
    m_inv: Callable = None,
) -> CgResult:
    """Transpose-Free QMR (Freund 1993): CGS's products with a
    quasi-minimized update — smooth convergence, one matvec per
    half-step. ``maxiter`` counts HALF-steps (two per CGS-equivalent
    iteration, matching scipy). The loop's stopping test uses Freund's
    residual bound ``tau * sqrt(k+1)``; the returned ``residual_norm`` is
    the TRUE final residual (one extra matvec after the loop). ``m_inv``
    left-preconditions like scipy's ``M``: the bound then tracks the
    preconditioned residual."""
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    if m_inv is None:
        m_inv = lambda v: v  # noqa: E731

    r = m_inv(b - matvec(x))
    u = r
    w = r
    rt = r
    v = m_inv(matvec(r))
    uhat = v
    b_norm2 = jnp.vdot(m_inv(b), m_inv(b)).real
    tolb = jnp.asarray(tol, b_norm2.dtype) * jnp.sqrt(
        jnp.where(b_norm2 > 0, b_norm2, 1.0)
    )
    rho = jnp.vdot(rt, r).real
    tau = jnp.sqrt(rho)
    zero = jnp.zeros((), b_norm2.dtype)

    # state: x, u, u_next, w, v, uhat, d, rho, alpha, tau, theta, eta,
    # ok, k
    def cond(st):
        tau, ok, k = st[9], st[12], st[13]
        # Freund's bound: ||r_k|| <= tau * sqrt(k+1)
        return jnp.logical_and(
            jnp.logical_and(tau * jnp.sqrt(k + 1.0) > tolb, ok), k < maxiter
        )

    def _even_tail(op):
        # advance to the second CGS direction; one matvec
        u, u_next, w, v, uhat, rho = op
        return u_next, m_inv(matvec(u_next)), v, rho

    def _odd_tail(op):
        # biorthogonality refresh ([1]-(5.7)); one matvec
        u, u_next, w, v, uhat, rho = op
        rho_new = jnp.vdot(rt, w).real
        beta = rho_new / _guard(rho)
        u_odd = w + beta * u
        uhat_new = m_inv(matvec(u_odd))
        v_new = uhat_new + beta * (uhat + beta * v)
        return u_odd, uhat_new, v_new, rho_new

    def body(st):
        (x, u, u_next, w, v, uhat, d, rho, alpha, tau, theta,
         eta, _ok, k) = st
        even = (k % 2) == 0

        # even half-step: new alpha and the odd-phase direction u_next
        vtr = jnp.vdot(rt, v).real
        alpha = jnp.where(even, rho / _guard(vtr), alpha)
        u_next = jnp.where(even, u - alpha * v, u_next)

        w = w - alpha * uhat
        d = u + (theta * theta / _guard(alpha)) * eta * d
        theta = jnp.sqrt(jnp.vdot(w, w).real) / _guard(tau)
        c2 = 1.0 / (1.0 + theta * theta)
        tau = tau * theta * jnp.sqrt(c2)
        eta = c2 * alpha
        x = x + eta * d

        ok = jnp.where(even, jnp.abs(vtr) > _EPS, jnp.abs(rho) > _EPS)
        u, uhat, v, rho = jax.lax.cond(
            even, _even_tail, _odd_tail, (u, u_next, w, v, uhat, rho)
        )
        return (x, u, u_next, w, v, uhat, d, rho, alpha, tau,
                theta, eta, ok, k + 1)

    st0 = (x, u, u, w, v, uhat, jnp.zeros_like(b), rho, zero, tau,
           zero, zero, jnp.bool_(True), jnp.int32(0))
    st = jax.lax.while_loop(cond, body, st0)
    x = st[0]
    r_true = b - matvec(x)
    return CgResult(
        x=x, iterations=st[13], residual_norm=jnp.sqrt(jnp.vdot(r_true, r_true).real)
    )

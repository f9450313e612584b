"""Restarted GMRES(m) for general systems.

Completes the Krylov family (CG for SPD, BiCGSTAB and GMRES for general
matrices). Fully jitted: the Arnoldi inner loop is a ``lax.fori_loop``
building the Krylov basis in a fixed (m+1, n) buffer with Givens rotations
applied on the fly, so residual norms are available without solving the
least-squares problem per step; restarts are an outer ``while_loop``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .cg import CgResult

__all__ = ["gmres_solve"]

_EPS = 1e-30


def gmres_solve(
    matvec: Callable,
    b,
    x0=None,
    *,
    restart: int = 30,
    tol: float = 1e-6,
    maxiter: int = 1000,
    m_inv: Callable = None,
) -> CgResult:
    """Solve ``A x = b`` for general square ``A``; ||r|| <= tol*||b||.

    ``maxiter`` counts total matvecs (inner iterations). ``m_inv`` right-
    preconditions (the Arnoldi basis spans the Krylov space of
    ``A M^{-1}``; the recurrence and stopping test see the TRUE residual,
    and only the final update pays one extra ``m_inv`` apply); pair with
    :func:`~.ilu.ilu_preconditioner`.
    """
    b = jnp.asarray(b)
    if m_inv is None:
        m_inv = lambda v: v  # noqa: E731
    n = b.shape[0]
    m = min(restart, n)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    b_norm = jnp.sqrt(jnp.vdot(b, b).real)
    tol_abs = tol * jnp.where(b_norm > 0, b_norm, 1.0)

    def cycle(x):
        """One GMRES(m) cycle; returns (x_new, res_norm, inner_steps)."""
        r = b - matvec(x)
        beta = jnp.sqrt(jnp.vdot(r, r).real)

        v0 = r / jnp.maximum(beta, _EPS)
        basis = jnp.zeros((m + 1, n), b.dtype).at[0].set(v0)
        h = jnp.zeros((m + 1, m), b.dtype)  # Hessenberg, Givens-reduced
        cs = jnp.zeros(m, b.dtype)
        sn = jnp.zeros(m, b.dtype)
        g = jnp.zeros(m + 1, b.dtype).at[0].set(beta)

        def arnoldi_step(j, state):
            basis, h, cs, sn, g, done = state

            def live(args):
                basis, h, cs, sn, g = args
                w = matvec(m_inv(basis[j]))
                # modified Gram-Schmidt against all m+1 rows (rows > j are
                # zero vectors, contributing nothing)
                hcol = jnp.dot(basis, w, precision=jax.lax.Precision.HIGHEST)  # (m+1,)
                keep = jnp.arange(m + 1) <= j
                hcol = jnp.where(keep, hcol, 0.0)
                w = w - jnp.dot(hcol, basis, precision=jax.lax.Precision.HIGHEST)
                hnext = jnp.sqrt(jnp.vdot(w, w).real)
                basis = basis.at[j + 1].set(w / jnp.maximum(hnext, _EPS))
                hcol = hcol.at[j + 1].set(hnext)

                # apply previous Givens rotations to the new column
                def rot(i, col):
                    a = cs[i] * col[i] + sn[i] * col[i + 1]
                    bb = -sn[i] * col[i] + cs[i] * col[i + 1]
                    return col.at[i].set(a).at[i + 1].set(bb)

                hcol = jax.lax.fori_loop(0, j, rot, hcol)
                denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                c = hcol[j] / jnp.maximum(denom, _EPS)
                s = hcol[j + 1] / jnp.maximum(denom, _EPS)
                hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
                cs_n = cs.at[j].set(c)
                sn_n = sn.at[j].set(s)
                g_n = g.at[j + 1].set(-s * g[j]).at[j].set(c * g[j])
                h_n = h.at[:, j].set(hcol)
                return basis, h_n, cs_n, sn_n, g_n

            converged = jnp.abs(g[j]) <= tol_abs
            basis, h, cs, sn, g = jax.lax.cond(
                jnp.logical_or(done, converged),
                lambda args: args,
                live,
                (basis, h, cs, sn, g),
            )
            return basis, h, cs, sn, g, jnp.logical_or(done, converged)

        basis, h, cs, sn, g, _done = jax.lax.fori_loop(
            0, m, arnoldi_step, (basis, h, cs, sn, g, jnp.bool_(False))
        )

        # back-substitute the m x m triangular system (rows never reduced are
        # identity-like: h[j,j] == 0 entries get y=0 via the EPS guard)
        def back(i_rev, y):
            i = m - 1 - i_rev
            s = g[i] - h[i] @ y
            yi = jnp.where(jnp.abs(h[i, i]) > _EPS, s / jnp.where(h[i, i] == 0, 1.0, h[i, i]), 0.0)
            return y.at[i].set(yi)

        y = jax.lax.fori_loop(0, m, back, jnp.zeros(m, b.dtype))
        x_new = x + m_inv(jnp.dot(y, basis[:m], precision=jax.lax.Precision.HIGHEST))
        r_new = b - matvec(x_new)
        return x_new, jnp.sqrt(jnp.vdot(r_new, r_new).real)

    def cond(state):
        _x, res, k = state
        return jnp.logical_and(res > tol_abs, k < maxiter)

    def body(state):
        x, _res, k = state
        x, res = cycle(x)
        return x, res, k + m

    r0 = b - matvec(x)
    x, res, k = jax.lax.while_loop(
        cond, body, (x, jnp.sqrt(jnp.vdot(r0, r0).real), jnp.int32(0))
    )
    return CgResult(x=x, iterations=k, residual_norm=res)

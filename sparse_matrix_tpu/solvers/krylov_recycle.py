"""Augmented / recycled Krylov solvers: LGMRES and GCROT(m,k).

Completes the scipy.sparse.linalg iterative family (reference analog: the
solver surface exercised by the fuzz/differential harness; the reference
itself ships no solvers, so these extend parity the same way the other
``solvers/`` modules do).

Both are built on one jitted *flexible* Arnoldi cycle (FGMRES): the
vector fed to the operator at step ``j`` is chosen per step, so the
"augmentation" directions of LGMRES and the recycled outer space of
GCROT drop into the same ``lax.fori_loop`` with static shapes:

* ``lgmres_solve`` — GMRES(m) augmented with the ``k`` previous outer
  correction vectors appended to the subspace (Baker/Jessup/Manteuffel).
  Early cycles with fewer stored corrections substitute plain Krylov
  continuations, so the subspace dimension is statically ``m + k``.
* ``gcrotmk_solve`` — GCROT(m,k) (Hicken & Zingg simplified variant, the
  one scipy implements): an outer space ``(U, C)`` with ``A U = C``,
  ``CᵀC = I`` is recycled across cycles; each cycle projects the residual
  onto ``C``, runs Arnoldi on ``(I - C Cᵀ) A``, and appends one new
  ``(u, c)`` pair (FIFO truncation to ``k``).

All loops are ``lax.while_loop``/``fori_loop`` with fixed buffers — no
data-dependent Python control flow, one compile per (n, m, k).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .cg import CgResult

__all__ = ["lgmres_solve", "gcrotmk_solve"]

_EPS = 1e-30


def _flex_arnoldi(matvec, pick_z, nsteps, n, dtype, v0, beta, c_outer,
                  tol_abs):
    """One flexible-Arnoldi cycle of ``nsteps`` steps.

    ``pick_z(j, basis)`` returns the vector handed to ``matvec`` at step
    ``j`` (FGMRES: the subspace the solution update lives in). Every
    ``w = A z`` is first projected against the rows of ``c_outer``
    ((k, n), zero rows are no-ops) recording ``bmat``, then MGS against
    the basis recording ``h``. Givens rotations run on the fly so
    ``|g[j]|`` is the projected residual norm and the loop freezes once
    it clears ``tol_abs``.

    Returns ``(basis, zbuf, bmat, h_raw, y, res)`` with
    ``A Z = C·bmat + V·h_raw`` and ``y`` minimizing ``|beta e1 - H y|``.
    """
    t = nsteps
    basis = jnp.zeros((t + 1, n), dtype).at[0].set(v0)
    zbuf = jnp.zeros((t, n), dtype)
    bmat = jnp.zeros((c_outer.shape[0], t), dtype)
    h_raw = jnp.zeros((t + 1, t), dtype)
    h_red = jnp.zeros((t + 1, t), dtype)  # Givens-reduced copy
    cs = jnp.zeros(t, dtype)
    sn = jnp.zeros(t, dtype)
    g = jnp.zeros(t + 1, dtype).at[0].set(beta)

    def step(j, state):
        basis, zbuf, bmat, h_raw, h_red, cs, sn, g, done = state

        def live(args):
            basis, zbuf, bmat, h_raw, h_red, cs, sn, g = args
            z = pick_z(j, basis)
            w = matvec(z)
            bcol = c_outer @ w  # (k,); invalid (zero) rows read 0
            w = w - bcol @ c_outer
            hcol = jnp.dot(basis, w, precision=jax.lax.Precision.HIGHEST)  # MGS; rows > j are zero vectors
            keep = jnp.arange(t + 1) <= j
            hcol = jnp.where(keep, hcol, 0.0)
            w = w - jnp.dot(hcol, basis, precision=jax.lax.Precision.HIGHEST)
            hnext = jnp.sqrt(jnp.vdot(w, w).real)
            basis = basis.at[j + 1].set(w / jnp.maximum(hnext, _EPS))
            hcol = hcol.at[j + 1].set(hnext)
            zbuf = zbuf.at[j].set(z)
            bmat = bmat.at[:, j].set(bcol)
            h_raw = h_raw.at[:, j].set(hcol)

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
            return basis, zbuf, bmat, h_raw, h_red.at[:, j].set(hcol), cs_n, sn_n, g_n

        converged = jnp.abs(g[j]) <= tol_abs
        out = jax.lax.cond(
            jnp.logical_or(done, converged),
            lambda args: args,
            live,
            (basis, zbuf, bmat, h_raw, h_red, cs, sn, g),
        )
        return (*out, jnp.logical_or(done, converged))

    basis, zbuf, bmat, h_raw, h_red, cs, sn, g, _done = jax.lax.fori_loop(
        0, t, step,
        (basis, zbuf, bmat, h_raw, h_red, cs, sn, g, jnp.bool_(False)),
    )

    def back(i_rev, y):
        i = t - 1 - i_rev
        s = g[i] - h_red[i] @ y
        yi = jnp.where(
            jnp.abs(h_red[i, i]) > _EPS,
            s / jnp.where(h_red[i, i] == 0, 1.0, h_red[i, i]),
            0.0,
        )
        return y.at[i].set(yi)

    y = jax.lax.fori_loop(0, t, back, jnp.zeros(t, dtype))
    return basis, zbuf, bmat, h_raw, y, jnp.abs(g[t])


def lgmres_solve(
    matvec: Callable,
    b,
    x0=None,
    *,
    inner_m: int = 30,
    outer_k: int = 3,
    tol: float = 1e-6,
    maxiter: int = 1000,
    m_inv: Callable = None,
) -> CgResult:
    """LGMRES(m, k): restarted GMRES whose subspace is augmented with the
    ``outer_k`` previous outer correction vectors — the restart no longer
    discards the slow eigendirections, which breaks the alternating-
    residual stagnation of plain GMRES(m). ``maxiter`` counts inner
    iterations (matvecs). ``m_inv`` right-preconditions (flexible:
    applied to Krylov vectors only; stored corrections already live in
    solution space, so the stopping test sees the TRUE residual).
    """
    b = jnp.asarray(b)
    if m_inv is None:
        m_inv = lambda v: v  # noqa: E731
    n = b.shape[0]
    m = min(int(inner_m), n)
    k = min(int(outer_k), max(n - m, 0))
    t = m + k
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    b_norm = jnp.sqrt(jnp.vdot(b, b).real)
    tol_abs = tol * jnp.where(b_norm > 0, b_norm, 1.0)
    aug0 = jnp.zeros((max(k, 1), n), b.dtype)
    valid0 = jnp.zeros(max(k, 1), bool)

    def cycle(x, aug, valid):
        r = b - matvec(x)
        beta = jnp.sqrt(jnp.vdot(r, r).real)
        v0 = r / jnp.maximum(beta, _EPS)

        def pick_z(j, basis):
            i = jnp.clip(j - m, 0, max(k - 1, 0))
            use_aug = jnp.logical_and(j >= m, valid[i])
            return jnp.where(use_aug, aug[i], m_inv(basis[j]))

        _basis, zbuf, _bmat, _h, y, _res = _flex_arnoldi(
            matvec, pick_z, t, n, b.dtype, v0, beta,
            jnp.zeros((0, n), b.dtype), tol_abs)
        dx = y @ zbuf
        x_new = x + dx
        r_new = b - matvec(x_new)
        dx_norm = jnp.sqrt(jnp.vdot(dx, dx).real)
        ok = dx_norm > _EPS
        if k > 0:
            aug = jnp.where(
                ok,
                jnp.roll(aug, -1, axis=0).at[k - 1].set(
                    dx / jnp.maximum(dx_norm, _EPS)),
                aug,
            )
            valid = jnp.where(ok, jnp.roll(valid, -1).at[k - 1].set(True),
                              valid)
        return x_new, jnp.sqrt(jnp.vdot(r_new, r_new).real), aug, valid

    def cond(state):
        _x, res, _aug, _valid, it = state
        return jnp.logical_and(res > tol_abs, it < maxiter)

    def body(state):
        x, _res, aug, valid, it = state
        x, res, aug, valid = cycle(x, aug, valid)
        return x, res, aug, valid, it + t

    r0 = b - matvec(x)
    x, res, _aug, _valid, it = jax.lax.while_loop(
        cond, body,
        (x, jnp.sqrt(jnp.vdot(r0, r0).real), aug0, valid0, jnp.int32(0)),
    )
    return CgResult(x=x, iterations=it, residual_norm=res)


def gcrotmk_solve(
    matvec: Callable,
    b,
    x0=None,
    *,
    m: int = 20,
    k: int = None,
    tol: float = 1e-6,
    maxiter: int = 1000,
    m_inv: Callable = None,
) -> CgResult:
    """GCROT(m, k): each cycle (1) projects the residual onto the
    recycled outer space ``C`` (``x += (C r) U``, ``r -= (C r) C``),
    (2) runs ``m`` flexible-Arnoldi steps on ``(I - C Cᵀ) A`` so
    ``A Z = C B + V H``, (3) updates ``x += Z y − (B y) U`` with ``y``
    the GMRES minimizer, and (4) recycles ``u = (Zy − U By)/γ``,
    ``c = (H y) V / γ``, ``γ = |H y|`` — by construction ``A u = c``,
    ``|c| = 1``, ``c ⊥ C`` — truncating FIFO (scipy's ``'oldest'``)
    beyond ``k``. ``maxiter`` counts inner iterations (matvecs);
    ``m_inv`` right-preconditions (flexible).
    """
    b = jnp.asarray(b)
    if m_inv is None:
        m_inv = lambda v: v  # noqa: E731
    n = b.shape[0]
    if k is None:
        k = m
    m = min(int(m), n)
    k = max(int(k), 1)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    b_norm = jnp.sqrt(jnp.vdot(b, b).real)
    tol_abs = tol * jnp.where(b_norm > 0, b_norm, 1.0)

    def cycle(x, u_buf, c_buf):
        r = b - matvec(x)
        q0 = c_buf @ r  # (k,); zero (unfilled) rows contribute nothing
        x = x + q0 @ u_buf
        r = r - q0 @ c_buf
        beta = jnp.sqrt(jnp.vdot(r, r).real)
        v0 = r / jnp.maximum(beta, _EPS)

        def pick_z(j, basis):
            return m_inv(basis[j])

        basis, zbuf, bmat, h_raw, y, _res = _flex_arnoldi(
            matvec, pick_z, m, n, b.dtype, v0, beta, c_buf, tol_abs)
        dx = y @ zbuf - (bmat @ y) @ u_buf
        x_new = x + dx
        r_new = b - matvec(x_new)
        hy = h_raw @ y  # (m+1,)
        gamma = jnp.sqrt(jnp.vdot(hy, hy).real)
        ok = gamma > _EPS
        u_new = dx / jnp.maximum(gamma, _EPS)
        c_new = jnp.dot(hy, basis, precision=jax.lax.Precision.HIGHEST) / jnp.maximum(gamma, _EPS)
        u_buf = jnp.where(ok, jnp.roll(u_buf, -1, axis=0).at[k - 1].set(u_new),
                          u_buf)
        c_buf = jnp.where(ok, jnp.roll(c_buf, -1, axis=0).at[k - 1].set(c_new),
                          c_buf)
        return x_new, jnp.sqrt(jnp.vdot(r_new, r_new).real), u_buf, c_buf

    def cond(state):
        _x, res, _u, _c, it = state
        return jnp.logical_and(res > tol_abs, it < maxiter)

    def body(state):
        x, _res, u_buf, c_buf, it = state
        x, res, u_buf, c_buf = cycle(x, u_buf, c_buf)
        return x, res, u_buf, c_buf, it + m

    r0 = b - matvec(x)
    x, res, _u, _c, it = jax.lax.while_loop(
        cond, body,
        (x, jnp.sqrt(jnp.vdot(r0, r0).real),
         jnp.zeros((k, n), b.dtype), jnp.zeros((k, n), b.dtype),
         jnp.int32(0)),
    )
    return CgResult(x=x, iterations=it, residual_norm=res)

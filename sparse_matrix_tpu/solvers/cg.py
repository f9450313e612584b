"""Conjugate-gradient solver driven by a pluggable SpMV.

North-star scope (not in the Rust reference): exercises the sparse kernels
end-to-end. Pure ``lax.while_loop`` — one compiled loop, no host
round-trips per iteration; works with any matvec closure (a planned
SpmvOperator, XLA ELL, or the mesh-sharded distributed SpMV).

Call solvers UNDER ``jax.jit`` (``jax.jit(lambda b: cg_solve(op, b, ...))``)
when solving repeatedly: an eager call re-traces and re-lowers the whole
while-loop every time.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "CgResult",
    "cg_solve",
    "cg_solve_ir",
    "cg_solve_multi",
    "pcg_solve",
    "pcg_solve_multi",
    "jacobi_preconditioner",
]


class CgResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray  # int32
    residual_norm: jnp.ndarray  # float


def cg_solve(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
) -> CgResult:
    """Solve ``A x = b`` for symmetric positive-definite ``A``.

    Convergence: ||r||_2 <= tol * ||b||_2.
    """
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    r = b - matvec(x)
    p = r
    rs = jnp.vdot(r, r).real
    b_norm2 = jnp.vdot(b, b).real
    tol2 = jnp.asarray(tol, rs.dtype) ** 2 * jnp.where(b_norm2 > 0, b_norm2, 1.0)

    def cond(state):
        _x, _p, _r, rs, k = state
        return jnp.logical_and(rs > tol2, k < maxiter)

    def body(state):
        x, p, r, rs, k = state
        ap = matvec(p)
        alpha = rs / jnp.vdot(p, ap).real
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r).real
        p = r + (rs_new / rs) * p
        return x, p, r, rs_new, k + 1

    x, p, r, rs, k = jax.lax.while_loop(cond, body, (x, p, r, rs, jnp.int32(0)))
    return CgResult(x=x, iterations=k, residual_norm=jnp.sqrt(rs))


def cg_solve_ir(
    matvec_hi: Callable,
    matvec_lo: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    inner_tol: float = 1e-2,
    inner_maxiter: int = 200,
) -> CgResult:
    """Mixed-precision CG by iterative refinement.

    Outer loop at working precision: true residual ``r = b - A_hi x``
    (``matvec_hi``, e.g. the f32 operator). Inner loop: CG on the
    low-precision operator (``matvec_lo``, e.g. the same operator with
    bf16 value planes — ``SpmvOperator(a, values_dtype=jnp.bfloat16)``)
    solving ``A_lo d = r`` to ``inner_tol`` relative; then ``x += d``.

    Classic IR analysis: each outer step contracts the working-precision
    residual by ``~inner_tol + u_lo * cond(A)``, so refinement reaches
    working accuracy iff ``cond(A) << 1/u_lo`` (bf16: cond below ~1e2 for
    a guaranteed contraction; in practice structured elementwise rounding
    behaves far better, and stencils whose coefficients are exactly
    representable in bf16 — constant {-1, 4} Poisson — incur NO value
    rounding at all). The hot loop runs every SpMV on the half-width
    value stream; the f32 operator is touched once per outer step.

    One compiled nested ``while_loop``; ``iterations`` counts INNER
    matvecs (the dominant cost), ``maxiter`` bounds that same count.
    """
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    b_norm2 = jnp.vdot(b, b).real
    tol2 = jnp.asarray(tol, b_norm2.dtype) ** 2 * jnp.where(
        b_norm2 > 0, b_norm2, 1.0
    )

    def inner(r, budget):
        """CG on A_lo for d: A_lo d = r, to inner_tol relative (or budget)."""
        d = jnp.zeros_like(r)
        q = r
        p = r
        rs = jnp.vdot(r, r).real
        itol2 = jnp.asarray(inner_tol, rs.dtype) ** 2 * jnp.where(
            rs > 0, rs, 1.0
        )

        def cond(st):
            _d, _p, _q, rs, k = st
            return jnp.logical_and(
                rs > itol2, jnp.logical_and(k < inner_maxiter, k < budget)
            )

        def body(st):
            d, p, q, rs, k = st
            ap = matvec_lo(p)
            pap = jnp.vdot(p, ap).real
            alpha = rs / jnp.where(pap == 0, 1.0, pap)
            d = d + alpha * p
            q = q - alpha * ap
            rs_new = jnp.vdot(q, q).real
            p = q + (rs_new / jnp.where(rs == 0, 1.0, rs)) * p
            return d, p, q, rs_new, k + 1

        d, _p, _q, _rs, k = jax.lax.while_loop(
            cond, body, (d, p, q, rs, jnp.int32(0))
        )
        return d, k

    def outer_cond(state):
        _x, rr, k = state
        return jnp.logical_and(rr > tol2, k < maxiter)

    def outer_body(state):
        x, _rr, k = state
        r = b - matvec_hi(x)
        d, ki = inner(r, maxiter - k)
        x = x + d
        r2 = b - matvec_hi(x)
        return x, jnp.vdot(r2, r2).real, k + ki

    r0 = b - matvec_hi(x)
    x, rr, k = jax.lax.while_loop(
        outer_cond, outer_body, (x, jnp.vdot(r0, r0).real, jnp.int32(0))
    )
    return CgResult(x=x, iterations=k, residual_norm=jnp.sqrt(rr))


def cg_solve_multi(
    matvec_multi: Callable,
    b,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    rhs_axis: int = -1,
) -> CgResult:
    """CG over K right-hand sides at once: ``b`` carries K systems on
    ``rhs_axis`` and ``matvec_multi`` maps that layout to itself. The
    default is the classic (n, K) column layout
    (e.g. :func:`~sparse_matrix_tpu.ops.spmm.spmm_dia`); the aligned-SpMM
    *packed* layout (c128+1, K, 128) runs with ``rhs_axis=1``
    (:func:`~sparse_matrix_tpu.ops.spmm.aligned_matvec_multi`) so no
    per-iteration relayout happens. Each system runs its own CG recurrence
    (per-column alpha/beta); columns iterate in lockstep until all
    converge — the multi-RHS form that makes SpMM's operand reuse pay.

    .. note:: **Measured caveat (first target, not re-measured on the
       GPU):** plain block CG at K=8 on the 512^2 Poisson DIA operator ran at
       **0.51x** of eight sequential :func:`cg_solve` calls — the
       lockstep recurrence iterates every column to the slowest one's
       count, and on a bandwidth-matched banded operator the SpMM reuse
       does not cover that. Prefer :func:`pcg_solve_multi` under a block
       AMG preconditioner (:func:`~sparse_matrix_tpu.solvers.amg.amg_pcg_solve`
       with a 2-D ``b`` measured **2.56x** at K=8 — the V-cycle equalizes
       iteration counts so lockstep stops losing), or sequential
       :func:`cg_solve` when no
       preconditioner is available. This entry point remains for operators
       whose matvec is strongly reuse-bound (e.g. gather-heavy general
       formats where :func:`~.spmm.lanepack_matvec_multi` amortizes the
       plan stream over K)."""
    b = jnp.asarray(b)
    ax = rhs_axis % b.ndim
    red = tuple(i for i in range(b.ndim) if i != ax)
    bshape = [1] * b.ndim
    bshape[ax] = b.shape[ax]

    def colsum(u, v):
        return jnp.sum(u * v, axis=red)  # (K,)

    def bc(s):  # broadcast a (K,) scalar row over the vector layout
        return s.reshape(bshape)

    x = jnp.zeros_like(b)
    r = b - matvec_multi(x)
    p = r
    rs = colsum(r, r)  # (K,)
    b_norm2 = colsum(b, b)
    tol2 = jnp.asarray(tol, rs.dtype) ** 2 * jnp.where(b_norm2 > 0, b_norm2, 1.0)

    def cond(state):
        _x, _p, _r, rs, k = state
        return jnp.logical_and(jnp.any(rs > tol2), k < maxiter)

    def body(state):
        x, p, r, rs, k = state
        live = rs > tol2  # (K,) columns still iterating
        ap = matvec_multi(p)
        pap = colsum(p, ap)
        alpha = jnp.where(live, rs / jnp.where(pap == 0, 1.0, pap), 0.0)
        x = x + bc(alpha) * p
        r = r - bc(alpha) * ap
        rs_new = colsum(r, r)
        beta = jnp.where(live, rs_new / jnp.where(rs == 0, 1.0, rs), 0.0)
        p = jnp.where(bc(live), r + bc(beta) * p, p)
        rs = jnp.where(live, rs_new, rs)
        return x, p, r, rs, k + 1

    x, p, r, rs, k = jax.lax.while_loop(cond, body, (x, p, r, rs, jnp.int32(0)))
    return CgResult(x=x, iterations=k, residual_norm=jnp.sqrt(rs))


def pcg_solve_multi(
    matvec_multi: Callable,
    b,
    precond: Callable,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    rhs_axis: int = -1,
) -> CgResult:
    """Preconditioned CG over K right-hand sides in lockstep.

    Layout-generic like :func:`cg_solve_multi`: ``b`` carries K systems on
    ``rhs_axis`` and both ``matvec_multi`` and ``precond`` map that layout
    to itself. With the default (n, K) column layout this composes with
    block-broadcasting preconditioners (:func:`jacobi_preconditioner`, the
    AMG ``hierarchy.preconditioner()`` — both broadcast over trailing RHS
    axes). Each column runs its own PCG recurrence (per-column alpha/beta
    on the M-inner product r.z); converged columns freeze while the rest
    iterate, so one V-cycle/SpMM per iteration serves all live systems."""
    b = jnp.asarray(b)
    ax = rhs_axis % b.ndim
    red = tuple(i for i in range(b.ndim) if i != ax)
    bshape = [1] * b.ndim
    bshape[ax] = b.shape[ax]

    def colsum(u, v):
        return jnp.sum(u * v, axis=red)  # (K,)

    def bc(s):
        return s.reshape(bshape)

    x = jnp.zeros_like(b)
    r = b - matvec_multi(x)
    z = precond(r)
    p = z
    rz = colsum(r, z)  # (K,) M-inner products
    rr = colsum(r, r)  # (K,) true residuals (convergence test)
    b_norm2 = colsum(b, b)
    tol2 = jnp.asarray(tol, rr.dtype) ** 2 * jnp.where(b_norm2 > 0, b_norm2, 1.0)

    def cond(state):
        _x, _p, _r, _rz, rr, k = state
        return jnp.logical_and(jnp.any(rr > tol2), k < maxiter)

    def body(state):
        x, p, r, rz, rr, k = state
        live = rr > tol2  # (K,) columns still iterating
        ap = matvec_multi(p)
        pap = colsum(p, ap)
        alpha = jnp.where(live, rz / jnp.where(pap == 0, 1.0, pap), 0.0)
        x = x + bc(alpha) * p
        r = r - bc(alpha) * ap
        z = precond(r)
        rz_new = colsum(r, z)
        beta = jnp.where(live, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        p = jnp.where(bc(live), z + bc(beta) * p, p)
        rz = jnp.where(live, rz_new, rz)
        rr = jnp.where(live, colsum(r, r), rr)
        return x, p, r, rz, rr, k + 1

    x, p, r, rz, rr, k = jax.lax.while_loop(
        cond, body, (x, p, r, rz, rr, jnp.int32(0))
    )
    return CgResult(x=x, iterations=k, residual_norm=jnp.sqrt(rr))


def jacobi_preconditioner(m) -> Callable:
    """M^-1 = diag(A)^-1 as a vector multiply (host CsrMatrix input).

    Broadcasts over multi-RHS blocks: a (n,) residual gets ``inv * r``, a
    (n, K) block gets ``inv[:, None] * r`` (the LOBPCG/block-CG case)."""
    import numpy as np

    rids = m.row_ids()
    on_diag = m.indices.astype(np.int64) == rids
    d = np.ones(m.rows, dtype=np.float64)
    d[rids[on_diag]] = m.vals[on_diag].astype(np.float64)
    d[d == 0.0] = 1.0
    inv = jnp.asarray((1.0 / d).astype(np.float32))

    def apply(r):
        r = jnp.asarray(r)
        return inv.reshape((-1,) + (1,) * (r.ndim - 1)) * r

    return apply


def pcg_solve(
    matvec: Callable,
    b,
    precond: Callable,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
) -> CgResult:
    """Preconditioned CG: ``precond`` applies M^-1 (e.g.
    :func:`jacobi_preconditioner`)."""
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = jnp.vdot(r, z).real
    rr = jnp.vdot(r, r).real
    b_norm2 = jnp.vdot(b, b).real
    tol2 = jnp.asarray(tol, rr.dtype) ** 2 * jnp.where(b_norm2 > 0, b_norm2, 1.0)

    def cond(state):
        _x, _p, _r, _rz, rr, k = state
        return jnp.logical_and(rr > tol2, k < maxiter)

    def body(state):
        x, p, r, rz, _rr, k = state
        ap = matvec(p)
        alpha = rz / jnp.vdot(p, ap).real
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = jnp.vdot(r, z).real
        p = z + (rz_new / rz) * p
        return x, p, r, rz_new, jnp.vdot(r, r).real, k + 1

    x, p, r, rz, rr, k = jax.lax.while_loop(
        cond, body, (x, p, r, rz, rr, jnp.int32(0))
    )
    return CgResult(x=x, iterations=k, residual_norm=jnp.sqrt(rr))

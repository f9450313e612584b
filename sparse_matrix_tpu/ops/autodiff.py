"""Autodiff through the sparse kernels: VJP-complete matvecs and
implicitly-differentiated solves.

Why this module exists: differentiating the slab formats' gathers and
scatter-adds directly yields a scatter-heavy backward program, yet the VJP
of any linear map is just the transpose map, which this library can plan
as its own operator. So:

* :func:`linear_matvec` wraps a (matvec, rmatvec) pair in ``jax.custom_vjp``
  — gradient w.r.t. ``x`` flows through EVERY format, and the backward
  pass is itself a planned SpMV (A^T's own format plan, as
  fast as the forward);
* :func:`differentiable_operator` builds that pair from a host CSR matrix;
* :func:`cg_solve_implicit` / :func:`implicit_solve` differentiate THROUGH a
  CG solve by the implicit function theorem (``lax.custom_linear_solve``):
  the backward pass is ONE more CG solve with the same operator, not
  backprop through every iteration (which would store every Krylov
  iterate — 1000+ vectors of rematerialization for a Poisson solve).

Gradients w.r.t. the matrix VALUES: the pure-XLA format paths (DIA, ELL)
differentiate natively — pass the operator as a pytree and grad through
``op.apply(params, x)`` w.r.t. ``params`` (tested in
tests/test_autodiff.py). The slab formats bake values into plan arrays;
plan the operator as DIA/ELL (``force=``) when value gradients are needed.

The reference has no AD story (a Rust CPU library); this is device-side
scope on top of its kernel surface (``spam_csr/src/mul_hash.rs`` ends at
SpGEMM).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import numpy as np
from jax import lax

__all__ = [
    "linear_matvec",
    "differentiable_operator",
    "cg_solve_implicit",
    "implicit_solve",
]


def linear_matvec(matvec: Callable, rmatvec: Callable) -> Callable:
    """``f(x) = A x`` with a custom VJP ``ct -> A^T ct``.

    Both callables must be LINEAR (no bias) — the VJP of a linear map is
    exactly its transpose, which this wrapper plans as its own operator. For complex operators pass the conjugate
    transpose as ``rmatvec`` (JAX's vjp convention).
    """

    @jax.custom_vjp
    def f(x):
        return matvec(x)

    def fwd(x):
        return matvec(x), None

    def bwd(_res, ct):
        return (rmatvec(ct),)

    f.defvjp(fwd, bwd)
    return f


def differentiable_operator(
    a,
    *,
    dtype=np.float32,
    force: Optional[str] = None,
    force_t: Optional[str] = None,
):
    """Plan ``A`` and ``A^T`` and return ``(f, op, op_t)`` where ``f`` is a
    :func:`linear_matvec`-wrapped, grad-able matvec.

    ``A^T`` gets its OWN format plan (``force_t``): the transpose of a
    banded matrix is banded, but e.g. a row-skewed matrix transposes to a
    column-skewed one that may plan differently."""
    from .operator import SpmvOperator

    op = SpmvOperator(a, dtype=dtype, force=force)
    op_t = SpmvOperator(a.transpose(), dtype=dtype,
                        force=force if force_t is None else force_t)
    return linear_matvec(op, op_t), op, op_t


def cg_solve_implicit(
    matvec: Callable,
    b,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
) -> jax.Array:
    """``x = A^{-1} b`` for SPD ``A``, differentiable w.r.t. ``b``.

    Forward runs :func:`~sparse_matrix_tpu.solvers.cg.cg_solve`; the
    implicit function theorem (``lax.custom_linear_solve``,
    ``symmetric=True``) makes each tangent/cotangent pass ONE more CG
    solve with the SAME operator — A symmetric means the backward solve
    needs no transposed operator at all, so this works for every format. Returns only ``x`` (the solve is exact to ``tol``
    as far as AD is concerned; iteration counts are not differentiable).
    """
    from ..solvers.cg import cg_solve

    def solve(mv, rhs):
        return cg_solve(mv, rhs, tol=tol, maxiter=maxiter).x

    return lax.custom_linear_solve(matvec, b, solve=solve, symmetric=True)


def implicit_solve(
    a,
    b,
    *,
    dtype=np.float32,
    tol: float = 1e-6,
    maxiter: int = 1000,
    force: Optional[str] = None,
) -> jax.Array:
    """One-call differentiable SPD solve from a host CSR matrix: plans the
    operator, then :func:`cg_solve_implicit`. Composable with jit/grad::

        loss = lambda b: implicit_solve(a_spd, b).sum()
        g = jax.grad(loss)(b)     # = A^{-1} ones, by one extra CG solve
    """
    from .operator import SpmvOperator

    op = SpmvOperator(a, dtype=dtype, force=force)
    import jax.numpy as jnp

    return cg_solve_implicit(op, jnp.asarray(b, dtype), tol=tol,
                             maxiter=maxiter)

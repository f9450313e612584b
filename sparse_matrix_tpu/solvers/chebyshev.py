"""Chebyshev semi-iteration: a dot-free linear solver for SPD operators.

New scope beyond the reference. The point on device meshes: unlike CG, the
Chebyshev recurrence needs NO inner products — on a distributed operator
(:mod:`..parallel`) every iteration is purely local work plus the
operand all-gather, with zero cross-device reductions on the critical path
(CG pays two psums per iteration). The price is needing spectral bounds,
which the library's own Lanczos estimate provides.

The iteration is the standard three-term recurrence for
``p_k(A) r_0`` with ``p_k`` the scaled-and-shifted Chebyshev polynomial
minimizing the worst-case error over ``[lam_min, lam_max]``; convergence
factor ``(sqrt(kappa)-1)/(sqrt(kappa)+1)`` per step, the same asymptotic
rate as CG.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .cg import CgResult

__all__ = ["chebyshev_solve"]


def chebyshev_solve(
    matvec: Callable,
    b,
    x0=None,
    *,
    lam_bounds: Optional[Tuple[float, float]] = None,
    n: Optional[int] = None,
    tol: float = 1e-6,
    maxiter: int = 1000,
    check_every: int = 10,
    lanczos_steps: int = 40,
    seed: int = 0,
) -> CgResult:
    """Solve SPD ``A x = b`` by Chebyshev iteration.

    ``lam_bounds = (lam_min, lam_max)`` must bracket the spectrum; when
    omitted they come from :func:`~.eigen.eigsh_extremal` (pass ``n``),
    widened 5% for safety. The residual norm is refreshed every
    ``check_every`` steps (it is NOT needed by the recurrence — computing
    it each step would reintroduce the reduction Chebyshev exists to
    avoid), so up to ``check_every - 1`` extra iterations may run after
    convergence.
    """
    b = jnp.asarray(b)
    if lam_bounds is None:
        if n is None:
            raise ValueError("pass lam_bounds or n (for the Lanczos estimate)")
        from .eigen import eigsh_extremal

        lo, hi = eigsh_extremal(matvec, n, m=lanczos_steps, seed=seed)
        # Ritz values lie INSIDE the spectrum: the lam_min estimate is an
        # overestimate (fatal for Chebyshev — modes below lam_min diverge)
        # and lam_max an underestimate, so widen multiplicatively down/up.
        # Additive padding by a fraction of the range would wipe out a
        # small lam_min entirely (measured: kappa -> 1e12, no convergence).
        lam_bounds = (0.5 * lo, 1.05 * hi)
    lam_min, lam_max = float(lam_bounds[0]), float(lam_bounds[1])
    if lam_min <= 0:
        raise ValueError(f"chebyshev_solve needs lam_min > 0, got {lam_min}")
    theta = (lam_max + lam_min) / 2.0
    # degenerate interval (scalar spectrum): keep delta tiny-positive so
    # the recurrence reduces to Richardson with the optimal step 1/theta
    delta = max((lam_max - lam_min) / 2.0, 1e-12 * theta)
    sigma1 = theta / delta

    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    r = b - matvec(x)
    b_norm2 = jnp.vdot(b, b).real
    tol2 = jnp.asarray(tol, b_norm2.dtype) ** 2 * jnp.where(b_norm2 > 0, b_norm2, 1.0)

    # first step: x1 = x0 + d0,  d0 = r / theta
    d = r / theta
    rho_prev = jnp.asarray(1.0 / sigma1, b.dtype)

    def cond(state):
        _x, _d, _r, rr, _rho, k = state
        return jnp.logical_and(rr > tol2, k < maxiter)

    def body(state):
        x, d, r, rr, rho, k = state
        x = x + d
        r = r - matvec(d)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        # refresh the monitored residual only every check_every steps
        rr = jax.lax.cond(
            (k + 1) % check_every == 0,
            lambda _: jnp.vdot(r, r).real,
            lambda rr_old: rr_old,
            rr,
        )
        return x, d, r, rr, rho_new, k + 1

    x, d, r, rr, _rho, k = jax.lax.while_loop(
        cond, body, (x, d, r, jnp.vdot(r, r).real, rho_prev, jnp.int32(0))
    )
    return CgResult(x=x, iterations=k, residual_norm=jnp.sqrt(jnp.vdot(r, r).real))

"""LOBPCG: locally-optimal block preconditioned conjugate gradient
eigensolver (Knyazev 2001) for extremal eigenpairs of symmetric operators.

North-star scope (not in the Rust reference): the block companion to the
single-vector Lanczos in :mod:`.eigen` — finds the k smallest (or largest)
eigenpairs using only a multi-RHS matvec, which is exactly what the SpMM
kernels provide (``SpmvOperator.matmat``: DIA shifted-slice SpMM or the
aligned packed form). All dense
subspace work is (3k x 3k) on-device (``jnp.linalg.qr`` / ``eigh``), the
iteration is one ``lax.while_loop`` — same jit discipline as :mod:`.cg`;
wrap the call in ``jax.jit`` when solving repeatedly.

Simplifications vs full Knyazev: hard-locking and deflation constraints are
omitted (k stays small and fixed); the basis is re-orthonormalized by QR
every iteration, which is the numerically robust variant of the SᵀS
Cholesky approach.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["LobpcgResult", "lobpcg"]


class LobpcgResult(NamedTuple):
    eigenvalues: jnp.ndarray  # (k,)
    eigenvectors: jnp.ndarray  # (n, k), orthonormal
    iterations: jnp.ndarray  # int32
    residual_norms: jnp.ndarray  # (k,) ||A x - lambda x||_2


def _orthonormalize(s):
    q, _r = jnp.linalg.qr(s)
    return q


def lobpcg(
    matmat: Callable,
    x0,
    *,
    largest: bool = False,
    precond: Optional[Callable] = None,
    tol: float = 1e-5,
    maxiter: int = 500,
) -> LobpcgResult:
    """Find the ``k = x0.shape[1]`` smallest (default) or largest eigenpairs
    of the symmetric operator behind ``matmat`` ((n, m) -> (n, m)).

    ``precond`` applies an approximate inverse to the residual block (e.g.
    :func:`~.cg.jacobi_preconditioner`, which broadcasts over columns).
    Convergence: per-vector ``||A x - lambda x|| <= tol * max(1, |lambda|)``.
    """
    x = jnp.asarray(x0)
    if x.ndim != 2:
        raise ValueError("x0 must be (n, k)")
    n, k = x.shape
    if 3 * k > n:
        raise ValueError("3*k must not exceed n for the (X,W,P) basis")
    sign = -1.0 if largest else 1.0  # work with ascending eigh order

    def rayleigh_ritz(s):
        # s: (n, 3k) orthonormal basis -> Ritz pairs of A restricted to s
        a_s = matmat(s)
        h = s.T @ a_s
        h = 0.5 * (h + h.T)
        theta, v = jnp.linalg.eigh(sign * h)
        theta = sign * theta  # ascending in the wanted direction
        return theta, v, a_s

    def residuals(x, ax, theta):
        r = ax - x * theta[None, :]
        return r, jnp.linalg.norm(r, axis=0)

    # init: orthonormal X, random-orthogonal P (a valid extra subspace that
    # avoids a rank-deficient first basis)
    x = _orthonormalize(x)
    key = jax.random.PRNGKey(0)
    p = jax.random.normal(key, (n, k), x.dtype)
    ax = matmat(x)
    h = x.T @ ax
    theta0, v0 = jnp.linalg.eigh(sign * 0.5 * (h + h.T))
    theta0 = sign * theta0
    x = x @ v0
    ax = ax @ v0
    r, rn = residuals(x, ax, theta0)

    def cond(st):
        _x, _p, theta, rn, it = st
        tol_k = tol * jnp.maximum(1.0, jnp.abs(theta))
        return jnp.logical_and(jnp.any(rn > tol_k), it < maxiter)

    def body(st):
        x, p, _theta, _rn, it = st
        ax = matmat(x)
        h = x.T @ ax
        theta = jnp.diag(0.5 * (h + h.T))
        w = ax - x * theta[None, :]
        if precond is not None:
            w = precond(w)
        s = jnp.concatenate([x, w, p], axis=1)  # (n, 3k)
        s = _orthonormalize(s)
        theta_s, v, a_s = rayleigh_ritz(s)
        vx = v[:, :k]
        x_new = s @ vx
        ax_new = a_s @ vx
        # P = the non-X part of the new block (classic LOBPCG three-term)
        vp = vx.at[:k, :].set(0.0)
        p_new = s @ vp
        r, rn = residuals(x_new, ax_new, theta_s[:k])
        return x_new, p_new, theta_s[:k], rn, it + 1

    x, p, theta, rn, it = jax.lax.while_loop(
        cond, body, (x, p, theta0, rn, jnp.int32(0))
    )
    return LobpcgResult(
        eigenvalues=theta, eigenvectors=x, iterations=it, residual_norms=rn
    )

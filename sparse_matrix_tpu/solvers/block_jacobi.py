"""Block-Jacobi and Chebyshev-polynomial preconditioners.

New scope beyond the reference; both are device-natural members of the
preconditioner spectrum:

* **Block-Jacobi** (:func:`block_jacobi_preconditioner`): rows partition
  into fixed 128-blocks; each diagonal block is extracted on host,
  inverted ONCE as a batched ``(nb, 128, 128)`` pinv, and the apply is a
  single batched matmul — between diagonal Jacobi and IC(0) in
  strength, with a purely local apply (distributed-friendly: no
  cross-block coupling).
* **Chebyshev polynomial** (:func:`chebyshev_preconditioner`): ``M^{-1} =
  p_d(A)`` with ``p_d`` the degree-``d`` Chebyshev approximation of
  ``1/x`` on ``[lam_min, lam_max]`` — symmetric positive definite by
  construction for a positive interval, needs only matvecs (dot-free like
  :func:`~.chebyshev.chebyshev_solve`: on a mesh it adds zero cross-chip
  reductions), and composes with any operator including distributed ones.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax.numpy as jnp
import numpy as np

__all__ = ["block_jacobi_preconditioner", "chebyshev_preconditioner"]

_BS = 128  # diagonal block size


def block_jacobi_preconditioner(m, *, bs: int = _BS, dtype=np.float32) -> Callable:
    """``M^{-1} = blockdiag(A)^{-1}`` with ``bs``-sized row blocks.

    Host CsrMatrix input; diagonal blocks are pinv-ed once (singular
    blocks — empty rows — degrade gracefully to least-squares inverses).
    Applies to ``(n,)`` vectors and ``(n, K)`` blocks.
    """
    n = m.rows
    nb = -(-n // bs)
    rids = m.row_ids()
    cids = m.indices.astype(np.int64)
    in_block = (rids // bs) == (cids // bs)
    blocks = np.zeros((nb, bs, bs), dtype=np.float64)
    rb = rids[in_block]
    blocks[rb // bs, rb % bs, cids[in_block] % bs] = m.vals[in_block].astype(
        np.float64
    )
    # pad rows (and genuinely empty rows) get an identity diagonal so the
    # block inverse is well-posed and acts as plain Jacobi there
    for b in range(nb):
        dz = np.flatnonzero(np.diag(blocks[b]) == 0.0)
        blocks[b, dz, dz] = 1.0
    inv = jnp.asarray(np.linalg.pinv(blocks).astype(dtype))  # (nb, bs, bs)
    pad = nb * bs - n

    def apply(r):
        r = jnp.asarray(r)
        vec = r.ndim == 1
        r2 = r[:, None] if vec else r
        k = r2.shape[1]
        rp = jnp.concatenate(
            [r2, jnp.zeros((pad, k), r2.dtype)], axis=0
        ) if pad else r2
        r3 = rp.reshape(nb, bs, k)
        y3 = jnp.einsum("bij,bjk->bik", inv, r3)
        y = y3.reshape(nb * bs, k)[:n]
        return y[:, 0] if vec else y

    return apply


def chebyshev_preconditioner(
    matvec: Callable,
    *,
    lam_bounds: Optional[Tuple[float, float]] = None,
    n: Optional[int] = None,
    degree: int = 8,
    lanczos_steps: int = 40,
    seed: int = 0,
) -> Callable:
    """``M^{-1} = p_degree(A) ~= A^{-1}`` by the Chebyshev minimax
    approximation of ``1/x`` on the spectral interval.

    SPD by construction for ``lam_min > 0``, so PCG-safe; the apply is
    ``degree`` matvecs and nothing else (no dots). Bounds default to the
    library's Lanczos estimates, widened multiplicatively (see
    :func:`~.chebyshev.chebyshev_solve` for why additive padding is
    wrong). Works on vectors and (n, K) blocks when ``matvec`` does.
    """
    if lam_bounds is None:
        if n is None:
            raise ValueError("pass lam_bounds or n (for the Lanczos estimate)")
        from .eigen import eigsh_extremal

        lo, hi = eigsh_extremal(matvec, n, m=lanczos_steps, seed=seed)
        lam_bounds = (0.5 * lo, 1.05 * hi)
    lam_min, lam_max = float(lam_bounds[0]), float(lam_bounds[1])
    if lam_min <= 0:
        raise ValueError(f"chebyshev_preconditioner needs lam_min > 0, got {lam_min}")
    theta = (lam_max + lam_min) / 2.0
    delta = max((lam_max - lam_min) / 2.0, 1e-12 * theta)
    sigma1 = theta / delta

    mm = getattr(matvec, "matmat", None)

    def mv(v):
        if v.ndim == 2 and mm is not None:
            return mm(v)  # SpmvOperator block apply -> true SpMM path
        return matvec(v)

    def apply(r):
        r = jnp.asarray(r)
        # the preconditioner apply IS a fixed-iteration chebyshev_solve on
        # M x = r from x0 = 0: same three-term recurrence, degree steps
        x = jnp.zeros_like(r)
        res = r
        d = res / theta
        rho = 1.0 / sigma1
        for _ in range(degree):
            x = x + d
            res = res - mv(d)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * res
            rho = rho_new
        return x

    return apply

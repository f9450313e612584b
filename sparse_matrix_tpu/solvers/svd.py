"""Sparse truncated SVD (top-k singular triplets) via Golub-Kahan-Lanczos.

New scope beyond the reference (no solver layer there); completes the
spectral family (power/Lanczos/LOBPCG are symmetric-only, LSQR solves
rectangular systems — this factorizes them).

Device-first design: the bidiagonalization runs as one jitted
``lax.fori_loop`` holding the U (steps, m) and V (steps, n) bases in fixed
buffers; full reorthogonalization is two dense (steps, n) matmuls per step
(dense matmul work at full f32 precision, the same masked-basis trick as the GMRES Arnoldi loop — rows
beyond the current step are zero and contribute nothing). Only the tiny
(steps x steps) bidiagonal SVD runs on the host. ``matvec``/``rmatvec``
are pluggable, so planned :class:`~sparse_matrix_tpu.ops.operator.
SpmvOperator` applies (DIA/aligned/LanePack/ELL) carry the hot path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SvdResult", "svds", "svds_csr"]

_EPS = 1e-30


class SvdResult(NamedTuple):
    u: object  # (m, k) left singular vectors
    s: object  # (k,) singular values, descending
    v: object  # (n, k) right singular vectors


def _gkl(matvec, rmatvec, m: int, n: int, steps: int, seed: int):
    """Jitted GKL bidiagonalization with full reorthogonalization.

    Returns (U (steps, m), V (steps, n), alphas (steps,), betas (steps,)):
    ``A v_j = alpha_j u_j + beta_{j-1} u_{j-1}`` (betas[j] couples step j
    to j+1; betas[steps-1] is the final residual norm).
    """
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jnp.float32)
    v0 = v0 / jnp.maximum(jnp.linalg.norm(v0), _EPS)

    ubuf = jnp.zeros((steps, m), jnp.float32)
    vbuf = jnp.zeros((steps, n), jnp.float32).at[0].set(v0)
    alphas = jnp.zeros(steps, jnp.float32)
    betas = jnp.zeros(steps, jnp.float32)

    def reorth(w, basis, j_excl):
        """Project w off basis rows < j_excl (rows >= are zero anyway;
        the mask guards the current/future rows)."""
        coeff = jnp.dot(basis, w, precision=jax.lax.Precision.HIGHEST)
        keep = jnp.arange(basis.shape[0]) < j_excl
        return w - jnp.dot(jnp.where(keep, coeff, 0.0), basis, precision=jax.lax.Precision.HIGHEST)

    def body(j, state):
        ubuf, vbuf, alphas, betas = state
        # j=0 wraps to betas[-1]/ubuf[-1], both still zero -> no-op term
        w = matvec(vbuf[j]) - betas[j - 1] * ubuf[j - 1]
        w = reorth(w, ubuf, j)
        a = jnp.linalg.norm(w)
        # breakdown (exact low rank / lucky termination): a vanished
        # direction becomes the zero vector — its B rows/cols are zero and
        # contribute zero singular values instead of NaN blowups
        live_a = a > 1e-6 * jnp.maximum(alphas[0], 1.0)
        u = jnp.where(live_a, w / jnp.maximum(a, _EPS), 0.0)
        ubuf = ubuf.at[j].set(u)
        alphas = alphas.at[j].set(jnp.where(live_a, a, 0.0))

        z = rmatvec(u) - a * vbuf[j]
        z = reorth(z, vbuf, j + 1)
        b = jnp.linalg.norm(z)
        live_b = b > 1e-6 * jnp.maximum(alphas[0], 1.0)
        betas = betas.at[j].set(jnp.where(live_b, b, 0.0))
        vbuf = jax.lax.cond(
            j + 1 < steps,
            lambda vb: vb.at[j + 1].set(
                jnp.where(live_b, z / jnp.maximum(b, _EPS), 0.0)
            ),
            lambda vb: vb,
            vbuf,
        )
        return ubuf, vbuf, alphas, betas

    return jax.lax.fori_loop(0, steps, body, (ubuf, vbuf, alphas, betas))


def svds(
    matvec: Callable,
    rmatvec: Callable,
    shape: Tuple[int, int],
    k: int = 6,
    *,
    steps: Optional[int] = None,
    seed: int = 0,
) -> SvdResult:
    """Top-``k`` singular triplets of the (m, n) linear operator given by
    ``matvec`` (A @ x) and ``rmatvec`` (A^T @ y).

    ``steps`` Lanczos steps (default ``min(min(m, n), max(2k + 10, 20))``)
    with full reorthogonalization; accuracy of the leading triplets is at
    f32 working precision for well-separated spectra (test oracle: dense
    numpy SVD).
    """
    m, n = int(shape[0]), int(shape[1])
    if k < 1 or k > min(m, n):
        raise ValueError(f"k={k} out of range for shape {shape}")
    if steps is None:
        steps = min(min(m, n), max(2 * k + 10, 20))
    steps = int(min(max(steps, k), min(m, n)))

    ubuf, vbuf, alphas, betas = _gkl(matvec, rmatvec, m, n, steps, seed)

    # host: SVD of the small projection — A V = U B with B upper-bidiagonal
    # (alpha_j on the diagonal, beta_j on the superdiagonal)
    bmat = np.diag(np.asarray(alphas)) + np.diag(np.asarray(betas)[:-1], 1)
    p, s, qt = np.linalg.svd(bmat)
    u_small = jnp.asarray(p[:, :k].astype(np.float32))
    v_small = jnp.asarray(qt[:k].T.astype(np.float32))
    u = (jnp.asarray(ubuf).T @ u_small)
    v = (jnp.asarray(vbuf).T @ v_small)
    return SvdResult(u=u, s=jnp.asarray(s[:k].astype(np.float32)), v=v)


def svds_csr(a, k: int = 6, *, dtype=np.float32, steps=None, seed: int = 0,
             force=None) -> SvdResult:
    """Top-``k`` singular triplets of a host CSR matrix through planned
    device operators (``A`` and ``A^T`` each get their own format plan)."""
    from ..ops.operator import SpmvOperator

    op = SpmvOperator(a, dtype=dtype, force=force)
    opt = SpmvOperator(a.transpose(), dtype=dtype, force=force)
    return svds(op, opt, (a.rows, a.cols), k, steps=steps, seed=seed)

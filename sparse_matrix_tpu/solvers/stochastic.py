"""Stochastic (Hutchinson) estimators: trace and diagonal of implicit
operators.

New scope beyond the reference. Use cases: ``trace(A)`` / ``diag(A)`` of
operators only available as matvecs — Galerkin products, ``A^{-1}`` via a
solver closure (log-det gradients), graph heat kernels via
:func:`~.funm.expm_multiply_sym`.

Device-first: all ``k`` Rademacher probes run as ONE (n, k) block through the
operator's SpMM path (``matvec`` receives the full block when it supports
2-D inputs — every :class:`~sparse_matrix_tpu.ops.operator.SpmvOperator`
does via ``matmat``), so probe count scales along the packed-RHS axis the
SpMM kernels amortize.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["HutchinsonResult", "trace_estimate", "diag_estimate"]


class HutchinsonResult(NamedTuple):
    estimate: object  # scalar (trace) or (n,) vector (diag)
    stderr: object  # standard error of the estimate


def _probe_block(n: int, k: int, seed: int, dtype):
    """(n, k) Rademacher +-1 probes."""
    bits = jax.random.bernoulli(jax.random.PRNGKey(seed), 0.5, (n, k))
    return jnp.where(bits, 1.0, -1.0).astype(dtype)


def _apply_block(matvec: Callable, z):
    """Apply through matmat when available (one SpMM for all probes)."""
    mm = getattr(matvec, "matmat", None)
    if mm is not None:
        return mm(z)
    try:
        return matvec(z)
    except Exception:  # matvec is vector-only: column loop fallback
        return jnp.stack([matvec(z[:, i]) for i in range(z.shape[1])], axis=1)


def trace_estimate(
    matvec: Callable, n: int, *, probes: int = 32, seed: int = 0, dtype=jnp.float32
) -> HutchinsonResult:
    """``tr(A) ~= mean_i z_i^T A z_i`` over Rademacher probes ``z_i``.

    Unbiased; stderr shrinks as ``probes^{-1/2}`` (exact for diagonal A,
    variance comes from off-diagonal mass).
    """
    z = _probe_block(n, probes, seed, dtype)
    az = _apply_block(matvec, z)
    per_probe = jnp.sum(z * az, axis=0)  # (k,) quadratic forms
    est = jnp.mean(per_probe)
    stderr = jnp.std(per_probe, ddof=1) / jnp.sqrt(probes) if probes > 1 else jnp.inf
    return HutchinsonResult(estimate=est, stderr=stderr)


def diag_estimate(
    matvec: Callable, n: int, *, probes: int = 64, seed: int = 0, dtype=jnp.float32
) -> HutchinsonResult:
    """``diag(A) ~= mean_i z_i * (A z_i)`` (Bekas-Kokiopoulou-Saad)."""
    z = _probe_block(n, probes, seed, dtype)
    az = _apply_block(matvec, z)
    samples = z * az  # (n, k)
    est = jnp.mean(samples, axis=1)
    stderr = (
        jnp.std(samples, axis=1, ddof=1) / jnp.sqrt(probes)
        if probes > 1
        else jnp.full(n, jnp.inf)
    )
    return HutchinsonResult(estimate=est, stderr=stderr)

"""Matrix-function actions: ``y = exp(t A) @ b`` without forming exp(tA).

New scope beyond the reference (no solver layer there). Two device
paths, both pure matvec sequences that ride the planned SpMV/SpMM formats:

* **Symmetric/SPD — Chebyshev** (:func:`expm_multiply_sym`): expand
  ``exp`` in Chebyshev polynomials on the spectral interval
  ``[lam_min, lam_max]`` (coefficients are modified Bessel values,
  computed once on host); the three-term recurrence is one
  ``lax.fori_loop`` of matvecs. Degree follows from the classic
  super-geometric convergence bound; spectral bounds default to the
  library's own Lanczos estimates (:func:`~.eigen.eigsh_extremal`).
* **General — scaled Taylor** (:func:`expm_multiply`): Al-Mohy-Higham
  style ``y = (exp(tA/s))^s b`` with a fixed-degree truncated Taylor per
  step, ``s`` chosen from a 1-norm bound. The CSR convenience wrapper
  computes the exact 1-norm on host; the raw-matvec form takes a bound.

Accuracy oracle in tests: ``scipy.linalg.expm`` on dense.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["expm_multiply_sym", "expm_multiply", "expm_multiply_csr"]


def _cheb_coeffs(a: float, b: float, t: float, degree: int) -> np.ndarray:
    """Chebyshev coefficients of ``exp(t x)`` on ``[a, b]``:
    ``c_k = 2 e^{t(a+b)/2} I_k(t(b-a)/2)`` (``c_0`` halved)."""
    from scipy.special import ive  # exponentially-scaled I_k, overflow-safe

    half_span = t * (b - a) / 2.0
    mid = t * (a + b) / 2.0
    k = np.arange(degree + 1)
    # ive(k, z) = I_k(z) * exp(-|z|)  ->  c_k = 2 e^{mid + |half|} ive_k
    c = 2.0 * np.exp(mid + abs(half_span)) * ive(k, half_span)
    c[0] *= 0.5
    return c


def _cheb_degree(a: float, b: float, t: float, tol: float) -> int:
    """Smallest degree whose trailing coefficient bound is below tol
    (coefficients decay super-geometrically; scan the actual values)."""
    for deg in (8, 12, 16, 24, 32, 48, 64, 96, 128):
        c = _cheb_coeffs(a, b, t, deg)
        scale = max(abs(c).max(), 1e-300)
        if abs(c[-1]) <= tol * scale and abs(c[-2]) <= tol * scale:
            return deg
    return 128


def expm_multiply_sym(
    matvec: Callable,
    b,
    t: float = 1.0,
    *,
    lam_bounds: Optional[Tuple[float, float]] = None,
    n: Optional[int] = None,
    degree: Optional[int] = None,
    tol: float = 1e-7,
    lanczos_steps: int = 40,
    seed: int = 0,
):
    """``exp(t A) @ b`` for symmetric ``A`` by Chebyshev expansion.

    ``lam_bounds`` (lam_min, lam_max) spectral interval; estimated with
    :func:`~.eigen.eigsh_extremal` (pass ``n``) when omitted, widened 5%
    each side for safety. Works for vectors and (n, K) blocks.
    """
    b = jnp.asarray(b)
    if lam_bounds is None:
        if n is None:
            raise ValueError("pass lam_bounds or n (for the Lanczos estimate)")
        from .eigen import eigsh_extremal

        lo, hi = eigsh_extremal(matvec, n, m=lanczos_steps, seed=seed)
        pad = 0.05 * max(hi - lo, abs(hi), 1e-30)
        lam_bounds = (lo - pad, hi + pad)
    a_lo, a_hi = float(lam_bounds[0]), float(lam_bounds[1])
    if not a_hi > a_lo:
        a_hi = a_lo + max(1e-6, abs(a_lo) * 1e-6)
    if degree is None:
        degree = _cheb_degree(a_lo, a_hi, t, tol)
    c = jnp.asarray(_cheb_coeffs(a_lo, a_hi, t, degree).astype(np.float32))

    # affine map of A onto [-1, 1]: As = (2A - (a+b)I) / (b-a)
    alpha = 2.0 / (a_hi - a_lo)
    beta = -(a_hi + a_lo) / (a_hi - a_lo)

    def amap(v):
        return alpha * matvec(v) + beta * v

    t0 = b
    t1 = amap(b)
    y0 = c[0] * t0 + c[1] * t1

    def body(k, state):
        tm1, tcur, y = state
        tnext = 2.0 * amap(tcur) - tm1
        return tcur, tnext, y + c[k] * tnext

    _, _, y = jax.lax.fori_loop(2, degree + 1, body, (t0, t1, y0))
    return y


def expm_multiply(
    matvec: Callable,
    b,
    t: float = 1.0,
    *,
    norm_bound: float,
    degree: int = 16,
    theta: float = 1.0,
):
    """``exp(t A) @ b`` for GENERAL ``A``: scaling + truncated Taylor.

    ``s = ceil(|t| * norm_bound / theta)`` substeps, each applying the
    degree-``degree`` Taylor polynomial of ``exp(tA/s)`` (double
    ``lax.fori_loop``; at ``theta=1`` and degree 16 the per-step truncation
    is ~1/17! ~ 3e-15). ``norm_bound`` is any upper bound on ``||A||``
    (the CSR wrapper supplies the exact 1-norm).
    """
    b = jnp.asarray(b)
    s = max(1, int(np.ceil(abs(t) * float(norm_bound) / theta)))
    h = t / s

    def taylor_step(_, y):
        term = y
        acc = y

        def inner(k, st):
            term, acc = st
            term = (h / k) * matvec(term)
            return term, acc + term

        _, acc = jax.lax.fori_loop(1, degree + 1, inner, (term, acc))
        return acc

    return jax.lax.fori_loop(0, s, taylor_step, b)


def expm_multiply_csr(a, b, t: float = 1.0, *, dtype=np.float32, degree: int = 16,
                      force=None):
    """``exp(t A) @ b`` for a host CSR matrix through a planned operator
    (exact 1-norm computed on host for the scaling)."""
    from ..ops.operator import SpmvOperator

    col_abs = np.bincount(
        a.indices.astype(np.int64),
        weights=np.abs(a.vals.astype(np.float64)),
        minlength=a.cols,
    )
    norm1 = float(col_abs.max()) if a.nnz() else 0.0
    op = SpmvOperator(a, dtype=dtype, force=force)
    return expm_multiply(op, b, t, norm_bound=max(norm1, 1e-30), degree=degree)

"""Batched small sparse systems sharing one sparsity pattern.

New scope beyond the reference (single-matrix library): small matrices
(<35K nnz) are launch-overhead bound — no kernel choice can amortize a
launch over a single 1k x 1k operator. The answer is to stop solving them
one at a time: batch B systems with the SAME pattern (per-element FEM
blocks, per-sample graph Laplacians, parameter sweeps) into one device op.

Design:

* The pattern is host CSR; per-system values are a ``(B, nnz)`` array
  scattered once into a shared padded-ELL view ``(B, rows, W)``.
* For the small-n regime this module targets, the gather of ``x`` rows
  becomes a **one-hot matmul**: ``sel[r, w, c]`` (static from the
  pattern) contracted with ``x (B, c)`` — FLOPs ``B * rows * W * cols``
  are trivia at small n. ``precision=HIGHEST`` keeps it exact (a default
  f32 matmul may round operands to TF32 on the GPU). Whether it beats the
  plain gather on the GPU is not measured yet.
* Above the one-hot budget the apply falls back to the XLA gather (still
  batched — one launch, not B).
* :func:`batched_cg_solve` runs all systems in one ``lax.while_loop``
  with per-lane convergence masks (a lane that converged stops updating
  but the loop runs until every lane is done — standard SIMT-style
  batching, no host sync per system).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "BatchedEllOperator",
    "BatchedCgResult",
    "batched_cg_solve",
]

# one-hot selector budget: rows*W*cols f32 elements (64 MB default)
_ONEHOT_BUDGET = 16 * 1024 * 1024


class BatchedEllOperator:
    """``y[b] = A_b @ x[b]`` for B matrices sharing one CSR pattern.

    ``vals`` is ``(B, nnz)`` in the pattern's CSR entry order. Applies to
    ``x`` of shape ``(B, cols)`` (or ``(B, cols, K)`` blocks).
    """

    def __init__(self, pattern, vals, *, dtype=np.float32, force_gather: bool = False):
        from .spmv import ell_from_csr

        vals = np.asarray(vals)
        if vals.ndim != 2 or vals.shape[1] != pattern.nnz():
            raise ValueError(
                f"vals must be (B, nnz={pattern.nnz()}), got {vals.shape}"
            )
        self.rows, self.cols = pattern.rows, pattern.cols
        self.batch = vals.shape[0]
        # scatter (B, nnz) -> (B, rows, W) through the pattern's ELL layout
        _, ell_cols = ell_from_csr(pattern, dtype=dtype)
        w = ell_cols.shape[1]
        r = pattern.row_ids()
        k = np.arange(pattern.nnz()) - pattern.offsets[:-1].astype(np.int64)[r]
        ev = np.zeros((self.batch, self.rows, w), dtype=dtype)
        ev[:, r, k] = vals.astype(dtype)
        self.ell_vals = jnp.asarray(ev)
        self.ell_cols = jnp.asarray(ell_cols)
        self.width = w
        sel_elems = self.rows * w * self.cols
        self.use_onehot = (not force_gather) and sel_elems <= _ONEHOT_BUDGET
        if self.use_onehot:
            sel = np.zeros((self.rows * w, self.cols), dtype=dtype)
            sel[np.arange(self.rows * w), ell_cols.reshape(-1)] = 1.0
            self.sel = jnp.asarray(sel)

    def __call__(self, x):
        x = jnp.asarray(x)
        if x.ndim == 2:
            return _apply_vec(
                self.ell_vals, self.ell_cols,
                self.sel if self.use_onehot else None, x,
            )
        return _apply_block(
            self.ell_vals, self.ell_cols,
            self.sel if self.use_onehot else None, x,
        )


@functools.partial(jax.jit, static_argnames=())
def _apply_vec(ell_vals, ell_cols, sel, x):
    b, rows, w = ell_vals.shape
    if sel is not None:
        # one-hot gather as a matmul: (B, cols) @ (cols, rows*W) -> (B, rows, W)
        xg = jax.lax.dot_general(
            x, sel.T, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(b, rows, w)
    else:
        xg = x[:, ell_cols]  # batched XLA gather (one launch)
    return jnp.sum(ell_vals * xg, axis=2)


@functools.partial(jax.jit, static_argnames=())
def _apply_block(ell_vals, ell_cols, sel, x):
    b, rows, w = ell_vals.shape
    k = x.shape[2]
    if sel is not None:
        xg = jax.lax.dot_general(
            x, sel.T, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )  # (B, K, rows*W)
        xg = jnp.moveaxis(xg, 1, 2).reshape(b, rows, w, k)
    else:
        xg = x[:, ell_cols]  # (B, rows, W, K)
    return jnp.sum(ell_vals[..., None] * xg, axis=2)


class BatchedCgResult(NamedTuple):
    x: object  # (B, n) solutions
    iterations: object  # (B,) per-lane iteration counts
    residual_norm: object  # (B,) final residual norms


def batched_cg_solve(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
) -> BatchedCgResult:
    """CG on B SPD systems at once: ``matvec`` maps ``(B, n) -> (B, n)``.

    One ``lax.while_loop`` for the whole batch; converged lanes freeze
    (masked updates) while the rest keep iterating — no per-system host
    round-trips, and the wall-clock is set by the hardest lane instead of
    the sum. Per-lane stopping: ``||r_b|| <= tol * ||b_b||``.
    """
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    def dots(u, v):
        return jnp.sum(u * v, axis=1)  # (B,)

    r = b - matvec(x)
    p = r
    rr = dots(r, r)
    bb = dots(b, b)
    tol2 = jnp.asarray(tol, rr.dtype) ** 2 * jnp.where(bb > 0, bb, 1.0)

    def cond(state):
        _x, _p, _r, rr, _it, k = state
        return jnp.logical_and(jnp.any(rr > tol2), k < maxiter)

    def body(state):
        x, p, r, rr, it, k = state
        active = rr > tol2  # (B,)
        ap = matvec(p)
        pap = dots(p, ap)
        alpha = rr / jnp.where(pap != 0, pap, 1.0)
        alpha = jnp.where(active, alpha, 0.0)[:, None]
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = dots(r, r)
        beta = jnp.where(active, rr_new / jnp.where(rr != 0, rr, 1.0), 0.0)
        p = jnp.where(active[:, None], r + beta[:, None] * p, p)
        rr = jnp.where(active, rr_new, rr)
        return x, p, r, rr, it + active.astype(jnp.int32), k + 1

    x, p, r, rr, it, k = jax.lax.while_loop(
        cond, body, (x, p, r, rr, jnp.zeros(b.shape[0], jnp.int32), jnp.int32(0))
    )
    return BatchedCgResult(x=x, iterations=it, residual_norm=jnp.sqrt(rr))

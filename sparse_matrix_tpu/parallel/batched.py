"""Batch-parallel small systems over the device mesh.

``ops/batched.py`` solves B same-pattern systems in one device program
(the answer to the launch-floor regime of small matrices). This module
scales that across devices: the BATCH axis is the
parallel axis, sharded over a 1-D mesh. Each device owns B/ndev complete
systems, so the apply and every CG vector op are fully device-local; the
only cross-device traffic is the scalar convergence test (``jnp.any``
over per-lane residuals — one psum of a (B,) bool per iteration, bytes
that round to nothing against interconnect bandwidth).

This is the batched analog of the reference's data parallelism
(``/root/reference/spam_csr/src/mul_hash.rs:38-64`` — independent work
items scheduled over workers); on devices the scheduling is GSPMD: annotate
the batch sharding, let XLA partition the program.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.batched import BatchedCgResult, BatchedEllOperator, batched_cg_solve

__all__ = ["shard_batched_operator", "dist_batched_cg_solve"]

BATCH = "batch"


def shard_batched_operator(
    op: BatchedEllOperator, mesh: Mesh, *, axis: str = BATCH
) -> BatchedEllOperator:
    """Re-place a :class:`BatchedEllOperator`'s per-system arrays with the
    batch axis sharded over ``mesh`` (pattern data — ell_cols / one-hot
    selector — is replicated: it is shared by every system). B must divide
    by the mesh size (pad with duplicate systems upstream otherwise)."""
    (ax,) = mesh.axis_names if len(mesh.axis_names) == 1 else (axis,)
    if op.batch % mesh.devices.size != 0:
        raise ValueError(
            f"batch {op.batch} not divisible by mesh size {mesh.devices.size}"
        )
    bshard = NamedSharding(mesh, P(ax, None, None))
    repl = NamedSharding(mesh, P())
    op.ell_vals = jax.device_put(op.ell_vals, bshard)
    op.ell_cols = jax.device_put(op.ell_cols, repl)
    if op.use_onehot:
        op.sel = jax.device_put(op.sel, repl)
    return op


def dist_batched_cg_solve(
    op: BatchedEllOperator,
    b,
    mesh: Optional[Mesh] = None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    axis: str = BATCH,
) -> BatchedCgResult:
    """Batched CG with the batch axis sharded over ``mesh``.

    ``b`` is ``(B, n)`` (host or device); it is placed batch-sharded and
    the whole solve jits under GSPMD — each device iterates its own
    B/ndev systems, lanes freeze independently on convergence, and the
    loop runs until the globally hardest lane is done.
    """
    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh(axis=axis)
    (ax,) = mesh.axis_names if len(mesh.axis_names) == 1 else (axis,)
    op = shard_batched_operator(op, mesh, axis=ax)
    b = jax.device_put(jnp.asarray(b), NamedSharding(mesh, P(ax, None)))

    @jax.jit
    def solve(bb):
        return batched_cg_solve(op, bb, tol=tol, maxiter=maxiter)

    return solve(b)

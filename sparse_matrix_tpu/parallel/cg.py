"""Distributed conjugate gradient over a device mesh.

The "training step" of this framework: one CG iteration = one distributed
SpMV (all-gather of the direction vector between devices) + axpy updates on
row-sharded vectors + two global reductions (psum). Provided both as an
explicit ``shard_map`` step (collectives spelled out) and as a jitted
GSPMD solve (sharding constraints, XLA inserts collectives).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .spmv import dist_spmv_gspmd, shard_ell
from ..formats.csr import CsrMatrix

__all__ = ["dist_cg_step", "dist_cg_solve", "prepare_dist_cg"]


def dist_cg_step(ell_vals, ell_cols, state, mesh: Mesh, *, axis: str = "rows"):
    """One CG iteration with explicit collectives via shard_map.

    ``state = (x, p, r, rs)``: all vectors row-sharded; ``rs`` replicated
    scalar. Returns the updated state. This is the ``dryrun_multichip``
    workload: all-gather rides the mesh axis; dots psum over it.
    """
    from jax import shard_map

    vec = P(axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), (vec, vec, vec, P()), ),
        out_specs=(vec, vec, vec, P()),
    )
    def _step(ev, ec, st):
        x, p, r, rs = st
        p_full = jax.lax.all_gather(p, axis, tiled=True)
        ap = jnp.sum(ev * p_full[ec], axis=1)
        pap = jax.lax.psum(jnp.vdot(p, ap), axis)
        alpha = rs / pap
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jax.lax.psum(jnp.vdot(r, r), axis)
        p = r + (rs_new / rs) * p
        return x, p, r, rs_new

    return _step(ell_vals, ell_cols, state)


def prepare_dist_cg(m: CsrMatrix, b: np.ndarray, mesh: Mesh, *, dtype=np.float32, axis: str = "rows"):
    """Shard the operator and the padded right-hand side onto the mesh."""
    ev, ec, rows_pad = shard_ell(m, mesh, dtype=dtype, axis=axis)
    b_pad = np.zeros(rows_pad, dtype=dtype)
    b_pad[: m.rows] = b
    vec_sh = NamedSharding(mesh, P(axis))
    return ev, ec, jax.device_put(jnp.asarray(b_pad), vec_sh), rows_pad


def dist_cg_solve(
    ell_vals,
    ell_cols,
    b,
    mesh: Mesh,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    axis: str = "rows",
):
    """Full CG solve under jit with GSPMD shardings (collectives inserted by
    XLA); vectors stay row-sharded across iterations."""
    from ..solvers.cg import cg_solve

    matvec = lambda v: dist_spmv_gspmd(ell_vals, ell_cols, v, mesh, axis=axis)
    return jax.jit(
        lambda b_: cg_solve(matvec, b_, tol=tol, maxiter=maxiter)
    )(b)

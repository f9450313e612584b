"""Distributed AMG-preconditioned CG over a device mesh.

Composes the whole stack across chips: the host coarsening loop
(:func:`~sparse_matrix_tpu.solvers.amg.amg_coarsen` — strength graph,
native greedy aggregation, Galerkin products through the SpGEMM engines)
builds the hierarchy once; every level's ``A``/``P``/``P^T`` then lives
ROW-SHARDED in padded-ELL layout on the mesh and the V-cycle + PCG run
under one jit with GSPMD shardings (XLA inserts the all-gathers for the
replicated operand side and psums for the dot products — the same
communication pattern as :mod:`.spmv`, applied per level).

Sharding plan per level ``l``:

* ``A_l`` rows over the mesh axis; smoother vectors (``x``, ``r``,
  ``dinv``) sharded the same way — Jacobi sweeps are purely local.
* ``P_l`` sharded over FINE rows (prolongation output is fine-sharded),
  ``P_l^T`` over COARSE rows (restriction output is coarse-sharded), so
  level transfers never resharble output; only the gathered operand
  crosses the interconnect.
* The coarsest solve is a replicated small dense ``pinv`` matmul.

Validated on the virtual 8-device CPU mesh (tests) and wired into
``__graft_entry__.dryrun_multichip`` as the sixth parallelism strategy.
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.csr import CsrMatrix
from .spmv import shard_ell

__all__ = ["DistAmgLevel", "DistAmgHierarchy", "dist_amg_setup", "dist_amg_pcg_solve"]


class DistAmgLevel(NamedTuple):
    a_ev: object  # (rows_pad, W) row-sharded
    a_ec: object
    p_ev: object  # (rows_pad, Wp) fine-row-sharded
    p_ec: object
    pt_ev: object  # (coarse_pad, Wt) coarse-row-sharded
    pt_ec: object
    dinv: object  # (rows_pad,) row-sharded
    n: int  # true (unpadded) fine size
    rows_pad: int
    coarse_pad: int


class DistAmgHierarchy(NamedTuple):
    levels: List[DistAmgLevel]
    coarse_inv: object  # replicated (coarse_pad, coarse_pad) pinv
    omega: float
    nu: int

    def preconditioner(self):
        return lambda r: dist_vcycle(self, r)


def _pad_csr_cols(m: CsrMatrix, cols_pad: int) -> CsrMatrix:
    """Widen the column space (padding columns are structurally empty)."""
    return CsrMatrix(m.rows, cols_pad, m.vals, m.indices, m.offsets, is_sorted=m.is_sorted)


def dist_amg_setup(
    a: CsrMatrix,
    mesh: Mesh,
    *,
    axis: str = "rows",
    dtype=np.float32,
    theta: float = 0.08,
    coarse_size: int = 200,
    max_levels: int = 12,
    omega: float = 2.0 / 3.0,
    nu: int = 1,
    coarsening=None,
) -> DistAmgHierarchy:
    """Build the hierarchy on host, shard every level onto the mesh.

    ``coarsening``: a prior ``amg_coarsen(a, ...)`` result to reuse (the
    host coarsening is the expensive part; sharding it onto several meshes
    needs it once)."""
    from ..solvers.amg import amg_coarsen

    if coarsening is None:
        coarsening = amg_coarsen(
            a, theta=theta, coarse_size=coarse_size, max_levels=max_levels
        )
    host_levels, coarse = coarsening
    ndev = mesh.devices.size
    levels = []
    vec_sh = NamedSharding(mesh, P(axis))
    for a_l, p_l, dinv, _lam in host_levels:
        rows_pad = -(-a_l.rows // ndev) * ndev
        coarse_pad = -(-p_l.cols // ndev) * ndev
        a_ev, a_ec, _ = shard_ell(a_l, mesh, dtype=dtype, axis=axis)
        # P gathers coarse vectors: pad its column space to coarse_pad
        p_ev, p_ec, _ = shard_ell(_pad_csr_cols(p_l, coarse_pad), mesh, dtype=dtype, axis=axis)
        # P^T gathers fine vectors: pad to rows_pad
        pt_ev, pt_ec, _ = shard_ell(
            _pad_csr_cols(p_l.transpose(), rows_pad), mesh, dtype=dtype, axis=axis
        )
        dpad = np.zeros(rows_pad, dtype=dtype)
        dpad[: a_l.rows] = dinv.astype(dtype)
        levels.append(
            DistAmgLevel(
                a_ev, a_ec, p_ev, p_ec, pt_ev, pt_ec,
                jax.device_put(jnp.asarray(dpad), vec_sh),
                a_l.rows, rows_pad, coarse_pad,
            )
        )
    # replicated coarse pinv, padded square
    cp = levels[-1].coarse_pad if levels else -(-coarse.rows // ndev) * ndev
    dense = np.zeros((cp, cp), np.float64)
    dense[: coarse.rows, : coarse.cols] = coarse.to_dense().astype(np.float64)
    coarse_inv = jax.device_put(
        jnp.asarray(np.linalg.pinv(dense).astype(dtype)),
        NamedSharding(mesh, P(None, None)),
    )
    return DistAmgHierarchy(levels, coarse_inv, omega=omega, nu=nu)


def _ell_apply(ev, ec, x_full):
    """Local ELL row-block times a (gathered) full vector — under GSPMD the
    gather of ``x_full`` is inserted by XLA from the shardings."""
    return jnp.sum(ev * x_full[ec], axis=1)


def dist_vcycle(h: DistAmgHierarchy, r, level: int = 0):
    """One V(nu, nu) cycle on a row-sharded residual (jit-compatible)."""
    if level >= len(h.levels):
        return jnp.dot(h.coarse_inv, r, precision=jax.lax.Precision.HIGHEST)
    lv = h.levels[level]
    # pre-smooth (weighted Jacobi from x=0): purely local
    x = h.omega * lv.dinv * r
    for _ in range(h.nu - 1 if h.nu > 1 else 0):
        x = x + h.omega * lv.dinv * (r - _ell_apply(lv.a_ev, lv.a_ec, x))
    rc = _ell_apply(lv.pt_ev, lv.pt_ec, r - _ell_apply(lv.a_ev, lv.a_ec, x))
    xc = dist_vcycle(h, rc, level + 1)
    x = x + _ell_apply(lv.p_ev, lv.p_ec, xc)
    # post-smooth (symmetric)
    for _ in range(h.nu):
        x = x + h.omega * lv.dinv * (r - _ell_apply(lv.a_ev, lv.a_ec, x))
    return x


def dist_amg_pcg_solve(
    h: DistAmgHierarchy,
    b,
    *,
    tol: float = 1e-6,
    maxiter: int = 200,
):
    """PCG with the distributed V-cycle; ``b`` is the (rows_pad,)
    row-sharded padded rhs. The whole solve jits into one while_loop;
    GSPMD turns dots into psums and operand gathers into all-gathers."""
    from ..solvers.cg import pcg_solve

    lv0 = h.levels[0]
    matvec = lambda v: _ell_apply(lv0.a_ev, lv0.a_ec, v)
    return jax.jit(
        lambda bb: pcg_solve(matvec, bb, h.preconditioner(), tol=tol, maxiter=maxiter)
    )(b)

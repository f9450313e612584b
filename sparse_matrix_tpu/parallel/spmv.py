"""Distributed SpMV over a device mesh.

Row-parallel decomposition (the multi-chip generalization of the reference's
FLOP-balanced row chunking, ``spam_csr/src/mul_hash.rs:38-64``): each device
owns a contiguous block of matrix rows in padded-ELL layout; ``x`` is
replicated (gathered between devices when it arrives sharded); ``y`` comes back
row-sharded. Two implementations:

* :func:`dist_spmv` — ``shard_map`` with explicit collectives
  (``all_gather`` of x over the mesh axis);
* :func:`dist_spmv_gspmd` — sharding-annotated XLA (GSPMD inserts the
  collectives), the idiomatic jit path.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.csr import CsrMatrix
from ..ops.spmv import ell_from_csr

__all__ = [
    "shard_ell",
    "dist_spmv",
    "dist_spmv_gspmd",
    "shard_ell_by_cols",
    "dist_spmv_colsplit",
]


def shard_ell(
    m: CsrMatrix, mesh: Mesh, *, dtype=np.float32, axis: str = "rows"
) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
    """Build a row-sharded padded-ELL view of ``m`` on the mesh.

    Rows are padded to a multiple of the mesh size so shards are equal.
    Returns (ell_vals, ell_cols, padded_rows), both sharded on rows.
    """
    n = mesh.devices.size
    ev, ec = ell_from_csr(m, dtype=dtype)
    rows_pad = -(-m.rows // n) * n
    if rows_pad != m.rows:
        ev = np.pad(ev, ((0, rows_pad - m.rows), (0, 0)))
        ec = np.pad(ec, ((0, rows_pad - m.rows), (0, 0)))
    sh = NamedSharding(mesh, P(axis, None))
    return jax.device_put(jnp.asarray(ev), sh), jax.device_put(jnp.asarray(ec), sh), rows_pad


def dist_spmv(ell_vals, ell_cols, x, mesh: Mesh, *, axis: str = "rows"):
    """y = A @ x with explicit collectives: x arrives row-sharded, is
    all-gathered between devices, each device multiplies its row block."""
    from jax import shard_map

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=P(axis),
    )
    def _spmv(ev, ec, x_shard):
        x_full = jax.lax.all_gather(x_shard, axis, tiled=True)
        return jnp.sum(ev * x_full[ec], axis=1)

    return _spmv(ell_vals, ell_cols, x)


def dist_spmv_gspmd(ell_vals, ell_cols, x, mesh: Mesh, *, axis: str = "rows"):
    """Same computation via sharding constraints; XLA/GSPMD inserts the
    all-gather."""
    y = jnp.sum(ell_vals * x[ell_cols], axis=1)
    return jax.lax.with_sharding_constraint(y, NamedSharding(mesh, P(axis)))


def shard_ell_by_cols(
    m: CsrMatrix, mesh: Mesh, *, dtype=np.float32, axis: str = "rows"
) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
    """Column-split decomposition: device d owns the columns
    ``[d*C/n, (d+1)*C/n)`` of the matrix (its ELL slice built from the
    column-restricted submatrix). The "tensor-parallel" axis of this domain:
    x arrives sharded, partial products are reduce-scattered back."""
    n = mesh.devices.size
    cols_pad = -(-m.cols // n) * n
    rows_pad = -(-m.rows // n) * n  # psum_scatter tiles y over devices
    shard_w = cols_pad // n
    r = m.row_ids()
    c = m.indices.astype(np.int64)
    owner = c // shard_w
    local_c = c % shard_w
    evs, ecs = [], []
    w = 1
    for d in range(n):
        mask = owner == d
        offsets = np.zeros(rows_pad + 1, dtype=np.int64)
        np.add.at(offsets, r[mask] + 1, 1)
        np.cumsum(offsets, out=offsets)
        sub = CsrMatrix(
            rows_pad, max(1, shard_w), m.vals[mask],
            local_c[mask].astype(np.uint32), offsets, is_sorted=m.is_sorted,
        )
        ev, ec = ell_from_csr(sub, dtype=dtype)
        evs.append(ev)
        ecs.append(ec)
        w = max(w, ev.shape[1])
    evs = [np.pad(e, ((0, 0), (0, w - e.shape[1]))) for e in evs]
    ecs = [np.pad(e, ((0, 0), (0, w - e.shape[1]))) for e in ecs]
    sh = NamedSharding(mesh, P(axis, None, None))
    ev = jax.device_put(jnp.asarray(np.stack(evs)), sh)
    ec = jax.device_put(jnp.asarray(np.stack(ecs)), sh)
    return ev, ec, cols_pad


def dist_spmv_colsplit(ell_vals3, ell_cols3, x, mesh: Mesh, *, axis: str = "rows"):
    """Column-split SpMV: each device multiplies its column slice against its
    x shard, then partial y vectors are summed and re-sharded with a
    reduce-scatter (``psum_scatter``) between devices."""
    from jax import shard_map

    n = mesh.devices.size

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(axis)),
        out_specs=P(axis),
    )
    def _spmv(ev, ec, x_shard):
        y_partial = jnp.sum(ev[0] * x_shard[ec[0]], axis=1)  # full-length rows
        return jax.lax.psum_scatter(y_partial, axis, tiled=True)

    return _spmv(ell_vals3, ell_cols3, x)

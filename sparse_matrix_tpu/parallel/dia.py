"""Distributed DIA SpMV: banded operators row-sharded across the mesh.

Each device owns a contiguous block of rows of every band (``data`` sharded
on its row axis). A band at offset ``off`` needs ``x[i+off]`` for the local
rows — a window of the global x that spans at most ``max|off|`` beyond the
local shard, so the exchange is an all-gather of x between devices followed by
static local slices (halo exchange would be the bandwidth-optimal variant;
x is small relative to the operator, so the all-gather is fine here).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.dia import DiaMatrix

__all__ = ["shard_dia", "dist_spmv_dia", "dist_spmv_dia_halo", "dist_cg_solve_dia"]


def shard_dia(m: DiaMatrix, mesh: Mesh, *, axis: str = "rows") -> Tuple[jnp.ndarray, int]:
    """Row-shard the band data; returns (data (nbands, rows_pad) sharded on
    the second axis, rows_pad)."""
    n = mesh.devices.size
    rows_pad = -(-m.rows // n) * n
    data = m.data
    if rows_pad != m.rows:
        data = np.pad(data, ((0, 0), (0, rows_pad - m.rows)))
    sh = NamedSharding(mesh, P(None, axis))
    return jax.device_put(jnp.asarray(data), sh), rows_pad


def dist_spmv_dia(
    data, x, offsets: tuple, mesh: Mesh, *, rows_pad: int, axis: str = "rows"
):
    """y = A @ x for a sharded DIA operator; x and y row-sharded."""
    from jax import shard_map

    n = mesh.devices.size
    shard_rows = rows_pad // n
    lo = -min(0, min(offsets))
    hi = max(0, max(offsets)) + rows_pad

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis)),
        out_specs=P(axis),
    )
    def _spmv(data_shard, x_shard):
        # device d owns global rows [d*shard_rows, (d+1)*shard_rows)
        d = jax.lax.axis_index(axis)
        x_full = jax.lax.all_gather(x_shard, axis, tiled=True)
        xpad = jnp.zeros(lo + hi, x_full.dtype).at[lo : lo + x_full.shape[0]].set(x_full)
        base = d * shard_rows
        y = jnp.zeros(shard_rows, x_full.dtype)
        for b, off in enumerate(offsets):
            win = jax.lax.dynamic_slice(xpad, (lo + base + off,), (shard_rows,))
            y = y + data_shard[b] * win
        return y

    return _spmv(data, x)


def dist_spmv_dia_halo(
    data, x, offsets: tuple, mesh: Mesh, *, rows_pad: int, axis: str = "rows"
):
    """Halo-exchange DIA SpMV: each device trades only ``max|offset|``
    boundary elements with its mesh neighbors via ``ppermute`` (two
    point-to-point hops), instead of all-gathering x. interconnect bytes per
    apply scale with the bandwidth of the operator, not with N — the right
    exchange for banded operators, where the halo is tiny.

    Boundary devices receive zero-filled halos (``ppermute`` leaves
    non-targets zero), matching the global zero-padding semantics of
    :func:`dist_spmv_dia`. Falls back to the all-gather variant when the
    halo is wider than one shard (neighbors alone cannot supply it).
    """
    from jax import shard_map

    n = mesh.devices.size
    shard_rows = rows_pad // n
    lo = -min(0, min(offsets))
    hi = max(0, max(offsets))
    if lo > shard_rows or hi > shard_rows:
        return dist_spmv_dia(data, x, offsets, mesh, rows_pad=rows_pad, axis=axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(axis)),
        out_specs=P(axis),
    )
    def _spmv(data_shard, x_shard):
        parts = []
        if lo:
            left = jax.lax.ppermute(
                x_shard[-lo:], axis, [(i, i + 1) for i in range(n - 1)]
            )
            parts.append(left)
        parts.append(x_shard)
        if hi:
            right = jax.lax.ppermute(
                x_shard[:hi], axis, [(i + 1, i) for i in range(n - 1)]
            )
            parts.append(right)
        xl = jnp.concatenate(parts) if len(parts) > 1 else x_shard
        y = jnp.zeros(shard_rows, x_shard.dtype)
        for b, off in enumerate(offsets):
            s = lo + off
            y = y + data_shard[b] * jax.lax.slice(xl, (s,), (s + shard_rows,))
        return y

    return _spmv(data, x)


def dist_cg_solve_dia(
    m: DiaMatrix, b: np.ndarray, mesh: Mesh, *, tol=1e-5, maxiter=2000, axis: str = "rows"
):
    """Distributed CG on a banded operator: DIA shards + row-sharded vectors;
    XLA inserts psum for the dots under jit (GSPMD)."""
    from ..solvers.cg import cg_solve

    data, rows_pad = shard_dia(m, mesh, axis=axis)
    b_pad = np.zeros(rows_pad, dtype=np.float32)
    b_pad[: m.rows] = b
    vec = NamedSharding(mesh, P(axis))
    bj = jax.device_put(jnp.asarray(b_pad), vec)
    mv = lambda v: dist_spmv_dia_halo(data, v, m.offsets, mesh, rows_pad=rows_pad, axis=axis)
    return jax.jit(lambda bb: cg_solve(mv, bb, tol=tol, maxiter=maxiter))(bj)

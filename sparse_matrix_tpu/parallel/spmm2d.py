"""2-D (rows x cols) mesh SpMM: Y = A @ X with A sharded over both axes.

The 1-D decompositions in :mod:`parallel.spmv` shard rows *or* columns; a
2-D mesh shards both, the standard scaling shape for large operators
("How to Scale Your Model": pick a mesh, annotate shardings, let collectives
ride the interconnect). Device (i, j) owns the (i, j) block of A (padded-ELL layout with
block-local column indices), the ``j``-th row-shard of X (replicated over the
``rows`` mesh axis), and produces a partial Y block; partials are summed
over the ``cols`` axis with ``psum``, leaving Y row-sharded (replicated over
``cols``).

interconnect traffic per apply: one psum of ``rows_pad/nr x F`` over the ``cols``
axis — no all-gather of X at all (X is consumed where it lives). The
reference has no multi-node capability (SURVEY.md §2.2); this extends its
FLOP-balanced row-chunking idea (``spam_csr/src/mul_hash.rs:38-64``) to a
second axis.
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

__all__ = ["make_mesh2d", "shard_ell_2d", "dist_spmm_2d"]


def make_mesh2d(nr: int, nc: int, *, axes: Tuple[str, str] = ("rows", "cols")) -> Mesh:
    """(nr x nc) mesh over the first nr*nc devices."""
    devs = jax.devices()
    if nr * nc > len(devs):
        raise ValueError(f"requested {nr * nc} devices, have {len(devs)}")
    return Mesh(np.array(devs[: nr * nc]).reshape(nr, nc), axes)


def shard_ell_2d(
    m: CsrMatrix, mesh: Mesh, *, dtype=np.float32
) -> Tuple[jnp.ndarray, jnp.ndarray, int, int]:
    """Split ``m`` into an (nr x nc) grid of blocks, each in padded-ELL form
    with block-local column indices; ELL widths are padded to the global max
    so every shard has the same shape.

    Returns ``(ell_vals, ell_cols, rows_pad, cols_pad)`` with arrays of shape
    ``(nr, nc, rows_pad/nr, W)`` sharded ``P(rows, cols, None, None)``.
    """
    ra, ca = mesh.axis_names
    nr, nc = mesh.shape[ra], mesh.shape[ca]
    rows_pad = -(-m.rows // nr) * nr
    cols_pad = -(-m.cols // nc) * nc
    sr, sc = rows_pad // nr, cols_pad // nc

    r = m.row_ids().astype(np.int64)
    c = m.indices.astype(np.int64)
    evs, ecs, w = [], [], 1
    for i in range(nr):
        row_e, row_c = [], []
        for j in range(nc):
            mask = (r // sr == i) & (c // sc == j)
            offsets = np.zeros(sr + 1, dtype=np.int64)
            np.add.at(offsets, (r[mask] - i * sr) + 1, 1)
            np.cumsum(offsets, out=offsets)
            sub = CsrMatrix(
                sr, sc, m.vals[mask], (c[mask] - j * sc).astype(np.uint32),
                offsets, is_sorted=m.is_sorted,
            )
            ev, ec = ell_from_csr(sub, dtype=dtype)
            row_e.append(ev)
            row_c.append(ec)
            w = max(w, ev.shape[1])
        evs.append(row_e)
        ecs.append(row_c)
    ev4 = np.zeros((nr, nc, sr, w), dtype=dtype)
    ec4 = np.zeros((nr, nc, sr, w), dtype=np.int32)
    for i in range(nr):
        for j in range(nc):
            e, k = evs[i][j], ecs[i][j]
            ev4[i, j, :, : e.shape[1]] = e
            ec4[i, j, :, : k.shape[1]] = k
    sh = NamedSharding(mesh, P(ra, ca, None, None))
    return (
        jax.device_put(jnp.asarray(ev4), sh),
        jax.device_put(jnp.asarray(ec4), sh),
        rows_pad,
        cols_pad,
    )


def dist_spmm_2d(ell_vals4, ell_cols4, x, mesh: Mesh):
    """Y = A @ X on the 2-D mesh.

    ``x``: (cols_pad, F) sharded ``P(cols, None)`` (replicated over rows).
    Returns (rows_pad, F) sharded ``P(rows, None)`` (replicated over cols,
    via a psum of partial blocks over the cols axis).
    """
    from jax import shard_map

    ra, ca = mesh.axis_names

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(ra, ca, None, None), P(ra, ca, None, None), P(ca, None)),
        out_specs=P(ra, None),
    )
    def _spmm(ev, ec, x_shard):
        # local block SpMM: (sr, W) ELL against the local (sc, F) X shard
        gathered = x_shard[ec[0, 0]]            # (sr, W, F)
        y_part = jnp.einsum("rw,rwf->rf", ev[0, 0], gathered)
        return jax.lax.psum(y_part, ca)

    return _spmm(ell_vals4, ell_cols4, x)

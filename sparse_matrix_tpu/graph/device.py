"""Device shortest paths: tropical-semiring relaxation on banded graphs.

One Bellman-Ford relaxation is an SpMV in the (min, +) semiring:
``dist'[i] = min(dist[i], min_j (w(j->i) + dist[j]))``. There is no matrix-unit
for (min, +), but for banded adjacency the DIA static-slice recipe
(``ops/spmv_dia.py`` — every x-read a statically offset contiguous slice,
no gathers) applies verbatim on the VPU: absent band slots hold ``+inf``
(the semiring zero), so one padded window per band relaxes every node at
once, and the whole multi-source frontier ``(n, S)`` relaxes in the same
pass. Grid/mesh graphs — the structures this framework's corpus is built
around — are exactly the banded case.

The iteration runs in ONE jitted ``lax.while_loop`` until a fixpoint
(bounded by ``n`` sweeps, the negative-cycle certificate), so a k-diameter
graph costs k fused VPU sweeps with no host round-trips. Host Dijkstra
(``graph/csgraph.py``) keeps the irregular/general case, mirroring the
framework's host/device split (reference ``spam_csr/src/mul_hash.rs``
keeps irregular kernels host-side the same way).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import CsrMatrix
from .csgraph import NegativeCycleError, _check_square

__all__ = [
    "BandedGraphPlan",
    "banded_graph_plan",
    "bellman_ford_device",
    "floyd_warshall_device",
]

# Matching the DIA SpMV accept window (formats/dia.py MAX_BANDS is tighter
# because DIA competes against other *sum* formats; min-plus has no
# alternative device format, so it accepts wider bands before giving up).
_MAX_BANDS = 96
_MIN_FILL = 0.05


@dataclass(frozen=True)
class BandedGraphPlan:
    """In-edge band table: ``data[k, i] = w(i + offsets[k] -> i)``, +inf
    where no edge exists (+inf is the (min, +) semiring's zero, exactly as
    0.0 is the (+, *) semiring's — the DIA zero-fill convention carried
    over)."""

    n: int
    offsets: Tuple[int, ...]
    data: np.ndarray  # (nb, n) float32, +inf absent fill


def banded_graph_plan(
    a: CsrMatrix, *, max_bands: int = _MAX_BANDS, min_fill: float = _MIN_FILL
) -> Optional[BandedGraphPlan]:
    """Build the in-edge band table, or None when the graph isn't banded
    enough to pay (same accept shape as ``formats/dia.try_dia_from_csr``,
    relaxed because there is no competing device format for (min, +))."""
    n = _check_square(a)
    if a.nnz() == 0:
        return None
    # in-edges of i live in column i: band over A^T
    at = a.transpose()
    r = np.repeat(np.arange(n, dtype=np.int64), np.diff(at.offsets))
    c = at.indices.astype(np.int64)
    offs = np.unique(c - r)
    if len(offs) > max_bands:
        return None
    if at.nnz() < min_fill * len(offs) * n:
        return None
    data = np.full((len(offs), n), np.inf, dtype=np.float32)
    k = np.searchsorted(offs, c - r)
    data[k, r] = at.vals.astype(np.float32)
    return BandedGraphPlan(n=n, offsets=tuple(int(o) for o in offs), data=data)


@functools.partial(jax.jit, static_argnames=("offsets", "n", "max_iters"))
def _bf_loop(data, dist0, *, offsets: tuple, n: int, max_iters: int):
    lo = -min(0, min(offsets))
    hi = max(0, max(offsets))
    inf = jnp.asarray(jnp.inf, dist0.dtype)

    def relax(dist):
        # (lo | dist | hi) padding makes every band read a static slice
        padded = jnp.concatenate(
            [
                jnp.full((lo, dist.shape[1]), inf, dist.dtype),
                dist,
                jnp.full((hi, dist.shape[1]), inf, dist.dtype),
            ],
            axis=0,
        )
        new = dist
        for k, off in enumerate(offsets):
            win = jax.lax.dynamic_slice(
                padded, (lo + off, 0), (n, dist.shape[1])
            )
            new = jnp.minimum(new, data[k][:, None] + win)
        return new

    def cond(carry):
        _dist, changed, it = carry
        return changed & (it < max_iters)

    def body(carry):
        dist, _changed, it = carry
        new = relax(dist)
        return new, jnp.any(new < dist), it + 1

    # prime with one relaxation so `changed` starts meaningful
    first = relax(dist0)
    dist, changed, iters = jax.lax.while_loop(
        cond, body, (first, jnp.any(first < dist0), jnp.int32(1))
    )
    return dist, changed, iters


def bellman_ford_device(
    plan_or_matrix, indices, *, max_iters: Optional[int] = None
):
    """Multi-source Bellman-Ford on the banded device path.

    ``indices`` is an array of source nodes; returns float64
    ``(len(indices), n)`` distances (computed f32 on device — document
    per docs/DTYPES.md). Raises :class:`NegativeCycleError` when the
    fixpoint hasn't settled after ``n`` sweeps with improvements still
    flowing (the standard certificate).
    """
    plan = (
        plan_or_matrix
        if isinstance(plan_or_matrix, BandedGraphPlan)
        else banded_graph_plan(plan_or_matrix)
    )
    if plan is None:
        raise ValueError("graph is not banded enough for the device path")
    n = plan.n
    src = np.atleast_1d(np.asarray(indices, dtype=np.int64))
    dist0 = np.full((n, len(src)), np.inf, dtype=np.float32)
    dist0[src, np.arange(len(src))] = 0.0
    cap = int(max_iters) if max_iters is not None else n
    dist, changed, _iters = _bf_loop(
        jnp.asarray(plan.data),
        jnp.asarray(dist0),
        offsets=plan.offsets,
        n=n,
        max_iters=cap,
    )
    if max_iters is None and bool(changed):
        raise NegativeCycleError("negative-weight cycle reachable from sources")
    return np.asarray(dist, dtype=np.float64).T


@functools.partial(jax.jit, static_argnames=("n",))
def _fw_loop(d0, *, n: int):
    def body(k, d):
        # d = min(d, d[:, k, None] + d[None, k, :]) — one rank-1 tropical
        # outer "product" per pivot, n^2 work per step on the VPU
        return jnp.minimum(d, d[:, k][:, None] + d[k, :][None, :])

    return jax.lax.fori_loop(0, n, body, d0)


def _fw_loop_pred(d0, p0, *, n: int):
    def body(k, dp):
        d, p = dp
        cand = d[:, k][:, None] + d[k, :][None, :]
        take = cand < d  # strict improvement, scipy tie-breaking
        return jnp.where(take, cand, d), jnp.where(take, p[k, :][None, :], p)

    return jax.lax.fori_loop(0, n, body, (d0, p0))


def floyd_warshall_device(a: CsrMatrix, return_predecessors: bool = False):
    """All-pairs shortest paths, dense Floyd-Warshall on device: n fused
    rank-1 (min, +) updates in one ``lax.fori_loop`` — the tropical analog
    of a blocked dense factorization, sized for n up to a few thousand
    (n^2 floats resident). ``return_predecessors`` carries the int32
    predecessor matrix through the same loop (``pred[i, j] <- pred[k, j]``
    on strict improvement, scipy semantics/sentinel -9999). Negative
    cycles are reported when any diagonal goes negative. scipy parity:
    ``scipy.sparse.csgraph.floyd_warshall``."""
    n = _check_square(a)
    d0 = np.full((n, n), np.inf, dtype=np.float32)
    r = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.offsets))
    c = a.indices.astype(np.int64)
    # duplicate-free CSR, but parallel edges after symmetrization are the
    # caller's concern; keep the min to be safe
    np.minimum.at(d0, (r, c), a.vals.astype(np.float32))
    np.fill_diagonal(d0, np.minimum(d0.diagonal(), 0.0))
    if not return_predecessors:
        dist = np.asarray(_fw_loop(jnp.asarray(d0), n=n), dtype=np.float64)
        if np.any(np.diagonal(dist) < 0):
            raise NegativeCycleError("negative-weight cycle present")
        return dist
    p0 = np.full((n, n), -9999, dtype=np.int32)
    p0[r, c] = r.astype(np.int32)
    np.fill_diagonal(p0, -9999)
    dist, pred = _fw_loop_pred(jnp.asarray(d0), jnp.asarray(p0), n=n)
    dist = np.asarray(dist, dtype=np.float64)
    if np.any(np.diagonal(dist) < 0):
        raise NegativeCycleError("negative-weight cycle present")
    return dist, np.asarray(pred)

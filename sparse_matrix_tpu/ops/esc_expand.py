"""k-major product expansion for ESC SpGEMM.

The sparsity pattern is static, so the expansion's index streams are plan
data. This module reorders the products k-major (contraction index major:
for each k, rhs row-k entries major, lhs col-k entries minor), which makes
BOTH operand streams window-local:

* the lhs values, stored CSC-permuted, are read per chunk of 128 products
  from ONE (kw, 128) window + a lane gather;
* the rhs values of consecutive k are CONTIGUOUS in CSR storage — same
  window treatment.

The packed int32 sort key (out_row * cols + out_col) is host-precomputed
(static pattern), so the main sort + compaction run the 1-key packed path.

Capability gates (fall back to the XLA-gather engine): the key must fit
int32 ((rows+1)*cols < 2^31) and operand windows must stay within
``_MAX_KW`` rows of 128.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import CsrMatrix
from ..formats.lanepack import LANES, SUBLANES

__all__ = ["ExpandPlan", "plan_expand_kmajor", "expand_products"]

# plan-size limit: per-chunk operand window rows (lane positions must fit
# int16). Inherited from the first target's on-chip slice budget.
_MAX_KW = 64


class ExpandPlan(NamedTuple):
    """k-major expansion plan. ``S`` slabs of (8,128) product slots.

    ``lv_lane``/``rv_lane`` (S,8,128) int16: operand position within the
    chunk's window; ``lv_off``/``rv_off`` (S*8,) int32 window rows into
    the operand arrays (viewed as (*,128)); ``out_key`` (S*8*128,) int32
    packed ``row*cols+col`` (sentinel rows*cols on padding); ``perm_csc``
    lhs CSR->CSC value permutation; ``valid`` per-slot mask baked into
    zero lv lanes + sentinel keys.
    """

    rows: int
    cols: int
    num_products: int
    kw_lv: int
    kw_rv: int
    lv_lane: np.ndarray
    rv_lane: np.ndarray
    lv_off: np.ndarray
    rv_off: np.ndarray
    out_key: np.ndarray
    perm_csc: np.ndarray

    @property
    def num_slabs(self) -> int:
        return int(self.lv_lane.shape[0])


def plan_expand_kmajor(lhs: CsrMatrix, rhs: CsrMatrix):
    """Build the k-major expansion plan, or None when a capability gate
    fails (caller falls back to the XLA-gather engine)."""
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    rows, cols = lhs.rows, rhs.cols
    if (rows + 1) * cols >= (1 << 31):
        return None

    # lhs in CSC order: entries sorted by (col, row)
    lr = lhs.row_ids().astype(np.int64)
    lc = lhs.indices.astype(np.int64)
    perm_csc = np.lexsort((lr, lc))
    lc_s = lc[perm_csc]
    lr_s = lr[perm_csc]

    # per-k segments: lhs CSC [la, la+lk), rhs CSR [ra, ra+rk)
    k_space = lhs.cols
    lk = np.bincount(lc_s, minlength=k_space)
    la = np.zeros(k_space, dtype=np.int64)
    np.cumsum(lk[:-1], out=la[1:])
    rk = np.diff(rhs.offsets).astype(np.int64)
    ra = rhs.offsets[:-1].astype(np.int64)

    nk = lk * rk
    n = int(nk.sum())
    if n == 0:
        return None
    start = np.zeros(k_space, dtype=np.int64)
    np.cumsum(nk[:-1], out=start[1:])
    ks = np.nonzero(nk)[0]
    k_of = np.repeat(ks, nk[ks])
    within = np.arange(n, dtype=np.int64) - start[k_of]
    lkk = lk[k_of]
    e_of = ra[k_of] + within // lkk  # rhs entry position (rhs-entry major)
    a_of = la[k_of] + within % lkk  # lhs CSC position

    out_key = (lr_s[a_of] * cols + rhs.indices.astype(np.int64)[e_of]).astype(
        np.int32)

    # chunking: 128 consecutive products per chunk; per-chunk operand
    # windows from the chunk's own min position (the select-mode trick)
    num_chunks = -(-n // LANES)
    n_pad = num_chunks * LANES
    chunk_id = np.arange(n, dtype=np.int64) // LANES
    heads = np.arange(num_chunks, dtype=np.int64) * LANES

    def windows(pos):
        lo = np.minimum.reduceat(pos, heads) >> 7
        lane = pos - (lo[chunk_id] << 7)
        kw = int(np.max(pos // LANES - lo[chunk_id]) + 1) if n else 1
        return lo.astype(np.int32), lane.astype(np.int16), kw

    lv_off_c, lv_lane_f, kw_lv = windows(a_of)
    rv_off_c, rv_lane_f, kw_rv = windows(e_of)
    if kw_lv > _MAX_KW or kw_rv > _MAX_KW:
        return None

    num_slabs = -(-num_chunks // SUBLANES)
    lv_lane = np.zeros((num_slabs, SUBLANES, LANES), dtype=np.int16)
    rv_lane = np.zeros((num_slabs, SUBLANES, LANES), dtype=np.int16)
    lv_lane.reshape(-1)[:n] = lv_lane_f
    rv_lane.reshape(-1)[:n] = rv_lane_f
    lv_off = np.zeros(num_slabs * SUBLANES, dtype=np.int32)
    rv_off = np.zeros(num_slabs * SUBLANES, dtype=np.int32)
    lv_off[:num_chunks] = lv_off_c
    rv_off[:num_chunks] = rv_off_c

    key_pad = np.full(num_slabs * SUBLANES * LANES, rows * cols,
                      dtype=np.int32)
    key_pad[:n] = out_key
    # padding slots gather lane 0 of their chunk's window; their product
    # is keyed to the sentinel row and dropped after the reduce
    return ExpandPlan(
        rows=rows, cols=cols, num_products=n, kw_lv=kw_lv, kw_rv=kw_rv,
        lv_lane=lv_lane, rv_lane=rv_lane, lv_off=lv_off, rv_off=rv_off,
        out_key=key_pad, perm_csc=perm_csc.astype(np.int64),
    )


def _pick_b(num_slabs: int) -> int:
    # slab padding granularity of the plan arrays
    for cand in (64, 32, 16, 8, 4, 2):
        if num_slabs >= cand * 8:
            return cand
    return 1


@functools.partial(jax.jit, static_argnames=("kw_lv", "kw_rv"))
def _expand_jit(lv_pad, rv_pad, lv_lane, rv_lane, lv_off, rv_off, *,
                kw_lv: int, kw_rv: int):
    num_slabs = lv_lane.shape[0]
    s8 = num_slabs * SUBLANES
    co_l = lv_off.astype(jnp.int32)
    co_r = rv_off.astype(jnp.int32)
    wl = lv_pad[co_l[:, None] + jnp.arange(kw_lv)[None, :]].reshape(
        s8, kw_lv * LANES)
    wr = rv_pad[co_r[:, None] + jnp.arange(kw_rv)[None, :]].reshape(
        s8, kw_rv * LANES)
    lv = jnp.take_along_axis(
        wl, lv_lane.reshape(s8, LANES).astype(jnp.int32), axis=1)
    rv = jnp.take_along_axis(
        wr, rv_lane.reshape(s8, LANES).astype(jnp.int32), axis=1)
    return (lv * rv).reshape(num_slabs, SUBLANES, LANES)


def expand_device_arrays(plan: ExpandPlan):
    """The plan's slab/offset arrays on device, padded to whole B-slab
    steps — reusable across calls, and passable as jit ARGUMENTS so
    chained callers don't embed them as program constants (see
    EscSpgemm.as_pytree)."""
    from ..utils.transfer import to_device

    b = _pick_b(plan.num_slabs)
    s = plan.num_slabs
    sp = max(b, -(-s // b) * b)

    def pad_slab(a):
        if a.shape[0] == sp:
            return to_device(a)
        out = np.zeros((sp,) + a.shape[1:], dtype=a.dtype)
        out[: a.shape[0]] = a
        return to_device(out)

    def pad_off(a):
        out = np.zeros(sp * SUBLANES, dtype=np.int32)
        out[: len(a)] = a
        return to_device(out)

    return dict(
        lv_lane=pad_slab(plan.lv_lane), rv_lane=pad_slab(plan.rv_lane),
        lv_off=pad_off(plan.lv_off), rv_off=pad_off(plan.rv_off),
    )


def expand_products(plan: ExpandPlan, lv_csc, rv, *, device_arrays=None):
    """All intermediate products in plan order, padded to (S,8,128).

    ``lv_csc`` = lhs values already CSC-permuted (``vals[plan.perm_csc]``);
    ``rv`` = rhs values in CSR order. Both are padded to whole 128-lane
    rows here. ``device_arrays`` = a cached/threaded
    :func:`expand_device_arrays` dict.
    """
    s = plan.num_slabs

    def pad_vals(v, kw):
        r = -(-v.shape[0] // LANES) + kw
        out = jnp.zeros(r * LANES, v.dtype).at[: v.shape[0]].set(v)
        return out.reshape(r, LANES)

    arrs = device_arrays if device_arrays is not None else (
        expand_device_arrays(plan))
    p = _expand_jit(
        pad_vals(lv_csc, plan.kw_lv), pad_vals(rv, plan.kw_rv),
        arrs["lv_lane"], arrs["rv_lane"], arrs["lv_off"], arrs["rv_off"],
        kw_lv=plan.kw_lv, kw_rv=plan.kw_rv,
    )
    return p.reshape(-1)[: s * SUBLANES * LANES]

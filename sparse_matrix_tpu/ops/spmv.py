"""SpMV over the planned slab formats, evaluated by XLA.

* :func:`spmv_lanepack` — a
  :class:`~sparse_matrix_tpu.formats.lanepack.LanePackPlan` (see that module's
  docstring for the format design): per chunk of 128 slots, gather x from
  the chunk's column window, multiply, prefix-sum along the chunk, take the
  run sums at host-planned boundaries, and scatter-add them by row block.
* :func:`spmv_aligned` / :func:`spmv_stripe` — the destination-aligned and
  multi-level slab formats (formats/aligned.py, formats/stripe.py).
* :func:`spmv_ell_xla` — padded-ELL gather+reduce; any sharding; the
  multi-chip building block and correctness baseline.
* :func:`spmv_oracle` — numpy CSR row loop; the test oracle.

New scope vs the reference (which has no SpMV), per the project north star.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import CsrMatrix
from ..formats.lanepack import LANES, SUBLANES, LanePackPlan
from ..utils.transfer import to_device

__all__ = [
    "spmv_lanepack",
    "lanepack_device_arrays",
    "spmv_aligned",
    "aligned_device_arrays",
    "spmv_stripe",
    "stripe_device_arrays",
    "spmv_ell_xla",
    "ell_from_csr",
    "spmv_oracle",
]


def _pick_b(num_slabs: int) -> int:
    # padding granularity of the slab arrays (plans are padded to a whole
    # number of B-slab steps; padding slabs hold zeros)
    for cand in (64, 32, 16, 8, 4, 2):
        if num_slabs >= cand * 8:
            return cand
    return 1


def lanepack_device_arrays(plan: LanePackPlan, *, b: Optional[int] = None):
    """Move a plan's arrays to device once, padded to a whole number of
    B-slab steps; reusable across calls (CG passes this once per solve)."""
    b = b if b is not None else _pick_b(plan.num_slabs)
    s = plan.num_slabs
    sp = max(b, -(-s // b) * b)

    def pad(a):
        if a.shape[0] == sp:
            return to_device(a)
        out = np.zeros((sp,) + a.shape[1:], dtype=a.dtype)
        out[: a.shape[0]] = a
        return to_device(out)

    def pad1(a, fill, n):
        out = np.full(n, fill, dtype=np.int32)
        out[: min(len(a), n)] = a[:n] if len(a) >= n else a
        return to_device(out)

    # padding slabs hold zero values; they accumulate 0 into block 0
    return dict(
        b=b,
        vals=pad(plan.vals),
        lane=pad(plan.lane),
        ends=pad(plan.ends),
        starts=pad(plan.starts),
        rb_a=pad1(plan.rb_a[:s], 0, sp),
        rb_b=pad1(plan.rb_b[:s], 0, sp),
        split=pad1(plan.split[:s], SUBLANES, sp),
        chunk_rb=pad1(plan.chunk_rb[: s * SUBLANES], 0, sp * SUBLANES),
        col_off=pad1(plan.col_off[: s * SUBLANES], 0, sp * SUBLANES),
        rb_mask=jnp.asarray(plan.rb_mask),
    )


@functools.partial(jax.jit, static_argnames=("rows", "cols", "kw"))
def _spmv_lanepack_jit(arrs, x, *, rows: int, cols: int, kw: int):
    """XLA evaluation of a LanePack plan: per chunk, gather x from the
    chunk's window, multiply, prefix-sum, take the run sums at the
    planned boundaries, scatter-add by row block."""
    c128 = -(-cols // LANES)
    # pad x; add KW guard rows so window slices never run off the end
    xpad = jnp.zeros((c128 + kw) * LANES, x.dtype).at[: x.shape[0]].set(x)
    x2d = xpad.reshape(c128 + kw, LANES)
    s8 = arrs["vals"].shape[0] * SUBLANES
    vals = arrs["vals"].reshape(s8, LANES)
    lane = arrs["lane"].reshape(s8, LANES).astype(jnp.int32)
    ends = arrs["ends"].reshape(s8, LANES).astype(jnp.int32)
    starts = arrs["starts"].reshape(s8, LANES).astype(jnp.int32)
    co = arrs["col_off"].astype(jnp.int32)

    win = x2d[co[:, None] + jnp.arange(kw)[None, :]].reshape(s8, kw * LANES)
    xg = jnp.take_along_axis(win, lane, axis=1)
    p = vals * xg
    c = jnp.cumsum(p, axis=1)
    g_end = jnp.take_along_axis(c, ends, axis=1)
    g_start = jnp.where(
        starts < 0, 0.0, jnp.take_along_axis(c, jnp.maximum(starts, 0), axis=1)
    )
    contrib = g_end - g_start  # (S*8, 128), per chunk
    r128 = arrs["rb_mask"].shape[0]
    y2d = jnp.zeros((r128, LANES), vals.dtype).at[arrs["chunk_rb"]].add(contrib)
    y2d = jnp.where(arrs["rb_mask"][:, None] > 0, y2d, 0.0)
    return y2d.reshape(-1)[:rows]


# plan-size limit (columns) of the LanePack/aligned/stripe plans:
# SpmvOperator column-splits wider general operators into shards, which
# bounds each plan and its planning time. Inherited from the first
# target's on-chip memory budget; not re-tuned for the GPU.
_VMEM_X_LIMIT = 10_000_000


def _cast_x(x, plan_dtype, allow_downcast):
    """Cast ``x`` to the plan's dtype, refusing silent precision loss.

    A float64/complex128 vector reaching a float32 plan used to truncate
    with only a warning; for a library whose accuracy layer is
    precision-bound (Higham-u parameterized, core/accuracy.py) that is a
    correctness hazard. Callers that really want the downcast pass
    ``allow_downcast=True`` or convert explicitly first.
    """
    in_dt = np.dtype(x.dtype) if hasattr(x, "dtype") else np.asarray(x).dtype
    out_dt = np.dtype(plan_dtype)
    if (
        not allow_downcast
        and in_dt.kind in ("f", "c")
        and out_dt.kind in ("f", "c")
        and in_dt.itemsize > out_dt.itemsize
    ):
        raise TypeError(
            f"x has dtype {in_dt} but the plan is {out_dt}: refusing the "
            "silent precision loss. Build the operator with "
            f"dtype={in_dt}, cast x yourself, or pass allow_downcast=True."
        )
    return jnp.asarray(x, dtype=plan_dtype)


def spmv_lanepack(plan: LanePackPlan, x, *, device_arrays=None, allow_downcast=False):
    """y = A @ x over a LanePack plan.

    Plans are bounded by the slab-count and column plan-size limits;
    SpmvOperator shards larger operators automatically.
    """
    if plan.num_slabs * 8 * 4 > 900_000:
        raise ValueError(
            f"LanePack plan has {plan.num_slabs} slabs, over the plan-size "
            "limit — use the ELL path or SpmvOperator (which guards this "
            "automatically)"
        )
    if plan.cols > _VMEM_X_LIMIT:
        raise ValueError(
            f"LanePack plan has cols={plan.cols}, over the "
            f"{_VMEM_X_LIMIT} plan-size limit — use spmv_ell_xla or shard"
        )
    arrs = device_arrays if device_arrays is not None else lanepack_device_arrays(plan)
    x = _cast_x(x, plan.dtype, allow_downcast)
    return _spmv_lanepack_jit(
        {k: v for k, v in arrs.items() if k != "b"},
        x,
        rows=plan.rows,
        cols=plan.cols,
        kw=plan.kw,
    )


# ---------------------------------------------------------------------------
# Aligned slabs (destination-aligned slots; formats/aligned.py)
# ---------------------------------------------------------------------------


# plan-size limit: aligned plans above this many slabs are applied as
# uniform segments of at most this size (one compilation, partial y's
# summed). Inherited from the first target's on-chip scalar-memory budget.
_SMEM_SLAB_SEGMENT = 16384


def aligned_device_arrays(plan, *, b: Optional[int] = None):
    """Device arrays for an :class:`~..formats.aligned.AlignedPlan`, padded
    to whole B-slab steps; includes the spill sub-plan's arrays when one
    exists.

    Plans beyond the segment limit are split into uniform
    slab segments (key ``"segments"``): one kernel compilation, several
    calls per apply, partial y's summed by :func:`spmv_aligned`."""
    b = b if b is not None else _pick_b(plan.num_slabs)
    s = plan.num_slabs

    def build(lo: int, hi: int, sp: int):
        def pad(a):
            seg = a[lo:hi]  # first-axis slice: contiguous view, no copy
            if sp == hi - lo:
                return to_device(seg)
            tail = np.zeros((sp - (hi - lo),) + a.shape[1:], dtype=a.dtype)
            return to_device(np.concatenate([seg, tail]))

        def pad1(a, fill, scale=1):
            out = np.full(sp * scale, fill, dtype=np.int32)
            out[: (hi - lo) * scale] = a[lo * scale : hi * scale]
            return to_device(out)

        return dict(
            vals=pad(plan.vals),
            lane=pad(plan.lane),
            rb_a=pad1(plan.rb_a, 0),
            rb_b=pad1(plan.rb_b, 0),
            split=pad1(plan.split, SUBLANES),
            chunk_rb=pad1(plan.chunk_rb, 0, SUBLANES),
            col_off=pad1(plan.col_off, 0, SUBLANES),
            rb_mask=jnp.asarray(plan.rb_mask),
        )

    arrs = dict(b=b)
    if s <= _SMEM_SLAB_SEGMENT:
        sp = max(b, -(-s // b) * b)
        arrs.update(build(0, s, sp))
    else:
        nseg = -(-s // _SMEM_SLAB_SEGMENT)
        per_seg = -(-s // nseg)
        seg = -(-per_seg // b) * b  # uniform, b-aligned segment size
        arrs["segments"] = [
            build(lo, min(s, lo + seg), seg) for lo in range(0, s, seg)
        ]
    if plan.spill is not None:
        arrs["spill"] = lanepack_device_arrays(plan.spill)
    return arrs


@functools.partial(jax.jit, static_argnames=("rows", "cols"))
def _spmv_aligned_jit(arrs, x, *, rows: int, cols: int):
    """XLA evaluation of an aligned plan: per-chunk contributions
    scatter-added by chunk row block."""
    c128 = -(-cols // LANES)
    xpad = jnp.zeros((c128 + 1) * LANES, x.dtype).at[: x.shape[0]].set(x)
    x2d = xpad.reshape(c128 + 1, LANES)
    s8 = arrs["vals"].shape[0] * SUBLANES
    vals = arrs["vals"].reshape(s8, LANES)
    lane = arrs["lane"].reshape(s8, LANES).astype(jnp.int32)
    co = arrs["col_off"].astype(jnp.int32)
    xw = x2d[co]  # (s8, 128)
    p = vals * jnp.take_along_axis(xw, lane, axis=1)
    r128 = arrs["rb_mask"].shape[0]
    y2d = jnp.zeros((r128, LANES), vals.dtype).at[arrs["chunk_rb"]].add(p)
    y2d = jnp.where(arrs["rb_mask"][:, None] > 0, y2d, 0.0)
    return y2d.reshape(-1)[:rows]


def spmv_aligned(plan, x, *, device_arrays=None, allow_downcast=False):
    """y = A @ x over an aligned plan (+ LanePack on the spill sub-plan
    when the plan has one). Plans beyond the segment limit run as several
    uniform slab segments (one compilation). See formats/aligned.py."""
    if plan.cols > _VMEM_X_LIMIT:
        raise ValueError(
            f"aligned plan has cols={plan.cols}, over the {_VMEM_X_LIMIT} "
            "plan-size limit — use spmv_ell_xla or shard"
        )
    arrs = device_arrays if device_arrays is not None else aligned_device_arrays(plan)
    x = _cast_x(x, plan.dtype, allow_downcast)

    def one(seg):
        return _spmv_aligned_jit(
            {k: v for k, v in seg.items() if k not in ("b", "spill")},
            x,
            rows=plan.rows,
            cols=plan.cols,
        )

    if "segments" in arrs:
        y = one(arrs["segments"][0])
        for seg in arrs["segments"][1:]:
            y = y + one(seg)
    else:
        y = one(arrs)
    if plan.spill is not None:
        sp_arrs = arrs.get("spill")
        if sp_arrs is None:
            sp_arrs = lanepack_device_arrays(plan.spill)
        y = y + _spmv_lanepack_jit(
            {k: v for k, v in sp_arrs.items() if k != "b"},
            x,
            rows=plan.rows,
            cols=plan.cols,
            kw=plan.spill.kw,
        )
    return y


# ---------------------------------------------------------------------------
# Stripe slabs (multi-level destinations; formats/stripe.py)
# ---------------------------------------------------------------------------


def stripe_device_arrays(plan, *, b: Optional[int] = None):
    """Device arrays for a :class:`~..formats.stripe.StripePlan`, padded to
    whole B-slab steps (padding slabs are all-zero: ends=starts=0 gathers
    cancel, and they accumulate a zero tile into row block 0)."""
    b = b if b is not None else _pick_b(plan.num_slabs)
    s = plan.num_slabs
    sp = max(b, -(-s // b) * b)

    def pad(a):
        if a.shape[0] == sp:
            return to_device(a)
        out = np.zeros((sp,) + a.shape[1:], dtype=a.dtype)
        out[: a.shape[0]] = a
        return to_device(out)

    def pad1(a, fill, scale=1):
        out = np.full(sp * scale, fill, dtype=np.int32)
        out[: min(len(a), s * scale)] = a[: s * scale]
        return to_device(out)

    arrs = dict(
        b=b,
        vals=pad(plan.vals),
        lane=pad(plan.lane),
        ends=pad(plan.ends),
        stripe_rb=pad1(plan.stripe_rb, 0),
        col_off=pad1(plan.col_off, 0, SUBLANES),
        chunk_stripe=pad1(plan.chunk_stripe, 0, SUBLANES),
        rb_mask=jnp.asarray(plan.rb_mask),
    )
    if plan.starts is not None:
        arrs["starts"] = pad(plan.starts)
    if plan.spill is not None:
        arrs["spill"] = stripe_device_arrays(plan.spill)
    return arrs


@functools.partial(
    jax.jit, static_argnames=("rows", "cols", "lvl", "kw", "scan"))
def _spmv_stripe_jit(arrs, x, *, rows: int, cols: int, lvl: int, kw: int,
                     scan: bool):
    """XLA evaluation of a stripe plan: per level, the run sums of each
    chunk scatter-added to the level's row block."""
    c128 = -(-cols // LANES)
    xpad = jnp.zeros((c128 + kw) * LANES, x.dtype).at[: x.shape[0]].set(x)
    x2d = xpad.reshape(c128 + kw, LANES)
    s8 = arrs["vals"].shape[0] * SUBLANES
    vals = arrs["vals"].reshape(s8, LANES)
    lane = arrs["lane"].reshape(s8, LANES).astype(jnp.int32)
    ends = arrs["ends"].transpose(0, 2, 1, 3).reshape(s8, lvl, LANES)
    co = arrs["col_off"].astype(jnp.int32)
    win = x2d[co[:, None] + jnp.arange(kw)[None, :]].reshape(s8, kw * LANES)
    p = vals * jnp.take_along_axis(win, lane, axis=1)
    if scan:
        starts = arrs["starts"].transpose(0, 2, 1, 3).reshape(s8, lvl, LANES)
        c = jnp.cumsum(p, axis=1)
    r128p = arrs["rb_mask"].shape[0]
    y2d = jnp.zeros((r128p, LANES), vals.dtype)
    for l in range(lvl):
        e = ends[:, l].astype(jnp.int32)
        if scan:
            st = starts[:, l].astype(jnp.int32)
            g_end = jnp.take_along_axis(c, e, axis=1)
            g_start = jnp.where(
                st < 0, 0.0,
                jnp.take_along_axis(c, jnp.maximum(st, 0), axis=1))
            g = g_end - g_start
        else:
            g = jnp.take_along_axis(p, e, axis=1)
        rb = arrs["chunk_stripe"].astype(jnp.int32) * lvl + l
        y2d = y2d.at[rb].add(g)
    y2d = jnp.where(arrs["rb_mask"][:, None] > 0, y2d, 0.0)
    return y2d.reshape(-1)[:rows]


def spmv_stripe(plan, x, *, device_arrays=None, allow_downcast=False):
    """y = A @ x over a stripe plan (multi-level destinations; the
    no-locality path) + the stripe plan of the collision spill when the
    plan has one. See formats/stripe.py for the design."""
    if plan.cols > _VMEM_X_LIMIT:
        raise ValueError(
            f"stripe plan has cols={plan.cols}, over the {_VMEM_X_LIMIT} "
            "plan-size limit — use spmv_ell_xla or shard")
    if plan.num_slabs * SUBLANES * 4 > 900_000:
        raise ValueError(
            f"stripe plan has {plan.num_slabs} slabs, over the plan-size "
            "limit — use SpmvOperator (guards automatically)")
    arrs = device_arrays if device_arrays is not None else stripe_device_arrays(plan)
    x = _cast_x(x, plan.dtype, allow_downcast)
    y = _spmv_stripe_jit(
        {k: v for k, v in arrs.items() if k not in ("b", "spill")},
        x,
        rows=plan.rows,
        cols=plan.cols,
        lvl=plan.levels,
        kw=plan.kw,
        scan=plan.mode == "scan",
    )
    if plan.spill is not None:
        sp_arrs = arrs.get("spill")
        if sp_arrs is None:
            sp_arrs = stripe_device_arrays(plan.spill)
        y = y + spmv_stripe(plan.spill, x, device_arrays=sp_arrs,
                            allow_downcast=allow_downcast)
    return y


# ---------------------------------------------------------------------------
# Padded ELL
# ---------------------------------------------------------------------------


def ell_from_csr(m: CsrMatrix, *, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Pad rows to the max row length: (rows, W) vals + col indices.
    Pad slots point at column 0 with value 0."""
    row_nnz = np.diff(m.offsets)
    w = max(1, int(row_nnz.max())) if m.nnz() else 1
    ell_vals = np.zeros((m.rows, w), dtype=dtype)
    ell_cols = np.zeros((m.rows, w), dtype=np.int32)
    r = m.row_ids()
    k = np.arange(m.nnz()) - m.offsets[:-1].astype(np.int64)[r]
    ell_vals[r, k] = m.vals.astype(dtype)
    ell_cols[r, k] = m.indices.astype(np.int32)
    return ell_vals, ell_cols


def ell_spill_from_csr(m: CsrMatrix, *, dtype=np.float32, max_width: int = None):
    """Width-capped ELL + COO spill (the cuSPARSE-HYB idea for row skew).

    One dense row must not inflate the padded array to rows x max_row_nnz:
    rows keep their first ``max_width`` entries in the ELL part, the tail of
    outlier rows spills to COO triplets handled by a small scatter-add.
    ``max_width=None`` picks the 99th-percentile row length (doubled head
    room), so the spill stays tiny for near-uniform matrices and the ELL
    array stays compact for skewed ones.

    Returns ``(ell_vals, ell_cols, spill_rows, spill_cols, spill_vals)``.
    """
    row_nnz = np.diff(m.offsets)
    w_full = max(1, int(row_nnz.max())) if m.nnz() else 1
    if max_width is None:
        q = int(np.quantile(row_nnz, 0.99)) if m.nnz() else 1
        max_width = max(1, 2 * max(1, q))
    w = max(1, min(w_full, int(max_width)))
    r = m.row_ids()
    k = np.arange(m.nnz(), dtype=np.int64) - m.offsets[:-1].astype(np.int64)[r]
    in_ell = k < w
    ell_vals = np.zeros((m.rows, w), dtype=dtype)
    ell_cols = np.zeros((m.rows, w), dtype=np.int32)
    ell_vals[r[in_ell], k[in_ell]] = m.vals[in_ell].astype(dtype)
    ell_cols[r[in_ell], k[in_ell]] = m.indices[in_ell].astype(np.int32)
    sp = ~in_ell
    return (
        ell_vals,
        ell_cols,
        r[sp].astype(np.int32),
        m.indices[sp].astype(np.int32),
        m.vals[sp].astype(dtype),
    )


@jax.jit
def spmv_ell_xla(ell_vals, ell_cols, x):
    """y = A @ x from the padded-ELL view: gather + row reduce; no scatter."""
    return jnp.sum(ell_vals * x[ell_cols], axis=1)


@jax.jit
def spmv_ell_spill_xla(ell_vals, ell_cols, spill_rows, spill_cols, spill_vals, x):
    """Width-capped ELL SpMV + scatter-add of the (small) COO spill."""
    y = jnp.sum(ell_vals * x[ell_cols], axis=1)
    return y.at[spill_rows].add(spill_vals * x[spill_cols])


def spmv_oracle(m: CsrMatrix, x: np.ndarray) -> np.ndarray:
    """Host CSR row-loop oracle (float64 accumulation for float dtypes)."""
    y = np.zeros(m.rows, dtype=np.result_type(m.vals.dtype, x.dtype))
    for i in range(m.rows):
        lo, hi = int(m.offsets[i]), int(m.offsets[i + 1])
        acc = np.float64(0) if np.issubdtype(y.dtype, np.floating) else y.dtype.type(0)
        for kk in range(lo, hi):
            acc += m.vals[kk] * x[int(m.indices[kk])]
        y[i] = acc
    return y

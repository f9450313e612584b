"""SpMM: sparse matrix times dense multi-vector block (A @ X).

New scope beyond the reference (which is mat-mat/mat-vec-free): with
multiple right-hand sides every gathered operand is reused across the
``F`` columns.

* :func:`spmm_dia` — banded operator: static shifted slices of X, one fused
  elementwise pass per band, no indices.
* :func:`spmm_bcsr` — block-sparse operator: one batched 128x128 block
  matmul per stored block against the matching X block row, scatter-added
  by block row.
* aligned / LanePack / BELL — the packed multi-RHS forms of the slab
  formats (ops/spmv.py, ops/spmv_bell.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.bcsr import BsrMatrix
from ..formats.dia import DiaMatrix

__all__ = [
    "spmm_dia",
    "spmm_bcsr",
    "spmm_aligned",
    "spmm_aligned_packed",
    "aligned_matvec_multi",
    "spmm_bell",
    "bell_spmm_viable",
    "spmm_lanepack",
    "spmm_lanepack_packed",
    "lanepack_matvec_multi",
    "spmm_ell_xla",
    "pack_rhs",
    "unpack_rhs",
]


@functools.partial(jax.jit, static_argnames=("offsets", "rows"))
def _spmm_dia_jit(data, x, *, offsets: tuple, rows: int):
    lo = -min(0, min(offsets))
    hi = max(0, max(offsets)) + max(rows, x.shape[0])
    xpad = jnp.zeros((lo + hi, x.shape[1]), x.dtype).at[lo : lo + x.shape[0]].set(x)
    y = jnp.zeros((rows, x.shape[1]), x.dtype)
    for b, off in enumerate(offsets):
        y = y + data[b][:, None] * jax.lax.dynamic_slice(
            xpad, (lo + off, 0), (rows, x.shape[1])
        )
    return y


def spmm_dia(m: DiaMatrix, x):
    """Y = A @ X for a DIA operator; X is (cols, F)."""
    x = jnp.asarray(x)
    return _spmm_dia_jit(jnp.asarray(m.data), x, offsets=m.offsets, rows=m.rows)


@functools.partial(jax.jit, static_argnames=("brows", "bs", "precision"))
def _spmm_bcsr_jit(a_blocks, brow, bcol, x3, *, brows, bs, precision):
    f = x3.shape[2]
    prods = jnp.einsum("pij,pjk->pik", a_blocks, x3[bcol], precision=precision)
    return jnp.zeros((brows, bs, f), a_blocks.dtype).at[brow].add(prods)


# ---------------------------------------------------------------------------
# Aligned multi-RHS SpMM (general unstructured-with-locality operators)
# ---------------------------------------------------------------------------
#
# With K right-hand sides the per-chunk x-window loads amortize K-fold
# while the gather+multiply scales. The RHS block lives in a *packed*
# layout (c128+1, K, 128) — window-major, K in the middle, lanes last — so
# each chunk's window is one (K, 128) row of the leading axis. Solvers keep
# every vector in this layout (see cg_solve_multi's packed mode): the
# (n, K) <-> packed relayout happens once per solve, not per apply.

LANES = 128
SUBLANES = 8


@functools.partial(jax.jit, static_argnames=("rows",))
def _spmm_aligned_jit(arrs, x3, *, rows: int):
    """XLA evaluation of an aligned plan, packed layout."""
    s8 = arrs["vals"].shape[0] * SUBLANES
    k = x3.shape[1]
    vals = arrs["vals"].reshape(s8, 1, LANES)
    lane = arrs["lane"].reshape(s8, 1, LANES).astype(jnp.int32)
    xw = x3[arrs["col_off"].astype(jnp.int32)]  # (s8, K, 128)
    idx = jnp.broadcast_to(lane, (s8, k, LANES))
    p = vals * jnp.take_along_axis(xw, idx, axis=2)
    r128 = arrs["rb_mask"].shape[0]
    y = jnp.zeros((r128, k, LANES), vals.dtype).at[arrs["chunk_rb"]].add(p)
    return jnp.where(arrs["rb_mask"][:, None, None] > 0, y, 0.0)


def pack_rhs(x, cols: int, guard: int = 1):
    """(cols, K) -> packed (c128+guard, K, 128). The one relayout per
    solve. ``guard`` zero windows let window slices of width
    ``guard`` never run off the end (aligned uses 1; lanepack uses kw)."""
    x = jnp.asarray(x)
    k = x.shape[1]
    c128 = -(-cols // LANES)
    xpad = jnp.zeros((c128 * LANES, k), x.dtype).at[: x.shape[0]].set(x)
    x3 = jnp.transpose(xpad.reshape(c128, LANES, k), (0, 2, 1))
    return jnp.concatenate([x3, jnp.zeros((guard, k, LANES), x.dtype)], axis=0)


def unpack_rhs(y3, rows: int):
    """Packed (r128[+pad], K, 128) -> (rows, K)."""
    r128, k = y3.shape[0], y3.shape[1]
    return jnp.transpose(y3, (0, 2, 1)).reshape(r128 * LANES, k)[:rows]


def _pick_b_spmm(k: int) -> int:
    # slab padding granularity of the packed aligned arrays
    return max(8, min(64, 512 // max(1, k)))


# plan-size limit of the packed aligned SpMM: (c128+1 + 2*r128)*K*128
# floats of packed X and Y. Inherited from the first target's on-chip
# memory budget; larger problems shard or split K.
_VMEM_SPMM_LIMIT = 24_000_000  # floats


def spmm_aligned_packed(plan, x3, *, device_arrays=None, nbuf: int = 2):
    """Y = A @ X on an :class:`~..formats.aligned.AlignedPlan`, packed
    layout in AND out: ``x3`` is (c128+1, K, 128), the result is
    (r128, K, 128). Iterative multi-RHS solvers stay in this layout so the
    K-fold x-window-load amortization is free of per-apply relayouts.
    ``plan.spill`` is applied per-column via LanePack (spills are small by
    construction)."""
    from .spmv import _spmv_lanepack_jit, aligned_device_arrays, lanepack_device_arrays

    k = int(x3.shape[1])
    r128 = -(-plan.rows // LANES)
    c128 = -(-plan.cols // LANES)
    if (c128 + 1 + nbuf * r128) * k * LANES > _VMEM_SPMM_LIMIT:
        raise ValueError(
            f"aligned SpMM: (rows={plan.rows}, cols={plan.cols}, K={k}) is "
            "over the packed plan-size limit — shard over a mesh or split K"
        )
    arrs = device_arrays
    if arrs is None or arrs.get("b") != _pick_b_spmm(k):
        arrs = aligned_device_arrays(plan, b=_pick_b_spmm(k))

    def one(seg):
        return _spmm_aligned_jit(
            {kk: v for kk, v in seg.items() if kk not in ("b", "spill")},
            x3,
            rows=plan.rows,
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
        x2 = unpack_rhs(x3, plan.cols)
        cols_y = []
        for kk in range(k):
            cols_y.append(
                _spmv_lanepack_jit(
                    {a: v for a, v in sp_arrs.items() if a != "b"},
                    x2[:, kk],
                    rows=plan.rows,
                    cols=plan.cols,
                    kw=plan.spill.kw,
                )
            )
        y = y + pack_rhs(jnp.stack(cols_y, axis=1), plan.rows)[:r128]
    return y


def aligned_matvec_multi(plan, k: int, *, nbuf: int = 2):
    """Packed-layout multi-RHS matvec closure for a SQUARE aligned plan:
    (c128+1, K, 128) -> (c128+1, K, 128) (the guard row re-appended), ready
    for ``cg_solve_multi(..., rhs_axis=1)``. Device arrays are built once
    and captured."""
    from .spmv import aligned_device_arrays

    if plan.rows != plan.cols:
        raise ValueError("packed multi-RHS matvec needs a square operator")
    arrs = aligned_device_arrays(plan, b=_pick_b_spmm(k))

    def mv(x3):
        y = spmm_aligned_packed(plan, x3, device_arrays=arrs, nbuf=nbuf)
        guard = jnp.zeros((x3.shape[0] - y.shape[0], x3.shape[1], LANES), y.dtype)
        return jnp.concatenate([y, guard], axis=0)

    return mv


def spmm_aligned(plan, x, *, device_arrays=None):
    """Y = A @ X (X is (cols, K)) over an aligned plan; convenience
    wrapper over :func:`spmm_aligned_packed` paying one relayout each way.
    """
    x3 = pack_rhs(x, plan.cols)
    y3 = spmm_aligned_packed(plan, x3, device_arrays=device_arrays)
    return unpack_rhs(y3, plan.rows)


# ---------------------------------------------------------------------------
# LanePack multi-RHS SpMM (the GENERAL path — no locality assumption)
# ---------------------------------------------------------------------------
#
# Same packed-RHS idea as the aligned SpMM, applied to the general LanePack
# format: every per-chunk operand stream (vals/lane/ends/starts) and every
# x-window load is read once and reused across all K right-hand sides;
# only the lane gather, the prefix sum and the boundary gathers scale with
# K. This removes SpmvOperator.matmat's per-column SpMV loop on
# lanepack/hybrid operators (the block-AMG V-cycle's P^T apply).


@functools.partial(jax.jit, static_argnames=("rows", "kw"))
def _spmm_lanepack_jit(arrs, x3, *, rows, kw):
    """XLA evaluation of a LanePack plan, packed layout."""
    s8 = arrs["vals"].shape[0] * SUBLANES
    k = x3.shape[1]
    vals = arrs["vals"].reshape(s8, 1, LANES)
    lane = arrs["lane"].reshape(s8, 1, LANES).astype(jnp.int32)
    ends = arrs["ends"].reshape(s8, 1, LANES).astype(jnp.int32)
    starts = arrs["starts"].reshape(s8, 1, LANES).astype(jnp.int32)
    co = arrs["col_off"].astype(jnp.int32)

    win = x3[co[:, None] + jnp.arange(kw)[None, :]]  # (s8, kw, K, 128)
    win = jnp.transpose(win, (0, 2, 1, 3)).reshape(s8, k, kw * LANES)
    xg = jnp.take_along_axis(win, jnp.broadcast_to(lane, (s8, k, LANES)), axis=2)
    p = vals * xg
    c = jnp.cumsum(p, axis=2)
    g_end = jnp.take_along_axis(c, jnp.broadcast_to(ends, (s8, k, LANES)), axis=2)
    s3 = jnp.broadcast_to(starts, (s8, k, LANES))
    g_start = jnp.where(
        s3 < 0, 0.0, jnp.take_along_axis(c, jnp.maximum(s3, 0), axis=2)
    )
    contrib = g_end - g_start  # (s8, K, 128)
    r128 = arrs["rb_mask"].shape[0]
    y = jnp.zeros((r128, k, LANES), vals.dtype).at[arrs["chunk_rb"]].add(contrib)
    return jnp.where(arrs["rb_mask"][:, None, None] > 0, y, 0.0)


def _pick_b_lp_spmm(k: int, kw: int) -> int:
    # slab padding granularity of the packed LanePack arrays
    return max(4, min(64, 256 // max(1, k * kw)))


def spmm_lanepack_packed(plan, x3, *, device_arrays=None, nbuf: int = 2):
    """Y = A @ X on a :class:`~..formats.lanepack.LanePackPlan`, packed
    layout in AND out: ``x3`` is (c128+kw, K, 128) (see :func:`pack_rhs`
    with ``guard=plan.kw``), the result is (r128, K, 128)."""
    from .spmv import _VMEM_X_LIMIT, lanepack_device_arrays

    k = int(x3.shape[1])
    r128 = -(-plan.rows // LANES)
    c128 = -(-plan.cols // LANES)
    if plan.num_slabs * 8 * 4 > 900_000:
        raise ValueError(
            f"LanePack plan has {plan.num_slabs} slabs, over the plan-size "
            "limit — use spmm_ell_xla"
        )
    if (c128 + plan.kw + nbuf * r128) * k * LANES > _VMEM_X_LIMIT:
        raise ValueError(
            f"lanepack SpMM: (rows={plan.rows}, cols={plan.cols}, K={k}) is "
            "over the packed plan-size limit — split K or use spmm_ell_xla"
        )
    arrs = device_arrays
    if arrs is None or arrs.get("b") != _pick_b_lp_spmm(k, plan.kw):
        arrs = lanepack_device_arrays(plan, b=_pick_b_lp_spmm(k, plan.kw))
    return _spmm_lanepack_jit(
        {kk: v for kk, v in arrs.items() if kk != "b"},
        x3,
        rows=plan.rows,
        kw=plan.kw,
    )


def lanepack_matvec_multi(plan, k: int, *, nbuf: int = 2):
    """Packed-layout multi-RHS matvec closure for a SQUARE lanepack plan
    (general path analog of :func:`aligned_matvec_multi`), ready for
    ``cg_solve_multi(..., rhs_axis=1)``."""
    from .spmv import lanepack_device_arrays

    if plan.rows != plan.cols:
        raise ValueError("packed multi-RHS matvec needs a square operator")
    arrs = lanepack_device_arrays(plan, b=_pick_b_lp_spmm(k, plan.kw))

    def mv(x3):
        y = spmm_lanepack_packed(plan, x3, device_arrays=arrs, nbuf=nbuf)
        guard = jnp.zeros((x3.shape[0] - y.shape[0], x3.shape[1], LANES), y.dtype)
        return jnp.concatenate([y, guard], axis=0)

    return mv


# Packed-vs-loop dispatch: a per-column loop pays K launches, the packed
# form pays relayouts. The crossover (loop on large plans at small K,
# packed for small plans and K >= 8) is inherited from the first target
# and has not been re-measured on the GPU.
_LP_SPMM_MIN_K = 8
_LP_SPMM_LOOP_MIN_SLABS = 512


def _lp_spmm_use_kernel(plan, k: int) -> bool:
    return k >= _LP_SPMM_MIN_K or plan.num_slabs < _LP_SPMM_LOOP_MIN_SLABS


def spmm_lanepack(plan, x, *, device_arrays=None, nbuf: int = 2):
    """Y = A @ X (X is (cols, K)) via the general LanePack path.

    Packed multi-RHS form when K >= 8 or the plan is small; per-column
    :func:`~.spmv.spmv_lanepack` loop for small K on large plans (see the
    measured dispatch note above)."""
    x = jnp.asarray(x, dtype=plan.dtype)
    if not _lp_spmm_use_kernel(plan, int(x.shape[1])):
        from .spmv import lanepack_device_arrays, spmv_lanepack

        arrs = lanepack_device_arrays(plan)  # SpMV-shaped step size, built once
        return jnp.stack(
            [
                spmv_lanepack(plan, x[:, k], device_arrays=arrs)
                for k in range(x.shape[1])
            ],
            axis=1,
        )
    k = int(x.shape[1])
    # pad K >= 8 to multiples of 8 (fewer distinct compiled shapes);
    # small-K calls on small plans keep their exact K — padding to 8
    # would quadruple their compute for launch-bound work
    if k >= _LP_SPMM_MIN_K and k % 8:
        kpad = -(-k // 8) * 8
        x = jnp.concatenate([x, jnp.zeros((x.shape[0], kpad - k), x.dtype)], axis=1)
    x3 = pack_rhs(x, plan.cols, guard=plan.kw)
    y3 = spmm_lanepack_packed(plan, x3, device_arrays=device_arrays, nbuf=nbuf)
    return unpack_rhs(y3, plan.rows)[:, :k]


def spmm_ell_xla(ev, ec, x):
    """Y = A @ X for a padded-ELL operator (pure XLA, any backend/sharding;
    the matmat fallback that never loops per column). ``ev``/``ec`` as in
    :func:`~.spmv.spmv_ell_xla`; gathered X rows are reused across K."""
    ev = jnp.asarray(ev)
    ec = jnp.asarray(ec)
    x = jnp.asarray(x)
    return jnp.einsum("rw,rwk->rk", ev, x[ec])


def spmm_bcsr(m: BsrMatrix, x, *, precision=None):
    """Y = A @ X for a BCSR operator; X is (cols, F). F is padded to a
    multiple of 128 internally."""
    # f32 block products in full precision: the default GPU matmul may
    # round operands to TF32 (~3 decimal digits)
    precision = precision if precision is not None else jax.lax.Precision.HIGHEST
    x = np.asarray(x, dtype=m.blocks.dtype)
    f = x.shape[1]
    fpad = max(128, -(-f // 128) * 128)
    cols_pad = m.bcols * m.bs
    x_full = np.zeros((cols_pad, fpad), dtype=x.dtype)
    x_full[: x.shape[0], :f] = x
    x3 = jnp.asarray(x_full.reshape(m.bcols, m.bs, fpad))
    brow = jnp.asarray(m.block_rows_expanded().astype(np.int32))
    bcol = jnp.asarray(m.block_cols.astype(np.int32))
    # block rows with no blocks produce unvisited output blocks -> mask
    has = np.zeros(m.brows, dtype=bool)
    has[np.asarray(m.block_rows_expanded())] = True
    y3 = _spmm_bcsr_jit(
        jnp.asarray(m.blocks),
        brow,
        bcol,
        x3,
        brows=m.brows,
        bs=m.bs,
        precision=precision,
    )
    y3 = jnp.where(jnp.asarray(has)[:, None, None], y3, 0.0)
    return y3.reshape(m.brows * m.bs, fpad)[: m.rows, :f]

# ---------------------------------------------------------------------------
# BELL SpMM: the streaming general-path family (formats/bell.py) with K
# right-hand sides. The slot planes (5 B/slot) are read ONCE for all K
# columns; x lives in the packed (rows_tot, K, 128) layout and each
# (layer, half) costs one row-shifted slice + one batched lane gather.
# This removes SpmvOperator.matmat's per-column loop on BELL operators for
# K in [2, 16].
# ---------------------------------------------------------------------------


def _bell_spmm_x3(x, *, cols: int, lo: int, hi: int):
    """(cols, K) -> (lo + c128 + hi, K, 128) packed RHS."""
    c128 = -(-cols // LANES)
    k = x.shape[1]
    xpad = jnp.zeros((c128 * LANES, k), x.dtype).at[: x.shape[0]].set(x)
    x3 = xpad.reshape(c128, LANES, k).transpose(0, 2, 1)
    return jnp.concatenate(
        [
            jnp.zeros((lo, k, LANES), x.dtype),
            x3,
            jnp.zeros((hi, k, LANES), x.dtype),
        ],
        axis=0,
    )


@functools.partial(
    jax.jit,
    static_argnames=("ds", "modes", "span", "rows", "cols", "br", "k"),
)
def _spmm_bell_jit(vals, lane, x, *, ds: tuple, modes: tuple, span: int,
                   rows: int, cols: int, br: int, k: int):
    r128p = vals.shape[1]
    c128 = -(-cols // LANES)
    nh = span // 128 + 1
    dmin = min(ds) if ds else 0
    dmax = max(ds) if ds else 0
    lo = max(0, -dmin)
    win_rows = lo + br + max(dmax + nh - 1, 0)
    win_rows += (-win_rows) % 8
    total_rows = max((r128p // br - 1) * br + win_rows, lo + c128)
    hi = total_rows - lo - c128
    x3 = _bell_spmm_x3(x, cols=cols, lo=lo, hi=hi)

    bias = LANES if span == 128 else 0
    y3 = jnp.zeros((r128p, k, LANES), x.dtype)
    for li, (d, mask) in enumerate(zip(ds, modes)):
        pos = lane[li].astype(jnp.int32) + bias
        idx = jnp.bitwise_and(pos, 127)
        half = jax.lax.shift_right_logical(pos, 7)
        idx3 = jnp.broadcast_to(
            idx[:, None, :], (r128p, k, LANES)).reshape(r128p * k, LANES)
        xg = None
        for h in range(nh):
            if not (mask >> h) & 1:
                continue
            a = jax.lax.slice_in_dim(x3, lo + d + h, lo + d + h + r128p,
                                     axis=0)
            g = jnp.take_along_axis(
                a.reshape(r128p * k, LANES), idx3, axis=1
            ).reshape(r128p, k, LANES)
            if xg is None:
                xg = g
            else:
                xg = jnp.where(half[:, None, :] == h, g, xg)
        y3 = y3 + vals[li].astype(x.dtype)[:, None, :] * xg
    return y3.transpose(0, 2, 1).reshape(-1, k)[:rows]


def bell_spmm_viable(plan, k: int) -> bool:
    """Packed-path gate: 2 <= K <= 16 and the packed RHS + planes stay
    inside the BELL plan-size limit."""
    return 2 <= k <= 16 and _bell_spmm_pick_br(plan, k, 512) >= 32


def _bell_spmm_pick_br(plan, k: int, br0: int) -> int:
    """Largest BR (rows of 128 per step, a power of two >= 32) whose
    working-set model fits the BELL plan-size limit, or 0.

    Model = packed RHS + two copies of the slot planes + two (BR, K, 128)
    x slices per distinct window offset + the y block and accumulator.
    Inherited from the first target's on-chip memory budget; it bounds the
    packed path's size and picks the padding step."""
    from ..formats.bell import _BELL_VMEM_BUDGET

    c128 = -(-plan.cols // LANES)
    x3_bytes = (c128 + 16) * k * LANES * 4
    sb = plan.vals.dtype.itemsize + plan.lane.dtype.itemsize
    nh = plan.span // 128 + 1
    n_off = len({
        d + h
        for d, mask in zip(plan.ds, plan.modes)
        for h in range(nh)
        if (mask >> h) & 1
    }) or 1
    per_br = (2 * max(plan.num_layers, 1) * LANES * sb
              + (2 * n_off + 6) * k * LANES * 4)
    br = br0
    while br >= 32 and x3_bytes + br * per_br > _BELL_VMEM_BUDGET:
        br //= 2
    return br if br >= 32 else 0


def spmm_bell(plan, x, *, device_arrays=None):
    """Y = A @ X (X is (cols, K)) on a :class:`~..formats.bell.BellPlan`:
    one pass over the slot planes for all K columns (+ the lanepack SpMM
    on the spill sub-plan when the plan has one)."""
    from .spmv_bell import bell_device_arrays

    x = jnp.asarray(x, dtype=plan.dtype)
    k = int(x.shape[1])
    if not bell_spmm_viable(plan, k):
        raise ValueError(
            f"spmm_bell gate: K={k} (need 2..16) or packed RHS over the "
            "plan-size limit; chunk K or fall back to per-column spmv_bell")
    arrs = (device_arrays if device_arrays is not None
            else bell_device_arrays(plan))
    if plan.num_layers:
        # shrink BR until the K-scaled working set fits the limit
        br = _bell_spmm_pick_br(plan, k, int(arrs["br"]))
        r128p = arrs["vals"].shape[1]
        vals, lane = arrs["vals"], arrs["lane"]
        if r128p % br:
            pad = br - r128p % br
            vals = jnp.pad(vals, ((0, 0), (0, pad), (0, 0)))
            lane = jnp.pad(lane, ((0, 0), (0, pad), (0, 0)))
        y = _spmm_bell_jit(
            vals, lane, x,
            ds=plan.ds, modes=plan.modes, span=plan.span, rows=plan.rows,
            cols=plan.cols, br=br, k=k,
        )
    else:
        y = jnp.zeros((plan.rows, k), dtype=plan.dtype)
    if plan.spill is not None:
        y = y + spmm_lanepack(plan.spill, x,
                              device_arrays=arrs.get("spill"))
    return y

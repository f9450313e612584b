"""LanePack: the general planned SpMV format.

A re-design of CSR as fixed-shape slabs. The reference streams CSR rows
through per-core hash tables (``spam_csr/src/mul_hash.rs``) — a
pointer-chasing pattern. LanePack lays the matrix out in (8,128) tiles so
SpMV uses only *within-row* lane gathers (``take_along_axis(..., axis=1)``),
dynamic row slices and prefix sums, all with static shapes:

* columns are split into ``KW*128``-wide **windows**; ``x`` is viewed as
  ``x2d = x.reshape(C128, 128)`` and a window is ``KW`` consecutive rows of
  ``x2d`` (read with one dynamic row slice per chunk);
* rows are split into 128-row **blocks**; ``y[row]``'s position within its
  block is its destination *lane*;
* every nonzero becomes a **slot** in an ``(8, 128)`` **slab**. A slab row
  ("chunk") holds up to 128 products sharing one column window and one row
  block, sorted by destination lane. ``lane`` (int16) is the product's x
  position within its window;
* the apply computes products ``val * x_window[lane]`` (``KW`` lane gathers
  + masked select), a lane-axis prefix sum, then
  per-destination-lane run sums via two more lane gathers at
  host-precomputed run boundaries ``ends``/``starts`` (int8) — a segmented
  reduction with no scatter;
* each chunk's contributions are scatter-added into ``y`` by row block;
  with the default "dense" packing a slab may span two row blocks (the
  planned sublane boundary ``split`` records where).

``KW`` trades window fragmentation (more, emptier chunks at small ``KW``)
against per-slot gather work (``KW`` masked gathers); the planner picks it by
a calibrated cost model. The FLOP-balancing idea of the reference's
``rows_to_threads`` (``mul_hash.rs:38-64``) appears here as slot packing:
work per slab is a fixed slot count regardless of row-length skew.

HBM traffic per slot: 4B vals (f32) + 2B lane + 1B ends + 1B starts = 8B,
matching ideal CSR (4B val + 4B col index).

The planner is pure numpy and fully vectorized; plans are immutable and
reusable across SpMV applications (e.g. every CG iteration).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .csr import CsrMatrix

__all__ = ["LanePackPlan", "plan_lanepack"]

SUBLANES = 8
LANES = 128
SLOTS = SUBLANES * LANES

# cost model: time_per_slab ~ fixed + kw_slope * KW (ns). Constants come
# from utils.autotune: calibrated on-device when a cache exists, else the
# inherited defaults.


def _cost_constants():
    from ..utils import autotune

    return (
        autotune.get("lanepack_fixed_ns"),
        autotune.get("lanepack_kw_ns"),
        autotune.get("lanepack_dense_slab_ns"),
        autotune.get("lanepack_per_rb_slab_ns"),
    )


@dataclass(frozen=True)
class LanePackPlan:
    """Host-side plan; numpy arrays, moved to device by the kernel wrapper.

    ``S`` slabs: ``vals`` (S,8,128) dtype; ``lane`` (S,8,128) int16 (position
    in window); ``ends``/``starts`` (S,8,128) int8 run boundaries (starts may
    be -1); accumulation metadata ``rb_a``/``rb_b``/``split`` (under "dense"
    packing a slab covers at most two row blocks; under "per_rb" always one);
    ``col_off`` (S*8,) int32 x2d row base per chunk; ``rb_mask`` (r128,)
    nonzero where the row block has entries.
    """

    rows: int
    cols: int
    kw: int
    pack: str  # "dense" (two-target slabs) or "per_rb" (padded, single-target)
    vals: np.ndarray
    lane: np.ndarray
    ends: np.ndarray
    starts: np.ndarray
    rb_a: np.ndarray  # (S,) first row-block target per slab
    rb_b: np.ndarray  # (S,) second target (== rb_a when the slab has one)
    split: np.ndarray  # (S,) sublanes [0,split) -> rb_a, [split,8) -> rb_b
    chunk_rb: np.ndarray  # (S*8,) per-chunk row block (reference path)
    col_off: np.ndarray
    rb_mask: np.ndarray
    nnz: int
    dtype: np.dtype

    @property
    def num_slabs(self) -> int:
        return int(self.vals.shape[0])

    @property
    def r128(self) -> int:
        return -(-self.rows // LANES)

    @property
    def c128(self) -> int:
        return -(-self.cols // LANES)

    @property
    def fill(self) -> float:
        total = self.vals.size
        return self.nnz / total if total else 1.0

    def slot_bytes(self) -> int:
        """Total HBM bytes streamed per SpMV (slab arrays)."""
        return int(
            self.vals.nbytes + self.lane.nbytes + self.ends.nbytes + self.starts.nbytes
        )


def _count_slabs(m: CsrMatrix, kw: int) -> int:
    """Slab count for a candidate window width (cheap, no packing).

    Memoized per (matrix, kw) in the CSR cache: dispatch costing and
    plan_lanepack both walk the same kw candidates, and the sort here was
    183 calls / 0.4 s of a 2048² AMG setup."""
    memo = m._cache.setdefault("count_slabs", {})
    hit = memo.get(kw)
    if hit is not None:
        return hit
    r = m.row_ids()
    c = m.indices.astype(np.int64)
    rb = r // LANES
    w = c // (kw * LANES)
    keys = rb * (m.cols // (kw * LANES) + 2) + w
    keys = np.sort(keys)
    if len(keys) == 0:
        memo[kw] = 0
        return 0
    head = np.r_[True, keys[1:] != keys[:-1]]
    sizes = np.diff(np.append(np.nonzero(head)[0], len(keys)))
    chunks_per_group = -(-sizes // LANES)
    # chunks regroup per rb; rb of each group:
    grb = (keys[head] // (m.cols // (kw * LANES) + 2)).astype(np.int64)
    order = np.argsort(grb, kind="stable")
    grb = grb[order]
    cg = chunks_per_group[order]
    rb_head = np.r_[True, grb[1:] != grb[:-1]]
    rb_tot = np.add.reduceat(cg, np.nonzero(rb_head)[0])
    out = int(np.sum(-(-rb_tot // SUBLANES)))
    memo[kw] = out
    return out


def plan_lanepack(
    m: CsrMatrix,
    *,
    dtype=np.float32,
    kw: Optional[int] = None,
    kw_candidates: Sequence[int] = (1, 2, 4, 8, 16),
    pack: str = "auto",
) -> LanePackPlan:
    """Plan SpMV for ``m``; O(nnz log nnz) host time, vectorized numpy.

    ``pack``: "dense" packs chunks with at most two row blocks per slab
    (best fill; kernel pays masked split accumulation); "per_rb" pads each
    row block's chunks to whole slabs (kernel does one unmasked (8,128)
    accumulation per slab); "auto" picks by
    the slab-count cost model."""
    rows, cols = m.rows, m.cols
    nnz = m.nnz()

    c_fixed, c_kw, c_dense, c_per_rb = _cost_constants()
    if kw is None:
        # kw selection only needs slab-count RATIOS: sampled row bands
        # suffice on multi-M-nnz inputs (five full _count_slabs passes
        # were ~11 s of a 2048^2 AMG setup)
        mm, mscale = m, 1.0
        if nnz > 1_500_000:
            from .csr import sample_row_bands

            mm, mscale = sample_row_bands(m)
        best, best_cost = 1, float("inf")
        for cand in kw_candidates:
            if cand * LANES > cols + LANES:
                break
            s = _count_slabs(mm, cand) * mscale
            cost = s * (c_fixed + c_kw * cand)
            if cost < best_cost:
                best, best_cost = cand, cost
        kw = best

    wtot = cols // (kw * LANES) + 2
    # chunk-sort: one fused native pass computing key = ((rb*wtot+w)<<7)|dst
    # and the blockwise per-128-row-block sort (same (rb, w, dst) order as
    # the lexsort below; was the dominant term of multi-M-nnz plans)
    res = None
    if nnz and m.is_sorted:
        from ..native import lanepack_sort_native

        res = lanepack_sort_native(rows, cols, kw, m.offsets, m.indices)
    if res is not None:
        perm, ck = res
        gk = (ck >> np.uint64(7)).astype(np.int64)
        dst = (ck & np.uint64(LANES - 1)).astype(np.int64)
        v = lane = None  # derived lazily only on the numpy fill path
        new_group = np.empty(nnz, dtype=bool)
        new_group[0] = True
        new_group[1:] = gk[1:] != gk[:-1]
    else:
        r = m.row_ids()
        c = m.indices.astype(np.int64)
        v = m.vals.astype(dtype)

        rb0 = r // LANES
        dst = (r % LANES).astype(np.int64)
        w0 = c // (kw * LANES)
        lane = (c % (kw * LANES)).astype(np.int64)

        perm = np.lexsort((dst, w0, rb0))
        dst, lane, v = dst[perm], lane[perm], v[perm]
        gk = (rb0 * wtot + w0)[perm]

        new_group = np.empty(nnz, dtype=bool)
        if nnz:
            new_group[0] = True
            new_group[1:] = gk[1:] != gk[:-1]
    if nnz:
        group_start = np.maximum.accumulate(np.where(new_group, np.arange(nnz), 0))
        pos = (np.arange(nnz) - group_start) % LANES
        is_chunk_head = pos == 0
        heads = np.nonzero(is_chunk_head)[0]
        head_rb = gk[heads] // wtot
        head_w = gk[heads] % wtot
        chunk_cnt = np.diff(np.append(heads, nnz))
    else:
        pos = np.zeros(0, np.int64)
        is_chunk_head = np.zeros(0, bool)
        heads = np.zeros(0, np.int64)
        head_rb = np.zeros(0, np.int64)
        head_w = np.zeros(0, np.int64)
        chunk_cnt = np.zeros(0, np.int64)
    num_chunks = len(head_rb)

    if pack == "auto":
        # per-slab kernel cost: per_rb saves the masked two-target split
        # (~12 ns of ~26 ns); dense saves slab padding. Pick fewer ns.
        rb_change0 = np.r_[True, head_rb[1:] != head_rb[:-1]] if num_chunks else np.zeros(0, bool)
        counts0 = (
            np.diff(np.append(np.nonzero(rb_change0)[0], num_chunks))
            if num_chunks
            else np.zeros(0, np.int64)
        )
        slabs_per_rb = int(np.sum(-(-counts0 // SUBLANES)))
        slabs_dense = -(-num_chunks // SUBLANES)
        # per-slab costs (autotune defaults: dense two-target ~30 ns,
        # per_rb ~32 ns) — dense wins
        # unless per-rb padding is negligible AND slab counts diverge
        # strongly (rare); keep both modes selectable
        pack = "per_rb" if slabs_per_rb * c_per_rb < slabs_dense * c_dense else "dense"
        # per_rb's planned y is (r128, 8, 128) f32 = 32 B/row vs dense's
        # 4 B/row: an inherited plan-size gate keeps large operators dense
        if pack == "per_rb" and 32 * m.rows + 4 * m.cols > 88 * 1024 * 1024:
            pack = "dense"

    # pack chunks densely into slabs, allowing at most TWO distinct row
    # blocks per slab (the kernel does a split two-target accumulation);
    # a slab is padded early only when a third row block would enter it.
    rb_change = np.empty(num_chunks, dtype=bool)
    if num_chunks:
        rb_change[0] = True
        rb_change[1:] = head_rb[1:] != head_rb[:-1]
    counts = (
        np.diff(np.append(np.nonzero(rb_change)[0], num_chunks))
        if num_chunks
        else np.zeros(0, np.int64)
    )
    uniq_rbs = head_rb[rb_change] if num_chunks else np.zeros(0, np.int64)

    chunk_slab = np.zeros(num_chunks, dtype=np.int64)
    chunk_sublane = np.zeros(num_chunks, dtype=np.int64)
    slab_meta: list = []  # (rb_a, rb_b, split)
    cur_fill = 0  # sublanes used in the open slab (0 => no open slab)
    k = 0
    for rbi, c in zip(uniq_rbs, counts):
        c = int(c)
        placed = 0
        if pack == "per_rb" and cur_fill != 0:
            cur_fill = 0  # close the slab at every row-block boundary
        while placed < c:
            if cur_fill == 0:
                slab_meta.append([rbi, rbi, SUBLANES])
            elif slab_meta[-1][1] != rbi:
                if slab_meta[-1][0] != slab_meta[-1][1]:
                    # already two row blocks: close (pad) and open fresh
                    cur_fill = 0
                    slab_meta.append([rbi, rbi, SUBLANES])
                else:
                    # second row block enters: record the split point
                    slab_meta[-1][1] = rbi
                    slab_meta[-1][2] = cur_fill
            take = min(c - placed, SUBLANES - cur_fill)
            sl = len(slab_meta) - 1
            chunk_slab[k : k + take] = sl
            chunk_sublane[k : k + take] = np.arange(cur_fill, cur_fill + take)
            k += take
            placed += take
            cur_fill = (cur_fill + take) % SUBLANES
    num_slabs = len(slab_meta)

    vals_s = np.zeros((num_slabs, SUBLANES, LANES), dtype=dtype)
    lane_s = np.zeros((num_slabs, SUBLANES, LANES), dtype=np.int16)
    ends_s = np.zeros((num_slabs, SUBLANES, LANES), dtype=np.int8)
    starts_s = np.zeros((num_slabs, SUBLANES, LANES), dtype=np.int8)
    col_off = np.zeros(max(num_slabs, 1) * SUBLANES, dtype=np.int32)
    meta = np.asarray(slab_meta, dtype=np.int32).reshape(num_slabs, 3) if num_slabs else np.zeros((0, 3), np.int32)
    rb_a = np.zeros(max(num_slabs, 1), dtype=np.int32)
    rb_b = np.zeros(max(num_slabs, 1), dtype=np.int32)
    split = np.full(max(num_slabs, 1), SUBLANES, dtype=np.int32)
    if num_slabs:
        rb_a[:num_slabs] = meta[:, 0]
        rb_b[:num_slabs] = meta[:, 1]
        split[:num_slabs] = meta[:, 2]
    chunk_rb = np.zeros(max(num_slabs, 1) * SUBLANES, dtype=np.int32)

    if nnz:
        col_off[chunk_slab * SUBLANES + chunk_sublane] = (head_w * kw).astype(
            np.int32
        )
        chunk_rb[chunk_slab * SUBLANES + chunk_sublane] = head_rb.astype(np.int32)

        filled = None
        if res is not None:
            from ..native import lanepack_fill_native

            filled = lanepack_fill_native(
                chunk_cnt, chunk_slab, chunk_sublane, perm, m.row_ids(),
                m.indices, m.vals, kw, vals_s, lane_s, ends_s, starts_s,
            )
        if filled is None:
            if v is None:  # native sort ran but the fill dtype pair didn't
                v = m.vals[perm].astype(dtype)
                lane = m.indices[perm].astype(np.int64) % (kw * LANES)
            chunk_id = np.cumsum(is_chunk_head) - 1
            slab_of = chunk_slab[chunk_id]
            sub_of = chunk_sublane[chunk_id]
            vals_s[slab_of, sub_of, pos] = v
            lane_s[slab_of, sub_of, pos] = lane.astype(np.int16)

            run_head = np.empty(nnz, dtype=bool)
            run_head[0] = True
            run_head[1:] = (dst[1:] != dst[:-1]) | (chunk_id[1:] != chunk_id[:-1])
            run_tail = np.r_[run_head[1:], True]
            h = np.nonzero(run_head)[0]
            t = np.nonzero(run_tail)[0]
            starts_s[slab_of[h], sub_of[h], dst[h]] = (pos[h] - 1).astype(np.int8)
            ends_s[slab_of[h], sub_of[h], dst[h]] = pos[t].astype(np.int8)

    r128 = -(-rows // LANES)
    rb_mask = np.zeros(r128, dtype=dtype)
    if nnz:
        rb_mask[np.unique(head_rb)] = 1

    return LanePackPlan(
        rows=rows,
        cols=cols,
        kw=kw,
        pack=pack,
        vals=vals_s,
        lane=lane_s,
        ends=ends_s,
        starts=starts_s,
        rb_a=rb_a,
        rb_b=rb_b,
        split=split,
        chunk_rb=chunk_rb,
        col_off=col_off,
        rb_mask=rb_mask,
        nnz=nnz,
        dtype=np.dtype(dtype),
    )

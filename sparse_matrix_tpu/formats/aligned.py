"""Aligned LanePack: destination-aligned slot packing for SpMV.

Round-2 redesign of the general SpMV path (VERDICT r1 item 2: break the
26 Gnnz/s wall). The general :mod:`.lanepack` format packs 128 products per
chunk regardless of destination and pays a segmented reduce per slab (a
cumsum + two boundary gathers + the ``ends``/``starts`` byte streams). The
**aligned** variant instead places each product at slot lane ``row % 128``:

* a chunk is ``(row-block, 128-col window, layer)`` — the k-th entries of
  each row within the window stack into layer k;
* products ``val * x_window[lane]`` are then *already* per-row
  contributions: no cumsum, no boundary gathers, no ends/starts streams
  (5 bytes/slot streamed instead of 8);
* chunk contributions scatter-add into y by row block.

The catch: a chunk only fills when ~128 rows of the block have a k-th entry
in the same window — window-straddling rows and scattered matrices produce
near-empty chunks. The **hybrid** plan therefore spills entries of chunks
with fewer than ``spill_k`` slots to a small general-LanePack sub-plan (the
existing segmented-reduce kernel); fills >
``plan.fill`` ~1.0 on banded/local structures with a ~1% spill.

Uniform-random matrices keep the general path (aligned fill collapses;
the planner gates on estimated fill).

Same HBM contract as LanePack otherwise: uint32 column discipline, padded
slabs stream zero values, plans are immutable and reusable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .csr import CsrMatrix
from .lanepack import LANES, SUBLANES, LanePackPlan, _count_slabs, plan_lanepack

__all__ = ["AlignedPlan", "plan_aligned", "estimate_aligned"]

# spill threshold: aligned chunks with fewer slots than this go to the
# general sub-plan (each spilled slot costs ~2x the stream bytes but frees
# 128 - k wasted slots)
SPILL_K = 32


@dataclass(frozen=True)
class AlignedPlan:
    """Host-side aligned plan (+ optional general spill sub-plan)."""

    rows: int
    cols: int
    vals: np.ndarray  # (S, 8, 128) dtype
    lane: np.ndarray  # (S, 8, 128) int8: x position within the 128-col window
    col_off: np.ndarray  # (S*8,) int32: x2d row per chunk
    chunk_rb: np.ndarray  # (S*8,) int32: row block per chunk (reference path)
    rb_a: np.ndarray  # (S,)
    rb_b: np.ndarray  # (S,)
    split: np.ndarray  # (S,) sublanes [0, split) -> rb_a, rest -> rb_b
    rb_mask: np.ndarray  # (r128,)
    nnz: int
    dtype: np.dtype
    spill: Optional[LanePackPlan]  # general sub-plan for low-fill chunks

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
        kept = self.nnz - (self.spill.nnz if self.spill is not None else 0)
        total = self.vals.size
        return kept / total if total else 1.0

    def slot_bytes(self) -> int:
        b = int(self.vals.nbytes + self.lane.nbytes)
        if self.spill is not None:
            b += self.spill.slot_bytes()
        return b


def _chunk_keys(m: CsrMatrix):
    """Per-entry (sorted) chunk keys: (rb, window, layer) plus helpers."""
    nnz = m.nnz()
    r = m.row_ids().astype(np.int64)
    c = m.indices.astype(np.int64)
    if m.is_sorted:
        order = np.arange(nnz)  # CSR invariant 6: already (row, col)-sorted
    else:
        order = np.lexsort((c, r))
        r, c = r[order], c[order]
    w = c // LANES
    new_rw = np.r_[True, (r[1:] != r[:-1]) | (w[1:] != w[:-1])] if nnz else np.zeros(0, bool)
    start_rw = np.maximum.accumulate(np.where(new_rw, np.arange(nnz), 0))
    layer = np.arange(nnz) - start_rw
    # layer < 128 always (a 128-col window holds at most 128 distinct
    # sorted columns), so the key stride is the constant 128 — the same
    # packing as the native spmx_aligned_sort, letting either path derive
    # (rb, w) back out of a key via // 128
    wtot = m.cols // LANES + 2
    ck = (r // LANES * wtot + w) * 128 + layer
    return order, r, c, ck


def _sort_by_chunk(r_s: np.ndarray, ck: np.ndarray, rows: int) -> np.ndarray:
    """Permutation sorting entries by chunk key.

    ``ck``'s high bits are the 128-row block and ``r_s`` is row-sorted, so
    the sort decomposes into independent cache-resident per-block sorts —
    the native runtime does those in one pass (the global
    ``np.argsort(ck)`` was the dominant term of ``plan_aligned`` in the
    2048^2 AMG setup profile). Falls back to the global argsort."""
    from ..native import blockwise_argsort_native

    r128 = -(-rows // LANES)
    starts = np.searchsorted(r_s, np.arange(0, r128 + 1) * LANES)
    perm = blockwise_argsort_native(starts, ck)
    if perm is None:
        perm = np.argsort(ck, kind="stable")
    return perm


def _chunk_sorted(m: CsrMatrix):
    """``(perm, ck, wtot)``: chunk-sorted order over ORIGINAL entry
    indices plus the sorted keys, ``key = (rb*wtot + w)*128 + layer``.

    One fused native pass on sorted CSR (spmx_aligned_sort); otherwise the
    numpy key build + blockwise/global sort."""
    from ..native import aligned_sort_native

    nnz = m.nnz()
    wtot = m.cols // LANES + 2
    if nnz == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64), wtot
    if m.is_sorted:
        res = aligned_sort_native(m.rows, m.cols, m.offsets, m.indices)
        if res is not None:
            return res[0], res[1], wtot
    order, r_s, _, ck = _chunk_keys(m)
    p = _sort_by_chunk(r_s, ck, m.rows)
    return order[p], ck[p].astype(np.uint64), wtot


def _spill_sub_slabs(key_rbw: np.ndarray, counts: np.ndarray, wtot: int) -> int:
    """Slab count the general (kw=1) LanePack plan would need for the
    spilled chunks — computed from CHUNK-level stats, equal by
    construction to ``_count_slabs(sub, 1)`` on the spilled-entry matrix
    (same (rb, window) grouping; parity-tested). Lets the keep/split
    decision run before any per-entry spill work."""
    if len(key_rbw) == 0:
        return 0
    # key_rbw is sorted (chunk keys are); merge layers of the same (rb, w)
    new_g = np.r_[True, key_rbw[1:] != key_rbw[:-1]]
    gidx = np.nonzero(new_g)[0]
    sizes = np.add.reduceat(counts, gidx)
    chunks_per_group = -(-sizes // LANES)
    grb = key_rbw[gidx] // wtot
    rb_head = np.r_[True, grb[1:] != grb[:-1]]
    rb_tot = np.add.reduceat(chunks_per_group, np.nonzero(rb_head)[0])
    return int(np.sum(-(-rb_tot // SUBLANES)))


def estimate_aligned(m: CsrMatrix, *, spill_k: int = SPILL_K):
    """Cheap planning estimate: (kept_chunks, kept_nnz, spill_nnz) without
    building arrays — the operator's dispatch input."""
    nnz = m.nnz()
    if nnz == 0:
        return 0, 0, 0
    _, cks, _ = _chunk_sorted(m)
    new_chunk = np.r_[True, cks[1:] != cks[:-1]]
    cnt = np.diff(np.append(np.nonzero(new_chunk)[0], nnz))
    big = cnt >= spill_k
    kept_nnz = int(cnt[big].sum())
    kept_chunks = int(big.sum())
    return kept_chunks, kept_nnz, nnz - kept_nnz


def plan_aligned(
    m: CsrMatrix, *, dtype=np.float32, spill_k: int = SPILL_K
) -> AlignedPlan:
    """Build the hybrid aligned plan. O(nnz log nnz) vectorized host time.

    Spilling only engages when it wins: straddler entries are often so
    scattered that the general sub-plan's slabs come out nearly empty (the
    two-row-block packing limit — measured 1024 slabs for 3072 spilled
    Poisson entries), making keep-everything
    the faster plan. The decision compares estimated kernel times via the
    autotuned per-slab costs.
    """
    from ..utils import autotune

    rows, cols, nnz = m.rows, m.cols, m.nnz()
    # one fused pass computes chunk keys and the chunk-sorted entry order
    # (indices into the ORIGINAL entry arrays); chunk counts are its run
    # lengths — the old unique + argsort pair was two full sorts of the
    # nnz stream plus ~10 numpy key-derivation passes
    perm, ck, wtot = _chunk_sorted(m)
    if nnz:
        new_chunk = np.r_[True, ck[1:] != ck[:-1]]
        heads_all = np.nonzero(new_chunk)[0]
        cnt = np.diff(np.append(heads_all, nnz))
    else:
        heads_all = np.zeros(0, np.int64)
        cnt = np.zeros(0, np.int64)

    # keep/split decision from CHUNK-level stats only (the general
    # sub-plan's slab count folds layers analytically — parity with
    # _count_slabs tested): straddler entries are often so scattered that
    # the sub-plan's slabs come out nearly empty, making keep-everything
    # the faster plan; a losing decision now costs no per-entry work.
    small = cnt < spill_k
    spill_plan = None
    do_split = False
    if nnz and small.any():
        key_rbw_all = ck[heads_all] // 128
        sub_slabs = _spill_sub_slabs(
            key_rbw_all[small].astype(np.int64), cnt[small], wtot
        )
        ali_ns = autotune.get("lanepack_aligned_slab_ns")
        gen_ns = autotune.get("lanepack_dense_slab_ns")
        cost_all = -(-len(cnt) // SUBLANES) * ali_ns
        cost_split = (
            -(-int((~small).sum()) // SUBLANES) * ali_ns + sub_slabs * gen_ns
        )
        do_split = cost_split < cost_all

    row_of = m.row_ids()
    if do_split:
        spill_mask = np.repeat(small, cnt)  # per-entry, chunk-sorted order
        sp_idx = np.sort(perm[spill_mask])  # spilled entries, CSR order
        rr, vv = row_of[sp_idx], m.vals[sp_idx].astype(dtype)
        offs = np.zeros(rows + 1, np.int64)
        offs[1:] = np.bincount(rr, minlength=offs.shape[0] - 1)
        np.cumsum(offs, out=offs)
        sub = CsrMatrix(
            rows, cols, vv, m.indices[sp_idx], offs, is_sorted=m.is_sorted
        )
        spill_plan = plan_lanepack(sub, dtype=dtype)
        kept_idx = perm[~spill_mask]  # chunk-sorted order, original indices
        ck = ck[~spill_mask]
        kn = len(kept_idx)
        new_chunk = np.r_[True, ck[1:] != ck[:-1]] if kn else np.zeros(0, bool)
        head = np.nonzero(new_chunk)[0]
        cnt_kept = np.diff(np.append(head, kn)) if kn else np.zeros(0, np.int64)
        head_key = (ck[head] // 128).astype(np.int64)  # (rb*wtot + w)
    else:
        kept_idx = perm
        kn = nnz
        head = heads_all
        cnt_kept = cnt
        head_key = (
            key_rbw_all.astype(np.int64)
            if nnz and small.any()
            else (ck[head] // 128).astype(np.int64)
        )
    head_rb = head_key // wtot
    head_w = head_key % wtot
    num_chunks = len(head)

    # two-target slab packing (same rule as plan_lanepack: at most two row
    # blocks per slab, split sublane recorded). The placement is a position
    # state machine over rbs (O(1) python per rb), with all per-chunk and
    # per-slab arrays derived vectorized from the start positions — the
    # naive per-chunk loop was the planning hotspot at multi-M nnz.
    rb_change = np.r_[True, head_rb[1:] != head_rb[:-1]] if num_chunks else np.zeros(0, bool)
    counts = (
        np.diff(np.append(np.nonzero(rb_change)[0], num_chunks))
        if num_chunks
        else np.zeros(0, np.int64)
    )
    uniq_rbs = head_rb[rb_change] if num_chunks else np.zeros(0, np.int64)

    pos0 = np.zeros(len(counts), np.int64)
    pos = 0  # global sublane position, pads included
    nrb = 1  # row blocks in the currently open slab
    for i, cnt_i in enumerate(counts):
        cur = pos % SUBLANES
        if cur != 0 and nrb == 2:
            pos += SUBLANES - cur  # slab already holds two rbs: close (pad)
            cur = 0
        pos0[i] = pos
        entered_shared = cur != 0
        pos += int(cnt_i)
        if pos % SUBLANES == 0:
            nrb = 1
        else:
            # open slab holds two rbs only if this rb started mid-slab and
            # did not spill past the shared slab
            nrb = 2 if entered_shared and cnt_i < SUBLANES - cur else 1

    if num_chunks:
        gpos = np.repeat(pos0, counts) + (
            np.arange(num_chunks) - np.repeat(np.cumsum(counts) - counts, counts)
        )
        chunk_slab = gpos // SUBLANES
        chunk_sub = gpos % SUBLANES
        chunk_rb_of = np.repeat(uniq_rbs, counts)
        s = int(gpos[-1] // SUBLANES) + 1
        uslab, first = np.unique(chunk_slab, return_index=True)
        last = np.r_[first[1:] - 1, num_chunks - 1]
        rb_a_full = np.zeros(s, np.int64)
        rb_b_full = np.zeros(s, np.int64)
        rb_a_full[uslab] = chunk_rb_of[first]
        rb_b_full[uslab] = chunk_rb_of[last]
        split_full = np.full(s, SUBLANES, np.int64)
        two = rb_a_full[chunk_slab] != chunk_rb_of
        np.minimum.at(split_full, chunk_slab[two], chunk_sub[two])
        meta = np.stack([rb_a_full, rb_b_full, split_full], axis=1)
    else:
        chunk_slab = np.zeros(0, np.int64)
        chunk_sub = np.zeros(0, np.int64)
        meta = np.zeros((0, 3), np.int64)
        s = 0

    vals_s = np.zeros((s, SUBLANES, LANES), dtype)
    lane_s = np.zeros((s, SUBLANES, LANES), np.int8)
    col_off = np.zeros(max(s, 1) * SUBLANES, np.int32)
    chunk_rb = np.zeros(max(s, 1) * SUBLANES, np.int32)
    ma = np.asarray(meta, np.int32) if s else np.zeros((0, 3), np.int32)
    rb_a = np.zeros(max(s, 1), np.int32)
    rb_b = np.zeros(max(s, 1), np.int32)
    split = np.full(max(s, 1), SUBLANES, np.int32)
    if s:
        rb_a[:s], rb_b[:s], split[:s] = ma[:, 0], ma[:, 1], ma[:, 2]
    if kn:
        from ..native import aligned_fill_native

        filled = aligned_fill_native(
            cnt_kept, chunk_slab, chunk_sub, kept_idx, row_of,
            m.indices, m.vals, vals_s, lane_s,
        )
        if filled is None:  # library or dtype pair unavailable
            chunk_id = np.cumsum(new_chunk) - 1
            so, su = chunk_slab[chunk_id], chunk_sub[chunk_id]
            dst = row_of[kept_idx] % LANES
            vals_s[so, su, dst] = m.vals[kept_idx].astype(dtype)
            lane_s[so, su, dst] = (
                m.indices[kept_idx].astype(np.int64) % LANES
            ).astype(np.int8)
        col_off[chunk_slab * SUBLANES + chunk_sub] = head_w.astype(np.int32)
        chunk_rb[chunk_slab * SUBLANES + chunk_sub] = head_rb.astype(np.int32)

    r128 = -(-rows // LANES)
    rb_mask = np.zeros(r128, dtype)
    if kn:
        rb_mask[np.unique(head_rb)] = 1
    if spill_plan is not None:
        rb_mask = np.maximum(rb_mask, spill_plan.rb_mask)

    return AlignedPlan(
        rows=rows,
        cols=cols,
        vals=vals_s,
        lane=lane_s,
        col_off=col_off,
        chunk_rb=chunk_rb,
        rb_a=rb_a,
        rb_b=rb_b,
        split=split,
        rb_mask=rb_mask,
        nnz=nnz,
        dtype=np.dtype(dtype),
        spill=spill_plan,
    )

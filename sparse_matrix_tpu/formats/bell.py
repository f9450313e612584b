"""BELL: blocked-ELL layers with *static* window offsets — the streaming
general-path SpMV format.

Why a third family: the aligned format pays one dynamic x-window load per
chunk (``col_off``), while DIA needs nothing but *static* shifted slices
of x (ops/spmv_dia.py). BELL ports that recipe to general matrices:

* an entry ``(r, c, v)`` lives in row block ``rb = r // 128`` at lane
  ``r % 128`` (destination-aligned, like formats/aligned.py);
* its element offset ``o = c - r`` is quantized structure: local/banded
  matrices produce a handful of distinct ``o`` values. Distinct offsets
  are greedily grouped into **buckets** of o-span <= ``span`` (128 or
  256); a bucket with base ``b`` reads x elements
  ``[128*(rb + b), 128*(rb + b) + span + 128)`` — 2 or 3 adjacent rows of
  the streamed x window, ALL static slices. Every entry of the bucket has
  ``pos = o - 128*b + r%128`` in ``[0, span + 127]``, valid for every row
  phase — a constant-offset band never straddles planes (the v1 layout
  keyed planes by ``c//128 - r//128``, which split every
  non-multiple-of-128 stencil offset across two half-filled planes:
  femlike fill 0.369 vs ~0.9 here);
* entries group into layers ``(b, k)`` — the k-th entry of ``(b, row)`` —
  giving ``L`` layers of ``(r128, 128)`` value planes plus ``pos`` lane
  indices (int8 storing pos-128 at span 128; int16 storing pos at 256);
* the apply's per-layer work is 1-3 STATIC window slices (``b`` is
  compile-time), one in-row lane gather per *used* 128-half
  (``take_along_axis(.., axis=1)``) merged by half-index selects, one fma.
  No dynamic loads, no cumsum, no scatter; y is written once. There is no
  rows/cols plan-size limit (the aligned/LanePack plans have one).

The planner builds both span candidates and keeps the cheaper one
(streamed bytes x the measured per-chunk cost): pure 5-point stencils
pack perfectly at span 128 (5 B/slot), jittered/clustered structure needs
span 256 (6 B/slot) to unify each cluster into k-full planes.

Sparse layers (stray far-from-diagonal entries) either stay (streaming
zeros is cheap) or spill to a general-LanePack sub-plan; the choice is a
per-layer cost comparison with the autotuned per-(layer, row-block)
kernel cost.

The reference's general SpGEMM load-balances by FLOPs across threads
(/root/reference/spam_csr/src/mul_hash.rs:38-64); BELL is the SpMV analog
of that discipline: fixed-size work per 128-row block and layer,
irregularity absorbed at plan time on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .csr import CsrMatrix
from .lanepack import LANES, SLOTS, LanePackPlan, plan_lanepack

__all__ = ["BellPlan", "plan_bell", "estimate_bell"]

# hard cap on kept layers: bounds the unrolled apply's length / compile time
MAX_LAYERS = 48
# widest kept window span (in 128-col windows): bounds the padded x view
MAX_DSPAN = 4096

# plan-size limit for picking BR (the row-block padding step) and for the
# packed multi-RHS path (ops/spmm.py bell_spmm_viable): slot blocks + x
# window + y under this many bytes. Inherited from the first target's
# on-chip memory budget; not re-tuned for the GPU.
_BELL_VMEM_BUDGET = 72 * 1024 * 1024
_BR_CANDIDATES = (512, 256, 128, 64, 32)

# candidate o-spans per bucket: span 128 -> int8 lanes (5 B/slot, window =
# 2 halves), span 256 -> int16 lanes (6 B/slot, window = 3 halves)
_SPANS = (128, 256)


def _slot_bytes_per(span: int, dtype=np.float32) -> int:
    return np.dtype(dtype).itemsize + (1 if span == 128 else 2)


def pick_br(L: int, dmax: int, slot_bytes: int = 5) -> int:
    """Row-block padding step BR (in 128-row blocks): the largest
    candidate whose working-set model fits the BELL plan-size limit."""
    for br in _BR_CANDIDATES:
        per_step = (
            L * br * LANES * slot_bytes
            + (br + max(dmax, 0) + 8) * LANES * 4
            + br * LANES * 4
        )
        if 2 * per_step <= _BELL_VMEM_BUDGET:
            return br
    return _BR_CANDIDATES[-1]


def bell_chunk_ns(br: int, dspan: int = 0) -> float:
    """Per-(layer, 128-row-block) cost model: a c0 + c1*(128/br)
    interpolation over the BR candidates (the c0 < 0 fit value is
    empirical; the floor keeps the extrapolation sane) plus a linear
    penalty in the kept window span. Constants from utils.autotune
    (inherited fits, not measured on the GPU)."""
    from ..utils import autotune

    c0 = autotune.get("bell_chunk_c0_ns")
    c1 = autotune.get("bell_chunk_c1_ns")
    c2 = autotune.get("bell_chunk_dspan_ns")
    return max(0.5, c0 + c1 * (128.0 / max(br, 1))) + c2 * max(dspan, 0)


@dataclass(frozen=True)
class BellPlan:
    """Host-side BELL plan (+ optional general spill sub-plan)."""

    rows: int
    cols: int
    ds: Tuple[int, ...]  # static per-layer bucket bases, len L
    vals: np.ndarray  # (L, r128, 128) dtype
    lane: np.ndarray  # (L, r128, 128): span 128 -> int8 = pos - 128;
    # span 256 -> int16 = pos (see _layer_keys)
    modes: Tuple[int, ...]  # per-layer bitmask of used 128-halves
    # (bit h set => the kernel gathers from window row b + h)
    span: int  # bucket o-span: 128 or 256
    nnz: int
    dtype: np.dtype
    spill: Optional[LanePackPlan]

    @property
    def num_layers(self) -> int:
        return len(self.ds)

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

    @property
    def dspan(self) -> int:
        return (max(self.ds) - min(self.ds) + 1) if self.ds else 0

    def slot_bytes(self) -> int:
        b = int(self.vals.nbytes + self.lane.nbytes)
        if self.spill is not None:
            b += self.spill.slot_bytes()
        return b


def _bucket_bases(uo: np.ndarray, span: int) -> np.ndarray:
    """Greedy bucketing of sorted distinct element offsets: a bucket with
    base ``b = o_first >> 7`` holds every o <= 128*b + span, so pos =
    o - 128*b + r%128 stays in [0, span + 127] for every row phase."""
    bases = np.empty(len(uo), np.int64)
    limit = None
    cur = 0
    for i, v in enumerate(uo):
        if limit is None or v > limit:
            cur = int(v) >> 7
            limit = 128 * cur + span
        bases[i] = cur
    return bases


def _layer_keys(m: CsrMatrix, span: int):
    """Per-entry (bucket base, layer-within-(bucket,row)) keys in
    (b, r, c) order (same-b layers adjacent; the kernel reuses window
    slices across them)."""
    nnz = m.nnz()
    r = m.row_ids().astype(np.int64)
    c = m.indices.astype(np.int64)
    o = c - r
    uo = np.unique(o)
    bases = _bucket_bases(uo, span)
    d = bases[np.searchsorted(uo, o)]
    order = np.lexsort((c, r, d))
    d_s, r_s, c_s = d[order], r[order], c[order]
    if nnz:
        new = np.r_[True, (d_s[1:] != d_s[:-1]) | (r_s[1:] != r_s[:-1])]
        start = np.maximum.accumulate(np.where(new, np.arange(nnz), 0))
        k = np.arange(nnz) - start
        kmax = int(k.max()) + 1
        dmin = int(d_s.min())
        lkey = (d_s - dmin) * kmax + k
    else:
        k = np.zeros(0, np.int64)
        kmax, dmin = 1, 0
        lkey = np.zeros(0, np.int64)
    return order, d_s, r_s, c_s, k, lkey, kmax, dmin


def _spill_decision(lkey, r_s, r128: int, *, max_layers: int, count_scale: float = 1.0):
    """Per-layer keep/spill by cost: keeping a layer streams its whole
    (r128, 128) plane (autotuned ns per (layer, row-block)); spilling its
    entries costs general-LanePack slabs (>= ceil(nrb/2): a slab packs at
    most two row blocks — the reason sparse-but-wide layers usually stay).
    Returns (kept lkey values sorted, per-entry spill mask)."""
    from ..utils import autotune

    if len(lkey) == 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    uniq, inv, cnt = np.unique(lkey, return_inverse=True, return_counts=True)
    # row blocks present per layer
    rb = r_s // LANES
    pair = inv.astype(np.int64) * r128 + rb
    upair = np.unique(pair)
    nrb = np.bincount((upair // r128).astype(np.int64), minlength=len(uniq))

    # pre-spill BR guess (the kept-layer count isn't known yet): good
    # enough for the keep/spill comparison, which is order-of-magnitude
    bell_ns = bell_chunk_ns(pick_br(min(len(uniq), max_layers), 4))
    dense_ns = autotune.get("lanepack_dense_slab_ns")
    cost_keep = r128 * bell_ns
    # count_scale lifts sampled-sub-matrix entry/row-block counts back to
    # full-operator magnitudes for the cost comparison
    slabs_est = np.maximum(
        -(-(cnt * count_scale) // SLOTS), -(-(nrb * count_scale) // 2)
    )
    spill_layer = slabs_est * dense_ns < cost_keep

    keep_idx = np.nonzero(~spill_layer)[0]
    if len(keep_idx) > max_layers:
        # force-spill the smallest kept layers beyond the cap
        order = np.argsort(cnt[keep_idx], kind="stable")
        drop = keep_idx[order[: len(keep_idx) - max_layers]]
        spill_layer[drop] = True
    spill_mask = spill_layer[inv]
    return uniq[~spill_layer], spill_mask


def _sampled_reject(m: CsrMatrix) -> bool:
    """O(100k) pre-filter before the O(nnz log nnz) estimate: sampled
    window offsets showing a huge span or far more distinct values than
    MAX_LAYERS reject for certain (the AMG-prolongator case — rectangular
    aspect makes d drift linearly with the row, exploding the layer set;
    the operator planner probes many such candidates per setup)."""
    nnz = m.nnz()
    if nnz <= 1_000_000:
        return False
    idx = np.linspace(0, nnz - 1, 100_000).astype(np.int64)
    r = m.row_ids()[idx].astype(np.int64)
    c = m.indices[idx].astype(np.int64)
    d = (c - r) >> 7
    if int(d.max() - d.min() + 1) > MAX_DSPAN:
        return True
    # distinct (d, .) layer keys are at least distinct d values; far more
    # of them than the cap means nearly everything would spill
    return len(np.unique(d)) > 4 * MAX_LAYERS


def _span_stats(kept, spill_nnz: int, kmax: int, dmin: int, r128: int, span: int):
    """Shared cost/viability model for one span candidate — used by BOTH
    the sampled dispatch estimate and plan_bell's full-matrix span pick,
    so the two cannot drift."""
    from ..utils import autotune

    layers = len(kept)
    if layers:
        kd = kept // kmax + dmin
        dspan = int(kd.max() - kd.min() + 1)
        dmax = int(kd.max())
    else:
        dspan, dmax = 0, 0
    sb = _slot_bytes_per(span)
    br = pick_br(max(layers, 1), dmax, sb)
    # spilled entries' slab count is only known after packing; lower-bound
    # by slot capacity (dispatch-grade accuracy, like _count_slabs).
    # the chunk cost scales with slot bytes (the kernel is stream-bound;
    # the measured fit is for the 5 B/slot layout)
    cost = (
        layers * r128 * bell_chunk_ns(br, dspan) * (sb / 5.0)
        + -(-spill_nnz // SLOTS) * autotune.get("lanepack_dense_slab_ns")
    )
    viable = layers > 0 and dspan <= MAX_DSPAN
    return layers, dspan, br, float(cost), viable


def _estimate_for_span(
    m: CsrMatrix, span: int, *, max_layers: int, r128: Optional[int] = None,
    total_nnz: Optional[int] = None,
):
    """Estimate for one span. When ``m`` is a sampled row-band sub-matrix,
    ``r128``/``total_nnz`` carry the FULL operator's dimensions; layer
    structure (L, dspan, kept fraction) is taken from the sample and entry
    counts are scaled back up."""
    from ..utils import autotune

    nnz = m.nnz()
    scale = 1.0 if total_nnz is None else total_nnz / max(1, nnz)
    r128 = r128 if r128 is not None else -(-m.rows // LANES)
    _, d_s, r_s, _, _, lkey, kmax, dmin = _layer_keys(m, span)
    kept, spill_mask = _spill_decision(
        lkey, r_s, r128, max_layers=max_layers, count_scale=scale
    )
    layers, dspan, br, cost, viable = _span_stats(
        kept, int(spill_mask.sum() * scale), kmax, dmin, r128, span
    )
    kept_nnz = int((~spill_mask).sum() * scale)
    return dict(
        layers=layers,
        kept_nnz=kept_nnz,
        spill_nnz=int(nnz * scale) - kept_nnz,
        cost_ns=cost,
        dspan=dspan,
        br=br,
        span=span,
        viable=viable,
    )


def estimate_bell(m: CsrMatrix, *, max_layers: int = MAX_LAYERS):
    """Cheap dispatch estimate: dict with kept layer count, kept nnz,
    estimated kernel cost (ns), window span, and a viability flag —
    without building the slot arrays. Evaluates both bucket spans and
    reports the cheaper."""
    nnz = m.nnz()
    if nnz == 0:
        return dict(
            layers=0, kept_nnz=0, spill_nnz=0, cost_ns=0.0, dspan=0,
            br=0, span=_SPANS[0], viable=True,
        )
    # memoized per matrix: two dispatch branches (the lanepack-viability
    # corner and _general_choice) both estimate the same operator, and the
    # layer-key passes were ~40% of a small FixedSideSpgemm plan
    memo = m._cache.setdefault("estimate_bell", {})
    hit = memo.get(max_layers)
    if hit is not None:
        return hit
    if _sampled_reject(m):
        out = dict(
            layers=0, kept_nnz=0, spill_nnz=nnz, cost_ns=float("inf"),
            dspan=0, br=0, span=_SPANS[0], viable=False,
        )
        memo[max_layers] = out
        return out
    sub, r128o, tot = m, None, None
    if nnz > 800_000:
        from .csr import sample_row_bands

        sub, _ = sample_row_bands(m, 400_000)
        r128o = -(-m.rows // LANES)
        tot = nnz
    best = None
    for span in _SPANS:
        est = _estimate_for_span(
            sub, span, max_layers=max_layers, r128=r128o, total_nnz=tot
        )
        if best is None or (est["viable"] and est["cost_ns"] < best["cost_ns"]):
            best = est
    memo[max_layers] = best
    return best


def plan_bell(
    m: CsrMatrix, *, dtype=np.float32, max_layers: int = MAX_LAYERS,
    span: Optional[int] = None,
) -> BellPlan:
    """Build the BELL plan. O(nnz log nnz) vectorized host time; both
    bucket spans are estimated and the cheaper one built (``span=`` forces
    one)."""
    rows, cols, nnz = m.rows, m.cols, m.nnz()
    r128 = -(-rows // LANES)
    if nnz == 0:
        return BellPlan(
            rows=rows,
            cols=cols,
            ds=(),
            vals=np.zeros((0, r128, LANES), dtype),
            lane=np.zeros((0, r128, LANES), np.int8),
            modes=(),
            span=_SPANS[0],
            nnz=0,
            dtype=np.dtype(dtype),
            spill=None,
        )

    if span is None:
        # pick the span from FULL-matrix layer keys, not the sampled
        # estimate: row-band sampling changes the distinct-offset set and
        # with it every greedy bucket boundary — on femlike_262k the
        # sampled estimate saw 9 layers for BOTH spans and picked the
        # 5 B/slot span 128, while the full matrix packs span 128 into 18
        # half-filled layers (fill 0.43) vs span 256's 9 (fill 0.86).
        # plan_bell is already O(nnz log nnz); one extra key pass per
        # operator is dispatch-grade cheap next to shipping the wrong plan.
        best = None
        for cand in _SPANS:
            keys = _layer_keys(m, cand)
            kept_c, mask_c = _spill_decision(
                keys[5], keys[2], r128, max_layers=max_layers
            )
            _, _, _, cost, viable = _span_stats(
                kept_c, int(mask_c.sum()), keys[6], keys[7], r128, cand
            )
            # inviable candidates (dspan past the kernel's window cap, or
            # nothing kept) only win against other inviable candidates
            key = (not viable, cost)
            if best is None or key < best[0]:
                best = (key, cand, keys, kept_c, mask_c)
        _, span, keys, kept, spill_mask = best
        order, d_s, r_s, c_s, k, lkey, kmax, dmin = keys
    else:
        order, d_s, r_s, c_s, k, lkey, kmax, dmin = _layer_keys(m, span)
        kept, spill_mask = _spill_decision(lkey, r_s, r128, max_layers=max_layers)
    v_s = m.vals[order].astype(dtype)

    spill_plan = None
    if spill_mask.any():
        rr, cc, vv = r_s[spill_mask], c_s[spill_mask], v_s[spill_mask]
        # entries arrive in (d, r, c) order; the CSR contract is (r, c)
        so = np.lexsort((cc, rr))
        rr, cc, vv = rr[so], cc[so], vv[so]
        offs = np.zeros(rows + 1, np.int64)
        offs[1:] = np.bincount(rr, minlength=rows)
        np.cumsum(offs, out=offs)
        sub = CsrMatrix(rows, cols, vv, cc.astype(np.uint32), offs, is_sorted=True)
        spill_plan = plan_lanepack(sub, dtype=dtype)

    keep = ~spill_mask
    lk, r_k, c_k, v_k, d_k = (
        lkey[keep], r_s[keep], c_s[keep], v_s[keep], d_s[keep]
    )
    # remap kept layer keys -> dense layer indices (kept is sorted; lkey
    # sorts by (b, k), so same-b layers are adjacent — the kernel reuses
    # the x window slices across them)
    li = np.searchsorted(kept, lk)
    ds = tuple(int(x // kmax + dmin) for x in kept)

    L = len(ds)
    lane_dt = np.int8 if span == 128 else np.int16
    vals = np.zeros((L, r128, LANES), dtype)
    lane = np.zeros((L, r128, LANES), lane_dt)
    masks = [0] * L
    if len(li):
        rb = r_k // LANES
        rl = r_k % LANES
        pos = c_k - LANES * (rb + d_k)  # in [0, span + 127]
        written = np.zeros((L, r128, LANES), bool)
        vals[li, rb, rl] = v_k
        stored = pos - LANES if span == 128 else pos
        lane[li, rb, rl] = stored.astype(lane_dt)
        written[li, rb, rl] = True
        mask_arr = np.zeros(L, np.int64)
        np.bitwise_or.at(mask_arr, li, 1 << (pos >> 7))
        # padded slots point at index 0 of the layer's first USED half:
        # they contribute vals=0 and never force an unused window slice
        for i in range(L):
            h0 = 0
            mi = int(mask_arr[i])
            while mi and not (mi >> h0) & 1:
                h0 += 1
            pad = LANES * h0 - (LANES if span == 128 else 0)
            lane[i][~written[i]] = lane_dt(pad)
        masks = [int(x) for x in mask_arr]

    return BellPlan(
        rows=rows,
        cols=cols,
        ds=ds,
        vals=vals,
        lane=lane,
        modes=tuple(masks),
        span=span,
        nnz=nnz,
        dtype=np.dtype(dtype),
        spill=spill_plan,
    )

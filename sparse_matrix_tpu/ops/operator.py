"""Planned SpMV operator with automatic format selection.

A production sparse library picks the storage scheme from the structure of
the operator (MKL/cuSPARSE ship DIA/banded paths next to CSR). Here:

* band-structured matrices (few distinct diagonals, decently filled) go to
  DIA — index-free shifts+FMA SpMV at memory speed-of-light;
* everything else goes to one of the general slab formats (BELL, aligned,
  stripe, LanePack) or padded ELL, each evaluated by XLA.

The plan is built once and reused across applications (CG iterates the same
operator hundreds of times).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..formats.csr import CsrMatrix
from ..formats.dia import try_dia_from_csr
from ..formats.lanepack import plan_lanepack

__all__ = ["SpmvOperator", "split_bands"]

# a diagonal goes to the DIA part when at least this fraction of its slots
# hold nonzeros (the HYB-style split threshold)
BAND_FILL_THRESHOLD = 0.5
MIN_BAND_NNZ_FRACTION = 0.3  # hybrid only pays if bands cover enough nnz
# plan-size limit: general (non-banded) operators taller than this are
# planned as row shards, which bounds each shard's plan and its per-shard
# planning time. Inherited from the first target's on-chip memory budget;
# not re-tuned for the GPU.
_ROWS_SPLIT_LIMIT = 4_000_000
# f32-equivalent band-data size above which DIA matmat takes the packed
# layout (ops/spmv_dia.py); an inherited crossover, not measured on the GPU
_DIA_PACKED_MIN_BYTES = 48 * 1024 * 1024


def split_bands(
    m: CsrMatrix, *, fill_threshold: float = BAND_FILL_THRESHOLD
) -> tuple:
    """Split into (banded part, residual part) by per-diagonal fill.

    The HYB idea (ELL+COO in cuSPARSE terms) recast for this library:
    well-filled diagonals go to index-free DIA; stragglers go to the general
    format. Returns (dense_band_csr, residual_csr); either may be empty.
    """
    r = m.row_ids()
    c = m.indices.astype(np.int64)
    offs = c - r
    # dense histogram over the offset range (one bincount pass + an O(nnz)
    # table gather) — np.unique + np.isin were two full sorts of the nnz
    # stream, several seconds per probed operator of the 2048^2 AMG setup
    shift = m.rows - 1
    span = m.rows + m.cols - 1
    counts_d = np.bincount(offs + shift, minlength=span)
    uniq = np.nonzero(counts_d)[0]
    counts = counts_d[uniq]
    uniq = uniq - shift
    band_len = np.minimum(m.rows, m.cols - uniq.clip(min=0)) - np.maximum(0, -uniq).clip(min=0)
    band_len = np.maximum(band_len, 1)
    good_mask = np.zeros(span, dtype=bool)
    good_mask[uniq[counts >= fill_threshold * band_len] + shift] = True
    in_band = good_mask[offs + shift]
    def subset(mask):
        offsets = np.zeros(m.rows + 1, dtype=m.offsets.dtype)
        offsets[1:] = np.bincount(r[mask], minlength=m.rows)
        np.cumsum(offsets, out=offsets)
        return CsrMatrix(
            m.rows, m.cols, m.vals[mask], m.indices[mask], offsets, is_sorted=m.is_sorted
        )
    return subset(in_band), subset(~in_band)




def _shard_force(cur_force, first_op: "SpmvOperator"):
    """Format to force on the remaining shards of a row/col split: reuse
    the first shard's choice when it is one of the never-raising general
    formats. Split shards of one matrix are structurally homogeneous, and
    the per-shard dispatch estimators (DIA probe, chunk/slab counts, BELL
    spans) were a scaling term of the 4096^2 AMG setup. DIA/hybrid are
    not propagated — forcing them raises when a shard misses the gate."""
    if cur_force is not None:
        return cur_force
    if first_op.format in ("aligned", "lanepack", "bell", "ell", "stripe"):
        return first_op.format
    return None


_STATIC_KEYS = ("b", "br")  # step sizes: python ints, not device arrays


def _strip_static(d):
    """Drop static config entries (step sizes "b"/"br") from a
    device-array dict at ANY depth (aligned plans nest "spill" /
    "segments" dicts) so they never become traced pytree leaves."""
    if isinstance(d, dict):
        return {k: _strip_static(v) for k, v in d.items() if k not in _STATIC_KEYS}
    if isinstance(d, (list, tuple)):
        return type(d)(_strip_static(e) for e in d)
    return d


def _graft_static(params, ref):
    """Re-insert the static entries stripped by :func:`_strip_static`,
    taking them from the operator's own (concrete) arrays."""
    if isinstance(ref, dict):
        out = {}
        for k, v in ref.items():
            if k in _STATIC_KEYS:
                out[k] = v
            elif isinstance(v, (dict, list, tuple)):
                out[k] = _graft_static(params[k], v)
            else:
                out[k] = params[k]
        return out
    if isinstance(ref, (list, tuple)):
        return type(ref)(_graft_static(p_, r_) for p_, r_ in zip(params, ref))
    return params


class SpmvOperator:
    """``op = SpmvOperator(csr); y = op(x)`` — jit-friendly planned SpMV.

    Formats, picked by structure: ``dia`` (fully banded), ``hybrid``
    (well-filled diagonals in DIA + residual in LanePack), ``aligned``
    (destination-aligned slots — the fast general path when windows fill),
    or ``lanepack`` (segmented-reduce general path).
    """

    _values_dtype = None  # class default: loaded plans bypass __init__

    def __init__(self, m: CsrMatrix, *, dtype=np.float32,
                 force: Optional[str] = None, values_dtype=None,
                 stripe_cfg=None):
        # shard pinning: a row/col split's later shards reuse the first
        # shard's stripe (mode, L, KW) so each shard does not re-run the
        # pricing grid (split shards are structurally homogeneous)
        self._stripe_cfg_hint = stripe_cfg
        # values_dtype=bfloat16 stores the DIA band / BELL slot value
        # planes half-width (the dominant HBM stream of those kernels);
        # products widen to ``dtype`` before accumulation. Only the
        # streaming formats support it — anything else raises in its
        # _set_* so a silent f32 operator can't masquerade as bf16.
        self._values_dtype = values_dtype
        self.rows, self.cols = m.rows, m.cols
        self.nnz = m.nnz()
        self._dia = None
        self._plan = None
        self._aligned = None
        self._bell = None
        self._stripe = None
        self._ell = None
        self._ell_spill = None
        self._colsplit = None

        # Wide/tall operators: the general formats' plans are bounded by
        # the plan-size limits _VMEM_X_LIMIT (columns) and
        # _ROWS_SPLIT_LIMIT (rows). Unless the matrix is banded (DIA has
        # no such limit), split into shards within them: column shards sum their partial applies
        # (the single-chip analog of parallel/spmv.py's column-split), row
        # shards concatenate theirs. A giant general matrix recurses into
        # a grid of both.
        from .spmv import _VMEM_X_LIMIT

        self._rowsplit = None
        if (m.cols > _VMEM_X_LIMIT or m.rows > _ROWS_SPLIT_LIMIT) and force != "ell":
            banded = (
                try_dia_from_csr(m, dtype=dtype) if force in (None, "dia") else None
            )
            if banded is not None:
                self.format = "dia"
                self._set_dia(banded)
                return
            if force == "dia":
                raise ValueError("matrix is not band-structured enough for DIA")
            if m.cols > _VMEM_X_LIMIT:
                # column shards: masking a row-sorted CSR by a column range
                # preserves (row, col) order. The native two-pass partition
                # replaces ~7 numpy full-nnz passes per shard (the 4096^2
                # restriction operator spent seconds per shard here; the
                # from_coo path before that re-lexsorted every shard)
                from ..native import colsplit_native

                nsplit = -(-m.cols // _VMEM_X_LIMIT)
                bounds = np.linspace(0, m.cols, nsplit + 1).astype(np.int64)
                self.format = "colsplit"
                self._colsplit = []
                sub_force = force
                parts = colsplit_native(
                    m.rows, bounds, m.offsets, m.indices, m.vals
                )
                for s, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
                    if parts is not None:
                        offs, idx, vv = parts[0][s], parts[1][s], parts[2][s]
                    else:
                        cid = m.indices.astype(np.int64)
                        mask = (cid >= lo) & (cid < hi)
                        offs = np.zeros(m.rows + 1, np.int64)
                        offs[1:] = np.bincount(m.row_ids()[mask], minlength=m.rows)
                        np.cumsum(offs, out=offs)
                        idx = (cid[mask] - lo).astype(np.uint32)
                        vv = m.vals[mask]
                    sub = CsrMatrix(
                        m.rows, int(hi - lo), vv, idx, offs, is_sorted=m.is_sorted
                    )
                    sub_op = SpmvOperator(sub, dtype=dtype, force=sub_force,
                                  values_dtype=self._values_dtype,
                                  stripe_cfg=self._stripe_cfg_hint)
                    sub_force = _shard_force(sub_force, sub_op)
                    if self._stripe_cfg_hint is None:
                        self._stripe_cfg_hint = getattr(
                            sub_op, "_stripe_cfg", None)
                    self._colsplit.append((int(lo), int(hi), sub_op))
                return
            # row shards are contiguous row ranges: pure slices of the CSR
            nsplit = -(-m.rows // _ROWS_SPLIT_LIMIT)
            bounds = np.linspace(0, m.rows, nsplit + 1).astype(np.int64)
            self._build_rowsplit(m, bounds, dtype, force)
            return

        if force == "aligned":
            self.format = "aligned"
            self._set_aligned(m, dtype)
            return

        if force == "bell":
            self.format = "bell"
            self._set_bell(m, dtype)
            return

        if force == "stripe":
            self.format = "stripe"
            self._set_stripe(m, dtype)
            return

        if force in (None, "dia"):
            dia = try_dia_from_csr(m, dtype=dtype)
            if dia is not None:
                self.format = "dia"
                self._set_dia(dia)
                return
            if force == "dia":
                raise ValueError("matrix is not band-structured enough for DIA")

        if force in (None, "hybrid") and (
            force == "hybrid" or self._hybrid_plausible(m)
        ):
            banded, residual = split_bands(m)
            if (
                banded.nnz() >= MIN_BAND_NNZ_FRACTION * max(1, m.nnz())
                and residual.nnz() > 0
            ):
                dia = try_dia_from_csr(banded, dtype=dtype, min_fill=0.0)
                if dia is not None:
                    self.format = "hybrid"
                    self._set_dia(dia)
                    # residual may itself be hyper-sparse: route it by the
                    # same LanePack-vs-ELL guard (a pathological residual
                    # plan would blow the SMEM scalar-prefetch budget)
                    if self._lanepack_viable(residual):
                        self._set_plan(residual, dtype)
                    else:
                        self._set_ell(residual, dtype)
                    return
            if force == "hybrid":
                raise ValueError("no useful band/residual split")

        if force in (None, "ell"):
            # hyper-sparse guard: when LanePack packing would be pathologically
            # empty (slab memory blowup) and padded ELL is compact, consider
            # ELL — but PRICE it first (autotune ell_gather_ns): the byte
            # heuristic alone misrouted the SpGEMM-as-SpMV selection
            # matrices (740k rows, ~1.1 nnz/row) to ELL on the first target,
            # where its gather was 50x slower than LanePack.
            plan_est = self._estimate_lanepack_bytes(m)
            row_max = int(np.diff(m.offsets).max()) if m.nnz() else 1
            ell_bytes = m.rows * max(1, row_max) * 8
            if force == "ell":
                self.format = "ell"
                self._set_ell(m, dtype)
                return
            if plan_est > 4 * m.nnz() * 8 and ell_bytes < plan_est / 2:
                from ..utils import autotune

                # absolute cap: never materialize a near-2-GiB slab plan
                # just to dodge gathers (ADVICE r4: a cost-model win at
                # ~1.9 GiB of plan bytes pressures HBM alongside other
                # residents — cap at 512 MiB, ~16x any plan this library
                # has measured a win on)
                if plan_est > 1 << 29:
                    self.format = "ell"
                    self._set_ell(m, dtype)
                    return
                t_aligned, t_gen, _ = self._general_costs(m)
                t_lp = (
                    t_gen
                    if t_gen is not None and self._lanepack_viable(m)
                    else float("inf")
                )
                ell_ns = (
                    m.rows * max(1, row_max) * autotune.get("ell_gather_ns")
                )
                if ell_ns <= min(t_aligned, t_lp):
                    self.format = "ell"
                    self._set_ell(m, dtype)
                    return
                # otherwise fall through to the regular dispatch (viability
                # branch + _general_choice pick among stripe/bell/aligned/
                # lanepack/rowsplit as usual)
            if not self._lanepack_viable(m):
                # too many slabs for the 1 MB SMEM scalar prefetch — but the
                # BELL and aligned kernels run big plans without scalar
                # prefetch, so ELL (whose x-gather crawls at ~0.14 Gelem/s)
                # is only the last resort. Regression: Poisson 2048^2's
                # prolongators (21M nnz) fell to ELL and the V-cycle ran
                # ~100x slow.
                from ..formats.bell import estimate_bell
                from .spmv import _VMEM_X_LIMIT

                est = estimate_bell(m)
                bell_ok = est["viable"] and est["spill_nnz"] <= est["kept_nnz"]
                t_aligned, t_gen, slabs = self._general_costs(m)
                t_bell = est["cost_ns"] if bell_ok else float("inf")
                # the stripe family was built for exactly this corner
                # (scatter/skew structure beyond LanePack's SMEM budget)
                t_stripe, stripe_ok, scfg = self._stripe_cost_and_viable(m)
                if stripe_ok and t_stripe < min(
                    t_aligned, t_bell,
                    t_gen if t_gen is not None else float("inf"),
                ):
                    self.format = "stripe"
                    self._set_stripe(m, dtype, cfg=scfg)
                    return
                # SMEM row-split: when LanePack is the clear cost-model
                # winner but its scalar-prefetch arrays exceed the 1 MB
                # SMEM, shard rows so each part fits and re-dispatch the
                # shards. Found by the round-4 row-skew corpus: the
                # 262k-row power-law class collapsed the aligned planner
                # to fill 0.012 (0.67 Gnnz/s) while split LanePack is the
                # 10-26 Gnnz/s family (corpus_r4.out).
                if (
                    t_gen is not None
                    and slabs is not None
                    and t_gen < 0.7 * min(t_aligned, t_bell)
                ):
                    # viability bound: slabs * 44 B < 800 kB (see
                    # _lanepack_viable); 1.3x headroom for uneven shards
                    nsplit = int(np.ceil(slabs * 44.0 * 1.3 / 800_000)) + 1
                    if 2 <= nsplit <= 64 and m.rows >= 256 * nsplit:
                        # balance shards by nnz, snapped to row boundaries
                        targets = np.linspace(0, m.nnz(), nsplit + 1)[1:-1]
                        cuts = np.searchsorted(m.offsets, targets)
                        bounds = np.unique(
                            np.r_[0, cuts, m.rows].astype(np.int64)
                        )
                        self._build_rowsplit(m, bounds, dtype, None)
                        return
                if bell_ok:
                    self.format = "bell"
                    self._set_bell(m, dtype)
                    return
                if m.nnz() > 0 and m.cols <= _VMEM_X_LIMIT:
                    self.format = "aligned"
                    self._set_aligned(m, dtype)
                    return
                self.format = "ell"
                self._set_ell(m, dtype)
                return

        # BELL vs aligned vs general LanePack: compare estimated kernel
        # times (autotuned per-chunk/per-slab costs x estimated counts); an
        # explicit force="lanepack" bypasses the comparison
        if force is None:
            choice = self._general_choice(m)
            if choice == "bell":
                self.format = "bell"
                self._set_bell(m, dtype)
                return
            if choice == "aligned":
                self.format = "aligned"
                self._set_aligned(m, dtype)
                return
            if choice == "stripe":
                self.format = "stripe"
                # memoized counts make the re-call ~free; it recovers the
                # grid argmin so plan_stripe skips its own grid
                _t, _ok, scfg = self._stripe_cost_and_viable(m)
                self._set_stripe(m, dtype, cfg=scfg)
                return

        self.format = "lanepack"
        self._set_plan(m, dtype)

    # above this nnz the dispatch cost estimators run on sampled row bands
    # (full _chunk_keys + 5x _count_slabs passes cost ~50 s of a 2048^2 AMG
    # setup; contiguous bands preserve the local structure the estimators
    # key on, and the counts they produce scale linearly in nnz). Round 5
    # lowered 1.5M -> 500k: pricing dominated sub-M selection-matrix plans
    # (2.0 s of a 2.8 s FixedSideSpgemm plan at uniform2048) and the 200k
    # sample target leaves >=2.5x real sampling at the new threshold
    _SAMPLED_COSTS_NNZ = 500_000

    def _build_rowsplit(self, m, bounds, dtype, force):
        """Shard ``m`` into contiguous row ranges (pure CSR slices), one
        sub-operator each; applies concatenate (``__call__``)."""
        self.format = "rowsplit"
        self._rowsplit = []
        sub_force = force
        sub_cfg = None
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            lo_o, hi_o = int(m.offsets[lo]), int(m.offsets[hi])
            sub = CsrMatrix(
                int(hi - lo),
                m.cols,
                m.vals[lo_o:hi_o],
                m.indices[lo_o:hi_o],
                m.offsets[lo : hi + 1] - lo_o,
                is_sorted=m.is_sorted,
            )
            sub_op = SpmvOperator(sub, dtype=dtype, force=sub_force,
                                  values_dtype=self._values_dtype,
                                  stripe_cfg=sub_cfg)
            sub_force = _shard_force(sub_force, sub_op)
            if sub_cfg is None:
                sub_cfg = getattr(sub_op, "_stripe_cfg", None)
            self._rowsplit.append((int(lo), int(hi), sub_op))

    @staticmethod
    def _general_costs(m: CsrMatrix):
        """(t_aligned, t_lanepack, lanepack_slabs) estimated kernel ns for
        the two round-2 general families (autotuned constants x estimated
        counts) plus the best-kw slab count (the SMEM-viability quantity);
        counts come from sampled row bands on large matrices."""
        from ..formats.aligned import _chunk_keys
        from ..formats.csr import sample_row_bands
        from ..formats.lanepack import _count_slabs, _cost_constants
        from ..utils import autotune

        scale = 1.0
        mm = m
        if m.nnz() > SpmvOperator._SAMPLED_COSTS_NNZ:
            mm, scale = sample_row_bands(m)
        _, _, _, ck = _chunk_keys(mm)
        chunks = int(len(np.unique(ck))) * scale
        # two-term aligned model (base per slab + per-entry): a single
        # per-slab constant overestimates sparse-chunk matrices ~2.5x
        # (see autotune.py aligned_slab_* calibration notes) — floored by
        # the per-chunk x-window cost, which DOMINATES scatter-heavy plans
        # (the per-entry fit underpriced powerlaw_262k 3x and misrouted it
        # here at fill 0.012). The floor's ns/chunk scales with the
        # per-row-block x working set (window locality); see the
        # aligned_chunk_floor_* calibration in utils/autotune.py.
        if mm.nnz():
            rbs = mm.row_ids() // 128
            heads = np.nonzero(np.r_[True, rbs[1:] != rbs[:-1]])[0]
            cc = mm.indices.astype(np.int64)
            ws_bytes = 4.0 * float(
                np.median(
                    np.maximum.reduceat(cc, heads)
                    - np.minimum.reduceat(cc, heads)
                    + 1
                )
            )
        else:
            ws_bytes = 1.0
        lo, hi = autotune.get("aligned_chunk_floor_lo_ns"), autotune.get(
            "aligned_chunk_floor_hi_ns"
        )
        frac = min(1.0, max(0.0, (np.log2(max(ws_bytes, 1.0)) - 15.0) / 5.0))
        t_aligned = max(
            (chunks / 8.0) * autotune.get("aligned_slab_base_ns")
            + m.nnz() * autotune.get("aligned_slab_per_entry_ns"),
            chunks * (lo + (hi - lo) * frac),
        )
        c_fixed, c_kw, _, _ = _cost_constants()
        t_gen = None
        gen_slabs = None
        for kw in (1, 2, 4, 8, 16):
            if kw * 128 > m.cols + 128:
                break
            s = _count_slabs(mm, kw) * scale
            t = s * (c_fixed + c_kw * kw)
            if t_gen is None or t < t_gen:
                t_gen, gen_slabs = t, s
        return t_aligned, t_gen, gen_slabs

    @staticmethod
    def _stripe_cost_and_viable(m: CsrMatrix):
        """(best stripe ns, viable, (mode, L, KW) argmin) over the grid —
        sampled counts on large matrices; stripe is the multi-level
        scatter-class family (formats/stripe.py) and enters dispatch only
        when its scalar-prefetch arrays fit SMEM. The argmin config is
        threaded into :func:`plan_stripe` so the planner does not re-run
        the same grid (counts/spill-frac are memoized per sample, but the
        double grid was still ~2 s of a 1024² AmgRefresh plan)."""
        from ..formats.stripe import _mode_cost, _cost_constants
        from ..formats.stripe import _stripe_counts

        mm, scale = SpmvOperator._sampled_for_counts(m)
        consts = _cost_constants()
        best, best_slabs, best_cfg = None, None, None
        for mode in ("scan", "select"):
            for lc in (2, 4, 8):
                if (lc // 2) * 128 >= m.rows + 128:
                    continue
                for kc in (1, 2, 4, 8, 16):
                    if kc > 1 and (kc // 2) * 128 > m.cols + 128:
                        continue
                    t = _mode_cost(
                        mm, mode, lc, kc, mm.nnz(), consts,
                        best=None if best is None else best / scale,
                    ) * scale
                    if best is None or t < best:
                        best = t
                        best_cfg = (mode, lc, kc)
                        best_slabs = _stripe_counts(
                            mm, lc, kc, 128 if mode == "scan" else 127,
                        )[0] * scale
        if best is None:
            return float("inf"), False, None
        viable = best_slabs is not None and best_slabs * 36 < 800_000
        return best, viable, best_cfg

    @staticmethod
    def _general_choice(m: CsrMatrix) -> str:
        """Pick the general-path family by estimated kernel time:
        ``bell`` (high-fill local structure), ``aligned``, ``stripe``
        (multi-level scatter family), or ``lanepack``."""
        from ..formats.bell import estimate_bell

        if m.nnz() == 0:
            return "lanepack"
        est = estimate_bell(m)
        # a mostly-spilled hybrid is lanepack wearing a BELL hat: require
        # the kept planes to carry the majority of the nnz (same gate as
        # the force path above)
        bell_ok = est["viable"] and est["spill_nnz"] <= est["kept_nnz"]
        t_bell = est["cost_ns"] if bell_ok else float("inf")
        t_aligned, t_gen, _slabs = SpmvOperator._general_costs(m)
        t_stripe, stripe_ok, _scfg = SpmvOperator._stripe_cost_and_viable(m)
        t_gen_f = t_gen if t_gen is not None else float("inf")
        # stripe margin 0.8 -> 0.9 (round 5): the constants are now a
        # measured-grid refit (scan residuals <=5%, fit_stripe_consts.out)
        # rather than the r4 five-point extrapolation; at 0.8 the refit
        # pushed randlocal to aligned (294 us model) over stripe scan(2,2)
        # (254 model, 255 measured vs aligned's 270) — a shipped
        # regression the margin itself caused
        if stripe_ok and t_stripe < 0.9 * min(t_bell, t_aligned, t_gen_f):
            return "stripe"
        if t_bell < t_aligned and (t_gen is None or t_bell < t_gen):
            return "bell"
        if t_gen is None or t_aligned < t_gen:
            return "aligned"
        return "lanepack"

    @staticmethod
    def _aligned_wins(m: CsrMatrix) -> bool:
        if m.nnz() == 0:
            return False
        t_aligned, t_gen, _slabs = SpmvOperator._general_costs(m)
        return t_gen is None or t_aligned < t_gen

    @staticmethod
    def _hybrid_plausible(m: CsrMatrix) -> bool:
        """Sampled pre-filter for the hybrid (DIA+general) split probe:
        estimate the nnz fraction on well-filled diagonals from a row-band
        sample (element offsets are shift-invariant under the sampling);
        the full split_bands pass — a dense offset histogram plus two
        subset builds, ~2 s of a 2048^2 AMG setup across the prolongator
        shards — only runs when the estimate is within 2x of the gate."""
        if m.nnz() <= SpmvOperator._SAMPLED_COSTS_NNZ:
            return True
        from ..formats.csr import sample_row_bands

        sub, _ = sample_row_bands(m)
        so = sub.indices.astype(np.int64) - sub.row_ids()
        _, counts = np.unique(so, return_counts=True)
        good = counts >= BAND_FILL_THRESHOLD * 0.5 * sub.rows
        frac = counts[good].sum() / max(1, sub.nnz())
        return frac >= 0.5 * MIN_BAND_NNZ_FRACTION

    @staticmethod
    def _sampled_for_counts(m: CsrMatrix):
        """(sub, scale) for slab-count estimates: sampled row bands above
        the cost cap (the full-matrix count passes were seconds per 2048^2
        AMG operator; counts scale linearly in nnz)."""
        if m.nnz() > SpmvOperator._SAMPLED_COSTS_NNZ:
            from ..formats.csr import sample_row_bands

            return sample_row_bands(m)
        return m, 1.0

    @staticmethod
    def _lanepack_viable(m: CsrMatrix) -> bool:
        """Slab-count limit of a LanePack plan (per-slab index arrays under
        ~800 kB); larger plans go to another format or a row split."""
        from ..formats.lanepack import _count_slabs

        mm, scale = SpmvOperator._sampled_for_counts(m)
        slabs = min(
            (
                _count_slabs(mm, kw) * scale
                for kw in (1, 2, 4, 8, 16)
                if kw * 128 <= m.cols + 128
            ),
            default=0,
        )
        return slabs * 8 * 4 + slabs * 3 * 4 < 800_000

    @staticmethod
    def _estimate_lanepack_bytes(m: CsrMatrix) -> int:
        from ..formats.lanepack import _count_slabs

        mm, scale = SpmvOperator._sampled_for_counts(m)
        best = None
        for kw in (1, 2, 4, 8, 16):
            if kw * 128 > m.cols + 128:
                break
            s = _count_slabs(mm, kw) * scale
            b = int(s) * 1024 * 8
            best = b if best is None else min(best, b)
        return best if best is not None else m.nnz() * 8

    def _set_ell(self, m, dtype):
        import jax.numpy as jnp

        from .spmv import ell_from_csr, ell_spill_from_csr

        self._no_bf16("ell")

        # width guard: one dense row must not inflate the padded array to
        # rows x max_row_nnz — skewed matrices get a capped ELL + COO spill
        row_nnz = np.diff(m.offsets)
        w_full = max(1, int(row_nnz.max())) if m.nnz() else 1
        q99 = int(np.quantile(row_nnz, 0.99)) if m.nnz() else 1
        if w_full > 2 * max(1, 2 * q99):
            from ..utils.transfer import to_device

            ev, ec, sr, sc, sv = ell_spill_from_csr(m, dtype=dtype)
            self._ell = (to_device(ev), to_device(ec))
            self._ell_spill = (to_device(sr), to_device(sc), to_device(sv))
        else:
            from ..utils.transfer import to_device

            ev, ec = ell_from_csr(m, dtype=dtype)
            self._ell = (to_device(ev), to_device(ec))
            self._ell_spill = None

    def _no_bf16(self, fmt: str):
        if self._values_dtype is not None:
            raise ValueError(
                f"values_dtype is only supported on the streaming formats "
                f"(dia, bell); dispatch chose {fmt!r} — force='dia' or "
                f"force='bell', or drop values_dtype"
            )

    def _set_aligned(self, m, dtype):
        from ..formats.aligned import plan_aligned
        from .spmv import aligned_device_arrays

        self._no_bf16("aligned")
        self._aligned = plan_aligned(m, dtype=dtype)
        self._ali_arrs = aligned_device_arrays(self._aligned)

    def _set_bell(self, m, dtype):
        from ..formats.bell import plan_bell
        from .spmv_bell import bell_device_arrays

        self._bell = plan_bell(m, dtype=dtype)
        self._bell_arrs = bell_device_arrays(
            self._bell, values_dtype=self._values_dtype
        )

    def _set_stripe(self, m, dtype, cfg=None):
        from ..formats.stripe import plan_stripe
        from .spmv import stripe_device_arrays

        self._no_bf16("stripe")
        cfg = cfg or getattr(self, "_stripe_cfg_hint", None)
        if cfg is not None:
            mode, lvl, kw = cfg
            self._stripe = plan_stripe(m, dtype=dtype, mode=mode,
                                       levels=lvl, kw=kw)
        else:
            self._stripe = plan_stripe(m, dtype=dtype)
        # requested config (select mode may degrade the plan's kw to the
        # measured gather width): what shard pinning must reuse
        self._stripe_cfg = cfg or (self._stripe.mode, self._stripe.levels,
                                   self._stripe.kw)
        self._stripe_arrs = stripe_device_arrays(self._stripe)

    def _set_dia(self, dia):
        from .spmv_dia import dia_device_arrays

        self._dia = dia
        self._dia_arrs = dia_device_arrays(
            dia, values_dtype=self._values_dtype
        )

    def _set_plan(self, m, dtype):
        from .spmv import lanepack_device_arrays

        # hybrid keeps its DIA part bf16-capable; the lanepack residual
        # stays f32 (it is the minority nnz by construction)
        if self.format not in ("hybrid",):
            self._no_bf16("lanepack")
        self._plan = plan_lanepack(m, dtype=dtype)
        self._lp_arrs = lanepack_device_arrays(self._plan)

    def __call__(self, x):
        if getattr(self, "_rowsplit", None) is not None:
            import jax.numpy as jnp

            return jnp.concatenate([sub(x) for _lo, _hi, sub in self._rowsplit])
        if getattr(self, "_colsplit", None) is not None:
            y = None
            for lo, hi, sub in self._colsplit:
                yp = sub(x[lo:hi])
                y = yp if y is None else y + yp
            return y
        y = None
        if self._bell is not None:
            from .spmv_bell import spmv_bell

            y = spmv_bell(self._bell, x, device_arrays=self._bell_arrs)
        if self._stripe is not None:
            from .spmv import spmv_stripe

            y = spmv_stripe(self._stripe, x, device_arrays=self._stripe_arrs)
        if self._aligned is not None:
            from .spmv import spmv_aligned

            y = spmv_aligned(self._aligned, x, device_arrays=self._ali_arrs)
        if self._dia is not None:
            from .spmv_dia import spmv_dia

            y = spmv_dia(self._dia, x, device_arrays=self._dia_arrs)
        if self._plan is not None:
            from .spmv import spmv_lanepack

            y2 = spmv_lanepack(self._plan, x, device_arrays=self._lp_arrs)
            y = y2 if y is None else y + y2
        if self._ell is not None:
            if getattr(self, "_ell_spill", None) is not None:
                from .spmv import spmv_ell_spill_xla

                y3 = spmv_ell_spill_xla(
                    self._ell[0], self._ell[1], *self._ell_spill, x
                )
            else:
                from .spmv import spmv_ell_xla

                y3 = spmv_ell_xla(self._ell[0], self._ell[1], x)
            y = y3 if y is None else y + y3
        return y

    def as_pytree(self):
        """The operator's DEVICE arrays as a pytree, for passing the
        operator as a jit ARGUMENT via :meth:`apply`.

        Why: closure-captured operators embed their arrays as program
        constants; at 2048² Poisson that is 84 MB per compiled program,
        which lengthens compilation and bloats the compile cache.
        ``jax.jit(lambda params,
        b: cg_solve(lambda v: op.apply(params, v), b))(op.as_pytree(), b)``
        keeps the program small and the arrays as runtime operands.
        """
        if getattr(self, "_rowsplit", None) is not None:
            return {"rowsplit": [sub.as_pytree() for _lo, _hi, sub in self._rowsplit]}
        if getattr(self, "_colsplit", None) is not None:
            return {"colsplit": [sub.as_pytree() for _lo, _hi, sub in self._colsplit]}
        params = {}
        if self._dia is not None:
            params["dia"] = {"data": self._dia_arrs["data"]}
        if self._aligned is not None:
            params["ali"] = _strip_static(self._ali_arrs)
        if self._bell is not None:
            params["bell"] = _strip_static(self._bell_arrs)
        if self._stripe is not None:
            params["stripe"] = _strip_static(self._stripe_arrs)
        if self._plan is not None:
            params["lp"] = _strip_static(self._lp_arrs)
        if self._ell is not None:
            params["ell"] = self._ell
            if getattr(self, "_ell_spill", None) is not None:
                params["ell_spill"] = self._ell_spill
        return params

    def apply(self, params, x):
        """``y = A @ x`` using :meth:`as_pytree` params instead of the
        operator's own (constant-embedding) arrays; jit-traceable with
        ``params`` as an argument."""
        if getattr(self, "_rowsplit", None) is not None:
            import jax.numpy as jnp

            return jnp.concatenate(
                [
                    sub.apply(pp, x)
                    for (_lo, _hi, sub), pp in zip(self._rowsplit, params["rowsplit"])
                ]
            )
        if getattr(self, "_colsplit", None) is not None:
            y = None
            for (lo, hi, sub), pp in zip(self._colsplit, params["colsplit"]):
                yp = sub.apply(pp, x[lo:hi])
                y = yp if y is None else y + yp
            return y
        y = None
        if self._bell is not None:
            from .spmv_bell import spmv_bell

            bl = _graft_static(params["bell"], self._bell_arrs)
            y = spmv_bell(self._bell, x, device_arrays=bl)
        if self._stripe is not None:
            from .spmv import spmv_stripe

            st = _graft_static(params["stripe"], self._stripe_arrs)
            y = spmv_stripe(self._stripe, x, device_arrays=st)
        if self._aligned is not None:
            from .spmv import spmv_aligned

            ali = _graft_static(params["ali"], self._ali_arrs)
            y = spmv_aligned(self._aligned, x, device_arrays=ali)
        if self._dia is not None:
            from .spmv_dia import spmv_dia

            y2 = spmv_dia(self._dia, x, device_arrays=params["dia"])
            y = y2 if y is None else y + y2
        if self._plan is not None:
            from .spmv import spmv_lanepack

            lp = _graft_static(params["lp"], self._lp_arrs)
            y2 = spmv_lanepack(self._plan, x, device_arrays=lp)
            y = y2 if y is None else y + y2
        if self._ell is not None:
            if params.get("ell_spill") is not None:
                from .spmv import spmv_ell_spill_xla

                y3 = spmv_ell_spill_xla(*params["ell"], *params["ell_spill"], x)
            else:
                from .spmv import spmv_ell_xla

                y3 = spmv_ell_xla(*params["ell"], x)
            y = y3 if y is None else y + y3
        return y

    def matmat(self, x):
        """Y = A @ X for X of shape (cols, K) — the multi-RHS apply.

        Every format runs a true SpMM path (the gathered operand/window
        loads amortize K-fold): DIA shifted-slice SpMM,
        aligned and lanepack packed-RHS forms, ELL gather-reuse
        XLA; hybrid sums its DIA and lanepack parts. Iterative multi-RHS
        solvers on aligned/lanepack operators should prefer the packed
        layout directly (:func:`~.spmm.aligned_matvec_multi` /
        :func:`~.spmm.lanepack_matvec_multi` + ``cg_solve_multi(rhs_axis=1)``)
        to also skip the per-apply relayout."""
        import jax.numpy as jnp

        x = jnp.asarray(x)
        if getattr(self, "_rowsplit", None) is not None:
            return jnp.concatenate(
                [sub.matmat(x) for _lo, _hi, sub in self._rowsplit], axis=0
            )
        if getattr(self, "_colsplit", None) is not None:
            y = None
            for lo, hi, sub in self._colsplit:
                yp = sub.matmat(x[lo:hi])
                y = yp if y is None else y + yp
            return y
        y = None
        if self._bell is not None:
            from .spmm import bell_spmm_viable, spmm_bell

            k = int(x.shape[1])
            # inherited crossover (not measured on the GPU): packed at
            # K >= 8, the per-column loop below; K > 16 runs in packed
            # chunks
            if k >= 8 and bell_spmm_viable(self._bell, min(k, 16)):
                nchunks = -(-k // 16)  # balanced chunks, each in [8, 16]
                base, rem = divmod(k, nchunks)
                sizes = [base + (i < rem) for i in range(nchunks)]
                parts, j = [], 0
                for step in sizes:
                    parts.append(
                        spmm_bell(self._bell, x[:, j:j + step],
                                  device_arrays=self._bell_arrs))
                    j += step
                y = parts[0] if len(parts) == 1 else jnp.concatenate(
                    parts, axis=1)
            else:
                # small K / giant packed RHS: per-column loop over the
                # streaming kernel (operand reuse via the shared arrays)
                from .spmv_bell import spmv_bell

                y = jnp.stack(
                    [
                        spmv_bell(self._bell, x[:, j], device_arrays=self._bell_arrs)
                        for j in range(k)
                    ],
                    axis=1,
                )
        if self._stripe is not None:
            from .spmv import spmv_stripe

            # per-column loop (no packed stripe SpMM kernel yet; the
            # format targets single-vector no-locality SpMV)
            y = jnp.stack(
                [
                    spmv_stripe(self._stripe, x[:, j],
                                device_arrays=self._stripe_arrs)
                    for j in range(int(x.shape[1]))
                ],
                axis=1,
            )
        if self._dia is not None:
            from .spmm import spmm_dia
            from .spmv_dia import spmm_dia_stream

            k = int(x.shape[1])
            arrs = self._dia_arrs
            if (
                arrs["data"].size * 4 > _DIA_PACKED_MIN_BYTES
                and self._dia.rows == self._dia.cols
                and k >= 2
            ):
                # large operators: band planes read ONCE per chunk of
                # <=16 columns (vs K re-reads in the shifted-slice form)
                nchunks = -(-k // 16)
                base, rem = divmod(k, nchunks)
                sizes = [base + (i < rem) for i in range(nchunks)]
                parts, j = [], 0
                for step in sizes:
                    if step >= 2:
                        parts.append(spmm_dia_stream(
                            self._dia, x[:, j:j + step], device_arrays=arrs))
                    else:
                        from .spmv_dia import spmv_dia

                        parts.append(spmv_dia(
                            self._dia, x[:, j], device_arrays=arrs)[:, None])
                    j += step
                y = parts[0] if len(parts) == 1 else jnp.concatenate(
                    parts, axis=1)
            else:
                y = spmm_dia(self._dia, x)
        if self._aligned is not None:
            from .spmm import spmm_aligned

            y2 = spmm_aligned(
                self._aligned, x, device_arrays=self._spmm_cache(int(x.shape[1]))
            )
            y = y2 if y is None else y + y2
        if self._plan is not None:
            from .spmm import _lp_spmm_use_kernel, spmm_lanepack

            if not _lp_spmm_use_kernel(self._plan, int(x.shape[1])):
                # per-column loop on the operator's own SpMV arrays: on
                # large plans at small K the packed kernel's relayout cost
                # loses to K launches (measured dispatch note in spmm.py)
                from .spmv import spmv_lanepack

                y2 = jnp.stack(
                    [
                        spmv_lanepack(self._plan, x[:, k], device_arrays=self._lp_arrs)
                        for k in range(x.shape[1])
                    ],
                    axis=1,
                )
            else:
                y2 = spmm_lanepack(
                    self._plan, x, device_arrays=self._spmm_cache(int(x.shape[1]))
                )
            y = y2 if y is None else y + y2
        if self._ell is not None:
            from .spmm import spmm_ell_xla

            y2 = spmm_ell_xla(self._ell[0], self._ell[1], x)
            if getattr(self, "_ell_spill", None) is not None:
                sr, sc, sv = self._ell_spill
                y2 = y2.at[sr].add(sv[:, None] * x[sc])
            y = y2 if y is None else y + y2
        return y

    def _spmm_cache(self, k: int):
        """Per-K device arrays for the packed SpMM kernels, built once.

        The first matmat may run inside a jit trace; without the eager
        guard the cached constants would be tracers that leak into later
        traces (UnexpectedTracerError)."""
        import jax

        from .spmm import _pick_b_lp_spmm, _pick_b_spmm

        # each kernel family has its own step-size picker; a mismatched b
        # makes spmm_*_packed silently rebuild (re-upload) per apply
        if self._aligned is not None:
            bk = ("ali", _pick_b_spmm(k))
        else:
            bk = ("lp", _pick_b_lp_spmm(k, self._plan.kw))
        cache = getattr(self, "_spmm_arrs", {})
        if bk not in cache:
            with jax.ensure_compile_time_eval():
                if self._aligned is not None:
                    from .spmv import aligned_device_arrays

                    cache[bk] = aligned_device_arrays(self._aligned, b=bk[1])
                else:
                    from .spmv import lanepack_device_arrays

                    cache[bk] = lanepack_device_arrays(self._plan, b=bk[1])
            self._spmm_arrs = cache
        return cache[bk]

    def bytes_per_apply(self) -> int:
        """HBM bytes streamed per SpMV (operator data only)."""
        if getattr(self, "_rowsplit", None) is not None:
            return sum(sub.bytes_per_apply() for _lo, _hi, sub in self._rowsplit)
        if getattr(self, "_colsplit", None) is not None:
            return sum(sub.bytes_per_apply() for _lo, _hi, sub in self._colsplit)
        if self.format == "ell":
            total = int(self._ell[0].nbytes + self._ell[1].nbytes)
            if getattr(self, "_ell_spill", None) is not None:
                total += sum(int(a.nbytes) for a in self._ell_spill)
            return total
        total = 0
        if self._dia is not None:
            total += int(self._dia.data.nbytes)
        if self._plan is not None:
            total += self._plan.slot_bytes()
        if self._aligned is not None:
            total += self._aligned.slot_bytes()
        if self._bell is not None:
            total += self._bell.slot_bytes()
        if self._stripe is not None:
            total += self._stripe.slot_bytes()
        return total


def _lanepack_payload(pl, prefix: str) -> dict:
    return {
        prefix + "kw": pl.kw, prefix + "pack": pl.pack, prefix + "rows": pl.rows,
        prefix + "cols": pl.cols, prefix + "nnz": pl.nnz, prefix + "vals": pl.vals,
        prefix + "lane": pl.lane, prefix + "ends": pl.ends, prefix + "starts": pl.starts,
        prefix + "rb_a": pl.rb_a, prefix + "rb_b": pl.rb_b, prefix + "split": pl.split,
        prefix + "chunk_rb": pl.chunk_rb, prefix + "col_off": pl.col_off,
        prefix + "rb_mask": pl.rb_mask,
    }


def _lanepack_from_payload(z, prefix: str):
    from ..formats.lanepack import LanePackPlan

    return LanePackPlan(
        rows=int(z[prefix + "rows"]), cols=int(z[prefix + "cols"]),
        kw=int(z[prefix + "kw"]), pack=str(z[prefix + "pack"]),
        vals=z[prefix + "vals"], lane=z[prefix + "lane"], ends=z[prefix + "ends"],
        starts=z[prefix + "starts"], rb_a=z[prefix + "rb_a"], rb_b=z[prefix + "rb_b"],
        split=z[prefix + "split"], chunk_rb=z[prefix + "chunk_rb"],
        col_off=z[prefix + "col_off"], rb_mask=z[prefix + "rb_mask"],
        nnz=int(z[prefix + "nnz"]), dtype=z[prefix + "vals"].dtype,
    )


def save_operator_plan(op: SpmvOperator, path: str) -> None:
    """Persist a planned operator's arrays (npz) so later processes skip
    planning (the checkpoint/resume analog for plans). Split (colsplit/
    rowsplit) operators persist each shard recursively under ``s{i}_``
    key prefixes."""
    payload = {}
    _payload_into(op, "", payload)
    np.savez_compressed(path, **payload)


def _payload_into(op: SpmvOperator, pre: str, payload: dict) -> None:
    payload[pre + "format"] = op.format
    payload[pre + "rows"] = op.rows
    payload[pre + "cols"] = op.cols
    payload[pre + "nnz"] = op.nnz
    parts = getattr(op, "_rowsplit", None)
    kind = "row"
    if parts is None:
        parts = getattr(op, "_colsplit", None)
        kind = "col"
    if parts is not None:
        payload[pre + "split_kind"] = kind
        payload[pre + "split_bounds"] = np.asarray(
            [p[0] for p in parts] + [parts[-1][1]], np.int64
        )
        for i, (_lo, _hi, sub) in enumerate(parts):
            _payload_into(sub, pre + f"s{i}_", payload)
        return
    if getattr(op, "_aligned", None) is not None:
        al = op._aligned
        payload.update({
            pre + "ali_vals": al.vals, pre + "ali_lane": al.lane,
            pre + "ali_col_off": al.col_off, pre + "ali_chunk_rb": al.chunk_rb,
            pre + "ali_rb_a": al.rb_a, pre + "ali_rb_b": al.rb_b,
            pre + "ali_split": al.split, pre + "ali_rb_mask": al.rb_mask,
            pre + "ali_nnz": al.nnz,
        })
        if al.spill is not None:
            payload.update(_lanepack_payload(al.spill, pre + "alisp_"))
    if op._dia is not None:
        payload.update({
            pre + "dia_data": op._dia.data,
            pre + "dia_offsets": np.asarray(op._dia.offsets, np.int64),
            pre + "dia_rows": op._dia.rows, pre + "dia_cols": op._dia.cols,
        })
    if getattr(op, "_bell", None) is not None:
        bl = op._bell
        payload.update({
            pre + "bell_ds": np.asarray(bl.ds, np.int64),
            pre + "bell_modes": np.asarray(bl.modes, np.int64),
            pre + "bell_vals": bl.vals, pre + "bell_lane": bl.lane,
            pre + "bell_nnz": bl.nnz, pre + "bell_span": bl.span,
            # v3 = greedy o-bucketed window assignment (formats/bell.py)
            pre + "bell_ver": 3,
        })
        if bl.spill is not None:
            payload.update(_lanepack_payload(bl.spill, pre + "bellsp_"))
    if getattr(op, "_stripe", None) is not None:
        _stripe_payload(op._stripe, pre + "stripe_", payload)
    if op._plan is not None:
        payload.update(_lanepack_payload(op._plan, pre + "lp_"))
    if getattr(op, "_ell", None) is not None:
        payload[pre + "ell_vals"] = np.asarray(op._ell[0])
        payload[pre + "ell_cols"] = np.asarray(op._ell[1])
        if getattr(op, "_ell_spill", None) is not None:
            payload.update({
                pre + "ell_spill_rows": np.asarray(op._ell_spill[0]),
                pre + "ell_spill_cols": np.asarray(op._ell_spill[1]),
                pre + "ell_spill_vals": np.asarray(op._ell_spill[2]),
            })


def _stripe_payload(st, pre: str, payload: dict) -> None:
    payload.update({
        pre + "vals": st.vals, pre + "lane": st.lane, pre + "ends": st.ends,
        pre + "rb": st.stripe_rb, pre + "col_off": st.col_off,
        pre + "chunk_stripe": st.chunk_stripe, pre + "rb_mask": st.rb_mask,
        pre + "nnz": st.nnz, pre + "levels": st.levels, pre + "kw": st.kw,
        pre + "mode": st.mode, pre + "rows": st.rows, pre + "cols": st.cols,
    })
    if st.starts is not None:
        payload[pre + "starts"] = st.starts
    if st.spill is not None:  # scan-mode spill: one level deep by design
        _stripe_payload(st.spill, pre + "sp_", payload)


def _stripe_from_payload(z, pre: str):
    from ..formats.stripe import StripePlan

    return StripePlan(
        rows=int(z[pre + "rows"]), cols=int(z[pre + "cols"]),
        levels=int(z[pre + "levels"]), kw=int(z[pre + "kw"]),
        mode=str(z[pre + "mode"]),
        vals=z[pre + "vals"], lane=z[pre + "lane"], ends=z[pre + "ends"],
        starts=z[pre + "starts"] if pre + "starts" in z else None,
        stripe_rb=z[pre + "rb"], col_off=z[pre + "col_off"],
        chunk_stripe=z[pre + "chunk_stripe"], rb_mask=z[pre + "rb_mask"],
        nnz=int(z[pre + "nnz"]), dtype=z[pre + "vals"].dtype,
        spill=(_stripe_from_payload(z, pre + "sp_")
               if pre + "sp_vals" in z else None),
    )


def load_operator_plan(path: str) -> SpmvOperator:
    """Rebuild a planned operator saved by :func:`save_operator_plan`."""
    z = np.load(path, allow_pickle=False)
    return _op_from_payload(z, "")


def _op_from_payload(z, pre: str) -> SpmvOperator:
    from ..formats.dia import DiaMatrix

    op = SpmvOperator.__new__(SpmvOperator)
    op.format = str(z[pre + "format"])
    op.rows, op.cols, op.nnz = (
        int(z[pre + "rows"]), int(z[pre + "cols"]), int(z[pre + "nnz"])
    )
    op._dia = None
    op._plan = None
    op._aligned = None
    op._bell = None
    op._stripe = None
    op._ell = None
    op._ell_spill = None
    op._rowsplit = None
    op._colsplit = None
    if pre + "split_kind" in z:
        bounds = z[pre + "split_bounds"]
        parts = [
            (int(bounds[i]), int(bounds[i + 1]), _op_from_payload(z, pre + f"s{i}_"))
            for i in range(len(bounds) - 1)
        ]
        if str(z[pre + "split_kind"]) == "row":
            op._rowsplit = parts
        else:
            op._colsplit = parts
        return op
    if pre + "ali_vals" in z:
        from ..formats.aligned import AlignedPlan
        from .spmv import aligned_device_arrays

        spill = (
            _lanepack_from_payload(z, pre + "alisp_")
            if pre + "alisp_vals" in z
            else None
        )
        op._aligned = AlignedPlan(
            rows=op.rows, cols=op.cols, vals=z[pre + "ali_vals"],
            lane=z[pre + "ali_lane"], col_off=z[pre + "ali_col_off"],
            chunk_rb=z[pre + "ali_chunk_rb"], rb_a=z[pre + "ali_rb_a"],
            rb_b=z[pre + "ali_rb_b"], split=z[pre + "ali_split"],
            rb_mask=z[pre + "ali_rb_mask"], nnz=int(z[pre + "ali_nnz"]),
            dtype=z[pre + "ali_vals"].dtype, spill=spill,
        )
        op._ali_arrs = aligned_device_arrays(op._aligned)
    if pre + "dia_data" in z:
        dia = DiaMatrix(
            int(z[pre + "dia_rows"]), int(z[pre + "dia_cols"]), z[pre + "dia_data"],
            tuple(int(o) for o in z[pre + "dia_offsets"]),
        )
        op._set_dia(dia)
    if pre + "bell_vals" in z:
        from ..formats.bell import BellPlan
        from .spmv_bell import bell_device_arrays

        spill = (
            _lanepack_from_payload(z, pre + "bellsp_")
            if pre + "bellsp_vals" in z
            else None
        )
        if int(z.get(pre + "bell_ver", 1)) != 3:
            raise ValueError(
                "BELL plan was saved with an incompatible (pre-v3) window "
                "assignment; re-plan the operator and save again"
            )
        op._bell = BellPlan(
            rows=op.rows, cols=op.cols,
            ds=tuple(int(d) for d in z[pre + "bell_ds"]),
            vals=z[pre + "bell_vals"], lane=z[pre + "bell_lane"],
            modes=tuple(int(mo) for mo in z[pre + "bell_modes"]),
            span=int(z[pre + "bell_span"]),
            nnz=int(z[pre + "bell_nnz"]), dtype=z[pre + "bell_vals"].dtype,
            spill=spill,
        )
        op._bell_arrs = bell_device_arrays(op._bell)
    if pre + "stripe_vals" in z:
        from .spmv import stripe_device_arrays

        op._stripe = _stripe_from_payload(z, pre + "stripe_")
        op._stripe_arrs = stripe_device_arrays(op._stripe)
    if pre + "lp_vals" in z:
        from .spmv import lanepack_device_arrays

        op._plan = _lanepack_from_payload(z, pre + "lp_")
        op._lp_arrs = lanepack_device_arrays(op._plan)
    if pre + "ell_vals" in z:
        import jax.numpy as jnp

        op._ell = (jnp.asarray(z[pre + "ell_vals"]), jnp.asarray(z[pre + "ell_cols"]))
        if pre + "ell_spill_rows" in z:
            op._ell_spill = (
                jnp.asarray(z[pre + "ell_spill_rows"]),
                jnp.asarray(z[pre + "ell_spill_cols"]),
                jnp.asarray(z[pre + "ell_spill_vals"]),
            )
    return op

"""Sort-based device sparse ops: transpose, add/sub, ESC SpGEMM.

Design: every structural op here is a composition of sorts and scans
(the first target's XLA scatter and random gather were slow, ``lax.sort``
and scans fast; not re-measured on the GPU):

  multi-key sort -> run detection -> prefix-sum run totals -> compaction sort

with **no scatter anywhere** and no int64 keys (lexicographic two-key sorts).

Dynamic-shape discipline: XLA needs static shapes, but sparse results have
data-dependent nnz. Every op returns a *padded* result (capacity = worst
case, computed on host) plus a traced ``nnz`` scalar; padding rows carry the
sentinel row id ``rows`` so offsets derived by ``searchsorted`` ignore them.
This is the device analog of the reference's exact-allocation-after-symbolic
design (``mul_hash_numeric``, ``spam_csr/src/mul_hash.rs:106-201``): the
symbolic phase runs on host (:func:`expand_plan`), the numeric phase on
device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import CsrMatrix, INDEX_DTYPE, OFFSET_DTYPE
from ..formats.device import DeviceCsr

__all__ = [
    "PaddedCoo",
    "transpose_device",
    "add_device",
    "sub_device",
    "spgemm_esc_device",
    "EscSpgemm",
    "expand_plan",
    "padded_to_host",
]


class PaddedCoo(NamedTuple):
    """Row-sorted COO with static capacity and dynamic nnz.

    Entries beyond ``nnz`` have ``row == rows`` (sentinel) and zero values.
    """

    row: jnp.ndarray  # (cap,) int32, sorted; sentinel = rows
    col: jnp.ndarray  # (cap,) int32
    val: jnp.ndarray  # (cap,)
    nnz: jnp.ndarray  # () int32
    rows: int
    cols: int


def _offsets_from_sorted_rows(row: jnp.ndarray, rows: int) -> jnp.ndarray:
    return jnp.searchsorted(row, jnp.arange(rows + 1, dtype=row.dtype)).astype(jnp.int32)


def padded_to_host(p: PaddedCoo) -> CsrMatrix:
    """Trim a device result to an exact host CSR (sorted)."""
    n = int(p.nnz)
    row = np.asarray(p.row)[:n].astype(np.int64)
    col = np.asarray(p.col)[:n].astype(np.int64)
    val = np.asarray(p.val)[:n]
    offsets = np.zeros(p.rows + 1, dtype=OFFSET_DTYPE)
    np.add.at(offsets, row + 1, 1)
    np.cumsum(offsets, out=offsets)
    return CsrMatrix(p.rows, p.cols, val, col.astype(INDEX_DTYPE), offsets, is_sorted=True)


# ---------------------------------------------------------------------------
# transpose
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("rows", "cols"))
def _transpose_impl(row, col, val, *, rows: int, cols: int):
    # sort entries by (col, row): two-key lexicographic sort, no int64
    c_s, r_s, v_s = jax.lax.sort((col, row, val), num_keys=2)
    return c_s, r_s, v_s


def transpose_device(a: DeviceCsr) -> DeviceCsr:
    """Transpose by (col, row) sort — the device analog of the host
    sort-based transpose (replacing the reference's dense O(r*c) sweep,
    ``spam_csr/src/lib.rs:256-264``)."""
    new_row, new_col, new_val = _transpose_impl(
        a.row_ids, a.indices, a.vals, rows=a.rows, cols=a.cols
    )
    offsets = _offsets_from_sorted_rows(new_row, a.cols)
    return DeviceCsr(
        vals=new_val,
        indices=new_col,
        offsets=offsets,
        row_ids=new_row,
        rows=a.cols,
        cols=a.rows,
        is_sorted=True,
    )


# ---------------------------------------------------------------------------
# union merge (add/sub)
# ---------------------------------------------------------------------------


def _run_reduce(row, col, val, rows: int):
    """Combine duplicate (row, col) keys in sorted COO: prefix-sum run
    totals assigned at run ends, then compaction sort. Returns PaddedCoo
    components."""
    n = val.shape[0]
    if n == 0:
        return row, col, val, jnp.int32(0)
    same_prev = jnp.concatenate(
        [jnp.zeros(1, bool), (row[1:] == row[:-1]) & (col[1:] == col[:-1])]
    )
    is_end = jnp.concatenate([~same_prev[1:], jnp.ones(1, bool)])

    # segmented inclusive scan: per-run sums restart at run heads, so runs
    # never contaminate each other (a global cumsum + difference loses
    # precision to cross-run cancellation)
    def _combine(a, b):
        va, ha = a
        vb, hb = b
        return jnp.where(hb, vb, va + vb), ha | hb

    run_total, _ = jax.lax.associative_scan(_combine, (val, ~same_prev))

    # keep only run ends; push the rest to the tail, preserving key order
    idx = jnp.arange(n, dtype=jnp.int32)
    sort_key = jnp.where(is_end, 0, 1).astype(jnp.int32)
    _k, _i, row_o, col_o, val_o = jax.lax.sort(
        (sort_key, idx, row, col, run_total), num_keys=2
    )
    nnz = jnp.sum(is_end.astype(jnp.int32))
    # sentinel rows for the tail
    valid = jnp.arange(n, dtype=jnp.int32) < nnz
    row_o = jnp.where(valid, row_o, rows)
    val_o = jnp.where(valid, val_o, 0)
    return row_o, col_o, val_o, nnz


@functools.partial(jax.jit, static_argnames=("rows", "cols", "sign"))
def _merge_impl(ra, ca, va, rb, cb, vb, *, rows: int, cols: int, sign: int):
    row = jnp.concatenate([ra, rb])
    col = jnp.concatenate([ca, cb])
    val = jnp.concatenate([va, jnp.asarray(sign, va.dtype) * vb])
    n = val.shape[0]
    if n and (rows + 1) * cols < (1 << 31) and n < (1 << 30):
        key = row * jnp.int32(cols) + col
        k_s, v_s = jax.lax.sort((key, val), num_keys=1)
        return _packed_run_reduce(k_s, v_s, rows, cols)
    r_s, c_s, v_s = jax.lax.sort((row, col, val), num_keys=2)
    return _run_reduce(r_s, c_s, v_s, rows)


def _merge(a: DeviceCsr, b: DeviceCsr, sign: int) -> PaddedCoo:
    if (a.rows, a.cols) != (b.rows, b.cols):
        raise ValueError("matrices must have identical dimensions")
    row, col, val, nnz = _merge_impl(
        a.row_ids, a.indices, a.vals, b.row_ids, b.indices, b.vals,
        rows=a.rows, cols=a.cols, sign=sign,
    )
    return PaddedCoo(row, col, val, nnz, a.rows, a.cols)


def add_device(a: DeviceCsr, b: DeviceCsr) -> PaddedCoo:
    """Union add keeping cancellation zeros explicit (reference
    ``apply_elementwise`` semantics, ``spam_csr/src/lib.rs:83-148``)."""
    return _merge(a, b, +1)


def sub_device(a: DeviceCsr, b: DeviceCsr) -> PaddedCoo:
    return _merge(a, b, -1)


# ---------------------------------------------------------------------------
# ESC SpGEMM
# ---------------------------------------------------------------------------


def expand_plan(lhs: CsrMatrix, rhs: CsrMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host symbolic phase: expansion index arrays for all intermediate
    products (the FLOP-count upper bound of ``rows_to_threads``,
    ``mul_hash.rs:38-64``, materialized as gather indices)."""
    lhs_rows = lhs.row_ids()
    k_idx = lhs.indices.astype(np.int64)
    rhs_row_nnz = np.diff(rhs.offsets)
    reps = rhs_row_nnz[k_idx]
    total = int(reps.sum())
    src = np.repeat(np.arange(lhs.nnz(), dtype=np.int64), reps)
    run_starts = np.zeros(lhs.nnz() + 1, dtype=np.int64)
    np.cumsum(reps, out=run_starts[1:])
    within = np.arange(total, dtype=np.int64) - run_starts[src]
    q = rhs.offsets[k_idx[src]].astype(np.int64) + within
    out_r = lhs_rows[src]
    return src.astype(np.int32), q.astype(np.int32), out_r.astype(np.int32)


def _packed_run_reduce(key, val, rows: int, cols: int):
    """:func:`_run_reduce` on int32-packed ``row * cols + col`` keys —
    fewer sort operands/key compares on both sorts (the packed main sort
    + this compaction are the ESC hot phases)."""
    n = val.shape[0]
    same_prev = jnp.concatenate(
        [jnp.zeros(1, bool), key[1:] == key[:-1]])
    is_end = jnp.concatenate([~same_prev[1:], jnp.ones(1, bool)])

    def _combine(a, b):
        va, ha = a
        vb, hb = b
        return jnp.where(hb, vb, va + vb), ha | hb

    run_total, _ = jax.lax.associative_scan(_combine, (val, ~same_prev))
    # stable partition (run ends first) via one packed key: bit 30 is the
    # not-an-end flag, low bits the original position (n < 2^30 guarded
    # by the caller)
    idx = jnp.arange(n, dtype=jnp.int32)
    part_key = jnp.where(is_end, idx, idx + (1 << 30))
    _k, key_o, val_o = jax.lax.sort((part_key, key, run_total), num_keys=1)
    nnz = jnp.sum(is_end.astype(jnp.int32))
    valid = idx < nnz
    row_o = jnp.where(valid, key_o // jnp.int32(cols), rows)
    col_o = jnp.where(valid, key_o % jnp.int32(cols), 0)
    val_o = jnp.where(valid, val_o, 0)
    return row_o.astype(jnp.int32), col_o.astype(jnp.int32), val_o, nnz


@functools.partial(jax.jit, static_argnames=("rows", "cols"))
def _packed_reduce_presort(key_const, p, rows: int, cols: int):
    """Sort (static packed key, products) and run-reduce — the back half
    of the k-major-expansion ESC engine (the key is plan data)."""
    k_s, v_s = jax.lax.sort((key_const, p), num_keys=1)
    return _packed_run_reduce(k_s, v_s, rows, cols)


@functools.partial(jax.jit, static_argnames=("rows", "cols"))
def _esc_impl(lhs_vals, rhs_vals, rhs_indices, src, q, out_r, *, rows: int, cols: int):
    out_c = rhs_indices[q]
    out_v = lhs_vals[src] * rhs_vals[q]
    n = out_v.shape[0]
    if n and (rows + 1) * cols < (1 << 31) and n < (1 << 30):
        # packed path: ONE int32 key -> 1-key sorts with fewer operands
        key = out_r * jnp.int32(cols) + out_c
        k_s, v_s = jax.lax.sort((key, out_v), num_keys=1)
        return _packed_run_reduce(k_s, v_s, rows, cols)
    r_s, c_s, v_s = jax.lax.sort((out_r, out_c, out_v), num_keys=2)
    return _run_reduce(r_s, c_s, v_s, rows)


class EscSpgemm:
    """Amortized ESC SpGEMM: the expansion plan and operand arrays live on
    device, reusable across repeated multiplies — the sort-engine analog of
    :class:`~.spgemm_block.BlockSpgemm`.

    Default engine = the k-major expansion (:mod:`.esc_expand`, engine
    name ``"kmajor"``): operand streams window-local, sort key
    host-precomputed, 1-key packed sorts. The XLA-gather engine remains as
    ``engine="xla"`` and as the automatic fallback when the packed key
    exceeds int32 or operand windows exceed the plan limit; it is one
    multi-key ``lax.sort`` + segmented scan, not a per-row gather loop.

    ``multiply_device(lhs_vals=, rhs_vals=)`` accepts fresh values with the
    SAME sparsity patterns (iterative algorithms re-multiply updated
    operators without re-planning).

    ``reduce=`` picks the post-expansion reduction: ``"spmv"`` routes the
    product stream through a fixed-pattern selection-matrix SpMV
    (:class:`~.spgemm_spmv.ReduceSpmv` — the sort/scan/compaction
    disappear, output row/col/nnz become plan constants), ``"sort"`` keeps
    the packed-key sort path, ``"auto"`` tries spmv and falls back.
    ``reduce_force=`` pins the SpMV format for the selection matrix.
    """

    def __init__(self, lhs: CsrMatrix, rhs: CsrMatrix, *, dtype=np.float32,
                 engine: str = "auto", reduce: str = "auto",
                 reduce_force=None):
        if lhs.cols != rhs.rows:
            raise ValueError("LHS cols != RHS rows")
        self.rows, self.cols = lhs.rows, rhs.cols
        self.rhs_vals = jnp.asarray(rhs.vals.astype(dtype))
        self._xplan = None
        self._rspmv = None
        if engine in ("auto", "kmajor"):
            from .esc_expand import plan_expand_kmajor

            xp = plan_expand_kmajor(lhs, rhs)
            if xp is not None:
                self._xplan = xp
                self.num_products = xp.num_products
                self.lhs_vals = jnp.asarray(lhs.vals.astype(dtype))
                self.lhs_vals_csc = jnp.asarray(
                    lhs.vals[xp.perm_csc].astype(dtype))
                self.out_key = jnp.asarray(xp.out_key)
                self._padded = xp.num_slabs * 1024 > xp.num_products
                if reduce == "auto" and not (
                    np.isfinite(lhs.vals).all() and np.isfinite(rhs.vals).all()
                ):
                    # non-finite plan-time values: the SpMV reduction has
                    # dense-window semantics (0 * inf = NaN across gather
                    # windows, spgemm_spmv.py contract) — keep the exactly
                    # confined sort reduction
                    reduce = "sort"
                if reduce in ("auto", "spmv"):
                    from .spgemm_spmv import ReduceSpmv

                    try:
                        self._rspmv = ReduceSpmv(
                            xp.out_key, xp.num_products, self.rows,
                            self.cols, force=reduce_force, dtype=dtype)
                    except Exception:
                        if reduce == "spmv":
                            raise
            elif engine == "kmajor":
                raise ValueError(
                    "k-major expansion unavailable (key exceeds int32 or "
                    "operand windows exceed the plan limit)")
        if self._xplan is None:
            src, q, out_r = expand_plan(lhs, rhs)
            self.num_products = len(src)
            self.src = jnp.asarray(src)
            self.q = jnp.asarray(q)
            self.out_r = jnp.asarray(out_r)
            self.lhs_vals = jnp.asarray(lhs.vals.astype(dtype))
            self.rhs_indices = jnp.asarray(rhs.indices.astype(np.int32))
        self._lhs_perm = (jnp.asarray(self._xplan.perm_csc)
                          if self._xplan is not None else None)

    @property
    def engine(self) -> str:
        return "kmajor" if self._xplan is not None else "xla_gather"

    def as_pytree(self):
        """Plan arrays (expansion slabs + the SpMV-reduce selection
        operator) as a pytree for :meth:`multiply_device`'s ``params=`` —
        inside an outer jit (chained bench loops, solvers) they ride as
        runtime ARGUMENTS, not compiled constants (the policy of
        AmgRefresh.device_fn and SpmvOperator.as_pytree)."""
        out = {}
        if self._xplan is not None:
            from .esc_expand import expand_device_arrays

            if getattr(self, "_expand_arrs", None) is None:
                self._expand_arrs = expand_device_arrays(self._xplan)
            out["expand"] = self._expand_arrs
        if self._rspmv is not None:
            out["rspmv"] = self._rspmv.as_pytree()
        return out

    def multiply_device(self, lhs_vals=None, rhs_vals=None,
                        params=None) -> PaddedCoo:
        """Re-multiply with fresh same-pattern values.

        Non-finite scope (ADVICE r4): the ``reduce="auto"`` guard checks
        PLAN-TIME values only. Values that turn non-finite AFTER planning
        (a diverging Newton step) still flow through the SpMV reduction
        with dense-window semantics — ``0 * inf = NaN`` can contaminate
        finite outputs sharing a gather window (the documented contract,
        module docstring + test_runtime_nonfinite_boundary_fixed_side).
        Drifting-value users who need strict IEEE confinement should
        construct with ``reduce="sort"`` (exactly-confined, ~2x slower
        re-multiply) or run their own ``isfinite`` check on the stream.
        """
        rv = self.rhs_vals if rhs_vals is None else jnp.asarray(rhs_vals)
        if self._xplan is not None:
            from .esc_expand import expand_products

            lv = (self.lhs_vals_csc if lhs_vals is None
                  else jnp.asarray(lhs_vals)[self._lhs_perm])
            p = expand_products(
                self._xplan, lv, rv,
                device_arrays=None if params is None else params["expand"])
            if self._rspmv is not None:
                if params is not None and "rspmv" in params:
                    return self._rspmv.apply(params["rspmv"], p)
                return self._rspmv.reduce(p)
            row, col, val, nnz = _packed_reduce_presort(
                self.out_key, p, self.rows, self.cols)
            if self._padded:
                nnz = nnz - 1  # the sentinel-key padding run
            return PaddedCoo(row, col, val, nnz, self.rows, self.cols)
        lv = self.lhs_vals if lhs_vals is None else lhs_vals
        row, col, val, nnz = _esc_impl(
            lv, rv, self.rhs_indices, self.src, self.q, self.out_r,
            rows=self.rows, cols=self.cols,
        )
        return PaddedCoo(row, col, val, nnz, self.rows, self.cols)

    def multiply(self) -> CsrMatrix:
        return padded_to_host(self.multiply_device())


def spgemm_esc_device(lhs: DeviceCsr, rhs: DeviceCsr, plan=None, host_pair=None) -> PaddedCoo:
    """Device numeric phase of ESC SpGEMM: gather products, sort by key,
    run-reduce. ``plan`` from :func:`expand_plan` (host symbolic phase);
    ``host_pair`` = (lhs_host, rhs_host) to derive it if absent."""
    if plan is None:
        if host_pair is None:
            raise ValueError("need plan or host_pair")
        plan = expand_plan(*host_pair)
    src, q, out_r = (jnp.asarray(p) for p in plan)
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    row, col, val, nnz = _esc_impl(
        lhs.vals, rhs.vals, rhs.indices, src, q, out_r, rows=lhs.rows, cols=rhs.cols
    )
    return PaddedCoo(row, col, val, nnz, lhs.rows, rhs.cols)

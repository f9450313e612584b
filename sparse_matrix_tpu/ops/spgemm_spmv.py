"""Same-pattern SpGEMM as SpMV (round 4).

Amortized SpGEMM's reduction has a STATIC structure: with both sparsity
patterns fixed, *which products land in which output entry* is plan data.
The ESC engine nevertheless re-pays a device sort + segmented scan +
compaction sort on every re-multiply — most of its time at
uniform4096_0.5% on the first target. All of
it collapses to ONE SpMV with an all-ones selection matrix ``S``
(outputs x product slots) built once on host — routed through the
format-dispatched SpMV engines (stripe/lanepack/aligned/BELL), i.e. the
machinery this framework already cost-models and optimizes.

Two levels:

* :class:`ReduceSpmv` — reduce the k-major expansion's product
  stream (:mod:`.esc_expand`): re-multiply = expansion kernel + ``S @ p``.
  Output keys are static, so the compaction disappears too: the result's
  row/col arrays are plan constants and ``nnz`` is known at plan time.
* :class:`FixedSideSpgemm` — when ONE side's values are also fixed
  (Galerkin ``R A P`` with frozen R/P, re-multiplies of ``A @ B`` with A
  frozen), fold them into the selection matrix:
  ``W[i, q_j] = lhs_vals[src_j]`` and ``C.vals = W @ rhs.vals`` — no
  expansion kernel, no product stream, ONE SpMV whose nnz equals the
  intermediate-product count.

Reference anchor: this replaces the per-row hash accumulate of the
reference's numeric phase (``/root/reference/spam_csr/src/mul_hash.rs:
145-163``) for the same-pattern regime — the hash table's job (route
product j to output entry i) is done once on host; the device only
streams FLOPs.

**Finite-stream contract**: with finite value streams the results are
structurally exact (match the hash engine to f32 round-off). With
non-finite values (NaN/inf) the windowed SpMV formats the selection
operator dispatches to (lanepack/stripe/aligned/dia) read gather
windows whose zero-weight slots multiply neighboring stream values, so
``0 * inf = NaN`` can contaminate outputs sharing a window with a
non-finite product — dense-window semantics, the same class of behavior
as scipy's explicit-zero products. For strict IEEE confinement use the
sort reduction (``EscSpgemm(reduce="sort")``, which segment-reduces
exactly the real products); ``reduce="auto"`` checks the plan-time
values and avoids the SpMV reduction when they are non-finite.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..formats.csr import CsrMatrix, INDEX_DTYPE, OFFSET_DTYPE

__all__ = ["ReduceSpmv", "FixedSideSpgemm"]


def _check_int32_cols(rows: int, cols: int) -> None:
    """The engines' output row/col arrays are int32 (like every device
    kernel in this library); uk % out_cols would silently wrap beyond
    2^31. The fuzz harness gated on this (_INT32_COL_ENGINES) — the
    public constructors must too (ADVICE r4)."""
    if cols >= 2**31 or rows >= 2**31:
        raise ValueError(
            f"SpMV-reduce SpGEMM engines carry int32 output coordinates; "
            f"got rows={rows}, cols={cols} (>= 2^31). Use the sort-"
            f"reduction ESC engine or the host engine for wider outputs."
        )


def _fixedside_select(lhs: CsrMatrix, rhs: CsrMatrix, fixed: str):
    """Build FixedSideSpgemm's grouped selection matrix: native fused
    expand+group pass when available (per-row stable sorts by output
    column — products already enumerate row-major, and within one output
    entry the varying side's CSR position ascends in enumeration order,
    so no global lexsort is needed), numpy expand_plan + _group_by_key
    otherwise. Returns ``(S, out_row, out_col, nnz_out, num_products)``."""
    from ..native.loader import fixedside_plan_native

    reps = np.diff(rhs.offsets)[lhs.indices.astype(np.int64)]
    num_products = int(reps.sum())
    nat = None
    if num_products:
        nat = fixedside_plan_native(lhs, rhs, fixed == "lhs", num_products)
    if nat is not None:
        s_idx, s_val, out_row, out_col, off_full, nnz_out = nat
        offsets = np.ascontiguousarray(off_full[:nnz_out + 1],
                                       dtype=OFFSET_DTYPE)
        cols_x = rhs.nnz() if fixed == "lhs" else lhs.nnz()
        s = CsrMatrix(nnz_out, cols_x, s_val, s_idx, offsets,
                      is_sorted=True)
        return s, out_row[:nnz_out], out_col[:nnz_out], nnz_out, num_products
    from .device_sorted import expand_plan

    src, q, out_r = expand_plan(lhs, rhs)
    out_c = rhs.indices.astype(np.int64)[q]
    key = out_r.astype(np.int64) * rhs.cols + out_c
    if fixed == "lhs":
        idx, w_vals, cols_x = q, lhs.vals[src], rhs.nnz()
    else:
        idx, w_vals, cols_x = src, rhs.vals[q], lhs.nnz()
    s, out_row, out_col, nnz_out = _group_by_key(
        key, rhs.cols, cols_x, sub_order=idx, indices=idx, vals=w_vals)
    return s, out_row, out_col, nnz_out, len(key)


def _group_by_key(key: np.ndarray, out_cols: int, cols_x: int,
                  sub_order: Optional[np.ndarray] = None,
                  indices: Optional[np.ndarray] = None,
                  vals: Optional[np.ndarray] = None):
    """Group positions by ``key`` into a CSR matrix whose row i selects
    (and sums) the positions of the i-th distinct key.

    ``indices`` maps grouped positions to matrix columns (default: the
    position itself); ``sub_order`` is the within-run column order (must
    make per-row indices strictly increasing); ``vals`` default to ones.
    Returns ``(S, out_row, out_col, nnz_out)`` with out_row/out_col
    decoded from the distinct keys. Runs on host with int64 keys — no
    packed-int32 capability gate.
    """
    n = len(key)
    if n == 0:
        # zero-dim CsrMatrix is rejected by design (HasZeroDimension
        # analog, core/matrix.py) — signal "no operator" instead
        return None, np.zeros(0, np.int32), np.zeros(0, np.int32), 0
    if sub_order is None:
        ord_ = np.argsort(key, kind="stable")
    else:
        ord_ = np.lexsort((sub_order, key))
    ks = key[ord_]
    head = np.empty(n, dtype=bool)
    head[0] = True
    np.not_equal(ks[1:], ks[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    nnz_out = len(starts)
    offsets = np.empty(nnz_out + 1, dtype=OFFSET_DTYPE)
    offsets[:-1] = starts
    offsets[-1] = n
    uk = ks[starts]
    out_row = (uk // out_cols).astype(np.int32)
    out_col = (uk % out_cols).astype(np.int32)
    col_idx = ord_ if indices is None else np.asarray(indices)[ord_]
    v = (np.ones(n, np.float32) if vals is None
         else np.asarray(vals, np.float32)[ord_])
    s = CsrMatrix(nnz_out, cols_x, v, col_idx.astype(INDEX_DTYPE), offsets,
                  is_sorted=True)
    return s, out_row, out_col, nnz_out


class _ZeroOperator:
    """Stand-in operator for a plan with zero products: carries the same
    call/as_pytree/apply surface as SpmvOperator so degenerate levels
    (e.g. an AmgRefresh hierarchy with an empty product) compose instead
    of dying with AttributeError (ADVICE r4)."""

    format = "zero"

    def __init__(self, dtype):
        self._dtype = dtype

    def __call__(self, x):
        return jnp.zeros(0, self._dtype)

    def as_pytree(self):
        return {}

    def apply(self, params, x):
        return jnp.zeros(0, self._dtype)


def _operator(s, force, dtype):
    if s is None:
        return _ZeroOperator(dtype)
    from .operator import SpmvOperator

    return SpmvOperator(s, dtype=dtype, force=force)


class ReduceSpmv:
    """Fixed-pattern reduction of an ESC product stream: ``S @ p``.

    Built from an :class:`~.esc_expand.ExpandPlan`'s ``out_key`` (padded;
    sentinel-keyed padding slots are simply never referenced by ``S``, so
    they are dropped structurally — no post-reduce trim). ``force=``
    pins the SpMV format for ``S`` (default: the operator's cost-model
    dispatch)."""

    def __init__(self, out_key_padded: np.ndarray, num_products: int,
                 rows: int, cols: int, *, force: Optional[str] = None,
                 dtype=np.float32):
        _check_int32_cols(rows, cols)
        key = np.asarray(out_key_padded[:num_products], np.int64)
        s, out_row, out_col, nnz_out = _group_by_key(
            key, cols, len(out_key_padded))
        from ..utils.transfer import to_device

        self.rows, self.cols = rows, cols
        self._num_products = num_products
        self.nnz_out = nnz_out
        # host copies stay: consumers that need the static pattern on host
        # (AmgRefresh threads level skeletons through _pattern_csr) must
        # not pull the device arrays back to the host
        self.out_row_host = np.asarray(out_row)
        self.out_col_host = np.asarray(out_col)
        self.out_row = to_device(out_row)
        self.out_col = to_device(out_col)
        self.op = _operator(s, force, dtype)

    def as_pytree(self):
        """The selection operator's device arrays as a pytree — pass these
        through :meth:`apply` when composing inside an outer jit (a
        chained bench loop, a solver) so the selection matrix rides as a
        runtime ARGUMENT, not a compiled constant (>24 MB constants blow
        remote-compile payloads; same policy as AmgRefresh.device_fn)."""
        return self.op.as_pytree()

    def apply(self, params, p):
        """:meth:`reduce` with the selection operator's arrays supplied as
        ``params`` (from :meth:`as_pytree`); jit-traceable with ``params``
        as an argument."""
        return self._reduce(p, lambda x: self.op.apply(params, x))

    def reduce(self, p):
        """Products (padded plan order) -> PaddedCoo (exact, row-sorted)."""
        return self._reduce(p, self.op)

    def _reduce(self, p, op):
        from .device_sorted import PaddedCoo

        # pad slots hold garbage (the expansion kernel's window slicing
        # replicates real operands there): S never references them
        # structurally, but windowed SpMV formats READ them inside gather
        # windows with zero weights, and 0 * inf = NaN (found by the
        # amortized fuzz, case167 dump). Mask is a plan constant.
        p = jnp.where(jnp.arange(p.shape[0]) < self._num_products, p,
                      jnp.zeros((), p.dtype))
        val = op(p)
        return PaddedCoo(self.out_row, self.out_col, val,
                         jnp.int32(self.nnz_out), self.rows, self.cols)


class FixedSideSpgemm:
    """``C = A @ B`` with one side's VALUES frozen: SpGEMM as one SpMV.

    ``fixed="lhs"``: ``C.vals = W @ rhs_vals`` where ``W`` has one entry
    per intermediate product, ``W[(r,c), pos_B(k,c)] = A[r,k]``. The
    varying side's values are consumed in CSR order — re-multiplying an
    updated B costs exactly one planned SpMV over ``num_products`` nnz
    (zero sorts, zero gathers outside the SpMV kernel). ``fixed="rhs"``
    mirrors it (``x`` = lhs values in CSR order).

    The output pattern (row/col/nnz) is a plan constant; results come
    back as exact row-sorted :class:`~.device_sorted.PaddedCoo`.

    This is the engine of choice for Galerkin triple products
    (``R @ A @ P`` re-evaluated as A's values drift: two FixedSide
    multiplies with R and P frozen) and for iterative algorithms that
    re-multiply a frozen operator against same-pattern updates.
    """

    def __init__(self, lhs: CsrMatrix, rhs: CsrMatrix, *,
                 fixed: str = "lhs", dtype=np.float32,
                 force: Optional[str] = None):
        if lhs.cols != rhs.rows:
            raise ValueError("LHS cols != RHS rows")
        if fixed not in ("lhs", "rhs"):
            raise ValueError("fixed must be 'lhs' or 'rhs'")
        _check_int32_cols(lhs.rows, rhs.cols)
        s, out_row, out_col, nnz_out, num_products = _fixedside_select(
            lhs, rhs, fixed)
        from ..utils.transfer import to_device

        self.rows, self.cols = lhs.rows, rhs.cols
        self.fixed = fixed
        self.num_products = num_products
        self.nnz_out = nnz_out
        # see ReduceSpmv.__init__: host copies avoid device->host pulls
        self.out_row_host = np.asarray(out_row)
        self.out_col_host = np.asarray(out_col)
        self.out_row = to_device(out_row)
        self.out_col = to_device(out_col)
        self._default_x = to_device(
            (rhs.vals if fixed == "lhs" else lhs.vals).astype(dtype))
        self.op = _operator(s, force, dtype)

    def as_pytree(self):
        """Selection-operator device arrays as a pytree — see
        :meth:`ReduceSpmv.as_pytree` (same >24 MB-constants rationale)."""
        return self.op.as_pytree()

    def apply(self, params, vals=None):
        """:meth:`multiply_device` with the selection operator's arrays
        supplied as ``params`` (from :meth:`as_pytree`); jit-traceable
        with ``params`` as an argument — the form chained benches and
        solvers must use (AmgRefresh.device_fn does)."""
        return self._multiply(vals, lambda x: self.op.apply(params, x))

    def multiply_device(self, vals=None):
        """One SpMV: ``vals`` = the varying side's values in CSR order
        (defaults to the values captured at plan time)."""
        return self._multiply(vals, self.op)

    def _multiply(self, vals, op):
        from .device_sorted import PaddedCoo

        x = self._default_x if vals is None else jnp.asarray(vals)
        val = op(x)
        return PaddedCoo(self.out_row, self.out_col, val,
                         jnp.int32(self.nnz_out), self.rows, self.cols)

    def multiply(self, vals=None) -> CsrMatrix:
        from .device_sorted import padded_to_host

        return padded_to_host(self.multiply_device(vals))

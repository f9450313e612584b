"""Block-dense SpGEMM.

At the densities real workloads have (>= ~0.1%), dense 128x128 block
products on the matrix units can be cheaper than a per-element sparse
scheme. So:

* **symbolic phase** (host): block-level SpGEMM structure — which (A-block,
  B-block) pairs contribute to which C block (the FLOP-balanced planning
  idea of ``rows_to_threads``, ``mul_hash.rs:38-64``, lifted to 128x128
  block granularity);
* **numeric phase** (device): one batched block matmul over all pairs,
  ``C[c] += A[a] @ B[b]`` scatter-added by C block;
* C comes back as dense blocks; exact zeros are dropped on conversion to
  CSR (cancellation zeros are NOT kept explicit, unlike the element-wise
  union ops — documented divergence, invisible through the DOK oracle).

The C++ native host path (``spgemm_hash_host``) wins for hyper-sparse
unstructured matrices. :func:`spgemm_auto` picks by estimated cost.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.bcsr import BsrMatrix, BLOCK_SIZE
from ..formats.csr import CsrMatrix

__all__ = ["block_pairs_plan", "spgemm_block_device", "spgemm_auto", "spgemm_cost_estimates"]


def block_pairs_plan(a: BsrMatrix, b: BsrMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host symbolic phase at block granularity.

    Returns (pair_a, pair_b, pair_c, c_block_keys): for each contributing
    pair p, C-block ``pair_c[p]`` accumulates ``A.blocks[pair_a[p]] @
    B.blocks[pair_b[p]]``. Pairs are sorted by C block. ``c_block_keys`` are the distinct
    C blocks as ``brow * bcols + bcol``.
    """
    a_brows = a.block_rows_expanded()  # (nnzb_a,)
    a_bcols = a.block_cols.astype(np.int64)
    b_row_nnzb = np.diff(b.block_offsets)
    reps = b_row_nnzb[a_bcols]
    total = int(reps.sum())
    src = np.repeat(np.arange(a.nnzb, dtype=np.int64), reps)
    starts = np.zeros(a.nnzb + 1, dtype=np.int64)
    np.cumsum(reps, out=starts[1:])
    within = np.arange(total, dtype=np.int64) - starts[src]
    q = b.block_offsets[a_bcols[src]] + within  # B block index
    c_brow = a_brows[src]
    c_bcol = b.block_cols.astype(np.int64)[q]
    c_key = c_brow * b.bcols + c_bcol
    order = np.lexsort((q, c_key))
    src, q, c_key = src[order], q[order], c_key[order]
    uniq, inv = np.unique(c_key, return_inverse=True)
    return (
        src.astype(np.int32),
        q.astype(np.int32),
        inv.astype(np.int32),
        uniq.astype(np.int64),
    )


@functools.partial(jax.jit, static_argnames=("num_c", "bs", "precision", "out_dtype"))
def _block_numeric(a_blocks, b_blocks, pair_a, pair_b, pair_c, *, num_c, bs, precision, out_dtype=None):
    """Batched block matmul + scatter-add by C block. The scatter-add
    order is not fixed on the GPU, so results agree with a sequential sum
    to rounding, not bit for bit."""
    out_dtype = out_dtype if out_dtype is not None else a_blocks.dtype
    prods = jnp.einsum(
        "pij,pjk->pik",
        a_blocks[pair_a],
        b_blocks[pair_b],
        precision=precision,
        preferred_element_type=out_dtype,
    )
    return jnp.zeros((num_c, bs, bs), out_dtype).at[pair_c].add(prods)


@functools.partial(jax.jit, static_argnames=("rows", "cols", "bs"))
def _sparsify_blocks_jit(c_blocks, c_brows, c_bcols, *, rows: int, cols: int, bs: int):
    """Device-side compaction of dense C blocks to row-sorted padded COO.

    Scatter-free (sort-based, like every device structural op here): zero
    slots get the sentinel row id ``rows`` and sink to the tail of a
    two-key lexicographic sort. Replaces the host ``BsrMatrix.to_csr``
    pass, whose numpy/native sweep was the bottleneck for near-dense
    outputs."""
    num_c = c_blocks.shape[0]
    ri = jax.lax.broadcasted_iota(jnp.int32, (num_c, bs, bs), 1)
    ci = jax.lax.broadcasted_iota(jnp.int32, (num_c, bs, bs), 2)
    r = (c_brows[:, None, None] * bs + ri).reshape(-1)
    c = (c_bcols[:, None, None] * bs + ci).reshape(-1)
    v = c_blocks.reshape(-1)
    live = (v != 0) & (r < rows) & (c < cols)
    rkey = jnp.where(live, r, rows).astype(jnp.int32)
    rkey, c, v = jax.lax.sort([rkey, c.astype(jnp.int32), v], num_keys=2)
    nnz = jnp.sum(live.astype(jnp.int32))
    return rkey, c, v, nnz


def spgemm_block_pad_device(
    lhs: CsrMatrix,
    rhs: CsrMatrix,
    *,
    bs: int = BLOCK_SIZE,
    dtype=np.float32,
    precision=None,
):
    """C = A @ B via block-dense matmuls, result as a device-resident
    row-sorted :class:`~.device_sorted.PaddedCoo` (no host sparsify pass).
    """
    from .device_sorted import PaddedCoo

    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    # full f32 products: the default GPU matmul may round to TF32
    precision = precision if precision is not None else jax.lax.Precision.HIGHEST
    a = BsrMatrix.from_csr(lhs, bs, dtype=dtype)
    b = BsrMatrix.from_csr(rhs, bs, dtype=dtype)
    pair_a, pair_b, pair_c, c_keys = block_pairs_plan(a, b)
    if len(pair_a) == 0:
        z = jnp.zeros(0, dtype)
        zi = jnp.zeros(0, jnp.int32)
        return PaddedCoo(zi, zi, z, jnp.int32(0), lhs.rows, rhs.cols)
    c_blocks = _block_numeric(
        jnp.asarray(a.blocks),
        jnp.asarray(b.blocks),
        jnp.asarray(pair_a),
        jnp.asarray(pair_b),
        jnp.asarray(pair_c),
        num_c=len(c_keys),
        bs=bs,
        precision=precision,
    )
    bcols_c = -(-rhs.cols // bs)
    c_brows = jnp.asarray((c_keys // bcols_c).astype(np.int32))
    c_bcols = jnp.asarray((c_keys % bcols_c).astype(np.int32))
    r, c, v, nnz = _sparsify_blocks_jit(
        c_blocks, c_brows, c_bcols, rows=lhs.rows, cols=rhs.cols, bs=bs
    )
    return PaddedCoo(r, c, v, nnz, lhs.rows, rhs.cols)


def spgemm_block_device(
    lhs: CsrMatrix,
    rhs: CsrMatrix,
    *,
    bs: int = BLOCK_SIZE,
    dtype=np.float32,
    precision=None,
) -> CsrMatrix:
    """C = A @ B via block-dense matmuls. Host in/out; exact zeros
    dropped in the result.

    The sparsify pass runs on device (:func:`_sparsify_blocks_jit`); only
    the live prefix of the sorted result is read back (one scalar sync for
    nnz, then an nnz-sized transfer instead of the full capacity)."""
    p = spgemm_block_pad_device(lhs, rhs, bs=bs, dtype=dtype, precision=precision)
    n = int(p.nnz)
    if n == 0:
        return CsrMatrix.new(lhs.rows, rhs.cols, dtype=dtype)
    r = np.asarray(jax.lax.slice_in_dim(p.row, 0, n))
    c = np.asarray(jax.lax.slice_in_dim(p.col, 0, n))
    v = np.asarray(jax.lax.slice_in_dim(p.val, 0, n))
    return CsrMatrix.from_coo(lhs.rows, rhs.cols, r, c, v, sum_duplicates=False)


class BlockSpgemm:
    """Amortized block SpGEMM: blocks and the pair plan live on device,
    reusable across repeated multiplies (the common case — the reference
    bench squares the same matrix per iteration, and iterative algorithms
    reuse operators)."""

    def __init__(self, lhs: CsrMatrix, rhs: CsrMatrix, *, bs: int = BLOCK_SIZE, dtype=np.float32, precision=None, storage="f32"):
        """``storage="bf16"`` stores A/B blocks in bfloat16 — halves the
        per-pair memory traffic at bf16 operand precision; C accumulates f32 either
        way. f32 storage keeps exact-operand HIGHEST matmuls."""
        if lhs.cols != rhs.rows:
            raise ValueError("LHS cols != RHS rows")
        if storage == "bf16":
            block_dtype = jnp.bfloat16
            self.precision = precision  # DEFAULT: operands are already bf16
        else:
            block_dtype = dtype
            self.precision = precision if precision is not None else jax.lax.Precision.HIGHEST
        self.out_dtype = np.dtype(dtype)
        self.bs = bs
        self.rows, self.cols = lhs.rows, rhs.cols
        a = BsrMatrix.from_csr(lhs, bs, dtype=block_dtype)
        b = BsrMatrix.from_csr(rhs, bs, dtype=block_dtype)
        pair_a, pair_b, pair_c, self.c_keys = block_pairs_plan(a, b)
        self.num_pairs = len(pair_a)
        self.a_blocks = jnp.asarray(a.blocks)
        self.b_blocks = jnp.asarray(b.blocks)
        self.pair_a = jnp.asarray(pair_a)
        self.pair_b = jnp.asarray(pair_b)
        self.pair_c = jnp.asarray(pair_c)
        self.bcols_c = -(-rhs.cols // bs)

    def multiply_device(self):
        """Run the numeric phase; returns dense C blocks on device."""
        return _block_numeric(
            self.a_blocks, self.b_blocks, self.pair_a, self.pair_b, self.pair_c,
            num_c=len(self.c_keys), bs=self.bs,
            precision=self.precision, out_dtype=jnp.dtype(self.out_dtype),
        )

    def multiply(self) -> CsrMatrix:
        c_blocks = np.asarray(self.multiply_device())
        c_brows = (self.c_keys // self.bcols_c).astype(np.int64)
        c_bcols = (self.c_keys % self.bcols_c).astype(np.int32)
        offsets = np.zeros(-(-self.rows // self.bs) + 1, dtype=np.int64)
        np.add.at(offsets, c_brows + 1, 1)
        np.cumsum(offsets, out=offsets)
        return BsrMatrix(self.rows, self.cols, self.bs, c_blocks, c_bcols, offsets).to_csr()


def spgemm_dense_xla(lhs: CsrMatrix, rhs: CsrMatrix, *, dtype=np.float32) -> CsrMatrix:
    """Densify -> one XLA matmul -> sparsify. For small/medium uniform
    matrices where every 128-block is populated anyway, the plain dense
    matmul is the fastest device path."""
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    a = jnp.asarray(lhs.to_dense().astype(dtype))
    b = jnp.asarray(rhs.to_dense().astype(dtype))
    c = np.asarray(
        jnp.dot(a, b, preferred_element_type=a.dtype, precision=jax.lax.Precision.HIGHEST)
    )
    r, cc = np.nonzero(c)
    return CsrMatrix.from_coo(lhs.rows, rhs.cols, r, cc, c[r, cc], sum_duplicates=False)


def spgemm_cost_estimates(
    lhs: CsrMatrix, rhs: CsrMatrix, *, products: Optional[float] = None
) -> dict:
    """Estimated end-to-end seconds for each SpGEMM engine on this input.

    Rates come from :mod:`..utils.autotune` (on-device calibration when a
    cache exists, inherited defaults otherwise). ``products`` (the FLOP count,
    ``flops_per_row(lhs, rhs).sum()``) can be passed in when the caller
    already computed it — it is O(nnz) host work paid per dispatched
    product otherwise.
    """
    import os

    from ..utils import autotune
    from .spgemm_host import flops_per_row

    bs = BLOCK_SIZE

    def _blocks(m: CsrMatrix) -> float:
        # distinct (row-block, col-block) count; sampled row bands above
        # the cap (two full uniques were 4.3 s per 2048^2 Galerkin level —
        # longer than the winning engine's actual product)
        mm, scale = m, 1.0
        if m.nnz() > 1_500_000:
            from ..formats.csr import sample_row_bands

            mm, scale = sample_row_bands(m)
        bc = -(-mm.cols // bs)
        keys = mm.row_ids() // bs * bc + mm.indices.astype(np.int64) // bs
        return len(np.unique(keys)) * scale

    a_blocks = _blocks(lhs)
    b_blocks = _blocks(rhs)
    bcols_b = -(-rhs.cols // bs)
    brows_b = -(-rhs.rows // bs)
    pair_est = a_blocks * max(1.0, b_blocks / max(1, brows_b))
    c_blocks_est = min(-(-lhs.rows // bs) * bcols_b, pair_est)

    host_rate = autotune.get("spgemm_host_products_per_s") * max(1, os.cpu_count() or 1)
    host_touch = autotune.get("spgemm_host_touch_s_per_byte")
    mxu_pair = autotune.get("spgemm_mxu_pair_s")
    dense_rate = autotune.get("spgemm_dense_mac_per_s")
    esc_rate = autotune.get("spgemm_esc_products_per_s")
    # every device engine pays sync AND, being one-shot at an arbitrary new
    # shape, the first-call XLA compile (compiles cache per process+shape;
    # one-shot dispatch has no history to hit that cache). Amortizing
    # callers (EscSpgemm/BlockSpgemm re-multiply) bypass this dispatcher.
    dev_fixed = autotune.get("device_call_sync_s") + autotune.get(
        "device_oneshot_compile_s"
    )

    if products is None:
        products = float(flops_per_row(lhs, rhs).sum())
    return {
        "host": products / host_rate,
        "mxu": pair_est * mxu_pair + c_blocks_est * bs * bs * 4 * host_touch + dev_fixed,
        "dense": (
            lhs.rows * lhs.cols * rhs.cols * 2 / dense_rate
            + (lhs.rows * lhs.cols + rhs.rows * rhs.cols + lhs.rows * rhs.cols)
            * 4
            * host_touch
            + dev_fixed
        ),
        # ESC sort engine: host plan build (3 int32 streams) + kernel + fixed
        "esc": products * 12 * host_touch + products / esc_rate + dev_fixed,
    }


def spgemm_auto(lhs: CsrMatrix, rhs: CsrMatrix, *, output_sorted: bool = True) -> CsrMatrix:
    """Pick the SpGEMM engine by an estimated end-to-end cost model
    (rates from :mod:`..utils.autotune`):

    * host hash (C++) — wins for hyper-sparse inputs;
    * block-dense matmuls, plus the sparsify of the C blocks — wins when
      block structure is genuinely sparse;
    * dense XLA matmul plus densify/sparsify — wins for small/medium
      near-block-dense problems;
    * ESC sort engine.

    On the CPU backend every product runs on the host engines.
    """
    import os

    from ..utils import autotune
    from .spgemm_host import flops_per_row, spgemm_hash_host

    # dims first: the cost estimator gathers rhs row counts through lhs
    # column indices and would raise an unrelated IndexError otherwise
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")

    # rhs with at most one entry per row (tentative prolongators, diagonal
    # scalings, selection matrices) degenerates to a hash-free column
    # relabel + per-row merge — one O(nnz lhs) native pass that beats every
    # engine below (3x the hash engine on the AMG smoothing product).
    if rhs.nnz() <= rhs.rows:
        from ..native import colmap_spgemm_native

        out = colmap_spgemm_native(lhs, rhs)
        if out is not None:
            return out

    # Tiny products can never win on device: every device engine pays the
    # one-shot dispatch sync (and, first time, a compile). If the host
    # estimate is below the sync constant, answer on host without touching
    # the jax backend.
    host_rate = autotune.get("spgemm_host_products_per_s") * max(
        1, os.cpu_count() or 1
    )
    products = float(flops_per_row(lhs, rhs).sum())
    if products / host_rate <= autotune.get("device_call_sync_s"):
        return spgemm_hash_host(lhs, rhs, output_sorted=output_sorted)

    # banded x banded: band convolution is the closed-form product
    # (measured ~58x the host hash engine on Poisson squaring)
    from ..formats.dia import try_dia_from_csr

    da = try_dia_from_csr(lhs)
    if da is not None and lhs.cols == rhs.rows:
        db = try_dia_from_csr(rhs)
        if db is not None and da.nbands * db.nbands <= 4096:
            from .spgemm_dia import spgemm_dia

            out = spgemm_dia(da, db).to_csr()
            return out if output_sorted else CsrMatrix(
                out.rows, out.cols, out.vals, out.indices, out.offsets, is_sorted=False
            )

    if jax.default_backend() == "cpu":
        return spgemm_hash_host(lhs, rhs, output_sorted=output_sorted)

    # every device engine pays at least the one-shot sync + compile
    # constant: when the host estimate is already below that floor, skip
    # the block-structure estimators entirely (they cost real host time —
    # 4.3 s/level of the 2048^2 AMG setup went to estimating products the
    # host engine then ran in 1.8 s)
    dev_floor = autotune.get("device_call_sync_s") + autotune.get(
        "device_oneshot_compile_s"
    )
    if products / host_rate <= dev_floor:
        return spgemm_hash_host(lhs, rhs, output_sorted=output_sorted)

    costs = spgemm_cost_estimates(lhs, rhs, products=products)

    best = min(costs, key=costs.get)
    if best == "host":
        return spgemm_hash_host(lhs, rhs, output_sorted=output_sorted)
    if best == "dense":
        out = spgemm_dense_xla(lhs, rhs)
    elif best == "esc":
        from .device_sorted import EscSpgemm

        # one-shot: the SpMV-reduce selection plan (reduce="auto") costs
        # seconds of host plan build that only amortizing callers recover —
        # the sort reduction is the right one-shot engine
        out = EscSpgemm(lhs, rhs, reduce="sort").multiply()
    else:
        out = spgemm_block_device(lhs, rhs)
    return out if output_sorted else CsrMatrix(
        out.rows, out.cols, out.vals, out.indices, out.offsets, is_sorted=False
    )

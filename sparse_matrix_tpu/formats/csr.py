"""Host CSR format.

Re-design of the reference ``CsrMatrix<T, const IS_SORTED: bool>``
(``spam_csr/src/lib.rs:26-32``) as a numpy-array-backed Python class with a
runtime ``is_sorted`` flag instead of a const generic. This is the *host*
representation: construction, conversion and element access live here; the
device kernels (``sparse_matrix_tpu.ops``) consume its arrays as jnp pytrees.

The seven structural invariants (``spam_csr/src/lib.rs:47-81``):

1. ``len(indices) == len(vals)``
2. ``len(offsets) == rows + 1``
3. ``offsets`` is non-decreasing
4. ``offsets[rows] == nnz``
5. all column indices are in ``[0, cols)``
6. per-row indices strictly increasing if sorted, else all-distinct
7. ``offsets[0] == 0``

Unlike DOK, CSR stores explicit zeros (e.g. from additive cancellation, as the
reference's ``apply_elementwise`` does, ``spam_csr/src/lib.rs:83-148``).

Index dtype is uint32 with ``0xFFFF_FFFF`` reserved as the empty/pad sentinel,
carrying the reference's contract that column indices be < 2^32-1
(``spam_csr/src/mul_hash.rs:12``); it doubles as the padding sentinel of the
tiled device formats.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from ..core.dok import DokMatrix
from ..core.matrix import Matrix, check_dims

__all__ = [
    "CsrMatrix", "INDEX_DTYPE", "OFFSET_DTYPE", "SENTINEL", "sample_row_bands"
]


def sample_row_bands(m: "CsrMatrix", target_nnz: int = 200_000):
    """(sub_csr, scale): a few contiguous row bands totalling about
    ``target_nnz`` entries, and the factor to scale entry/slab/chunk
    counts back up. Contiguous bands preserve the local structure the
    format planners' cost estimators key on; their counts scale linearly
    in nnz. Used by the dispatch estimators on multi-million-nnz
    operators (a full estimator pass there costs seconds of AMG setup
    per level)."""
    nnz = m.nnz()
    if nnz <= target_nnz:
        return m, 1.0
    # memoized per (matrix, target): dispatch costing, kw selection, and
    # the bell pre-filter each re-sample the same operator during one
    # plan, and every fresh sample re-derives row_ids/slab counts from
    # scratch (0.8 s of a 2048² AMG setup)
    memo = m._cache.setdefault("row_band_sample", {})
    hit = memo.get(target_nnz)
    if hit is not None:
        return hit
    nbands = 4
    band_nnz = target_nnz // nbands
    starts = np.linspace(0, nnz - band_nnz, nbands).astype(np.int64)
    offs = m.offsets
    vals_parts, idx_parts, counts, bounds = [], [], [], []
    new_row = 0
    for st in starts:
        r0 = int(np.searchsorted(offs, st, side="right") - 1)
        r1 = int(np.searchsorted(offs, st + band_nnz, side="right"))
        r1 = min(max(r1, r0 + 1), m.rows)
        lo, hi = int(offs[r0]), int(offs[r1])
        vals_parts.append(m.vals[lo:hi])
        idx_parts.append(m.indices[lo:hi].astype(np.int64))
        counts.append(np.diff(offs[r0 : r1 + 1]))
        bounds.append(r0 - new_row)  # band's row renumbering shift
        new_row += r1 - r0
    # renumbering rows breaks every element offset c - r unless the
    # band's columns shift along with its rows; a uniform extra offset C
    # keeps shifted columns non-negative without changing the offset
    # structure (layer/bucket/chunk patterns are shift-invariant)
    C = max(max(bounds), 0)
    idx_parts = [
        (ip - sh + C).astype(INDEX_DTYPE) for ip, sh in zip(idx_parts, bounds)
    ]
    cnt = np.concatenate(counts)
    sub_offs = np.zeros(len(cnt) + 1, OFFSET_DTYPE)
    np.cumsum(cnt, out=sub_offs[1:])
    sub = CsrMatrix(
        len(cnt), m.cols + C, np.concatenate(vals_parts),
        np.concatenate(idx_parts), sub_offs, is_sorted=m.is_sorted,
    )
    out = (sub, nnz / max(1, sub.nnz()))
    memo[target_nnz] = out
    return out

INDEX_DTYPE = np.uint32
OFFSET_DTYPE = np.int64
SENTINEL = np.uint32(0xFFFFFFFF)  # empty/pad marker (mul_hash.rs:12 contract)


class CsrMatrix(Matrix):
    """Compressed sparse row matrix with optional within-row column sorting."""

    __slots__ = (
        "_rows", "_cols", "vals", "indices", "offsets", "is_sorted", "_cache",
        "_version",
    )

    def __init__(
        self,
        rows: int,
        cols: int,
        vals: np.ndarray,
        indices: np.ndarray,
        offsets: np.ndarray,
        *,
        is_sorted: bool,
        validate: bool = False,
    ):
        self._rows, self._cols = check_dims(rows, cols)
        self.vals = np.asarray(vals)
        self.indices = np.asarray(indices, dtype=INDEX_DTYPE)
        self.offsets = np.asarray(offsets, dtype=OFFSET_DTYPE)
        self.is_sorted = bool(is_sorted)
        # memo for idempotent structure analyses (DIA probes, offset
        # histograms): the operator planner and the SpGEMM dispatcher probe
        # the same matrix repeatedly during AMG setup (45 try_dia calls =
        # 10.5 s of the 2048^2 profile). Invalidated by set_element, which
        # also bumps _version (memo stamps of OTHER matrices referencing
        # this one — the transpose memo — check it to detect mutation).
        self._cache = {}
        self._version = 0
        if validate and not self.invariants():
            raise ValueError("CSR invariants violated")

    # -- construction --------------------------------------------------------
    @classmethod
    def new(cls, rows: int, cols: int, *, dtype=np.float64, is_sorted: bool = True) -> "CsrMatrix":
        # the reference pre-allocates min(1000, r*c/5) capacity
        # (spam_csr/src/lib.rs:162-171) — a growth heuristic numpy doesn't need.
        rows, cols = check_dims(rows, cols)
        return cls(
            rows,
            cols,
            np.zeros(0, dtype=dtype),
            np.zeros(0, dtype=INDEX_DTYPE),
            np.zeros(rows + 1, dtype=OFFSET_DTYPE),
            is_sorted=is_sorted,
        )

    @classmethod
    def identity(cls, n: int, *, dtype=np.float64, is_sorted: bool = True) -> "CsrMatrix":
        # spam_csr/src/lib.rs:177-185
        return cls(
            n,
            n,
            np.ones(n, dtype=dtype),
            np.arange(n, dtype=INDEX_DTYPE),
            np.arange(n + 1, dtype=OFFSET_DTYPE),
            is_sorted=is_sorted,
        )

    @classmethod
    def from_dok(cls, dok: DokMatrix, *, dtype=None) -> "CsrMatrix":
        """Sorted CSR from DOK via one pass over lexicographic entries
        (``spam_csr/src/lib.rs:315-334``)."""
        dtype = dtype if dtype is not None else (dok.dtype or np.float64)
        n = dok.nnz()
        rr = np.empty(n, dtype=np.int64)
        cc = np.empty(n, dtype=np.int64)
        vv = np.empty(n, dtype=dtype)
        for k, ((i, j), t) in enumerate(dok.iter_entries()):
            rr[k], cc[k], vv[k] = i, j, t
        offsets = np.zeros(dok.rows + 1, dtype=OFFSET_DTYPE)
        offsets[1:] = np.bincount(rr, minlength=dok.rows)
        np.cumsum(offsets, out=offsets)
        return cls(dok.rows, dok.cols, vv, cc.astype(INDEX_DTYPE), offsets, is_sorted=True)

    @classmethod
    def from_dok_shuffled(cls, dok: DokMatrix, rng: np.random.Generator, *, dtype=None) -> "CsrMatrix":
        """Unsorted CSR from DOK: shuffle entries, then stable-sort by row only,
        so within-row column order is randomized — the adversarial-order
        generator used throughout the reference tests
        (``from_dok``, ``spam_csr/src/lib.rs:336-358``)."""
        m = cls.from_dok(dok, dtype=dtype)
        perm_vals = m.vals.copy()
        perm_idx = m.indices.copy()
        for r in range(m.rows):
            lo, hi = int(m.offsets[r]), int(m.offsets[r + 1])
            if hi - lo > 1:
                p = rng.permutation(hi - lo)
                perm_vals[lo:hi] = perm_vals[lo:hi][p]
                perm_idx[lo:hi] = perm_idx[lo:hi][p]
        return cls(m.rows, m.cols, perm_vals, perm_idx, m.offsets, is_sorted=False)

    @classmethod
    def from_coo(
        cls, rows: int, cols: int, r: np.ndarray, c: np.ndarray, v: np.ndarray, *, sum_duplicates: bool = True
    ) -> "CsrMatrix":
        """Sorted CSR from COO triplets (vectorized lexsort path)."""
        rows, cols = check_dims(rows, cols)
        r = np.asarray(r, dtype=np.int64)
        c = np.asarray(c, dtype=np.int64)
        v = np.asarray(v)
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        if sum_duplicates and len(r):
            keys = r * cols + c
            head = np.empty(len(keys), dtype=bool)
            head[0] = True
            np.not_equal(keys[1:], keys[:-1], out=head[1:])
            seg = np.cumsum(head) - 1
            v = _segsum_exact(seg, v)
            r, c = r[head], c[head]
        offsets = np.zeros(rows + 1, dtype=OFFSET_DTYPE)
        offsets[1:] = np.bincount(r, minlength=rows)
        np.cumsum(offsets, out=offsets)
        return cls(rows, cols, v, c.astype(INDEX_DTYPE), offsets, is_sorted=True)

    @classmethod
    def from_scipy(cls, s) -> "CsrMatrix":
        """From any scipy.sparse matrix (sorted CSR)."""
        from ..verify.differential import from_scipy

        return from_scipy(s)

    def to_scipy(self):
        """To scipy.sparse.csr_matrix."""
        from ..verify.differential import to_scipy

        return to_scipy(self)

    @classmethod
    def from_bcoo(cls, b) -> "CsrMatrix":
        """From a ``jax.experimental.sparse.BCOO`` (unbatched, unblocked);
        duplicate coordinates are summed (BCOO allows them, CSR invariant 6
        does not)."""
        if getattr(b, "n_batch", 0) or getattr(b, "n_dense", 0):
            raise ValueError("from_bcoo supports unbatched/unblocked BCOO only")
        idx = np.asarray(b.indices, dtype=np.int64)
        return cls.from_coo(
            int(b.shape[0]), int(b.shape[1]), idx[:, 0], idx[:, 1],
            np.asarray(b.data),
        )

    def to_bcoo(self, *, dtype=None):
        """To ``jax.experimental.sparse.BCOO`` — the bridge to jax's own
        experimental sparse stack (``sparsify`` transforms, BCOO matmuls).
        Planned operators
        (:class:`~sparse_matrix_tpu.ops.operator.SpmvOperator`) are the
        library's SpMV path — this exists for interop."""
        import jax.numpy as jnp
        from jax.experimental import sparse as jsparse

        v = self.vals if dtype is None else self.vals.astype(dtype)
        idx = np.stack(
            [self.row_ids(), self.indices.astype(np.int64)], axis=1
        )
        return jsparse.BCOO(
            (jnp.asarray(v), jnp.asarray(idx)), shape=self.shape,
            indices_sorted=self.is_sorted, unique_indices=True,
        )

    def to_dok(self) -> DokMatrix:
        """CSR -> DOK (zero entries dropped by DOK set semantics),
        reference ``From<CsrMatrix> for DokMatrix`` (``spam_csr/src/lib.rs:375-384``)."""
        m = DokMatrix(self._rows, self._cols, dtype=self.vals.dtype)
        for pos, t in self.iter_entries():
            m.set_element(pos, t)
        return m

    # -- shape / access ------------------------------------------------------
    @property
    def rows(self) -> int:
        return self._rows

    @property
    def cols(self) -> int:
        return self._cols

    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_slice(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        return self.indices[lo:hi], self.vals[lo:hi]

    def get_element(self, pos: Tuple[int, int]):
        # binary search when sorted, linear scan otherwise
        # (spam_csr/src/lib.rs:199-213)
        self._check_bounds(pos)
        i, j = pos
        cidx, vals = self.row_slice(i)
        if self.is_sorted:
            k = np.searchsorted(cidx, j)
            if k < len(cidx) and cidx[k] == j:
                return vals[k]
            return None
        hits = np.nonzero(cidx == j)[0]
        return vals[hits[0]] if len(hits) else None

    def set_element(self, pos: Tuple[int, int], t):
        # CSR stores explicit zeros; inserting shifts the tail and bumps
        # offsets (spam_csr/src/lib.rs:215-254). Numpy arrays make this a
        # rebuild-with-insert; same semantics, vectorized shift.
        self._check_bounds(pos)
        i, j = pos
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        cidx = self.indices[lo:hi]
        if self.is_sorted:
            k = int(np.searchsorted(cidx, j))
            found = k < len(cidx) and cidx[k] == j
        else:
            hits = np.nonzero(cidx == j)[0]
            found = len(hits) > 0
            k = int(hits[0]) if found else len(cidx)  # append at row end
        self._cache = {}
        self._version += 1
        if found:
            old = self.vals[lo + k]
            self.vals = self.vals.copy()
            self.vals[lo + k] = t
            return old
        ins = lo + k
        self.vals = np.insert(self.vals, ins, t)
        self.indices = np.insert(self.indices, ins, INDEX_DTYPE(j))
        self.offsets = self.offsets.copy()
        self.offsets[i + 1 :] += 1
        return None

    # -- structure ------------------------------------------------------------
    def transpose(self) -> "CsrMatrix":
        """Transpose by stable (col, row) sort — O(nnz log nnz), replacing the
        reference's dense O(r*c) sweep (``spam_csr/src/lib.rs:256-264``, noted
        as a simplicity artifact in SURVEY.md). Output rows end up sorted, as
        the reference's does. The native runtime runs it as an O(nnz)
        counting sort (row-major iteration makes the stable scatter emit
        each transposed row already sorted — identical output).

        Memoized both ways with a version stamp (AMG setup transposed each
        42M-nnz prolongator twice — once for the Galerkin product, once for
        the restriction operator); a mutated result drops the memo."""
        memo = self._cache.get("transpose")
        if memo is not None:
            t, stamp = memo
            if t._version == stamp:
                return t
        t = self._transpose_impl()
        self._cache["transpose"] = (t, t._version)
        t._cache["transpose"] = (self, self._version)  # reverse memo
        return t

    def _transpose_impl(self) -> "CsrMatrix":
        from ..native import csr_transpose_native

        res = csr_transpose_native(
            self._rows, self._cols, self.offsets, self.indices, self.vals
        )
        if res is not None:
            t_offsets, t_indices, t_vals = res
            return CsrMatrix(
                self._cols,
                self._rows,
                t_vals,
                t_indices,
                t_offsets.astype(OFFSET_DTYPE),
                is_sorted=self.is_sorted,
            )
        n = self.nnz()
        row_ids = np.repeat(np.arange(self._rows, dtype=np.int64), np.diff(self.offsets))
        order = np.lexsort((row_ids, self.indices.astype(np.int64)))
        new_offsets = np.zeros(self._cols + 1, dtype=OFFSET_DTYPE)
        new_offsets[1:] = np.bincount(self.indices.astype(np.int64), minlength=self._cols)
        np.cumsum(new_offsets, out=new_offsets)
        return CsrMatrix(
            self._cols,
            self._rows,
            self.vals[order],
            row_ids[order].astype(INDEX_DTYPE),
            new_offsets,
            is_sorted=self.is_sorted,
        )

    # -- invariants ------------------------------------------------------------
    def invariant1(self) -> bool:
        return self.indices.shape[0] == self.vals.shape[0]

    def invariant2(self) -> bool:
        return self.offsets.shape[0] == self._rows + 1

    def invariant3(self) -> bool:
        return bool(np.all(np.diff(self.offsets) >= 0))

    def invariant4(self) -> bool:
        return int(self.offsets[self._rows]) == self.indices.shape[0]

    def invariant5(self) -> bool:
        return bool(np.all(self.indices < self._cols)) if self.nnz() else True

    def invariant6(self) -> bool:
        if self.nnz() == 0:
            return True
        idx = self.indices.astype(np.int64)
        d = np.diff(idx)
        row_start_mask = np.zeros(len(idx), dtype=bool)
        starts = self.offsets[:-1][np.diff(self.offsets) > 0]
        row_start_mask[starts.astype(np.int64)] = True
        if self.is_sorted:
            # strictly increasing within each row
            return bool(np.all((d > 0) | row_start_mask[1:]))
        # all-distinct within each row
        for r in range(self._rows):
            lo, hi = int(self.offsets[r]), int(self.offsets[r + 1])
            if hi - lo != len(np.unique(idx[lo:hi])):
                return False
        return True

    def invariant7(self) -> bool:
        return int(self.offsets[0]) == 0

    def invariants(self) -> bool:
        return (
            self.invariant1()
            and self.invariant2()
            and self.invariant3()
            and self.invariant4()
            and self.invariant5()
            and self.invariant6()
            and self.invariant7()
        )

    # -- iteration -------------------------------------------------------------
    def iter_entries(self) -> Iterator[Tuple[Tuple[int, int], object]]:
        for r in range(self._rows):
            lo, hi = int(self.offsets[r]), int(self.offsets[r + 1])
            for k in range(lo, hi):
                yield (r, int(self.indices[k])), self.vals[k]

    def matvec_host(self, x: np.ndarray) -> np.ndarray:
        """Exact host ``A @ x`` in f64 (oracle/residual checks; vectors or
        ``(cols, K)`` blocks). The device paths live in ``ops/``."""
        x = np.asarray(x, dtype=np.float64)
        rid = self.row_ids()
        idx = self.indices.astype(np.int64)
        v = self.vals.astype(np.float64)
        if x.ndim == 1:
            out = np.zeros(self._rows, np.float64)
            np.add.at(out, rid, v * x[idx])
        else:
            out = np.zeros((self._rows, x.shape[1]), np.float64)
            np.add.at(out, rid, v[:, None] * x[idx])
        return out

    def row_ids(self) -> np.ndarray:
        """Per-entry row index (expansion of offsets).

        Memoized (callers must treat the result as read-only): format
        planning and SpGEMM dispatch re-derive it repeatedly — np.repeat
        alone was 1.7 s of the 2048^2 AMG setup profile. Invalidated by
        ``set_element`` with the rest of ``_cache``."""
        out = self._cache.get("row_ids")
        if out is None:
            out = np.repeat(np.arange(self._rows, dtype=np.int64), np.diff(self.offsets))
            self._cache["row_ids"] = out
        return out

    # -- arithmetic -------------------------------------------------------------
    def apply_elementwise(self, rhs: "CsrMatrix", f) -> "CsrMatrix":
        """Union-merge combine keeping cancellation zeros explicit, as the
        reference's ``apply_elementwise`` (``spam_csr/src/lib.rs:83-148``):
        for every position present in either operand the result stores
        ``f(t1, t2)`` with the absent side as zero. ``f`` must be a numpy
        ufunc-compatible binary function (vectorized)."""
        if self.shape != rhs.shape:
            raise ValueError("matrices must have identical dimensions")
        dtype = np.result_type(self.vals.dtype, rhs.vals.dtype)
        zero = dtype.type(0)
        ra, ca, va = self.row_ids(), self.indices.astype(np.int64), self.vals
        rb, cb, vb = rhs.row_ids(), rhs.indices.astype(np.int64), rhs.vals
        # tag 0 = lhs, 1 = rhs; lexsort by (row, col, tag) aligns pairs
        r = np.concatenate([ra, rb])
        c = np.concatenate([ca, cb])
        v = np.concatenate([va.astype(dtype), vb.astype(dtype)])
        tag = np.concatenate(
            [np.zeros(len(ra), np.int8), np.ones(len(rb), np.int8)]
        )
        if self._rows * self._cols < 2**62:
            # packed single-key stable sort (radix) == lexsort((tag, c, r)):
            # stability preserves lhs-before-rhs concatenation order for
            # equal (row, col), which is exactly the tag order
            order = np.argsort(r * self._cols + c, kind="stable")
        else:  # packed key would overflow int64
            order = np.lexsort((tag, c, r))
        r, c, v, tag = r[order], c[order], v[order], tag[order]
        n = len(r)
        if n == 0:
            return CsrMatrix(
                self._rows, self._cols, v, c.astype(INDEX_DTYPE),
                np.zeros(self._rows + 1, dtype=OFFSET_DTYPE), is_sorted=True,
            )
        head = np.empty(n, dtype=bool)
        head[0] = True
        head[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        both = ~head  # second element of an aligned pair
        # per unique key: lhs value (or 0) and rhs value (or 0)
        lhs_v = np.where(tag == 0, v, zero)
        rhs_v = np.where(tag == 1, v, zero)
        pair_next_rhs = np.zeros(n, dtype=dtype)
        pair_next_rhs[:-1] = np.where(both[1:], rhs_v[1:], zero)
        t1 = np.where(head, lhs_v, zero)
        t2 = np.where(head, np.where(tag == 0, pair_next_rhs, rhs_v), zero)
        out_v = f(t1[head], t2[head])
        r_o, c_o = r[head], c[head]
        offsets = np.zeros(self._rows + 1, dtype=OFFSET_DTYPE)
        offsets[1:] = np.bincount(r_o, minlength=self._rows)
        np.cumsum(offsets, out=offsets)
        return CsrMatrix(
            self._rows,
            self._cols,
            np.asarray(out_v, dtype=dtype),
            c_o.astype(INDEX_DTYPE),
            offsets,
            is_sorted=True,
        )

    def __add__(self, rhs: "CsrMatrix") -> "CsrMatrix":
        return self.apply_elementwise(rhs, np.add)

    def __sub__(self, rhs: "CsrMatrix") -> "CsrMatrix":
        return self.apply_elementwise(rhs, np.subtract)

    def __matmul__(self, rhs: "CsrMatrix") -> "CsrMatrix":
        # unsorted output, as the reference's Mul operator
        # (spam_csr/src/lib.rs:292-297); engine picked by cost model
        from ..ops.spgemm_block import spgemm_auto

        return spgemm_auto(self, rhs, output_sorted=False)

    def __eq__(self, other) -> bool:
        if not isinstance(other, CsrMatrix):
            return NotImplemented
        return (
            self.shape == other.shape
            and self.is_sorted == other.is_sorted
            and np.array_equal(self.offsets, other.offsets)
            and np.array_equal(self.indices, other.indices)
            and np.array_equal(self.vals, other.vals, equal_nan=np.issubdtype(self.vals.dtype, np.floating))
        )

    def __hash__(self):  # pragma: no cover
        return id(self)

    def __repr__(self) -> str:
        return (
            f"CsrMatrix({self._rows}x{self._cols}, nnz={self.nnz()}, "
            f"sorted={self.is_sorted}, dtype={self.vals.dtype})"
        )

    def to_dense(self) -> np.ndarray:
        a = np.zeros((self._rows, self._cols), dtype=self.vals.dtype)
        r = self.row_ids()
        # duplicate-free by invariant 6, so direct assignment is safe
        a[r, self.indices.astype(np.int64)] = self.vals
        return a

    # -- scipy.sparse-shaped convenience surface -------------------------------
    # Aliases so scipy.sparse users can switch with minimal edits (the compat
    # namespace ``sparse_matrix_tpu.sparse`` builds on these). One deliberate
    # difference: ``nnz`` is a METHOD here (reference ``Matrix::nnz``,
    # spam_matrix/src/lib.rs:15-27), not scipy's property — use ``getnnz()``
    # for the scipy spelling.

    @property
    def T(self) -> "CsrMatrix":
        return self.transpose()

    def toarray(self) -> np.ndarray:
        return self.to_dense()

    def todense(self) -> np.ndarray:
        return self.to_dense()

    def tocsr(self) -> "CsrMatrix":
        return self

    def getnnz(self, axis=None):
        """Stored-entry counts: total (``axis=None``), per column
        (``axis=0``), or per row (``axis=1``) — scipy.sparse semantics
        (explicit zeros count)."""
        if axis is None:
            return self.nnz()
        if axis in (0, -2):
            return np.bincount(
                self.indices.astype(np.int64), minlength=self._cols
            ).astype(np.int64)
        if axis in (1, -1):
            return np.diff(self.offsets).astype(np.int64)
        raise ValueError(f"axis must be None, 0, or 1, got {axis}")

    def count_nonzero(self) -> int:
        return int(np.count_nonzero(self.vals))

    def dot(self, other):
        """Matrix-matrix (CsrMatrix) or matrix-vector/block (ndarray)."""
        if isinstance(other, CsrMatrix):
            return self @ other
        arr = np.asarray(other)
        if arr.ndim == 1:
            return self.matvec_host(arr)
        if arr.ndim == 2:
            return np.stack(
                [self.matvec_host(arr[:, j]) for j in range(arr.shape[1])], axis=1
            )
        raise ValueError("dot expects a CsrMatrix, vector, or 2-D block")

    def diagonal(self, k: int = 0) -> np.ndarray:
        """The k-th diagonal as a dense vector (scipy semantics: missing
        entries read as zero)."""
        n = max(0, min(self._rows + min(k, 0), self._cols - max(k, 0)))
        out = np.zeros(n, dtype=self.vals.dtype)
        r = self.row_ids()
        c = self.indices.astype(np.int64)
        on = c - r == k
        out[np.where(k >= 0, r[on], c[on])] = self.vals[on]
        return out

    def astype(self, dtype) -> "CsrMatrix":
        return CsrMatrix(
            self._rows, self._cols, self.vals.astype(dtype),
            self.indices.copy(), self.offsets.copy(), is_sorted=self.is_sorted,
        )

    def copy(self) -> "CsrMatrix":
        return self.astype(self.vals.dtype)

    def conj(self) -> "CsrMatrix":
        return CsrMatrix(
            self._rows, self._cols, np.conj(self.vals),
            self.indices.copy(), self.offsets.copy(), is_sorted=self.is_sorted,
        )

    def multiply(self, other: "CsrMatrix") -> "CsrMatrix":
        """Elementwise (Hadamard) product; the output pattern is the
        INTERSECTION of the two patterns (scipy.sparse semantics, unlike
        :meth:`apply_elementwise`'s union merge for add/sub)."""
        if not isinstance(other, CsrMatrix):
            other = CsrMatrix.from_coo(
                self._rows, self._cols,
                *np.nonzero(np.asarray(other)),
                np.asarray(other)[np.nonzero(np.asarray(other))],
            )
        if self.shape != other.shape:
            raise ValueError("matrices must have identical dimensions")
        ka = self.row_ids() * self._cols + self.indices.astype(np.int64)
        kb = other.row_ids() * self._cols + other.indices.astype(np.int64)
        _, ia, ib = np.intersect1d(ka, kb, assume_unique=True, return_indices=True)
        v = self.vals[ia] * other.vals[ib]
        k = ka[ia]
        return CsrMatrix.from_coo(
            self._rows, self._cols, k // self._cols, k % self._cols, v,
            sum_duplicates=False,
        )

    def sum(self, axis=None):
        """Total (axis=None), column sums (axis=0), or row sums (axis=1) —
        returned as plain ndarrays, not np.matrix."""
        if axis is None:
            return self.vals.sum()
        if axis in (0, -2):
            return np.bincount(
                self.indices.astype(np.int64), weights=self.vals.real,
                minlength=self._cols,
            ).astype(self.vals.dtype) if not np.iscomplexobj(self.vals) else (
                np.bincount(self.indices.astype(np.int64), weights=self.vals.real, minlength=self._cols)
                + 1j * np.bincount(self.indices.astype(np.int64), weights=self.vals.imag, minlength=self._cols)
            )
        if axis in (1, -1):
            out = np.zeros(self._rows, dtype=self.vals.dtype)
            np.add.at(out, self.row_ids(), self.vals)
            return out
        raise ValueError(f"axis must be None, 0, or 1, got {axis}")

    # -- scipy.sparse.csr_matrix method-surface completion ------------------
    # Everything below mirrors scipy's csr_matrix public methods so a scipy
    # user can switch without renaming (differential-tested in
    # tests/test_csr_scipy_surface.py; the dir()-diff coverage test there
    # pins the surface to scipy's with zero exclusions). Design notes:
    # * CSR is the single canonical host storage — the row-major
    #   "conversions" (tocoo/tocsc/tolil/tobsr) return CSR objects, while
    #   todok/todia build the real alternate structures.
    # * axis reductions return plain 1-D ndarrays, not np.matrix.

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def data(self) -> np.ndarray:
        """scipy name for the value array (alias of ``vals``)."""
        return self.vals

    @property
    def indptr(self) -> np.ndarray:
        """scipy name for the row-offset array (alias of ``offsets``)."""
        return self.offsets

    @property
    def ndim(self) -> int:
        return 2

    @property
    def size(self) -> int:
        return self.nnz()

    @property
    def format(self) -> str:
        return "csr"

    maxprint = 50  # scipy's repr truncation knob; our repr never dumps entries

    def getmaxprint(self) -> int:
        return self.maxprint

    def getformat(self) -> str:
        return self.format

    def get_shape(self) -> Tuple[int, int]:
        return self.shape

    def set_shape(self, shape) -> None:
        """In-place reshape (scipy semantics: same number of elements)."""
        r = self.reshape(shape)
        self._adopt(r)

    def _adopt(self, other: "CsrMatrix") -> None:
        """In-place mutation helper: take ``other``'s fields, invalidate
        memos, and bump ``_version`` so memo stamps held by other matrices
        (the transpose memo) detect the change."""
        self._rows, self._cols = other._rows, other._cols
        self.vals, self.indices, self.offsets = (
            other.vals, other.indices, other.offsets,
        )
        self.is_sorted = other.is_sorted
        self._cache = {}
        self._version += 1

    @property
    def real(self) -> "CsrMatrix":
        return CsrMatrix(
            self._rows, self._cols, np.ascontiguousarray(self.vals.real),
            self.indices.copy(), self.offsets.copy(), is_sorted=self.is_sorted,
        )

    @property
    def imag(self) -> "CsrMatrix":
        return CsrMatrix(
            self._rows, self._cols, np.ascontiguousarray(self.vals.imag),
            self.indices.copy(), self.offsets.copy(), is_sorted=self.is_sorted,
        )

    @property
    def has_sorted_indices(self) -> bool:
        return self.is_sorted

    @property
    def has_canonical_format(self) -> bool:
        # CSR invariant 6 forbids duplicate columns in a row, so sorted
        # implies canonical
        return self.is_sorted

    def conjugate(self) -> "CsrMatrix":
        return self.conj()

    def getH(self) -> "CsrMatrix":
        return self.conj().transpose()

    def asfptype(self) -> "CsrMatrix":
        if self.vals.dtype.kind in ("f", "c"):
            return self
        return self.astype(np.float64)

    def check_format(self, full_check: bool = True) -> None:
        """Raise ``ValueError`` unless the seven CSR invariants hold
        (scipy's check_format analog; ``full_check`` kept for signature
        parity — the invariants are always checked in full)."""
        if not self.invariants():
            raise ValueError("CSR invariants violated")

    def nonzero(self):
        """Row/column arrays of the explicitly NONZERO entries in row-major
        order (scipy filters stored zeros)."""
        m = self if self.is_sorted else self.sorted_indices()
        keep = m.vals != 0
        return (
            m.row_ids()[keep].copy(),
            m.indices[keep].astype(np.int64),
        )

    # -- canonical-format maintenance ---------------------------------------

    def sort_indices(self) -> None:
        """In-place within-row column sort (no-op when already sorted)."""
        if self.is_sorted:
            return
        order = np.lexsort((self.indices, self.row_ids()))
        new = CsrMatrix(
            self._rows, self._cols, self.vals[order], self.indices[order],
            self.offsets.copy(), is_sorted=True,
        )
        self._adopt(new)

    def sorted_indices(self) -> "CsrMatrix":
        out = self.copy()
        out.sort_indices()
        return out

    def sum_duplicates(self) -> None:
        """Sort indices and merge duplicate coordinates in place. Our
        invariants already forbid duplicates, so after the sort this is a
        defensive no-op — kept for scipy signature parity."""
        self.sort_indices()
        c = self.indices
        r = self.row_ids()
        if len(c) == 0:
            return
        dup = (c[1:] == c[:-1]) & (r[1:] == r[:-1])
        if not dup.any():
            return
        self._adopt(CsrMatrix.from_coo(self._rows, self._cols, r, c, self.vals))

    def eliminate_zeros(self) -> None:
        """Drop explicitly-stored zero entries in place."""
        keep = self.vals != 0
        if keep.all():
            return
        r = self.row_ids()[keep]
        offs = np.zeros(self._rows + 1, dtype=OFFSET_DTYPE)
        offs[1:] = np.bincount(r, minlength=self._rows)
        np.cumsum(offs, out=offs)
        self._adopt(CsrMatrix(
            self._rows, self._cols, self.vals[keep], self.indices[keep],
            offs, is_sorted=self.is_sorted,
        ))

    def prune(self) -> None:
        """Trim storage to ``nnz`` entries. Our arrays are exact-size by
        construction (no growth slack), so this is a documented no-op."""

    # -- shape changes -------------------------------------------------------

    def reshape(self, *shape, order: str = "C") -> "CsrMatrix":
        """New shape with the same number of elements; entries keep their
        ``order``-linearized position (scipy.sparse semantics). Accepts
        ``reshape((r, c))`` or ``reshape(r, c)``."""
        if len(shape) == 1:
            shape = tuple(np.atleast_1d(shape[0])) if not isinstance(
                shape[0], tuple
            ) else shape[0]
        if len(shape) != 2:
            raise ValueError("sparse matrices stay 2-D under reshape")
        r2, c2 = int(shape[0]), int(shape[1])
        if r2 == -1:
            r2 = (self._rows * self._cols) // c2
        if c2 == -1:
            c2 = (self._rows * self._cols) // r2
        if r2 * c2 != self._rows * self._cols:
            raise ValueError(
                f"cannot reshape {self.shape} ({self._rows * self._cols} "
                f"elements) into ({r2}, {c2})"
            )
        r = self.row_ids()
        c = self.indices.astype(np.int64)
        if order == "C":
            lin = r * self._cols + c
            nr, nc = lin // c2, lin % c2
        elif order == "F":
            lin = c * self._rows + r
            nr, nc = lin % r2, lin // r2
        else:
            raise ValueError("order must be 'C' or 'F'")
        return CsrMatrix.from_coo(r2, c2, nr, nc, self.vals, sum_duplicates=False)

    def resize(self, *shape) -> None:
        """In-place shape change; entries outside the new bounds are
        dropped (scipy.sparse semantics, unlike reshape)."""
        if len(shape) == 1:
            shape = tuple(shape[0])
        r2, c2 = check_dims(int(shape[0]), int(shape[1]))
        r = self.row_ids()
        c = self.indices.astype(np.int64)
        keep = (r < r2) & (c < c2)
        offs = np.zeros(r2 + 1, dtype=OFFSET_DTYPE)
        offs[1:] = np.bincount(r[keep], minlength=r2)
        np.cumsum(offs, out=offs)
        self._adopt(CsrMatrix(
            r2, c2, self.vals[keep], self.indices[keep], offs,
            is_sorted=self.is_sorted,
        ))

    # -- indexing -------------------------------------------------------------

    def _norm_index(self, key, n: int) -> np.ndarray:
        """Normalize an int/slice/array/bool-mask index into an int64 array
        of positions in ``[0, n)``."""
        if isinstance(key, (int, np.integer)):
            i = int(key) + (n if key < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {key} out of range for axis of {n}")
            return np.array([i], dtype=np.int64)
        if isinstance(key, slice):
            return np.arange(*key.indices(n), dtype=np.int64)
        a = np.asarray(key)
        if a.dtype == bool:
            if a.shape != (n,):
                raise IndexError("boolean mask length mismatch")
            return np.nonzero(a)[0].astype(np.int64)
        a = a.astype(np.int64).ravel()
        a = np.where(a < 0, a + n, a)
        if len(a) and (a.min() < 0 or a.max() >= n):
            raise IndexError(f"index out of range for axis of {n}")
        return a

    def _select_rows(self, ri: np.ndarray) -> "CsrMatrix":
        """Rows ``ri`` in order (duplicates allowed) — vectorized segment
        gather over the offset array."""
        cnt = np.diff(self.offsets)[ri]
        cum = np.cumsum(cnt)
        total = int(cum[-1]) if len(cum) else 0
        starts = self.offsets[ri].astype(np.int64)
        idx = (
            np.arange(total, dtype=np.int64)
            - np.repeat(cum - cnt, cnt)
            + np.repeat(starts, cnt)
        )
        offs = np.zeros(len(ri) + 1, dtype=OFFSET_DTYPE)
        offs[1:] = cum
        return CsrMatrix(
            len(ri), self._cols, self.vals[idx], self.indices[idx], offs,
            is_sorted=self.is_sorted,
        )

    def _select_cols(self, ci: np.ndarray) -> "CsrMatrix":
        """Columns ``ci`` in order (duplicates allowed): each stored entry
        with column ``c`` expands into one output entry per occurrence of
        ``c`` in ``ci`` — fully vectorized via a sorted-selection
        searchsorted expansion."""
        so = np.argsort(ci, kind="stable")
        sci = ci[so]
        c = self.indices.astype(np.int64)
        lo = np.searchsorted(sci, c, side="left")
        hi = np.searchsorted(sci, c, side="right")
        reps = hi - lo
        cum = np.cumsum(reps)
        total = int(cum[-1]) if len(cum) else 0
        pos = (
            np.arange(total, dtype=np.int64)
            - np.repeat(cum - reps, reps)
            + np.repeat(lo, reps)
        )
        out_c = so[pos]
        out_r = np.repeat(self.row_ids(), reps)
        out_v = np.repeat(self.vals, reps)
        return CsrMatrix.from_coo(
            self._rows, len(ci), out_r, out_c, out_v, sum_duplicates=False
        )

    def __getitem__(self, key):
        """scipy-style indexing: ``A[i]``/``A[i, j]``/slices/int arrays/
        boolean masks, outer selection for (rows, cols) pairs of
        slices/arrays, and inner pair indexing when both are arrays
        (``A[[1, 2], [3, 4]]`` -> 1x2 of the two elements, as scipy)."""
        if isinstance(key, tuple):
            if len(key) != 2:
                raise IndexError("only 2-D indexing is supported")
            rk, ck = key
        else:
            rk, ck = key, slice(None)
        int_r = isinstance(rk, (int, np.integer))
        int_c = isinstance(ck, (int, np.integer))
        if int_r and int_c:
            i = int(rk) + (self._rows if rk < 0 else 0)
            j = int(ck) + (self._cols if ck < 0 else 0)
            got = self.get_element((i, j))
            # get_element mirrors the reference's Option-returning get;
            # scipy indexing reads absent entries as zero
            return self.vals.dtype.type(0) if got is None else got
        arr_r = not int_r and not isinstance(rk, slice)
        arr_c = not int_c and not isinstance(ck, slice)
        if arr_r and arr_c:
            ri = self._norm_index(rk, self._rows)
            ci = self._norm_index(ck, self._cols)
            if len(ri) != len(ci):
                raise IndexError("inner indexing arrays must match in length")
            vals = np.array(
                [self[int(i), int(j)] for i, j in zip(ri, ci)]
            )
            return CsrMatrix.from_coo(
                1, len(ri), np.zeros(len(ri), np.int64),
                np.arange(len(ri), dtype=np.int64),
                vals.astype(self.vals.dtype), sum_duplicates=False,
            )
        out = self._select_rows(self._norm_index(rk, self._rows))
        if not (isinstance(ck, slice) and ck == slice(None)):
            out = out._select_cols(out._norm_index(ck, out._cols))
        return out

    def __setitem__(self, key, value):
        if (
            isinstance(key, tuple) and len(key) == 2
            and all(isinstance(k, (int, np.integer)) for k in key)
        ):
            i = int(key[0]) + (self._rows if key[0] < 0 else 0)
            j = int(key[1]) + (self._cols if key[1] < 0 else 0)
            self.set_element((i, j), value)
            return
        raise NotImplementedError(
            "only single-element assignment A[i, j] = v is supported; "
            "build matrices through DOK or from_coo"
        )

    def getrow(self, i: int) -> "CsrMatrix":
        return self[i]

    def getcol(self, j: int) -> "CsrMatrix":
        return self[:, [int(j) + (self._cols if j < 0 else 0)]]

    # -- scalar arithmetic ----------------------------------------------------

    def _scaled(self, s) -> "CsrMatrix":
        dt = np.result_type(self.vals.dtype, np.asarray(s).dtype)
        return CsrMatrix(
            self._rows, self._cols, self.vals.astype(dt) * s,
            self.indices.copy(), self.offsets.copy(), is_sorted=self.is_sorted,
        )

    @staticmethod
    def _is_scalar(x) -> bool:
        return np.isscalar(x) or (
            isinstance(x, np.ndarray) and x.ndim == 0
        )

    def __mul__(self, other):
        """Scalar scaling, or matrix product for matrix/vector operands
        (scipy.sparse.spmatrix ``*`` semantics)."""
        if self._is_scalar(other):
            return self._scaled(other)
        return self.dot(other)

    def __rmul__(self, other):
        if self._is_scalar(other):
            return self._scaled(other)
        return NotImplemented

    def __truediv__(self, other):
        if self._is_scalar(other):
            dt = np.result_type(self.vals.dtype, np.asarray(other).dtype, np.float64)
            return CsrMatrix(
                self._rows, self._cols, self.vals.astype(dt) / other,
                self.indices.copy(), self.offsets.copy(),
                is_sorted=self.is_sorted,
            )
        return NotImplemented

    def __neg__(self) -> "CsrMatrix":
        return self._scaled(-1)

    def __abs__(self) -> "CsrMatrix":
        return CsrMatrix(
            self._rows, self._cols, np.abs(self.vals),
            self.indices.copy(), self.offsets.copy(), is_sorted=self.is_sorted,
        )

    def __pow__(self, n):
        """Matrix power (spmatrix ``**`` semantics; elementwise power is
        :meth:`power`)."""
        from .construct import matrix_power

        return matrix_power(self, n)

    def power(self, n, dtype=None) -> "CsrMatrix":
        """ELEMENTWISE power over stored entries (scipy semantics; the
        pattern is preserved, so ``n`` must be a positive scalar — implicit
        zeros under ``n <= 0`` would densify)."""
        if not self._is_scalar(n):
            raise NotImplementedError("power expects a scalar exponent")
        if not n > 0:
            raise ValueError("power exponent must be > 0 (0**n densifies)")
        v = self.vals.astype(dtype) if dtype is not None else self.vals
        return CsrMatrix(
            self._rows, self._cols, v ** n, self.indices.copy(),
            self.offsets.copy(), is_sorted=self.is_sorted,
        )

    # -- elementwise binary min/max --------------------------------------------

    @classmethod
    def _from_dense(cls, d: np.ndarray) -> "CsrMatrix":
        r, c = np.nonzero(d)
        return cls.from_coo(
            d.shape[0], d.shape[1], r, c, d[r, c], sum_duplicates=False
        )

    def _minmax_binop(self, other, f) -> "CsrMatrix":
        if isinstance(other, CsrMatrix):
            return self.apply_elementwise(other, f)
        if self._is_scalar(other):
            if other == 0:
                return CsrMatrix(
                    self._rows, self._cols, f(self.vals, other),
                    self.indices.copy(), self.offsets.copy(),
                    is_sorted=self.is_sorted,
                )
            # a nonzero scalar flips every implicit zero: densify (scipy
            # takes the same path, with the same efficiency caveat)
            return self._from_dense(f(self.to_dense(), other))
        return self._from_dense(f(self.to_dense(), np.asarray(other)))

    def maximum(self, other) -> "CsrMatrix":
        """Elementwise maximum vs a sparse matrix, scalar, or dense array
        (scipy semantics: implicit zeros participate)."""
        return self._minmax_binop(other, np.maximum)

    def minimum(self, other) -> "CsrMatrix":
        """Elementwise minimum (see :meth:`maximum`)."""
        return self._minmax_binop(other, np.minimum)

    # -- reductions -------------------------------------------------------------

    def _minmax_reduce(self, axis, ufunc, skip_nan: bool):
        v = self.vals
        if skip_nan and np.issubdtype(v.dtype, np.floating):
            keep = ~np.isnan(v)
            v = v[keep]
            ridx = self.row_ids()[keep]
            cidx = self.indices[keep].astype(np.int64)
        else:
            ridx = self.row_ids()
            cidx = self.indices.astype(np.int64)
        full = self.nnz() == self._rows * self._cols and len(v) == self.nnz()
        if axis is None:
            if len(v) == 0:
                return self.vals.dtype.type(0)
            m = ufunc.reduce(v)
            if not full:
                m = ufunc(m, self.vals.dtype.type(0))
            return m
        if axis in (0, -2):
            n, idx, other = self._cols, cidx, self._rows
        elif axis in (1, -1):
            n, idx, other = self._rows, ridx, self._cols
        else:
            raise ValueError(f"axis must be None, 0, or 1, got {axis}")
        ident = (
            -np.inf if ufunc is np.maximum else np.inf
        ) if np.issubdtype(v.dtype, np.floating) else (
            np.iinfo(v.dtype).min if ufunc is np.maximum else np.iinfo(v.dtype).max
        )
        out = np.full(n, ident, dtype=v.dtype)
        ufunc.at(out, idx, v)
        count = np.bincount(idx, minlength=n)
        out = np.where(count < other, ufunc(out, v.dtype.type(0)), out)
        return out.astype(self.vals.dtype)

    def max(self, axis=None, out=None):
        """Maximum including implicit zeros; axis reductions return plain
        1-D ndarrays (scipy returns coo matrices)."""
        return self._minmax_reduce(axis, np.maximum, skip_nan=False)

    def min(self, axis=None, out=None):
        return self._minmax_reduce(axis, np.minimum, skip_nan=False)

    def nanmax(self, axis=None, out=None):
        return self._minmax_reduce(axis, np.maximum, skip_nan=True)

    def nanmin(self, axis=None, out=None):
        return self._minmax_reduce(axis, np.minimum, skip_nan=True)

    def mean(self, axis=None, dtype=None, out=None):
        """Arithmetic mean over ALL elements (implicit zeros included)."""
        dt = np.dtype(dtype) if dtype is not None else np.result_type(
            self.vals.dtype, np.float64
        )
        if axis is None:
            denom = self._rows * self._cols
            return (self.vals.astype(dt).sum() / denom) if denom else dt.type(0)
        s = self.sum(axis=axis).astype(dt)
        return s / (self._rows if axis in (0, -2) else self._cols)

    def _first_gap_cols(self) -> np.ndarray:
        """Per row: the first column holding an IMPLICIT zero (== cols for
        full rows). Sorted canonical rows have their first gap at the first
        k with ``indices[k] != k`` (else at the row's entry count)."""
        m = self if self.is_sorted else self.sorted_indices()
        cnt = np.diff(m.offsets)
        exc = m.offsets[:-1].astype(np.int64)
        local = np.arange(m.nnz(), dtype=np.int64) - np.repeat(exc, cnt)
        mism = m.indices.astype(np.int64) != local
        cand = np.where(mism, local, self._cols)
        first = np.full(self._rows, self._cols, dtype=np.int64)
        np.minimum.at(first, m.row_ids(), cand)
        return np.minimum(first, cnt)

    def _arg_reduce(self, axis, ufunc):
        if self._rows * self._cols == 0:
            raise ValueError("cannot take argmin/argmax of a zero-size matrix")
        want_max = ufunc is np.maximum
        m = self if self.is_sorted else self.sorted_indices()
        v = m.vals
        r = m.row_ids()
        c = m.indices.astype(np.int64)
        nan_pos = (
            np.nonzero(np.isnan(v))[0]
            if np.issubdtype(v.dtype, np.floating) else np.zeros(0, np.int64)
        )
        # per-row best explicit entry, first occurrence on ties: lexsort by
        # (row, -value-rank, col); NaN propagates like numpy (first NaN wins)
        if len(v):
            key = np.where(np.isnan(v), np.inf if want_max else -np.inf, v) \
                if np.issubdtype(v.dtype, np.floating) else v
            order = np.lexsort((c, -key if want_max else key, r))
            head = np.r_[True, r[order][1:] != r[order][:-1]]
            hrow = r[order][head]
            hval = v[order][head]
            hcol = c[order][head]
        else:
            hrow = np.zeros(0, np.int64)
            hval = np.zeros(0, v.dtype)
            hcol = np.zeros(0, np.int64)
        best_v = np.zeros(self._rows, dtype=np.result_type(v.dtype, np.float64))
        best_c = np.zeros(self._rows, dtype=np.int64)
        has = np.zeros(self._rows, dtype=bool)
        best_v[hrow] = hval
        best_c[hrow] = hcol
        has[hrow] = True
        gap = self._first_gap_cols()
        has_gap = gap < self._cols
        zero_beats = np.where(
            want_max, best_v < 0, best_v > 0
        ) & has_gap
        zero_ties = (best_v == 0) & has_gap
        best_c = np.where(~has & has_gap, gap, best_c)
        best_v = np.where(~has, 0.0, best_v)
        best_c = np.where(has & zero_beats, gap, best_c)
        best_v = np.where(has & zero_beats, 0.0, best_v)
        best_c = np.where(has & zero_ties, np.minimum(best_c, gap), best_c)
        if axis in (1, -1):
            out = best_c.copy()
            if len(nan_pos):  # numpy-style NaN: first NaN in the row wins
                first = np.full(self._rows, -1, np.int64)
                first[r[nan_pos[::-1]]] = nan_pos[::-1]
                hitr = first >= 0
                out[hitr] = c[first[hitr]]
            return out
        if axis is None:
            if len(nan_pos):
                p = int(nan_pos[0])
                return int(r[p] * self._cols + c[p])
            i = (
                int(np.argmax(best_v)) if want_max else int(np.argmin(best_v))
            )
            return int(i * self._cols + best_c[i])
        if axis in (0, -2):
            # reduce the transpose's rows (same semantics, columns swapped)
            return self.transpose()._arg_reduce(1, ufunc)
        raise ValueError(f"axis must be None, 0, or 1, got {axis}")

    def argmax(self, axis=None, out=None):
        """Index of the maximum including implicit zeros: linear row-major
        index for ``axis=None``, per-row/column int64 arrays otherwise."""
        return self._arg_reduce(axis, np.maximum)

    def argmin(self, axis=None, out=None):
        return self._arg_reduce(axis, np.minimum)

    # -- diagonal / misc ---------------------------------------------------------

    def setdiag(self, values, k: int = 0) -> None:
        """Set diagonal ``k`` in place (scipy semantics: a short array sets
        only its length; new entries are inserted, set zeros stay explicit
        per the cancellation-zero policy)."""
        ndiag = max(0, min(self._rows + min(k, 0), self._cols - max(k, 0)))
        varr = np.asarray(values)
        if varr.ndim == 0:
            n = ndiag
            dvals = np.full(n, varr[()])
        else:
            n = min(ndiag, len(varr))
            dvals = varr[:n]
        row0 = max(0, -k)
        dr = np.arange(n, dtype=np.int64) + row0
        dc = dr + k
        r = self.row_ids()
        c = self.indices.astype(np.int64)
        keep = ~((c - r == k) & (r >= row0) & (r < row0 + n))
        dt = np.result_type(self.vals.dtype, dvals.dtype)
        self._adopt(CsrMatrix.from_coo(
            self._rows, self._cols,
            np.concatenate([r[keep], dr]),
            np.concatenate([c[keep], dc]),
            np.concatenate([self.vals[keep].astype(dt), dvals.astype(dt)]),
            sum_duplicates=False,
        ))

    def trace(self, offset: int = 0):
        return self.diagonal(offset).sum()

    # -- format conversions --------------------------------------------------

    def tocoo(self, copy: bool = False) -> "CsrMatrix":
        """CSR is the canonical row-major storage; the coo/csc/lil/bsr
        "conversions" return CSR objects (the compat namespace's
        constructors for those formats build CSR too)."""
        return self.copy() if copy else self

    def tocsc(self, copy: bool = False) -> "CsrMatrix":
        return self.copy() if copy else self

    def tolil(self, copy: bool = False) -> "CsrMatrix":
        return self.copy() if copy else self

    def tobsr(self, blocksize=None, copy: bool = False) -> "CsrMatrix":
        return self.copy() if copy else self

    def todok(self, copy: bool = False) -> "DokMatrix":
        return self.to_dok()

    def todia(self, copy: bool = False):
        """A real :class:`~.dia.DiaMatrix` (dense band planes). Guarded
        against scattered patterns whose band count would explode memory —
        the same hazard scipy's todia warns about."""
        from .dia import DiaMatrix

        r = self.row_ids()
        c = self.indices.astype(np.int64)
        offs = np.unique(c - r) if self.nnz() else np.array([0], np.int64)
        if len(offs) * self._rows > (1 << 26):
            raise ValueError(
                f"todia would allocate {len(offs)} bands x {self._rows} rows; "
                "the pattern is too scattered for DIA"
            )
        data = np.zeros((len(offs), self._rows), dtype=self.vals.dtype)
        b = np.searchsorted(offs, c - r)
        data[b, r] = self.vals
        return DiaMatrix(self._rows, self._cols, data, tuple(int(o) for o in offs))

    def asformat(self, format, copy: bool = False):
        """Convert to ``format`` by name (scipy's asformat dispatch)."""
        if format is None or format == "csr":
            return self.copy() if copy else self
        conv = {
            "coo": self.tocoo, "csc": self.tocsc, "lil": self.tolil,
            "bsr": self.tobsr, "dok": self.todok, "dia": self.todia,
            "array": self.toarray, "dense": self.todense,
        }.get(format)
        if conv is None:
            raise ValueError(f"unknown format {format!r}")
        try:
            return conv(copy=copy)
        except TypeError:
            return conv()


def _attach_elementwise_ufuncs():
    """scipy's zero-preserving elementwise methods (sin, sqrt, expm1, ...):
    one stored-entry ufunc application each, pattern preserved. Generated
    in a loop — eighteen hand-written clones would say nothing more."""
    for f in (
        np.sin, np.tan, np.arcsin, np.arctan, np.sinh, np.tanh,
        np.arcsinh, np.arctanh, np.ceil, np.floor, np.rint, np.trunc,
        np.sqrt, np.sign, np.expm1, np.log1p, np.deg2rad, np.rad2deg,
    ):
        def method(self, *, _f=f):
            return CsrMatrix(
                self._rows, self._cols, _f(self.vals), self.indices.copy(),
                self.offsets.copy(), is_sorted=self.is_sorted,
            )

        method.__name__ = f.__name__
        method.__doc__ = (
            f"Elementwise {f.__name__} over stored entries "
            "(zero-preserving, pattern unchanged; scipy.sparse parity)."
        )
        setattr(CsrMatrix, f.__name__, method)


_attach_elementwise_ufuncs()


def _segsum_exact(seg: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Segment sum preserving dtype (wrapping ints wrap; floats sum in order)."""
    nseg = int(seg[-1]) + 1 if len(seg) else 0
    out = np.zeros(nseg, dtype=v.dtype)
    np.add.at(out, seg, v)
    return out

"""ctypes loader for the C++ native runtime, with graceful degradation.

On first use the shared library is built if missing (and the toolchain is
present); any failure downgrades to the pure-Python/numpy host paths.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

__all__ = [
    "load_library",
    "native_available",
    "native_spgemm_available",
    "spgemm_hash_native",
    "flops_per_row_native",
    "parse_entries_native",
    "aggregate_pass_native",
    "ilu0_native",
    "ilut_native",
    "trisolve_native",
    "amg_strength_native",
    "scale_rows_native",
    "csr_transpose_native",
    "offset_hist_native",
    "blockwise_argsort_native",
    "jacobi_smoother_native",
    "aligned_sort_native",
    "aligned_fill_native",
    "lanepack_sort_native",
    "lanepack_fill_native",
    "dia_fill_native",
    "colmap_spgemm_native",
    "colmap_smoothed_native",
    "chol_native",
    "ldl_native",
    "lu_native",
    "colsplit_native",
    "connected_components_native",
    "dijkstra_native",
    "traversal_order_native",
    "kruskal_native",
    "hopcroft_karp_native",
    "maxflow_native",
]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_U32P = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("SPMX_NO_NATIVE", "0") not in ("", "0"):
        return None
    try:
        from .build import build

        lib = ctypes.CDLL(build())
        if lib.spmx_abi_version() != 1:
            return None
        _declare(lib)
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def _declare(lib: ctypes.CDLL) -> None:
    c_i64, c_int = ctypes.c_int64, ctypes.c_int
    lib.spmx_abi_version.restype = c_int
    lib.spmx_hardware_threads.restype = c_int
    lib.spmx_flops_per_row.argtypes = [c_i64, _I64P, _U32P, _I64P, _I64P]
    lib.spmx_partition_rows.argtypes = [c_i64, _I64P, c_i64, _I64P]
    lib.spmx_spgemm_symbolic.argtypes = [
        c_i64, _I64P, _U32P, _I64P, _U32P, _I64P, c_i64, c_int, _I64P,
    ]
    lib.spmx_debug_set.argtypes = [c_int]
    lib.spmx_debug_clear.argtypes = []
    lib.spmx_debug_probe_hist.argtypes = [_I64P, _I64P]
    lib.spmx_blocks_count_nnz.restype = c_i64
    lib.spmx_blocks_count_nnz.argtypes = [_F32P, c_i64, c_i64]
    lib.spmx_blocks_to_coo.restype = c_i64
    lib.spmx_blocks_to_coo.argtypes = [
        _F32P, c_i64, c_i64, _I64P, _U32P, c_i64, c_i64, _I64P, _I64P, _F32P,
    ]
    for name, vp in [("spmx_ilu0_f64", _F64P), ("spmx_ilu0_f32", _F32P)]:
        getattr(lib, name).restype = c_i64
        getattr(lib, name).argtypes = [c_i64, c_i64, _I64P, _U32P, vp, _I64P]
    for name, vp in [("spmx_ilut_f64", _F64P), ("spmx_ilut_f32", _F32P)]:
        getattr(lib, name).restype = c_i64
        getattr(lib, name).argtypes = [
            c_i64, c_i64, _I64P, _U32P, vp, ctypes.c_double, c_i64,
            _I64P, _U32P, vp, _I64P, _U32P, vp,
        ]
    for name, vp in [("spmx_trisolve_f64", _F64P), ("spmx_trisolve_f32", _F32P)]:
        getattr(lib, name).restype = c_i64
        getattr(lib, name).argtypes = [c_i64, _I64P, _U32P, vp, _I64P, vp, c_int, c_int]
    lib.spmx_fixedside_plan.restype = c_i64
    lib.spmx_fixedside_plan.argtypes = [
        c_i64, _I64P, _U32P, _F32P, _I64P, _U32P, _F32P, c_int,
        _U32P, _F32P, _I32P, _I32P, _I64P,
    ]
    lib.spmx_aggregate_pass1.restype = c_i64
    lib.spmx_aggregate_pass1.argtypes = [c_i64, _I64P, _I64P, _I64P]
    lib.spmx_aggregate_pass2.restype = c_i64
    lib.spmx_aggregate_pass2.argtypes = [c_i64, _I64P, _I64P, _I64P]
    lib.spmx_aggregate_pass3.restype = c_i64
    lib.spmx_aggregate_pass3.argtypes = [c_i64, _I64P, _I64P, c_i64, _I64P]
    lib.spmx_parse_entries.restype = c_i64
    lib.spmx_parse_entries.argtypes = [
        ctypes.c_char_p, c_i64, c_i64, _I64P, _I64P, _F64P, ctypes.c_int, ctypes.c_void_p,
    ]
    for name, vp in [
        ("spmx_spgemm_numeric_f64", _F64P),
        ("spmx_spgemm_numeric_f32", _F32P),
        ("spmx_spgemm_numeric_i64", _I64P),
    ]:
        getattr(lib, name).argtypes = [
            c_i64, _I64P, _U32P, vp, _I64P, _U32P, vp, _I64P, _I64P, _I64P,
            c_i64, c_int, c_int, _U32P, vp,
        ]
    for name, vp in [
        ("spmx_amg_diag_abssum_f64", _F64P),
        ("spmx_amg_diag_abssum_f32", _F32P),
    ]:
        getattr(lib, name).argtypes = [c_i64, _I64P, _U32P, vp, _F64P, _F64P, _F64P]
    for name, vp in [
        ("spmx_strength_count_f64", _F64P),
        ("spmx_strength_count_f32", _F32P),
    ]:
        getattr(lib, name).argtypes = [
            c_i64, _I64P, _U32P, vp, ctypes.c_double, _F64P, _I64P,
        ]
    for name, vp in [
        ("spmx_strength_fill_f64", _F64P),
        ("spmx_strength_fill_f32", _F32P),
    ]:
        getattr(lib, name).argtypes = [
            c_i64, _I64P, _U32P, vp, ctypes.c_double, _F64P, _I64P, _I64P,
        ]
    for name, vp in [("spmx_scale_rows_f64", _F64P), ("spmx_scale_rows_f32", _F32P)]:
        getattr(lib, name).argtypes = [c_i64, _I64P, vp, _F64P, vp]
    for name, vp in [
        ("spmx_csr_transpose_f64", _F64P),
        ("spmx_csr_transpose_f32", _F32P),
    ]:
        getattr(lib, name).argtypes = [
            c_i64, c_i64, _I64P, _U32P, vp, _I64P, _U32P, vp,
        ]
    lib.spmx_offset_hist.restype = c_i64
    lib.spmx_offset_hist.argtypes = [c_i64, _I64P, _U32P, c_i64, _I64P, _I64P]
    for name, vp in [
        ("spmx_jacobi_smoother_f64", _F64P),
        ("spmx_jacobi_smoother_f32", _F32P),
    ]:
        getattr(lib, name).restype = c_i64
        getattr(lib, name).argtypes = [c_i64, _I64P, _U32P, vp, _F64P, vp]
    _U64P = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
    lib.spmx_blockwise_argsort_u64.argtypes = [c_i64, _I64P, _U64P, _I64P]
    lib.spmx_aligned_sort.restype = c_i64
    lib.spmx_aligned_sort.argtypes = [c_i64, c_i64, _I64P, _U32P, _I64P, _U64P]
    _I8P = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
    lib.spmx_stripe_count.restype = c_i64
    lib.spmx_stripe_count.argtypes = [
        c_i64, c_i64, c_i64, _I64P, _U32P, c_i64, c_i64, c_int, _I64P,
    ]
    lib.spmx_stripe_fill.restype = c_i64
    lib.spmx_stripe_fill.argtypes = [
        _F32P, _F32P, ctypes.c_void_p, c_int, _I8P, _I8P, _I32P, _I32P,
        _I32P, _U8P, _I64P,
    ]
    for name, vin, vout in [
        ("spmx_aligned_fill_f32f32", _F32P, _F32P),
        ("spmx_aligned_fill_f64f32", _F64P, _F32P),
        ("spmx_aligned_fill_f64f64", _F64P, _F64P),
    ]:
        getattr(lib, name).argtypes = [
            c_i64, _I64P, _I64P, _I64P, _I64P, _I64P, _U32P, vin, vout, _I8P,
        ]
    for name, vp in [("spmx_dia_fill_f32", _F32P), ("spmx_dia_fill_f64", _F64P)]:
        getattr(lib, name).argtypes = [c_i64, _I64P, _U32P, vp, c_i64, _I64P, vp]
    for name, vp in [("spmx_colsplit_f32", _F32P), ("spmx_colsplit_f64", _F64P)]:
        getattr(lib, name).argtypes = [
            c_i64, c_i64, _I64P, _I64P, _U32P, vp, _I64P, _U32P, vp,
        ]
    for name, vp in [
        ("spmx_colmap_spgemm_f32", _F32P),
        ("spmx_colmap_spgemm_f64", _F64P),
    ]:
        getattr(lib, name).restype = c_i64
        getattr(lib, name).argtypes = [
            c_i64, _I64P, _U32P, vp, _U32P, vp, _I64P, _U32P, vp,
        ]
    for name, vp in [
        ("spmx_colmap_smoothed_f32", _F32P),
        ("spmx_colmap_smoothed_f64", _F64P),
    ]:
        getattr(lib, name).restype = c_i64
        getattr(lib, name).argtypes = [
            c_i64, _I64P, _U32P, vp, _F64P, _U32P, vp, _I64P, _U32P, vp,
        ]
    lib.spmx_etree.argtypes = [c_i64, _I64P, _U32P, _I64P]
    lib.spmx_chol_symbolic.restype = c_i64
    lib.spmx_chol_symbolic.argtypes = [c_i64, _I64P, _U32P, _I64P, _I64P]
    lib.spmx_chol_numeric.restype = c_i64
    lib.spmx_chol_numeric.argtypes = [c_i64, _I64P, _U32P, _F64P, _I64P, _I64P, _I64P, _F64P]
    lib.spmx_ldl_numeric.restype = c_i64
    lib.spmx_ldl_numeric.argtypes = [c_i64, _I64P, _U32P, _F64P, _I64P, _I64P, _I64P, _F64P, _F64P]
    lib.spmx_lu.restype = c_i64
    lib.spmx_lu.argtypes = [
        c_i64, _I64P, _I64P, _F64P, c_i64, c_i64,
        _I64P, _I64P, _F64P, _I64P, _I64P, _F64P, _I64P, _I64P,
    ]
    lib.spmx_spgemm_symbolic_spa.argtypes = [
        c_i64, c_i64, _I64P, _U32P, _I64P, _U32P, _I64P, c_i64, c_int, _I64P,
    ]
    for name, vp in [
        ("spmx_spgemm_numeric_spa_f64", _F64P),
        ("spmx_spgemm_numeric_spa_f32", _F32P),
        ("spmx_spgemm_numeric_spa_i64", _I64P),
    ]:
        getattr(lib, name).argtypes = [
            c_i64, c_i64, _I64P, _U32P, vp, _I64P, _U32P, vp, _I64P, _I64P,
            _I64P, c_i64, c_int, c_int, _U32P, vp,
        ]
    lib.spmx_lanepack_sort.restype = c_i64
    lib.spmx_lanepack_sort.argtypes = [c_i64, c_i64, c_i64, _I64P, _U32P, _I64P, _U64P]
    _I16P = np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS")
    for name, vin, vout in [
        ("spmx_lanepack_fill_f32f32", _F32P, _F32P),
        ("spmx_lanepack_fill_f64f32", _F64P, _F32P),
        ("spmx_lanepack_fill_f64f64", _F64P, _F64P),
    ]:
        getattr(lib, name).argtypes = [
            c_i64, _I64P, _I64P, _I64P, _I64P, _I64P, _U32P, vin, c_i64,
            vout, _I16P, _I8P, _I8P,
        ]
    # graph algorithms (sparse_matrix_tpu/graph/)
    lib.spmx_connected_components.restype = c_i64
    lib.spmx_connected_components.argtypes = [c_i64, _I64P, _U32P, _I64P]
    lib.spmx_scc.restype = c_i64
    lib.spmx_scc.argtypes = [c_i64, _I64P, _U32P, _I64P]
    lib.spmx_dijkstra.restype = None
    lib.spmx_dijkstra.argtypes = [c_i64, _I64P, _U32P, _F64P, c_i64, _F64P, _I64P]
    lib.spmx_bfs_order.restype = c_i64
    lib.spmx_bfs_order.argtypes = [c_i64, _I64P, _U32P, c_i64, _I64P, _I64P]
    lib.spmx_dfs_order.restype = c_i64
    lib.spmx_dfs_order.argtypes = [c_i64, _I64P, _U32P, c_i64, _I64P, _I64P]
    lib.spmx_kruskal.restype = c_i64
    lib.spmx_kruskal.argtypes = [c_i64, c_i64, _I64P, _I64P, _I64P, _I64P]
    lib.spmx_hopcroft_karp.restype = c_i64
    lib.spmx_hopcroft_karp.argtypes = [c_i64, c_i64, _I64P, _U32P, _I64P, _I64P]
    lib.spmx_maxflow.restype = c_i64
    lib.spmx_maxflow.argtypes = [c_i64, c_i64, _I64P, _I64P, _I64P, c_i64, c_i64, _I64P]


def native_available() -> bool:
    return load_library() is not None


def native_spgemm_available() -> bool:
    return native_available()


_NUMERIC_BY_DTYPE = {
    np.dtype(np.float64): "spmx_spgemm_numeric_f64",
    np.dtype(np.float32): "spmx_spgemm_numeric_f32",
    np.dtype(np.int64): "spmx_spgemm_numeric_i64",
}

_NUMERIC_SPA_BY_DTYPE = {
    np.dtype(np.float64): "spmx_spgemm_numeric_spa_f64",
    np.dtype(np.float32): "spmx_spgemm_numeric_spa_f32",
    np.dtype(np.int64): "spmx_spgemm_numeric_spa_i64",
}

# per-chunk SPA arrays are cols x (4B mark + value); 4M cols keeps a f64
# chunk under 50 MB on this box
_SPA_COLS_LIMIT = 4_194_304


def flops_per_row_native(lhs, rhs) -> np.ndarray:
    lib = load_library()
    out = np.zeros(lhs.rows, dtype=np.int64)
    lib.spmx_flops_per_row(
        lhs.rows,
        np.ascontiguousarray(lhs.offsets, dtype=np.int64),
        np.ascontiguousarray(lhs.indices, dtype=np.uint32),
        np.ascontiguousarray(rhs.offsets, dtype=np.int64),
        out,
    )
    return out


def colmap_spgemm_native(lhs, rhs):
    """``lhs @ rhs`` when rhs has AT MOST ONE entry per row: hash-free
    column relabel + per-row merge (the AMG tentative-prolongator product;
    degenerate case of mul_hash, /root/reference/spam_csr/src/mul_hash.rs).
    Returns a sorted CsrMatrix, or None when unavailable/ineligible —
    callers fall through to the hash engine."""
    from ..formats.csr import CsrMatrix, INDEX_DTYPE, OFFSET_DTYPE

    lib = load_library()
    dtype = np.result_type(lhs.vals.dtype, rhs.vals.dtype)
    sfx = {np.dtype(np.float64): "f64", np.dtype(np.float32): "f32"}.get(
        np.dtype(dtype)
    )
    if lib is None or sfx is None:
        return None
    ro = np.asarray(rhs.offsets)
    row_len = np.diff(ro)
    if row_len.max(initial=0) > 1:
        return None
    tmap = np.full(rhs.rows, 0xFFFFFFFF, dtype=np.uint32)
    tval = np.zeros(rhs.rows, dtype=dtype)
    has = row_len == 1
    src = ro[:-1][has]
    tmap[has] = rhs.indices[src]
    tval[has] = rhs.vals[src]
    nnz_ub = max(1, int(lhs.offsets[-1]))
    out_offsets = np.zeros(lhs.rows + 1, dtype=OFFSET_DTYPE)
    out_indices = np.empty(nnz_ub, dtype=INDEX_DTYPE)
    out_vals = np.empty(nnz_ub, dtype=dtype)
    w = getattr(lib, f"spmx_colmap_spgemm_{sfx}")(
        lhs.rows,
        np.ascontiguousarray(lhs.offsets, dtype=np.int64),
        np.ascontiguousarray(lhs.indices, dtype=np.uint32),
        np.ascontiguousarray(lhs.vals, dtype=dtype),
        tmap, tval, out_offsets, out_indices, out_vals,
    )
    return CsrMatrix(
        lhs.rows, rhs.cols, out_vals[:w], out_indices[:w], out_offsets,
        is_sorted=True,
    )


def chol_native(n, offsets, indices, vals):
    """Sparse up-looking Cholesky (native). Input: full symmetric sorted
    CSR. Returns ``(lp, li, lx)`` — the CSR of ``U = L^T`` (f64, diagonal
    first per row, sorted) — or None when the library is unavailable.
    Raises ValueError on a non-SPD pivot."""
    lib = load_library()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    parent = np.empty(n, dtype=np.int64)
    lib.spmx_etree(n, offsets, indices, parent)
    colcount = np.empty(n, dtype=np.int64)
    nnz_l = int(lib.spmx_chol_symbolic(n, offsets, indices, parent, colcount))
    lp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(colcount, out=lp[1:])
    li = np.empty(max(1, nnz_l), dtype=np.int64)
    lx = np.empty(max(1, nnz_l), dtype=np.float64)
    rc = int(lib.spmx_chol_numeric(n, offsets, indices, vals, parent, lp, li, lx))
    if rc >= 0:
        raise ValueError(f"chol: non-positive pivot in column {rc} (input not SPD?)")
    return lp, li, lx


def ldl_native(n, offsets, indices, vals):
    """Sparse LDL^T (Davis's algorithm; native). Input: full symmetric
    sorted CSR. Returns ``(lp, li, lx, d)`` — STRICT L by columns (= CSR
    of strict L^T, unit diagonal implied) plus the diagonal ``d`` — or
    None when the library is unavailable. Raises on a zero pivot."""
    lib = load_library()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    parent = np.empty(n, dtype=np.int64)
    lib.spmx_etree(n, offsets, indices, parent)
    colcount = np.empty(n, dtype=np.int64)
    lib.spmx_chol_symbolic(n, offsets, indices, parent, colcount)
    colcount -= 1  # strict part only (no stored unit diagonal)
    lp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(colcount, out=lp[1:])
    nnz_l = int(lp[-1])
    li = np.empty(max(1, nnz_l), dtype=np.int64)
    lx = np.empty(max(1, nnz_l), dtype=np.float64)
    d = np.empty(n, dtype=np.float64)
    rc = int(lib.spmx_ldl_numeric(n, offsets, indices, vals, parent, lp, li, lx, d))
    if rc >= 0:
        raise ValueError(f"ldl: zero pivot in column {rc}")
    return lp, li, lx, d


def lu_native(n, bp, bi, bx):
    """Sparse LU with partial pivoting (Gilbert-Peierls; native). Input:
    the matrix by COLUMNS (CSC arrays). Returns ``(lp, li, lx, up, ui,
    ux, pinv)`` — L (unit diagonal stored, row indices in pivot
    positions) and U by columns — or None when the library is
    unavailable. Raises ValueError on a singular column."""
    lib = load_library()
    if lib is None:
        return None
    bp = np.ascontiguousarray(bp, dtype=np.int64)
    bi = np.ascontiguousarray(bi, dtype=np.int64)
    bx = np.ascontiguousarray(bx, dtype=np.float64)
    nnz = int(bp[-1])
    cap = max(16, 8 * nnz)
    while True:
        lp = np.empty(n + 1, dtype=np.int64)
        li = np.empty(cap, dtype=np.int64)
        lx = np.empty(cap, dtype=np.float64)
        up = np.empty(n + 1, dtype=np.int64)
        ui = np.empty(cap, dtype=np.int64)
        ux = np.empty(cap, dtype=np.float64)
        pinv = np.empty(n, dtype=np.int64)
        sizes = np.zeros(2, dtype=np.int64)
        rc = int(lib.spmx_lu(n, bp, bi, bx, cap, cap, lp, li, lx, up, ui, ux,
                             pinv, sizes))
        if rc == -2:
            cap *= 4
            continue
        if rc <= -3:
            raise ValueError(f"lu: singular at column {-(rc + 3)}")
        lnz, unz = int(sizes[0]), int(sizes[1])
        return lp, li[:lnz], lx[:lnz], up, ui[:unz], ux[:unz], pinv


def colmap_smoothed_native(a, ws, rhs):
    """Fused prolongator smoothing ``(I - diag(ws) @ a) @ rhs`` when rhs
    has AT MOST ONE entry per row (the AMG tentative prolongator): one
    pass over ``a``, per-term rounding identical to materializing the
    smoother matrix and running :func:`colmap_spgemm_native` (parity test
    in tests/test_amg.py). Returns a sorted CsrMatrix or None when
    unavailable/ineligible."""
    from ..formats.csr import CsrMatrix, INDEX_DTYPE, OFFSET_DTYPE

    lib = load_library()
    dtype = np.result_type(a.vals.dtype, rhs.vals.dtype)
    sfx = {np.dtype(np.float64): "f64", np.dtype(np.float32): "f32"}.get(
        np.dtype(dtype)
    )
    if lib is None or sfx is None or a.rows != a.cols or a.cols != rhs.rows:
        return None
    ro = np.asarray(rhs.offsets)
    row_len = np.diff(ro)
    if row_len.max(initial=0) > 1:
        return None
    tmap = np.full(rhs.rows, 0xFFFFFFFF, dtype=np.uint32)
    tval = np.zeros(rhs.rows, dtype=dtype)
    has = row_len == 1
    src = ro[:-1][has]
    tmap[has] = rhs.indices[src]
    tval[has] = rhs.vals[src]
    # +rows upper bound: rows of A without an explicit diagonal inject the
    # identity's T entry as an extra term
    nnz_ub = max(1, int(a.offsets[-1]) + a.rows)
    out_offsets = np.zeros(a.rows + 1, dtype=OFFSET_DTYPE)
    out_indices = np.empty(nnz_ub, dtype=INDEX_DTYPE)
    out_vals = np.empty(nnz_ub, dtype=dtype)
    w = getattr(lib, f"spmx_colmap_smoothed_{sfx}")(
        a.rows,
        np.ascontiguousarray(a.offsets, dtype=np.int64),
        np.ascontiguousarray(a.indices, dtype=np.uint32),
        np.ascontiguousarray(a.vals, dtype=dtype),
        np.ascontiguousarray(ws, dtype=np.float64),
        tmap, tval, out_offsets, out_indices, out_vals,
    )
    return CsrMatrix(
        a.rows, rhs.cols, out_vals[:w], out_indices[:w], out_offsets,
        is_sorted=True,
    )


def _native_debug_begin(lib):
    """Arm the native probe-length recorder when SPMX_DEBUG is on.

    This instruments the engine that actually runs in production — the
    reference's `debug` feature records probe histograms from inside
    mul_hash (spam_csr/src/mul_hash.rs:98-99,188-189; linprobe/src/map.rs:
    17-18), not from a fallback path. Returns True when armed."""
    from ..utils.debugflags import debug_enabled

    if not debug_enabled():
        return False
    lib.spmx_debug_clear()
    lib.spmx_debug_set(1)
    return True


def _native_debug_end(lib, row_nz):
    """Read back + disarm; surface through utils.debugflags histograms."""
    from ..utils.debugflags import record_histogram

    sym = np.zeros(64, dtype=np.int64)
    num = np.zeros(64, dtype=np.int64)
    lib.spmx_debug_probe_hist(sym, num)
    lib.spmx_debug_set(0)
    record_histogram(
        "native_probe_symbolic",
        {int(i): int(c) for i, c in enumerate(sym) if c},
    )
    record_histogram(
        "native_probe_numeric",
        {int(i): int(c) for i, c in enumerate(num) if c},
    )
    # per-phase row_nz dump analog (mul_hash.rs:18-25): output row-length
    # histogram of the run that just completed
    lens, counts = np.unique(row_nz, return_counts=True)
    record_histogram(
        "native_row_nz", {int(k): int(v) for k, v in zip(lens, counts)}
    )


def spgemm_hash_native(lhs, rhs, *, output_sorted: bool = False, num_threads: int = 0):
    """Two-phase threaded hash SpGEMM via the C++ runtime (mul_hash analog)."""
    from ..formats.csr import CsrMatrix, INDEX_DTYPE, OFFSET_DTYPE

    lib = load_library()
    rows = lhs.rows
    lo = np.ascontiguousarray(lhs.offsets, dtype=np.int64)
    li = np.ascontiguousarray(lhs.indices, dtype=np.uint32)
    ro = np.ascontiguousarray(rhs.offsets, dtype=np.int64)
    ri = np.ascontiguousarray(rhs.indices, dtype=np.uint32)
    dtype = np.result_type(lhs.vals.dtype, rhs.vals.dtype)
    lv = np.ascontiguousarray(lhs.vals, dtype=dtype)
    rv = np.ascontiguousarray(rhs.vals, dtype=dtype)

    # phase 1: FLOP upper bounds + balanced row chunks
    row_nz = np.zeros(rows, dtype=np.int64)
    lib.spmx_flops_per_row(rows, lo, li, ro, row_nz)
    num_parts = max(1, min(rows, lib.spmx_hardware_threads() * 4))
    rows_offset = np.zeros(num_parts + 1, dtype=np.int64)
    lib.spmx_partition_rows(rows, row_nz, num_parts, rows_offset)

    # SPA gate: a dense epoch-marked accumulator over the output column
    # space beats the probe chains (~2-3x at AMG Galerkin shapes) when the
    # per-chunk arrays stay small and the O(cols) setup amortizes over the
    # FLOPs
    flops_total = int(row_nz.sum())
    use_spa = rhs.cols <= _SPA_COLS_LIMIT and flops_total >= rhs.cols // 4

    debug_armed = False if use_spa else _native_debug_begin(lib)

    # phase 2: symbolic -> exact row nnz
    if use_spa:
        lib.spmx_spgemm_symbolic_spa(
            rows, rhs.cols, lo, li, ro, ri, rows_offset, num_parts,
            num_threads, row_nz,
        )
    else:
        lib.spmx_spgemm_symbolic(
            rows, lo, li, ro, ri, rows_offset, num_parts, num_threads, row_nz
        )

    # phase 3: exact allocation + numeric
    offsets = np.zeros(rows + 1, dtype=OFFSET_DTYPE)
    np.cumsum(row_nz, out=offsets[1:])
    nnz = int(offsets[-1])
    out_indices = np.zeros(nnz, dtype=INDEX_DTYPE)
    out_vals = np.zeros(nnz, dtype=dtype)
    if use_spa:
        getattr(lib, _NUMERIC_SPA_BY_DTYPE[dtype])(
            rows, rhs.cols, lo, li, lv, ro, ri, rv, offsets, row_nz,
            rows_offset, num_parts, num_threads,
            1 if output_sorted else 0, out_indices, out_vals,
        )
    else:
        getattr(lib, _NUMERIC_BY_DTYPE[dtype])(
            rows, lo, li, lv, ro, ri, rv, offsets, row_nz, rows_offset,
            num_parts, num_threads, 1 if output_sorted else 0,
            out_indices, out_vals,
        )
    if debug_armed:
        _native_debug_end(lib, row_nz)
    return CsrMatrix(
        lhs.rows, rhs.cols, out_vals, out_indices, offsets, is_sorted=output_sorted
    )


_ILU_BY_DTYPE = {
    np.dtype(np.float64): "spmx_ilu0_f64",
    np.dtype(np.float32): "spmx_ilu0_f32",
}
_TRI_BY_DTYPE = {
    np.dtype(np.float64): "spmx_trisolve_f64",
    np.dtype(np.float32): "spmx_trisolve_f32",
}


def ilu0_native(rows, cols, offsets, indices, vals, diag_pos):
    """In-place ILU(0) on the CSR value array (solvers/ilu.py). Returns the
    first zero-pivot row, -1 on success, or None when unavailable."""
    lib = load_library()
    name = _ILU_BY_DTYPE.get(vals.dtype)
    if lib is None or name is None:
        return None
    assert vals.flags["C_CONTIGUOUS"]
    return int(
        getattr(lib, name)(
            rows, cols,
            np.ascontiguousarray(offsets, dtype=np.int64),
            np.ascontiguousarray(indices, dtype=np.uint32),
            vals,
            np.ascontiguousarray(diag_pos, dtype=np.int64),
        )
    )


_ILUT_BY_DTYPE = {
    np.dtype(np.float64): "spmx_ilut_f64",
    np.dtype(np.float32): "spmx_ilut_f32",
}


def ilut_native(rows, cols, offsets, indices, vals, *, tau: float, p: int):
    """ILUT(p, tau) via the native runtime. Returns
    ``(l_cnt, l_idx, l_val, u_cnt, u_idx, u_val)`` fixed-cap row arrays
    (caps p and p+1; U rows start with the diagonal), or None when the
    library/dtype is unavailable. Raises ValueError on a zero pivot."""
    lib = load_library()
    name = _ILUT_BY_DTYPE.get(vals.dtype)
    if lib is None or name is None:
        return None
    l_cnt = np.zeros(rows, dtype=np.int64)
    l_idx = np.zeros(rows * p, dtype=np.uint32)
    l_val = np.zeros(rows * p, dtype=vals.dtype)
    u_cnt = np.zeros(rows, dtype=np.int64)
    u_idx = np.zeros(rows * (p + 1), dtype=np.uint32)
    u_val = np.zeros(rows * (p + 1), dtype=vals.dtype)
    rc = int(
        getattr(lib, name)(
            rows, cols,
            np.ascontiguousarray(offsets, dtype=np.int64),
            np.ascontiguousarray(indices, dtype=np.uint32),
            np.ascontiguousarray(vals),
            float(tau), int(p),
            l_cnt, l_idx, l_val, u_cnt, u_idx, u_val,
        )
    )
    if rc >= 0:
        raise ValueError(f"ilut: zero pivot in row {rc}")
    return l_cnt, l_idx, l_val, u_cnt, u_idx, u_val


def trisolve_native(rows, offsets, indices, vals, diag_pos, x, *, lower, unit):
    """In-place exact CSR triangular solve (x holds b on entry). Returns
    the zero-pivot row, -1 on success, or None when unavailable."""
    lib = load_library()
    name = _TRI_BY_DTYPE.get(vals.dtype)
    if lib is None or name is None or x.dtype != vals.dtype:
        return None
    assert x.flags["C_CONTIGUOUS"]
    return int(
        getattr(lib, name)(
            rows,
            np.ascontiguousarray(offsets, dtype=np.int64),
            np.ascontiguousarray(indices, dtype=np.uint32),
            np.ascontiguousarray(vals),
            np.ascontiguousarray(diag_pos, dtype=np.int64),
            x, 1 if lower else 0, 1 if unit else 0,
        )
    )


def aggregate_pass_native(which: int, so, si, agg, na: int = 0):
    """Run greedy-aggregation pass 1, 2, or 3 (solvers/amg.py) in the
    native runtime; mutates ``agg`` in place and returns the new aggregate
    count (pass 1/3) or the number attached (pass 2), or None when the
    library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    so = np.ascontiguousarray(so, dtype=np.int64)
    si = np.ascontiguousarray(si, dtype=np.int64)
    assert agg.dtype == np.int64 and agg.flags["C_CONTIGUOUS"]
    if which == 1:
        return int(lib.spmx_aggregate_pass1(len(agg), so, si, agg))
    if which == 2:
        return int(lib.spmx_aggregate_pass2(len(agg), so, si, agg))
    return int(lib.spmx_aggregate_pass3(len(agg), so, si, na, agg))


def parse_entries_native(text: str, expect: int, n_value_cols: int):
    """Bulk-parse MatrixMarket entry lines; returns (rows, cols, vals,
    vals_imag|None, count) or None when the native library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    buf = text.encode()
    rows = np.zeros(max(1, expect), dtype=np.int64)
    cols = np.zeros(max(1, expect), dtype=np.int64)
    vals = np.zeros(max(1, expect), dtype=np.float64)
    vi = np.zeros(max(1, expect), dtype=np.float64) if n_value_cols >= 2 else None
    n = lib.spmx_parse_entries(
        buf, len(buf), expect, rows, cols, vals, n_value_cols,
        vi.ctypes.data_as(ctypes.c_void_p) if vi is not None else None,
    )
    if n < 0:
        return None
    return rows[:n], cols[:n], vals[:n], (vi[:n] if vi is not None else None), int(n)


_SUFFIX_BY_DTYPE = {np.dtype(np.float64): "f64", np.dtype(np.float32): "f32"}


def amg_strength_native(rows, offsets, indices, vals, theta: float):
    """Fused AMG per-level analysis (solvers/amg.py strength_graph +
    _diag_of + _lambda_max_dinv_a operands) in three native sweeps.

    Returns ``(diag, abssum, s_offsets, s_indices)`` — signed diagonal,
    per-row absolute sums, and the strong-connection graph — or None when
    the library/dtype is unavailable. The strength test compares squares
    (|a_ij|^2 >= theta^2 |a_ii| |a_jj|), so values beyond ~1e150 fall back
    to the numpy path to avoid overflow."""
    lib = load_library()
    sfx = _SUFFIX_BY_DTYPE.get(vals.dtype)
    if lib is None or sfx is None:
        return None
    n = int(rows)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    vals = np.ascontiguousarray(vals)
    diag = np.zeros(n, dtype=np.float64)
    abssum = np.zeros(n, dtype=np.float64)
    rowmax = np.zeros(n, dtype=np.float64)
    getattr(lib, f"spmx_amg_diag_abssum_{sfx}")(
        n, offsets, indices, vals, diag, abssum, rowmax
    )
    if len(rowmax) and float(rowmax.max()) > 1e150:
        return None
    sdiag = np.abs(diag)
    missing = sdiag == 0.0
    if missing.any():
        sdiag[missing] = np.where(rowmax[missing] > 0, rowmax[missing], 1.0)
    theta2 = float(theta) * float(theta)
    counts = np.zeros(n, dtype=np.int64)
    getattr(lib, f"spmx_strength_count_{sfx}")(
        n, offsets, indices, vals, theta2, sdiag, counts
    )
    s_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=s_offsets[1:])
    s_indices = np.zeros(max(1, int(s_offsets[-1])), dtype=np.int64)
    getattr(lib, f"spmx_strength_fill_{sfx}")(
        n, offsets, indices, vals, theta2, sdiag, s_offsets, s_indices
    )
    return diag, abssum, s_offsets, s_indices[: int(s_offsets[-1])]


def scale_rows_native(rows, offsets, vals, s):
    """``out[k] = vals[k] * s[row(k)]`` in one native sweep (amg.py
    _scale_rows); returns the scaled value array or None."""
    lib = load_library()
    sfx = _SUFFIX_BY_DTYPE.get(vals.dtype)
    if lib is None or sfx is None:
        return None
    vals = np.ascontiguousarray(vals)
    out = np.empty_like(vals)
    getattr(lib, f"spmx_scale_rows_{sfx}")(
        int(rows),
        np.ascontiguousarray(offsets, dtype=np.int64),
        vals,
        np.ascontiguousarray(s, dtype=np.float64),
        out,
    )
    return out


def csr_transpose_native(rows, cols, offsets, indices, vals):
    """Counting-sort CSR transpose (formats/csr.py): returns
    ``(t_offsets, t_indices, t_vals)`` with sorted rows, or None."""
    lib = load_library()
    sfx = _SUFFIX_BY_DTYPE.get(vals.dtype)
    if lib is None or sfx is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    vals = np.ascontiguousarray(vals)
    nnz = int(offsets[-1])
    t_offsets = np.zeros(int(cols) + 1, dtype=np.int64)
    t_offsets[1:] = np.bincount(indices.astype(np.int64), minlength=int(cols))
    np.cumsum(t_offsets, out=t_offsets)
    cursor = t_offsets[:-1].copy()
    t_indices = np.zeros(max(1, nnz), dtype=np.uint32)
    t_vals = np.zeros(max(1, nnz), dtype=vals.dtype)
    getattr(lib, f"spmx_csr_transpose_{sfx}")(
        int(rows), int(cols), offsets, indices, vals, cursor, t_indices, t_vals
    )
    return t_offsets, t_indices[:nnz], t_vals[:nnz]


def jacobi_smoother_native(rows, offsets, indices, vals, ws):
    """``out = -vals * ws[row]`` with ``+1`` at diagonal entries, one sweep
    (amg.py _jacobi_smoother_matrix). Returns the new value array, None when
    unavailable, or False when some row lacks an explicit diagonal."""
    lib = load_library()
    sfx = _SUFFIX_BY_DTYPE.get(vals.dtype)
    if lib is None or sfx is None:
        return None
    vals = np.ascontiguousarray(vals)
    out = np.empty_like(vals)
    ndiag = int(
        getattr(lib, f"spmx_jacobi_smoother_{sfx}")(
            int(rows),
            np.ascontiguousarray(offsets, dtype=np.int64),
            np.ascontiguousarray(indices, dtype=np.uint32),
            vals,
            np.ascontiguousarray(ws, dtype=np.float64),
            out,
        )
    )
    if ndiag != int(rows):
        return False
    return out


def offset_hist_native(rows, offsets, indices, cap: int):
    """Single-pass histogram of element offsets ``col - row``
    (formats/dia.py band probe, ops/operator.py split_bands). Returns
    ``(offs, counts)`` sorted ascending, ``-1`` when more than ``cap``
    distinct offsets exist (early exit), or None when unavailable."""
    lib = load_library()
    if lib is None:
        return None
    out_offs = np.zeros(max(1, cap), dtype=np.int64)
    out_counts = np.zeros(max(1, cap), dtype=np.int64)
    n = int(
        lib.spmx_offset_hist(
            int(rows),
            np.ascontiguousarray(offsets, dtype=np.int64),
            np.ascontiguousarray(indices, dtype=np.uint32),
            int(cap), out_offs, out_counts,
        )
    )
    if n < 0:
        return -1
    return out_offs[:n], out_counts[:n]


def blockwise_argsort_native(starts, keys):
    """Stable argsort of u64 ``keys`` within each contiguous
    ``[starts[b], starts[b+1])`` block (formats/aligned.py planner: chunk
    keys are already grouped by 128-row block in CSR order, so the global
    sort decomposes into cache-resident per-block sorts). Returns the
    global permutation, or None when unavailable."""
    lib = load_library()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(len(keys), dtype=np.int64)
    lib.spmx_blockwise_argsort_u64(len(starts) - 1, starts, keys, out)
    return out


def aligned_sort_native(rows, cols, offsets, indices):
    """Fused chunk-key computation + blockwise chunk sort for the aligned
    planner (formats/aligned.py): returns ``(perm, ck_sorted)`` with
    ``ck = ((rb*wtot + w) << 7) | layer``, or None when unavailable or the
    matrix violates the layer<128 precondition (duplicate columns)."""
    lib = load_library()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    nnz = int(offsets[-1])
    perm = np.empty(nnz, dtype=np.int64)
    ck = np.empty(nnz, dtype=np.uint64)
    rc = int(lib.spmx_aligned_sort(int(rows), int(cols), offsets, indices, perm, ck))
    if rc != 0:
        return None
    return perm, ck


_ALIGNED_FILL = {
    (np.dtype(np.float32), np.dtype(np.float32)): "spmx_aligned_fill_f32f32",
    (np.dtype(np.float64), np.dtype(np.float32)): "spmx_aligned_fill_f64f32",
    (np.dtype(np.float64), np.dtype(np.float64)): "spmx_aligned_fill_f64f64",
}


def aligned_fill_native(chunk_cnt, chunk_slab, chunk_sub, kept_idx, row_of,
                        indices, vals, vals_s, lane_s):
    """Scatter kept entries into the aligned plan's slab arrays in one
    native pass (plan_aligned). Mutates vals_s/lane_s in place; returns
    True, or None when the library/dtype pair is unavailable."""
    lib = load_library()
    name = _ALIGNED_FILL.get((vals.dtype, vals_s.dtype))
    if lib is None or name is None:
        return None
    assert vals_s.flags["C_CONTIGUOUS"] and lane_s.flags["C_CONTIGUOUS"]
    getattr(lib, name)(
        len(chunk_cnt),
        np.ascontiguousarray(chunk_cnt, dtype=np.int64),
        np.ascontiguousarray(chunk_slab, dtype=np.int64),
        np.ascontiguousarray(chunk_sub, dtype=np.int64),
        np.ascontiguousarray(kept_idx, dtype=np.int64),
        np.ascontiguousarray(row_of, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.uint32),
        np.ascontiguousarray(vals),
        vals_s.reshape(-1), lane_s.reshape(-1),
    )
    return True


def lanepack_sort_native(rows, cols, kw, offsets, indices):
    """Fused chunk-key computation + blockwise chunk sort for the LanePack
    planner (formats/lanepack.py): returns ``(perm, ck_sorted)`` with
    ``ck = ((rb*wtot + w) << 7) | dst`` — the same (rb, w, dst) order as
    ``np.lexsort((dst, w, rb))`` — or None when unavailable."""
    lib = load_library()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    nnz = int(offsets[-1])
    perm = np.empty(nnz, dtype=np.int64)
    ck = np.empty(nnz, dtype=np.uint64)
    lib.spmx_lanepack_sort(
        int(rows), int(cols), int(kw), offsets, indices, perm, ck
    )
    return perm, ck


_LANEPACK_FILL = {
    (np.dtype(np.float32), np.dtype(np.float32)): "spmx_lanepack_fill_f32f32",
    (np.dtype(np.float64), np.dtype(np.float32)): "spmx_lanepack_fill_f64f32",
    (np.dtype(np.float64), np.dtype(np.float64)): "spmx_lanepack_fill_f64f64",
}


def lanepack_fill_native(chunk_cnt, chunk_slab, chunk_sub, perm, row_of,
                         indices, vals, kw, vals_s, lane_s, ends_s, starts_s):
    """One-pass slab fill for the LanePack planner (vals/lane slots + the
    segmented-reduce run boundaries ends/starts). Mutates the four slab
    arrays in place; returns True, or None when the library or dtype pair
    is unavailable."""
    lib = load_library()
    name = _LANEPACK_FILL.get((vals.dtype, vals_s.dtype))
    if lib is None or name is None:
        return None
    assert vals_s.flags["C_CONTIGUOUS"] and lane_s.flags["C_CONTIGUOUS"]
    assert ends_s.flags["C_CONTIGUOUS"] and starts_s.flags["C_CONTIGUOUS"]
    getattr(lib, name)(
        len(chunk_cnt),
        np.ascontiguousarray(chunk_cnt, dtype=np.int64),
        np.ascontiguousarray(chunk_slab, dtype=np.int64),
        np.ascontiguousarray(chunk_sub, dtype=np.int64),
        np.ascontiguousarray(perm, dtype=np.int64),
        np.ascontiguousarray(row_of, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.uint32),
        np.ascontiguousarray(vals),
        int(kw),
        vals_s.reshape(-1), lane_s.reshape(-1),
        ends_s.reshape(-1), starts_s.reshape(-1),
    )
    return True


def stripe_plan_native(m, levels: int, kw: int, mode: str):
    """Full stripe plan assembly (formats/stripe.py plan_stripe body):
    per-stripe key sort + chunking + slab packing + spill detection in two
    native calls (count retains state, fill emits). Returns a dict of the
    plan arrays (f32 values) or None when the library is unavailable or
    the shape is outside the native envelope (nnz >= 2^31, L/KW > 255,
    key wider than 63 bits)."""
    import ctypes as _ct

    lib = load_library()
    if lib is None or m.nnz() >= 2**31 or levels > 255 or kw > 255:
        return None
    offsets = np.ascontiguousarray(m.offsets, dtype=np.int64)
    indices = np.ascontiguousarray(m.indices, dtype=np.uint32)
    meta = np.zeros(4, dtype=np.int64)
    rc = int(lib.spmx_stripe_count(
        int(m.rows), int(m.cols), int(m.nnz()), offsets, indices,
        int(levels), int(kw), 1 if mode == "select" else 0, meta,
    ))
    if rc != 0:
        return None
    num_slabs, num_chunks, kw_g, num_spill = (int(x) for x in meta)
    lvl = int(levels)
    lane_dtype = np.int8 if kw_g == 1 else np.int16
    vals_s = np.zeros((num_slabs, 8, 128), dtype=np.float32)
    lane_s = np.zeros((num_slabs, 8, 128), dtype=lane_dtype)
    ends_s = np.zeros((num_slabs, lvl, 8, 128), dtype=np.int8)
    starts_s = (np.zeros((num_slabs, lvl, 8, 128), dtype=np.int8)
                if mode != "select" else np.zeros(0, dtype=np.int8))
    col_off = np.zeros(max(num_slabs, 1) * 8, dtype=np.int32)
    chunk_stripe = np.zeros(max(num_slabs, 1) * 8, dtype=np.int32)
    stripe_rb = np.zeros(max(num_slabs, 1), dtype=np.int32)
    h = lvl * 128
    rb_used = np.zeros(max(-(-m.rows // h) * lvl, 1), dtype=np.uint8)
    sp_idx = np.zeros(max(num_spill, 1), dtype=np.int64)
    vals32 = np.ascontiguousarray(m.vals, dtype=np.float32)
    nsp = int(lib.spmx_stripe_fill(
        vals32, vals_s.reshape(-1), _ct.c_void_p(lane_s.ctypes.data),
        0 if kw_g == 1 else 1, ends_s.reshape(-1),
        (starts_s if mode != "select" else ends_s).reshape(-1),
        col_off, chunk_stripe, stripe_rb, rb_used, sp_idx,
    ))
    if nsp != num_spill:
        raise RuntimeError(
            f"stripe native fill spill mismatch: {nsp} != {num_spill}")
    return {
        "vals": vals_s, "lane": lane_s, "ends": ends_s,
        "starts": starts_s if mode != "select" else None,
        "col_off": col_off, "chunk_stripe": chunk_stripe,
        "stripe_rb": stripe_rb, "rb_used": rb_used, "kw_g": kw_g,
        "spill_idx": sp_idx[:num_spill],
    }


def fixedside_plan_native(lhs, rhs, fixed_lhs: bool, num_products: int):
    """Fused expand + group-by-key pass for FixedSideSpgemm
    (ops/spgemm_spmv.py): per-row stable sorts by output column replace
    the global (key, sub_order) lexsort over num_products int64 keys, and
    the grouped output pattern (out_row/out_col/CSR offsets) is emitted
    in the same pass. Returns
    ``(s_idx, s_val, out_row, out_col, offsets, nnz_out)`` — out_row/
    out_col/offsets sized num_products(+1), valid through nnz_out — or
    None when the library is unavailable or a position exceeds int32."""
    lib = load_library()
    if lib is None:
        return None
    if max(lhs.nnz(), rhs.nnz()) >= 2**31:
        return None
    s_idx = np.empty(num_products, dtype=np.uint32)
    s_val = np.empty(num_products, dtype=np.float32)
    out_row = np.empty(num_products, dtype=np.int32)
    out_col = np.empty(num_products, dtype=np.int32)
    offsets = np.empty(num_products + 1, dtype=np.int64)
    nnz_out = int(lib.spmx_fixedside_plan(
        int(lhs.rows),
        np.ascontiguousarray(lhs.offsets, dtype=np.int64),
        np.ascontiguousarray(lhs.indices, dtype=np.uint32),
        np.ascontiguousarray(lhs.vals, dtype=np.float32),
        np.ascontiguousarray(rhs.offsets, dtype=np.int64),
        np.ascontiguousarray(rhs.indices, dtype=np.uint32),
        np.ascontiguousarray(rhs.vals, dtype=np.float32),
        1 if fixed_lhs else 0,
        s_idx, s_val, out_row, out_col, offsets,
    ))
    return s_idx, s_val, out_row, out_col, offsets, nnz_out


def colsplit_native(rows, bounds, offsets, indices, vals):
    """Partition a row-sorted CSR into column-range shards in two native
    passes (ops/operator.py colsplit). Returns
    ``(shard_offsets, shard_indices, shard_vals)`` — per-shard lists, with
    indices rebased to each shard's lower bound — or None."""
    lib = load_library()
    sfx = _SUFFIX_BY_DTYPE.get(vals.dtype)
    if lib is None or sfx is None:
        return None
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    nsplit = len(bounds) - 1
    nnz = int(offsets[-1])
    out_offsets = np.empty(nsplit * (int(rows) + 1), dtype=np.int64)
    out_indices = np.empty(max(1, nnz), dtype=np.uint32)
    out_vals = np.empty(max(1, nnz), dtype=vals.dtype)
    getattr(lib, f"spmx_colsplit_{sfx}")(
        int(rows), nsplit, bounds, offsets,
        np.ascontiguousarray(indices, dtype=np.uint32),
        np.ascontiguousarray(vals),
        out_offsets, out_indices, out_vals,
    )
    offs_l, idx_l, val_l = [], [], []
    pos = 0
    for s in range(nsplit):
        so = out_offsets[s * (int(rows) + 1) : (s + 1) * (int(rows) + 1)]
        n_s = int(so[-1])
        offs_l.append(so)
        idx_l.append(out_indices[pos : pos + n_s])
        val_l.append(out_vals[pos : pos + n_s])
        pos += n_s
    return offs_l, idx_l, val_l


def dia_fill_native(rows, offsets, indices, vals, band_offsets, data):
    """One-pass DIA band-storage build (formats/dia.py accept path).
    Mutates ``data`` (nb, rows) in place; returns True or None."""
    lib = load_library()
    sfx = _SUFFIX_BY_DTYPE.get(vals.dtype)
    if lib is None or sfx is None or data.dtype != vals.dtype:
        return None
    assert data.flags["C_CONTIGUOUS"]
    getattr(lib, f"spmx_dia_fill_{sfx}")(
        int(rows),
        np.ascontiguousarray(offsets, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.uint32),
        np.ascontiguousarray(vals),
        int(data.shape[0]),
        np.ascontiguousarray(band_offsets, dtype=np.int64),
        data.reshape(-1),
    )
    return True


def blocks_to_coo_native(blocks, block_rows, block_cols, rows, cols):
    """Sparsify dense BSR blocks to COO via the C pass; None if unavailable
    or the dtype isn't float32."""
    lib = load_library()
    if lib is None or blocks.dtype != np.float32:
        return None
    blocks = np.ascontiguousarray(blocks)
    nnzb, bs = blocks.shape[0], blocks.shape[1]
    n = int(lib.spmx_blocks_count_nnz(blocks, nnzb, bs))
    out_r = np.zeros(max(1, n), dtype=np.int64)
    out_c = np.zeros(max(1, n), dtype=np.int64)
    out_v = np.zeros(max(1, n), dtype=np.float32)
    k = int(
        lib.spmx_blocks_to_coo(
            blocks, nnzb, bs,
            np.ascontiguousarray(block_rows, dtype=np.int64),
            np.ascontiguousarray(block_cols, dtype=np.uint32),
            rows, cols, out_r, out_c, out_v,
        )
    )
    return out_r[:k], out_c[:k], out_v[:k]


def _graph_csr_args(offsets, indices):
    return (
        np.ascontiguousarray(offsets, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.uint32),
    )


def connected_components_native(n, offsets, indices, *, strong=False):
    """Component labels over a CSR pattern. ``strong=False`` = weak
    connectivity (edges undirected; the pattern may be one-directional),
    ``strong=True`` = Tarjan SCC. Returns ``(ncomp, labels)`` with labels
    numbered by first row occurrence, or None when the library is
    unavailable."""
    lib = load_library()
    if lib is None:
        return None
    offsets, indices = _graph_csr_args(offsets, indices)
    labels = np.empty(max(1, n), dtype=np.int64)
    fn = lib.spmx_scc if strong else lib.spmx_connected_components
    nc = int(fn(int(n), offsets, indices, labels))
    return nc, labels[:n]


def dijkstra_native(n, offsets, indices, vals, source):
    """Single-source Dijkstra. Returns ``(dist, pred)`` (f64/i64, unreached
    = +inf / -1) or None when the library is unavailable. Weights must be
    non-negative (caller's contract; graph/csgraph.py enforces)."""
    lib = load_library()
    if lib is None:
        return None
    offsets, indices = _graph_csr_args(offsets, indices)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    dist = np.full(max(1, n), np.inf, dtype=np.float64)
    pred = np.full(max(1, n), -1, dtype=np.int64)
    lib.spmx_dijkstra(int(n), offsets, indices, vals, int(source), dist, pred)
    return dist[:n], pred[:n]


def traversal_order_native(n, offsets, indices, source, *, dfs=False):
    """BFS (or DFS preorder) visitation order + parent array from
    ``source``. Returns ``(order, pred)`` with ``order`` trimmed to the
    visited count, or None when the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    offsets, indices = _graph_csr_args(offsets, indices)
    order = np.empty(max(1, n), dtype=np.int64)
    pred = np.full(max(1, n), -1, dtype=np.int64)
    fn = lib.spmx_dfs_order if dfs else lib.spmx_bfs_order
    cnt = int(fn(int(n), offsets, indices, int(source), order, pred))
    return order[:cnt], pred[:n]


def kruskal_native(n, ei, ej, order):
    """Kruskal accept loop over pre-sorted undirected edges. Returns the
    int64 0/1 keep mask (aligned with ei/ej) or None when the library is
    unavailable."""
    lib = load_library()
    if lib is None:
        return None
    ei = np.ascontiguousarray(ei, dtype=np.int64)
    ej = np.ascontiguousarray(ej, dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    keep = np.zeros(max(1, len(ei)), dtype=np.int64)
    lib.spmx_kruskal(int(n), len(ei), ei, ej, order, keep)
    return keep[: len(ei)]


def hopcroft_karp_native(rows, cols, offsets, indices):
    """Maximum bipartite matching (Hopcroft-Karp) on the rows->cols CSR
    pattern. Returns ``(size, match_row, match_col)`` (-1 = unmatched) or
    None when the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    mr = np.empty(max(1, rows), dtype=np.int64)
    mc = np.empty(max(1, cols), dtype=np.int64)
    size = int(lib.spmx_hopcroft_karp(int(rows), int(cols), offsets, indices, mr, mc))
    return size, mr[:rows], mc[:cols]


def maxflow_native(n, eu, ev, cap, source, sink):
    """Dinic maximum flow over an integer-capacity edge list. Returns
    ``(flow_value, per_edge_flow)`` or None when the library is
    unavailable."""
    lib = load_library()
    if lib is None:
        return None
    eu = np.ascontiguousarray(eu, dtype=np.int64)
    ev = np.ascontiguousarray(ev, dtype=np.int64)
    cap = np.ascontiguousarray(cap, dtype=np.int64)
    flow = np.zeros(max(1, len(eu)), dtype=np.int64)
    val = int(lib.spmx_maxflow(int(n), len(eu), eu, ev, cap, int(source), int(sink), flow))
    return val, flow[: len(eu)]

"""DIA format + index-free SpMV + operator auto-selection tests."""

import numpy as np
import pytest

from sparse_matrix_tpu.core import DokMatrix
from sparse_matrix_tpu.formats import CsrMatrix
from sparse_matrix_tpu.formats.dia import try_dia_from_csr
from sparse_matrix_tpu.ops.operator import SpmvOperator
from sparse_matrix_tpu.ops.spmv_dia import spmv_dia
from sparse_matrix_tpu.solvers import cg_solve, poisson_2d_csr


def test_poisson_is_dia():
    A = poisson_2d_csr(16, dtype=np.float32)
    d = try_dia_from_csr(A)
    assert d is not None
    assert d.nbands == 5
    assert set(d.offsets) == {-16, -1, 0, 1, 16}
    assert d.to_csr() == CsrMatrix.from_dok(A.to_dok())


def test_dia_spmv_matches_dense():
    A = poisson_2d_csr(20, dtype=np.float32)
    d = try_dia_from_csr(A)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(400).astype(np.float32)
    y = np.asarray(spmv_dia(d, x))
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-5, atol=1e-5)


def test_dia_rectangular_bands():
    # band off the square diagonal on a rectangular matrix
    m = DokMatrix.new(6, 9, dtype=np.float32)
    for i in range(6):
        m.set_element((i, i + 3), np.float32(i + 1))
        if i + 5 < 9:
            m.set_element((i, i + 5), np.float32(2.0))
    A = CsrMatrix.from_dok(m)
    d = try_dia_from_csr(A, min_fill=0.0)
    assert d is not None
    rng = np.random.default_rng(1)
    x = rng.standard_normal(9).astype(np.float32)
    np.testing.assert_allclose(np.asarray(spmv_dia(d, x)), A.to_dense() @ x, rtol=1e-5, atol=1e-6)


def test_unstructured_rejected():
    rng = np.random.default_rng(2)
    a = (rng.random((300, 300)) < 0.01) * rng.standard_normal((300, 300))
    A = CsrMatrix.from_dok(DokMatrix.from_dense(a.astype(np.float32)))
    assert try_dia_from_csr(A) is None


def test_operator_auto_selects():
    A = poisson_2d_csr(16, dtype=np.float32)
    op = SpmvOperator(A)
    assert op.format == "dia"
    rng = np.random.default_rng(3)
    a = (rng.random((200, 200)) < 0.02) * rng.standard_normal((200, 200))
    B = CsrMatrix.from_dok(DokMatrix.from_dense(a.astype(np.float32)))
    op2 = SpmvOperator(B)
    # non-banded: one of the general formats, picked by estimated cost
    # (at r128=2 streaming BELL planes is nearly free, so the round-3
    # family can win the cost race even on scattered structure; round 4
    # added the stripe family to the same race)
    assert op2.format in ("lanepack", "aligned", "bell", "stripe")
    x = rng.standard_normal(200).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op2(x)), a.astype(np.float32) @ x, rtol=1e-4, atol=1e-4)


def test_cg_with_operator():
    A = poisson_2d_csr(24, dtype=np.float32)
    op = SpmvOperator(A)
    rng = np.random.default_rng(4)
    b = rng.standard_normal(24 * 24).astype(np.float32)
    res = cg_solve(op, b, tol=1e-5, maxiter=2000)
    r = A.to_dense().astype(np.float64) @ np.asarray(res.x, dtype=np.float64) - b
    assert np.linalg.norm(r) <= 1e-3 * np.linalg.norm(b)


def test_operator_ell_fallback_hyper_sparse():
    # one nonzero per row over a very wide matrix: LanePack packing would be
    # pathologically empty. The dispatch contract (not a hardcoded format):
    # the router must pick one of the compact scatter-friendly formats it
    # prices for this class (ELL or stripe — both avoid the empty-slab
    # LanePack blowup), and the result must be correct.
    rng = np.random.default_rng(9)
    rows, cols = 2000, 60000
    r = np.arange(rows)
    c = rng.integers(0, cols, rows)
    v = rng.standard_normal(rows).astype(np.float32)
    from sparse_matrix_tpu.formats.csr import CsrMatrix as C

    A = C.from_coo(rows, cols, r, c, v)
    op = SpmvOperator(A)
    assert op.format in ("ell", "stripe"), op.format
    x = rng.standard_normal(cols).astype(np.float32)
    y = np.asarray(op(x))
    ref = np.zeros(rows, np.float32)
    for i in range(rows):
        lo, hi = int(A.offsets[i]), int(A.offsets[i + 1])
        ref[i] = (A.vals[lo:hi] * x[A.indices[lo:hi].astype(np.int64)]).sum()
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-5)


def test_operator_plan_save_load(tmp_path):
    from sparse_matrix_tpu.ops.operator import load_operator_plan, save_operator_plan

    rng = np.random.default_rng(12)
    a = (rng.random((200, 160)) < 0.03) * rng.standard_normal((200, 160))
    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats.csr import CsrMatrix as C

    A = C.from_dok(DokMatrix.from_dense(a.astype(np.float32)))
    for force in ("lanepack", None):
        op = SpmvOperator(A, force=force)
        p = str(tmp_path / f"plan_{op.format}.npz")
        save_operator_plan(op, p)
        op2 = load_operator_plan(p)
        assert op2.format == op.format
        x = rng.standard_normal(160).astype(np.float32)
        np.testing.assert_allclose(np.asarray(op2(x)), np.asarray(op(x)), rtol=1e-6)

    B = poisson_2d_csr(16, dtype=np.float32)
    op = SpmvOperator(B)
    p = str(tmp_path / "plan_dia.npz")
    save_operator_plan(op, p)
    op2 = load_operator_plan(p)
    assert op2.format == "dia"
    x = rng.standard_normal(256).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op2(x)), np.asarray(op(x)), rtol=1e-6)


def test_operator_force_lanepack_is_respected():
    # force="lanepack" must bypass the aligned-vs-lanepack cost comparison
    A = poisson_2d_csr(16, dtype=np.float32)
    op = SpmvOperator(A, force="lanepack")
    assert op.format == "lanepack"
    op2 = SpmvOperator(A, force="aligned")
    assert op2.format == "aligned"


@pytest.mark.parametrize("values_dtype", [None, "bfloat16"])
def test_dia_large_operator_takes_xla_path(values_dtype):
    """Band data above 48 MB (the size that used to switch to a streaming
    kernel) runs the same fused XLA form and matches a float64 oracle."""
    import jax
    import jax.numpy as jnp

    from sparse_matrix_tpu.formats.dia import DiaMatrix
    from sparse_matrix_tpu.ops.spmv_dia import dia_device_arrays, spmv_dia

    rows = 2_600_000
    offs = (-1613, -1, 0, 1, 1613)
    rng = np.random.default_rng(7)
    data = rng.integers(-4, 5, (len(offs), rows)).astype(np.float32)
    assert data.nbytes > 48 * 1024 * 1024
    d = DiaMatrix(rows, rows, data, offs)
    vdt = jnp.bfloat16 if values_dtype else None
    arrs = dia_device_arrays(d, values_dtype=vdt)
    x = rng.standard_normal(rows).astype(np.float32)
    jaxpr = str(jax.make_jaxpr(lambda v: spmv_dia(d, v, device_arrays=arrs))(x))
    assert "pallas_call" not in jaxpr
    y = np.asarray(spmv_dia(d, x, device_arrays=arrs), np.float64)
    ref = np.zeros(rows)
    scale = np.zeros(rows)
    x64 = x.astype(np.float64)
    for b, off in enumerate(offs):
        lo, hi = max(0, -off), min(rows, rows - off)
        ref[lo:hi] += data[b, lo:hi] * x64[lo + off:hi + off]
        scale[lo:hi] += np.abs(data[b, lo:hi] * x64[lo + off:hi + off])
    # small-integer band values are exact in bf16 too
    assert np.abs(y - ref).max() <= 1e-5 * scale.max()


def test_dia_packed_spmm_negative_lane_shifts():
    """Offsets whose divmod by 128 leaves a lane shift (incl. negatives:
    -1 -> q=-1, r=127) exercise the packed layout's two-view lane
    concatenation."""
    from sparse_matrix_tpu.formats.dia import DiaMatrix
    from sparse_matrix_tpu.ops.spmv_dia import spmm_dia_stream

    rng = np.random.default_rng(1)
    rows = 4096
    offs = (-129, -1, 0, 3, 130)
    data = np.zeros((5, rows), np.float32)
    for b, off in enumerate(offs):
        lo, hi = max(0, -off), min(rows, rows - off)
        data[b, lo:hi] = rng.standard_normal(hi - lo)
    d = DiaMatrix(rows, rows, data, offs)
    x = rng.standard_normal((rows, 4)).astype(np.float32)
    ref = d.to_csr().to_dense().astype(np.float64) @ x
    y = np.asarray(spmm_dia_stream(d, x, br=4))
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)

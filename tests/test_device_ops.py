"""Device sort-based ops (transpose, add/sub, ESC SpGEMM) vs the DOK oracle —
commuting-diagram tests through DeviceCsr round-trips."""

import numpy as np
import pytest
from hypothesis import given, settings

from sparse_matrix_tpu.core import DokMatrix
from sparse_matrix_tpu.formats import CsrMatrix
from sparse_matrix_tpu.formats.device import DeviceCsr
from sparse_matrix_tpu.ops.device_sorted import (
    add_device,
    expand_plan,
    padded_to_host,
    spgemm_esc_device,
    sub_device,
    transpose_device,
)
from sparse_matrix_tpu.verify.strategies import add_pairs, dok_matrices, mul_pairs, finite_f64s
import jax.numpy as jnp

# XLA may flush f32 subnormals to zero (on accelerators, and on CPU in several ops) — a
# documented device-op contract, so keep subnormals out of the value domain
def _f32_ftz(v):
    f = np.float32(np.clip(v, -1e30, 1e30))
    return np.float32(0.0) if 0 < abs(float(f)) < np.finfo(np.float32).tiny else f


F32 = finite_f64s().map(_f32_ftz)


def to_dev(m: DokMatrix) -> DeviceCsr:
    return DeviceCsr.from_host(CsrMatrix.from_dok(m, dtype=np.float32), dtype=jnp.float32)


@settings(max_examples=25)
@given(dok_matrices(F32, dtype=np.float32))
def test_transpose_device_commutes(m):
    d = to_dev(m)
    t = transpose_device(d)
    host = t.to_host()
    assert host.invariants()
    assert host.to_dok() == m.transpose()


@settings(max_examples=25)
@given(add_pairs(F32, dtype=np.float32))
def test_add_device_commutes(pair):
    da, db = to_dev(pair.a), to_dev(pair.b)
    out = padded_to_host(add_device(da, db))
    assert out.invariants()
    assert out.to_dok() == pair.a + pair.b


@settings(max_examples=25)
@given(add_pairs(F32, dtype=np.float32))
def test_sub_device_commutes(pair):
    da, db = to_dev(pair.a), to_dev(pair.b)
    out = padded_to_host(sub_device(da, db))
    assert out.invariants()
    assert out.to_dok() == pair.a - pair.b


@settings(max_examples=25)
@given(mul_pairs(F32, dtype=np.float32))
def test_spgemm_esc_device_commutes(pair):
    ha = CsrMatrix.from_dok(pair.a, dtype=np.float32)
    hb = CsrMatrix.from_dok(pair.b, dtype=np.float32)
    da, db = DeviceCsr.from_host(ha), DeviceCsr.from_host(hb)
    out = padded_to_host(spgemm_esc_device(da, db, plan=expand_plan(ha, hb)))
    assert out.invariants()
    expected = (pair.a * pair.b).to_dense().astype(np.float64)
    np.testing.assert_allclose(out.to_dense().astype(np.float64), expected, rtol=1e-4, atol=1e-5)


def test_add_dim_mismatch():
    a = to_dev(DokMatrix.new(2, 3, dtype=np.float32))
    b = to_dev(DokMatrix.new(3, 2, dtype=np.float32))
    with pytest.raises(ValueError, match="identical dimensions"):
        add_device(a, b)


def test_cancellation_zero_kept_explicit():
    m = DokMatrix.new(2, 2, dtype=np.float32)
    m.set_element((0, 0), np.float32(3.0))
    d = to_dev(m)
    out = padded_to_host(sub_device(d, d))
    # explicit zero stays (union structure), vanishes through DOK
    assert out.nnz() == 1
    assert out.to_dok() == DokMatrix.new(2, 2, dtype=np.float32)


def test_esc_spgemm_amortized_and_value_reuse():
    from sparse_matrix_tpu.ops.device_sorted import EscSpgemm

    rng = np.random.default_rng(4)
    n = 64
    a = (rng.random((n, n)) < 0.06) * rng.standard_normal((n, n))
    b = (rng.random((n, n)) < 0.06) * rng.standard_normal((n, n))
    A = CsrMatrix.from_dok(DokMatrix.from_dense(a.astype(np.float32)))
    B = CsrMatrix.from_dok(DokMatrix.from_dense(b.astype(np.float32)))
    eng = EscSpgemm(A, B)
    C = eng.multiply()
    assert C.invariants()
    np.testing.assert_allclose(
        C.to_dense(), a.astype(np.float32) @ b.astype(np.float32), rtol=1e-4, atol=1e-5
    )
    # fresh values, same sparsity: no re-plan needed
    C2 = padded_to_host(eng.multiply_device(lhs_vals=eng.lhs_vals * 2.0))
    np.testing.assert_allclose(C2.to_dense(), 2.0 * C.to_dense(), rtol=1e-5, atol=1e-6)


def test_esc_spgemm_dim_mismatch():
    from sparse_matrix_tpu.ops.device_sorted import EscSpgemm

    with pytest.raises(ValueError, match="LHS cols != RHS rows"):
        EscSpgemm(CsrMatrix.new(2, 3, dtype=np.float32), CsrMatrix.new(2, 3, dtype=np.float32))


def test_esc_pallas_expansion_engine():
    """ESC k-major expansion + packed presorted-key reduce must match the XLA-gather engine and the dense oracle,
    including the sentinel-padding nnz correction and fresh-value reuse."""
    import jax.numpy as jnp

    from sparse_matrix_tpu.ops.device_sorted import EscSpgemm

    rng = np.random.default_rng(5)
    r = rng.integers(0, 300, 2200)
    c = rng.integers(0, 280, 2200)
    a = CsrMatrix.from_coo(300, 280, r, c, rng.standard_normal(2200))
    b = CsrMatrix.from_coo(
        280, 310, rng.integers(0, 280, 1800), rng.integers(0, 310, 1800),
        rng.standard_normal(1800))
    e = EscSpgemm(a, b)
    assert e.engine == "kmajor"
    ref = a.to_dense() @ b.to_dense()
    np.testing.assert_allclose(e.multiply().to_dense(), ref, atol=1e-4)
    # nnz exactness (sentinel padding must not leak)
    assert e.multiply().nnz() == int(np.count_nonzero(ref))
    # fresh values with the same pattern
    nv = rng.standard_normal(a.nnz()).astype(np.float32)
    a2 = CsrMatrix(a.rows, a.cols, nv, a.indices, a.offsets,
                   is_sorted=a.is_sorted)
    from sparse_matrix_tpu.ops.device_sorted import padded_to_host

    got = padded_to_host(e.multiply_device(lhs_vals=jnp.asarray(nv)))
    np.testing.assert_allclose(
        got.to_dense(), a2.to_dense() @ b.to_dense(), atol=1e-4)
    # parity with the XLA engine
    e2 = EscSpgemm(a, b, engine="xla")
    np.testing.assert_allclose(
        e2.multiply().to_dense(), ref, atol=1e-4)

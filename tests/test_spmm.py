"""SpMM (sparse x dense block) tests."""

import numpy as np
import pytest

from sparse_matrix_tpu.core import DokMatrix
from sparse_matrix_tpu.formats import CsrMatrix
from sparse_matrix_tpu.formats.bcsr import BsrMatrix
from sparse_matrix_tpu.formats.dia import try_dia_from_csr
from sparse_matrix_tpu.ops.spmm import spmm_bcsr, spmm_dia
from sparse_matrix_tpu.solvers import poisson_2d_csr


def test_spmm_dia():
    A = poisson_2d_csr(16, dtype=np.float32)
    d = try_dia_from_csr(A)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 7)).astype(np.float32)
    y = np.asarray(spmm_dia(d, x))
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-4, atol=1e-4)


def test_spmm_bcsr():
    rng = np.random.default_rng(1)
    a = (rng.random((200, 150)) < 0.05) * rng.standard_normal((200, 150))
    A = CsrMatrix.from_dok(DokMatrix.from_dense(a.astype(np.float32)))
    B = BsrMatrix.from_csr(A, 8)
    x = rng.standard_normal((150, 5)).astype(np.float32)
    y = np.asarray(spmm_bcsr(B, x))
    np.testing.assert_allclose(y, a.astype(np.float32) @ x, rtol=1e-3, atol=1e-4)


def test_spmm_bcsr_empty_block_rows():
    m = DokMatrix.new(300, 300, dtype=np.float32)
    m.set_element((299, 0), np.float32(3.0))
    A = CsrMatrix.from_dok(m)
    B = BsrMatrix.from_csr(A, 128)
    x = np.ones((300, 3), dtype=np.float32)
    y = np.asarray(spmm_bcsr(B, x))
    assert y[299, 0] == 3.0
    assert np.all(y[:299] == 0)


def test_spmm_aligned_matches_dense():
    import jax.numpy as jnp
    from sparse_matrix_tpu.formats.aligned import plan_aligned
    from sparse_matrix_tpu.ops.spmm import pack_rhs, spmm_aligned, unpack_rhs
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    rng = np.random.default_rng(0)
    m = poisson_2d_csr(24, dtype=np.float32)
    plan = plan_aligned(m)
    x = rng.standard_normal((m.cols, 8)).astype(np.float32)
    y = np.asarray(spmm_aligned(plan, x))
    np.testing.assert_allclose(y, m.to_dense().astype(np.float32) @ x, rtol=1e-4, atol=1e-4)
    # pack/unpack round-trip
    x3 = pack_rhs(x, m.cols)
    np.testing.assert_allclose(np.asarray(unpack_rhs(x3, m.cols)), x)


def test_spmm_aligned_with_spill_plan(tmp_path, monkeypatch):
    # poisson + a handful of far-scattered entries: the scattered chunks
    # hold 1 slot each; a calibration that makes aligned slabs expensive
    # forces the spill sub-plan, exercising spmm's per-column spill path
    import json

    from sparse_matrix_tpu.formats.aligned import plan_aligned
    from sparse_matrix_tpu.ops.spmm import spmm_aligned
    from sparse_matrix_tpu.solvers import poisson_2d_csr
    from sparse_matrix_tpu.formats.csr import CsrMatrix
    from sparse_matrix_tpu.utils import autotune

    cache = tmp_path / "autotune.json"
    cache.write_text(json.dumps({
        "lanepack_aligned_slab_ns": 1e6, "lanepack_dense_slab_ns": 1e-3,
    }))
    monkeypatch.setenv("SPMX_AUTOTUNE_CACHE", str(cache))
    autotune.reset_cache()
    try:
        rng = np.random.default_rng(1)
        m = poisson_2d_csr(32, dtype=np.float32)
        r = m.row_ids()
        c = m.indices.astype(np.int64)
        v = m.vals
        extra = 60
        re = rng.integers(0, m.rows, extra)
        ce = (re * 37 + 511) % m.cols  # scattered, far from the band
        ve = rng.standard_normal(extra).astype(np.float32)
        m2 = CsrMatrix.from_coo(m.rows, m.cols, np.r_[r, re], np.r_[c, ce], np.r_[v, ve])
        plan = plan_aligned(m2)
        assert plan.spill is not None
        x = rng.standard_normal((m2.cols, 4)).astype(np.float32)
        y = np.asarray(spmm_aligned(plan, x))
        np.testing.assert_allclose(
            y, m2.to_dense().astype(np.float32) @ x, rtol=1e-4, atol=1e-4
        )
    finally:
        autotune.reset_cache()


def test_cg_solve_multi_packed_layout():
    import jax.numpy as jnp
    from sparse_matrix_tpu.formats.aligned import plan_aligned
    from sparse_matrix_tpu.ops.spmm import aligned_matvec_multi, pack_rhs, unpack_rhs
    from sparse_matrix_tpu.solvers import cg_solve, cg_solve_multi, poisson_2d_csr
    from sparse_matrix_tpu.ops.operator import SpmvOperator

    rng = np.random.default_rng(2)
    m = poisson_2d_csr(16, dtype=np.float32)
    plan = plan_aligned(m)
    k = 4
    b = rng.standard_normal((m.rows, k)).astype(np.float32)
    mv = aligned_matvec_multi(plan, k)
    res = cg_solve_multi(mv, pack_rhs(b, m.cols), tol=1e-6, maxiter=2000, rhs_axis=1)
    x = np.asarray(unpack_rhs(res.x, m.rows))
    dense = m.to_dense().astype(np.float64)
    for j in range(k):
        r = dense @ x[:, j] - b[:, j]
        assert np.linalg.norm(r) < 1e-4 * np.linalg.norm(b[:, j])


def test_operator_matmat_all_formats():
    from sparse_matrix_tpu.ops.operator import SpmvOperator
    from sparse_matrix_tpu.solvers import poisson_2d_csr
    from sparse_matrix_tpu.formats.csr import CsrMatrix
    from sparse_matrix_tpu.core import DokMatrix

    rng = np.random.default_rng(5)
    p = poisson_2d_csr(16, dtype=np.float32)
    dense_g = ((rng.random((300, 300)) < 0.03) * rng.standard_normal((300, 300))).astype(np.float32)
    g = CsrMatrix.from_dok(DokMatrix.from_dense(dense_g))
    for m, force in ((p, "dia"), (p, "aligned"), (p, "lanepack"), (p, "ell"), (g, "lanepack"), (g, "ell")):
        X = rng.standard_normal((m.cols, 6)).astype(np.float32)
        op = SpmvOperator(m, force=force)
        y = np.asarray(op.matmat(X))
        np.testing.assert_allclose(
            y, m.to_dense().astype(np.float32) @ X, rtol=1e-4, atol=1e-4,
            err_msg=force,
        )
    Xg = rng.standard_normal((g.cols, 3)).astype(np.float32)
    opg = SpmvOperator(g)
    np.testing.assert_allclose(
        np.asarray(opg.matmat(Xg)), dense_g @ Xg, rtol=1e-3, atol=1e-3
    )


@pytest.mark.parametrize("kw", [1, 2, 4])
@pytest.mark.parametrize("pack", ["dense", "per_rb"])
def test_spmm_lanepack_matches_dense(kw, pack):
    """General-path multi-RHS SpMM vs dense, both pack modes, kw windows,
    rectangular shape."""
    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats.csr import CsrMatrix
    from sparse_matrix_tpu.formats.lanepack import plan_lanepack
    from sparse_matrix_tpu.ops.spmm import spmm_lanepack

    rng = np.random.default_rng(kw * 7 + (pack == "per_rb"))
    rows, cols = 220, 150 + kw * 128
    dense = ((rng.random((rows, cols)) < 0.04) * rng.standard_normal((rows, cols))).astype(np.float32)
    m = CsrMatrix.from_dok(DokMatrix.from_dense(dense))
    plan = plan_lanepack(m, kw=kw, pack=pack)
    # K=5 exercises the per-column dispatch branch, K=9 the packed kernel
    for K in (5, 9):
        X = rng.standard_normal((cols, K)).astype(np.float32)
        y = np.asarray(spmm_lanepack(plan, X))
        np.testing.assert_allclose(y, dense @ X, rtol=1e-4, atol=1e-4)


def test_spmm_lanepack_packed_matvec_multi():
    """Square packed-layout closure: matches per-column SpMV results."""
    from sparse_matrix_tpu.formats.lanepack import plan_lanepack
    from sparse_matrix_tpu.ops.spmm import lanepack_matvec_multi, pack_rhs, unpack_rhs
    from sparse_matrix_tpu.ops.spmv import spmv_lanepack
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    m = poisson_2d_csr(14, dtype=np.float32)
    plan = plan_lanepack(m)
    rng = np.random.default_rng(3)
    K = 4
    X = rng.standard_normal((m.cols, K)).astype(np.float32)
    mv = lanepack_matvec_multi(plan, K)
    x3 = pack_rhs(X, m.cols, guard=plan.kw)
    y3 = mv(x3)
    assert y3.shape == x3.shape  # layout maps to itself (guard re-appended)
    Y = np.asarray(unpack_rhs(y3, m.rows))
    for k in range(K):
        np.testing.assert_allclose(
            Y[:, k], np.asarray(spmv_lanepack(plan, X[:, k])), rtol=1e-5, atol=1e-5
        )


def test_spmm_ell_with_spill_matches_dense():
    """Skewed matrix: operator picks ELL+COO spill; matmat must include the
    spill contribution."""
    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats.csr import CsrMatrix
    from sparse_matrix_tpu.ops.operator import SpmvOperator

    rng = np.random.default_rng(17)
    rows = cols = 400
    dense = ((rng.random((rows, cols)) < 0.01) * rng.standard_normal((rows, cols))).astype(np.float32)
    dense[7, :] = rng.standard_normal(cols).astype(np.float32)  # one dense row
    m = CsrMatrix.from_dok(DokMatrix.from_dense(dense))
    op = SpmvOperator(m, force="ell")
    assert op._ell_spill is not None  # the guard kicked in
    X = rng.standard_normal((cols, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(op.matmat(X)), dense @ X, rtol=1e-4, atol=1e-4
    )


def test_operator_matmat_lazy_cache_across_jit_traces():
    """Regression: the aligned matmat device-array cache is built on first
    use, which can happen INSIDE a jit trace; the cached constants must be
    concrete, not tracers, or the next trace raises UnexpectedTracerError
    (hit by experiments/amg_block.py's second jitted solve)."""
    import jax

    from sparse_matrix_tpu.ops.operator import SpmvOperator
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    p = poisson_2d_csr(16, dtype=np.float32)
    op = SpmvOperator(p, force="aligned")
    rng = np.random.default_rng(8)
    X = rng.standard_normal((p.cols, 4)).astype(np.float32)
    y1 = np.asarray(jax.jit(lambda xx: op.matmat(xx))(X))  # builds the cache
    y2 = np.asarray(jax.jit(lambda xx: op.matmat(xx))(X))  # fresh trace, reuses it
    ref = p.to_dense().astype(np.float32) @ X
    np.testing.assert_allclose(y1, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y2, ref, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------- BELL SpMM

def _bell_spmm_case(m, dense, rng, k, rtol=2e-4):
    from sparse_matrix_tpu.formats.bell import plan_bell
    from sparse_matrix_tpu.ops.spmm import spmm_bell

    x = rng.standard_normal((m.cols, k)).astype(np.float32)
    plan = plan_bell(m)
    y = np.asarray(spmm_bell(plan, x))
    y_ref = (dense.astype(np.float64) @ x.astype(np.float64)).astype(
        np.float32)
    scale = max(1.0, np.abs(y_ref).max())
    np.testing.assert_allclose(y / scale, y_ref / scale, atol=rtol)
    return plan


@pytest.mark.parametrize("k", [2, 5, 8, 16])
def test_spmm_bell_matches_dense(k):
    rng = np.random.default_rng(10)
    n = 512
    dense = ((rng.random((n, n)) < 0.05)
             * rng.standard_normal((n, n))).astype(np.float32)
    # local structure so the planner keeps layers resident
    i = np.arange(n)
    for off in (-2, -1, 0, 1, 3):
        j = np.clip(i + off, 0, n - 1)
        dense[i, j] = rng.standard_normal(n)
    m = CsrMatrix.from_dok(DokMatrix.from_dense(dense))
    _bell_spmm_case(m, dense, rng, k)


def test_spmm_bell_rectangular_and_spill():
    from sparse_matrix_tpu.formats.bell import plan_bell

    rng = np.random.default_rng(11)
    rows, cols = 300, 520
    dense = np.zeros((rows, cols), np.float32)
    i = np.arange(rows)
    for off in (0, 1, 2, 130):
        j = np.clip(i + off, 0, cols - 1)
        dense[i, j] = rng.standard_normal(rows)
    m = CsrMatrix.from_dok(DokMatrix.from_dense(dense))
    _bell_spmm_case(m, dense, rng, 4)
    # force a spill sub-plan via the layer cap and keep parity
    x = rng.standard_normal((cols, 4)).astype(np.float32)
    from sparse_matrix_tpu.ops.spmm import spmm_bell

    plan = plan_bell(m, max_layers=2)
    assert plan.spill is not None
    y = np.asarray(spmm_bell(plan, x))
    y_ref = (dense.astype(np.float64) @ x.astype(np.float64)).astype(
        np.float32)
    np.testing.assert_allclose(y, y_ref, atol=2e-3)


def test_spmm_bell_gate_and_operator_route():
    from sparse_matrix_tpu.formats.bell import plan_bell
    from sparse_matrix_tpu.ops.spmm import bell_spmm_viable, spmm_bell

    rng = np.random.default_rng(12)
    n = 256
    dense = np.zeros((n, n), np.float32)
    i = np.arange(n)
    for off in (-1, 0, 1):
        j = np.clip(i + off, 0, n - 1)
        dense[i, j] = rng.standard_normal(n)
    m = CsrMatrix.from_dok(DokMatrix.from_dense(dense))
    plan = plan_bell(m)
    assert not bell_spmm_viable(plan, 1)
    assert not bell_spmm_viable(plan, 17)
    assert bell_spmm_viable(plan, 8)
    with pytest.raises(ValueError):
        spmm_bell(plan, np.zeros((n, 1), np.float32))
    # operator.matmat routes BELL through the packed kernel
    from sparse_matrix_tpu.ops.operator import SpmvOperator

    op = SpmvOperator(m, force="bell")
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = np.asarray(op.matmat(x))
    np.testing.assert_allclose(
        y, dense.astype(np.float64) @ x.astype(np.float64), atol=2e-3)


def test_spmm_dia_stream_parity():
    """Streaming DIA SpMM (CPU = pure-XLA reference of the kernel math)
    vs the f64 oracle, f32 and bf16 planes, plus input validation."""
    import jax.numpy as jnp

    from sparse_matrix_tpu.formats.dia import try_dia_from_csr
    from sparse_matrix_tpu.ops.spmv import spmv_oracle
    from sparse_matrix_tpu.ops.spmv_dia import dia_device_arrays, spmm_dia_stream
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    a = poisson_2d_csr(40, dtype=np.float32)  # offsets +-40: exercises q/r
    dia = try_dia_from_csr(a)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((a.cols, 4)).astype(np.float32)
    y_ref = np.stack(
        [spmv_oracle(a, x[:, j].astype(np.float64)) for j in range(4)], axis=1
    )
    scale = max(1.0, np.abs(y_ref).max())
    for vdt, tol in ((None, 2e-6), (jnp.bfloat16, 2e-6)):  # {-1,4} bf16-exact
        arrs = dia_device_arrays(dia, values_dtype=vdt)
        y = np.asarray(spmm_dia_stream(dia, x, device_arrays=arrs))
        assert np.abs(y / scale - y_ref / scale).max() < tol
    with pytest.raises(ValueError, match="K must be"):
        spmm_dia_stream(dia, x[:, :1])
    with pytest.raises(ValueError, match="K must be"):
        spmm_dia_stream(dia, np.tile(x, (1, 5)))  # K=20


def test_operator_matmat_dia_streaming_dispatch(monkeypatch):
    """matmat routes large square DIA operators through the packed
    spmm_dia_stream in balanced chunks of <=16 columns (threshold patched
    down so a test-size operator exercises the real branch)."""
    from sparse_matrix_tpu.ops import operator as opmod
    from sparse_matrix_tpu.ops.operator import SpmvOperator
    from sparse_matrix_tpu.ops.spmv import spmv_oracle
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    monkeypatch.setattr(opmod, "_DIA_PACKED_MIN_BYTES", 1024)
    a = poisson_2d_csr(40, dtype=np.float32)
    op = SpmvOperator(a, force="dia")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((a.cols, 20)).astype(np.float32)  # 2 chunks of 10
    y = np.asarray(op.matmat(x))
    y_ref = np.stack(
        [spmv_oracle(a, x[:, j].astype(np.float64)) for j in range(20)], axis=1
    )
    scale = max(1.0, np.abs(y_ref).max())
    assert np.abs(y / scale - y_ref / scale).max() < 2e-6


def test_dia_matvec_multi_block_cg():
    """Packed-persistent DIA block matvec through cg_solve_multi
    (rhs_axis=1): 4 Poisson systems in lockstep converge to tol and match
    the per-column f64 solutions."""
    from sparse_matrix_tpu.formats.dia import try_dia_from_csr
    from sparse_matrix_tpu.ops.spmv_dia import (
        dia_matvec_multi, dia_pack_rhs, dia_unpack_rhs)
    from sparse_matrix_tpu.solvers import poisson_2d_csr
    from sparse_matrix_tpu.solvers.cg import cg_solve_multi

    a = poisson_2d_csr(24, dtype=np.float32)
    dia = try_dia_from_csr(a)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((a.rows, 4)).astype(np.float32)
    mv = dia_matvec_multi(dia, 4)
    b3 = dia_pack_rhs(dia, b)
    # closure maps the packed layout to itself
    y3 = mv(b3)
    assert y3.shape == b3.shape
    res = cg_solve_multi(mv, b3, tol=1e-6, maxiter=3000, rhs_axis=1)
    x = np.asarray(dia_unpack_rhs(dia, res.x))
    ad = a.to_dense().astype(np.float64)
    x_ref = np.linalg.solve(ad, b.astype(np.float64))
    assert np.abs(x - x_ref).max() < 1e-3 * max(1.0, np.abs(x_ref).max())

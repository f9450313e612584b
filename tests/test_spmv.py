"""SpMV property tests: the LanePack plan's XLA evaluation and the XLA ELL
path, against the numpy CSR oracle."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sparse_matrix_tpu.core import DokMatrix
from sparse_matrix_tpu.formats import CsrMatrix
from sparse_matrix_tpu.formats.lanepack import plan_lanepack
from sparse_matrix_tpu.ops.spmv import (
    ell_from_csr,
    spmv_ell_xla,
    spmv_lanepack,
    spmv_oracle,
)
from sparse_matrix_tpu.verify.strategies import dok_matrices, finite_f64s


def _rand_csr(rng, rows, cols, density):
    a = (rng.random((rows, cols)) < density) * rng.standard_normal((rows, cols))
    return CsrMatrix.from_dok(DokMatrix.from_dense(a.astype(np.float32))), a.astype(np.float32)


@pytest.mark.parametrize(
    "rows,cols,density",
    [
        (5, 7, 0.4),
        (130, 260, 0.05),
        (257, 129, 0.15),
        (128, 128, 0.0),  # empty matrix
        (1, 1, 1.0),
        (300, 40, 0.1),
    ],
)
def test_lanepack_matches_dense(rows, cols, density):
    rng = np.random.default_rng(rows * 1000 + cols)
    A, a = _rand_csr(rng, rows, cols, density)
    x = rng.standard_normal(cols).astype(np.float32)
    y = np.asarray(spmv_lanepack(plan_lanepack(A), x))
    y_ref = a @ x
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [1, 2, 4])
def test_lanepack_kw_variants(kw):
    rng = np.random.default_rng(kw)
    A, a = _rand_csr(rng, 140, 1000, 0.02)
    x = rng.standard_normal(1000).astype(np.float32)
    plan = plan_lanepack(A, kw=kw)
    assert plan.kw == kw
    y = np.asarray(spmv_lanepack(plan, x))
    np.testing.assert_allclose(y, a @ x, rtol=1e-4, atol=1e-4)


def test_lanepack_plan_postconditions():
    # planner analog of the reference's rows_to_threads postcondition test
    # (spam_csr/src/mul_hash.rs:204-224)
    rng = np.random.default_rng(7)
    A, _ = _rand_csr(rng, 300, 300, 0.03)
    plan = plan_lanepack(A)
    assert plan.vals.shape == plan.lane.shape == plan.ends.shape == plan.starts.shape
    assert plan.lane.dtype == np.int16
    assert plan.ends.dtype == np.int8 and plan.starts.dtype == np.int8
    assert plan.nnz == A.nnz()
    # every nonzero is represented exactly once
    assert np.count_nonzero(plan.vals) <= plan.nnz
    assert float(np.sum(plan.vals)) == pytest.approx(float(np.sum(A.vals)), rel=1e-4)
    assert (plan.rb_a >= 0).all() and (plan.rb_a < plan.r128).all()
    assert (plan.rb_b >= 0).all() and (plan.rb_b < plan.r128).all()
    assert (plan.split >= 0).all() and (plan.split <= 8).all()
    # dense packing: at least half the slots used on this workload
    assert plan.fill > 0.5
    # starts in [-1, 127], ends in [0, 127]
    assert plan.starts.min() >= -1 and plan.starts.max() < 128
    assert plan.ends.min() >= 0 and plan.ends.max() < 128
    # HBM bytes per slot: 4 + 2 + 1 + 1
    assert plan.slot_bytes() == plan.vals.size * 8


@settings(max_examples=15, deadline=None)
@given(dok_matrices(finite_f64s(), dtype=np.float64, max_size=6))
def test_lanepack_property_vs_oracle(m):
    A = CsrMatrix.from_dok(m, dtype=np.float64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.cols)
    y_ref = spmv_oracle(A, x)
    # overflow to inf is out of the f32 kernel contract
    if not np.all(np.isfinite(y_ref.astype(np.float32))):
        return
    if not np.all(np.isfinite(A.vals.astype(np.float32))):
        return
    A32 = CsrMatrix(A.rows, A.cols, A.vals.astype(np.float32), A.indices, A.offsets, is_sorted=True)
    y = np.asarray(spmv_lanepack(plan_lanepack(A32), x.astype(np.float32)))
    scale = max(1.0, np.abs(y_ref).max())
    np.testing.assert_allclose(y / scale, y_ref / scale, atol=1e-3)


def test_ell_matches_oracle():
    rng = np.random.default_rng(3)
    A, a = _rand_csr(rng, 100, 80, 0.1)
    x = rng.standard_normal(80).astype(np.float32)
    ev, ec = ell_from_csr(A)
    y = np.asarray(spmv_ell_xla(ev, ec, x))
    np.testing.assert_allclose(y, a @ x, rtol=1e-4, atol=1e-5)


def test_ell_spill_matches_oracle():
    # width-capped ELL + COO spill on a skewed matrix (one dense row)
    from sparse_matrix_tpu.ops.spmv import ell_spill_from_csr, spmv_ell_spill_xla

    rng = np.random.default_rng(5)
    A, a = _rand_csr(rng, 200, 150, 0.02)
    for j in range(150):  # one dense row
        A.set_element((7, j), np.float32(rng.standard_normal()))
        a[7, j] = float(A.get_element((7, j)))
    x = rng.standard_normal(150).astype(np.float32)
    ev, ec, sr, sc, sv = ell_spill_from_csr(A)
    assert ev.shape[1] < 150  # the dense row must not set the pad width
    assert len(sr) > 0
    y = np.asarray(spmv_ell_spill_xla(ev, ec, sr, sc, sv, x))
    np.testing.assert_allclose(y, a @ x, rtol=1e-4, atol=1e-4)


def test_operator_ell_spill_guard_and_plan_roundtrip(tmp_path):
    # a skewed matrix forced onto the ELL branch routes to capped ELL + spill
    from sparse_matrix_tpu.ops.operator import (
        SpmvOperator,
        load_operator_plan,
        save_operator_plan,
    )

    rng = np.random.default_rng(6)
    A, a = _rand_csr(rng, 300, 300, 0.01)
    for j in range(300):
        A.set_element((11, j), np.float32(rng.standard_normal()))
        a[11, j] = float(A.get_element((11, j)))
    op = SpmvOperator(A, force="ell")
    assert op._ell_spill is not None
    assert op._ell[0].shape[1] < 300
    x = rng.standard_normal(300).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op(x)), a @ x, rtol=1e-4, atol=1e-4)
    p = str(tmp_path / "plan.npz")
    save_operator_plan(op, p)
    op2 = load_operator_plan(p)
    assert op2._ell_spill is not None
    np.testing.assert_allclose(np.asarray(op2(x)), a @ x, rtol=1e-4, atol=1e-4)


def test_empty_rows_are_zero():
    # rows with no entries (and whole empty row blocks) must produce 0, not
    # garbage from unvisited output blocks
    A = CsrMatrix.new(400, 400, dtype=np.float32)
    A.set_element((399, 0), np.float32(2.0))
    x = np.ones(400, dtype=np.float32)
    y = np.asarray(spmv_lanepack(plan_lanepack(A), x))
    assert y[399] == 2.0
    assert np.all(y[:399] == 0.0)


def test_aligned_matches_oracle_banded_and_scattered():
    from sparse_matrix_tpu.formats.aligned import plan_aligned
    from sparse_matrix_tpu.ops.spmv import spmv_aligned
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    A = poisson_2d_csr(24, dtype=np.float32)
    rng = np.random.default_rng(12)
    x = rng.standard_normal(A.cols).astype(np.float32)
    plan = plan_aligned(A)
    y = np.asarray(spmv_aligned(plan, x))
    np.testing.assert_allclose(y, spmv_oracle(A, x).astype(np.float32), rtol=1e-4, atol=1e-4)

    B, b = _rand_csr(rng, 300, 260, 0.05)
    xb = rng.standard_normal(260).astype(np.float32)
    yb = np.asarray(spmv_aligned(plan_aligned(B), xb))
    np.testing.assert_allclose(yb, b @ xb, rtol=1e-4, atol=1e-4)


def test_aligned_spill_engages_when_profitable(tmp_path, monkeypatch):
    # force the spill to win by making the aligned slab cost huge relative
    # to the general kernel (autotune-driven decision)
    import json

    from sparse_matrix_tpu.formats.aligned import plan_aligned
    from sparse_matrix_tpu.ops.spmv import spmv_aligned
    from sparse_matrix_tpu.utils import autotune

    rng = np.random.default_rng(13)
    A, a = _rand_csr(rng, 500, 500, 0.03)
    p = tmp_path / "autotune.json"
    monkeypatch.setenv("SPMX_AUTOTUNE_CACHE", str(p))

    p.write_text(json.dumps({"lanepack_aligned_slab_ns": 1e6}))
    autotune.reset_cache()
    plan_spill = plan_aligned(A, spill_k=32)
    assert plan_spill.spill is not None and plan_spill.spill.nnz > 0

    p.write_text(json.dumps({"lanepack_dense_slab_ns": 1e6}))
    autotune.reset_cache()
    plan_keep = plan_aligned(A, spill_k=32)
    assert plan_keep.spill is None
    autotune.reset_cache()

    x = rng.standard_normal(500).astype(np.float32)
    ref = a @ x
    np.testing.assert_allclose(np.asarray(spmv_aligned(plan_spill, x)), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(spmv_aligned(plan_keep, x)), ref, rtol=1e-4, atol=1e-4)


def test_operator_aligned_force_and_plan_roundtrip(tmp_path):
    from sparse_matrix_tpu.ops.operator import (
        SpmvOperator,
        load_operator_plan,
        save_operator_plan,
    )
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    A = poisson_2d_csr(16, dtype=np.float32)
    op = SpmvOperator(A, force="aligned")
    assert op.format == "aligned"
    rng = np.random.default_rng(14)
    x = rng.standard_normal(A.cols).astype(np.float32)
    ref = spmv_oracle(A, x).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op(x)), ref, rtol=1e-4, atol=1e-4)
    pth = str(tmp_path / "ali.npz")
    save_operator_plan(op, pth)
    op2 = load_operator_plan(pth)
    assert op2.format == "aligned"
    np.testing.assert_allclose(np.asarray(op2(x)), ref, rtol=1e-4, atol=1e-4)


def test_aligned_segments_beyond_smem_budget(monkeypatch):
    # plans over the scalar-prefetch budget split into uniform segments
    import sparse_matrix_tpu.ops.spmv as sp
    from sparse_matrix_tpu.formats.aligned import plan_aligned
    from sparse_matrix_tpu.ops.spmv import aligned_device_arrays, spmv_aligned
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    A = poisson_2d_csr(48, dtype=np.float32)
    plan = plan_aligned(A)
    monkeypatch.setattr(sp, "_SMEM_SLAB_SEGMENT", max(2, plan.num_slabs // 3))
    arrs = aligned_device_arrays(plan)
    assert "segments" in arrs and len(arrs["segments"]) >= 3
    rng = np.random.default_rng(17)
    x = rng.standard_normal(A.cols).astype(np.float32)
    y = np.asarray(spmv_aligned(plan, x, device_arrays=arrs))
    np.testing.assert_allclose(y, spmv_oracle(A, x).astype(np.float32), rtol=1e-4, atol=1e-4)


def test_operator_as_pytree_apply_matches_call():
    """op.apply(op.as_pytree(), x) under jit-with-params-as-argument must
    match op(x) for every format (the large-operator pattern: arrays as
    runtime operands, not 84 MB program constants)."""
    import jax
    import numpy as np

    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats import CsrMatrix
    from sparse_matrix_tpu.ops.operator import SpmvOperator
    from sparse_matrix_tpu.solvers import poisson_2d_csr
    from sparse_matrix_tpu.solvers.cg import cg_solve

    rng = np.random.default_rng(0)
    p = poisson_2d_csr(16, dtype=np.float32)
    g = CsrMatrix.from_dok(DokMatrix.from_dense(
        ((rng.random((300, 300)) < 0.03) * rng.standard_normal((300, 300))).astype(np.float32)
    ))
    skew = ((rng.random((200, 200)) < 0.01) * rng.standard_normal((200, 200)))
    skew[3, :] = rng.standard_normal(200)  # dense row -> ELL + spill
    sk = CsrMatrix.from_dok(DokMatrix.from_dense(skew.astype(np.float32)))
    cases = [(p, f) for f in ("dia", "aligned", "lanepack", "ell")] + [
        (g, None), (sk, "ell"),
    ]
    for m, force in cases:
        op = SpmvOperator(m, force=force)
        params = op.as_pytree()
        x = rng.standard_normal(m.cols).astype(np.float32)
        ref = np.asarray(op(x))
        y = np.asarray(jax.jit(lambda pp, v: op.apply(pp, v))(params, x))
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6, err_msg=str(force))

    # the intended composition: a full CG solve with params as an argument
    op = SpmvOperator(p, force="dia")
    params = op.as_pytree()
    b = rng.standard_normal(p.rows).astype(np.float32)
    res = jax.jit(
        lambda pp, bb: cg_solve(lambda v: op.apply(pp, v), bb, tol=1e-5, maxiter=500)
    )(params, b)
    x = np.asarray(res.x, dtype=np.float64)
    assert np.linalg.norm(p.to_dense().astype(np.float64) @ x - b) < 1e-4 * np.linalg.norm(b)


def test_wide_operator_column_splits(monkeypatch):
    """cols beyond the VMEM x budget: the operator column-splits into
    shards and sums partial applies (call, matmat, and the as_pytree/apply
    jit-argument path all agree with dense)."""
    import jax
    import numpy as np

    import sparse_matrix_tpu.ops.spmv as spmv_mod
    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats import CsrMatrix
    from sparse_matrix_tpu.ops import operator as op_mod

    monkeypatch.setattr(spmv_mod, "_VMEM_X_LIMIT", 200)  # force the split
    rng = np.random.default_rng(0)
    dense = ((rng.random((150, 640)) < 0.05) * rng.standard_normal((150, 640))).astype(np.float32)
    m = CsrMatrix.from_dok(DokMatrix.from_dense(dense))
    op = op_mod.SpmvOperator(m, dtype=np.float32)
    assert op.format == "colsplit" and len(op._colsplit) == 4
    monkeypatch.undo()  # the tiny limit is only for plan construction
    x = rng.standard_normal(640).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op(x)), dense @ x, rtol=1e-4, atol=1e-5)
    X = rng.standard_normal((640, 3)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op.matmat(X)), dense @ X, rtol=1e-4, atol=1e-4)
    params = op.as_pytree()
    y = np.asarray(jax.jit(lambda pp, v: op.apply(pp, v))(params, x))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-4, atol=1e-5)


def test_tall_operator_row_splits(monkeypatch):
    """rows beyond the y-buffer budget: row shards, outputs concatenated;
    a giant general matrix recurses into a row x col grid."""
    import jax
    import numpy as np

    import sparse_matrix_tpu.ops.spmv as spmv_mod
    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats import CsrMatrix
    from sparse_matrix_tpu.ops import operator as op_mod

    monkeypatch.setattr(op_mod, "_ROWS_SPLIT_LIMIT", 100)
    rng = np.random.default_rng(1)
    dense = ((rng.random((350, 120)) < 0.05) * rng.standard_normal((350, 120))).astype(np.float32)
    m = CsrMatrix.from_dok(DokMatrix.from_dense(dense))
    op = op_mod.SpmvOperator(m, dtype=np.float32)
    assert op.format == "rowsplit" and len(op._rowsplit) == 4
    monkeypatch.undo()
    x = rng.standard_normal(120).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op(x)), dense @ x, rtol=1e-4, atol=1e-5)
    X = rng.standard_normal((120, 3)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op.matmat(X)), dense @ X, rtol=1e-4, atol=1e-4)
    params = op.as_pytree()
    y = np.asarray(jax.jit(lambda pp, v: op.apply(pp, v))(params, x))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-4, atol=1e-5)

    # both dimensions over budget: col-split outer, row-split inner
    monkeypatch.setattr(op_mod, "_ROWS_SPLIT_LIMIT", 100)
    monkeypatch.setattr(spmv_mod, "_VMEM_X_LIMIT", 100)
    op2 = op_mod.SpmvOperator(m, dtype=np.float32)
    assert op2.format == "colsplit"
    assert op2._colsplit[0][2].format == "rowsplit"
    monkeypatch.undo()
    np.testing.assert_allclose(np.asarray(op2(x)), dense @ x, rtol=1e-4, atol=1e-5)


def test_smem_rowsplit_for_skewed_scatter():
    """Row-skew + uniform column scatter (the corpus powerlaw_262k class,
    shrunk): LanePack's scalar-prefetch plan exceeds SMEM at full size
    and the aligned plan collapses to fill 0.012 (corpus_r4.out, 0.67
    Gnnz/s). Round 3 row-split into LanePack shards (1.1 Gnnz/s); round 4
    routes the class to the stripe family (multi-level destinations,
    4.7+ Gnnz/s measured — experiments/stripe_bench_v2.out). The
    dispatcher must land on one of those two, never the collapsed plan."""
    import jax.numpy as jnp

    from sparse_matrix_tpu.bench.corpus import _power_law_rows
    from sparse_matrix_tpu.ops.operator import SpmvOperator

    rng = np.random.default_rng(7)
    m = _power_law_rows(rng, 1 << 18, 16)
    m32 = CsrMatrix(
        m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
        is_sorted=m.is_sorted,
    )
    op = SpmvOperator(m32)
    assert op.format in ("stripe", "rowsplit")
    if op.format == "rowsplit":
        assert all(s.format == "lanepack" for _lo, _hi, s in op._rowsplit)
    x = rng.standard_normal(m.cols).astype(np.float32)
    y = np.asarray(op(jnp.asarray(x)))
    ref = np.zeros(m.rows, np.float64)
    np.add.at(
        ref, m.row_ids(),
        m.vals.astype(np.float64) * x[m.indices.astype(np.int64)],
    )
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-4


def test_aligned_cost_floor_keeps_randlocal_off_bell():
    """The locality-aware per-chunk floor must NOT misroute randlocal to
    BELL (measured loser: 12.4 vs aligned 15.6 Gnnz/s — calibration
    points in utils/autotune.py). Round 5: the refit stripe constants
    legitimately route this class into the stripe family (scan 16.3 /
    select 17.9 measured on the 262k variant, skew_dispatch_r5b.out), so
    the pinned contract is the CLASS of winners, not one format."""
    from sparse_matrix_tpu.bench.corpus import _random_local
    from sparse_matrix_tpu.ops.operator import SpmvOperator

    rng = np.random.default_rng(0)
    m = _random_local(rng, 1 << 16, 16, 3840)
    m32 = CsrMatrix(
        m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
        is_sorted=m.is_sorted,
    )
    assert SpmvOperator(m32).format in ("aligned", "stripe")

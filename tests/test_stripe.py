"""Stripe (multi-level destination) SpMV: plan invariants + kernel parity.

The format exists to break the (row block x column window) cell-occupancy
fill bound on scattered matrices (VERDICT r3 #1); see formats/stripe.py.
spmv_stripe evaluates the plan with XLA on every backend; tests/test_gpu.py
checks it on the card.
"""

import numpy as np
import pytest

from sparse_matrix_tpu.formats.csr import CsrMatrix
from sparse_matrix_tpu.formats.stripe import (
    StripePlan, count_stripe_slabs, plan_stripe,
)
from sparse_matrix_tpu.ops.spmv import spmv_oracle, spmv_stripe


def _rand_csr(rng, rows, cols, per_row, band=None, skew=False):
    if skew:
        lens = np.minimum(
            (rng.pareto(1.5, rows) + 1) * per_row / 3, rows).astype(np.int64)
        r = np.repeat(np.arange(rows), lens)
        c = rng.integers(0, cols, len(r))
    else:
        r = np.repeat(np.arange(rows, dtype=np.int64), per_row)
        if band:
            c = np.clip(r + rng.integers(-band, band + 1, len(r)), 0, cols - 1)
        else:
            c = rng.integers(0, cols, len(r))
    v = rng.standard_normal(len(r))
    return CsrMatrix.from_coo(rows, cols, r, c, v)


@pytest.mark.parametrize("mode", ["scan", "select"])
@pytest.mark.parametrize("levels,kw", [(1, 1), (2, 1), (4, 2), (8, 4), (2, 8)])
def test_stripe_parity_banded_random(levels, kw, mode):
    rng = np.random.default_rng(levels * 10 + kw)
    m = _rand_csr(rng, 1500, 1500, 12, band=400)
    plan = plan_stripe(m, levels=levels, kw=kw, mode=mode)
    assert plan.levels == levels and plan.mode == mode
    if mode == "scan":
        assert plan.kw == kw  # select reports the chunk-span gather width
    x = rng.standard_normal(1500).astype(np.float32)
    y = np.asarray(spmv_stripe(plan, x))
    ref = spmv_oracle(m, x)
    np.testing.assert_allclose(y, ref, rtol=0, atol=3e-5 * max(
        1.0, np.abs(ref).max()))


def test_stripe_parity_shapes_and_auto():
    rng = np.random.default_rng(3)
    for rows, cols, pr, band, skew in [
        (517, 901, 3, None, False),
        (64, 64, 2, None, False),
        (1, 7, 3, None, False),
        (300, 5, 2, None, False),
        (1024, 2048, 6, None, True),
        (257, 129, 1, 60, False),
    ]:
        m = _rand_csr(rng, rows, cols, pr, band=band, skew=skew)
        plan = plan_stripe(m)
        x = rng.standard_normal(cols).astype(np.float32)
        y = np.asarray(spmv_stripe(plan, x))
        ref = spmv_oracle(m, x)
        np.testing.assert_allclose(
            y, ref, rtol=0, atol=3e-5 * max(1.0, np.abs(ref).max()),
            err_msg=f"{rows}x{cols} L={plan.levels} kw={plan.kw}")


def test_stripe_fill_beats_cell_bound_on_scatter():
    # the reason the format exists: multi-level chunks must lift fill well
    # past the single-cell bound on banded-random (expander) structure
    rng = np.random.default_rng(0)
    m = _rand_csr(rng, 1 << 15, 1 << 15, 16, band=4096)
    single = plan_stripe(m, levels=1, kw=1)
    multi = plan_stripe(m, levels=4, kw=4)
    assert single.fill < 0.3
    assert multi.fill > 2.0 * single.fill
    assert multi.num_slabs < 0.5 * single.num_slabs


def test_stripe_empty_and_dense_rows():
    rng = np.random.default_rng(1)
    # empty rows, a dense row, duplicate-free CSR
    r = np.r_[np.zeros(200, np.int64), np.full(300, 700, np.int64),
              rng.integers(0, 1000, 500)]
    c = np.r_[rng.integers(0, 1000, 200), np.arange(300, dtype=np.int64),
              rng.integers(0, 1000, 500)]
    v = rng.standard_normal(len(r))
    m = CsrMatrix.from_coo(1000, 1000, r, c, v)
    plan = plan_stripe(m, levels=4, kw=2)
    x = rng.standard_normal(1000).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(spmv_stripe(plan, x)), spmv_oracle(m, x),
        rtol=0, atol=3e-5 * 40)


def test_stripe_zero_matrix():
    m = CsrMatrix.from_coo(64, 64, np.zeros(0, np.int64),
                           np.zeros(0, np.int64), np.zeros(0))
    plan = plan_stripe(m)
    y = np.asarray(spmv_stripe(plan, np.ones(64, np.float32)))
    assert np.all(y == 0)


def test_stripe_count_matches_plan():
    rng = np.random.default_rng(5)
    m = _rand_csr(rng, 3000, 3000, 10, band=500)
    for L, KW in [(1, 1), (2, 2), (4, 1), (8, 2)]:
        assert count_stripe_slabs(m, L, KW) == plan_stripe(
            m, levels=L, kw=KW).num_slabs


def test_operator_force_stripe():
    import jax.numpy as jnp

    from sparse_matrix_tpu.ops.operator import SpmvOperator

    rng = np.random.default_rng(8)
    m = _rand_csr(rng, 2000, 2000, 10, band=300)
    op = SpmvOperator(m, force="stripe")
    assert op.format == "stripe"
    x = rng.standard_normal(2000).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(op(jnp.asarray(x))), spmv_oracle(m, x),
        rtol=0, atol=3e-5 * 40)
    # as_pytree/apply round-trip (operators as jit arguments)
    import jax

    params = op.as_pytree()
    y2 = jax.jit(lambda pp, xx: op.apply(pp, xx))(params, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y2), spmv_oracle(m, x),
                               rtol=0, atol=3e-5 * 40)
    # matmat per-column loop
    X = rng.standard_normal((2000, 3)).astype(np.float32)
    Y = np.asarray(op.matmat(jnp.asarray(X)))
    for j in range(3):
        np.testing.assert_allclose(Y[:, j], spmv_oracle(m, X[:, j]),
                                   rtol=0, atol=3e-5 * 40)
    assert op.bytes_per_apply() > 0


def test_select_mode_spill_through_operator_and_saveload():
    import tempfile, os

    import jax
    import jax.numpy as jnp

    from sparse_matrix_tpu.ops.operator import (
        SpmvOperator, load_operator_plan, save_operator_plan,
    )

    rng = np.random.default_rng(2)
    m = _rand_csr(rng, 3000, 3000, 6)
    # force a select plan (collisions guaranteed at this density)
    op = SpmvOperator(m, force="stripe")
    op._stripe = plan_stripe(m, mode="select", levels=8, kw=8)
    from sparse_matrix_tpu.ops.spmv import stripe_device_arrays

    op._stripe_arrs = stripe_device_arrays(op._stripe)
    assert op._stripe.spill is not None and op._stripe.spill.nnz > 0
    x = rng.standard_normal(3000).astype(np.float32)
    ref = spmv_oracle(m, x)
    atol = 3e-5 * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(np.asarray(op(jnp.asarray(x))), ref,
                               rtol=0, atol=atol)
    params = op.as_pytree()
    y = jax.jit(lambda pp, xx: op.apply(pp, xx))(params, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=atol)
    f = tempfile.mktemp(suffix=".npz")
    try:
        save_operator_plan(op, f)
        op2 = load_operator_plan(f)
        assert op2._stripe.mode == "select"
        assert op2._stripe.spill is not None
        np.testing.assert_allclose(np.asarray(op2(jnp.asarray(x))), ref,
                                   rtol=0, atol=atol)
    finally:
        os.unlink(f)

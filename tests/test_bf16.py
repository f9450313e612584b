"""bf16 value-plane storage + mixed-precision refinement CG.

The DIA band planes / BELL slot value planes are the dominant HBM stream
of their applies; ``values_dtype=bfloat16`` stores them half-width and
the applies widen them, accumulating in the x dtype (f32). The GPU runs
the same XLA programs (tests/test_gpu.py checks them on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sparse_matrix_tpu.formats.dia import try_dia_from_csr
from sparse_matrix_tpu.ops.operator import SpmvOperator
from sparse_matrix_tpu.ops.spmv import spmv_oracle
from sparse_matrix_tpu.ops.spmv_dia import dia_device_arrays, spmv_dia
from sparse_matrix_tpu.solvers import cg_solve, cg_solve_ir, poisson_2d_csr

BF16_EPS = 2.0 ** -8  # ml_dtypes.bfloat16 epsilon / 2 = unit roundoff 2^-9


def _scaled_poisson(n: int, seed: int = 0):
    """D A D for diagonal D with random positive entries: SPD, banded,
    values NOT exactly representable in bf16 (unlike the {-1, 4} stencil),
    so the half-width storage genuinely rounds."""
    a = poisson_2d_csr(n, dtype=np.float64)
    rng = np.random.default_rng(seed)
    d = (0.5 + rng.random(a.rows)).astype(np.float64)
    vals = a.vals * d[a.row_ids()] * d[a.indices.astype(np.int64)]
    from sparse_matrix_tpu.formats.csr import CsrMatrix

    return CsrMatrix(
        a.rows, a.cols, vals.astype(np.float32), a.indices, a.offsets,
        is_sorted=a.is_sorted,
    )


def test_dia_bf16_parity():
    a = _scaled_poisson(24)
    dia = try_dia_from_csr(a, dtype=np.float32)
    assert dia is not None
    rng = np.random.default_rng(1)
    x = rng.standard_normal(a.cols).astype(np.float32)
    arrs16 = dia_device_arrays(dia, values_dtype=jnp.bfloat16)
    assert arrs16["data"].dtype == jnp.bfloat16
    y16 = np.asarray(spmv_dia(dia, x, device_arrays=arrs16))
    assert y16.dtype == np.float32
    y_ref = spmv_oracle(a, x.astype(np.float64))
    # per-entry: |y16 - y| <= bf16 roundoff on each value * row sum
    scale = np.abs(a.to_dense().astype(np.float64)) @ np.abs(x.astype(np.float64))
    assert (np.abs(y16 - y_ref) <= 4 * BF16_EPS * scale + 1e-6).all()
    # and the rounding is actually visible (vs the f32 path)
    y32 = np.asarray(spmv_dia(dia, x, device_arrays=dia_device_arrays(dia)))
    assert np.abs(y16 - y_ref).max() > np.abs(y32 - y_ref).max()


def test_dia_bf16_exact_for_representable_stencil():
    """{-1, 4} is exact in bf16: the Poisson operator's bf16 planes are
    bit-identical to f32 and so is the SpMV."""
    a = poisson_2d_csr(16, dtype=np.float32)
    dia = try_dia_from_csr(a, dtype=np.float32)
    x = np.random.default_rng(2).standard_normal(a.cols).astype(np.float32)
    y16 = np.asarray(
        spmv_dia(dia, x, device_arrays=dia_device_arrays(dia, values_dtype=jnp.bfloat16))
    )
    y32 = np.asarray(spmv_dia(dia, x, device_arrays=dia_device_arrays(dia)))
    np.testing.assert_array_equal(y16, y32)


def test_bell_bf16_spmv_and_spmm_parity():
    from sparse_matrix_tpu.formats.bell import plan_bell
    from sparse_matrix_tpu.ops.spmm import spmm_bell
    from sparse_matrix_tpu.ops.spmv_bell import bell_device_arrays, spmv_bell

    a = _scaled_poisson(16, seed=3)
    plan = plan_bell(a)
    assert plan.num_layers > 0
    arrs16 = bell_device_arrays(plan, values_dtype=jnp.bfloat16)
    assert arrs16["vals"].dtype == jnp.bfloat16
    rng = np.random.default_rng(4)
    x = rng.standard_normal(a.cols).astype(np.float32)
    y16 = np.asarray(spmv_bell(plan, x, device_arrays=arrs16))
    y_ref = spmv_oracle(a, x.astype(np.float64))
    scale = np.abs(a.to_dense().astype(np.float64)) @ np.abs(x.astype(np.float64))
    assert (np.abs(y16 - y_ref) <= 4 * BF16_EPS * scale + 1e-6).all()

    xs = rng.standard_normal((a.cols, 8)).astype(np.float32)
    ys = np.asarray(spmm_bell(plan, xs, device_arrays=arrs16))
    ys_ref = np.stack(
        [spmv_oracle(a, xs[:, j].astype(np.float64)) for j in range(8)], axis=1
    )
    scales = np.abs(a.to_dense().astype(np.float64)) @ np.abs(xs.astype(np.float64))
    assert (np.abs(ys - ys_ref) <= 4 * BF16_EPS * scales + 1e-6).all()


def test_operator_values_dtype_dispatch():
    # banded -> dia with bf16 planes
    a = poisson_2d_csr(16, dtype=np.float32)
    op = SpmvOperator(a, values_dtype=jnp.bfloat16)
    assert op.format in ("dia", "hybrid")
    x = np.random.default_rng(5).standard_normal(a.cols).astype(np.float32)
    y = np.asarray(op(x))
    np.testing.assert_allclose(
        y, spmv_oracle(a, x.astype(np.float64)).astype(np.float32),
        rtol=1e-5, atol=1e-5,  # exact stencil: f32-level error
    )
    # forced bell with bf16 planes
    opb = SpmvOperator(a, force="bell", values_dtype=jnp.bfloat16)
    yb = np.asarray(opb(x))
    np.testing.assert_allclose(y, yb, rtol=1e-5, atol=1e-5)
    # non-streaming formats refuse (no silent f32 masquerade)
    with pytest.raises(ValueError, match="values_dtype"):
        SpmvOperator(a, force="aligned", values_dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="values_dtype"):
        SpmvOperator(a, force="lanepack", values_dtype=jnp.bfloat16)


def test_cg_solve_ir_converges_where_bf16_cg_stalls():
    a = _scaled_poisson(24, seed=6)
    op_hi = SpmvOperator(a, force="dia")
    op_lo = SpmvOperator(a, force="dia", values_dtype=jnp.bfloat16)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(a.rows).astype(np.float32)
    bn = np.linalg.norm(b)

    res = cg_solve_ir(op_hi, op_lo, b, tol=1e-5, maxiter=4000)
    true_r = np.linalg.norm(
        b.astype(np.float64) - spmv_oracle(a, np.asarray(res.x, np.float64))
    )
    assert float(res.residual_norm) <= 1e-5 * bn
    # the reported norm is an honest true residual (recomputed via A_hi)
    assert true_r <= 3e-5 * bn

    # plain CG on the bf16 operator alone cannot reach that accuracy:
    # its recurrence converges to the ROUNDED operator's solution
    res_lo = cg_solve(op_lo, b, tol=1e-5, maxiter=4000)
    true_r_lo = np.linalg.norm(
        b.astype(np.float64) - spmv_oracle(a, np.asarray(res_lo.x, np.float64))
    )
    assert true_r_lo > 10 * true_r


def test_cg_solve_ir_zero_rhs():
    a = poisson_2d_csr(8, dtype=np.float32)
    op = SpmvOperator(a, force="dia")
    op16 = SpmvOperator(a, force="dia", values_dtype=jnp.bfloat16)
    res = cg_solve_ir(op, op16, np.zeros(a.rows, np.float32), tol=1e-5)
    assert int(res.iterations) == 0
    assert float(np.abs(np.asarray(res.x)).max()) == 0.0


def test_amg_pcg_bf16_hierarchy():
    """bf16 value planes in the V-cycle (preconditioner-grade), f32 outer
    operator: converges to the same working-precision tolerance with a
    comparable iteration count."""
    from sparse_matrix_tpu.solvers.amg import amg_pcg_solve, amg_setup

    a = _scaled_poisson(24, seed=8)
    b = np.random.default_rng(9).standard_normal(a.rows).astype(np.float32)
    h32 = amg_setup(a, coarse_size=60)
    h16 = amg_setup(a, coarse_size=60, values_dtype=jnp.bfloat16)
    assert h16.outer_a_op is not None and h32.outer_a_op is None
    r32 = amg_pcg_solve(a, b, tol=1e-6, maxiter=100, hierarchy=h32)
    r16 = amg_pcg_solve(a, b, tol=1e-6, maxiter=100, hierarchy=h16)
    bn = np.linalg.norm(b)
    assert float(r32.residual_norm) <= 1e-6 * bn
    assert float(r16.residual_norm) <= 1e-6 * bn
    # the true residual is honest (outer matvec is f32, not the rounded op)
    tr = np.linalg.norm(
        b.astype(np.float64) - spmv_oracle(a, np.asarray(r16.x, np.float64))
    )
    assert tr <= 1e-5 * bn
    # preconditioner degradation is mild
    assert int(r16.iterations) <= int(r32.iterations) + 10


def test_ic_pcg_bf16_sweeps():
    """bf16 value planes on the IC(0) factor sweeps (preconditioner-
    grade): PCG still converges to working tolerance with a comparable
    iteration count, and the reported residual is the true f32 one."""
    from sparse_matrix_tpu.solvers.ilu import ic_pcg_solve

    a = _scaled_poisson(24, seed=10)
    b = np.random.default_rng(11).standard_normal(a.rows).astype(np.float32)
    bn = np.linalg.norm(b)
    r32 = ic_pcg_solve(a, b, sweeps=2, tol=1e-6, maxiter=400)
    r16 = ic_pcg_solve(a, b, sweeps=2, tol=1e-6, maxiter=400,
                       values_dtype=jnp.bfloat16)
    assert float(r32.residual_norm) <= 1e-6 * bn
    assert float(r16.residual_norm) <= 1e-6 * bn
    tr = np.linalg.norm(
        b.astype(np.float64) - spmv_oracle(a, np.asarray(r16.x, np.float64))
    )
    assert tr <= 1e-5 * bn
    assert int(r16.iterations) <= int(r32.iterations) + 10

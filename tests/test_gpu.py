"""Parity tests on the GPU: the library's compiled paths against float64
host oracles. Every test here needs a GPU and skips elsewhere;
``python chip_smoke.py`` runs them on the card, in its own process:

    SPMX_GPU_TESTS=1 python -m pytest tests/test_gpu.py -m gpu

Tolerances: f32 results within 1e-5 of ``|A||x|`` (a TF32-rounded product,
2^-11, would fail them); bf16 value planes within 2^-8; solvers against
the requested tolerance; scatter-add order varies between runs, so no
comparison is bitwise.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparse_matrix_tpu.core import DokMatrix
from sparse_matrix_tpu.formats import CsrMatrix
from sparse_matrix_tpu.ops.operator import SpmvOperator
from sparse_matrix_tpu.solvers import poisson_2d_csr

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]

TOL_F32 = 1e-5
TOL_BF16 = 2.0 ** -8


def _rand_csr(rng, rows, cols, density):
    a = (rng.random((rows, cols)) < density) * rng.standard_normal((rows, cols))
    a = a.astype(np.float32)
    return CsrMatrix.from_dok(DokMatrix.from_dense(a)), a


def _check(a_dense, x, y, tol):
    a64 = np.asarray(a_dense, np.float64)
    x64 = np.asarray(x, np.float64)
    scale = np.abs(np.abs(a64) @ np.abs(x64)).max()
    err = np.abs(np.asarray(y, np.float64) - a64 @ x64).max()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("force", [None, "aligned", "lanepack", "bell", "stripe", "ell", "hybrid"])
def test_operator_format_parity(force):
    rng = np.random.default_rng(1)
    # banded core + scattered residual: every format (and the hybrid
    # split) has work to do
    n = 3000
    rows = np.arange(n, dtype=np.int64)[:, None]
    c = np.concatenate([rows + np.array([-60, -1, 0, 1, 60]),
                        rows + rng.integers(-900, 900, (n, 4))], axis=1)
    c = np.clip(c, 0, n - 1).ravel()
    r = np.repeat(np.arange(n, dtype=np.int64), 9)
    m = CsrMatrix.from_coo(n, n, r, c, rng.standard_normal(len(r)).astype(np.float32))
    op = SpmvOperator(m, force=force)
    dense = m.to_dense()
    x = rng.standard_normal(n).astype(np.float32)
    _check(dense, x, op(jnp.asarray(x)), TOL_F32)
    xk = rng.standard_normal((n, 8)).astype(np.float32)
    _check(dense, xk, op.matmat(jnp.asarray(xk)), TOL_F32)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_dia_2048_parity(tag):
    """Poisson 2048^2 (84 MB of f32 band data) through SpmvOperator."""
    import scipy.sparse as sp

    a = poisson_2d_csr(2048, dtype=np.float32)
    op = SpmvOperator(a, values_dtype=jnp.bfloat16 if tag == "bf16" else None)
    assert op.format == "dia"
    rng = np.random.default_rng(2)
    x = rng.standard_normal(a.cols)
    a_sp = sp.csr_matrix((a.vals.astype(np.float64), a.indices, a.offsets),
                         shape=(a.rows, a.cols))
    y = np.asarray(op(jnp.asarray(x, jnp.float32)), np.float64)
    x32 = np.asarray(x, np.float32).astype(np.float64)
    err = np.abs(y - a_sp @ x32).max()
    scale = np.abs(abs(a_sp) @ np.abs(x32)).max()
    assert err <= (TOL_BF16 if tag == "bf16" else TOL_F32) * scale


def test_cg_and_amg_pcg():
    from sparse_matrix_tpu.solvers import amg_pcg_solve, amg_setup, cg_solve

    a = poisson_2d_csr(256, dtype=np.float32)
    rng = np.random.default_rng(4)
    b = rng.standard_normal(a.rows).astype(np.float32)
    dense = a.to_dense().astype(np.float64)
    op = SpmvOperator(a)
    res = jax.jit(lambda bb: cg_solve(op, bb, tol=1e-5, maxiter=5000))(b)
    assert float(res.residual_norm) <= 1e-5 * np.linalg.norm(b) * 1.01
    eps_cond = np.finfo(np.float32).eps * (1 / np.tan(np.pi / (2 * 257))) ** 2
    x = np.asarray(res.x, np.float64)
    assert np.linalg.norm(b - dense @ x) <= (1e-5 + eps_cond) * np.linalg.norm(b)

    h = amg_setup(a)
    res = amg_pcg_solve(a, jnp.asarray(b), tol=1e-5, maxiter=200, hierarchy=h)
    assert int(res.iterations) <= 60
    x = np.asarray(res.x, np.float64)
    assert np.linalg.norm(b - dense @ x) <= (1e-5 + eps_cond) * np.linalg.norm(b)


def test_block_amg_pcg():
    """Block V-cycle + pcg_solve_multi (the level operators' packed SpMM)."""
    from sparse_matrix_tpu.solvers import amg_pcg_solve, amg_setup

    a = poisson_2d_csr(48, dtype=np.float32)
    rng = np.random.default_rng(23)
    b = rng.standard_normal((a.rows, 4)).astype(np.float32)
    hier = amg_setup(a, coarse_size=120, dtype=np.float32)
    res = jax.jit(
        lambda bb: amg_pcg_solve(a, bb, tol=1e-6, maxiter=60, hierarchy=hier)
    )(b)
    assert int(res.iterations) <= 25
    dense = a.to_dense().astype(np.float64)
    x = np.asarray(res.x, np.float64)
    for j in range(4):
        assert np.linalg.norm(dense @ x[:, j] - b[:, j]) < 5e-4 * np.linalg.norm(b[:, j])


def test_spgemm_engines_parity():
    from sparse_matrix_tpu.ops.device_sorted import EscSpgemm
    from sparse_matrix_tpu.ops.spgemm_block import (
        BlockSpgemm, spgemm_block_device, spgemm_dense_xla,
    )

    rng = np.random.default_rng(5)
    a, ad = _rand_csr(rng, 384, 384, 0.05)
    ref = ad.astype(np.float64) @ ad.astype(np.float64)
    bound = np.abs(ad).astype(np.float64) @ np.abs(ad).astype(np.float64)
    for name, c in (
        ("block", spgemm_block_device(a, a)),
        ("block-amortized", BlockSpgemm(a, a).multiply()),
        ("esc-kmajor", EscSpgemm(a, a, reduce="sort").multiply()),
        ("esc-xla", EscSpgemm(a, a, engine="xla").multiply()),
        ("dense", spgemm_dense_xla(a, a)),
    ):
        err = np.abs(c.to_dense().astype(np.float64) - ref)
        assert (err <= 1e-5 * bound + 1e-30).all(), name


def test_spmm_bcsr_full_f32_precision():
    """BCSR SpMM at HIGHEST precision: operands with more significand bits
    than TF32 keeps must survive the block products."""
    from sparse_matrix_tpu.formats.bcsr import BsrMatrix
    from sparse_matrix_tpu.ops.spmm import spmm_bcsr

    rng = np.random.default_rng(6)
    a, ad = _rand_csr(rng, 256, 256, 0.08)
    x = (1.0 + rng.random((256, 16)) * 2.0 ** -12).astype(np.float32)
    y = np.asarray(spmm_bcsr(BsrMatrix.from_csr(a, 128), x))
    _check(ad, x, y, TOL_F32)


def test_preconditioned_and_batched_solvers():
    """IC(0)-PCG, Chebyshev, batched CG, the traced complex operator and
    svds on the card."""
    from sparse_matrix_tpu.ops import BatchedEllOperator, ComplexSpmvOperator, batched_cg_solve
    from sparse_matrix_tpu.solvers import chebyshev_solve, ic_pcg_solve, svds_csr

    rng = np.random.default_rng(0)
    p = poisson_2d_csr(48, dtype=np.float32)
    b = rng.standard_normal(p.rows).astype(np.float32)
    dense64 = p.to_dense().astype(np.float64)

    res = ic_pcg_solve(p, b, sweeps=4, tol=1e-5, maxiter=2000)
    x = np.asarray(res.x, dtype=np.float64)
    assert np.linalg.norm(dense64 @ x - b) < 1e-4 * np.linalg.norm(b)

    op = SpmvOperator(p, dtype=np.float32)
    resc = chebyshev_solve(op, b, n=p.rows, tol=1e-5, maxiter=4000)
    xc = np.asarray(resc.x, dtype=np.float64)
    assert np.linalg.norm(dense64 @ xc - b) < 1e-4 * np.linalg.norm(b)

    pat = poisson_2d_csr(12, dtype=np.float32)
    vals = np.stack([pat.vals * s for s in (0.5 + rng.random(32))]).astype(np.float32)
    bop = BatchedEllOperator(pat, vals)
    bm = rng.standard_normal((32, pat.rows)).astype(np.float32)
    bres = batched_cg_solve(bop, bm, tol=1e-5, maxiter=300)
    d7 = CsrMatrix(pat.rows, pat.cols, vals[7], pat.indices, pat.offsets,
                   is_sorted=True).to_dense()
    assert np.linalg.norm(d7 @ np.asarray(bres.x)[7] - bm[7]) < 1e-3 * np.linalg.norm(bm[7])

    mask = rng.random((200, 200)) < 0.04
    dc = mask * (rng.standard_normal((200, 200)) + 1j * rng.standard_normal((200, 200)))
    ac = CsrMatrix.from_dok(DokMatrix.from_dense(dc.astype(np.complex128)))
    copz = ComplexSpmvOperator(ac)
    xcx = (rng.standard_normal(200) + 1j * rng.standard_normal(200)).astype(np.complex64)
    yc = np.asarray(jax.jit(copz)(jnp.asarray(xcx)))
    np.testing.assert_allclose(yc, dc.astype(np.complex64) @ xcx, rtol=1e-4, atol=1e-4)

    dsv = ((rng.random((300, 120)) < 0.05) * rng.standard_normal((300, 120))).astype(np.float64)
    asv = CsrMatrix.from_dok(DokMatrix.from_dense(dsv))
    sv = svds_csr(asv, k=3, steps=30)
    ref = np.linalg.svd(dsv, compute_uv=False)[:3]
    np.testing.assert_allclose(np.asarray(sv.s), ref, rtol=3e-3)


def test_autodiff_grad_through_planned_operator():
    """jax.grad through the planned matvec (custom_vjp routes the
    cotangent through A^T's own plan) and through an implicit CG solve."""
    from sparse_matrix_tpu.ops import differentiable_operator, implicit_solve

    a = poisson_2d_csr(32)
    n = a.rows
    f, _op, _op_t = differentiable_operator(a, force="lanepack")
    d = jnp.asarray(a.to_dense().astype(np.float32))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    b = jnp.ones(n, jnp.float32)

    @jax.jit
    def loss(xx):
        r = f(xx) - b
        return 0.5 * jnp.vdot(r, r)

    g = np.asarray(jax.grad(loss)(x))
    g_ref = np.asarray(jnp.dot(d.T, jnp.dot(d, x, precision="highest") - b,
                               precision="highest"))
    scale = max(1.0, float(np.abs(g_ref).max()))
    np.testing.assert_allclose(g / scale, g_ref / scale, atol=5e-5)

    gb = np.asarray(jax.grad(
        lambda bb: implicit_solve(a, bb, tol=1e-7, maxiter=4000).sum())(b))
    g_ref2 = np.linalg.solve(a.to_dense().astype(np.float64), np.ones(n))
    np.testing.assert_allclose(gb, g_ref2, rtol=5e-3, atol=5e-3)


def test_bf16_value_planes_and_refinement_cg():
    from sparse_matrix_tpu.formats.bell import plan_bell
    from sparse_matrix_tpu.ops.spmv import spmv_oracle
    from sparse_matrix_tpu.ops.spmv_bell import bell_device_arrays, spmv_bell
    from sparse_matrix_tpu.solvers import cg_solve_ir

    rng = np.random.default_rng(11)
    a64 = poisson_2d_csr(64, dtype=np.float64)
    d = (0.5 + rng.random(a64.rows)).astype(np.float64)
    vals = a64.vals * d[a64.row_ids()] * d[a64.indices.astype(np.int64)]
    a = CsrMatrix(a64.rows, a64.cols, vals.astype(np.float32), a64.indices,
                  a64.offsets, is_sorted=a64.is_sorted)
    x = rng.standard_normal(a.cols).astype(np.float32)
    y_ref = spmv_oracle(a, x.astype(np.float64))
    scale = np.abs(y_ref).max()

    plan = plan_bell(a)
    arrs16 = bell_device_arrays(plan, values_dtype=jnp.bfloat16)
    y16 = np.asarray(spmv_bell(plan, x, device_arrays=arrs16))
    assert np.abs(y16 - y_ref).max() / scale < 3e-2

    op_hi = SpmvOperator(a, force="dia")
    op_lo = SpmvOperator(a, force="dia", values_dtype=jnp.bfloat16)
    b = rng.standard_normal(a.rows).astype(np.float32)
    res = cg_solve_ir(op_hi, op_lo, b, tol=1e-5, maxiter=6000)
    assert float(res.residual_norm) <= 1e-5 * np.linalg.norm(b)
    true_r = np.linalg.norm(
        b.astype(np.float64) - spmv_oracle(a, np.asarray(res.x, np.float64)))
    assert true_r <= 1e-4 * np.linalg.norm(b)


def test_gmres_and_coarse_solve_precision():
    """GMRES's Gram-Schmidt products and the AMG coarse solve run at full
    f32 precision on the card (a TF32 Gram matrix loses orthogonality)."""
    from sparse_matrix_tpu.solvers import gmres_solve

    rng = np.random.default_rng(9)
    _a, ad = _rand_csr(rng, 400, 400, 0.02)
    ad = ad + 8.0 * np.eye(400, dtype=np.float32)
    a = CsrMatrix.from_dok(DokMatrix.from_dense(ad))
    b = rng.standard_normal(400).astype(np.float32)
    res = gmres_solve(SpmvOperator(a), b, tol=1e-6, maxiter=400)
    x = np.asarray(res.x, np.float64)
    assert np.linalg.norm(ad.astype(np.float64) @ x - b) <= 1e-5 * np.linalg.norm(b)

    from sparse_matrix_tpu.solvers import amg_pcg_solve, amg_setup

    p = poisson_2d_csr(64, dtype=np.float32)
    bp = rng.standard_normal(p.rows).astype(np.float32)
    h = amg_setup(p, coarse_size=400)
    res = amg_pcg_solve(p, jnp.asarray(bp), tol=1e-6, maxiter=100, hierarchy=h)
    assert int(res.iterations) <= 30

"""Complex-dtype host paths (the reference parses complex MatrixMarket and
its DOK/CSR are generic over T) and remaining protocol surface."""

import numpy as np
import pytest

from sparse_matrix_tpu.core import DokMatrix, parse_matrix_market
from sparse_matrix_tpu.formats import CsrMatrix
from sparse_matrix_tpu.ops import spgemm_esc_host, spgemm_hash_host


def _complex_pair(rng, l, m, n, density=0.2):
    a = (rng.random((l, m)) < density) * (rng.standard_normal((l, m)) + 1j * rng.standard_normal((l, m)))
    b = (rng.random((m, n)) < density) * (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n)))
    return a.astype(np.complex128), b.astype(np.complex128)


def test_complex_spgemm_host_paths():
    rng = np.random.default_rng(0)
    a, b = _complex_pair(rng, 20, 30, 25)
    A = CsrMatrix.from_dok(DokMatrix.from_dense(a))
    B = CsrMatrix.from_dok(DokMatrix.from_dense(b))
    ref = a @ b
    # python hash path (native is real/int only and auto-falls-back)
    c1 = spgemm_hash_host(A, B, output_sorted=True, force_python=True)
    np.testing.assert_allclose(c1.to_dense(), ref, rtol=1e-12)
    c2 = spgemm_esc_host(A, B)
    np.testing.assert_allclose(c2.to_dense(), ref, rtol=1e-12)
    # native dispatcher must fall back, not crash
    c3 = spgemm_hash_host(A, B, output_sorted=True)
    np.testing.assert_allclose(c3.to_dense(), ref, rtol=1e-12)


def test_complex_add_transpose():
    rng = np.random.default_rng(1)
    a, b = _complex_pair(rng, 15, 15, 15)
    A = CsrMatrix.from_dok(DokMatrix.from_dense(a))
    B = CsrMatrix.from_dok(DokMatrix.from_dense(b))
    np.testing.assert_allclose((A + B).to_dense(), a + b)
    np.testing.assert_allclose(A.transpose().to_dense(), a.T)


def test_complex_dok_mul():
    rng = np.random.default_rng(2)
    a, b = _complex_pair(rng, 6, 7, 5, density=0.4)
    da = DokMatrix.from_dense(a)
    db = DokMatrix.from_dense(b)
    np.testing.assert_allclose((da * db).to_dense(), a @ b, rtol=1e-12)


def test_complex_matrix_market_roundtrip_via_parse():
    text = "%%MatrixMarket matrix coordinate complex general\n2 2 2\n1 1 1.5 2.5\n2 2 -1.0 0.5\n"
    m = parse_matrix_market(text).matrix
    assert m.get_element((0, 0)) == 1.5 + 2.5j
    p = m * m
    assert p.get_element((0, 0)) == (1.5 + 2.5j) ** 2


def test_new_square():
    m = CsrMatrix.new_square(5, dtype=np.float32)
    assert m.shape == (5, 5)
    d = DokMatrix.new_square(4, dtype=np.int8)
    assert d.shape == (4, 4)


def test_matmul_operator_unsorted_output():
    # `&CsrMatrix * &CsrMatrix` yields unsorted output in the reference
    # (spam_csr/src/lib.rs:292-297); our @ mirrors that
    rng = np.random.default_rng(3)
    a = (rng.random((10, 10)) < 0.3) * rng.standard_normal((10, 10))
    A = CsrMatrix.from_dok(DokMatrix.from_dense(a))
    C = A @ A
    assert not C.is_sorted
    assert C.invariants()
    np.testing.assert_allclose(C.to_dense(), a @ a, rtol=1e-12)


def test_complex_device_operator_matches_dense():
    """ComplexSpmvOperator: device apply via two real K=2 SpMMs."""
    import numpy as np

    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats import CsrMatrix
    from sparse_matrix_tpu.ops import ComplexSpmvOperator

    rng = np.random.default_rng(0)
    n = 120
    mask = rng.random((n, n)) < 0.05
    d = mask * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    np.fill_diagonal(d, d.diagonal() + 3.0)
    a = CsrMatrix.from_dok(DokMatrix.from_dense(d.astype(np.complex128)))
    op = ComplexSpmvOperator(a)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    y = np.asarray(op(x))
    np.testing.assert_allclose(y, d.astype(np.complex64) @ x, rtol=1e-4, atol=1e-4)
    # block apply
    X = (rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))).astype(np.complex64)
    Y = np.asarray(op.matmat(X))
    np.testing.assert_allclose(Y, d.astype(np.complex64) @ X, rtol=1e-4, atol=1e-4)


def test_complex_device_operator_pure_real_skips_imag_part():
    import numpy as np

    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats import CsrMatrix
    from sparse_matrix_tpu.ops import ComplexSpmvOperator

    rng = np.random.default_rng(1)
    d = ((rng.random((40, 40)) < 0.1) * rng.standard_normal((40, 40))).astype(np.complex128)
    a = CsrMatrix.from_dok(DokMatrix.from_dense(d))
    op = ComplexSpmvOperator(a)
    assert op._ai is None
    x = (rng.standard_normal(40) + 1j * rng.standard_normal(40)).astype(np.complex64)
    np.testing.assert_allclose(
        np.asarray(op(x)), d.astype(np.complex64) @ x, rtol=1e-4, atol=1e-4
    )


def test_complex_operator_rejects_real_matrix():
    import numpy as np
    import pytest

    from sparse_matrix_tpu.ops import ComplexSpmvOperator
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    with pytest.raises(ValueError, match="complex values"):
        ComplexSpmvOperator(poisson_2d_csr(4, dtype=np.float32))


def test_complex_hermitian_cg_converges():
    """CG on a Hermitian positive-definite complex system through the
    device operator (cg_solve's vdot handles complex)."""
    import numpy as np

    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats import CsrMatrix
    from sparse_matrix_tpu.ops import ComplexSpmvOperator
    from sparse_matrix_tpu.solvers.cg import cg_solve

    rng = np.random.default_rng(2)
    n = 64
    mask = rng.random((n, n)) < 0.06
    m = mask * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    d = (m + m.conj().T) / 2
    np.fill_diagonal(d, np.abs(d).sum(axis=1).real + 1.0)  # HPD
    a = CsrMatrix.from_dok(DokMatrix.from_dense(d))
    op = ComplexSpmvOperator(a)
    b = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    res = cg_solve(op, b, tol=1e-6, maxiter=500)
    x = np.asarray(res.x)
    assert np.linalg.norm(d @ x - b) < 1e-4 * np.linalg.norm(b)


def test_complex_device_operator_traced_under_jit():
    """The complex operator composes with jitted code: the split/combine
    is traced jnp, so a jitted apply matches the eager one."""
    import jax
    import numpy as np

    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats import CsrMatrix
    from sparse_matrix_tpu.ops import ComplexSpmvOperator

    rng = np.random.default_rng(3)
    n = 96
    d = (rng.random((n, n)) < 0.06) * (
        rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    a = CsrMatrix.from_dok(DokMatrix.from_dense(d.astype(np.complex128)))
    op = ComplexSpmvOperator(a)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    y = np.asarray(jax.jit(lambda v: op(v) * 2.0)(x))
    np.testing.assert_allclose(y, 2.0 * (d.astype(np.complex64) @ x), rtol=1e-4, atol=1e-4)

"""RCM reordering: permutation validity, the matvec identity, bandwidth
recovery on shuffled structured matrices, and a scipy differential check.

New-scope module (no reference counterpart): formats/reorder.py exists so
the locality-dependent fast paths (DIA, aligned) apply to corpora with
arbitrary node numbering.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sparse_matrix_tpu.formats.csr import CsrMatrix
from sparse_matrix_tpu.formats.reorder import (
    bandwidth,
    permute_symmetric,
    rcm_permutation,
    rcm_reordered,
)
from sparse_matrix_tpu.solvers.poisson import poisson_2d_csr
from sparse_matrix_tpu.verify.strategies import dok_fixed_size, finite_f64s


@st.composite
def square_doks(draw, max_size: int = 9):
    n = draw(st.integers(min_value=1, max_value=max_size))
    return draw(dok_fixed_size(n, n, finite_f64s()))


def _random_sym_perm(m, seed=0):
    rng = np.random.default_rng(seed)
    return permute_symmetric(m, rng.permutation(m.rows))


def test_rcm_recovers_poisson_bandwidth():
    a = poisson_2d_csr(64)
    shuffled = _random_sym_perm(a, seed=3)
    assert bandwidth(shuffled) > 1000
    b, p = rcm_reordered(shuffled)
    # 5-point Poisson on a 64-wide grid has optimal bandwidth 64; RCM finds
    # it (scipy's RCM also lands on 64 — see the differential test)
    assert bandwidth(b) <= 130
    assert b.invariants()


def test_rcm_matches_scipy_quality():
    scipy_csgraph = pytest.importorskip("scipy.sparse.csgraph")
    a = _random_sym_perm(poisson_2d_csr(48), seed=7)
    ours = bandwidth(rcm_reordered(a)[0])
    s = a.to_scipy().tocsr()
    ps = scipy_csgraph.reverse_cuthill_mckee(s, symmetric_mode=True)
    theirs = bandwidth(CsrMatrix.from_scipy(s[ps][:, ps].tocsr()))
    assert ours <= 2 * theirs + 8


@settings(max_examples=40, deadline=None)
@given(square_doks())
def test_rcm_permutation_properties(dok):
    m = CsrMatrix.from_dok(dok, dtype=np.float64)
    p = rcm_permutation(m)
    assert sorted(p.tolist()) == list(range(m.rows))
    b = permute_symmetric(m, p)
    assert b.invariants()
    assert b.nnz() == m.nnz()
    # B[i, j] == A[p[i], p[j]]
    rng = np.random.default_rng(0)
    for _ in range(10):
        i, j = int(rng.integers(m.rows)), int(rng.integers(m.cols))
        assert b.get_element((i, j)) == m.get_element((int(p[i]), int(p[j])))
    # matvec identity: B @ x[p] == (A @ x)[p]. Bitwise equality can only be
    # asserted away from the overflow boundary: permuting columns reorders
    # each row sum, and with |a_ij| near DBL_MAX one order overflows to inf
    # while the other stays finite (hypothesis found exactly that case).
    if m.nnz() == 0 or np.max(np.abs(m.vals)) < 1e150:
        x = rng.standard_normal(m.cols)
        ya = m.to_dense() @ x
        yb = b.to_dense() @ x[p]
        np.testing.assert_allclose(yb, ya[p], rtol=1e-12, atol=1e-12)


def test_rcm_disconnected_components():
    # two disjoint path graphs + an isolated vertex
    r = np.array([0, 1, 3, 4, 0, 1, 3, 4])
    c = np.array([1, 2, 4, 5, 0, 1, 3, 4])
    m = CsrMatrix.from_coo(7, 7, r, c, np.ones(8))
    p = rcm_permutation(m)
    assert sorted(p.tolist()) == list(range(7))
    b = permute_symmetric(m, p)
    assert b.nnz() == m.nnz()


def test_rcm_empty_and_diagonal():
    e = CsrMatrix.new(5, 5)
    assert bandwidth(e) == 0
    assert sorted(rcm_permutation(e).tolist()) == list(range(5))
    d = CsrMatrix.identity(6)
    assert bandwidth(d) == 0
    b = permute_symmetric(d, rcm_permutation(d))
    assert b.nnz() == 6


def test_rcm_errors():
    m = CsrMatrix.new(3, 4)
    with pytest.raises(ValueError):
        rcm_permutation(m)
    sq = CsrMatrix.new(3, 3)
    with pytest.raises(ValueError):
        permute_symmetric(sq, np.array([0, 1]))


def test_nd_permutation_fill_beats_rcm():
    """Nested dissection must cut mesh Cholesky fill vs RCM (O(n log n)
    vs O(n^1.5)); permutation validity + exact solve through reorder="nd"."""
    import numpy as np

    from sparse_matrix_tpu.formats import nd_permutation
    from sparse_matrix_tpu.solvers import chol, chol_solve, poisson_2d_csr

    p = poisson_2d_csr(64, dtype=np.float64)
    q = nd_permutation(p)
    assert np.array_equal(np.sort(q), np.arange(p.rows))
    f_nd = chol(p, reorder="nd")
    f_rcm = chol(p, reorder="rcm")
    assert f_nd.l.nnz() < 0.7 * f_rcm.l.nnz(), (f_nd.l.nnz(), f_rcm.l.nnz())
    rng = np.random.default_rng(0)
    b = rng.standard_normal(p.rows)
    x = chol_solve(f_nd, b)
    rid = p.row_ids()
    ax = np.zeros(p.rows)
    np.add.at(ax, rid, p.vals * x[p.indices.astype(np.int64)])
    np.testing.assert_allclose(ax, b, rtol=1e-11, atol=1e-11)


def test_nd_lu_and_ldl_reorder():
    import numpy as np

    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats import CsrMatrix
    from sparse_matrix_tpu.solvers import ldl, ldl_solve, lu, lu_solve, poisson_2d_csr

    rng = np.random.default_rng(1)
    n = 60
    d = (rng.random((n, n)) < 0.15) * rng.standard_normal((n, n))
    d += np.diag(np.sign(rng.standard_normal(n)) * 0.5)
    a = CsrMatrix.from_dok(DokMatrix.from_dense(d))
    b = rng.standard_normal(n)
    x = lu_solve(lu(a, reorder="nd"), b)
    np.testing.assert_allclose(d @ x, b, rtol=1e-9, atol=1e-9)
    p = poisson_2d_csr(12, dtype=np.float64)
    bp = rng.standard_normal(p.rows)
    x = ldl_solve(ldl(p, reorder="nd"), bp)
    np.testing.assert_allclose(p.to_dense() @ x, bp, rtol=1e-10, atol=1e-10)


def test_nd_permutation_disconnected_components():
    """Components BFS never reaches must still be ordered (they join part
    A); permutation validity + factor correctness on a block-diagonal
    pair of meshes."""
    import numpy as np

    from sparse_matrix_tpu.formats import block_diag, nd_permutation
    from sparse_matrix_tpu.solvers import chol, chol_solve, poisson_2d_csr

    a = block_diag([poisson_2d_csr(16, dtype=np.float64),
                    poisson_2d_csr(11, dtype=np.float64)])
    q = nd_permutation(a)
    assert np.array_equal(np.sort(q), np.arange(a.rows))
    rng = np.random.default_rng(2)
    b = rng.standard_normal(a.rows)
    x = chol_solve(chol(a, reorder="nd"), b)
    np.testing.assert_allclose(a.matvec_host(x), b, rtol=1e-11, atol=1e-11)

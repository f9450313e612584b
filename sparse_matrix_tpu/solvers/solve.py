"""One-call ``solve(a, b)`` / ``lstsq(a, b)`` with measured-stack dispatch.

New scope beyond the reference: the "just solve it" entry point a
scipy.sparse.linalg user expects, routing to the framework's own pieces:

* small systems -> one dense device solve (exact; a 2k x 2k dense solve
  costs far less than any iterative setup);
* symmetric (detected or declared): IC(0)-PCG, degrading to Jacobi-PCG if
  the factorization hits a non-positive pivot (not SPD), then to MINRES
  if PCG stagnates (indefinite);
* unsymmetric: ILU(0)-right-preconditioned BiCGStab, degrading to
  GMRES(m) on breakdown/stagnation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["solve", "spsolve", "lstsq", "spsolve_triangular"]

_DENSE_N = 2048


def _is_symmetric(a, tol: float = 0.0) -> bool:
    at = a.transpose()
    if not np.array_equal(a.offsets, at.offsets) or not np.array_equal(
        a.indices, at.indices
    ):
        return False
    if tol == 0.0:
        return bool(np.array_equal(a.vals, at.vals))
    scale = max(1.0, float(np.abs(a.vals).max())) if a.nnz() else 1.0
    return bool(np.abs(a.vals - at.vals).max() <= tol * scale)


def solve(
    a,
    b,
    *,
    symmetric: Optional[bool] = None,
    tol: float = 1e-6,
    maxiter: int = 5000,
    dtype=np.float32,
    method: str = "auto",
):
    """Solve ``A x = b`` for square host-CSR ``A``; returns a
    :class:`~.cg.CgResult` (for the dense path ``iterations`` is 0 and the
    residual norm is computed explicitly).

    ``method="direct"`` forces the exact sparse Cholesky
    (:mod:`~.cholesky`, SPD input required) — f64 host solve, no
    iteration-count/conditioning sensitivity."""
    import jax.numpy as jnp

    from ..ops.operator import SpmvOperator
    from .cg import CgResult, jacobi_preconditioner, pcg_solve
    from .minres import minres_solve

    if a.rows != a.cols:
        raise ValueError("solve needs a square operator; use lstsq")
    if method not in ("auto", "direct"):
        raise ValueError(f"unknown method {method!r} (auto|direct)")
    b = np.asarray(b)

    if method == "direct":
        from .cholesky import chol, chol_solve, ldl, ldl_solve, lu, lu_solve

        if symmetric is None:
            symmetric = _is_symmetric(a, tol=1e-12)
        if not symmetric:
            x = lu_solve(lu(a), b)
        else:
            try:
                x = chol_solve(chol(a), b)
            except ValueError:  # non-positive pivot: symmetric indefinite
                x = ldl_solve(ldl(a), b)
        # x stays host f64: jnp.asarray would silently truncate to f32
        # (jax_enable_x64 off) and throw away the direct solve's exactness
        return CgResult(
            x=x, iterations=jnp.int32(0),
            residual_norm=np.float64(
                np.linalg.norm(a.matvec_host(x) - np.asarray(b, np.float64))
            ),
        )

    if a.rows <= _DENSE_N:
        dense = jnp.asarray(a.to_dense().astype(dtype))
        bj = jnp.asarray(b.astype(dtype))
        x = jnp.linalg.solve(dense, bj)
        r = bj - dense @ x
        return CgResult(
            x=x, iterations=jnp.int32(0),
            residual_norm=jnp.sqrt(jnp.vdot(r, r).real),
        )

    if symmetric is None:
        symmetric = _is_symmetric(a, tol=1e-12)
    op = SpmvOperator(a, dtype=dtype)
    b_norm = float(np.linalg.norm(b))

    if symmetric:
        from .ilu import ic_preconditioner

        try:
            m_inv = ic_preconditioner(a, sweeps=4, dtype=dtype)
        except ValueError:  # non-positive pivot: not SPD-like
            m_inv = jacobi_preconditioner(a)
        res = pcg_solve(op, b, m_inv, tol=tol, maxiter=maxiter)
        if float(res.residual_norm) <= tol * max(b_norm, 1e-30) * 1.01:
            return res
        # PCG stagnated (indefinite operator): MINRES handles it
        return minres_solve(op, b, tol=tol, maxiter=maxiter)

    from .bicgstab import bicgstab_solve
    from .gmres import gmres_solve
    from .ilu import ilu_preconditioner

    try:
        m_inv = ilu_preconditioner(a, sweeps=4, dtype=dtype)
    except ValueError:  # zero pivot on the pattern
        m_inv = None
    res = bicgstab_solve(op, b, tol=tol, maxiter=maxiter, m_inv=m_inv)
    if float(res.residual_norm) <= tol * max(b_norm, 1e-30) * 1.01:
        return res
    return gmres_solve(op, b, tol=tol, maxiter=maxiter, m_inv=m_inv)


def lstsq(a, b, *, tol: float = 1e-8, maxiter: int = 2000, dtype=np.float32,
          method: str = "auto"):
    """Least-squares ``min |A x - b|`` for rectangular host-CSR ``A``
    (LSQR on planned operators for ``A`` and ``A^T``).

    ``method="lsmr"``: LSMR instead — same bidiagonalization, but
    ``|A^T r|`` decreases monotonically (safer early stopping on
    ill-conditioned problems). ``method="direct"``: normal equations
    ``A^T A x = A^T b`` through the framework's SpGEMM + exact sparse
    Cholesky — exact up to the squared condition number (the classic
    normal-equations caveat; prefer LSQR/LSMR when ``A`` is
    ill-conditioned)."""
    from ..ops.operator import SpmvOperator
    from .lsqr import lsqr_solve

    if method == "direct":
        from ..ops.spgemm_block import spgemm_auto
        from .cholesky import spsolve_chol
        from .lsqr import LsqrResult
        import jax.numpy as jnp

        at = a.transpose()
        ata = spgemm_auto(at, a, output_sorted=True)
        b64 = np.asarray(b, dtype=np.float64)
        x = spsolve_chol(ata, at.matvec_host(b64))
        r = a.matvec_host(x) - b64
        return LsqrResult(
            x=x, iterations=jnp.int32(0),
            residual_norm=np.float64(np.linalg.norm(r)),
            atr_norm=np.float64(np.linalg.norm(at.matvec_host(r))),
        )
    if method not in ("auto", "lsmr"):
        raise ValueError(f"unknown method {method!r} (auto|lsmr|direct)")
    op = SpmvOperator(a, dtype=dtype)
    opt = SpmvOperator(a.transpose(), dtype=dtype)
    if method == "lsmr":
        from .lsmr import lsmr_solve

        return lsmr_solve(
            op, opt, np.asarray(b), n=a.cols, tol=tol, maxiter=maxiter
        )
    return lsqr_solve(op, opt, np.asarray(b), n=a.cols, tol=tol, maxiter=maxiter)


def spsolve(a, b, **kw) -> np.ndarray:
    """scipy.sparse.linalg.spsolve-shaped convenience: returns the
    solution ARRAY (host numpy). ``solve()`` keyword surface applies;
    accuracy-critical callers should use ``method="direct"``."""
    return np.asarray(solve(a, b, **kw).x)


def spsolve_triangular(
    a, b, *, lower: bool = True, unit_diagonal: bool = False
) -> np.ndarray:
    """Exact host triangular solve ``A x = b``
    (scipy.sparse.linalg.spsolve_triangular analog). ``a`` must be square
    CSR holding a lower (``lower=True``) or upper triangle; entries on the
    wrong side are ignored (scipy semantics). ``b`` may be a vector or an
    (n, k) block of right-hand sides. Runs in the native runtime with a
    Python fallback (solvers/ilu.py:trisolve_host); raises ``ValueError``
    on a missing/zero pivot. Device callers wanting jit-composable
    approximate solves use :class:`~sparse_matrix_tpu.solvers.ilu.
    TriangularJacobi` instead."""
    from ..formats.construct import tril, triu
    from .ilu import trisolve_host

    if a.rows != a.cols:
        raise ValueError("spsolve_triangular needs a square matrix")
    # drop wrong-side entries up front: the native kernel's upper path
    # reads from the stored diagonal onward and would include
    # sub-diagonal entries of a row with no stored diagonal
    rid = a.row_ids()
    cid = a.indices.astype(np.int64)
    if lower:
        if (cid > rid).any():
            a = tril(a)
    elif (cid < rid).any():
        a = triu(a)
    b = np.asarray(b)
    if b.shape[0] != a.rows:
        raise ValueError("rhs length does not match matrix rows")
    if b.ndim == 1:
        return trisolve_host(a, b, lower=lower, unit=unit_diagonal)
    if b.ndim != 2:
        raise ValueError("rhs must be a vector or (n, k) block")
    out = np.empty(b.shape, dtype=a.vals.dtype)
    for j in range(b.shape[1]):
        out[:, j] = trisolve_host(a, b[:, j], lower=lower, unit=unit_diagonal)
    return out

"""``sparse_matrix_tpu.sparse.linalg`` — a scipy.sparse.linalg-shaped facade.

Thin signature adapters over :mod:`sparse_matrix_tpu.solvers`: iterative
solvers return scipy's ``(x, info)`` tuples, ``eigs``/``eigsh``/``svds``
return scipy-ordered arrays, and matrix arguments may be a
:class:`~sparse_matrix_tpu.formats.csr.CsrMatrix`, any scipy.sparse matrix,
a dense 2-D ndarray, or a :class:`LinearOperator`. Device execution (planned
operators) kicks in whenever the input is one of our host CSR matrices;
foreign matrices are converted once up front.

Semantics deltas vs scipy, stated once:

* tolerances: convergence is ``||r|| <= max(rtol * ||b||, atol)`` like
  modern scipy; ``M`` always applies an approximate inverse;
* ``gmres``/``bicgstab`` precondition on the RIGHT (the stopping test sees
  the TRUE residual — scipy's gmres is left-preconditioned and tests the
  preconditioned residual);
* ``eigsh``/``eigs`` follow scipy's MAGNITUDE semantics for LM/SM:
  ``LM`` keeps the k largest ``|lambda|`` (symmetric case: both spectrum
  ends are computed and merged), ``SM`` routes through exact LDL^T / LU
  shift-invert at 0 (singular operators retry at a tiny positive shift);
  LA/SA are largest/smallest ALGEBRAIC (LOBPCG / Lanczos backed);
* ``lsqr``/``lsmr`` return scipy's tuple arity with the fields this
  implementation tracks; untracked diagnostics are ``nan``.

Reference anchor: the reference workspace has no solver layer (its surface
ends at SpGEMM, ``spam_csr/src/mul_hash.rs``); this facade exists so users of
scipy-based pipelines can adopt the rebuilt stack wholesale.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..formats.csr import CsrMatrix
from ..formats.construct import matrix_power, norm  # noqa: F401
from ..solvers import (
    bicg_solve,
    bicgstab_solve,
    cg_solve,
    cgs_solve,
    gcrotmk_solve,
    lgmres_solve,
    qmr_solve,
    tfqmr_solve,
    gmres_solve,
    lsmr_solve,
    lsqr_solve,
    minres_solve,
    pcg_solve,
)
from ..solvers import factorized as _factorized_csr
from ..solvers import spilu as _spilu_csr
from ..solvers import splu as _splu_csr
from ..solvers import spsolve as _spsolve_csr
from ..solvers import spsolve_triangular as _spsolve_triangular_csr
from ..solvers import condest, onenormest as _onenormest_mv
from ..solvers import eigs as _eigs_arnoldi
from ..solvers import lobpcg as _lobpcg
from ..solvers import svds_csr
from ..solvers import expm_multiply_csr
from ..solvers.factorized import SpluFactor
from ..solvers.funm_krylov import (
    funm_multiply_krylov as _funm_multiply_krylov,
)

__all__ = [
    "LinearOperator", "aslinearoperator",
    "cg", "bicg", "bicgstab", "cgs", "gmres", "minres", "qmr", "tfqmr",
    "lgmres", "gcrotmk", "lsqr", "lsmr",
    "eigs", "eigsh", "lobpcg", "svds",
    "spsolve", "spsolve_triangular", "splu", "spilu", "factorized",
    "expm", "expm_multiply", "inv", "onenormest", "condest", "norm",
    "matrix_power",
    "funm_multiply_krylov", "is_sptriangular", "spbandwidth", "LaplacianNd",
    "SuperLU", "use_solver", "MatrixRankWarning", "ArpackError",
    "ArpackNoConvergence",
]


class LinearOperator:
    """Minimal scipy-compatible linear operator: ``shape``, ``dtype``,
    ``matvec`` (and optional ``rmatvec``/``matmat``). Subclass or construct
    directly. JIT-composability: if ``matvec`` is jax-traceable, the
    iterative solvers run it inside their jitted loops unchanged."""

    def __init__(self, shape: Tuple[int, int], matvec: Callable = None, *,
                 rmatvec: Callable = None, matmat: Callable = None,
                 dtype=np.float32):
        self.shape = (int(shape[0]), int(shape[1]))
        self.dtype = np.dtype(dtype)
        if matvec is not None:
            self._matvec = matvec
        self._rmatvec = rmatvec
        self._matmat = matmat

    def matvec(self, x):
        return self._matvec(x)

    def rmatvec(self, x):
        if self._rmatvec is None:
            raise NotImplementedError("rmatvec not provided")
        return self._rmatvec(x)

    def matmat(self, x):
        if self._matmat is not None:
            return self._matmat(x)
        cols = [np.asarray(self.matvec(x[:, j])) for j in range(x.shape[1])]
        return np.stack(cols, axis=1)

    def __call__(self, x):
        return self.matvec(x)

    def __matmul__(self, x):
        if isinstance(x, LinearOperator):
            return self._compose(x)
        x = np.asarray(x) if not hasattr(x, "ndim") else x
        return self.matvec(x) if x.ndim == 1 else self.matmat(x)

    @property
    def T(self) -> "LinearOperator":
        return LinearOperator(
            (self.shape[1], self.shape[0]), self._rmatvec,
            rmatvec=self._matvec, dtype=self.dtype,
        )

    # -- scipy-parity operator algebra (closure-composed; jit-friendly
    # whenever the leaves' matvecs are jax-traceable) -------------------
    @property
    def H(self) -> "LinearOperator":
        """Adjoint (real operators here: same as ``.T``)."""
        return self.T

    def adjoint(self) -> "LinearOperator":
        return self.H

    def dot(self, x):
        return self @ x

    def _compose(self, other: "LinearOperator") -> "LinearOperator":
        if self.shape[1] != other.shape[0]:
            raise ValueError(
                f"cannot compose {self.shape} with {other.shape}")
        return LinearOperator(
            (self.shape[0], other.shape[1]),
            lambda x: self.matvec(other.matvec(x)),
            rmatvec=lambda y: other.rmatvec(self.rmatvec(y)),
            dtype=np.promote_types(self.dtype, other.dtype),
        )

    def __add__(self, other) -> "LinearOperator":
        if not isinstance(other, LinearOperator):
            other = aslinearoperator(other)
        if other.shape != self.shape:
            raise ValueError(f"shape mismatch: {self.shape} + {other.shape}")
        return LinearOperator(
            self.shape,
            lambda x: self.matvec(x) + other.matvec(x),
            rmatvec=lambda y: self.rmatvec(y) + other.rmatvec(y),
            dtype=np.promote_types(self.dtype, other.dtype),
        )

    __radd__ = __add__

    def __neg__(self) -> "LinearOperator":
        return self * (-1)

    def __sub__(self, other) -> "LinearOperator":
        return self + (-(other if isinstance(other, LinearOperator)
                         else aslinearoperator(other)))

    def __mul__(self, other):
        if np.isscalar(other):
            s = other
            return LinearOperator(
                self.shape, lambda x: s * self.matvec(x),
                rmatvec=lambda y: np.conj(s) * self.rmatvec(y),
                dtype=self.dtype,
            )
        if isinstance(other, LinearOperator):  # scipy: A * B composes
            return self._compose(other)
        return self @ other

    def __rmul__(self, other):
        if np.isscalar(other):
            return self * other
        return NotImplemented

    def __truediv__(self, other):
        if not np.isscalar(other):
            raise ValueError("can only divide a LinearOperator by a scalar")
        return self * (1.0 / other)

    def __pow__(self, p: int) -> "LinearOperator":
        if self.shape[0] != self.shape[1]:
            raise ValueError("operator power needs a square operator")
        p = int(p)
        if p < 0:
            raise ValueError("negative operator powers are not defined here")

        def mv(x, p=p):
            for _ in range(p):
                x = self.matvec(x)
            return x

        def rmv(y, p=p):
            for _ in range(p):
                y = self.rmatvec(y)
            return y

        return LinearOperator(self.shape, mv, rmatvec=rmv, dtype=self.dtype)


def aslinearoperator(a) -> LinearOperator:
    """Wrap a CsrMatrix / scipy matrix / dense array / LinearOperator."""
    if isinstance(a, LinearOperator):
        return a
    a = _ascsr_maybe(a)
    if isinstance(a, CsrMatrix):
        from ..ops.operator import SpmvOperator

        dt = np.float32  # device plans are f32-first (docs/DTYPES.md)
        op = SpmvOperator(a, dtype=dt)
        at = a.transpose()
        opt = SpmvOperator(at, dtype=dt)
        mm = getattr(op, "matmat", None)
        return LinearOperator(a.shape, _f32call(op), rmatvec=_f32call(opt),
                              matmat=_f32call(mm) if mm is not None else None,
                              dtype=dt)
    arr = np.asarray(a)
    if arr.ndim != 2:
        raise ValueError("aslinearoperator expects a 2-D operator")
    return LinearOperator(arr.shape, lambda x: arr @ x,
                          rmatvec=lambda y: arr.T @ y, dtype=arr.dtype)


def _ascsr_maybe(a):
    """Foreign sparse -> CsrMatrix; anything else passes through."""
    if hasattr(a, "tocsr") and hasattr(a, "tocoo") and not isinstance(a, CsrMatrix):
        return CsrMatrix.from_scipy(a)
    return a


def _ascsr(a) -> CsrMatrix:
    a = _ascsr_maybe(a)
    if isinstance(a, CsrMatrix):
        return a
    arr = np.asarray(a)
    if arr.ndim != 2:
        raise ValueError(f"expected a matrix, got ndim={arr.ndim}")
    r, c = np.nonzero(arr)
    return CsrMatrix.from_coo(arr.shape[0], arr.shape[1], r, c, arr[r, c])


def splu(a, permc_spec: str = "RCM"):
    """Facade splu: accepts CsrMatrix / scipy.sparse / dense; see
    :func:`sparse_matrix_tpu.solvers.factorized.splu`."""
    return _splu_csr(_ascsr(a), permc_spec=permc_spec)


def spilu(a, **kw):
    """Facade spilu: accepts CsrMatrix / scipy.sparse / dense."""
    return _spilu_csr(_ascsr(a), **kw)


def factorized(a):
    """Facade factorized: accepts CsrMatrix / scipy.sparse / dense."""
    return _factorized_csr(_ascsr(a))


def spsolve(a, b, **kw):
    """Facade spsolve: accepts CsrMatrix / scipy.sparse / dense."""
    return _spsolve_csr(_ascsr(a), b, **kw)


def spsolve_triangular(a, b, **kw):
    """Facade spsolve_triangular: accepts CsrMatrix / scipy.sparse /
    dense."""
    return _spsolve_triangular_csr(_ascsr(a), b, **kw)


def _f32call(op):
    """Facade dtype policy: cast caller vectors to the operator's f32
    plan dtype before the apply (the planned operators refuse silent
    float64 downcasts; at a scipy-compat boundary the cast is this
    facade's explicit, documented job)."""

    def call(x, *a, **kw):
        import jax.numpy as jnp

        return op(jnp.asarray(x, dtype=jnp.float32), *a, **kw)

    return call


def _square_matvec(a):
    """(matvec, n) from a square operator of any accepted type."""
    a = _ascsr_maybe(a)
    if isinstance(a, CsrMatrix):
        if a.rows != a.cols:
            raise ValueError("square operator required")
        from ..ops.operator import SpmvOperator

        return _f32call(SpmvOperator(a, dtype=np.float32)), a.rows
    if isinstance(a, LinearOperator):
        if a.shape[0] != a.shape[1]:
            raise ValueError("square operator required")
        return a.matvec, a.shape[0]
    arr = np.asarray(a)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError("square operator required")
    import jax.numpy as jnp

    dense = jnp.asarray(arr.astype(np.float32))
    return (lambda x: dense @ x), arr.shape[0]


def _precond_callable(m, n: int) -> Optional[Callable]:
    """scipy's ``M`` (approximate inverse of A) -> an apply callable."""
    if m is None:
        return None
    if callable(m) and not isinstance(m, (CsrMatrix, LinearOperator)):
        return m
    mv, mn = _square_matvec(m)
    if mn != n:
        raise ValueError("preconditioner shape does not match the operator")
    return mv


def _eff_tol(b, rtol: float, atol: float) -> float:
    """Map scipy's (rtol, atol) onto the solvers' single relative tol:
    ||r|| <= tol_eff * ||b|| with tol_eff = max(rtol, atol / ||b||)."""
    bn = float(np.linalg.norm(np.asarray(b)))
    return max(float(rtol), float(atol) / bn) if bn > 0 else float(rtol)


def _info(res, b, tol_rel: float, maxiter: int) -> int:
    rn = float(res.residual_norm)
    bn = float(np.linalg.norm(np.asarray(b)))
    return 0 if rn <= tol_rel * max(bn, 1e-300) * 1.001 else int(maxiter)


def cg(a, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=None, M=None,
       callback=None):
    """scipy.sparse.linalg.cg-shaped: returns ``(x, info)``; info 0 on
    convergence, else maxiter. ``callback`` is unsupported (the loop is one
    jitted ``while_loop``) and must be None."""
    if callback is not None:
        raise NotImplementedError("callback: the CG loop is a single jitted while_loop")
    mv, n = _square_matvec(a)
    maxiter = int(maxiter) if maxiter is not None else 10 * n
    tol = _eff_tol(b, rtol, atol)
    m_inv = _precond_callable(M, n)
    if m_inv is None:
        res = cg_solve(mv, np.asarray(b, np.float32), x0, tol=tol, maxiter=maxiter)
    else:
        res = pcg_solve(mv, np.asarray(b, np.float32), m_inv, x0, tol=tol,
                        maxiter=maxiter)
    return np.asarray(res.x), _info(res, b, tol, maxiter)


def bicgstab(a, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=None, M=None,
             callback=None):
    if callback is not None:
        raise NotImplementedError("callback: jitted while_loop")
    mv, n = _square_matvec(a)
    maxiter = int(maxiter) if maxiter is not None else 10 * n
    tol = _eff_tol(b, rtol, atol)
    res = bicgstab_solve(mv, np.asarray(b, np.float32), x0, tol=tol,
                         maxiter=maxiter, m_inv=_precond_callable(M, n))
    return np.asarray(res.x), _info(res, b, tol, maxiter)


def _square_matvec_pair(a):
    """(matvec, rmatvec, n) for solvers needing A^T (bicg/qmr)."""
    a = _ascsr_maybe(a)
    if isinstance(a, LinearOperator):
        if a.shape[0] != a.shape[1]:
            raise ValueError("square operator required")
        return a.matvec, a.rmatvec, a.shape[0]
    mv, rmv, (m, n) = _rect_matvecs(a)
    if m != n:
        raise ValueError("square operator required")
    return mv, rmv, n


def bicg(a, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=None, M=None,
         callback=None):
    """scipy.sparse.linalg.bicg-shaped. ``M`` applies the approximate
    inverse on both sides (its transpose apply is assumed equal — true for
    the symmetric preconditioners this library builds)."""
    if callback is not None:
        raise NotImplementedError("callback: jitted while_loop")
    mv, rmv, n = _square_matvec_pair(a)
    maxiter = int(maxiter) if maxiter is not None else 10 * n
    tol = _eff_tol(b, rtol, atol)
    m_inv = _precond_callable(M, n)
    res = bicg_solve(mv, rmv, np.asarray(b, np.float32), x0, tol=tol,
                     maxiter=maxiter, m_inv=m_inv)
    return np.asarray(res.x), _info(res, b, tol, maxiter)


def cgs(a, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=None, M=None,
        callback=None):
    """scipy.sparse.linalg.cgs-shaped (transpose-free)."""
    if callback is not None:
        raise NotImplementedError("callback: jitted while_loop")
    mv, n = _square_matvec(a)
    maxiter = int(maxiter) if maxiter is not None else 10 * n
    tol = _eff_tol(b, rtol, atol)
    res = cgs_solve(mv, np.asarray(b, np.float32), x0, tol=tol,
                    maxiter=maxiter, m_inv=_precond_callable(M, n))
    return np.asarray(res.x), _info(res, b, tol, maxiter)


def qmr(a, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=None, M1=None,
        M2=None, callback=None):
    """scipy.sparse.linalg.qmr-shaped. ``M1``/``M2`` are the left/right
    approximate-inverse factors (scipy semantics: applying them applies
    the inverse); their transposed applies come from ``rmatvec``/``.T``
    when available, else the factor must be symmetric."""
    if callback is not None:
        raise NotImplementedError("callback: jitted while_loop")
    mv, rmv, n = _square_matvec_pair(a)

    def _pair(mfac):
        if mfac is None:
            return None, None
        fwd = _precond_callable(mfac, n)
        if hasattr(mfac, "rmatvec"):
            return fwd, mfac.rmatvec
        if isinstance(mfac, (CsrMatrix, LinearOperator)):
            tmv, _tn = _square_matvec(mfac.T)
            return fwd, tmv
        return fwd, fwd  # bare callable: symmetric-factor assumption

    m1s, m1ts = _pair(M1)
    m2s, m2ts = _pair(M2)
    maxiter = int(maxiter) if maxiter is not None else 10 * n
    tol = _eff_tol(b, rtol, atol)
    res = qmr_solve(mv, rmv, np.asarray(b, np.float32), x0, tol=tol,
                    maxiter=maxiter, m1_solve=m1s, m1t_solve=m1ts,
                    m2_solve=m2s, m2t_solve=m2ts)
    return np.asarray(res.x), _info(res, b, tol, maxiter)


def tfqmr(a, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=None, M=None,
          callback=None, show=False):
    """scipy.sparse.linalg.tfqmr-shaped; ``maxiter`` counts half-steps
    like scipy. ``M`` left-preconditions (scipy semantics)."""
    del show
    if callback is not None:
        raise NotImplementedError("callback: jitted while_loop")
    mv, n = _square_matvec(a)
    maxiter = int(maxiter) if maxiter is not None else min(10000, 10 * n)
    tol = _eff_tol(b, rtol, atol)
    res = tfqmr_solve(mv, np.asarray(b, np.float32), x0, tol=tol,
                      maxiter=maxiter, m_inv=_precond_callable(M, n))
    return np.asarray(res.x), _info(res, b, tol, maxiter)


def gmres(a, b, x0=None, *, rtol=1e-5, atol=0.0, restart=None, maxiter=None,
          M=None, callback=None, callback_type=None):
    """Right-preconditioned restarted GMRES (scipy preconditions left;
    stopping here tests the TRUE residual). ``maxiter`` counts outer
    (restart) cycles, as in scipy."""
    if callback is not None:
        raise NotImplementedError("callback: jitted while_loop")
    del callback_type
    mv, n = _square_matvec(a)
    restart = int(restart) if restart is not None else min(n, 30)
    outer = int(maxiter) if maxiter is not None else max(1, min(n, 1000) // max(restart, 1) + 1)
    tol = _eff_tol(b, rtol, atol)
    res = gmres_solve(mv, np.asarray(b, np.float32), x0, restart=restart,
                      tol=tol, maxiter=outer * restart,
                      m_inv=_precond_callable(M, n))
    return np.asarray(res.x), _info(res, b, tol, outer)


def lgmres(a, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=1000, M=None,
           callback=None, inner_m=30, outer_k=3, outer_v=None,
           store_outer_Av=True, prepend_outer_v=False):
    """scipy.sparse.linalg.lgmres-shaped. ``maxiter`` counts outer cycles
    (scipy semantics); preconditioning is flexible/right, so the stopping
    test sees the TRUE residual. ``outer_v`` seeding is not offered (the
    augmentation store lives inside the jitted loop)."""
    if callback is not None:
        raise NotImplementedError("callback: jitted while_loop")
    if outer_v:
        raise NotImplementedError("outer_v seeding: buffer lives in-jit")
    del store_outer_Av, prepend_outer_v
    mv, n = _square_matvec(a)
    tol = _eff_tol(b, rtol, atol)
    t = min(int(inner_m), n) + min(int(outer_k), n)
    res = lgmres_solve(mv, np.asarray(b, np.float32), x0,
                       inner_m=int(inner_m), outer_k=int(outer_k), tol=tol,
                       maxiter=int(maxiter) * t,
                       m_inv=_precond_callable(M, n))
    return np.asarray(res.x), _info(res, b, tol, int(maxiter))


def gcrotmk(a, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=1000, M=None,
            callback=None, m=20, k=None, CU=None, discard_C=False,
            truncate="oldest"):
    """scipy.sparse.linalg.gcrotmk-shaped. ``maxiter`` counts outer
    cycles (scipy semantics); truncation is FIFO = scipy's ``'oldest'``;
    ``CU`` seeding/return is not offered (the recycle space lives inside
    the jitted loop)."""
    if callback is not None:
        raise NotImplementedError("callback: jitted while_loop")
    if CU is not None:
        raise NotImplementedError("CU seeding: recycle space lives in-jit")
    if truncate != "oldest":
        raise NotImplementedError("only truncate='oldest' (FIFO)")
    del discard_C
    mv, n = _square_matvec(a)
    tol = _eff_tol(b, rtol, atol)
    res = gcrotmk_solve(mv, np.asarray(b, np.float32), x0, m=int(m),
                        k=None if k is None else int(k), tol=tol,
                        maxiter=int(maxiter) * min(int(m), n),
                        m_inv=_precond_callable(M, n))
    return np.asarray(res.x), _info(res, b, tol, int(maxiter))


def minres(a, b, x0=None, *, rtol=1e-5, maxiter=None, M=None, callback=None,
           shift=0.0):
    if callback is not None:
        raise NotImplementedError("callback: jitted while_loop")
    mv, n = _square_matvec(a)
    if shift:
        base = mv
        mv = lambda x: base(x) - shift * x  # noqa: E731
    maxiter = int(maxiter) if maxiter is not None else 5 * n
    res = minres_solve(mv, np.asarray(b, np.float32), x0, tol=float(rtol),
                       maxiter=maxiter, precond=_precond_callable(M, n))
    return np.asarray(res.x), _info(res, b, float(rtol), maxiter)


def _rect_matvecs(a):
    """matvec/rmatvec pair for a facade argument, with the facade dtype
    policy applied: scipy entry points accept whatever float width the
    caller hands them (scipy's default is float64) and cast it to the
    operator's plan dtype HERE, explicitly — the planned operators
    themselves refuse silent downcasts (ops/spmv.py downcast guard), and
    that refusal is correct for direct users but wrong at a compat facade
    whose contract is scipy's."""
    a = _ascsr_maybe(a)
    if isinstance(a, LinearOperator):
        return a.matvec, a.rmatvec, a.shape
    a = _ascsr(a)
    from ..ops.operator import SpmvOperator

    op = SpmvOperator(a, dtype=np.float32)
    opt = SpmvOperator(a.transpose(), dtype=np.float32)
    return _f32call(op), _f32call(opt), a.shape


def lsqr(a, b, damp=0.0, atol=1e-6, btol=1e-6, conlim=None, iter_lim=None,
         **_ignored):
    """scipy.sparse.linalg.lsqr-shaped 10-tuple
    ``(x, istop, itn, r1norm, r2norm, anorm, acond, arnorm, xnorm, var)``;
    diagnostics this implementation does not track are ``nan``. ``damp``
    routes to LSMR (the damped Fong-Saunders form)."""
    mv, rmv, (m, n) = _rect_matvecs(a)
    del conlim
    tol = max(float(atol), float(btol))
    it = int(iter_lim) if iter_lim is not None else 2 * n
    if damp:
        res = lsmr_solve(mv, rmv, np.asarray(b, np.float32), n=n,
                         damp=float(damp), tol=tol, maxiter=it)
    else:
        res = lsqr_solve(mv, rmv, np.asarray(b, np.float32), n=n, tol=tol,
                         maxiter=it)
    x = np.asarray(res.x)
    r1 = float(res.residual_norm)
    return (x, 1, int(res.iterations), r1, r1, np.nan, np.nan,
            float(res.atr_norm), float(np.linalg.norm(x)), None)


def lsmr(a, b, damp=0.0, atol=1e-6, btol=1e-6, conlim=None, maxiter=None,
         **_ignored):
    """scipy.sparse.linalg.lsmr-shaped 8-tuple
    ``(x, istop, itn, normr, normar, norma, conda, normx)``."""
    mv, rmv, (m, n) = _rect_matvecs(a)
    del conlim
    tol = max(float(atol), float(btol))
    it = int(maxiter) if maxiter is not None else 2 * n
    res = lsmr_solve(mv, rmv, np.asarray(b, np.float32), n=n,
                     damp=float(damp), tol=tol, maxiter=it)
    x = np.asarray(res.x)
    return (x, 1, int(res.iterations), float(res.residual_norm),
            float(res.atr_norm), np.nan, np.nan, float(np.linalg.norm(x)))


def _sm_sigma_retry(run_at, a):
    """Run ``run_at(sigma)`` at sigma=0; on the exact factorization's
    zero-pivot/singular error (A singular — e.g. a graph Laplacian, whose
    smallest eigenvalue is exactly 0) retry at a tiny positive shift
    scaled to the matrix (scipy's ARPACK SM handles singular operators;
    the exact shift-invert route here needs the nudge)."""
    try:
        return run_at(0.0)
    except ValueError as e:
        msg = str(e)
        if not ("pivot" in msg or "singular" in msg):
            raise
    m = _ascsr(a)
    scale = float(np.max(np.abs(m.vals))) if m.nnz() else 1.0
    eps = 1e-6 * max(scale, 1e-30)
    return run_at(eps)


def eigs(a, k: int = 6, *, which: str = "LM", v0=None, maxiter=None,
         sigma=None, M=None, **_ignored):
    """Arnoldi top-k-by-modulus eigenpairs (``which='LM'``).
    ``sigma=`` runs shift-invert: exact sparse LU of ``A - sigma I``
    (host-native, like the factorization itself) + host Arnoldi on the
    solve operator — eigenvalues NEAREST sigma, scipy semantics.
    ``which='SM'`` shift-inverts at 0; a singular ``A`` retries at a tiny
    matrix-scaled shift (see :func:`_sm_sigma_retry`)."""
    if which == "SM" and sigma is None:
        # smallest |lambda| = eigenvalues nearest 0 (exact LU shift-invert)
        return _sm_sigma_retry(
            lambda s: eigs(a, k, which="LM", v0=v0, maxiter=maxiter,
                           sigma=s, M=M),
            a,
        )
    if which != "LM":
        raise NotImplementedError(
            "eigs supports which='LM'/'SM' (Arnoldi by modulus); see "
            "solvers.eigen for generalized forms"
        )
    if M is not None:
        from ..solvers import eigs_generalized

        return eigs_generalized(
            _ascsr(a), _ascsr(M), int(k), which=which,
            sigma=None if sigma is None else float(sigma),
            m=int(maxiter) if maxiter else None,
        )
    if sigma is not None:
        from ..solvers import eigs_shift_invert

        return eigs_shift_invert(_ascsr(a), int(k), float(sigma),
                                 m=int(maxiter) if maxiter else None)
    mv, n = _square_matvec(a)
    m_steps = int(maxiter) if maxiter is not None else None
    vals, vecs = _eigs_arnoldi(mv, n, int(k), m=m_steps)
    return vals, vecs


def eigsh(a, k: int = 6, *, which: str = "LA", v0=None, maxiter=None,
          tol: float = 1e-5, sigma=None, M=None, seed: int = 0, **_ignored):
    """Symmetric eigenpairs via LOBPCG. ``which``: LA -> largest
    ALGEBRAIC, SA -> smallest ALGEBRAIC, LM/SM -> largest/smallest
    MAGNITUDE (scipy semantics: LM computes both spectrum ends and keeps
    the k largest ``|lambda|``; SM runs shift-invert at 0), BE -> both
    ends (k//2 smallest + k-k//2 largest, scipy's split). Returns
    ``(vals ascending, vecs)`` like scipy. ``sigma=`` runs shift-invert
    Lanczos over one exact LDL^T of ``A - sigma I`` — eigenvalues
    NEAREST sigma. ``M=`` (SPD) solves the generalized pencil via exact
    chol(M) + M-Lanczos (``solvers.generalized``)."""
    if which == "SM" and sigma is None and M is None:
        # smallest |lambda| = eigenvalues nearest 0 (exact LDL shift-invert;
        # singular A retries at a tiny matrix-scaled shift)
        return _sm_sigma_retry(
            lambda s: eigsh(a, k, which="LM", v0=v0, maxiter=maxiter,
                            tol=tol, sigma=s, seed=seed),
            a,
        )
    if which == "LM" and sigma is None:
        # largest |lambda|: both spectrum ends, keep the k biggest moduli.
        # The two end-runs can resolve the SAME pair when the ends overlap
        # (clustered spectra); dedup by (value, vector-overlap), then top
        # up with wider end-runs if collisions left fewer than k pairs.
        k = int(k)

        def ends(kk):
            lo = eigsh(a, kk, which="SA", v0=v0, maxiter=maxiter, tol=tol,
                       M=M, seed=seed)
            hi = eigsh(a, kk, which="LA", v0=v0, maxiter=maxiter, tol=tol,
                       M=M, seed=seed)
            vals = np.concatenate([lo[0], hi[0]])
            vecs = np.concatenate(
                [np.asarray(lo[1]), np.asarray(hi[1])], axis=1)
            return vals, vecs

        def dedup(vals, vecs):
            # generalized-pencil runs return M-orthonormal vectors; the
            # overlap test needs 2-normalized copies or a duplicated pair
            # can evade it (||v||_2 != 1 shrinks the inner product)
            nv = vecs / np.maximum(
                np.linalg.norm(vecs, axis=0, keepdims=True), 1e-30)
            sel = np.argsort(-np.abs(vals))
            picked, pvals = [], []
            for i in sel:
                if any(abs(vals[i] - pv) <= 1e-10 * max(1.0, abs(pv))
                       and np.abs(np.vdot(nv[:, i], nv[:, j])) > 0.99
                       for pv, j in zip(pvals, picked)):
                    continue
                picked.append(i)
                pvals.append(vals[i])
                if len(picked) == k:
                    break
            return picked

        vals, vecs = ends(k)
        picked = dedup(vals, vecs)
        if len(picked) < k:
            # widen both ends by the shortfall and re-dedup once
            kk = k + (k - len(picked)) + 1
            try:
                vals, vecs = ends(kk)
                picked = dedup(vals, vecs)
            except ValueError:
                pass  # wider k violated a backend bound; report below
        if len(picked) < k:
            raise RuntimeError(
                f"eigsh(which='LM') resolved only {len(picked)} distinct "
                f"pairs of the requested k={k} (spectrum-end runs "
                "collided); request fewer pairs or use which='LA'/'SA'"
            )
        vals = vals[picked]
        vecs = vecs[:, picked]
        order = np.argsort(vals)
        return vals[order], vecs[:, order]
    if which == "BE" and sigma is None:
        k = int(k)
        k_lo = k // 2
        k_hi = k - k_lo
        lo = eigsh(a, k_lo, which="SA", v0=None, maxiter=maxiter, tol=tol,
                   M=M, seed=seed) if k_lo else (np.empty(0), None)
        hi = eigsh(a, k_hi, which="LA", v0=None, maxiter=maxiter, tol=tol,
                   M=M, seed=seed)
        if k_lo == 0:
            return hi
        vals = np.concatenate([lo[0], hi[0]])
        vecs = np.concatenate([np.asarray(lo[1]), np.asarray(hi[1])], axis=1)
        order = np.argsort(vals)
        return vals[order], vecs[:, order]
    if M is not None:
        from ..solvers import eigsh_generalized

        return eigsh_generalized(
            _ascsr(a), _ascsr(M), int(k), which=which,
            sigma=None if sigma is None else float(sigma),
            m=int(maxiter) if maxiter else None,
        )
    if sigma is not None:
        from ..solvers import eigsh_shift_invert

        vals, vecs = eigsh_shift_invert(_ascsr(a), int(k), float(sigma),
                                        m=int(maxiter) if maxiter else None)
        order = np.argsort(vals)
        return vals[order], vecs[:, order]
    mv, n = _square_matvec(a)
    k = int(k)
    if not 1 <= k or 3 * k > n:
        raise ValueError(f"k={k} needs 3k <= n={n} (LOBPCG block)")

    def matmat(xb):
        import jax.numpy as jnp

        return jnp.stack([mv(xb[:, j]) for j in range(xb.shape[1])], axis=1)

    x0 = (v0 if v0 is not None
          else np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32))
    it = int(maxiter) if maxiter is not None else 500
    res = _lobpcg(matmat, x0, largest=which in ("LA", "LM"), tol=float(tol),
                  maxiter=it)
    vals = np.asarray(res.eigenvalues)
    vecs = np.asarray(res.eigenvectors)
    order = np.argsort(vals)
    return vals[order], vecs[:, order]


def lobpcg(a, X, B=None, M=None, *, largest=True, tol=1e-5, maxiter=None,
           **_ignored):
    """scipy.sparse.linalg.lobpcg-shaped: returns ``(vals, vecs)``.
    Generalized problems (``B`` SPD) route through one exact ``chol(B)``
    + M-Lanczos (``solvers.generalized``). For the generalized path
    ``maxiter`` (when given) pins the Lanczos subspace size; the default
    ``None`` keeps the residual-driven adaptive subspace growth, with
    ``tol`` as its convergence gate."""
    if B is not None:
        from ..solvers import lobpcg_generalized

        return lobpcg_generalized(
            _ascsr(a), np.asarray(X), _ascsr(B),
            largest=bool(largest), tol=float(tol),
            m=int(maxiter) if maxiter is not None else None,
        )
    mv, n = _square_matvec(a)

    def matmat(xb):
        import jax.numpy as jnp

        return jnp.stack([mv(xb[:, j]) for j in range(xb.shape[1])], axis=1)

    res = _lobpcg(matmat, np.asarray(X, np.float32), largest=bool(largest),
                  precond=_precond_callable(M, n), tol=float(tol),
                  maxiter=int(maxiter) if maxiter is not None else 200)
    return np.asarray(res.eigenvalues), np.asarray(res.eigenvectors)


def svds(a, k: int = 6, *, which: str = "LM", maxiter=None, seed: int = 0,
         **_ignored):
    """Top-k (``which='LM'``, GKL) or bottom-k (``which='SM'``) singular
    triplets; returns ``(u, s, vT)`` with ``s`` ASCENDING (scipy
    ordering). ``'SM'`` runs shift-invert Lanczos at 0 on the SPD Gram
    matrix of the SMALLER side (``A^T A`` when tall, ``A A^T`` when wide
    — the larger side's Gram is rank-deficient by construction for
    rectangular inputs and would zero-pivot); genuinely rank-deficient
    inputs surface as the factorization's zero-pivot error, as in
    scipy's ARPACK failure mode."""
    if which == "SM":
        from ..solvers import eigsh_shift_invert

        A = _ascsr(a)
        wide = A.rows < A.cols
        c = A @ A.transpose() if wide else A.transpose() @ A
        if not c.is_sorted:
            c = c.sorted_indices()
        vals, w = eigsh_shift_invert(c, int(k), 0.0,
                                     m=int(maxiter) if maxiter else None)
        s = np.sqrt(np.maximum(np.asarray(vals), 0.0))
        order = np.argsort(s)
        s, w = s[order], np.asarray(w)[:, order]

        def other_side(side):
            # recover the partner factor, re-orthonormalize (defensive
            # for clustered tiny s); QR may flip column signs — restore
            # the A-product alignment
            o0 = side / np.where(s > 0, s, 1.0)[None, :]
            o, _ = np.linalg.qr(o0)
            sgn = np.sign(np.sum(o * o0, axis=0))
            return o * np.where(sgn == 0, 1.0, sgn)[None, :]

        if wide:
            u = w  # eigenvectors of A A^T
            v = other_side(A.transpose().dot(u))
        else:
            v = w  # eigenvectors of A^T A
            u = other_side(A.dot(v))
        return u, s, v.T
    if which != "LM":
        raise NotImplementedError("svds supports which='LM' or 'SM'")
    res = svds_csr(_ascsr(a), int(k), steps=maxiter, seed=seed)
    u = np.asarray(res.u)[:, ::-1]
    s = np.asarray(res.s)[::-1]
    v = np.asarray(res.v)[:, ::-1]
    return u, s, v.T


def expm_multiply(a, b, start=None, stop=None, num=None, endpoint=True,
                  *, t: float = 1.0, **_ignored):
    """``exp(t A) @ b``; with ``start/stop/num`` returns the scipy time
    grid ``X[i] = exp(t_i A) @ b`` over ``t_i = linspace(start, stop,
    num, endpoint)``, stepped as ``X_{i+1} = exp(dt A) X_i`` so the
    operator is planned once and each grid point costs one substep chain."""
    a = _ascsr(a)
    b = np.asarray(b, np.float32)
    if start is None and stop is None and num is None:
        return np.asarray(expm_multiply_csr(a, b, t))
    if stop is None:
        raise ValueError("time grid needs stop= (scipy semantics)")
    start = 0.0 if start is None else float(start)
    num = 50 if num is None else int(num)
    ts = np.linspace(start, float(stop), num, endpoint=bool(endpoint))
    out = np.empty((num,) + b.shape, dtype=b.dtype)
    x = expm_multiply_csr(a, b, float(ts[0])) if ts[0] != 0.0 else b
    out[0] = np.asarray(x)
    for i in range(1, num):
        dt = float(ts[i] - ts[i - 1])
        x = expm_multiply_csr(a, np.asarray(x, np.float32), dt)
        out[i] = np.asarray(x)
    return out


_EXPM_DENSE_N = 2048


def expm(a) -> CsrMatrix:
    """Matrix exponential. Sparse expm densifies in general, so this runs
    the dense Padé/scaling route (jax.scipy.linalg.expm) and re-sparsifies;
    gated to n <= 2048 to keep the O(n^2) memory honest."""
    a = _ascsr(a)
    if a.rows != a.cols:
        raise ValueError("expm needs a square matrix")
    if a.rows > _EXPM_DENSE_N:
        raise ValueError(
            f"expm is dense-backed and capped at n={_EXPM_DENSE_N}; for "
            "exp(tA) @ b actions at scale use expm_multiply"
        )
    import jax.scipy.linalg as jsl

    dense = np.asarray(jsl.expm(np.asarray(a.to_dense(), np.float32)))
    r, c = np.nonzero(dense)
    return CsrMatrix.from_coo(a.rows, a.cols, r, c, dense[r, c])


def inv(a) -> CsrMatrix:
    """Exact sparse inverse through the native LU (column solves on the
    identity). The inverse of a sparse matrix is generically dense —
    intended for small/structured operators; prefer ``factorized`` or
    ``splu().solve`` for repeated application."""
    a = _ascsr(a)
    if a.rows != a.cols:
        raise ValueError("inv needs a square matrix")
    f = splu(a)
    x = f.solve(np.eye(a.rows, dtype=np.float64))
    r, c = np.nonzero(x)
    return CsrMatrix.from_coo(a.rows, a.cols, r, c, x[r, c])


def onenormest(a, *, itmax: int = 8) -> float:
    """Hager's 1-norm estimate from matvec/rmatvec probes."""
    mv, rmv, (m, n) = _rect_matvecs(a)
    if m != n:
        raise ValueError("onenormest needs a square operator")
    return _onenormest_mv(mv, rmv, n, itmax=itmax)


# ---------------------------------------------------------------------------
# structure probes, grid Laplacian, and small scipy-surface parity shims
# ---------------------------------------------------------------------------

class MatrixRankWarning(UserWarning):
    """scipy.sparse.linalg.MatrixRankWarning parity (singular-system
    warnings; this library raises on exact zero pivots instead)."""


class ArpackError(RuntimeError):
    """scipy.sparse.linalg.ArpackError parity class (the eigensolvers
    here are native Lanczos/Arnoldi/LOBPCG, not ARPACK; kept so except
    clauses written against scipy keep working)."""


class ArpackNoConvergence(ArpackError):
    """scipy parity: raised semantics not used — eigensolvers return
    their best estimate with documented residuals."""

    def __init__(self, msg="", eigenvalues=None, eigenvectors=None):
        super().__init__(msg)
        self.eigenvalues = eigenvalues
        self.eigenvectors = eigenvectors


def use_solver(**kwargs):
    """scipy.sparse.linalg.use_solver parity no-op: the direct backend
    here is always the native LU/Cholesky runtime (there is no UMFPACK
    toggle)."""


def is_sptriangular(a):
    """(is_lower, is_upper) from the CSR structure in one pass.
    scipy parity: ``scipy.sparse.linalg.is_sptriangular``."""
    a = _ascsr(a)
    r = np.repeat(np.arange(a.rows), np.diff(a.offsets.astype(np.int64)))
    c = a.indices.astype(np.int64)
    nz = a.vals != 0
    return bool(not np.any((c > r) & nz)), bool(not np.any((c < r) & nz))


def spbandwidth(a):
    """(below, above): widths of the lower/upper band holding every
    stored nonzero. scipy parity: ``scipy.sparse.linalg.spbandwidth``."""
    a = _ascsr(a)
    r = np.repeat(np.arange(a.rows), np.diff(a.offsets.astype(np.int64)))
    c = a.indices.astype(np.int64)
    nz = a.vals != 0
    r, c = r[nz], c[nz]
    if len(r) == 0:
        return 0, 0
    return int(np.maximum(r - c, 0).max()), int(np.maximum(c - r, 0).max())


def _lap1d_modes(n: int, bc: str):
    """Per-axis eigenpairs of the 1-D grid Laplacian (diag -2, off +1)
    under the named boundary condition; vectors orthonormal."""
    i = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)
    if bc == "dirichlet":
        lam = -4.0 * np.sin(np.pi * (k + 1) / (2 * (n + 1))) ** 2
        vecs = np.sqrt(2.0 / (n + 1)) * np.sin(
            np.pi * np.outer(k + 1, i + 1) / (n + 1))
    elif bc == "neumann":
        lam = -4.0 * np.sin(np.pi * k / (2 * n)) ** 2
        vecs = np.sqrt(2.0 / n) * np.cos(np.pi * np.outer(k, i + 0.5) / n)
        vecs[0] = 1.0 / np.sqrt(n)
    elif bc == "periodic":
        freq = np.minimum(k, n - k)
        lam = -4.0 * np.sin(np.pi * freq / n) ** 2
        vecs = np.empty((n, n))
        for kk in range(n):
            if kk == 0:
                vecs[kk] = 1.0 / np.sqrt(n)
            elif 2 * kk == n:
                vecs[kk] = np.where(i.astype(np.int64) % 2 == 0, 1.0, -1.0) / np.sqrt(n)
            elif kk <= n // 2:
                vecs[kk] = np.sqrt(2.0 / n) * np.cos(2 * np.pi * kk * i / n)
            else:
                vecs[kk] = np.sqrt(2.0 / n) * np.sin(2 * np.pi * (n - kk) * i / n)
    else:
        raise ValueError(
            "boundary_conditions must be 'neumann', 'dirichlet' or "
            f"'periodic', got {bc!r}")
    return lam, vecs


class LaplacianNd(LinearOperator):
    """N-D grid Laplacian (negative semi-definite second difference) as a
    LinearOperator with ANALYTIC eigenpairs — scipy parity:
    ``scipy.sparse.linalg.LaplacianNd`` (boundary_conditions in
    {'neumann', 'dirichlet', 'periodic'}). ``tosparse`` returns the host
    :class:`CsrMatrix` built by Kronecker sums of the 1-D stencils, so
    the operator drops straight onto the device DIA/SpMV paths.

    Documented delta: for a degenerate size-1 axis scipy's ``toarray``
    emits a ``-1`` diagonal that contradicts its own analytic
    ``eigenvalues()`` (0 for neumann/periodic); here matvec / tosparse /
    toarray / eigenvalues are mutually consistent (that axis contributes
    0 under neumann/periodic, -2 under dirichlet)."""

    def __init__(self, grid_shape, *, boundary_conditions="neumann",
                 dtype=np.int8):
        self.grid_shape = tuple(int(g) for g in grid_shape)
        if any(g < 1 for g in self.grid_shape):
            raise ValueError("grid_shape entries must be >= 1")
        self.boundary_conditions = boundary_conditions
        n = int(np.prod(self.grid_shape))
        self._modes = [_lap1d_modes(g, boundary_conditions)
                       for g in self.grid_shape]
        super().__init__((n, n), None, dtype=dtype)

    def _matvec(self, x):
        x = np.asarray(x)
        promote = np.promote_types(x.dtype, np.float64) \
            if x.dtype.kind == "f" else np.float64
        g = x.reshape(self.grid_shape).astype(promote)
        out = np.zeros_like(g)
        bc = self.boundary_conditions
        for ax, nax in enumerate(self.grid_shape):
            t = -2.0 * g
            t += np.roll(g, 1, axis=ax) + np.roll(g, -1, axis=ax)
            if bc != "periodic":
                # undo the wraparound contributions at the two faces
                first = [slice(None)] * g.ndim
                last = [slice(None)] * g.ndim
                first[ax] = 0
                last[ax] = nax - 1
                wrap_hi = [slice(None)] * g.ndim
                wrap_lo = [slice(None)] * g.ndim
                wrap_hi[ax] = nax - 1
                wrap_lo[ax] = 0
                t[tuple(first)] -= g[tuple(wrap_hi)]
                t[tuple(last)] -= g[tuple(wrap_lo)]
                if bc == "neumann":
                    t[tuple(first)] += g[tuple(first)]
                    t[tuple(last)] += g[tuple(last)]
            out += t
        return out.reshape(x.shape)

    def rmatvec(self, x):  # symmetric
        return self._matvec(x)

    def tosparse(self) -> CsrMatrix:
        def lap1(n):
            d = -2.0 * np.eye(n) + np.eye(n, k=1) + np.eye(n, k=-1)
            if self.boundary_conditions == "neumann":
                d[0, 0] += 1.0  # += (not =) so n == 1 reads 0
                d[n - 1, n - 1] += 1.0
            elif self.boundary_conditions == "periodic":
                d[0, n - 1] += 1.0
                d[n - 1, 0] += 1.0
            return d

        from ..formats.construct import eye as speye, kron as spkron

        def ascsr(d):
            r, c = np.nonzero(d)
            return CsrMatrix.from_coo(d.shape[0], d.shape[1], r, c, d[r, c])

        total = None
        for ax, nax in enumerate(self.grid_shape):
            term = ascsr(lap1(nax))
            for g in self.grid_shape[:ax]:
                term = spkron(speye(g), term)
            for g in self.grid_shape[ax + 1:]:
                term = spkron(term, speye(g))
            total = term if total is None else total + term
        return total

    def toarray(self) -> np.ndarray:
        return self.tosparse().to_dense().astype(self.dtype)

    def _eigval_grid(self):
        lam = self._modes[0][0]
        for l2, _ in self._modes[1:]:
            lam = np.add.outer(lam, l2)
        return lam  # shape = grid_shape, indexed by per-axis mode

    def eigenvalues(self, m=None) -> np.ndarray:
        lam = np.sort(self._eigval_grid().ravel())
        return lam if m is None else lam[-int(m):]

    def eigenvectors(self, m=None) -> np.ndarray:
        lam = self._eigval_grid().ravel()
        m = len(lam) if m is None else int(m)
        order = np.argsort(lam, kind="stable")[-m:]
        cols = []
        for flat in order:
            idx = np.unravel_index(flat, self.grid_shape)
            v = self._modes[0][1][idx[0]]
            for ax in range(1, len(self.grid_shape)):
                v = np.kron(v, self._modes[ax][1][idx[ax]])
            cols.append(v)
        return np.stack(cols, axis=1)


def funm_multiply_krylov(f, A, b, *, assume_a="general", t=1.0, atol=0.0,
                         rtol=1e-6, restart_every_m=None, max_restarts=20):
    """scipy.sparse.linalg.funm_multiply_krylov-shaped; see
    :func:`sparse_matrix_tpu.solvers.funm_krylov.funm_multiply_krylov`."""
    a = _ascsr_maybe(A)
    op = a if isinstance(a, (CsrMatrix, LinearOperator)) else _ascsr(A)
    return _funm_multiply_krylov(
        f, op, b, assume_a=assume_a, t=t, atol=atol, rtol=rtol,
        restart_every_m=restart_every_m, max_restarts=max_restarts)


SuperLU = SpluFactor  # scipy names the splu return type SuperLU

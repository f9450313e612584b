"""Incomplete factorizations (ILU(0) / IC(0)) and triangular solves.

New scope beyond the reference (whose solver layer does not exist — its
host-kernel stance, ``spam_csr/src/mul_hash.rs:13-36``, is the model for
where the sequential factorization lives: the native C++ runtime).

Device-first design:

* **Factorization on the host** (``native/src/spmx_native.cpp::spmx_ilu0_*``,
  IKJ row variant on the fixed CSR pattern): ILU(0) is sequential along the
  row-dependency chain, exactly the irregular work the native runtime
  exists for. Python fallback when the library is absent.
* **Triangular solves on device by Jacobi sweeps**: for triangular ``T``
  split as ``D + N``, the iteration ``x <- D^{-1}(b - N x)`` has the
  strictly-triangular (hence *nilpotent*) iteration matrix ``D^{-1}N`` —
  it is EXACT after ``depth(T)`` sweeps and each sweep is one SpMV on the
  framework's fast formats (DIA/aligned/LanePack). A fixed small sweep
  count is the classic Chow-Patel approximate triangular solve; PCG safety
  comes from using the SAME sweep count on ``L`` and ``L^T`` so the
  composite preconditioner is ``S^T S`` (symmetric PSD) by construction.
* **Exact solves on the host** (``spmx_trisolve_*``) for setup-time work,
  oracles, and small systems.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

__all__ = [
    "IluFactors",
    "ilu0",
    "ilut",
    "ilut_preconditioner",
    "ic0",
    "trisolve_host",
    "TriangularJacobi",
    "ilu_preconditioner",
    "ic_preconditioner",
    "ic_pcg_solve",
    "save_ilu_factors",
    "load_ilu_factors",
]


def _diag_positions(a) -> np.ndarray:
    """Per-row position of the diagonal entry in CSR storage (-1 if absent).

    Requires sorted column indices (CSR invariant 7 variant — callers pass
    ``is_sorted`` matrices).
    """
    diag_pos = np.full(a.rows, -1, dtype=np.int64)
    rid = a.row_ids()
    mask = a.indices.astype(np.int64) == rid
    diag_pos[rid[mask]] = np.flatnonzero(mask)
    return diag_pos


class IluFactors(NamedTuple):
    """ILU(0) factors ``A ~= L @ U`` on A's sparsity pattern.

    ``l`` is unit-lower-triangular (explicit 1.0 diagonal), ``u`` is upper
    triangular including the pivots. Both sorted CSR.
    """

    l: object  # CsrMatrix
    u: object  # CsrMatrix


def _factor_vals(a):
    """Run ILU(0) in place on a copy of A's values; returns (vals, diag_pos)."""
    from ..native import ilu0_native

    if not a.is_sorted:
        raise ValueError("ilu0 requires sorted CSR (use from_dok / sort first)")
    if a.rows != a.cols:
        raise ValueError("ilu0 requires a square matrix")
    vals = np.ascontiguousarray(a.vals).copy()
    diag_pos = _diag_positions(a)
    rc = ilu0_native(a.rows, a.cols, a.offsets, a.indices, vals, diag_pos)
    if rc is None:
        rc = _ilu0_python(a.rows, a.offsets, a.indices.astype(np.int64), vals, diag_pos)
    if rc >= 0:
        raise ValueError(f"ilu0: zero pivot in row {rc}")
    return vals, diag_pos


def _ilu0_python(rows, offsets, indices, vals, diag_pos):
    """Pure-Python IKJ fallback (same semantics as spmx_ilu0_*)."""
    w = {}
    for i in range(rows):
        b, e = int(offsets[i]), int(offsets[i + 1])
        for t in range(b, e):
            w[int(indices[t])] = t
        for t in range(b, e):
            k = int(indices[t])
            if k >= i:
                break
            dk = int(diag_pos[k])
            if dk < 0 or vals[dk] == 0:
                return k
            f = vals[t] / vals[dk]
            vals[t] = f
            for s in range(dk + 1, int(offsets[k + 1])):
                p = w.get(int(indices[s]))
                if p is not None:
                    vals[p] -= f * vals[s]
        if diag_pos[i] < 0 or vals[int(diag_pos[i])] == 0:
            return i
        w.clear()
    return -1


def ilu0(a) -> IluFactors:
    """ILU(0): incomplete LU on A's own sparsity pattern (no fill)."""
    from ..formats.csr import CsrMatrix

    vals, _ = _factor_vals(a)
    rid = a.row_ids()
    cid = a.indices.astype(np.int64)
    lower = cid < rid
    upper = cid >= rid
    dtype = vals.dtype
    # L: strict lower + explicit unit diagonal
    lr = np.concatenate([rid[lower], np.arange(a.rows, dtype=np.int64)])
    lc = np.concatenate([cid[lower], np.arange(a.rows, dtype=np.int64)])
    lv = np.concatenate([vals[lower], np.ones(a.rows, dtype=dtype)])
    l = CsrMatrix.from_coo(a.rows, a.cols, lr, lc, lv)
    u = CsrMatrix.from_coo(a.rows, a.cols, rid[upper], cid[upper], vals[upper])
    return IluFactors(l, u)


def ic0(a):
    """IC(0): incomplete Cholesky ``A ~= L @ L^T`` for symmetric positive
    definite ``A`` (pattern of A's lower triangle).

    Computed from the ILU(0) identity for symmetric input, ``U = D L^T``:
    ``L_c = L_unit @ sqrt(D)``. Raises if any pivot is non-positive (not
    an M-matrix-like input).
    """
    from ..formats.csr import CsrMatrix

    vals, diag_pos = _factor_vals(a)
    d = vals[diag_pos]
    if (d <= 0).any():
        bad = int(np.flatnonzero(d <= 0)[0])
        raise ValueError(f"ic0: non-positive pivot in row {bad} (input not SPD?)")
    sq = np.sqrt(d.astype(np.float64)).astype(vals.dtype)
    rid = a.row_ids()
    cid = a.indices.astype(np.int64)
    lower = cid < rid
    lr = np.concatenate([rid[lower], np.arange(a.rows, dtype=np.int64)])
    lc = np.concatenate([cid[lower], np.arange(a.rows, dtype=np.int64)])
    # column-scale the unit-lower factor by sqrt(d); diagonal becomes sqrt(d)
    lv = np.concatenate([vals[lower] * sq[cid[lower]], sq])
    return CsrMatrix.from_coo(a.rows, a.cols, lr, lc, lv)


def trisolve_host(t, b, *, lower: bool, unit: bool = False) -> np.ndarray:
    """Exact host triangular solve ``T x = b`` (native, Python fallback)."""
    from ..native import trisolve_native

    b = np.asarray(b)
    x = np.ascontiguousarray(b, dtype=t.vals.dtype).copy()
    diag_pos = _diag_positions(t)
    vals = np.ascontiguousarray(t.vals)
    rc = trisolve_native(
        t.rows, t.offsets, t.indices, vals, diag_pos, x, lower=lower, unit=unit
    )
    if rc is None:
        idx = t.indices.astype(np.int64)
        order = range(t.rows) if lower else range(t.rows - 1, -1, -1)
        for i in order:
            bb, e = int(t.offsets[i]), int(t.offsets[i + 1])
            acc = x[i]
            for s in range(bb, e):
                j = int(idx[s])
                if (lower and j < i) or (not lower and j > i):
                    acc -= vals[s] * x[j]
            if not unit:
                d = int(diag_pos[i])
                if d < 0 or vals[d] == 0:
                    rc = i
                    break
                acc /= vals[d]
            x[i] = acc
        else:
            rc = -1
    if rc >= 0:
        raise ValueError(f"trisolve: zero pivot in row {rc}")
    return x


class TriangularJacobi:
    """Device triangular solve by Jacobi sweeps on a triangular CSR ``T``.

    ``T = D + N`` with strictly-triangular ``N``; ``x_{k+1} = D^{-1}(b - N
    x_k)`` starting from ``x_0 = D^{-1} b``. ``D^{-1}N`` is nilpotent, so
    ``sweeps >= depth(T) - 1`` is exact; small fixed counts give the
    Chow-Patel approximate solve. ``N`` is applied through a planned
    :class:`~sparse_matrix_tpu.ops.operator.SpmvOperator`, so each sweep
    rides the DIA/aligned/LanePack fast paths; vectors and (n, K) blocks
    both work (the block path uses the true SpMM kernels).
    """

    def __init__(self, t, *, sweeps: int = 4, dtype=np.float32, force=None,
                 values_dtype=None):
        import jax.numpy as jnp

        from ..formats.csr import CsrMatrix
        from ..ops.operator import SpmvOperator

        if t.rows != t.cols:
            raise ValueError("triangular solve needs a square operator")
        self.sweeps = int(sweeps)
        rid = t.row_ids()
        cid = t.indices.astype(np.int64)
        diag_pos = _diag_positions(t)
        if (diag_pos < 0).any():
            raise ValueError("triangular factor is missing a diagonal entry")
        d = t.vals[diag_pos].astype(np.float64)
        if (d == 0).any():
            raise ValueError("triangular factor has a zero diagonal")
        self.dinv = jnp.asarray((1.0 / d).astype(dtype))
        strict = cid != rid
        n_mat = CsrMatrix.from_coo(
            t.rows, t.cols, rid[strict], cid[strict], t.vals[strict].astype(dtype)
        )
        # values_dtype=bfloat16: half-width planes on the strict part N
        # when its format supports them (preconditioner-grade — the sweep
        # polynomial is approximate by construction; dinv stays f32).
        self.n_op = None
        if values_dtype is not None:
            try:
                self.n_op = SpmvOperator(n_mat, dtype=dtype, force=force,
                                         values_dtype=values_dtype)
            except ValueError:
                pass
        if self.n_op is None:
            self.n_op = SpmvOperator(n_mat, dtype=dtype, force=force)
    def __call__(self, b):
        dinv = self.dinv if b.ndim == 1 else self.dinv[:, None]
        apply_n = self.n_op if b.ndim == 1 else self.n_op.matmat
        x = dinv * b
        for _ in range(self.sweeps):
            x = dinv * (b - apply_n(x))
        return x

    def as_pytree(self):
        """Device arrays as a pytree for passing the trisolve as a jit
        ARGUMENT (see :meth:`SpmvOperator.as_pytree` for why: closure-
        captured factors embed tens of MB of constants per program at
        2048²+ scale)."""
        return {"dinv": self.dinv, "n": self.n_op.as_pytree()}

    def apply(self, params, b):
        """Vector trisolve using :meth:`as_pytree` params (jit-traceable
        with ``params`` as an argument)."""
        dinv = params["dinv"]
        x = dinv * b
        for _ in range(self.sweeps):
            x = dinv * (b - self.n_op.apply(params["n"], x))
        return x


def ilu_preconditioner(a, *, sweeps: int = 4, dtype=np.float32, force=None,
                       values_dtype=None) -> Callable:
    """``M^{-1} r ~= U^{-1} L^{-1} r`` from ILU(0), both solves by Jacobi
    sweeps on device. For unsymmetric systems (BiCGStab / GMRES)."""
    f = ilu0(a)
    sl = TriangularJacobi(f.l, sweeps=sweeps, dtype=dtype, force=force,
                          values_dtype=values_dtype)
    su = TriangularJacobi(f.u, sweeps=sweeps, dtype=dtype, force=force,
                          values_dtype=values_dtype)
    return lambda r: su(sl(r))


def ic_preconditioner(a, *, sweeps: int = 4, dtype=np.float32, force=None,
                      values_dtype=None) -> Callable:
    """Symmetric PSD ``M^{-1} ~= L^{-T} L^{-1}`` from IC(0).

    Both solves use the same sweep count, so the lower-solve polynomial
    ``S`` and the upper-solve polynomial are exact transposes and
    ``M^{-1} = S^T S`` — symmetric PSD for ANY sweep count, which is what
    PCG requires (an *inexact* unsymmetric pairing would silently break
    the CG three-term recurrence)."""
    lc = ic0(a)
    sl = TriangularJacobi(lc, sweeps=sweeps, dtype=dtype, force=force,
                          values_dtype=values_dtype)
    su = TriangularJacobi(lc.transpose(), sweeps=sweeps, dtype=dtype, force=force,
                          values_dtype=values_dtype)
    return lambda r: su(sl(r))


def ic_pcg_solve(a, b, *, sweeps: int = 4, tol: float = 1e-6, maxiter: int = 1000,
                 dtype=np.float32, force=None, values_dtype=None):
    """IC(0)-preconditioned CG on a host CSR operator (whole solve jits
    into one ``lax.while_loop``; see :func:`~.cg.pcg_solve`)."""
    from ..ops.operator import SpmvOperator
    from .cg import pcg_solve

    op = SpmvOperator(a, dtype=dtype, force=force)
    m_inv = ic_preconditioner(a, sweeps=sweeps, dtype=dtype, force=force,
                              values_dtype=values_dtype)
    return pcg_solve(op, b, m_inv, tol=tol, maxiter=maxiter)


def _ilut_python(rows, cols, offsets, indices, vals, tau, p):
    """Pure-Python ILUT fallback (same semantics as spmx_ilut_*)."""
    import heapq

    l_rows, u_rows = [], []
    u_store = []  # per-row list [(col, val)], diagonal first
    for i in range(rows):
        w = {}
        norm2 = 0.0
        heap = []
        for t in range(int(offsets[i]), int(offsets[i + 1])):
            j = int(indices[t])
            v = float(vals[t])
            w[j] = w.get(j, 0.0) + v
            norm2 += v * v
            if j < i:
                heapq.heappush(heap, j)
        taui = tau * np.sqrt(norm2)
        last = -1
        while heap:
            k = heapq.heappop(heap)
            if k == last or k not in w:
                continue
            last = k
            wk = w[k]
            if abs(wk) < taui:
                w[k] = 0.0
                continue
            urow = u_store[k]
            wk /= urow[0][1]
            w[k] = wk
            for j, uv in urow[1:]:
                upd = wk * uv
                if j not in w:
                    if abs(upd) < taui:
                        continue
                    w[j] = -upd
                    if j < i:
                        heapq.heappush(heap, j)
                else:
                    w[j] -= upd
        # commit the diagonal at storage precision (the native engine stores
        # factors in V): a double pivot that underflows to 0 in vals.dtype
        # must report zero-pivot here, not produce inf/NaN factors later
        diag = float(np.asarray(w.get(i, 0.0), dtype=vals.dtype))
        if diag == 0.0:
            raise ValueError(f"ilut: zero pivot in row {i}")
        lpart = sorted(
            ((abs(v), j, v) for j, v in w.items() if j < i and v != 0.0 and abs(v) >= taui),
            reverse=True,
        )[:p]
        upart = sorted(
            ((abs(v), j, v) for j, v in w.items() if j > i and v != 0.0 and abs(v) >= taui),
            reverse=True,
        )[:p]
        l_rows.append([(j, v) for _a, j, v in lpart])
        u_store.append([(i, diag)] + [(j, v) for _a, j, v in upart])
    return l_rows, u_store


def ilut(a, *, tau: float = 1e-3, p: int = 10) -> IluFactors:
    """ILUT(p, tau): threshold incomplete LU with per-row fill cap
    (Saad's dual-dropping rule — entries under ``tau * ||row||_2`` vanish,
    then only the ``p`` largest survive per L/U part; the diagonal always
    stays). Stronger than :func:`ilu0` on matrices whose inverse needs
    fill; ``tau=0, p>=n`` degenerates to exact LU.

    Native C++ (the sequential row elimination with a lazy min-heap);
    Python fallback when the library is absent.
    """
    from ..formats.csr import CsrMatrix
    from ..native import ilut_native

    if not a.is_sorted:
        raise ValueError("ilut requires sorted CSR")
    if a.rows != a.cols:
        raise ValueError("ilut requires a square matrix")
    if p < 1:
        raise ValueError("ilut needs p >= 1")
    vals = np.ascontiguousarray(a.vals)
    out = ilut_native(a.rows, a.cols, a.offsets, a.indices, vals, tau=tau, p=p)
    dtype = vals.dtype
    n = a.rows
    if out is not None:
        l_cnt, l_idx, l_val, u_cnt, u_idx, u_val = out
        li = np.repeat(np.arange(n, dtype=np.int64), l_cnt)
        keep_l = (np.arange(n * p) % p) < np.repeat(l_cnt, p)
        lr = np.concatenate([li, np.arange(n, dtype=np.int64)])
        lc = np.concatenate([l_idx[keep_l].astype(np.int64), np.arange(n, dtype=np.int64)])
        lv = np.concatenate([l_val[keep_l], np.ones(n, dtype=dtype)])
        ui = np.repeat(np.arange(n, dtype=np.int64), u_cnt)
        keep_u = (np.arange(n * (p + 1)) % (p + 1)) < np.repeat(u_cnt, p + 1)
        ur, uc, uv = ui, u_idx[keep_u].astype(np.int64), u_val[keep_u]
    else:
        l_rows, u_rows = _ilut_python(
            a.rows, a.cols, a.offsets, a.indices.astype(np.int64), vals, tau, p
        )
        lr = np.concatenate(
            [np.full(len(rw), i, np.int64) for i, rw in enumerate(l_rows)]
            + [np.arange(n, dtype=np.int64)]
        ) if n else np.zeros(0, np.int64)
        lc = np.concatenate(
            [np.array([j for j, _ in rw], np.int64) for rw in l_rows]
            + [np.arange(n, dtype=np.int64)]
        ) if n else np.zeros(0, np.int64)
        lv = np.concatenate(
            [np.array([v for _, v in rw], dtype) for rw in l_rows]
            + [np.ones(n, dtype=dtype)]
        ) if n else np.zeros(0, dtype)
        ur = np.concatenate([np.full(len(rw), i, np.int64) for i, rw in enumerate(u_rows)])
        uc = np.concatenate([np.array([j for j, _ in rw], np.int64) for rw in u_rows])
        uv = np.concatenate([np.array([v for _, v in rw], dtype) for rw in u_rows])
    l = CsrMatrix.from_coo(n, n, lr, lc, lv)
    u = CsrMatrix.from_coo(n, n, ur, uc, uv)
    return IluFactors(l, u)


def ilut_preconditioner(a, *, tau: float = 1e-3, p: int = 10, sweeps: int = 4,
                        dtype=np.float32, force=None) -> Callable:
    """``M^{-1} r ~= U^{-1} L^{-1} r`` from ILUT — the stronger (more
    fill) sibling of :func:`ilu_preconditioner`."""
    f = ilut(a, tau=tau, p=p)
    sl = TriangularJacobi(f.l, sweeps=sweeps, dtype=dtype, force=force)
    su = TriangularJacobi(f.u, sweeps=sweeps, dtype=dtype, force=force)
    return lambda r: su(sl(r))


def save_ilu_factors(path, f: IluFactors) -> None:
    """Persist ILU/ILUT factors (npz) — resume skips the factorization."""
    np.savez(
        path,
        l_vals=f.l.vals, l_indices=f.l.indices, l_offsets=f.l.offsets,
        u_vals=f.u.vals, u_indices=f.u.indices, u_offsets=f.u.offsets,
        shape=np.array([f.l.rows, f.l.cols], np.int64),
    )


def load_ilu_factors(path) -> IluFactors:
    """Inverse of :func:`save_ilu_factors`."""
    from ..formats.csr import CsrMatrix

    z = np.load(path)
    rows, cols = (int(v) for v in z["shape"])
    return IluFactors(
        CsrMatrix(rows, cols, z["l_vals"], z["l_indices"], z["l_offsets"], is_sorted=True),
        CsrMatrix(rows, cols, z["u_vals"], z["u_indices"], z["u_offsets"], is_sorted=True),
    )

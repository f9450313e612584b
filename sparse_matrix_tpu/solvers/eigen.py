"""Eigenvalue solvers driven by the planned SpMV operator.

Solver-layer breadth beyond CG: power iteration (dominant eigenpair) and a
fixed-iteration Lanczos tridiagonalization for extremal eigenvalues of
symmetric operators. Everything is one jitted ``lax``-loop; the matvec is
any callable (SpmvOperator, distributed SpMV, ...).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "PowerResult",
    "power_iteration",
    "inverse_power_iteration",
    "lanczos",
    "eigsh_extremal",
    "eigs",
]


class PowerResult(NamedTuple):
    eigenvalue: jnp.ndarray
    eigenvector: jnp.ndarray
    iterations: jnp.ndarray


def power_iteration(
    matvec: Callable, n: int, *, tol: float = 1e-6, maxiter: int = 500, seed: int = 0
) -> PowerResult:
    """Dominant eigenpair by power iteration with Rayleigh quotient."""
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jnp.float32)
    v0 = v0 / jnp.linalg.norm(v0)

    def cond(state):
        _v, lam, lam_prev, k = state
        return jnp.logical_and(jnp.abs(lam - lam_prev) > tol * jnp.abs(lam) + 1e-30, k < maxiter)

    def body(state):
        v, lam, _prev, k = state
        w = matvec(v)
        lam_new = jnp.vdot(v, w).real
        v = w / jnp.maximum(jnp.linalg.norm(w), 1e-30)
        return v, lam_new, lam, k + 1

    v, lam, _prev, k = jax.lax.while_loop(
        cond, body, (v0, jnp.float32(0), jnp.float32(jnp.inf), jnp.int32(0))
    )
    return PowerResult(eigenvalue=lam, eigenvector=v, iterations=k)


def lanczos(matvec: Callable, n: int, m: int, *, seed: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """m-step Lanczos: returns (alpha (m,), beta (m-1,)) of the tridiagonal
    projection of a symmetric operator (full reorthogonalization omitted —
    fine for extremal-eigenvalue estimates)."""
    q = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jnp.float32)
    q = q / jnp.linalg.norm(q)

    def body(carry, _):
        q_prev, q_cur, beta_prev = carry
        w = matvec(q_cur) - beta_prev * q_prev
        alpha = jnp.vdot(q_cur, w).real
        w = w - alpha * q_cur
        beta = jnp.linalg.norm(w)
        q_next = w / jnp.maximum(beta, 1e-30)
        return (q_cur, q_next, beta), (alpha, beta)

    (_, _, _), (alphas, betas) = jax.lax.scan(
        body, (jnp.zeros_like(q), q, jnp.float32(0)), None, length=m
    )
    return alphas, betas[:-1]


def eigsh_extremal(matvec: Callable, n: int, *, m: int = 50, seed: int = 0):
    """(lambda_min, lambda_max) estimates from the Lanczos tridiagonal."""
    alphas, betas = lanczos(matvec, n, m, seed=seed)
    t = np.diag(np.asarray(alphas)) + np.diag(np.asarray(betas), 1) + np.diag(np.asarray(betas), -1)
    ev = np.linalg.eigvalsh(t)
    return float(ev[0]), float(ev[-1])


def inverse_power_iteration(
    matvec: Callable,
    n: int,
    *,
    sigma: float = 0.0,
    tol: float = 1e-5,
    maxiter: int = 100,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 500,
    seed: int = 0,
    direct_a=None,
) -> PowerResult:
    """Eigenpair of a symmetric operator by (shift-)inverse iteration, with
    the linear solves done by the library's own solvers — solvers
    composing solvers.

    ``sigma = 0`` (default): smallest eigenpair of an SPD operator, inner
    solves by CG. ``sigma != 0``: the eigenpair NEAREST ``sigma``
    (shift-invert); ``A - sigma I`` is symmetric indefinite, so the inner
    solves switch to MINRES — or, when ``direct_a`` carries the host CSR
    of ``A``, to EXACT host solves from one up-front LDL^T factorization
    (``solvers/cholesky.py``; indefinite-safe, no per-iteration Krylov
    cost). Returns the eigenvalue of ``A`` itself (the Rayleigh
    quotient), not of the shifted operator.
    """
    from .cg import cg_solve
    from .minres import minres_solve

    if direct_a is not None:
        from ..formats.construct import eye as _speye
        from .cholesky import ldl, ldl_solve

        shifted = direct_a
        if sigma != 0.0:
            sh = _speye(direct_a.rows, dtype=np.float64)
            sh.vals[:] = -sigma
            shifted = direct_a + sh
        fac = ldl(shifted)
        solve = lambda rhs: jnp.asarray(  # noqa: E731
            ldl_solve(fac, np.asarray(rhs)).astype(np.float32)
        )
        op = matvec
    elif sigma == 0.0:
        solve = lambda rhs: cg_solve(  # noqa: E731
            matvec, rhs, tol=inner_tol, maxiter=inner_maxiter
        ).x
        op = matvec
    else:
        op = lambda u: matvec(u) - jnp.float32(sigma) * u  # noqa: E731
        solve = lambda rhs: minres_solve(  # noqa: E731
            op, rhs, tol=inner_tol, maxiter=inner_maxiter
        ).x

    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jnp.float32)
    v = v / jnp.linalg.norm(v)
    lam = jnp.float32(0)
    lam_prev = jnp.float32(jnp.inf)
    k = 0
    # host loop: each step is a full jitted solve
    for k in range(1, maxiter + 1):
        w = solve(v)
        w = w / jnp.maximum(jnp.linalg.norm(w), 1e-30)
        lam_prev, lam = lam, jnp.vdot(w, matvec(w)).real
        v = w
        if abs(float(lam - lam_prev)) <= tol * abs(float(lam)) + 1e-30:
            break
    return PowerResult(eigenvalue=lam, eigenvector=v, iterations=jnp.int32(k))


def eigs(matvec: Callable, n: int, k: int = 6, *, m: int = None, seed: int = 0):
    """Top-``k`` eigenpairs (by modulus) of a GENERAL square operator by
    m-step Arnoldi with full orthogonalization.

    The Arnoldi loop is one jitted ``lax.fori_loop`` holding the Krylov
    basis in a fixed (m+1, n) buffer (the same masked-basis trick as the
    GMRES inner loop); only the small (m, m) Hessenberg eigenproblem runs
    on the host. Eigenvalues/vectors of a real matrix may be complex:
    returns numpy ``(vals (k,) complex, vecs (n, k) complex)``.

    Complements :func:`eigsh_extremal` (symmetric-only Lanczos) for the
    nonsymmetric systems served by BiCGStab/GMRES.
    """
    if m is None:
        m = min(n, max(2 * k + 10, 20))
    m = int(min(max(m, k + 1), n))
    if k < 1 or k > n:
        raise ValueError(f"k={k} out of range for n={n}")

    @jax.jit
    def arnoldi(v0):
        basis = jnp.zeros((m + 1, n), jnp.float32).at[0].set(v0)
        h = jnp.zeros((m + 1, m), jnp.float32)

        def body(j, state):
            basis, h = state
            w = matvec(basis[j])
            coeff = jnp.dot(basis, w, precision=jax.lax.Precision.HIGHEST)
            keep = jnp.arange(m + 1) <= j
            coeff = jnp.where(keep, coeff, 0.0)
            w = w - jnp.dot(coeff, basis, precision=jax.lax.Precision.HIGHEST)
            # one reorthogonalization pass (classical Gram-Schmidt twice
            # == numerically modified; keeps the basis orthonormal at f32)
            coeff2 = jnp.where(keep, jnp.dot(basis, w, precision=jax.lax.Precision.HIGHEST), 0.0)
            w = w - jnp.dot(coeff2, basis, precision=jax.lax.Precision.HIGHEST)
            hnext = jnp.linalg.norm(w)
            live = hnext > 1e-6
            basis = basis.at[j + 1].set(
                jnp.where(live, w / jnp.maximum(hnext, 1e-30), 0.0)
            )
            hcol = (coeff + coeff2).at[j + 1].set(jnp.where(live, hnext, 0.0))
            return basis, h.at[:, j].set(hcol)

        return jax.lax.fori_loop(0, m, body, (basis, h))

    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jnp.float32)
    v0 = v0 / jnp.linalg.norm(v0)
    basis, h = arnoldi(v0)
    hm = np.asarray(h)[:m, :m].astype(np.float64)
    vals, vecs = np.linalg.eig(hm)
    order = np.argsort(-np.abs(vals))[:k]
    ritz_vals = vals[order]
    ritz_vecs = np.asarray(basis)[:m].T.astype(np.complex128) @ vecs[:, order]
    ritz_vecs = ritz_vecs / np.linalg.norm(ritz_vecs, axis=0, keepdims=True)
    return ritz_vals, ritz_vecs


def _shifted(a, sigma: float):
    from ..formats.construct import eye as _speye

    if sigma == 0.0:
        return a
    sh = _speye(a.rows, dtype=np.float64)
    sh.vals[:] = -float(sigma)
    return a + sh


def eigsh_shift_invert(
    a,
    k: int = 6,
    sigma: float = 0.0,
    *,
    m: int = None,
    seed: int = 0,
    reorder: str = "rcm",
) -> Tuple[np.ndarray, np.ndarray]:
    """``k`` eigenpairs of symmetric host CSR ``a`` NEAREST ``sigma``
    (scipy's ``eigsh(sigma=...)`` surface): ONE exact LDL^T factorization
    of ``A - sigma I`` (indefinite-safe, ``solvers/cholesky.py``), then
    ``m``-step host Lanczos with full reorthogonalization on the solve
    operator — interior eigenvalues of ``A`` map to EXTREMAL eigenvalues
    ``1/(lambda - sigma)`` of the inverse, where Lanczos converges fast.

    Host-path by design: the factorization is host-native anyway, so the
    Lanczos recurrence stays f64 next to it (same stance as the
    reference's host-irregular / device-regular split,
    ``spam_csr/src/mul_hash.rs``). Returns ``(vals, vecs)`` of ``A``
    itself, sorted by ``|val - sigma|``.
    """
    from .cholesky import ldl, ldl_solve

    n = a.rows
    if a.rows != a.cols:
        raise ValueError("eigsh_shift_invert needs a square matrix")
    if not 1 <= k < n:
        raise ValueError(f"k={k} out of range for n={n}")
    adaptive = m is None
    if adaptive:
        m = min(n, max(2 * k + 10, 20))
    m = int(min(max(m, k + 2), n))

    fac = ldl(_shifted(a, sigma), reorder=reorder)

    def run(m_try, kk, deflate, seed_i):
        """One Lanczos sweep orthogonal to the ``deflate`` rows; returns
        the kk Ritz pairs nearest sigma."""
        rng = np.random.default_rng(seed_i)
        v = rng.standard_normal(n)
        if deflate.shape[0]:
            v -= deflate.T @ (deflate @ v)
        v /= np.linalg.norm(v)
        basis = np.zeros((m_try, n))
        alphas = np.zeros(m_try)
        betas = np.zeros(m_try)
        for j in range(m_try):
            basis[j] = v
            w = ldl_solve(fac, v)
            alphas[j] = float(w @ v)
            # full reorthogonalization (twice is enough, Parlett) against
            # both the running basis and the locked/deflated vectors
            for _ in range(2):
                w -= basis[: j + 1].T @ (basis[: j + 1] @ w)
                if deflate.shape[0]:
                    w -= deflate.T @ (deflate @ w)
            beta = float(np.linalg.norm(w))
            betas[j] = beta
            if beta <= 1e-14:
                m_try = j + 1
                basis = basis[:m_try]
                alphas = alphas[:m_try]
                betas = betas[:m_try]
                break
            v = w / beta
        t = (np.diag(alphas) + np.diag(betas[: m_try - 1], 1)
             + np.diag(betas[: m_try - 1], -1))
        theta, y = np.linalg.eigh(t)
        keep = np.abs(theta) > 1e-14  # theta -> 0 = far end of the spectrum
        theta, y = theta[keep], y[:, keep]
        order = np.argsort(-np.abs(theta))[: min(kk, len(theta))]
        vals = sigma + 1.0 / theta[order]
        vecs = basis.T @ y[:, order]
        vecs /= np.linalg.norm(vecs, axis=0, keepdims=True)
        fine = np.argsort(np.abs(vals - sigma))
        return vals[fine], vecs[:, fine]

    if not adaptive:
        return run(m, k, np.zeros((0, n)), seed)

    # Adaptive path with locking restarts: one Krylov sequence holds at
    # most ONE copy of a degenerate eigenvalue, so converged pairs are
    # locked and the next sweep runs deflated against them — the restart
    # recovers the remaining copies of clustered/multiple eigenvalues.
    locked_v: list = []
    locked_x = np.zeros((0, n))
    seed_i = seed
    while len(locked_v) < k:
        vals, vecs = run(m, k - len(locked_v), locked_x, seed_i)
        # a fresh start vector every sweep — a failed sweep must not
        # restart with the same seed or it repeats verbatim forever
        seed_i += 1
        r = a.dot(vecs) - vecs * vals[None, :]
        rn = np.linalg.norm(r, axis=0)
        good = rn <= 1e-8 * np.maximum(1.0, np.abs(vals))
        if np.any(good):
            gx = vecs[:, good]
            # re-orthogonalize against already-locked before locking
            if locked_x.shape[0]:
                gx = gx - locked_x.T @ (locked_x @ gx)
                gx /= np.maximum(np.linalg.norm(gx, axis=0, keepdims=True),
                                 1e-30)
            locked_v.extend(vals[good].tolist())
            locked_x = np.concatenate([locked_x, gx.T], axis=0)
            continue
        if m >= n:
            # cannot do better: return locked + best unconverged residue;
            # an early Lanczos breakdown can leave vals SHORT of the need
            need = k - len(locked_v)
            take = min(need, vals.shape[0])
            locked_v.extend(vals[:take].tolist())
            locked_x = np.concatenate([locked_x, vecs[:, :take].T], axis=0)
            if len(locked_v) < k:
                import warnings

                warnings.warn(
                    f"eigsh_shift_invert: only {len(locked_v)} of k={k} "
                    "pairs resolved at the full-subspace exit (Lanczos "
                    "breakdown filtered the rest); returning the pairs "
                    "found", RuntimeWarning, stacklevel=2,
                )
            break
        m = min(n, 2 * m)
    kk = min(k, len(locked_v))
    vals = np.asarray(locked_v[:kk])
    vecs = locked_x[:kk].T
    fine = np.argsort(np.abs(vals - sigma))
    return vals[fine], vecs[:, fine]


def eigs_shift_invert(
    a,
    k: int = 6,
    sigma: float = 0.0,
    *,
    m: int = None,
    seed: int = 0,
    reorder: str = "rcm",
) -> Tuple[np.ndarray, np.ndarray]:
    """Unsymmetric counterpart of :func:`eigsh_shift_invert`: exact sparse
    LU (partial pivoting) of ``A - sigma I``, host Arnoldi with full
    orthogonalization on the solve operator, Ritz values mapped back by
    ``lambda = sigma + 1/theta``. Returns complex ``(vals, vecs)`` sorted
    by ``|val - sigma|``."""
    from .cholesky import lu, lu_solve

    n = a.rows
    if a.rows != a.cols:
        raise ValueError("eigs_shift_invert needs a square matrix")
    if not 1 <= k < n:
        raise ValueError(f"k={k} out of range for n={n}")
    if m is None:
        m = min(n, max(2 * k + 10, 20))
    m = int(min(max(m, k + 2), n))

    fac = lu(_shifted(a, sigma), reorder=reorder)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    basis = np.zeros((m + 1, n))
    h = np.zeros((m + 1, m))
    basis[0] = v
    actual = m
    for j in range(m):
        w = lu_solve(fac, basis[j])
        hj = basis[: j + 1] @ w
        w -= basis[: j + 1].T @ hj
        # second orthogonalization pass
        hj2 = basis[: j + 1] @ w
        w -= basis[: j + 1].T @ hj2
        h[: j + 1, j] = hj + hj2
        beta = float(np.linalg.norm(w))
        h[j + 1, j] = beta
        if beta <= 1e-14:
            actual = j + 1
            break
        basis[j + 1] = w / beta
    hm = h[:actual, :actual]
    theta, y = np.linalg.eig(hm)
    keep = np.abs(theta) > 1e-14
    theta, y = theta[keep], y[:, keep]
    order = np.argsort(-np.abs(theta))[:k]
    vals = sigma + 1.0 / theta[order]
    vecs = basis[:actual].T.astype(np.complex128) @ y[:, order]
    vecs /= np.linalg.norm(vecs, axis=0, keepdims=True)
    fine = np.argsort(np.abs(vals - sigma))
    return vals[fine], vecs[:, fine]

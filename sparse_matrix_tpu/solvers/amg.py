"""Smoothed-aggregation algebraic multigrid (AMG) preconditioner.

New scope beyond the reference (whose solver layer does not exist; the
nearest analog is the SpGEMM engine family this module composes — the
reference's centerpiece kernel ``mul_hash`` at
``spam_csr/src/mul_hash.rs:13-36`` corresponds to the engines behind
``CsrMatrix.__matmul__`` used here for the Galerkin triple products).

Device-first design:

* **Setup** runs on the host (numpy aggregation + the framework's own
  SpGEMM engines for ``P^T A P``), once per operator.
* **The V-cycle is a fixed linear operator**: static level count, static
  shapes, symmetric smoothing (weighted Jacobi or Chebyshev, identical
  pre/post), restriction = ``P^T``. It therefore jits into straight-line
  XLA — every level's ``A``/``P``/``P^T`` apply is a planned
  :class:`~sparse_matrix_tpu.ops.operator.SpmvOperator` (DIA / aligned /
  LanePack / ELL picked per level by structure), the coarsest solve is one
  small dense matmul, and the whole preconditioned CG runs as
  one ``lax.while_loop`` with zero host round-trips per iteration.
* Symmetry of ``M^{-1}`` (required by PCG) holds because pre- and
  post-smoothers are the same symmetric operator (``w*D^{-1}`` sweeps, or a
  fixed polynomial in ``D^{-1}A`` — both are l2-symmetric for symmetric
  ``A``) and restriction is the exact adjoint of prolongation.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = [
    "AmgHierarchy",
    "AmgLevel",
    "aggregate_strong",
    "amg_coarsen",
    "save_amg_coarsening",
    "load_amg_coarsening",
    "amg_preconditioner",
    "amg_pcg_solve",
    "amg_setup",
    "strength_graph",
    "tentative_prolongator",
]


# -- setup: strength, aggregation, prolongator (host, numpy) -----------------


def strength_graph(a, theta: float = 0.08) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric strength-of-connection graph of a CSR matrix.

    Edge (i, j), i != j, is *strong* when
    ``|a_ij| >= theta * sqrt(|a_ii| * |a_jj|)``. Returns the strong
    adjacency in CSR form ``(offsets, indices)`` (vectorized; no symmetry
    enforcement beyond what the input has — AMG callers pass symmetric
    operators). Runs in the native runtime when available (the numpy path
    below is the fallback and parity oracle).
    """
    from ..native import amg_strength_native

    res = amg_strength_native(a.rows, a.offsets, a.indices, a.vals, theta)
    if res is not None:
        return res[2], res[3]
    n = a.rows
    rids = a.row_ids().astype(np.int64)
    cids = a.indices.astype(np.int64)
    vals = np.abs(a.vals.astype(np.float64))

    diag = np.zeros(n, dtype=np.float64)
    on_diag = cids == rids
    diag[rids[on_diag]] = vals[on_diag]
    # rows with zero/missing diagonal: fall back to the row max so the
    # threshold stays meaningful instead of dividing by zero
    missing = diag == 0.0
    if missing.any():
        rowmax = np.zeros(n, dtype=np.float64)
        np.maximum.at(rowmax, rids, vals)
        diag[missing] = np.where(rowmax[missing] > 0, rowmax[missing], 1.0)

    keep = (~on_diag) & (vals >= theta * np.sqrt(diag[rids] * diag[cids]))
    sr, sc = rids[keep], cids[keep]
    offsets = np.zeros(n + 1, dtype=np.int64)
    offsets[1:] = np.bincount(sr, minlength=n)
    np.cumsum(offsets, out=offsets)
    return offsets, sc.astype(np.int64)


def aggregate_strong(
    n: int, s_offsets: np.ndarray, s_indices: np.ndarray
) -> Tuple[np.ndarray, int]:
    """Standard greedy smoothed-aggregation node clustering.

    Pass 1: a node whose strong neighborhood is entirely unaggregated seeds
    a new aggregate containing itself + all strong neighbors. Pass 2
    (vectorized): leftover nodes attach to an adjacent pass-1 aggregate.
    Pass 3: remaining connected leftovers form their own aggregates;
    fully isolated nodes become singletons. Returns ``(agg_id[n], n_agg)``
    with every node assigned.
    """
    from ..native import aggregate_pass_native

    agg = np.full(n, -1, dtype=np.int64)
    so, si = s_offsets, s_indices
    # pass 1 — order-dependent greedy (deterministic, natural ordering).
    # This is a lexicographically-first MIS of the neighborhood-overlap
    # conflict graph: inherently sequential (P-complete), so it runs in
    # the native runtime (exact same semantics; the Python loop below is
    # the SPMX_NO_NATIVE fallback and the parity oracle in test_amg.py)
    na = aggregate_pass_native(1, so, si, agg)
    if na is None:
        na = 0
        for i in range(n):
            if agg[i] >= 0:
                continue
            nb = si[so[i] : so[i + 1]]
            if nb.size and (agg[nb] >= 0).any():
                continue
            agg[nb] = na
            agg[i] = na
            na += 1

    # pass 2 — attach stragglers to a neighboring pass-1 aggregate (all
    # decisions read the pass-1 state). Native by default: the vectorized
    # numpy fallback below pays a full-edge-set np.repeat plus
    # np.minimum.at (~1.5 s of the 2048^2 setup profile combined)
    un = agg < 0
    if un.any() and aggregate_pass_native(2, so, si, agg) is None:
        deg = np.diff(so)
        edge_src = np.repeat(np.arange(n, dtype=np.int64), deg)
        emask = un[edge_src] & (agg[si] >= 0)
        if emask.any():
            src, tgt_agg = edge_src[emask], agg[si[emask]]
            # deterministic pick: the smallest adjacent aggregate id
            choice = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
            np.minimum.at(choice, src, tgt_agg)
            attach = choice < np.iinfo(np.int64).max
            agg[attach] = choice[attach]

    # pass 3 — remaining nodes (connected only to other leftovers)
    if (agg < 0).any():
        na3 = aggregate_pass_native(3, so, si, agg, na)
        if na3 is not None:
            return agg, na3
        for i in np.flatnonzero(agg < 0):
            if agg[i] >= 0:
                continue
            nb = si[so[i] : so[i + 1]]
            grp = nb[agg[nb] < 0] if nb.size else nb
            agg[i] = na
            if grp.size:
                agg[grp] = na
            na += 1
    return agg, na


def tentative_prolongator(agg: np.ndarray, n_agg: int, *, dtype=np.float64):
    """Piecewise-constant tentative prolongator ``P0`` (n x n_agg).

    Column j is the indicator of aggregate j normalized to unit 2-norm
    (the standard SA choice for the constant near-null-space vector), so
    ``P0^T P0 = I``.
    """
    from ..formats.csr import CsrMatrix

    n = agg.shape[0]
    counts = np.bincount(agg, minlength=n_agg).astype(np.float64)
    v = (1.0 / np.sqrt(counts[agg])).astype(dtype)
    # exactly one entry per row, rows in order: build directly (the
    # from_coo lexsort is O(n log n) for an already-sorted stream)
    return CsrMatrix(
        n, int(n_agg), v, agg.astype(np.uint32),
        np.arange(n + 1, dtype=np.int64), is_sorted=True,
    )


def _diag_of(a) -> np.ndarray:
    rids = a.row_ids().astype(np.int64)
    on_diag = a.indices.astype(np.int64) == rids
    d = np.zeros(a.rows, dtype=np.float64)
    d[rids[on_diag]] = a.vals[on_diag].astype(np.float64)
    return d


def _lambda_max_dinv_a(a, dinv: np.ndarray) -> float:
    """Gershgorin upper bound on rho(D^-1 A): max_i sum_j |a_ij| / |a_ii|."""
    rids = a.row_ids().astype(np.int64)
    s = np.bincount(rids, weights=np.abs(a.vals.astype(np.float64)), minlength=a.rows)
    return float(np.max(s * np.abs(dinv))) if a.nnz() else 1.0


def _jacobi_smoother_matrix(a, ws: np.ndarray):
    """``S = I - diag(ws) @ A`` reusing A's sparsity pattern (host CSR).

    Valid whenever every row of A holds an explicit diagonal entry (true
    for Galerkin/stencil operators); returns None otherwise so the caller
    can fall back to the union-merge subtraction. This turns the
    prolongator smoothing ``P = P0 - (diag(ws) A) P0`` into a single
    SpGEMM ``S @ P0`` — the round-2 setup profile spent 39 s of the 209 s
    2048^2 setup in the CSR subtraction alone."""
    from ..formats.csr import CsrMatrix
    from ..native import jacobi_smoother_native

    vals = jacobi_smoother_native(
        a.rows, a.offsets, a.indices, a.vals, np.asarray(ws, np.float64)
    )
    if vals is False:  # some row lacks an explicit diagonal
        return None
    if vals is None:  # native unavailable: numpy sweep
        rids = a.row_ids().astype(np.int64)
        on_diag = a.indices.astype(np.int64) == rids
        if int(on_diag.sum()) != a.rows:
            return None
        v64 = -a.vals.astype(np.float64) * ws[rids]
        v64[on_diag] += 1.0  # round once, like the native sweep
        vals = v64.astype(a.vals.dtype)
    # S aliases A's index/offset arrays: it is transient (consumed by one
    # SpGEMM, never mutated) and the copies were 1.1 s of the 2048^2 setup
    return CsrMatrix(
        a.rows, a.cols, vals, a.indices, a.offsets, is_sorted=a.is_sorted
    )


def _scale_rows(a, s: np.ndarray):
    """Row-scaled copy ``diag(s) @ A`` (host CSR; native sweep when
    available — the numpy path pays two full-nnz dtype temporaries)."""
    from ..formats.csr import CsrMatrix
    from ..native import scale_rows_native

    vals = scale_rows_native(a.rows, a.offsets, a.vals, np.asarray(s, np.float64))
    if vals is None:
        rids = a.row_ids().astype(np.int64)
        vals = (a.vals.astype(np.float64) * s[rids]).astype(a.vals.dtype)
    return CsrMatrix(
        a.rows,
        a.cols,
        vals,
        a.indices.copy(),
        a.offsets.copy(),
        is_sorted=a.is_sorted,
    )


# -- the hierarchy -----------------------------------------------------------


def _apply(op, v):
    """Apply a planned SpmvOperator to a vector or an (n, K) block.

    ``v.ndim`` is static under jit, so this Python branch traces to the
    right kernel: the SpMV path for vectors, the true SpMM path
    (K-fold operand-load amortization) for blocks."""
    return op(v) if v.ndim == 1 else op.matmat(v)


class AmgLevel(NamedTuple):
    a_op: Callable  # SpmvOperator for A_l
    p_op: Callable  # SpmvOperator for P_l  (n_l x n_{l+1})
    pt_op: Callable  # SpmvOperator for P_l^T
    dinv: object  # jnp (n_l,) inverse diagonal
    lam: float  # Gershgorin bound on rho(D^-1 A_l) (Chebyshev smoother)
    n: int
    nnz: int


class AmgHierarchy:
    """Immutable multigrid hierarchy; ``vcycle`` is jit-compatible."""

    def __init__(
        self,
        levels: List[AmgLevel],
        coarse_inv,
        *,
        smoother: str,
        nu: int,
        omega: float,
        cheb_degree: int,
        outer_a_op=None,
    ):
        self.levels = levels
        self.coarse_inv = coarse_inv  # jnp (nc, nc) dense inverse
        self.smoother = smoother
        self.nu = nu
        self.omega = omega
        self.cheb_degree = cheb_degree
        # full-precision finest-level operator for the OUTER Krylov matvec
        # when the hierarchy itself runs half-width value planes (the
        # V-cycle is a preconditioner; the outer residual must not be)
        self.outer_a_op = outer_a_op

    # -- smoothers (pre and post use the same symmetric operator) ----------
    def _smooth(self, lv: AmgLevel, x, r):
        """nu sweeps toward ``A x = r`` starting from ``x``.

        Broadcasts over (n, K) residual blocks: the level apply dispatches
        to the SpMM path and ``D^{-1}`` gains a trailing RHS axis."""
        import jax.numpy as jnp

        if self.smoother == "chebyshev":
            return _chebyshev_apply(
                lv, x, r, degree=self.cheb_degree, lam_max=lv.lam
            )
        w = jnp.asarray(self.omega, dtype=r.dtype)
        dinv = lv.dinv if r.ndim == 1 else lv.dinv[:, None]
        for _ in range(self.nu):
            x = x + w * dinv * (r - _apply(lv.a_op, x))
        return x

    def vcycle(self, r, level: int = 0):
        """One V-cycle applied to a residual: returns ``M^{-1} r``.

        ``r`` may be a vector (n,) or a column block (n, K) — the block
        form runs one V-cycle over all K residuals at once through the
        SpMM kernels (the multi-RHS PCG regime,
        :func:`~sparse_matrix_tpu.solvers.cg.pcg_solve_multi`)."""
        import jax
        import jax.numpy as jnp

        if level == len(self.levels):
            # full f32: the default GPU matmul may round to TF32
            return jnp.dot(self.coarse_inv, r, precision=jax.lax.Precision.HIGHEST)
        lv = self.levels[level]
        x = self._smooth(lv, jnp.zeros_like(r), r)
        d = r - _apply(lv.a_op, x)
        ec = self.vcycle(_apply(lv.pt_op, d), level + 1)
        x = x + _apply(lv.p_op, ec)
        return self._smooth(lv, x, r)

    def preconditioner(self) -> Callable:
        return lambda r: self.vcycle(r)

    # -- jit-argument form (large hierarchies) -----------------------------
    def as_pytree(self):
        """Every level's device arrays as one pytree, for passing the
        hierarchy as a jit ARGUMENT via :meth:`vcycle_p` — closure-captured
        hierarchies embed their operators as program constants (>100 MB at
        Poisson 2048²; see ``SpmvOperator.as_pytree``)."""
        return {
            "levels": [
                {
                    "a": lv.a_op.as_pytree(),
                    "p": lv.p_op.as_pytree(),
                    "pt": lv.pt_op.as_pytree(),
                    "dinv": lv.dinv,
                }
                for lv in self.levels
            ],
            "coarse_inv": self.coarse_inv,
        }

    def vcycle_p(self, params, r, level: int = 0):
        """:meth:`vcycle` with the hierarchy arrays supplied as ``params``
        (:meth:`as_pytree`); vector residuals, jacobi smoother."""
        import jax
        import jax.numpy as jnp

        if self.smoother != "jacobi":
            raise NotImplementedError("vcycle_p supports the jacobi smoother")
        if level == len(self.levels):
            return jnp.dot(params["coarse_inv"], r, precision=jax.lax.Precision.HIGHEST)
        lv = self.levels[level]
        lp = params["levels"][level]
        x = self._smooth_p(lv, lp, jnp.zeros_like(r), r)
        d = r - lv.a_op.apply(lp["a"], x)
        ec = self.vcycle_p(params, lv.pt_op.apply(lp["pt"], d), level + 1)
        x = x + lv.p_op.apply(lp["p"], ec)
        return self._smooth_p(lv, lp, x, r)

    def _smooth_p(self, lv, lp, x, r):
        import jax.numpy as jnp

        w = jnp.asarray(self.omega, dtype=r.dtype)
        for _ in range(self.nu):
            x = x + w * lp["dinv"] * (r - lv.a_op.apply(lp["a"], x))
        return x

    def __repr__(self) -> str:  # pragma: no cover
        rows = ", ".join(f"{lv.n}({lv.nnz}nnz)" for lv in self.levels)
        return (
            f"AmgHierarchy[{rows} -> coarse {self.coarse_inv.shape[0]}; "
            f"{self.smoother} nu={self.nu}]"
        )


def _chebyshev_apply(lv: AmgLevel, x, r, *, degree: int, lam_max: float):
    """Fixed-degree Chebyshev smoother on the interval
    ``[lam_max/30, 1.1*lam_max]`` of ``D^{-1} A`` (hypre's default window).
    Preconditioned Chebyshev iteration (Templates, alg. on p.35); a fixed
    polynomial in ``D^{-1}A`` applied identically pre/post, hence symmetric.
    """
    hi = 1.1 * lam_max
    lo = lam_max / 30.0
    d = (hi + lo) / 2.0
    c = (hi - lo) / 2.0
    dinv = lv.dinv if r.ndim == 1 else lv.dinv[:, None]
    res = r - _apply(lv.a_op, x)
    p = None
    alpha = 0.0
    for i in range(degree):
        z = dinv * res
        if i == 0:
            p = z
            alpha = 1.0 / d
        else:
            beta = (c * alpha / 2.0) ** 2
            alpha = 1.0 / (d - beta / alpha)
            p = z + beta * p
        x = x + alpha * p
        if i + 1 < degree:
            res = r - _apply(lv.a_op, x)
    return x


def amg_setup(
    a,
    *,
    theta: float = 0.08,
    smooth_prolongator: bool = True,
    max_levels: int = 12,
    coarse_size: int = 400,
    dtype=np.float32,
    smoother: str = "jacobi",
    nu: int = 1,
    omega: float = 2.0 / 3.0,
    cheb_degree: int = 3,
    operator_force: Optional[str] = None,
    verbose: bool = False,
    coarsening=None,
    values_dtype=None,
) -> AmgHierarchy:
    """Build a smoothed-aggregation hierarchy for symmetric M-matrix-like
    ``a`` (host CsrMatrix).

    Per level: strength graph -> greedy aggregation -> normalized tentative
    ``P0`` -> (optional) one damped-Jacobi smoothing step
    ``P = (I - omega_p D^{-1} A) P0`` with ``omega_p = 4/3 / lambda_max`` ->
    Galerkin coarse operator ``A_c = P^T A P`` through the framework's
    SpGEMM engines. Device operators are planned per level
    (:class:`SpmvOperator` auto format). ``operator_force`` pins the SpMV
    format on every level (tests / format ablations).
    """
    import jax.numpy as jnp

    from ..ops.operator import SpmvOperator

    if a.rows != a.cols:
        raise ValueError("AMG requires a square operator")

    levels: List[AmgLevel] = []
    if coarsening is not None:
        # precomputed / loaded host coarsening (save_amg_coarsening):
        # skip strength, aggregation, and the Galerkin products entirely
        host_levels, cur = coarsening
    else:
        host_levels, cur = amg_coarsen(
            a,
            theta=theta,
            smooth_prolongator=smooth_prolongator,
            max_levels=max_levels,
            coarse_size=coarse_size,
        )
    def _op(mat):
        # values_dtype=bfloat16: half-width value planes where the chosen
        # format supports them (the streaming dia/bell formats, which
        # carry the dominant nnz). A V-cycle is a PRECONDITIONER — an
        # inexact M^{-1} only perturbs the PCG iteration count, so
        # falling back to f32 on the remaining operators (per-operator,
        # explicit here, not inside SpmvOperator) keeps correctness while
        # the big streams run half-width.
        if values_dtype is not None:
            try:
                return SpmvOperator(
                    mat, dtype=dtype, force=operator_force,
                    values_dtype=values_dtype,
                )
            except ValueError:
                pass
        return SpmvOperator(mat, dtype=dtype, force=operator_force)

    for cur_l, p, dinv, lam in host_levels:
        lv_ops = (_op(cur_l), _op(p), _op(p.transpose()))
        levels.append(
            AmgLevel(
                a_op=lv_ops[0],
                p_op=lv_ops[1],
                pt_op=lv_ops[2],
                dinv=jnp.asarray(dinv.astype(dtype)),
                lam=lam,
                n=cur_l.rows,
                nnz=cur_l.nnz(),
            )
        )
        if verbose:  # pragma: no cover
            print(
                f"amg level {len(levels)-1}: n={cur_l.rows} nnz={cur_l.nnz()} "
                f"(P nnz={p.nnz()}), "
                f"fmt={lv_ops[0].format}/{lv_ops[1].format}/{lv_ops[2].format}"
            )

    dense = cur.to_dense().astype(np.float64)
    coarse_inv = jnp.asarray(np.linalg.pinv(dense).astype(dtype))
    outer = None
    if values_dtype is not None and host_levels:
        # plan a full-precision finest operator for the outer Krylov
        # matvec (reuses the level-0 matrix; the bf16 one above serves
        # only the V-cycle smoothers)
        outer = SpmvOperator(
            host_levels[0][0], dtype=dtype, force=operator_force
        )
    return AmgHierarchy(
        levels,
        coarse_inv,
        smoother=smoother,
        nu=nu,
        omega=omega,
        cheb_degree=cheb_degree,
        outer_a_op=outer,
    )


def amg_coarsen(
    a,
    *,
    theta: float = 0.08,
    smooth_prolongator: bool = True,
    max_levels: int = 12,
    coarse_size: int = 400,
):
    """Host coarsening loop shared by the single-chip and distributed
    hierarchies: returns ``(levels, coarse)`` where each level is
    ``(A_l, P_l, dinv_l, lam_l)`` (host CSRs / numpy) and ``coarse`` is
    the final small operator for a dense direct solve.

    Per level: strength graph -> greedy aggregation (native runtime) ->
    normalized tentative ``P0`` -> (optional) one damped-Jacobi smoothing
    step ``P = (I - omega_p D^{-1} A) P0``, ``omega_p = 4/3 / lambda_max``
    -> Galerkin ``A_c = P^T A P`` through the SpGEMM engines.
    """
    from ..native import amg_strength_native

    levels = []
    cur = a
    while cur.rows > coarse_size and len(levels) < max_levels:
        # standard density stop-rule: Galerkin coarse operators densify as
        # they shrink; once a level is >10% dense a direct coarse solve is
        # cheaper than more (near-dense) products and aggregation stalls
        # anyway (the 4096^2 run coarsened 1323 -> 789 -> 529(100% dense)
        # -> ... burning minutes of setup for no convergence gain)
        if cur.nnz() > 0.1 * cur.rows * cur.rows and cur.rows <= 20_000:
            break
        # fused per-level analysis: strength graph + signed diagonal +
        # Gershgorin row sums in three native sweeps (numpy fallback pays
        # ~10 temporaries; was ~100 s of the 600 s 4096^2 setup profile)
        res = amg_strength_native(cur.rows, cur.offsets, cur.indices, cur.vals, theta)
        if res is not None:
            dvec, abssum, so, si = res
        else:
            so, si = strength_graph(cur, theta)
            dvec, abssum = _diag_of(cur), None
        agg, n_agg = aggregate_strong(cur.rows, so, si)
        if n_agg >= cur.rows:  # no coarsening possible (e.g. diagonal A)
            break
        # build P in A's value dtype: mixed dtypes would route every
        # smoothing/Galerkin product onto the Python hash fallback
        # (measured 10x the native engine at the finest level)
        p = tentative_prolongator(agg, n_agg, dtype=cur.vals.dtype)
        dinv = np.where(dvec != 0.0, 1.0 / np.where(dvec == 0.0, 1.0, dvec), 1.0)
        if abssum is not None:
            lam = float(np.max(abssum * np.abs(dinv))) if cur.nnz() else 1.0
        else:
            lam = _lambda_max_dinv_a(cur, dinv)
        if smooth_prolongator:
            omega_p = (4.0 / 3.0) / lam
            # P = (I - omega_p D^-1 A) P0  (one Jacobi smoothing step) as a
            # SINGLE fused pass over A (native colmap_smoothed: P0 has one
            # entry per row, so no hash; per-term rounding identical to
            # materializing S then multiplying — parity test in
            # test_amg.py). Fallback: S-then-SpGEMM, then union-merge.
            from ..native import colmap_smoothed_native

            fused = colmap_smoothed_native(cur, omega_p * dinv, p)
            if fused is not None:
                p = fused
            else:
                s_mat = _jacobi_smoother_matrix(cur, omega_p * dinv)
                if s_mat is not None:
                    from ..ops.spgemm_block import spgemm_auto

                    p = spgemm_auto(s_mat, p, output_sorted=True)
                else:
                    # rows without an explicit diagonal: the identity
                    # widens the pattern — keep the union-merge path
                    p = p - (_scale_rows(cur, omega_p * dinv) @ p)
        levels.append((cur, p, dinv, lam))
        cur = _galerkin(p, cur)
    return levels, cur


def _galerkin(p, a):
    """Coarse operator ``P^T A P`` via the framework SpGEMM engines, with a
    sorted-output final product (level operators feed format planners that
    expect sorted CSR)."""
    from ..ops.spgemm_block import spgemm_auto

    ap = spgemm_auto(a, p, output_sorted=False)
    return spgemm_auto(p.transpose(), ap, output_sorted=True)


def amg_preconditioner(a, **kw) -> Callable:
    """One-call convenience: setup + return the ``M^{-1}`` closure for
    :func:`~sparse_matrix_tpu.solvers.cg.pcg_solve`."""
    return amg_setup(a, **kw).preconditioner()


def amg_pcg_solve(
    a,
    b,
    *,
    tol: float = 1e-6,
    maxiter: int = 200,
    hierarchy: Optional[AmgHierarchy] = None,
    **setup_kw,
):
    """PCG with an AMG V-cycle preconditioner, end to end.

    ``hierarchy`` reuses a prior :func:`amg_setup` (the amortized regime —
    setup once, solve many). A 2-D ``b`` of shape (n, K) solves all K
    systems in one lockstep block PCG (:func:`~.cg.pcg_solve_multi`), each
    iteration running ONE block V-cycle + ONE SpMM over all live columns.
    Solve repeatedly UNDER ``jax.jit`` (see ``cg.py`` docstring)."""
    import jax.numpy as jnp

    from .cg import pcg_solve, pcg_solve_multi

    hier = hierarchy if hierarchy is not None else amg_setup(a, **setup_kw)
    if getattr(hier, "outer_a_op", None) is not None:
        op = hier.outer_a_op
    elif hier.levels:
        op = hier.levels[0].a_op
    else:
        # degenerate: the whole problem fit on the coarse level
        from ..ops.operator import SpmvOperator

        op = SpmvOperator(a)
    if jnp.asarray(b).ndim == 2:
        return pcg_solve_multi(
            op.matmat, b, hier.preconditioner(), tol=tol, maxiter=maxiter
        )
    return pcg_solve(op, b, hier.preconditioner(), tol=tol, maxiter=maxiter)


def save_amg_coarsening(path, levels, coarse) -> None:
    """Persist an :func:`amg_coarsen` result (npz) — the checkpoint/resume
    analog for hierarchies: a later process skips strength/aggregation and
    every Galerkin product and only re-plans device operators."""
    payload = {"n_levels": np.int64(len(levels))}

    def put(prefix, m):
        payload[prefix + "vals"] = m.vals
        payload[prefix + "indices"] = m.indices
        payload[prefix + "offsets"] = m.offsets
        payload[prefix + "shape"] = np.array([m.rows, m.cols], np.int64)

    for i, (a_l, p_l, dinv, lam) in enumerate(levels):
        put(f"l{i}_a_", a_l)
        put(f"l{i}_p_", p_l)
        payload[f"l{i}_dinv"] = dinv
        payload[f"l{i}_lam"] = np.float64(lam)
    put("coarse_", coarse)
    np.savez(path, **payload)


def load_amg_coarsening(path):
    """Inverse of :func:`save_amg_coarsening`; returns ``(levels, coarse)``
    in :func:`amg_coarsen`'s format."""
    from ..formats.csr import CsrMatrix

    z = np.load(path)

    def get(prefix):
        rows, cols = (int(v) for v in z[prefix + "shape"])
        return CsrMatrix(
            rows, cols, z[prefix + "vals"], z[prefix + "indices"],
            z[prefix + "offsets"], is_sorted=True,
        )

    levels = []
    for i in range(int(z["n_levels"])):
        levels.append(
            (get(f"l{i}_a_"), get(f"l{i}_p_"), z[f"l{i}_dinv"], float(z[f"l{i}_lam"]))
        )
    return levels, get("coarse_")

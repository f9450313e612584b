"""Device-side AMG hierarchy refresh for same-pattern operator updates.

The expensive pieces of smoothed-aggregation setup — strength graph,
aggregation, prolongator smoothing, and the Galerkin triple products —
depend on A's *values* only through products whose sparsity STRUCTURE is
fixed once the pattern is fixed. In the lagged-prolongator regime
(Newton/quasi-Newton steps, implicit time stepping, parameter continuation:
A's values drift on a frozen pattern), standard practice freezes the
aggregates and prolongators and refreshes only the coarse operators
``A_{l+1} = P_l^T A_l P_l``.

With P frozen, each Galerkin product is a *fixed-side* same-pattern
SpGEMM, i.e. exactly ONE planned SpMV (:class:`~..ops.spgemm_spmv.
FixedSideSpgemm`): re-Galerkin of the whole hierarchy is a chain of
``2 x levels`` SpMVs that runs device-resident under one jit — no sorts,
no hashes, no host SpGEMM. The reference re-runs its full two-phase hash
engine per product on every re-setup (``/root/reference/spam_csr/src/
mul_hash.rs:106-201``); here the hash phase's routing decision is plan
data computed once.

Semantics: the refreshed hierarchy is EXACT for the frozen-P Galerkin
``P^T A_new P`` (values match a from-scratch product with the same frozen
P to f32 round-off); it differs from a full re-setup only in that P is
not re-smoothed against the new values — the standard lagged-AMG
trade-off. Smoother data is refreshed exactly: per-level ``dinv`` from
the new diagonals and the Gershgorin bound ``lam`` from the new row sums.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..formats.csr import CsrMatrix
from ..ops.spgemm_spmv import FixedSideSpgemm
from .amg import AmgHierarchy, amg_coarsen, amg_setup

__all__ = ["AmgRefresh"]


def _pattern_csr(out_row, out_col, rows: int, cols: int) -> CsrMatrix:
    """Sorted CSR skeleton from a plan's static output pattern (row-major
    out_row/out_col), with placeholder unit values — exactly what
    :func:`~..ops.device_sorted.padded_to_host` would build from a
    multiply, minus the multiply."""
    from ..formats.csr import INDEX_DTYPE, OFFSET_DTYPE

    row = np.asarray(out_row, np.int64)
    col = np.asarray(out_col)
    offsets = np.zeros(rows + 1, dtype=OFFSET_DTYPE)
    np.add.at(offsets, row + 1, 1)
    np.cumsum(offsets, out=offsets)
    return CsrMatrix(rows, cols, np.ones(len(row), np.float32),
                     col.astype(INDEX_DTYPE), offsets, is_sorted=True)


def _pattern_meta(m: CsrMatrix):
    """Precompute the value-independent pieces of dinv/lam for a pattern:
    positions of explicit diagonal entries and the row-segment offsets
    (refresh recomputes dinv exactly and lam as the Gershgorin bound —
    the same bound ``amg_coarsen`` uses on its native path)."""
    rids = m.row_ids().astype(np.int64)
    on_diag = np.flatnonzero(m.indices.astype(np.int64) == rids)
    return on_diag, rids[on_diag], m.offsets.astype(np.int64)


def _dinv_lam(vals: np.ndarray, rows: int, meta) -> Tuple[np.ndarray, float]:
    diag_pos, diag_row, offsets = meta
    dvec = np.zeros(rows, dtype=np.float64)
    dvec[diag_row] = vals[diag_pos].astype(np.float64)
    dinv = np.where(dvec != 0.0, 1.0 / np.where(dvec == 0.0, 1.0, dvec), 1.0)
    if len(vals):
        c = np.zeros(len(vals) + 1, dtype=np.float64)
        np.cumsum(np.abs(vals, dtype=np.float64), out=c[1:])
        abssum = c[offsets[1:]] - c[offsets[:-1]]
        lam = float(np.max(abssum * np.abs(dinv)))
    else:
        lam = 1.0
    return dinv, lam


class AmgRefresh:
    """Plan once, re-Galerkin on device as A's values drift.

    ``AmgRefresh(a, **coarsen_kw)`` runs the host coarsening once (or
    reuses a precomputed ``coarsening=`` from :func:`amg_coarsen` /
    :func:`load_amg_coarsening`), freezes every prolongator, and plans
    the fixed-pattern product chain. Afterwards:

    * :meth:`refresh_values` — jitted device chain: new finest values
      (CSR order) -> tuple of every coarse level's values (CSR order).
    * :meth:`refresh_coarsening` — host ``(levels, coarse)`` tuple with
      refreshed values, dinv, and Gershgorin lam per level; feeds
      ``amg_setup(coarsening=...)``.
    * :meth:`refresh` — one call to a new :class:`AmgHierarchy`.

    ``force=`` pins the SpMV format of the selection operators (they are
    cost-model dispatched by default, like any framework SpMV).
    """

    def __init__(self, a: CsrMatrix, *, theta: float = 0.08,
                 smooth_prolongator: bool = True, max_levels: int = 12,
                 coarse_size: int = 400, force: Optional[str] = None,
                 coarsening=None):
        if not a.is_sorted:
            raise ValueError("AmgRefresh requires a sorted CSR pattern")
        if coarsening is None:
            coarsening = amg_coarsen(
                a, theta=theta, smooth_prolongator=smooth_prolongator,
                max_levels=max_levels, coarse_size=coarse_size)
        host_levels, _ = coarsening
        self._check_device_budget(a, [p for (_, p, _, _) in host_levels])
        self._prolongators: List[CsrMatrix] = [p for (_, p, _, _) in host_levels]
        self._plans: List[Tuple[FixedSideSpgemm, FixedSideSpgemm]] = []
        self._patterns: List[CsrMatrix] = [a]
        self._meta = [_pattern_meta(a)]
        cur = a
        for p in self._prolongators:
            # self-consistent chain: level l+1's pattern is the STRUCTURAL
            # P^T A P product of the chain's own level-l pattern (a
            # superset of a value-compacted host product, never smaller).
            # Only PATTERNS thread through the plan — the varying side's
            # values never enter FixedSideSpgemm's plan data, so the
            # intermediate/coarse matrices are built from the plan's
            # out_row/out_col constants with placeholder values (skipping
            # two device multiplies + jit compiles per level at plan time)
            ap = FixedSideSpgemm(cur, p, fixed="rhs", force=force)
            ap_pat = _pattern_csr(ap.out_row_host, ap.out_col_host, ap.rows,
                                  ap.cols)
            rap = FixedSideSpgemm(p.transpose(), ap_pat, fixed="lhs",
                                  force=force)
            cur = _pattern_csr(rap.out_row_host, rap.out_col_host, rap.rows,
                               rap.cols)
            self._plans.append((ap, rap))
            self._patterns.append(cur)
            self._meta.append(_pattern_meta(cur))
        self._chain_jit = None

    @staticmethod
    def _check_device_budget(a: CsrMatrix, prolongators) -> None:
        """Pre-flight device-memory estimate: the plan keeps every level's
        two selection operators device-resident (776 MB at Poisson 1024²,
        3058 MB at 2048², linear in products; ~12 GB at 4096²). A plan past
        the device's memory would die mid-push with an opaque
        RESOURCE_EXHAUSTED, so estimate products from the patterns (cheap:
        two reps sums per level) and fail BEFORE planning with the
        designed alternatives. The budget is the device's own allocation
        limit (``debugflags.hbm_budget_bytes``); SPMX_HBM_BYTES overrides
        it (0 disables)."""
        from ..utils.debugflags import hbm_budget_bytes

        budget = hbm_budget_bytes()
        if budget <= 0 or not prolongators:
            return
        # calibration: total pushed plan bytes ~= 59 B per FINEST-level AP
        # product (all levels, both engines, slab padding included) —
        # 776 MB / 13.1M at Poisson 1024², 3058 MB / 52.4M at 2048²
        p = prolongators[0]
        reps = np.diff(p.offsets)[a.indices.astype(np.int64)]
        est = float(reps.sum()) * 59.0
        if est > budget - 4e9:  # A + templates + workspace headroom
            raise ValueError(
                f"AmgRefresh plan estimate ~{est/1e9:.1f} GB of device-"
                f"resident selection plans exceeds the HBM budget "
                f"({budget/1e9:.1f} GB - 4 GB headroom). Options: the "
                f"row-sharded distributed hierarchy (parallel/, "
                f"dist-amg-pcg), per-refresh amg_setup on host, or raise "
                f"SPMX_HBM_BYTES if the device is larger.")

    @property
    def num_levels(self) -> int:
        return len(self._plans)

    # -- device path --------------------------------------------------------

    def device_fn(self):
        """``(fn, params)`` with ``fn(params, vals0) -> tuple of coarse
        vals`` — the selection operators ride as jit ARGUMENTS (pytrees),
        so the compiled program stays small at scale (same rationale as
        ``SpmvOperator.as_pytree``)."""
        plans = self._plans

        params = tuple(
            (ap.op.as_pytree(), rap.op.as_pytree()) for ap, rap in plans)

        def fn(prm, v):
            outs = []
            for (ap, rap), (pa, pr) in zip(plans, prm):
                v = rap.op.apply(pr, ap.op.apply(pa, v))
                outs.append(v)
            return tuple(outs)

        return fn, params

    def _level_fns(self):
        """Per-LEVEL jitted Galerkin steps: per-level programs compile in
        ~sum-of-parts (one program holding all 2L SpMVs compiled far
        slower), and the levels still chain device-resident with async
        dispatch between them."""
        import jax

        if self._chain_jit is None:
            fns = []
            for ap, rap in self._plans:
                f = jax.jit(
                    lambda pa, pr, v, _ap=ap, _rap=rap:
                    _rap.op.apply(pr, _ap.op.apply(pa, v)))
                fns.append((f, ap.op.as_pytree(), rap.op.as_pytree()))
            self._chain_jit = fns
        return self._chain_jit

    def refresh_values(self, new_vals):
        """New finest-level values (CSR order, length ``a.nnz()``) ->
        tuple of refreshed values for levels ``1..L`` (CSR order each),
        computed on device (per-level jits, chained without host sync)."""
        import jax.numpy as jnp

        v = jnp.asarray(new_vals, jnp.float32)
        outs = []
        for f, pa, pr in self._level_fns():
            v = f(pa, pr, v)
            outs.append(v)
        return tuple(outs)

    # -- host assembly -------------------------------------------------------

    def refresh_coarsening(self, new_vals):
        """``(levels, coarse)`` for :func:`amg_setup(coarsening=...)`:
        refreshed level matrices (values pulled from the device chain),
        frozen prolongators, exact new ``dinv`` and Gershgorin ``lam``."""
        new_vals = np.asarray(new_vals)
        if new_vals.shape != self._patterns[0].vals.shape:
            raise ValueError(
                f"value vector length {new_vals.shape} does not match the "
                f"planned pattern nnz {self._patterns[0].vals.shape}")
        chain = [np.asarray(v) for v in self.refresh_values(new_vals)]
        level_vals = [new_vals] + chain
        levels = []
        for l, p in enumerate(self._prolongators):
            pat = self._patterns[l]
            vals = level_vals[l].astype(pat.vals.dtype)
            a_l = CsrMatrix(pat.rows, pat.cols, vals, pat.indices,
                            pat.offsets, is_sorted=True)
            dinv, lam = _dinv_lam(vals, pat.rows, self._meta[l])
            levels.append((a_l, p, dinv, lam))
        pat = self._patterns[-1]
        coarse = CsrMatrix(pat.rows, pat.cols,
                           level_vals[-1].astype(pat.vals.dtype),
                           pat.indices, pat.offsets, is_sorted=True)
        if not levels:
            coarse = CsrMatrix(pat.rows, pat.cols,
                               new_vals.astype(pat.vals.dtype),
                               pat.indices, pat.offsets, is_sorted=True)
        return levels, coarse

    def refresh(self, new_vals, **setup_kw) -> AmgHierarchy:
        """New values -> new :class:`AmgHierarchy` (device Galerkin chain
        + operator re-planning on the fixed patterns; smoother/V-cycle
        options pass through to :func:`amg_setup`)."""
        levels, coarse = self.refresh_coarsening(new_vals)
        return amg_setup(self._patterns[0], coarsening=(levels, coarse),
                         **setup_kw)

    # -- fully device-resident refresh (round 5) -----------------------------

    def _build_device_templates(self):
        """One-time template hierarchy + value maps for
        :meth:`refresh_device`.

        Every SpMV plan's value planes are a static slot layout over the
        CSR value vector, but the planners do not retain the permutation.
        Recover it GENERICALLY (any format, hybrid/split included) by
        probe-planning the same pattern twice with integer-encoding
        values — ``lo = i % 2048 + 1``, ``hi = i // 2048 + 1``, both
        exact in f32 — and decoding ``src = (hi-1)*2048 + (lo-1)`` per
        float leaf of ``as_pytree()`` (all float leaves are value planes
        or slot-preserving reformats of one; pad slots hold 0 -> mask).
        Probe operators are planned on the host CPU device so the probe
        planes never leave the host; only the decoded int32 ``src`` and
        bool ``mask`` maps are pushed.
        """
        import jax
        import jax.numpy as jnp
        import jax.tree_util as jtu

        from ..ops.operator import SpmvOperator
        from ..utils.transfer import to_device

        cpu = jax.local_devices(backend="cpu")[0]
        self._tmpl_ops, self._tmpl_trees, self._maps = [], [], []
        self._p_ops = []
        for lvl in range(len(self._prolongators)):
            pat = self._patterns[lvl]
            t_op = SpmvOperator(pat)
            fmt = t_op.format
            force = fmt if fmt in ("dia", "bell", "aligned", "stripe",
                                   "lanepack", "ell", "hybrid") else None
            nnz = pat.nnz()
            i = np.arange(nnz, dtype=np.int64)
            lo = (i % 2048 + 1).astype(np.float32)
            hi = (i // 2048 + 1).astype(np.float32)
            with jax.default_device(cpu):
                p_lo = SpmvOperator(
                    CsrMatrix(pat.rows, pat.cols, lo, pat.indices,
                              pat.offsets, is_sorted=True),
                    force=force).as_pytree()
                p_hi = SpmvOperator(
                    CsrMatrix(pat.rows, pat.cols, hi, pat.indices,
                              pat.offsets, is_sorted=True),
                    force=force).as_pytree()
            t_tree = t_op.as_pytree()
            if (jtu.tree_structure(p_lo) != jtu.tree_structure(t_tree)
                    or jtu.tree_structure(p_hi)
                    != jtu.tree_structure(t_tree)):
                raise RuntimeError(
                    f"probe plan structure diverged from template at "
                    f"level {lvl} (format {fmt}) — value-swap refresh "
                    f"unavailable; use refresh()")
            maps = []
            for leaf_t, leaf_lo, leaf_hi in zip(
                    jtu.tree_leaves(t_tree), jtu.tree_leaves(p_lo),
                    jtu.tree_leaves(p_hi)):
                alo = np.asarray(leaf_lo)
                if not np.issubdtype(alo.dtype, np.floating):
                    maps.append(None)
                    continue
                ahi = np.asarray(leaf_hi)
                mask = alo > 0.5
                src = np.where(
                    mask,
                    (ahi.astype(np.int64) - 1) * 2048
                    + alo.astype(np.int64) - 1,
                    0)
                maps.append((to_device(src.astype(np.int32)),
                             to_device(mask)))
            self._tmpl_ops.append(t_op)
            self._tmpl_trees.append(t_tree)
            self._maps.append(maps)
            p = self._prolongators[lvl]
            self._p_ops.append(
                (SpmvOperator(p), SpmvOperator(p.transpose())))

    def _swap_values(self, lvl: int, vals):
        import jax.numpy as jnp
        import jax.tree_util as jtu

        leaves = jtu.tree_leaves(self._tmpl_trees[lvl])
        treedef = jtu.tree_structure(self._tmpl_trees[lvl])
        out = []
        for leaf, mp in zip(leaves, self._maps[lvl]):
            if mp is None:
                out.append(leaf)
            else:
                src, mask = mp
                out.append(
                    jnp.where(mask, vals[src], 0).astype(leaf.dtype))
        return jtu.tree_unflatten(treedef, out)

    def refresh_device(self, new_vals, *, nu: int = 1,
                       omega: float = 2.0 / 3.0) -> AmgHierarchy:
        """New finest values -> :class:`AmgHierarchy` with NO host round
        trip of level values and NO operator re-planning: the Galerkin
        chain runs on device, each level operator's value planes are
        re-gathered in place (static slot maps), dinv/Gershgorin-lam are
        computed on device, and only the tiny coarse block is pulled for
        the dense pseudo-inverse. The refreshed hierarchy reuses the
        template plans (jacobi smoother; exact frozen-P semantics of
        :meth:`refresh`)."""
        import jax
        import jax.numpy as jnp

        from .amg import AmgLevel

        if getattr(self, "_tmpl_ops", None) is None:
            self._build_device_templates()
        vals0 = jnp.asarray(new_vals, jnp.float32)
        chain = self.refresh_values(vals0)
        level_vals = [vals0, *chain]
        levels = []
        for lvl in range(len(self._prolongators)):
            pat = self._patterns[lvl]
            v = level_vals[lvl]
            params_new = self._swap_values(lvl, v)
            diag_pos, diag_row, _off = self._meta[lvl]
            dvec = jnp.zeros(pat.rows, v.dtype).at[
                jnp.asarray(diag_row.astype(np.int32))].set(
                v[jnp.asarray(diag_pos.astype(np.int32))])
            dinv = jnp.where(dvec != 0, 1.0 / jnp.where(dvec == 0, 1.0,
                                                        dvec), 1.0)
            abs_params = self._swap_values(lvl, jnp.abs(v))
            t_op = self._tmpl_ops[lvl]
            rowabs = t_op.apply(abs_params, jnp.ones(pat.cols, v.dtype))
            lam = float(jnp.max(rowabs * jnp.abs(dinv)))
            p_op, pt_op = self._p_ops[lvl]
            levels.append(AmgLevel(
                a_op=_SwappedOp(t_op, params_new),
                p_op=p_op, pt_op=pt_op, dinv=dinv,
                lam=lam if lam > 0 else 1.0,
                n=pat.rows, nnz=pat.nnz()))
        cpat = self._patterns[-1]
        cvals = np.asarray(level_vals[-1], np.float64)
        dense = np.zeros((cpat.rows, cpat.cols))
        dense[cpat.row_ids().astype(np.int64),
              cpat.indices.astype(np.int64)] = cvals
        coarse_inv = jnp.asarray(
            np.linalg.pinv(dense).astype(np.float32))
        return AmgHierarchy(levels, coarse_inv, smoother="jacobi", nu=nu,
                            omega=omega, cheb_degree=3)


class _SwappedOp:
    """A template SpmvOperator with its value planes swapped on device —
    duck-typed as an operator for the V-cycle (vector applies; the
    multi-RHS matmat path would need the template's SpMM plans and is
    not wired)."""

    def __init__(self, template, params):
        self._op, self._params = template, params
        self.format = getattr(template, "format", None)

    def __call__(self, x):
        return self._op.apply(self._params, x)

    def as_pytree(self):
        return self._params

    def apply(self, params, x):
        return self._op.apply(params, x)

    def matmat(self, x):
        raise NotImplementedError(
            "refresh_device hierarchies support vector applies; use "
            "AmgRefresh.refresh() for the multi-RHS block V-cycle")

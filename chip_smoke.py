#!/usr/bin/env python3
"""Drive the library's main path once on a GPU and check every result.

    python chip_smoke.py          # one GPU: all phases below
    python chip_smoke.py --four   # four GPUs: the nine mesh strategies only

Phases (one process, one GPU): device and native library; planned SpMV at
Poisson 2048^2 (f32 and bf16 value planes, beside a device copy of the
same bytes) and on the three general-structure corpus operators under
auto dispatch and every general format;
multi-RHS matmat; CG, IC-PCG (``solve()``) and AMG-PCG at Poisson 2048^2
to 1e-5; SpGEMM engines against the native host engine; the tests marked
``gpu``; the dispatch calibration. Any failure raises and exits non-zero.
The last line of stdout is one JSON object naming the device.

Without a GPU the script fails at once; there is no CPU fallback. The phase
functions take their sizes as arguments, so the CPU tests run them small.

Tolerances (checks against float64 references on the host):
  SpMV/SpMM f32:  ||y - y_ref||_inf <= 1e-5 * || |A||x| ||_inf. Rounding of
                  a few hundred f32 products stays near 1e-6; a product
                  rounded to TF32 (2^-11 ~ 4.9e-4) would fail.
  bf16 planes:    the same bound at 2^-8 (bf16 keeps 8 significand bits;
                  Poisson's stencil values are exact in bf16).
  CG:             the recursive residual meets tol; the true residual,
                  recomputed in f64, stays within tol plus f32 CG's
                  attainable accuracy eps_f32 * cond(A).
  SpGEMM:         exact nnz and pattern; |c - c_ref| <= 1e-5 * (|A||B|)
                  entrywise (scatter-add order differs from run to run).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

TOL_F32 = 1e-5
TOL_BF16 = 2.0 ** -8
SOLVE_TOL = 1e-5
SPGEMM_TOL = 1e-5
EPS_F32 = float(np.finfo(np.float32).eps)

# AMG-PCG iterations the same code takes on the CPU backend for Poisson
# 2048^2, b = standard normal (seed 0), tol 1e-5 (amg_pcg_iterations(2048)
# with JAX_PLATFORMS=cpu). The GPU sums in another order, so the count may
# move by a few iterations, not more.
AMG_CPU_ITERATIONS = {2048: 15}
AMG_ITER_SLACK = 3


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# references and timing
# ---------------------------------------------------------------------------


def _scipy(m):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (m.vals.astype(np.float64), m.indices.astype(np.int64),
         m.offsets.astype(np.int64)), shape=(m.rows, m.cols))


def check_apply(name, a_sp, x, y, tol):
    """``||y - A x||_inf <= tol * || |A||x| ||_inf`` against float64;
    returns the ratio of the error to the bound's scale."""
    x64 = np.asarray(x, np.float64)
    ref = a_sp @ x64
    scale = float(np.abs(abs(a_sp) @ np.abs(x64)).max())
    err = float(np.abs(np.asarray(y, np.float64) - ref).max())
    rel = err / max(scale, 1e-300)
    if not np.all(np.isfinite(np.asarray(y))) or rel > tol:
        raise AssertionError(
            f"{name}: max error {err:.3e} over scale {scale:.3e} = "
            f"{rel:.3e} > tol {tol:.1e}")
    return rel


def time_loop(step, x0, params=None, *, min_seconds=0.2):
    """Seconds per call of ``step`` chained inside one jit, to
    ``block_until_ready`` (bench/runner.py)."""
    from sparse_matrix_tpu.bench.runner import bench_device_loop

    r = bench_device_loop("t", step, x0, iters=20, repeats=3,
                          min_loop_seconds=min_seconds, params=params)
    return r.seconds


def _inv_row_sum(m):
    """1 / max abs row sum: keeps chained applies bounded."""
    s = np.zeros(m.rows)
    np.add.at(s, m.row_ids(), np.abs(m.vals.astype(np.float64)))
    return float(1.0 / max(s.max(), 1e-30))


def corpus_operators(scale: str = "full"):
    """The three general-structure operators of bench.py, from seed 0."""
    from sparse_matrix_tpu.bench.corpus import (
        _fem_like, _power_law_rows, _random_local,
    )

    rng = np.random.default_rng(0)
    if scale == "full":
        return {
            "femlike_262k": _fem_like(rng, 512, 2),
            "randlocal_262k": _random_local(rng, 1 << 18, 16, 4096),
            "powerlaw_262k": _power_law_rows(rng, 1 << 18, 16),
        }
    return {
        "femlike": _fem_like(rng, 32, 2),
        "randlocal": _random_local(rng, 4096, 16, 512),
        "powerlaw": _power_law_rows(rng, 4096, 16),
    }


GENERAL_FORMATS = ("aligned", "lanepack", "bell", "stripe", "ell")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    """Devices, card, power limit, native library. Fails without a GPU."""
    import jax

    from sparse_matrix_tpu.native import build
    from sparse_matrix_tpu.native.loader import load_library
    from sparse_matrix_tpu.utils.gpu import nvidia_smi_power, require_gpu

    device = require_gpu()
    log(f"jax.devices(): {jax.devices()}")
    log(f"device_kind: {device['kind']}  count: {device['count']}")
    power = nvidia_smi_power()
    log(f"nvidia-smi name, power.limit: {power}")
    lib = load_library()
    log(f"native library loaded: {lib is not None}  path: {build.LIB}")
    if lib is None:
        raise RuntimeError("native library failed to build or load")
    return device, power


def phase_spmv(n: int = 2048, corpus_scale: str = "full", *, timing=True):
    """Planned SpMV vs a float64 scipy product: Poisson n^2 (DIA, f32 and
    bf16 planes) and the corpus operators under auto dispatch and every
    forced general format."""
    import jax.numpy as jnp

    from sparse_matrix_tpu.ops.operator import SpmvOperator
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    rng = np.random.default_rng(1)
    a = poisson_2d_csr(n, dtype=np.float32)
    a_sp = _scipy(a)
    x = rng.standard_normal(a.cols).astype(np.float32)
    xj = jnp.asarray(x)
    log(f"[spmv] poisson {n}^2: rows={a.rows} nnz={a.nnz()}")
    for tag, vdt, tol in (("f32", None, TOL_F32),
                          ("bf16", jnp.bfloat16, TOL_BF16)):
        op = SpmvOperator(a, values_dtype=vdt)
        rel = check_apply(f"poisson {tag}", a_sp, x, op(xj), tol)
        line = (f"[spmv] poisson{n} {tag} format={op.format} "
                f"err/scale={rel:.2e} tol={tol:.1e} ok")
        if timing:
            data = op.as_pytree()["dia"]["data"]
            t = time_loop(lambda p, v: op.apply(p, v) * 0.125, xj,
                          params=op.as_pytree())
            tc = time_loop(lambda v: -v, data)
            line += (f" apply={t*1e6:.2f}us copy(band data, read+write)="
                     f"{tc*1e6:.2f}us ({2*data.nbytes/tc/1e9:.0f} GB/s)")
        log(line)

    for cname, m in corpus_operators(corpus_scale).items():
        m_sp = _scipy(m)
        cx = rng.standard_normal(m.cols).astype(np.float32)
        cxj = jnp.asarray(cx)
        c = _inv_row_sum(m)
        for force in (None,) + GENERAL_FORMATS:
            if force == "lanepack" and not SpmvOperator._lanepack_viable(m):
                log(f"[spmv] {cname} force=lanepack not run: over the "
                    f"LanePack plan-size limit (SpmvOperator routes it "
                    f"elsewhere)")
                continue
            t0 = time.perf_counter()
            op = SpmvOperator(m, force=force)
            plan_s = time.perf_counter() - t0
            rel = check_apply(f"{cname} {force}", m_sp, cx, op(cxj), TOL_F32)
            line = (f"[spmv] {cname} force={force} format={op.format} "
                    f"err/scale={rel:.2e} tol={TOL_F32:.1e} ok "
                    f"plan={plan_s:.2f}s")
            if timing:
                t = time_loop(lambda p, v: op.apply(p, v) * c, cxj,
                              params=op.as_pytree())
                tc = _copy_time(op.bytes_per_apply())
                line += (f" apply={t*1e6:.2f}us copy(plan bytes, read+write)="
                         f"{tc*1e6:.2f}us")
            log(line)


def _copy_time(nbytes: int) -> float:
    """Chained read+write pass over ``nbytes`` of f32 on the device."""
    import jax.numpy as jnp

    return time_loop(lambda v: -v, jnp.ones(max(1, nbytes // 4), jnp.float32))


def _best_of(fn, repeats: int = 5) -> float:
    """Best wall of ``fn()`` to block_until_ready (after one warm call)."""
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def phase_matmat(n: int = 2048, corpus_scale: str = "full", k: int = 8,
                 *, timing=True):
    """``op.matmat`` with K columns: Poisson (DIA; the packed layout at
    2048^2), femlike through the packed BELL, aligned and LanePack paths,
    and the BCSR block SpMM."""
    import jax
    import jax.numpy as jnp

    from sparse_matrix_tpu.formats.bcsr import BsrMatrix
    from sparse_matrix_tpu.ops.operator import SpmvOperator
    from sparse_matrix_tpu.ops.spmm import _spmm_bcsr_jit, spmm_bcsr
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    rng = np.random.default_rng(2)
    fem = next(iter(corpus_operators(corpus_scale).values()))
    c = _inv_row_sum(fem)
    for name, m, force in (("poisson%d" % n, poisson_2d_csr(n, dtype=np.float32), None),
                           ("femlike", fem, "bell"), ("femlike", fem, "aligned"),
                           ("femlike", fem, "lanepack")):
        op = SpmvOperator(m, force=force)
        x = rng.standard_normal((m.cols, k)).astype(np.float32)
        y = op.matmat(jnp.asarray(x))
        rel = check_apply(f"{name} matmat", _scipy(m), x, y, TOL_F32)
        line = (f"[matmat] {name} K={k} format={op.format} "
                f"err/scale={rel:.2e} tol={TOL_F32:.1e} ok")
        if timing:
            sc = 0.125 if force is None else c
            t = time_loop(lambda v: op.matmat(v) * sc, jnp.asarray(x))
            tc = _copy_time(op.bytes_per_apply() + 2 * x.nbytes)
            line += (f" apply={t*1e6:.2f}us copy(plan+X+Y bytes)="
                     f"{tc*1e6:.2f}us")
        log(line)

    bsr = BsrMatrix.from_csr(fem, 128)
    f = 128
    x = rng.standard_normal((fem.cols, f)).astype(np.float32)
    y = spmm_bcsr(bsr, x)
    rel = check_apply("femlike bcsr", _scipy(fem), x, y, TOL_F32)
    line = (f"[matmat] femlike bcsr F={f} blocks={bsr.nnzb} "
            f"err/scale={rel:.2e} tol={TOL_F32:.1e} ok")
    if timing:
        blocks = jnp.asarray(bsr.blocks)
        brow = jnp.asarray(bsr.block_rows_expanded().astype(np.int32))
        bcol = jnp.asarray(bsr.block_cols.astype(np.int32))
        x3 = jnp.asarray(np.pad(x, ((0, bsr.bcols * 128 - x.shape[0]), (0, 0)))
                         .reshape(bsr.bcols, 128, f))
        kw = dict(brows=bsr.brows, bs=128, precision=jax.lax.Precision.HIGHEST)
        t = time_loop(lambda p, v: _spmm_bcsr_jit(p, brow, bcol, v, **kw) * c,
                      x3, params=blocks)
        tc = _copy_time(bsr.blocks.nbytes + 2 * x3.nbytes)
        line += f" apply={t*1e6:.2f}us copy(blocks+X+Y bytes)={tc*1e6:.2f}us"
    log(line)


def poisson_cond(n: int) -> float:
    """2-norm condition number of the n^2 five-point Laplacian."""
    t = np.pi / (2 * (n + 1))
    return float(1.0 / np.tan(t) ** 2)


def _check_solve(name, a_sp, b, res, cond, wall, extra=""):
    x = np.asarray(res.x, np.float64)[: a_sp.shape[0]]
    bn = float(np.linalg.norm(b))
    rec = float(res.residual_norm) / bn
    true = float(np.linalg.norm(b - a_sp @ x)) / bn
    bound = SOLVE_TOL + EPS_F32 * cond
    iters = int(res.iterations)
    ok = np.isfinite(x).all() and rec <= SOLVE_TOL * 1.01 and true <= bound
    log(f"[solve] {name}: iterations={iters} wall={wall:.3f}s "
        f"recursive={rec:.3e} true(f64)={true:.3e} "
        f"bound(tol+eps*cond)={bound:.3e} {'ok' if ok else 'FAIL'}{extra}")
    if not ok:
        raise AssertionError(f"{name} did not reach the tolerance")
    return iters


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def amg_pcg_iterations(n: int = 2048):
    """(iterations, residual) of AMG-PCG on Poisson n^2 with the smoke's
    right-hand side — the number AMG_CPU_ITERATIONS records."""
    import jax.numpy as jnp

    from sparse_matrix_tpu.solvers import amg_pcg_solve, amg_setup, poisson_2d_csr

    a = poisson_2d_csr(n, dtype=np.float32)
    b = np.random.default_rng(0).standard_normal(a.rows).astype(np.float32)
    h = amg_setup(a)
    res = amg_pcg_solve(a, jnp.asarray(b), tol=SOLVE_TOL, maxiter=500,
                        hierarchy=h)
    return int(res.iterations), float(res.residual_norm)


def phase_solvers(n: int = 2048, *, amg_cpu_iterations=None):
    """CG, solve() (IC(0)-PCG for SPD input) and AMG-PCG at tol 1e-5."""
    import jax
    import jax.numpy as jnp

    from sparse_matrix_tpu.ops.operator import SpmvOperator
    from sparse_matrix_tpu.solvers import (
        amg_pcg_solve, amg_setup, cg_solve, poisson_2d_csr, solve,
    )

    a = poisson_2d_csr(n, dtype=np.float32)
    a_sp = _scipy(a)
    b = np.random.default_rng(0).standard_normal(a.rows).astype(np.float32)
    bj = jnp.asarray(b)
    cond = poisson_cond(n)
    maxiter = 20 * n + 100

    op = SpmvOperator(a)
    cg = jax.jit(lambda p, bb: cg_solve(lambda v: op.apply(p, v), bb,
                                        tol=SOLVE_TOL, maxiter=maxiter))
    params = op.as_pytree()
    _, first = _timed(lambda: cg(params, bj))
    jax.clear_caches()
    _, after_clear = _timed(lambda: cg(params, bj))
    res, wall = _timed(lambda: cg(params, bj))
    _check_solve("cg", a_sp, b, res, cond, wall,
                 f" first_call={first:.3f}s "
                 f"first_call_after_clear_caches={after_clear:.3f}s")

    res, first = _timed(lambda: solve(a, b, tol=SOLVE_TOL))
    res, wall = _timed(lambda: solve(a, b, tol=SOLVE_TOL))
    _check_solve("solve() [IC(0)-PCG]", a_sp, b, res, cond, wall,
                 f" (each call plans and factors on the host) "
                 f"first_call={first:.3f}s")

    t0 = time.perf_counter()
    h = amg_setup(a)
    setup_s = time.perf_counter() - t0
    _, first = _timed(lambda: amg_pcg_solve(a, bj, tol=SOLVE_TOL,
                                            maxiter=500, hierarchy=h))
    res, wall = _timed(lambda: amg_pcg_solve(a, bj, tol=SOLVE_TOL,
                                             maxiter=500, hierarchy=h))
    iters = _check_solve("amg_pcg", a_sp, b, res, cond, wall,
                         f" setup(host)={setup_s:.2f}s first_call={first:.3f}s "
                         f"levels={len(h.levels)}")
    if amg_cpu_iterations is not None:
        if abs(iters - amg_cpu_iterations) > AMG_ITER_SLACK:
            raise AssertionError(
                f"amg_pcg took {iters} iterations; the CPU takes "
                f"{amg_cpu_iterations} (slack {AMG_ITER_SLACK})")
        log(f"[solve] amg_pcg iterations {iters} vs CPU "
            f"{amg_cpu_iterations} (slack {AMG_ITER_SLACK}) ok")


def _check_spgemm(name, a, b, c):
    """Exact pattern + entrywise |c - c_ref| <= tol * (|A||B|) against the
    native host hash engine."""
    from sparse_matrix_tpu.ops.spgemm_host import spgemm_hash_host

    ref = _scipy(spgemm_hash_host(a, b, output_sorted=True))
    got = _scipy(c)
    got.sort_indices()
    ref.sort_indices()
    if got.nnz != ref.nnz or not (
        np.array_equal(got.indptr, ref.indptr)
        and np.array_equal(got.indices, ref.indices)
    ):
        raise AssertionError(
            f"{name}: pattern differs (nnz {got.nnz} vs host {ref.nnz})")
    bound = (abs(_scipy(a)) @ abs(_scipy(b))).tocsr()
    bound.sort_indices()
    err = np.abs(got.data - ref.data)
    lim = SPGEMM_TOL * bound.data
    if not np.all(err <= lim):
        raise AssertionError(f"{name}: value error {float(err.max()):.3e}")
    log(f"[spgemm] {name}: nnz={got.nnz} pattern exact, "
        f"max |c-c_ref|/(|A||B|)={float((err / np.maximum(bound.data, 1e-300)).max()):.2e} "
        f"tol={SPGEMM_TOL:.0e} ok")


def phase_spgemm(n: int = 2048, rand_rows: int = 1 << 16, *, timing=True):
    """spgemm_auto on Poisson n^2 and a random-local matrix, and the
    device engines (ESC sort, block) directly, vs the native host engine."""
    import jax

    from sparse_matrix_tpu.bench.corpus import _random_local
    from sparse_matrix_tpu.ops.device_sorted import EscSpgemm
    from sparse_matrix_tpu.ops.spgemm_block import (
        BlockSpgemm, spgemm_auto, spgemm_block_device,
    )
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    p = poisson_2d_csr(n, dtype=np.float32)
    r = _random_local(np.random.default_rng(3), rand_rows, 16,
                      max(16, rand_rows // 64))
    r = type(r)(r.rows, r.cols, r.vals.astype(np.float32), r.indices,
                r.offsets, is_sorted=r.is_sorted)
    for name, m in ((f"poisson{n}", p), (f"randlocal{rand_rows}", r)):
        t0 = time.perf_counter()
        c = spgemm_auto(m, m)
        _check_spgemm(f"spgemm_auto {name} ({time.perf_counter()-t0:.2f}s)",
                      m, m, c)
    e = EscSpgemm(r, r, reduce="sort")
    _check_spgemm(f"EscSpgemm[{e.engine}, sort] randlocal{rand_rows}",
                  r, r, e.multiply())
    _check_spgemm(f"spgemm_block_device randlocal{rand_rows}", r, r,
                  spgemm_block_device(r, r))

    # the amortized device engines: one multiply on plans built once
    ph = poisson_2d_csr(max(8, n // 2), dtype=np.float32)
    ek = EscSpgemm(ph, ph, reduce="sort")
    _check_spgemm(f"EscSpgemm[{ek.engine}, sort] poisson{max(8, n // 2)}",
                  ph, ph, ek.multiply())
    bk = BlockSpgemm(r, r)
    _check_spgemm(f"BlockSpgemm randlocal{rand_rows}", r, r, bk.multiply())
    if timing:
        plan_bytes = sum(int(a.nbytes) for a in jax.tree_util.tree_leaves(
            ek.as_pytree()))
        log(f"[spgemm] EscSpgemm[{ek.engine}] poisson{max(8, n // 2)} "
            f"products={ek.num_products}: multiply_device "
            f"{_best_of(ek.multiply_device)*1e6:.1f}us, copy(plan bytes) "
            f"{_copy_time(plan_bytes)*1e6:.1f}us")
        blk_bytes = int(bk.a_blocks.nbytes + bk.b_blocks.nbytes)
        log(f"[spgemm] BlockSpgemm randlocal{rand_rows} pairs={bk.num_pairs}: "
            f"multiply_device {_best_of(bk.multiply_device)*1e6:.1f}us, "
            f"copy(A+B block bytes) {_copy_time(blk_bytes)*1e6:.1f}us")


class _Outcomes:
    """pytest plugin: counts passed/failed/skipped test calls."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def phase_gpu_tests():
    """The tests marked ``gpu``, in this process (one JAX process per card)."""
    import pytest

    os.environ["SPMX_GPU_TESTS"] = "1"  # conftest keeps the real backend
    plugin = _Outcomes()
    rc = pytest.main(
        ["-q", "-p", "no:cacheprovider", "-m", "gpu", "-rs",
         os.path.join(ROOT, "tests", "test_gpu.py")],
        plugins=[plugin],
    )
    log(f"[gpu tests] exit={rc} {plugin.counts}")
    if rc != 0 or plugin.counts["passed"] == 0 or plugin.counts["skipped"]:
        raise AssertionError(f"gpu tests: exit {rc}, {plugin.counts}")


def phase_calibration():
    """Measured dispatch constants beside the inherited defaults (not saved)."""
    from sparse_matrix_tpu.utils import autotune

    got = autotune.calibrate(save=False)
    for k in sorted(got):
        log(f"[calibrate] {k}: measured={got[k]:.4g} "
            f"default={autotune.DEFAULTS[k]:.4g}")
    return got


# ---------------------------------------------------------------------------
# four cards: the nine mesh strategies, each against its one-card answer
# ---------------------------------------------------------------------------


def _close(name, got, ref, tol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    if not (np.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{name}: 4-card vs 1-card {err:.3e} > {tol:.0e}")
    return err


def phase_four(n_solver: int = 2048, n_rest: int = 1024, ndev: int = 4):
    """Each strategy of ``parallel/`` on an ``ndev``-device mesh and on a
    one-device mesh, same problem, same process; returns the count."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sparse_matrix_tpu.bench.corpus import _random_local
    from sparse_matrix_tpu.formats.dia import try_dia_from_csr
    from sparse_matrix_tpu.ops.batched import BatchedEllOperator
    from sparse_matrix_tpu.parallel import (
        dist_amg_pcg_solve, dist_amg_setup, dist_batched_cg_solve,
        dist_cg_solve, dist_ic_pcg_solve, dist_ic_setup, dist_spmm_2d,
        dist_spmv_colsplit, dist_spmv_dia_halo, dist_spmv_stripe, make_mesh,
        make_mesh2d, prepare_dist_cg, shard_dia, shard_ell_2d,
        shard_ell_by_cols, shard_stripe,
    )
    from sparse_matrix_tpu.parallel.spgemm import dist_spgemm_2d
    from sparse_matrix_tpu.solvers import poisson_2d_csr
    from sparse_matrix_tpu.solvers.amg import amg_coarsen

    if len(jax.devices()) < ndev:
        raise RuntimeError(f"need {ndev} devices, have {jax.devices()}")
    rng = np.random.default_rng(4)
    meshes = {d: make_mesh(d) for d in (ndev, 1)}
    a_s = poisson_2d_csr(n_solver, dtype=np.float32)
    a_r = poisson_2d_csr(n_rest, dtype=np.float32)
    b_s = rng.standard_normal(a_s.rows).astype(np.float32)
    x_r = rng.standard_normal(a_r.rows).astype(np.float32)
    maxiter = 20 * n_solver + 100
    bn = float(np.linalg.norm(b_s))

    def padded(v, mesh, rows_pad):
        out = np.zeros(rows_pad, np.float32)
        out[: len(v)] = v
        return jax.device_put(jnp.asarray(out), NamedSharding(mesh, P("rows")))

    def both(fn):
        return {d: fn(meshes[d], d) for d in (ndev, 1)}

    def report(name, err, tol, extra=""):
        log(f"[four] {name}: {ndev}-card vs 1-card max rel diff {err:.2e} "
            f"(tol {tol:.0e}) ok{extra}")

    done = 0

    # 1. row-sharded CG (ELL operator, GSPMD collectives)
    def cg(mesh, d):
        ev, ec, bj, _ = prepare_dist_cg(a_s, b_s, mesh)
        res = dist_cg_solve(ev, ec, bj, mesh, tol=SOLVE_TOL, maxiter=maxiter)
        return np.asarray(res.x)[: a_s.rows], int(res.iterations), float(res.residual_norm)

    out = both(cg)
    for d, (_x, it, rn) in out.items():
        if rn > SOLVE_TOL * bn * 1.01:
            raise AssertionError(f"dist cg on {d} card(s) did not converge")
    err = _close("row-shard CG", out[ndev][0], out[1][0],
                 10 * EPS_F32 * poisson_cond(n_solver))
    report("row-shard CG", err, 10 * EPS_F32 * poisson_cond(n_solver),
           f" iterations {out[ndev][1]} vs {out[1][1]}")
    done += 1

    # 2. column-split SpMV (x sharded, partial products reduce-scattered)
    def colsplit(mesh, d):
        ev, ec, cols_pad = shard_ell_by_cols(a_r, mesh)
        y = jax.jit(lambda v: dist_spmv_colsplit(ev, ec, v, mesh))(
            padded(x_r, mesh, cols_pad))
        return np.asarray(y)[: a_r.rows]

    out = both(colsplit)
    report("column-split SpMV", _close("colsplit", out[ndev], out[1], TOL_F32), TOL_F32)
    done += 1

    # 3. halo-exchange DIA SpMV
    dia = try_dia_from_csr(a_r)

    def halo(mesh, d):
        ddata, rows_pad = shard_dia(dia, mesh)
        y = jax.jit(lambda v: dist_spmv_dia_halo(
            ddata, v, dia.offsets, mesh, rows_pad=rows_pad))(
            padded(x_r, mesh, rows_pad))
        return np.asarray(y)[: a_r.rows]

    out = both(halo)
    report("halo DIA SpMV", _close("halo", out[ndev], out[1], TOL_F32), TOL_F32)
    done += 1

    # 4. 2-D (rows x cols) mesh SpMM
    k = 8
    xk = rng.standard_normal((a_r.cols, k)).astype(np.float32)
    mesh2 = {ndev: make_mesh2d(2, ndev // 2), 1: make_mesh2d(1, 1)}

    def spmm2d(m2):
        ev, ec, _rp, cp = shard_ell_2d(a_r, m2)
        xp = np.zeros((cp, k), np.float32)
        xp[: a_r.cols] = xk
        xs = jax.device_put(jnp.asarray(xp), NamedSharding(m2, P("cols", None)))
        y = jax.jit(lambda v: dist_spmm_2d(ev, ec, v, m2))(xs)
        return np.asarray(y)[: a_r.rows]

    out = {d: spmm2d(mesh2[d]) for d in (ndev, 1)}
    report("2-D SpMM", _close("spmm2d", out[ndev], out[1], TOL_F32), TOL_F32)
    done += 1

    # 5. 2-D owner-computes SpGEMM
    out = {d: dist_spgemm_2d(a_r, a_r, mesh2[d], axes=("rows", "cols"))
           for d in (ndev, 1)}
    c4, c1 = _scipy(out[ndev]), _scipy(out[1])
    c4.sort_indices()
    c1.sort_indices()
    if not (np.array_equal(c4.indptr, c1.indptr)
            and np.array_equal(c4.indices, c1.indices)):
        raise AssertionError("2-D SpGEMM patterns differ")
    report("2-D SpGEMM", _close("spgemm2d", c4.data, c1.data, SPGEMM_TOL),
           SPGEMM_TOL, f" nnz {c4.nnz}")
    done += 1

    # 6. distributed AMG-PCG (host coarsening once, sharded per mesh)
    coarsening = amg_coarsen(a_s, theta=0.08, coarse_size=200, max_levels=12)

    def amg(mesh, d):
        h = dist_amg_setup(a_s, mesh, coarsening=coarsening)
        res = dist_amg_pcg_solve(
            h, padded(b_s, mesh, h.levels[0].rows_pad), tol=SOLVE_TOL,
            maxiter=500)
        return (np.asarray(res.x)[: a_s.rows], int(res.iterations),
                float(res.residual_norm))

    out = both(amg)
    for d, (_x, it, rn) in out.items():
        if rn > SOLVE_TOL * bn * 1.01:
            raise AssertionError(f"dist AMG-PCG on {d} card(s) did not converge")
    tol_amg = 10 * SOLVE_TOL * np.sqrt(poisson_cond(n_solver))
    err = _close("dist AMG-PCG", out[ndev][0], out[1][0], tol_amg)
    report("dist AMG-PCG", err, tol_amg,
           f" iterations {out[ndev][1]} vs {out[1][1]}")
    done += 1

    # 7. distributed IC(0)-PCG
    def ic(mesh, d):
        f = dist_ic_setup(a_s, mesh, sweeps=4)
        res = dist_ic_pcg_solve(f, padded(b_s, mesh, f.rows_pad),
                                tol=SOLVE_TOL, maxiter=maxiter)
        return (np.asarray(res.x)[: a_s.rows], int(res.iterations),
                float(res.residual_norm))

    out = both(ic)
    for d, (_x, it, rn) in out.items():
        if rn > SOLVE_TOL * bn * 1.01:
            raise AssertionError(f"dist IC-PCG on {d} card(s) did not converge")
    err = _close("dist IC-PCG", out[ndev][0], out[1][0], tol_amg)
    report("dist IC-PCG", err, tol_amg,
           f" iterations {out[ndev][1]} vs {out[1][1]}")
    done += 1

    # 8. batch-sharded CG over same-pattern systems
    pat = poisson_2d_csr(max(4, n_rest // 16), dtype=np.float32)
    bsz = 2 * ndev
    vals_b = np.stack([pat.vals * (1.0 + 0.25 * j / bsz)
                       for j in range(bsz)]).astype(np.float32)
    bmat = rng.standard_normal((bsz, pat.rows)).astype(np.float32)

    def batched(mesh, d):
        bop = BatchedEllOperator(pat, vals_b, dtype=np.float32)
        res = dist_batched_cg_solve(bop, bmat, mesh, tol=SOLVE_TOL,
                                    maxiter=20 * pat.rows)
        if not (np.asarray(res.residual_norm)
                <= SOLVE_TOL * np.linalg.norm(bmat, axis=1) * 1.01).all():
            raise AssertionError(f"batched CG on {d} card(s) did not converge")
        return np.asarray(res.x)

    out = both(batched)
    tol_b = 10 * SOLVE_TOL * np.sqrt(poisson_cond(int(np.sqrt(pat.rows))))
    report(f"batch-sharded CG ({bsz} systems of {pat.rows})",
           _close("batched", out[ndev], out[1], tol_b), tol_b)
    done += 1

    # 9. distributed stripe SpMV on a scatter-class operator
    sm = _random_local(rng, a_r.rows, 16, max(64, a_r.rows // 16))
    sm = type(sm)(sm.rows, sm.cols, sm.vals.astype(np.float32), sm.indices,
                  sm.offsets, is_sorted=sm.is_sorted)
    xs_h = rng.standard_normal(sm.cols).astype(np.float32)

    def stripe(mesh, d):
        arrs, meta = shard_stripe(sm, mesh, levels=2, kw=2)
        y = jax.jit(lambda aa, v: dist_spmv_stripe(aa, v, mesh, meta))(
            arrs, padded(xs_h, mesh, meta["rows_pad"]))
        return np.asarray(y)[: sm.rows]

    out = both(stripe)
    check_apply("dist stripe (4 cards) vs f64", _scipy(sm), xs_h, out[ndev], TOL_F32)
    report("dist stripe SpMV", _close("stripe", out[ndev], out[1], TOL_F32), TOL_F32)
    done += 1
    return done


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the nine mesh strategies on four GPUs")
    args = ap.parse_args(argv)

    from sparse_matrix_tpu.utils.compile_cache import enable_compile_cache
    from sparse_matrix_tpu.utils.gpu import nvidia_smi_power, require_gpu

    cache = enable_compile_cache()
    device = require_gpu()  # no GPU: fail before any phase
    log(f"compile cache: {cache}")
    t_all = time.perf_counter()

    def run(name, fn, *a, **kw):
        t0 = time.perf_counter()
        log(f"== phase {name}")
        out = fn(*a, **kw)
        log(f"== phase {name} passed in {time.perf_counter() - t0:.1f}s")
        return out

    if args.four:
        log(f"nvidia-smi name, power.limit: {nvidia_smi_power()}")
        if device["count"] < 4:
            raise RuntimeError(f"--four needs 4 GPUs, have {device['count']}")
        run("four", phase_four)
    else:
        run("device", phase_device)
        run("spmv", phase_spmv)
        run("matmat", phase_matmat)
        run("solvers", phase_solvers,
            amg_cpu_iterations=AMG_CPU_ITERATIONS[2048])
        run("spgemm", phase_spgemm)
        run("gpu-tests", phase_gpu_tests)
        run("calibration", phase_calibration)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()

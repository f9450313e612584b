"""Example: the preconditioner spectrum on one problem.

    python examples/preconditioners.py [grid_size]

Solves the same 2D Poisson system four ways — plain CG, Jacobi-PCG,
IC(0)-PCG (native factorization + device Jacobi-sweep triangular solves),
and smoothed-aggregation AMG-PCG — and prints iterations + wall time.
Setup cost scales with strength: none < diagonal < IC(0) < AMG; per-solve
speed goes the other way.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from sparse_matrix_tpu.ops.operator import SpmvOperator
from sparse_matrix_tpu.solvers import (
    amg_setup,
    cg_solve,
    ic_preconditioner,
    jacobi_preconditioner,
    pcg_solve,
    poisson_2d_csr,
)


def run(label, solve, setup_s):
    t0 = time.perf_counter()
    res = solve()
    _ = np.asarray(res.x)
    dt = time.perf_counter() - t0
    print(f"{label:14s} setup {setup_s:6.2f}s   solve {dt*1e3:8.1f} ms "
          f"(first call includes compile)   iters {int(res.iterations):5d}   "
          f"|r| {float(res.residual_norm):.2e}")


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    a = poisson_2d_csr(n, dtype=np.float32)
    op = SpmvOperator(a)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.rows).astype(np.float32)
    print(f"poisson {n}x{n}: {a.rows} unknowns, nnz={a.nnz()}, format={op.format}")

    run("plain CG", lambda: cg_solve(op, b, tol=1e-5, maxiter=5000), 0.0)

    t0 = time.perf_counter(); mj = jacobi_preconditioner(a)
    run("jacobi-PCG", lambda: pcg_solve(op, b, mj, tol=1e-5, maxiter=5000),
        time.perf_counter() - t0)

    t0 = time.perf_counter(); mic = ic_preconditioner(a, sweeps=4)
    run("IC(0)-PCG", lambda: pcg_solve(op, b, mic, tol=1e-5, maxiter=5000),
        time.perf_counter() - t0)

    t0 = time.perf_counter()
    hier = amg_setup(a, coarse_size=400, dtype=np.float32)
    mamg = hier.preconditioner()
    run("AMG-PCG", lambda: pcg_solve(op, b, mamg, tol=1e-5, maxiter=5000),
        time.perf_counter() - t0)


if __name__ == "__main__":
    from sparse_matrix_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

"""End-to-end example: solve the 2D Poisson problem with CG on the device.

    python examples/poisson_cg.py [grid_size]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from sparse_matrix_tpu.ops.operator import SpmvOperator
from sparse_matrix_tpu.solvers import cg_solve, poisson_2d_csr


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    a = poisson_2d_csr(n, dtype=np.float32)
    op = SpmvOperator(a)  # picks DIA for the 5-point stencil
    print(f"operator: {n*n} rows, nnz={a.nnz()}, format={op.format}")

    rng = np.random.default_rng(0)
    b = rng.standard_normal(n * n).astype(np.float32)

    t0 = time.perf_counter()
    res = cg_solve(op, b, tol=1e-5, maxiter=4000)
    x = np.asarray(res.x)  # forces completion
    dt = time.perf_counter() - t0

    r = np.linalg.norm(a.to_dense() @ x - b) if n <= 64 else float(res.residual_norm)
    print(f"converged in {int(res.iterations)} iterations, residual {float(res.residual_norm):.2e}, "
          f"wall {dt*1e3:.0f} ms (includes compile on first run)")


if __name__ == "__main__":
    from sparse_matrix_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

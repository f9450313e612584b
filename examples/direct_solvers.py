"""Example: the exact direct solvers (host f64, native C++ kernels).

    python examples/direct_solvers.py [grid_size]

Factors the same 2D Poisson system three ways and checks each against an
independent residual:

* ``chol``  — up-looking sparse Cholesky (SPD),
* ``ldl``   — LDL^T of the indefinite shifted operator A - sigma*I
  (what exact shift-invert uses),
* ``lu``    — partial-pivoted LU (works for any nonsingular matrix).

Direct solves are setup/oracle work and run on the host in f64; the
iterative solvers (examples/preconditioners.py) are the device path.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from sparse_matrix_tpu.formats import eye
from sparse_matrix_tpu.solvers import (
    chol,
    chol_solve,
    ldl,
    ldl_solve,
    lu,
    lu_solve,
    poisson_2d_csr,
)


def residual(a, x, b):
    return np.linalg.norm(a.matvec_host(x) - b) / np.linalg.norm(b)


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    a = poisson_2d_csr(n, dtype=np.float64)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.rows)
    print(f"2D Poisson {n}x{n}: {a.rows} unknowns, {a.nnz()} nonzeros")

    t0 = time.perf_counter()
    f = chol(a)
    x = chol_solve(f, b)
    print(
        f"chol : {time.perf_counter()-t0:6.2f}s  nnz(L)={f.l.nnz():>9}  "
        f"|r|/|b| = {residual(a, x, b):.2e}"
    )

    sigma = 1.2345  # inside the spectrum: A - sigma I is indefinite
    sh = eye(a.rows, dtype=np.float64)
    sh.vals[:] = -sigma
    shifted = a + sh
    t0 = time.perf_counter()
    fl = ldl(shifted)
    x = ldl_solve(fl, b)
    print(
        f"ldl  : {time.perf_counter()-t0:6.2f}s  nnz(L)={fl.l.nnz():>9}  "
        f"shifted |r|/|b| = {residual(shifted, x, b):.2e}  "
        f"(negative pivots: {(fl.d < 0).sum()})"
    )

    t0 = time.perf_counter()
    fu = lu(a)
    x = lu_solve(fu, b)
    print(
        f"lu   : {time.perf_counter()-t0:6.2f}s  nnz(L+U)={fu.l.nnz()+fu.u.nnz():>9}  "
        f"|r|/|b| = {residual(a, x, b):.2e}"
    )


if __name__ == "__main__":
    from sparse_matrix_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

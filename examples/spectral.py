"""Example: spectral tools — truncated SVD, general eigs, heat kernel.

    python examples/spectral.py

* top singular triplets of a sparse rectangular matrix (`svds_csr`),
* dominant eigenvalues of a nonsymmetric operator (`eigs`),
* graph diffusion ``exp(-t L) b`` on the Poisson Laplacian
  (`expm_multiply_csr`).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from sparse_matrix_tpu.core import DokMatrix
from sparse_matrix_tpu.formats import CsrMatrix
from sparse_matrix_tpu.ops.operator import SpmvOperator
from sparse_matrix_tpu.solvers import eigs, expm_multiply_csr, poisson_2d_csr, svds_csr


def main():
    rng = np.random.default_rng(0)

    # --- truncated SVD of a sparse 2000 x 800 matrix
    m, n = 2000, 800
    d = ((rng.random((m, n)) < 0.01) * rng.standard_normal((m, n))).astype(np.float64)
    a = CsrMatrix.from_dok(DokMatrix.from_dense(d))
    res = svds_csr(a, k=5, steps=60)  # clustered spectrum: extra steps
    print("top-5 singular values:", np.round(np.asarray(res.s), 3))
    print("  dense oracle:       ", np.round(np.linalg.svd(d, compute_uv=False)[:5], 3))

    # --- dominant eigenvalues of a nonsymmetric sparse operator
    nn = 600
    g = ((rng.random((nn, nn)) < 0.02) * rng.standard_normal((nn, nn))).astype(np.float64)
    ga = CsrMatrix.from_dok(DokMatrix.from_dense(g))
    op = SpmvOperator(ga, dtype=np.float32)
    vals, _vecs = eigs(op, nn, k=3, m=80)
    ref = np.linalg.eigvals(g)
    ref = ref[np.argsort(-np.abs(ref))][:3]
    print("dominant |eigenvalues| (arnoldi):", np.round(np.abs(vals), 4))
    print("  dense oracle:                  ", np.round(np.abs(ref), 4))

    # --- heat kernel on the 2D Poisson Laplacian (graph diffusion)
    p = poisson_2d_csr(64, dtype=np.float32)
    b = np.zeros(p.rows, np.float32)
    b[p.rows // 2 + 32] = 1.0  # point source
    for t in (0.05, 0.25, 1.0):
        y = np.asarray(expm_multiply_csr(p, b, t=-t))
        print(f"exp(-{t} L) delta: mass {y.sum():.4f}, spread (nnz>1e-6) "
              f"{int((np.abs(y) > 1e-6).sum())} cells")


if __name__ == "__main__":
    from sparse_matrix_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

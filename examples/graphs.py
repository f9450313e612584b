"""Graph algorithms on sparse adjacency: the matrix IS the graph.

Run: python examples/graphs.py

Walks the csgraph-parity surface (sparse_matrix_tpu/graph/): components,
shortest paths (host Dijkstra vs the device min-plus banded Bellman-Ford
— tropical-semiring SpMV on the DIA static-slice recipe), spanning
trees, matching/structural rank, Laplacian spectra via LOBPCG.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import sparse_matrix_tpu.graph as g
from sparse_matrix_tpu.formats.csr import CsrMatrix
from sparse_matrix_tpu.solvers import poisson_2d_csr


def main():
    rng = np.random.default_rng(0)

    # a weighted grid graph: the 2-D Poisson pattern with random edge costs
    n_side = 64
    p = poisson_2d_csr(n_side)
    w = CsrMatrix(
        p.rows, p.cols, rng.uniform(0.5, 3.0, p.nnz()).astype(np.float64),
        p.indices, p.offsets, is_sorted=True,
    )
    n = w.rows
    print(f"grid graph: {n} nodes, {w.nnz()} edges")

    nc, labels = g.connected_components(w, directed=False)
    print(f"components: {nc}")

    # multi-source shortest paths: the banded structure routes to the
    # device min-plus Bellman-Ford (one jitted while_loop to the fixpoint)
    sources = np.array([0, n // 2, n - 1])
    dist = g.shortest_path(w, indices=sources)
    print(f"device min-plus BF: dist matrix {dist.shape}, "
          f"max finite {dist[np.isfinite(dist)].max():.2f}")

    # cross-check one source against host Dijkstra (native heap)
    d0 = g.dijkstra(w, indices=0)
    assert np.allclose(dist[0], d0, rtol=1e-5)
    print("host Dijkstra agrees (rtol 1e-5, f32 device distances)")

    # spanning structure
    mst = g.minimum_spanning_tree(w)
    print(f"MST: {mst.nnz()} edges, total weight {mst.vals.sum():.2f}")
    order, _pred = g.breadth_first_order(w, 0, directed=False)
    print(f"BFS from 0 reaches {len(order)} nodes")

    # structural rank of a rectangular pattern
    from sparse_matrix_tpu.formats.construct import random_csr

    r = random_csr(200, 150, 0.03, rng)
    print(f"structural rank of a 200x150 random pattern: {g.structural_rank(r)}")

    # spectral: lambda_2 of the normalized Laplacian (Fiedler gap)
    lap = g.laplacian(w, normed=True)
    from sparse_matrix_tpu.ops.operator import SpmvOperator
    from sparse_matrix_tpu.solvers import lobpcg

    op = SpmvOperator(lap, dtype=np.float32)
    x0 = rng.standard_normal((n, 2)).astype(np.float32)
    res = lobpcg(op.matmat, x0, largest=False, tol=1e-4, maxiter=300)
    lam = np.sort(np.asarray(res.eigenvalues))
    print(f"normalized-Laplacian lambda_1,2 = {lam[0]:.4f}, {lam[1]:.4f} "
          f"(lambda_1 ~ 0 for a connected graph)")


if __name__ == "__main__":
    from sparse_matrix_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

"""Benchmark corpus: MatrixMarket directory walker + synthetic generators.

The reference benches walk a ``matrices/`` directory of MatrixMarket files
(``gen_bench_mul!``, ``spam_csr/src/lib.rs:386-437``); the corpus itself was
never committed (``TODO.md:1-2``). With zero egress we cannot fetch
SuiteSparse, so :func:`generate_corpus` synthesizes a structurally diverse
stand-in (banded, uniform random, power-law rows, blocked) and saves it as
MatrixMarket, exercising the same I/O path the reference benches use.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

from ..core.dok import DokMatrix
from ..core.matrix_market import load_matrix_market_csr, save_matrix_market
from ..formats.csr import CsrMatrix
from ..solvers.poisson import poisson_2d_csr

__all__ = ["generate_corpus", "iter_corpus", "DEFAULT_CORPUS_DIR"]

DEFAULT_CORPUS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "matrices")


def _random_uniform(rng, n, density) -> CsrMatrix:
    nnz = int(n * n * density)
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    return CsrMatrix.from_coo(n, n, r, c, v)


def _power_law_rows(rng, n, avg_nnz, alpha: float = 1.5) -> CsrMatrix:
    # scale-free-ish row lengths: a few very heavy rows (the load-balancer
    # stress case the reference's rows_to_threads exists for)
    lens = np.minimum((rng.pareto(alpha, n) + 1) * avg_nnz / 3, n).astype(np.int64)
    r = np.repeat(np.arange(n), lens)
    c = rng.integers(0, n, len(r))
    v = rng.standard_normal(len(r))
    return CsrMatrix.from_coo(n, n, r, c, v)


def _blocked(rng, n, block, density_in_block) -> CsrMatrix:
    nb = n // block
    rows, cols, vals = [], [], []
    for bi in range(nb):
        for bj in (bi - 1, bi, bi + 1):
            if 0 <= bj < nb:
                k = int(block * block * density_in_block)
                rows.append(bi * block + rng.integers(0, block, k))
                cols.append(bj * block + rng.integers(0, block, k))
                vals.append(rng.standard_normal(k))
    return CsrMatrix.from_coo(
        n, n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    )


def _random_local(rng, n, per_row, bandwidth) -> CsrMatrix:
    """Unstructured but *local* matrix: random columns within a band around
    the diagonal — the FEM/circuit/RCM-reordered shape real unstructured
    corpora have (SuiteSparse matrices are rarely uniform-random; most have
    strong locality; uniform-random structure is the slab formats' corner
    case)."""
    r = np.repeat(np.arange(n, dtype=np.int64), per_row)
    off = rng.integers(-bandwidth, bandwidth + 1, size=len(r))
    c = np.clip(r + off, 0, n - 1)
    v = rng.standard_normal(len(r))
    return CsrMatrix.from_coo(n, n, r, c, v)


def _fem_like(rng, n_side, jitter) -> CsrMatrix:
    """9-point stencil with per-entry index jitter: the clustered-locality
    shape of assembled FEM operators (unstructured but index-local)."""
    n = n_side * n_side
    offs = np.array([-n_side - 1, -n_side, -n_side + 1, -1, 0, 1,
                     n_side - 1, n_side, n_side + 1], dtype=np.int64)
    r = np.repeat(np.arange(n, dtype=np.int64), len(offs))
    c = r + np.tile(offs, n) + rng.integers(-jitter, jitter + 1, size=len(r))
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    v = rng.standard_normal(len(r))
    return CsrMatrix.from_coo(n, n, r, c, v)


def generate_corpus(
    directory: str = DEFAULT_CORPUS_DIR, *, seed: int = 0, include_large: bool = True
) -> List[str]:
    """Generate the synthetic corpus (idempotent); returns file paths.

    ``include_large=False`` skips the 2-4M-nnz bench-scale matrices (the
    property tests walk the corpus through both DOK conversion paths, which
    is minutes of pure-python work at that size)."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    specs = {
        "poisson_64.mtx": lambda: poisson_2d_csr(64),
        "poisson_160.mtx": lambda: poisson_2d_csr(160),
        "uniform_1k_1pct.mtx": lambda: _random_uniform(rng, 1000, 0.01),
        "uniform_4k_02pct.mtx": lambda: _random_uniform(rng, 4096, 0.002),
        "powerlaw_2k.mtx": lambda: _power_law_rows(rng, 2048, 16),
        "blocked_2k.mtx": lambda: _blocked(rng, 2048, 64, 0.05),
    }
    if include_large:
        # unstructured-with-locality at a size where SpMV is not
        # grid-overhead bound (the round-2 general-path target matrices)
        specs["randlocal_262k.mtx"] = lambda: _random_local(rng, 1 << 18, 16, 4096)
        specs["femlike_262k.mtx"] = lambda: _fem_like(rng, 512, 2)
        # bench-scale row-degree skew (the rows_to_threads stress class,
        # mul_hash.rs:38-64): pareto 1.5 tails, and an extreme 1.1-tail
        # variant whose heaviest rows hold thousands of entries
        specs["powerlaw_262k.mtx"] = lambda: _power_law_rows(rng, 1 << 18, 16)
        specs["powerlaw_heavy_64k.mtx"] = lambda: _power_law_rows(
            rng, 1 << 16, 24, alpha=1.1
        )
        # 3-D stencil: 7 bands at {0, +-1, +-n, +-n^2} — wide offset
        # spread stresses the DIA detector and BELL's bucket windows
        from ..solvers.poisson import poisson_3d_csr

        specs["poisson3d_64.mtx"] = lambda: poisson_3d_csr(64)
    paths = []
    for name, make in specs.items():
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            save_matrix_market(make().to_dok(), path)
        paths.append(path)
    return paths


def iter_corpus(directory: str = DEFAULT_CORPUS_DIR) -> Iterator[Tuple[str, CsrMatrix]]:
    """Walk a MatrixMarket directory, parse, convert to sorted CSR — the
    driver loop of the reference's ``gen_bench_mul!`` macro."""
    if not os.path.isdir(directory):
        return
    for name in sorted(os.listdir(directory)):
        if not name.endswith((".mtx", ".mm")):
            continue
        yield name, load_matrix_market_csr(os.path.join(directory, name))

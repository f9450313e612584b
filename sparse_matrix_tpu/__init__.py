"""sparse_matrix_tpu — a sparse linear algebra framework for JAX.

A ground-up JAX/XLA re-design with the capabilities of the Rust
``sparse_matrix`` workspace (``spam_matrix`` trait layer, ``spam_dok`` DOK
format + MatrixMarket I/O, ``spam_csr`` CSR + parallel hash SpGEMM,
``linprobe`` linear-probe hash tables), plus the device extensions from the
project north star: padded device formats, planned segmented-reduction SpMV,
sort-based and hash-based SpGEMM, a CG solver, and multi-chip sharding via
``jax.sharding`` meshes.

Layers:
    core/      Matrix protocol, DOK oracle, MatrixMarket I/O, Higham oracle
    formats/   host CSR + device-resident pytree formats (tiled/padded)
    ops/       device kernels: SpMV, SpGEMM, add/sub, transpose
    parallel/  multi-chip sharding (mesh, distributed SpMV/SpGEMM/CG)
    solvers/   iterative solvers (CG) and model problems (2D Poisson)
    utils/     linprobe parity tables, debug instrumentation
    native/    C++ host runtime (hash tables, threaded SpGEMM, fast MM parser)
    bench/     corpus runner, roofline reporting
    verify/    fuzz loop with MatrixMarket failure dumps
"""

__version__ = "0.1.0"

from .core import (  # noqa: F401
    Matrix,
    MatrixIndexError,
    AddPair,
    MulPair,
    DokMatrix,
    MatrixType,
    ParsedMatrix,
    MatrixMarketError,
    HasZeroDimensionError,
    parse_matrix_market,
    to_matrix_market_string,
    load_matrix_market,
    save_matrix_market,
    IsNanError,
    is_good_approx_of_mul,
)

"""Kernels: planned SpMV/SpMM (DIA, slab formats, ELL), SpGEMM (native
hash, ESC, block-dense, auto-dispatch), sort-based device
transpose/add/sub."""

from .spgemm_host import (  # noqa: F401
    flops_per_row,
    partition_rows_by_flops,
    spgemm_hash_host,
    spgemm_esc_host,
)
from .spgemm_block import (  # noqa: F401
    BlockSpgemm,
    block_pairs_plan,
    spgemm_auto,
    spgemm_block_device,
    spgemm_dense_xla,
)
from .spgemm_dia import spgemm_dia  # noqa: F401
from .spmm import spmm_dia, spmm_bcsr  # noqa: F401
from .operator import SpmvOperator  # noqa: F401
from .autodiff import (  # noqa: F401
    cg_solve_implicit,
    differentiable_operator,
    implicit_solve,
    linear_matvec,
)
from .complex import ComplexSpmvOperator  # noqa: F401
from .batched import (  # noqa: F401
    BatchedCgResult,
    BatchedEllOperator,
    batched_cg_solve,
)
from .spmv import (  # noqa: F401
    spmv_lanepack,
    lanepack_device_arrays,
    spmv_ell_xla,
    ell_from_csr,
    spmv_oracle,
)
from .spmv_bell import spmv_bell, bell_device_arrays  # noqa: F401
from .device_sorted import (  # noqa: F401
    PaddedCoo,
    add_device,
    sub_device,
    transpose_device,
    spgemm_esc_device,
    expand_plan,
    padded_to_host,
)

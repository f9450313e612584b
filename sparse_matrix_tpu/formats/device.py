"""Device-resident CSR: a jax pytree mirroring the host CSR arrays.

The irregular host format (``spam_csr``'s vals/indices/offsets) moves to the
device unchanged; SpMV paths that need regular access patterns consume the
planned :mod:`~sparse_matrix_tpu.formats.lanepack` views instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CsrMatrix

__all__ = ["DeviceCsr"]


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceCsr:
    """CSR arrays on device. ``rows``/``cols``/``is_sorted`` are static
    (pytree aux data) so jitted kernels specialize on shape, not on values."""

    vals: jnp.ndarray  # (nnz,) float dtype
    indices: jnp.ndarray  # (nnz,) int32 column indices
    offsets: jnp.ndarray  # (rows+1,) int32
    row_ids: jnp.ndarray  # (nnz,) int32 per-entry row (precomputed expansion)
    rows: int
    cols: int
    is_sorted: bool

    def tree_flatten(self):
        return (
            (self.vals, self.indices, self.offsets, self.row_ids),
            (self.rows, self.cols, self.is_sorted),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        vals, indices, offsets, row_ids = children
        rows, cols, is_sorted = aux
        return cls(vals, indices, offsets, row_ids, rows, cols, is_sorted)

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    @classmethod
    def from_host(cls, m: CsrMatrix, *, dtype=jnp.float32) -> "DeviceCsr":
        from ..utils.transfer import to_device

        return cls(
            vals=to_device(m.vals, dtype=dtype),
            indices=to_device(m.indices.astype(np.int32)),
            offsets=to_device(m.offsets.astype(np.int32)),
            row_ids=to_device(m.row_ids().astype(np.int32)),
            rows=m.rows,
            cols=m.cols,
            is_sorted=m.is_sorted,
        )

    def to_host(self) -> CsrMatrix:
        return CsrMatrix(
            self.rows,
            self.cols,
            np.asarray(self.vals),
            np.asarray(self.indices).astype(np.uint32),
            np.asarray(self.offsets).astype(np.int64),
            is_sorted=self.is_sorted,
        )

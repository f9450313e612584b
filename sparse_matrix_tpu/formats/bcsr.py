"""BCSR: block-compressed sparse rows with dense 128x128 blocks.

North-star scope ("ELL/BCSR padded device formats"). A sparse matrix whose
nonzeros cluster into 128x128 tiles is best treated as *block-sparse with
dense blocks*: only nonzero blocks are stored, each fully dense, so
SpGEMM/SpMM become batched dense matmuls over matched block pairs — no
per-element indexing at all.

Blocks are stored row-major per block row (a CSR at block granularity):
``blocks (nnzb, BS, BS)``, ``block_cols (nnzb,)``, ``block_offsets
(brows+1,)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .csr import CsrMatrix, INDEX_DTYPE, OFFSET_DTYPE

__all__ = ["BsrMatrix", "BLOCK_SIZE"]

BLOCK_SIZE = 128


@dataclass
class BsrMatrix:
    rows: int
    cols: int
    bs: int
    blocks: np.ndarray  # (nnzb, bs, bs)
    block_cols: np.ndarray  # (nnzb,) int32
    block_offsets: np.ndarray  # (brows+1,) int64

    @property
    def brows(self) -> int:
        return -(-self.rows // self.bs)

    @property
    def bcols(self) -> int:
        return -(-self.cols // self.bs)

    @property
    def nnzb(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def block_density(self) -> float:
        total = self.brows * self.bcols
        return self.nnzb / total if total else 0.0

    @classmethod
    def from_csr(cls, m: CsrMatrix, bs: int = BLOCK_SIZE, *, dtype=np.float32) -> "BsrMatrix":
        r = m.row_ids()
        c = m.indices.astype(np.int64)
        br, bc = r // bs, c // bs
        key = br * (-(-m.cols // bs)) + bc
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        uniq, first = np.unique(key_s, return_index=True)
        nnzb = len(uniq)
        blocks = np.zeros((nnzb, bs, bs), dtype=dtype)
        # map each entry to its block slot
        slot = np.searchsorted(uniq, key)
        blocks[slot, r % bs, c % bs] = m.vals.astype(dtype)
        block_rows = (uniq // (-(-m.cols // bs))).astype(np.int64)
        block_cols = (uniq % (-(-m.cols // bs))).astype(np.int32)
        brows = -(-m.rows // bs)
        block_offsets = np.zeros(brows + 1, dtype=np.int64)
        np.add.at(block_offsets, block_rows + 1, 1)
        np.cumsum(block_offsets, out=block_offsets)
        return cls(m.rows, m.cols, bs, blocks, block_cols, block_offsets)

    def block_rows_expanded(self) -> np.ndarray:
        return np.repeat(
            np.arange(self.brows, dtype=np.int64), np.diff(self.block_offsets)
        )

    def to_csr(self) -> CsrMatrix:
        """Back to element CSR, dropping explicit zeros inside blocks."""
        br = self.block_rows_expanded()
        from ..native.loader import blocks_to_coo_native

        got = blocks_to_coo_native(self.blocks, br, self.block_cols, self.rows, self.cols)
        if got is not None:
            r, c, v = got
            return CsrMatrix.from_coo(self.rows, self.cols, r, c, v, sum_duplicates=False)
        s, rr, cc = np.nonzero(self.blocks)  # one vectorized pass
        r = br[s] * self.bs + rr
        c = self.block_cols.astype(np.int64)[s] * self.bs + cc
        v = self.blocks[s, rr, cc]
        keep = (r < self.rows) & (c < self.cols)
        return CsrMatrix.from_coo(
            self.rows, self.cols, r[keep], c[keep], v[keep], sum_duplicates=False
        )

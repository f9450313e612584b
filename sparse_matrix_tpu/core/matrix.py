"""Matrix abstraction layer.

Re-design of the reference trait layer (``spam_matrix/src/lib.rs:15-27``):
a small Python protocol that every host-side matrix format implements, plus the
conformable-pair wrappers used by the property-test generators
(``spam_matrix/src/lib.rs:29-35``).

Semantics mirrored from the reference:

* Dimensions are strictly positive (``NonZeroUsize`` in the reference); zero
  dimensions are rejected at construction time.
* ``get_element`` returns the stored value or ``None`` when no explicit entry
  exists, and raises :class:`MatrixIndexError` when the position is out of
  bounds (``spam_dok/src/lib.rs:161-166``).
* ``set_element`` returns the previously stored value (or ``None``) and raises
  :class:`MatrixIndexError` when out of bounds; storing an exact zero deletes
  the entry in formats with no-explicit-zero invariants
  (``spam_dok/src/lib.rs:167-176``).
* ``nnz`` counts explicit entries (``spam_matrix/src/lib.rs:22``).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Generic, Iterator, Optional, Tuple, TypeVar

T = TypeVar("T")

__all__ = [
    "MatrixIndexError",
    "Matrix",
    "AddPair",
    "MulPair",
    "check_dims",
]


class MatrixIndexError(IndexError):
    """Raised when ``get_element``/``set_element`` receive an out-of-bounds
    position (reference ``IndexError``, ``spam_matrix/src/lib.rs:12-13``)."""


def check_dims(rows: int, cols: int) -> Tuple[int, int]:
    """Validate that dimensions are positive integers (NonZeroUsize analog)."""
    rows = int(rows)
    cols = int(cols)
    if rows <= 0 or cols <= 0:
        raise ValueError("matrix dimensions must be positive (got %r x %r)" % (rows, cols))
    return rows, cols


class Matrix(abc.ABC, Generic[T]):
    """The format-independent matrix interface (``spam_matrix/src/lib.rs:15-27``).

    Concrete formats: :class:`~sparse_matrix_tpu.core.dok.DokMatrix` (the
    oracle) and :class:`~sparse_matrix_tpu.formats.csr.CsrMatrix` (the
    performance format backing the device kernels).
    """

    # -- construction -------------------------------------------------------
    @classmethod
    @abc.abstractmethod
    def new(cls, rows: int, cols: int, *, dtype=None) -> "Matrix[T]":
        """Empty ``rows x cols`` matrix. Dimensions must be positive."""

    @classmethod
    def new_square(cls, n: int, *, dtype=None) -> "Matrix[T]":
        return cls.new(n, n, dtype=dtype)

    @classmethod
    @abc.abstractmethod
    def identity(cls, n: int, *, dtype=None) -> "Matrix[T]":
        """n x n identity."""

    # -- shape / size --------------------------------------------------------
    @property
    @abc.abstractmethod
    def rows(self) -> int: ...

    @property
    @abc.abstractmethod
    def cols(self) -> int: ...

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    @abc.abstractmethod
    def nnz(self) -> int:
        """Number of explicit entries."""

    # -- element access ------------------------------------------------------
    @abc.abstractmethod
    def get_element(self, pos: Tuple[int, int]) -> Optional[T]:
        """Stored value at ``pos`` or ``None``; raises MatrixIndexError if OOB."""

    @abc.abstractmethod
    def set_element(self, pos: Tuple[int, int], t: T) -> Optional[T]:
        """Store ``t`` at ``pos``; return the previous value (or ``None``).

        Raises MatrixIndexError if OOB.
        """

    # -- structure ------------------------------------------------------------
    @abc.abstractmethod
    def transpose(self) -> "Matrix[T]": ...

    @abc.abstractmethod
    def invariants(self) -> bool:
        """Self-check of the format's structural invariants; first-class API
        as in the reference (``spam_matrix/src/lib.rs:16``)."""

    @abc.abstractmethod
    def iter_entries(self) -> Iterator[Tuple[Tuple[int, int], T]]:
        """Iterate ``((row, col), value)`` over explicit entries.

        DOK and sorted CSR yield lexicographic ``(row, col)`` order
        (``spam_dok/src/lib.rs:96-99``); unsorted CSR yields storage order.
        """

    def _check_bounds(self, pos: Tuple[int, int]) -> None:
        i, j = pos
        if not (0 <= i < self.rows and 0 <= j < self.cols):
            raise MatrixIndexError(
                f"position {pos!r} out of bounds for {self.rows}x{self.cols} matrix"
            )


@dataclass
class AddPair(Generic[T]):
    """Pair of matrices conformable for addition (``spam_matrix/src/lib.rs:31``)."""

    a: Matrix[T]
    b: Matrix[T]


@dataclass
class MulPair(Generic[T]):
    """Pair of matrices conformable for multiplication (``spam_matrix/src/lib.rs:35``)."""

    a: Matrix[T]
    b: Matrix[T]

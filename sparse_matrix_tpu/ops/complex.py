"""Complex-valued device SpMV/SpMM through the real fast paths.

The reference supports complex through generics on its host structures
(``spam_dok`` parses complex MatrixMarket; host DOK/CSR ops are generic);
this module extends that to the DEVICE through the real planned formats:
``A = Ar + i Ai`` splits into two real planned operators and every
complex apply becomes two K=2 SpMMs —

``A x = (Ar xr - Ai xi) + i (Ar xi + Ai xr)``

with ``[xr | xi]`` packed as a 2-column block so each operator streams its
slabs ONCE for both the real and imaginary parts (K-fold operand
amortization, here K=2). A purely-real matrix skips the
``Ai`` operator entirely.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ComplexSpmvOperator"]


class ComplexSpmvOperator:
    """``y = A @ x`` for complex ``A`` (host CSR, complex vals) on device.

    Vectors ``(cols,)`` and blocks ``(cols, K)`` (complex) both work; the
    result is complex64.
    """

    def __init__(self, m, *, dtype=np.float32, force=None):
        from ..formats.csr import CsrMatrix
        from .operator import SpmvOperator

        if not np.issubdtype(m.vals.dtype, np.complexfloating):
            raise ValueError("ComplexSpmvOperator needs complex values; "
                             "use SpmvOperator for real matrices")
        self.rows, self.cols = m.rows, m.cols
        self._real_dtype = np.dtype(dtype)
        ar = CsrMatrix(
            m.rows, m.cols, np.ascontiguousarray(m.vals.real),
            m.indices.copy(), m.offsets.copy(), is_sorted=m.is_sorted,
        )
        self._ar = SpmvOperator(ar, dtype=dtype, force=force)
        if np.any(m.vals.imag != 0):
            ai = CsrMatrix(
                m.rows, m.cols, np.ascontiguousarray(m.vals.imag),
                m.indices.copy(), m.offsets.copy(), is_sorted=m.is_sorted,
            )
            self._ai = SpmvOperator(ai, dtype=dtype, force=force)
        else:
            self._ai = None

    @property
    def format(self):
        return self._ar.format

    def __call__(self, x):
        import jax.numpy as jnp

        x = jnp.asarray(x)
        vec = x.ndim == 1
        if vec:
            x = x[:, None]
        k = x.shape[1]
        # pack [Re x | Im x] as a 2K-column real block: one SpMM per part
        xs = jnp.concatenate([jnp.real(x), jnp.imag(x)], axis=1).astype(
            self._real_dtype
        )
        yr = self._ar.matmat(xs)  # [Ar xr | Ar xi]
        re, im = yr[:, :k], yr[:, k:]
        if self._ai is not None:
            yi = self._ai.matmat(xs)  # [Ai xr | Ai xi]
            re = re - yi[:, k:]
            im = im + yi[:, :k]
        y = re + 1j * im
        return y[:, 0] if vec else y

    def matmat(self, x):
        return self(x)

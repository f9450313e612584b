"""Floating-point accuracy oracle for sparse matrix products.

Re-design of the reference's Higham forward-error bound check
(``is_good_approx_of_mul``, ``spam_dok/src/lib.rs:52-93``), used because both
the reference's hash-drain SpGEMM and our device kernels legitimately reorder
float accumulation, so bitwise equality with the oracle is the wrong contract.

The bound is (3.13) from Higham, *Accuracy and Stability of Numerical
Algorithms*:  ``|C - A@B|_inf <= 2 * gamma_n * |A|_inf * |B|_inf`` with
``gamma_n = n*u / (1 - n*u)`` and unit roundoff ``u = eps/2``.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np

from .dok import DokMatrix

__all__ = ["IsNanError", "is_good_approx_of_mul", "gamma_n", "inf_norm"]


class IsNanError(ValueError):
    """A row-sum turned NaN while evaluating the bound (reference ``IsNan``,
    ``spam_dok/src/lib.rs:53``)."""


def gamma_n(n: int, u: float = np.finfo(np.float64).eps / 2) -> float:
    """gamma_n = n*u / (1 - n*u)  (``spam_dok/src/lib.rs:73-75``)."""
    nu = float(n) * u
    return nu / (1.0 - nu)


def inf_norm(m: DokMatrix) -> float:
    """Infinity norm: max over rows of the row's absolute sum
    (``spam_dok/src/lib.rs:57-72``). Raises :class:`IsNanError` on NaN rows."""
    row_sums: dict = {}
    for (r, _c), t in m.entries.items():
        row_sums[r] = row_sums.get(r, 0.0) + float(abs(t))
    mx = 0.0
    for s in row_sums.values():
        if math.isnan(s):
            raise IsNanError("row sum is NaN")
        if s > mx:
            mx = s
    return mx


def is_good_approx_of_mul(
    c: DokMatrix, a: DokMatrix, b: DokMatrix, *, u: Union[float, None] = None
) -> bool:
    """Is ``c`` an acceptable floating-point product ``a @ b``?

    Mirrors ``spam_dok/src/lib.rs:56-92``: computes the exact-ish oracle product
    ``expected = a * b`` with the naive DOK multiply, then checks
    ``|expected - c|_inf <= 2 * gamma_n * |a|_inf * |b|_inf``.

    * if ``expected`` has no NaN but ``c`` does -> ``False``
      (``spam_dok/src/lib.rs:84-85``);
    * a zero norm on either side collapses the bound to 0 so that
      ``0 * inf`` cannot produce NaN (``spam_dok/src/lib.rs:86-90``);
    * raises :class:`IsNanError` when a norm itself is NaN.

    ``u`` defaults to the unit roundoff of float64; pass
    ``np.finfo(np.float32).eps / 2`` when checking f32 device kernels.
    """
    if u is None:
        u = float(np.finfo(np.float64).eps) / 2.0
    g = gamma_n(a.cols, u)
    expected = a * b
    expected_has_nan = any(_isnan(t) for _p, t in expected.entries.items())
    c_has_nan = any(_isnan(t) for _p, t in c.entries.items())
    if not expected_has_nan and c_has_nan:
        return False
    a_norm = inf_norm(a)
    b_norm = inf_norm(b)
    bound = 0.0 if (a_norm == 0.0 or b_norm == 0.0) else 2.0 * g * a_norm * b_norm
    return inf_norm(expected - c) <= bound


def _isnan(t) -> bool:
    try:
        return bool(np.isnan(t))
    except TypeError:
        return False

"""Accounted host->device transfers.

``to_device`` is ``jnp.asarray`` plus two counters, so benchmarks can split
"host plan work" from "device transfer" time.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["to_device", "transfer_seconds", "transfer_bytes"]

# cumulative wall/bytes spent in to_device pushes
_seconds = 0.0
_bytes = 0


def transfer_seconds() -> float:
    return _seconds


def transfer_bytes() -> int:
    return _bytes


def to_device(a, dtype=None):
    """``jnp.asarray`` of a host array in one push, with its time and bytes
    added to the counters. Device arrays pass straight through."""
    import jax
    import jax.numpy as jnp

    global _seconds, _bytes
    if isinstance(a, jax.Array) and dtype is None:
        return a
    a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
    t0 = time.perf_counter()
    try:
        return jnp.asarray(a)
    finally:
        _seconds += time.perf_counter() - t0
        _bytes += a.nbytes

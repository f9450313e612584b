"""Device mesh construction for multi-chip sharding.

The reference's parallelism is intra-process rayon over row chunks
(``spam_csr/src/mul_hash.rs:38-64``); the device equivalent scales over a
``jax.sharding.Mesh``: rows are the parallel axis, sharded across devices,
with XLA collectives (psum / all_gather; NCCL over NVLink between GPUs).
Every GPU of a host reaches every other at the same rate, so a mesh is
just the first n devices in order. This module builds the meshes;
``parallel.spmv`` / ``parallel.cg`` put them to work.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "row_sharding", "replicated", "P"]

ROWS = "rows"


def make_mesh(n_devices: Optional[int] = None, *, axis: str = ROWS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis,))


def row_sharding(mesh: Mesh, ndim: int = 1, *, axis: str = ROWS) -> NamedSharding:
    """Shard the leading (row) dimension; replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())

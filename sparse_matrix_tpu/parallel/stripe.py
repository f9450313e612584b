"""Distributed stripe SpMV: the scatter-class format over a device mesh
(VERDICT r4 #8 — the 8 round-2/3 strategies predate the stripe format,
and scattered matrices are exactly the class that shards badly).

Row-sharding is the right decomposition for a scatter matrix: its columns
have no locality to exploit, so the exchange is an all-gather of x
(bytes = (D-1)/D * cols * 4 per device per apply — the same volume
model as the row-sharded ELL path, asserted by the traffic test), and
each device then runs its own stripe plan on its row block. Per-shard
plans are built host-side on contiguous row slices with a UNIFORM
(mode=scan, L, KW, B, slab-pad) configuration so one compiled program
serves every device; scan mode is used because it has no collision-spill
side plan (select-mode spill would need a second, ragged LanePack shard
per device).

Each device applies its shard with the stripe format's XLA evaluation
(ops/spmv.py `_spmv_stripe_jit`), on a virtual CPU mesh and on GPUs alike.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

from ..formats.csr import CsrMatrix

__all__ = ["shard_stripe", "dist_spmv_stripe"]


def shard_stripe(m: CsrMatrix, mesh, *, levels: int = 2, kw: int = 2,
                 axis: str = "rows"):
    """Build per-device stripe plans on contiguous row blocks and stack
    them into mesh-sharded device arrays.

    Returns ``(arrs, meta)``: ``arrs`` a dict of (D, ...) arrays sharded
    on their leading axis; ``meta`` the static config
    ``(shard_rows, cols, levels, kw, b, rows)``.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..formats.stripe import plan_stripe
    from ..ops.spmv import _pick_b
    from ..formats.lanepack import LANES, SUBLANES

    d = mesh.devices.size
    h = levels * LANES
    shard_rows = -(-(-(-m.rows // d)) // h) * h  # multiple of L*128
    rows_pad = shard_rows * d

    offsets = m.offsets.astype(np.int64)
    plans = []
    for k in range(d):
        lo = min(m.rows, k * shard_rows)
        hi = min(m.rows, (k + 1) * shard_rows)
        off = np.zeros(shard_rows + 1, dtype=offsets.dtype)
        off[: hi - lo + 1] = offsets[lo : hi + 1] - offsets[lo]
        off[hi - lo + 1 :] = off[hi - lo]  # trailing empty pad rows
        sub = CsrMatrix(
            shard_rows, m.cols, m.vals[offsets[lo] : offsets[hi]],
            m.indices[offsets[lo] : offsets[hi]], off, is_sorted=m.is_sorted)
        plans.append(plan_stripe(sub, levels=levels, kw=kw, mode="scan"))

    max_slabs = max(p.num_slabs for p in plans)
    b = _pick_b(max(1, max_slabs))
    sp = max(b, -(-max_slabs // b) * b)

    def stack(get, fill, dtype, tail_shape):
        out = np.full((d, sp) + tail_shape, fill, dtype=dtype)
        for k, p in enumerate(plans):
            a = get(p)
            out[k, : a.shape[0]] = a
        return out

    p0 = plans[0]
    arrs_np = dict(
        vals=stack(lambda p: p.vals, 0, p0.vals.dtype, p0.vals.shape[1:]),
        lane=stack(lambda p: p.lane, 0, p0.lane.dtype, p0.lane.shape[1:]),
        ends=stack(lambda p: p.ends, 0, p0.ends.dtype, p0.ends.shape[1:]),
        starts=stack(lambda p: p.starts, 0, p0.starts.dtype,
                     p0.starts.shape[1:]),
        stripe_rb=stack(lambda p: p.stripe_rb[: p.num_slabs], 0, np.int32,
                        ()),
        col_off=stack(
            lambda p: p.col_off[: p.num_slabs * SUBLANES].reshape(-1,
                                                                  SUBLANES),
            0, np.int32, (SUBLANES,)),
        chunk_stripe=stack(
            lambda p: p.chunk_stripe[: p.num_slabs * SUBLANES].reshape(
                -1, SUBLANES), 0, np.int32, (SUBLANES,)),
    )
    r128p = p0.rb_mask.shape[0]
    rb_mask = np.zeros((d, r128p), p0.rb_mask.dtype)
    for k, p in enumerate(plans):
        rb_mask[k] = p.rb_mask
    arrs_np["rb_mask"] = rb_mask

    sh = NamedSharding(mesh, P(axis))
    arrs = {k: jax.device_put(jnp.asarray(v), sh) for k, v in arrs_np.items()}
    meta = dict(shard_rows=shard_rows, cols=m.cols, levels=levels, kw=kw,
                b=b, rows=m.rows, rows_pad=rows_pad)
    return arrs, meta


def dist_spmv_stripe(arrs, x, mesh, meta, *, axis: str = "rows"):
    """``y = A @ x`` for a :func:`shard_stripe` operator; x and y
    row-sharded over ``axis`` (x padded to ``rows_pad``... x is the
    GLOBAL vector of length cols, sharded; gathered per device)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..ops.spmv import _spmv_stripe_jit

    shard_rows = meta["shard_rows"]
    cols, lvl, kw = meta["cols"], meta["levels"], meta["kw"]
    spec = {k: P(axis) for k in arrs}

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, P(axis)),
        out_specs=P(axis),
    )
    def _apply(a_sh, x_sh):
        x_full = jax.lax.all_gather(x_sh, axis, tiled=True)
        local = {k: v[0] for k, v in a_sh.items()}
        local["col_off"] = local["col_off"].reshape(-1)
        local["chunk_stripe"] = local["chunk_stripe"].reshape(-1)
        y = _spmv_stripe_jit(
            local, x_full[:cols], rows=shard_rows, cols=cols, lvl=lvl,
            kw=kw, scan=True)
        return y

    return _apply(arrs, x)

"""BELL SpMV (formats/bell.py — the streaming general path).

The plan stores ``L`` layers of value planes and int8 lane planes over
128-row blocks; layer ``l`` reads its 256-wide x window starting at block
offset ``d_l`` (compile-time; see formats/bell.py _layer_keys). Per layer:
one or two static row-shifted slices of the padded 2-D x view (by the
planner's per-layer mode — a layer whose positions stay in one 128-half
needs a single slice), an in-row lane gather, one fma. No scatter, no
per-slab index arrays, so BELL has no slab-count limit: it covers the
giant operators that would otherwise need colsplit/rowsplit
(ops/operator.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.bell import BellPlan, pick_br
from ..formats.lanepack import LANES

__all__ = ["spmv_bell", "bell_device_arrays"]


def bell_device_arrays(plan: BellPlan, *, br: int | None = None,
                       values_dtype=None):
    """Move a plan's slot planes to device once, row-blocks padded to a
    whole number of BR-steps.

    ``values_dtype=jnp.bfloat16`` stores the value planes half-width: the
    slot stream drops from 5 B/slot (f32 val + i8 lane) to 3 B/slot; the
    apply widens the planes and accumulates in the x dtype (f32). The
    spill sub-plan (lanepack) keeps f32 values — spill is a tiny nnz
    fraction by construction."""
    from .spmv import lanepack_device_arrays

    L = plan.num_layers
    dmax = max(plan.ds) if plan.ds else 0
    vdt = np.dtype(values_dtype) if values_dtype is not None else plan.vals.dtype
    sb = vdt.itemsize + plan.lane.dtype.itemsize
    br = br if br is not None else pick_br(max(L, 1), dmax, sb)
    r128p = max(br, -(-plan.r128 // br) * br)
    vals = np.zeros((L, r128p, LANES), vdt)
    # pad rows point at index 0 of each layer's first used half (same
    # convention as the planner's pad slots): contribute 0, never force
    # an unused window slice
    lane = np.zeros((L, r128p, LANES), plan.lane.dtype)
    for i, mask in enumerate(plan.modes):
        h0 = 0
        while mask and not (mask >> h0) & 1:
            h0 += 1
        lane[i] = LANES * h0 - (LANES if plan.span == 128 else 0)
    vals[:, : plan.r128] = plan.vals.astype(vdt, copy=False)
    lane[:, : plan.r128] = plan.lane
    from ..utils.transfer import to_device

    arrs = dict(br=br, vals=to_device(vals), lane=to_device(lane))
    if plan.spill is not None:
        arrs["spill"] = lanepack_device_arrays(plan.spill)
    return arrs


@functools.partial(
    jax.jit,
    static_argnames=("ds", "modes", "span", "rows", "cols", "br"),
)
def _spmv_bell_jit(
    vals, lane, x, *, ds: tuple, modes: tuple, span: int, rows: int,
    cols: int, br: int
):
    r128p = vals.shape[1]
    c128 = -(-cols // LANES)
    nh = span // 128 + 1  # 128-halves per layer window
    dmin = min(ds) if ds else 0
    dmax = max(ds) if ds else 0
    lo = max(0, -dmin)
    # + (nh - 1): each layer's window also reads rows b+1 .. b+nh-1
    win_rows = lo + br + max(dmax + nh - 1, 0)
    win_rows += (-win_rows) % 8
    total_rows = max((r128p // br - 1) * br + win_rows, lo + c128)
    hi = total_rows - lo - c128

    xflat = jnp.zeros(c128 * LANES, x.dtype).at[: x.shape[0]].set(x)
    x2d = jnp.concatenate(
        [
            jnp.zeros((lo, LANES), x.dtype),
            xflat.reshape(c128, LANES),
            jnp.zeros((hi, LANES), x.dtype),
        ],
        axis=0,
    )

    bias = LANES if span == 128 else 0  # int8 lanes store pos - 128
    y2 = jnp.zeros((r128p, LANES), x.dtype)
    for li, (d, mask) in enumerate(zip(ds, modes)):
        pos = lane[li].astype(jnp.int32) + bias
        idx = jnp.bitwise_and(pos, 127)
        half = jax.lax.shift_right_logical(pos, 7)
        xg = None
        for h in range(nh):
            if not (mask >> h) & 1:
                continue
            a = jax.lax.slice_in_dim(
                x2d, lo + d + h, lo + d + h + r128p, axis=0
            )
            g = jnp.take_along_axis(a, idx, axis=1)
            xg = g if xg is None else jnp.where(half == h, g, xg)
        # bf16 planes: widen, f32 accumulate
        y2 = y2 + vals[li].astype(x.dtype) * xg
    return y2.reshape(-1)[:rows]


def spmv_bell(plan: BellPlan, x, *, device_arrays=None, allow_downcast=False):
    """y = A @ x over a BELL plan (+ LanePack on the spill sub-plan when
    the plan has one)."""
    from .spmv import _cast_x, _spmv_lanepack_jit

    arrs = device_arrays if device_arrays is not None else bell_device_arrays(plan)
    x = _cast_x(x, plan.dtype, allow_downcast)
    if plan.num_layers:
        y = _spmv_bell_jit(
            arrs["vals"],
            arrs["lane"],
            x,
            ds=plan.ds,
            modes=plan.modes,
            span=plan.span,
            rows=plan.rows,
            cols=plan.cols,
            br=arrs["br"],
        )
    else:
        y = jnp.zeros(plan.rows, dtype=plan.dtype)
    if plan.spill is not None:
        sp = arrs.get("spill")
        if sp is None:
            from .spmv import lanepack_device_arrays

            sp = lanepack_device_arrays(plan.spill)
        y = y + _spmv_lanepack_jit(
            {k: v for k, v in sp.items() if k != "b"},
            x,
            rows=plan.rows,
            cols=plan.cols,
            kw=plan.spill.kw,
        )
    return y

"""DIA SpMV: shifts + fused multiply-adds, no index data.

``y[i] = sum_b data[b, i] * x[i + off_b]`` — each band reads a contiguous,
statically-offset slice of x, so XLA fuses the whole thing into one
memory-bound elementwise pass. This is the speed-of-light SpMV for stencil
operators (2x ideal-CSR bytes saved: no column indices).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..formats.dia import DiaMatrix

__all__ = [
    "spmv_dia",
    "spmm_dia_stream",
    "dia_matvec_multi",
    "dia_pack_rhs",
    "dia_unpack_rhs",
    "dia_device_arrays",
]


def dia_device_arrays(m: DiaMatrix, *, values_dtype=None):
    """``values_dtype=jnp.bfloat16`` stores the band planes half-width:
    the value stream is the ONLY HBM traffic of the DIA kernel beyond x,
    so bf16 storage halves bytes/nnz. The kernel widens each block to the
    x dtype before the fma (f32 accumulate) — relative error per product
    is bf16-eps (~4e-3), which the mixed-precision refinement solvers
    (solvers/cg.py cg_solve_ir) recover to working accuracy."""
    from ..utils.transfer import to_device

    data = to_device(m.data)
    if values_dtype is not None:
        data = data.astype(values_dtype)
    return dict(data=data)


@functools.partial(jax.jit, static_argnames=("offsets", "rows", "cols"))
def _spmv_dia_jit(data, x, *, offsets: tuple, rows: int, cols: int):
    lo = -min(0, min(offsets))
    hi = max(0, max(offsets)) + max(rows, cols)
    xpad = jnp.zeros(lo + hi, x.dtype).at[lo : lo + x.shape[0]].set(x)
    if data.dtype != x.dtype:  # bf16 value planes: widen, f32 accumulate
        data = data.astype(x.dtype)
    y = jnp.zeros(rows, x.dtype)
    for b, off in enumerate(offsets):
        y = y + data[b] * jax.lax.dynamic_slice(xpad, (lo + off,), (rows,))
    return y


def spmv_dia(m: DiaMatrix, x, *, device_arrays=None):
    arrs = device_arrays if device_arrays is not None else dia_device_arrays(m)
    x = jnp.asarray(x)
    return _spmv_dia_jit(arrs["data"], x, offsets=m.offsets, rows=m.rows, cols=m.cols)


# -- packed DIA SpMM: K right-hand sides in ONE pass over the bands --------
#
# The per-column loop re-reads the band planes K times. The packed form
# lays X out as (lo + rpad + hi, K, 128) planes of 128 rows: each band
# offset becomes a row shift (whole planes) plus a lane shift realized as
# a two-view lane concatenation, broadcast over the K axis, so the band
# data is read once for all K columns.

# rows of 128 per layout step: rpad (the packed row count) is a multiple
# of it, and the guard rows round the padded height to a multiple of 8
_DIA_SPMM_BR = 256


def _dia_blocked_data(data, *, rows: int, br: int):
    """One-time reformat of (nb, rows) band data to the packed
    (nb, rpad, 128) layout — 2x the data bytes in copies, so it stays out
    of the per-apply jit."""
    nb = data.shape[0]
    r128 = -(-rows // 128)
    rpad = -(-r128 // br) * br
    dpad = jnp.zeros((nb, rpad, 128), data.dtype)
    return dpad.at[:, :r128, :].set(
        jnp.pad(data, ((0, 0), (0, r128 * 128 - data.shape[1]))).reshape(nb, r128, 128)
    )


def _dia_stream_geom(offsets: tuple, br: int):
    """Guard-row geometry of the packed layout: x3 is
    [lo_rows zero | rpad data rows | hi_rows zero] of (K, 128) planes."""
    lo_rows = -min(0, min(offsets)) // 128 + 1
    hi_rows = max(0, max(offsets)) // 128 + 2
    hi_rows += (-(lo_rows + br + hi_rows)) % 8
    return lo_rows, hi_rows


@functools.partial(jax.jit, static_argnames=("offsets", "k", "br"))
def _spmm_dia_stream_packed(dpad, x3, *, offsets: tuple, k: int, br: int):
    """Packed-layout core: x3 (lo+rpad+hi, K, 128) -> y3 (rpad, K, 128).
    Iterative block solvers stay in this layout (dia_matvec_multi), so
    the (rows,K)<->packed transposes are paid once per solve, not per
    apply."""
    rpad = dpad.shape[1]
    lo_rows, _hi_rows = _dia_stream_geom(offsets, br)
    y3 = jnp.zeros((rpad, k, 128), x3.dtype)
    for b, off in enumerate(offsets):
        q, r = off // 128, off % 128  # python divmod: r in [0, 128)
        a = jax.lax.slice_in_dim(x3, lo_rows + q, lo_rows + q + rpad, axis=0)
        if r == 0:
            win = a
        else:
            bv = jax.lax.slice_in_dim(
                x3, lo_rows + q + 1, lo_rows + q + 1 + rpad, axis=0
            )
            win = jnp.concatenate([a[:, :, r:], bv[:, :, :r]], axis=2)
        # bf16 planes: widen, f32 accumulate
        y3 = y3 + dpad[b].astype(x3.dtype)[:, None, :] * win
    return y3


@functools.partial(jax.jit, static_argnames=("offsets", "rows", "k", "br"))
def _spmm_dia_stream(dpad, x, *, offsets: tuple, rows: int, k: int, br: int):
    rpad = dpad.shape[1]
    lo_rows, hi_rows = _dia_stream_geom(offsets, br)
    xpack = jnp.zeros((rpad * 128, k), x.dtype).at[: x.shape[0], :].set(x)
    x3 = jnp.concatenate(
        [
            jnp.zeros((lo_rows, k, 128), x.dtype),
            xpack.reshape(rpad, 128, k).transpose(0, 2, 1),
            jnp.zeros((hi_rows, k, 128), x.dtype),
        ],
        axis=0,
    )
    y3 = _spmm_dia_stream_packed(dpad, x3, offsets=offsets, k=k, br=br)
    return y3.transpose(0, 2, 1).reshape(rpad * 128, k)[:rows]


def spmm_dia_stream(m: DiaMatrix, x, *, device_arrays=None, br: int = None):
    """``Y = A @ X`` (X is (cols, K), 2 <= K <= 16) through the packed
    layout: band planes read ONCE for all K columns. Square operators
    only; :func:`~sparse_matrix_tpu.ops.spmm.spmm_dia` (shifted slices of
    X) covers the rest."""
    arrs = device_arrays if device_arrays is not None else dia_device_arrays(m)
    x = jnp.asarray(x)
    k = int(x.shape[1])
    if not (2 <= k <= 16):
        raise ValueError("spmm_dia_stream: K must be in [2, 16]")
    if m.rows != m.cols:
        raise ValueError("spmm_dia_stream: square operators only")
    br = br if br is not None else _DIA_SPMM_BR
    dpad = _dia_blocked_for(m, arrs, br)
    return _spmm_dia_stream(dpad, x, offsets=m.offsets, rows=m.rows, k=k, br=br)


def _dia_blocked_for(m: DiaMatrix, arrs, br: int):
    """Blocked (nb, rpad, 128) band data for step size ``br``, cached per
    br in the device-array dict (concrete operands only)."""
    data = arrs["data"]
    key = f"data_blocked_br{br}"
    dpad = arrs.get(key)
    if dpad is None:
        if isinstance(data, jax.core.Tracer):
            # traced operand (operator passed as a jit argument): the
            # reformat joins the caller's program
            dpad = _dia_blocked_data(data, rows=m.rows, br=br)
        else:
            # first use may happen inside a trace: build the cached
            # constant eagerly or it would leak a tracer into later traces
            with jax.ensure_compile_time_eval():
                dpad = _dia_blocked_data(data, rows=m.rows, br=br)
            arrs[key] = dpad
    return dpad


def dia_pack_rhs(m: DiaMatrix, x, *, br: int = None):
    """(cols, K) -> the packed layout
    (lo + rpad + hi, K, 128) with zero guard rows; see
    :func:`dia_matvec_multi`."""
    br = br if br is not None else _DIA_SPMM_BR
    x = jnp.asarray(x)
    k = int(x.shape[1])
    r128 = -(-m.rows // 128)
    rpad = -(-r128 // br) * br
    lo_rows, hi_rows = _dia_stream_geom(m.offsets, br)
    xpack = jnp.zeros((rpad * 128, k), x.dtype).at[: x.shape[0], :].set(x)
    return jnp.concatenate(
        [
            jnp.zeros((lo_rows, k, 128), x.dtype),
            xpack.reshape(rpad, 128, k).transpose(0, 2, 1),
            jnp.zeros((hi_rows, k, 128), x.dtype),
        ],
        axis=0,
    )


def dia_unpack_rhs(m: DiaMatrix, x3, *, br: int = None):
    """Packed (lo + rpad + hi, K, 128) -> (rows, K)."""
    br = br if br is not None else _DIA_SPMM_BR
    lo_rows, hi_rows = _dia_stream_geom(m.offsets, br)
    body = x3[lo_rows : x3.shape[0] - hi_rows]
    rpad, k = body.shape[0], body.shape[1]
    return body.transpose(0, 2, 1).reshape(rpad * 128, k)[: m.rows]


def dia_matvec_multi(m: DiaMatrix, k: int, *, device_arrays=None,
                     values_dtype=None, br: int = None):
    """Packed-layout multi-RHS matvec closure for a square DIA operator: (lo+rpad+hi, K, 128) -> same shape (guard rows
    re-zeroed), ready for ``cg_solve_multi(..., rhs_axis=1)`` — the DIA
    analog of :func:`~sparse_matrix_tpu.ops.spmm.aligned_matvec_multi`.
    Iterates stay packed, so the (rows,K)<->packed transposes (~45% of
    the one-shot wrapper) are paid once per solve."""
    if m.rows != m.cols:
        raise ValueError("packed multi-RHS matvec needs a square operator")
    if not (2 <= k <= 16):
        raise ValueError("dia_matvec_multi: K must be in [2, 16]")
    br = br if br is not None else _DIA_SPMM_BR
    arrs = (device_arrays if device_arrays is not None
            else dia_device_arrays(m, values_dtype=values_dtype))
    dpad = _dia_blocked_for(m, arrs, br)
    lo_rows, hi_rows = _dia_stream_geom(m.offsets, br)

    def mv(x3):
        y3 = _spmm_dia_stream_packed(dpad, x3, offsets=m.offsets, k=k, br=br)
        return jnp.concatenate(
            [
                jnp.zeros((lo_rows, k, 128), y3.dtype),
                y3,
                jnp.zeros((hi_rows, k, 128), y3.dtype),
            ],
            axis=0,
        )

    return mv

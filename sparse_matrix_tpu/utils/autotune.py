"""Measured cost-model constants for engine/format dispatch.

The dispatch constants (LanePack ``C_FIXED``/``C_KW``, pack-mode
per-slab costs, ``spgemm_auto``'s host/block/dense rates) are data; wrong
constants on another machine silently pick wrong engines:

* :func:`get` — constant lookup: calibration cache (JSON, path from
  ``debugflags.autotune_cache_path()``) over the inherited defaults.
* :func:`calibrate` — microbenchmarks that measure the constants on *this*
  backend and persist them; run explicitly via
  ``python -m sparse_matrix_tpu.utils.autotune`` (or at first use with
  ``SPMX_AUTOTUNE=1``; compiling the probes takes a while, so it is
  opt-in).

The reference's analog is compile-time: cargo features and const generics
pick code paths (SURVEY §5 config); a runtime library on heterogeneous
accelerators needs measured dispatch instead.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from .debugflags import autotune_cache_path, autotune_on_first_use

__all__ = ["get", "get_all", "calibrate", "reset_cache"]

# Dispatch weights fitted on the library's first target accelerator;
# inherited as they are, not measured on the GPU (see calibrate()).
# Changing them re-routes formats, so they change only with a measurement.
DEFAULTS: Dict[str, float] = {
    # general LanePack: per-slab time = fixed + kw_slope * KW (ns)
    "lanepack_fixed_ns": 30.0,
    "lanepack_kw_ns": 4.0,
    # pack-mode per-slab costs at kw=1 (dense two-target vs per-rb padded)
    "lanepack_dense_slab_ns": 30.0,
    "lanepack_per_rb_slab_ns": 32.0,
    # aligned (dst-aligned slots, no cumsum) per-slab cost
    "lanepack_aligned_slab_ns": 19.0,
    # BELL per-(layer, 128-row-block) cost: c0 + c1*(128/BR)
    "bell_chunk_c0_ns": -0.43,
    "bell_chunk_c1_ns": 4.44,
    # aligned estimate: t = slabs*base + nnz*per_entry
    "aligned_slab_base_ns": 5.22,
    "aligned_slab_per_entry_ns": 0.027,
    # per-CHUNK floor of the aligned estimate, log2-interpolated in the
    # per-row-block x working set between 32 KB (lo) and 1 MB (hi)
    "aligned_chunk_floor_lo_ns": 1.0,
    "aligned_chunk_floor_hi_ns": 2.2,
    # BELL per-chunk penalty per unit of kept window span
    "bell_chunk_dspan_ns": 0.04,
    # stripe scan mode: per-slab ns = fixed + kw_slope*KW + lvl_slope*L
    "stripe_fixed_ns": 11.23,
    "stripe_kw_ns": 5.15,
    "stripe_lvl_ns": 8.51,
    # stripe select mode (kw term applies to the chunk-span kw_g from
    # _select_spill_stats, not the group window)
    "stripe_sel_fixed_ns": 1.96,
    "stripe_sel_kw_ns": 12.06,
    "stripe_sel_lvl_ns": 4.51,
    # ELL x-gather per element: prices the hyper-sparse ELL shortcut
    "ell_gather_ns": 7.1,
    # retired (select-mode spill is priced by the scan model on the
    # spilled subset); kept for saved-calibration compatibility
    "stripe_spill_per_nnz_ns": 0.12,
    # spgemm_auto rates
    "spgemm_host_products_per_s": 5e7,  # per core
    "spgemm_host_touch_s_per_byte": 4e-9,  # numpy densify/sparsify passes
    "spgemm_mxu_pair_s": 4.5e-7,  # per 128x128 block pair
    "spgemm_dense_mac_per_s": 2e13,
    # device ESC engine (k-major expansion + packed sort) products/s
    "spgemm_esc_products_per_s": 1.7e8,
    # one-shot device-call overhead (upload + dispatch + readback sync):
    # decides whether one-shot calls may use device engines
    "device_call_sync_s": 0.03,
    # first-call XLA compile for a device engine at a NEW shape; one-shot
    # dispatch (spgemm_auto) must bear it. Amortizing callers
    # (EscSpgemm/BlockSpgemm re-multiply) bypass spgemm_auto.
    "device_oneshot_compile_s": 40.0,
}

_cache: Optional[Dict[str, float]] = None
_calibrating = False


def reset_cache() -> None:
    """Forget the loaded calibration (tests repoint SPMX_AUTOTUNE_CACHE)."""
    global _cache
    _cache = None


def _load() -> Dict[str, float]:
    global _cache
    if _cache is not None:
        return _cache
    merged = dict(DEFAULTS)
    path = autotune_cache_path()
    try:
        with open(path, "r") as f:
            data = json.load(f)
        for k, v in data.items():
            if k in merged and isinstance(v, (int, float)) and v > 0:
                merged[k] = float(v)
    except (OSError, ValueError):
        if autotune_on_first_use() and not _calibrating:
            try:
                merged.update(calibrate(save=True))
            except Exception:
                pass  # calibration is best-effort; defaults stand
    _cache = merged
    return merged


def get(name: str) -> float:
    """Cost-model constant: calibrated value when a cache exists, else the
    inherited default. Unknown names raise KeyError."""
    if name not in DEFAULTS:
        raise KeyError(name)
    return _load()[name]


def get_all() -> Dict[str, float]:
    return dict(_load())


# ---------------------------------------------------------------------------
# calibration microbenchmarks
# ---------------------------------------------------------------------------


def _bench_loop(fn, x, iters):
    """Seconds per iteration of ``fn`` chained ``iters`` times inside one
    jit, timed to ``block_until_ready`` (best of 4 after a compile run)."""
    import jax

    @jax.jit
    def loop(v):
        return jax.lax.fori_loop(0, iters, lambda i, u: fn(u) * 0.2, v)

    jax.block_until_ready(loop(x))  # compile
    runs = []
    for _ in range(4):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(x))
        runs.append(time.perf_counter() - t0)
    return max(1e-12, min(runs) / iters)


def _calibration_matrix(seed=0, n=65536, nnz_per_row=12):
    """Mixed banded+scattered synthetic operator: exercises several kw
    choices without favoring one structure."""
    import numpy as np

    from ..formats.csr import CsrMatrix

    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    # half band-local, half scattered
    local = rng.integers(-256, 257, size=len(r) // 2)
    cols_local = np.clip(r[: len(r) // 2] + local, 0, n - 1)
    cols_rand = rng.integers(0, n, size=len(r) - len(cols_local))
    c = np.concatenate([cols_local, cols_rand])
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    v = rng.standard_normal(len(r)).astype(np.float32)
    offs = np.zeros(n + 1, np.int64)
    np.add.at(offs, r + 1, 1)
    np.cumsum(offs, out=offs)
    return CsrMatrix(n, n, v, c.astype(np.uint32), offs, is_sorted=True)


def calibrate(save: bool = True, *, verbose: bool = False) -> Dict[str, float]:
    """Measure the dispatch constants on the current backend.

    Device constants (LanePack slab costs, block/ESC/dense SpGEMM rates)
    are measured on an accelerator backend only; host constants (spgemm
    host rate, touch rate, call sync) are measured anywhere. Returns the
    measured subset; with ``save=True`` persists it (merged over any
    existing cache file).
    """
    global _calibrating
    import numpy as np

    _calibrating = True
    out: Dict[str, float] = {}
    try:
        import jax
        import jax.numpy as jnp

        def log(*a):
            if verbose:
                import sys

                print(*a, file=sys.stderr, flush=True)

        # --- host SpGEMM rate (products/s/core) ---
        from ..ops.spgemm_host import flops_per_row, spgemm_hash_host

        m = _calibration_matrix(1, n=4096, nnz_per_row=8)
        prods = float(flops_per_row(m, m).sum())
        t0 = time.perf_counter()
        spgemm_hash_host(m, m)
        host_s = time.perf_counter() - t0
        out["spgemm_host_products_per_s"] = prods / host_s / max(1, os.cpu_count() or 1)
        log(f"host hash: {out['spgemm_host_products_per_s']:.3g} products/s/core")

        # --- host touch rate (densify/sparsify numpy passes) ---
        d = m.to_dense()
        t0 = time.perf_counter()
        rr, cc = np.nonzero(d)
        _ = d[rr, cc]
        touch_s = time.perf_counter() - t0
        out["spgemm_host_touch_s_per_byte"] = touch_s / d.nbytes
        log(f"host touch: {out['spgemm_host_touch_s_per_byte']:.3g} s/byte")

        # --- one-shot device-call sync (any backend) ---
        f0 = jax.jit(lambda s: s + 1.0)
        float(f0(jnp.float32(0)))
        ls = []
        for _ in range(5):
            t0 = time.perf_counter()
            float(f0(jnp.float32(0)))
            ls.append(time.perf_counter() - t0)
        out["device_call_sync_s"] = float(min(ls))
        log(f"device sync: {out['device_call_sync_s']:.3g} s")

        if jax.default_backend() != "cpu":
            from ..formats.lanepack import plan_lanepack
            from ..ops.spmv import _spmv_lanepack_jit, lanepack_device_arrays

            big = _calibration_matrix(0)
            rng = np.random.default_rng(0)
            xj = jnp.asarray(rng.standard_normal(big.cols).astype(np.float32))
            per_slab = {}
            for kw in (1, 2, 4):
                plan = plan_lanepack(big, kw=kw, pack="dense")
                arrs = lanepack_device_arrays(plan, b=16)
                st = {k: v for k, v in arrs.items() if k != "b"}
                fn = lambda x_: _spmv_lanepack_jit(
                    st, x_, rows=big.rows, cols=big.cols, kw=kw)
                per = _bench_loop(fn, xj, 1000)
                per_slab[kw] = per / max(1, arrs["vals"].shape[0]) * 1e9
                log(f"lanepack kw={kw}: {per_slab[kw]:.1f} ns/slab")
            # least-squares fit per_slab = fixed + kw_slope * kw
            ks = np.array(sorted(per_slab))
            ys = np.array([per_slab[k] for k in ks])
            slope, fixed = np.polyfit(ks, ys, 1)
            out["lanepack_kw_ns"] = float(max(0.1, slope))
            out["lanepack_fixed_ns"] = float(max(1.0, fixed))
            out["lanepack_dense_slab_ns"] = float(per_slab[1])

            plan = plan_lanepack(big, kw=1, pack="per_rb")
            arrs = lanepack_device_arrays(plan, b=16)
            st = {k: v for k, v in arrs.items() if k != "b"}
            fn = lambda x_: _spmv_lanepack_jit(
                st, x_, rows=big.rows, cols=big.cols, kw=1)
            per = _bench_loop(fn, xj, 1000)
            out["lanepack_per_rb_slab_ns"] = float(
                per / max(1, arrs["vals"].shape[0]) * 1e9
            )
            log(f"lanepack per_rb: {out['lanepack_per_rb_slab_ns']:.1f} ns/slab")

            # --- block-pair rate (precision as BlockSpgemm's f32 default) ---
            from ..formats.bcsr import BsrMatrix
            from ..ops.spgemm_block import _block_numeric

            bm = BsrMatrix.from_csr(m, 128)
            npairs = 512
            rng = np.random.default_rng(1)
            pa = jnp.asarray(rng.integers(0, bm.nnzb, npairs).astype(np.int32))
            pb = jnp.asarray(rng.integers(0, bm.nnzb, npairs).astype(np.int32))
            pc = jnp.asarray(np.sort(rng.integers(0, 64, npairs)).astype(np.int32))
            blocks = jnp.asarray(bm.blocks)

            def pairfn(v):
                outb = _block_numeric(
                    blocks * (1.0 + v * 0.0), blocks, pa, pb, pc,
                    num_c=64, bs=128, precision=jax.lax.Precision.HIGHEST,
                )
                return v + jnp.sum(outb) * 1e-30

            per = _bench_loop(pairfn, jnp.float32(0), 200)
            out["spgemm_mxu_pair_s"] = float(per / npairs)
            log(f"block pair: {out['spgemm_mxu_pair_s']:.3g} s/pair")

            # --- device ESC engine rate: the k-major expansion + packed
            # sort, the engine spgemm_auto's "esc" branch runs
            from ..ops.device_sorted import EscSpgemm

            esc_e = EscSpgemm(m, m, engine="auto", reduce="sort")
            esc_prods = esc_e.num_products

            def escfn(v):
                r = esc_e.multiply_device(
                    rhs_vals=esc_e.rhs_vals * (1.0 + v * 0.0))
                return v + jnp.sum(r.val) * 1e-30

            # first call = XLA compile at a fresh shape: the one-shot
            # compile burden spgemm_auto's device entries must carry
            t0 = time.perf_counter()
            float(escfn(jnp.float32(0)))
            first_s = time.perf_counter() - t0

            per = _bench_loop(escfn, jnp.float32(0), 30)
            out["spgemm_esc_products_per_s"] = float(esc_prods / per)
            out["device_oneshot_compile_s"] = float(
                max(0.5, first_s - per - out["device_call_sync_s"])
            )
            log(f"esc: {out['spgemm_esc_products_per_s']:.3g} products/s")
            log(f"oneshot compile: {out['device_oneshot_compile_s']:.3g} s")

            # --- dense MAC rate ---
            a = jnp.asarray(np.ones((2048, 2048), np.float32))

            def densefn(v):
                c = jnp.dot(
                    a * (1.0 + v * 0.0), a,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST,
                )
                return v + jnp.sum(c) * 1e-30

            per = _bench_loop(densefn, jnp.float32(0), 200)
            out["spgemm_dense_mac_per_s"] = float(2048**3 * 2 / per)
            log(f"dense: {out['spgemm_dense_mac_per_s']:.3g} MAC/s")
    finally:
        _calibrating = False

    if save and out:
        path = autotune_cache_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        existing = {}
        try:
            with open(path, "r") as f:
                existing = json.load(f)
        except (OSError, ValueError):
            pass
        existing.update(out)
        import jax

        existing["_backend"] = jax.default_backend()
        with open(path, "w") as f:
            json.dump(existing, f, indent=1, sort_keys=True)
        reset_cache()
    return out


def main() -> None:
    got = calibrate(save=True, verbose=True)
    print(json.dumps(got, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()

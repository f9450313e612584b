"""SpMV benchmark on one GPU: Poisson 512^2 through the planned operator
(automatic format selection — DIA for banded), the forced general path on
the same operator, the three general-structure corpus operators, and the
Poisson 2048^2 DIA operator in f32 and with bf16 value planes.

Prints ONE JSON line on stdout (diagnostics go to stderr):
  {"metric": "spmv_effective_bw_pct_hbm_roofline", "value": <pct>,
   "unit": "%", "device": {...}, "power_limit": "...",
   "headline_us": {"min":..., "median":..., "max":...}, ...}

"Effective bandwidth" counts the *ideal CSR* working set (8 bytes/nnz: f32
value + int32 column index, plus x and y once) against the apply time,
over the device's published memory peak (bench/roofline.py). DIA stores
no indices, so its share can exceed what the bytes it moves would give.
Each apply is timed as a chained loop inside one jit, to
``block_until_ready`` (bench/runner.py). Without a GPU the script fails.
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _bench(op, xj, iters):
    from sparse_matrix_tpu.bench.runner import bench_device_loop

    t0 = time.time()
    r = bench_device_loop(
        "op", lambda p, v: op.apply(p, v) * 0.2, xj,
        iters=iters, repeats=3, params=op.as_pytree(),
    )
    return r, time.time() - t0


def _check(a, op, xj, rng):
    """Spot-check 256 rows against a float64 host dot; raises on mismatch."""
    y = np.asarray(op(xj))
    x_h = np.asarray(xj)
    for i in rng.choice(a.rows, size=min(a.rows, 256), replace=False):
        lo, hi = int(a.offsets[i]), int(a.offsets[i + 1])
        ref = float(
            a.vals[lo:hi].astype(np.float64)
            @ x_h[a.indices[lo:hi].astype(np.int64)]
        )
        if abs(float(y[i]) - ref) > 1e-2 * max(1.0, abs(ref)):
            raise AssertionError(
                f"{op.format}: row {i} gives {float(y[i])}, reference {ref}")


def main():
    from sparse_matrix_tpu.utils.compile_cache import enable_compile_cache
    from sparse_matrix_tpu.utils.gpu import nvidia_smi_power, require_gpu

    enable_compile_cache()
    device = require_gpu()
    power = nvidia_smi_power()
    log(f"device: {device}; nvidia-smi: {power}")

    import jax.numpy as jnp

    from sparse_matrix_tpu.bench.corpus import (
        _fem_like, _power_law_rows, _random_local,
    )
    from sparse_matrix_tpu.bench.roofline import device_spec
    from sparse_matrix_tpu.ops.operator import SpmvOperator
    from sparse_matrix_tpu.solvers import poisson_2d_csr

    spec = device_spec(device["kind"])
    n = int(os.environ.get("SPMX_BENCH_N", "512"))
    iters = int(os.environ.get("SPMX_BENCH_ITERS", "3000"))

    t0 = time.time()
    a = poisson_2d_csr(n, dtype=np.float32)
    op = SpmvOperator(a)
    nnz, rows = a.nnz(), a.rows
    log(f"operator: poisson {n}^2, nnz={nnz}, format={op.format}, "
        f"bytes/apply={op.bytes_per_apply()}, plan {time.time()-t0:.1f}s")

    rng = np.random.default_rng(0)
    xj = jnp.asarray(rng.standard_normal(rows).astype(np.float32))
    _check(a, op, xj, rng)

    r, wall = _bench(op, xj, iters)
    per = r.seconds
    ideal_bytes = nnz * 8 + rows * 4 * 2
    pct = 100.0 * ideal_bytes / per / 1e9 / spec.hbm_gbps
    log(f"best-format ({op.format}): {per*1e3:.4f} ms -> {nnz/per/1e9:.1f} "
        f"Gnnz/s, effective {ideal_bytes/per/1e9:.0f} GB/s ({pct:.1f}%), "
        f"iters={r.iters}, wall {wall:.0f}s")

    out = {
        "metric": "spmv_effective_bw_pct_hbm_roofline",
        "value": pct,
        "unit": "%",
        "device": device,
        "power_limit": power,
        "headline_us": {k: v * 1e6 for k, v in r.stats().items()},
        "iters": r.iters,
    }

    # general path (no DIA special-casing) on the same operator
    op_g = SpmvOperator(a, force="bell")
    _check(a, op_g, xj, rng)
    rg, wall = _bench(op_g, xj, iters)
    out["general_pct"] = 100.0 * ideal_bytes / rg.seconds / 1e9 / spec.hbm_gbps
    out["general_gnnz"] = nnz / rg.seconds / 1e9
    log(f"general ({op_g.format}): {rg.seconds*1e3:.4f} ms, wall {wall:.0f}s")

    # corpus: the non-banded structure classes on their dispatched formats
    crng = np.random.default_rng(0)
    out["class_banded_pct"] = out["value"]
    for cname, cls_tag, cm in (
        ("femlike_262k", "local", _fem_like(crng, 512, 2)),
        ("randlocal_262k", "scatter", _random_local(crng, 1 << 18, 16, 4096)),
        ("powerlaw_262k", "skew", _power_law_rows(crng, 1 << 18, 16)),
    ):
        cop = SpmvOperator(cm)
        cx = jnp.asarray(crng.standard_normal(cm.cols).astype(np.float32))
        _check(cm, cop, cx, crng)
        rc, wall = _bench(cop, cx, iters)
        cib = cm.nnz() * 8 + (cm.rows + cm.cols) * 4
        out[f"class_{cls_tag}_pct"] = (
            100.0 * cib / rc.seconds / 1e9 / spec.hbm_gbps)
        out[f"class_{cls_tag}_gnnz"] = cm.nnz() / rc.seconds / 1e9
        log(f"corpus {cname} ({cop.format}): {rc.seconds*1e3:.4f} ms, "
            f"wall {wall:.0f}s")

    # Poisson 2048^2 DIA, f32 vs bf16 value planes
    a2 = poisson_2d_csr(2048, dtype=np.float32)
    x2 = jnp.asarray(rng.standard_normal(a2.rows).astype(np.float32))
    for tag, vdt in (("f32", None), ("bf16", jnp.bfloat16)):
        op2 = SpmvOperator(a2, force="dia", values_dtype=vdt)
        _check(a2, op2, x2, rng)
        r2, wall = _bench(op2, x2, 400)
        out[f"dia_2048_gnnz_{tag}"] = a2.nnz() / r2.seconds / 1e9
        log(f"dia 2048^2 {tag}: {r2.seconds*1e6:.1f} us, wall {wall:.0f}s")

    print(json.dumps(out))


if __name__ == "__main__":
    main()

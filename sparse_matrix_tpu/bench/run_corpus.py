"""Corpus benchmark CLI — the ``gen_bench_mul!`` criterion driver analog
(``spam_csr/src/lib.rs:386-437``): walk a MatrixMarket directory, parse each
file, convert DOK -> CSR, and bench SpGEMM squaring (``m @ m``) per file,
plus SpMV per file.

Usage:
    python -m sparse_matrix_tpu.bench.run_corpus [--dir matrices] [--spmv]
        [--engine auto|native|python|esc|block] [--generate]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .corpus import DEFAULT_CORPUS_DIR, generate_corpus, iter_corpus
from .roofline import spmv_ideal_bytes
from .runner import bench_host
from ..ops.spgemm_host import flops_per_row, spgemm_esc_host, spgemm_hash_host


def _engine(name: str):
    if name == "native":
        return lambda a, b: spgemm_hash_host(a, b, output_sorted=False)
    if name == "python":
        return lambda a, b: spgemm_hash_host(a, b, output_sorted=False, force_python=True)
    if name == "esc":
        return spgemm_esc_host
    if name == "block":
        from ..ops.spgemm_block import spgemm_block_device

        return spgemm_block_device
    if name == "dense":
        from ..ops.spgemm_block import spgemm_dense_xla

        return spgemm_dense_xla
    from ..ops.spgemm_block import spgemm_auto

    return spgemm_auto


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default=DEFAULT_CORPUS_DIR)
    ap.add_argument("--engine", default="native",
                    choices=["auto", "native", "python", "esc", "block", "dense"])
    ap.add_argument("--spmv", action="store_true", help="also bench operator SpMV")
    ap.add_argument("--spmv-force", default=None,
                    help="force an SpMV format (dia/hybrid/aligned/lanepack/ell)")
    ap.add_argument("--generate", action="store_true", help="create the synthetic corpus first")
    ap.add_argument("--small", action="store_true",
                    help="with --generate: skip the 2-4M-nnz bench matrices")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    if args.generate:
        generate_corpus(args.dir, include_large=not args.small)
    engine = _engine(args.engine)

    results = []
    for name, m in iter_corpus(args.dir):
        if m.rows != m.cols:
            continue
        flops = int(flops_per_row(m, m).sum())
        from ..utils.profiling import trace

        with trace(f"spgemm_{name}"):
            r = bench_host(name, lambda: engine(m, m), warmup=1, repeats=args.repeats)
        row = {
            "file": name,
            "rows": m.rows,
            "nnz": m.nnz(),
            "spgemm_engine": args.engine,
            "spgemm_ms": round(r.millis, 3),
            "spgemm_mprod_s": round(flops / r.seconds / 1e6, 1),
        }
        if args.spmv:
            import jax.numpy as jnp

            from ..ops.operator import SpmvOperator
            from .runner import bench_device_loop

            m32 = m if m.vals.dtype == np.float32 else _to_f32(m)
            op = SpmvOperator(m32, force=args.spmv_force)
            x0 = jnp.asarray(np.random.default_rng(0).standard_normal(m.cols).astype(np.float32))
            # operators go in as jit ARGUMENTS (as_pytree/apply), not as
            # compiled-in constants
            br = bench_device_loop(
                name, lambda p, v: op.apply(p, v) * 0.5, x0, iters=100,
                params=op.as_pytree(),
            )
            row["spmv_format"] = op.format
            # planner fill: slot occupancy of the chosen packed format —
            # the load-balancing metric of the slot-packing design (the
            # rows_to_threads analog, mul_hash.rs:38-64): skewed row
            # degrees must not collapse it
            for attr in ("_aligned", "_bell", "_plan"):
                plan = getattr(op, attr, None)
                if plan is not None and hasattr(plan, "fill"):
                    row["spmv_fill"] = round(float(plan.fill), 3)
                    break
            row["spmv_ms"] = round(br.millis, 4)
            row["spmv_gnnz_s"] = round(m.nnz() / br.seconds / 1e9, 2)
            row["spmv_eff_gbps"] = round(
                spmv_ideal_bytes(m.nnz(), m.rows, m.cols) / br.seconds / 1e9, 1
            )
        print(json.dumps(row), flush=True)
        results.append(row)

    if not results:
        print(f"no MatrixMarket files under {args.dir} (use --generate)", file=sys.stderr)


def _to_f32(m):
    from ..formats.csr import CsrMatrix

    return CsrMatrix(
        m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets, is_sorted=m.is_sorted
    )


if __name__ == "__main__":
    main()

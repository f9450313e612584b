"""Example: many small same-pattern systems as one device op.

    python examples/batched_systems.py [batch]

A parameter sweep over 512 small SPD systems (one shared pattern,
per-system coefficients) solved simultaneously by the lane-masked batched
CG — one small system at a time is launch-overhead bound, so the
batched path amortizes one launch over all systems.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from sparse_matrix_tpu.ops import BatchedEllOperator, batched_cg_solve
from sparse_matrix_tpu.solvers import poisson_2d_csr


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    pat = poisson_2d_csr(16, dtype=np.float32)  # 256 unknowns, shared pattern
    rng = np.random.default_rng(0)
    # per-system coefficients: scaled copies (any values on the pattern work)
    vals = np.stack([pat.vals * s for s in (0.5 + rng.random(batch))]).astype(np.float32)
    op = BatchedEllOperator(pat, vals)
    print(f"{batch} systems of {pat.rows} unknowns, one-hot matmul apply: {op.use_onehot}")

    b = rng.standard_normal((batch, pat.rows)).astype(np.float32)
    t0 = time.perf_counter()
    res = batched_cg_solve(op, b, tol=1e-5, maxiter=400)
    x = np.asarray(res.x)
    dt = time.perf_counter() - t0
    its = np.asarray(res.iterations)
    print(f"solved all {batch} in {dt*1e3:.1f} ms (includes compile on first run); "
          f"iterations min/median/max = {its.min()}/{int(np.median(its))}/{its.max()}")
    worst = int(np.argmax(np.asarray(res.residual_norm)))
    print(f"worst lane residual: {float(np.asarray(res.residual_norm)[worst]):.2e}")
    assert np.isfinite(x).all()


if __name__ == "__main__":
    from sparse_matrix_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

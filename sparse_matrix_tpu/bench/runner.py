"""Criterion-equivalent measurement harness.

Warmup + repeated timed runs + summary stats. Device work is chained
inside one jit (so per-call dispatch does not dominate) and timed on the
host clock up to ``block_until_ready``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["BenchResult", "bench_host", "bench_device_loop"]


@dataclass
class BenchResult:
    name: str
    seconds: float  # best per-iteration time
    all_runs: list
    iters: int = 1  # chain length the runs were divided by

    @property
    def millis(self) -> float:
        return self.seconds * 1e3

    def throughput(self, units: float) -> float:
        return units / self.seconds

    def stats(self) -> Dict[str, float]:
        """min/median/max per-iteration seconds over the recorded runs —
        the criterion-style spread VERDICT r2 asked the JSON artifacts to
        carry (the reference benches with criterion,
        ``spam_csr/benches/mul_hash.rs:4-11``)."""
        runs = np.asarray(self.all_runs, dtype=np.float64) / max(self.iters, 1)
        return {
            "min": float(runs.min()),
            "median": float(np.median(runs)),
            "max": float(runs.max()),
        }

    def __repr__(self):
        return f"BenchResult({self.name}: {self.millis:.4f} ms)"


def bench_host(name: str, f: Callable, *, warmup: int = 2, repeats: int = 5) -> BenchResult:
    """Wall-clock a host-side callable (native SpGEMM, planners, parsers)."""
    for _ in range(warmup):
        f()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        f()
        runs.append(time.perf_counter() - t0)
    return BenchResult(name, min(runs), runs)


def bench_device_loop(
    name: str,
    step: Callable,  # x -> x-like (chained dependency)
    x0,
    *,
    iters: int = 2000,
    repeats: int = 3,
    min_loop_seconds: float = 0.4,
    params=None,
) -> BenchResult:
    """Time ``step`` by chaining ``iters`` applications inside one jit.

    The chain length is auto-scaled until one loop takes >=
    ``min_loop_seconds``, so host-clock noise is a small fraction of the
    reading. fori_loop tracing is O(1) in ``iters``, so rescaling costs one
    extra compile.

    ``params``: optional pytree passed to ``step(params, x)`` as a jit
    ARGUMENT instead of a closure constant — large operators
    (``SpmvOperator.as_pytree()``) otherwise bake their arrays into the
    compiled program.
    """
    import jax

    def make_loop(n):
        if params is None:
            @jax.jit
            def loop(x):
                return jax.lax.fori_loop(0, n, lambda i, v: step(v), x)

            return lambda x: loop(x)

        @jax.jit
        def loop_p(p, x):
            return jax.lax.fori_loop(0, n, lambda i, v: step(p, v), x)

        return lambda x: loop_p(params, x)

    def timed(loop):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(x0))
        return time.perf_counter() - t0

    loop = make_loop(iters)
    jax.block_until_ready(loop(x0))  # compile + warmup
    first = timed(loop)
    if first < min_loop_seconds:
        iters = int(iters * min_loop_seconds / max(first, 1e-9)) + 1
        loop = make_loop(iters)
        jax.block_until_ready(loop(x0))
    runs = [timed(loop) for _ in range(repeats)]
    return BenchResult(name, min(runs) / iters, runs, iters=iters)

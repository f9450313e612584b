"""Profiling hooks.

The reference profiles externally (perf @997Hz -> flamegraph,
``flamegraph.sh:1``); the device equivalent is the JAX profiler producing
Perfetto/TensorBoard traces. This module wraps it so benches and the corpus
runner can flip tracing on with one env var (``SPMX_TRACE_DIR``), plus the
in-code instrument the reference ships: probe-length histograms behind the
debug flag (see ``utils.debugflags``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

__all__ = ["trace", "trace_dir"]


def trace_dir() -> Optional[str]:
    return os.environ.get("SPMX_TRACE_DIR") or None


@contextlib.contextmanager
def trace(label: str = "spmx", directory: Optional[str] = None) -> Iterator[None]:
    """Capture a JAX profiler trace around the block if tracing is enabled
    (``SPMX_TRACE_DIR`` env var or explicit ``directory``); no-op otherwise.

    View with TensorBoard or ui.perfetto.dev.
    """
    directory = directory or trace_dir()
    if not directory:
        yield
        return
    import jax

    path = os.path.join(directory, label)
    os.makedirs(path, exist_ok=True)
    with jax.profiler.trace(path):
        yield

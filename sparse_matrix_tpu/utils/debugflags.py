"""Debug instrumentation flags.

The reference wires a ``debug`` cargo feature through ``spam_csr`` into
``linprobe`` to record probe-length histograms and per-phase row_nz dumps
(``linprobe/src/map.rs:17-18``, ``spam_csr/src/mul_hash.rs:18-25``). Here the
equivalent is a runtime flag (env var ``SPMX_DEBUG=1`` or
:func:`set_debug`) plus a process-global histogram store the benches and tests
can read back.
"""

from __future__ import annotations

import os
from typing import Dict

__all__ = [
    "debug_enabled",
    "set_debug",
    "record_histogram",
    "get_histograms",
    "clear_histograms",
    "autotune_cache_path",
    "autotune_on_first_use",
    "native_stripe_disabled",
    "hbm_budget_bytes",
    "compilation_cache_dir",
]

_DEBUG = os.environ.get("SPMX_DEBUG", "0") not in ("", "0", "false", "False")
_HISTOGRAMS: Dict[str, Dict[int, int]] = {}


def debug_enabled() -> bool:
    return _DEBUG


def set_debug(on: bool) -> None:
    global _DEBUG
    _DEBUG = bool(on)


def record_histogram(name: str, hist: Dict[int, int]) -> None:
    agg = _HISTOGRAMS.setdefault(name, {})
    for k, v in hist.items():
        agg[k] = agg.get(k, 0) + v


def get_histograms() -> Dict[str, Dict[int, int]]:
    return {k: dict(v) for k, v in _HISTOGRAMS.items()}


def clear_histograms() -> None:
    _HISTOGRAMS.clear()


def autotune_cache_path() -> str:
    """Where :mod:`..utils.autotune` persists measured cost-model constants.

    ``SPMX_AUTOTUNE_CACHE`` overrides (tests point it at a tmp file);
    default is a per-user cache keyed later by backend inside the file.
    """
    p = os.environ.get("SPMX_AUTOTUNE_CACHE")
    if p:
        return p
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache"),
        "spmx",
        "autotune.json",
    )


def autotune_on_first_use() -> bool:
    """``SPMX_AUTOTUNE=1``: run the on-device calibration at first use when
    no cache exists (its probes take a while to compile, hence opt-in; the
    explicit CLI ``python -m sparse_matrix_tpu.utils.autotune`` is the
    usual way)."""
    return os.environ.get("SPMX_AUTOTUNE", "0") not in ("", "0")


def native_stripe_disabled() -> bool:
    """``SPMX_NO_NATIVE_STRIPE=1``: force the numpy reference body of
    ``plan_stripe`` (parity tests diff it against the native assembly)."""
    return os.environ.get("SPMX_NO_NATIVE_STRIPE", "0") not in ("", "0")


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` ("" when unset): JAX reads it itself;
    utils.compile_cache only needs to know whether it is set."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR", "")


def hbm_budget_bytes() -> float:
    """``SPMX_HBM_BYTES``: device memory budget for pre-flight plan-size
    guards (AmgRefresh); 0 disables the guard. Default: the first
    device's ``memory_stats()["bytes_limit"]`` where it reports one (the
    memory this process may allocate), else no guard."""
    env = os.environ.get("SPMX_HBM_BYTES")
    if env is not None:
        return float(env)
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return float(stats.get("bytes_limit", 0))

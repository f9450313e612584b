"""The GPU a measurement runs on: refuse anything else, and describe it.

Measurement entry points (``bench.py``, ``chip_smoke.py``) call
:func:`require_gpu` first: a number taken on the CPU must never be
reported as a device number, so there is no CPU fallback.
"""

from __future__ import annotations

import subprocess

__all__ = ["require_gpu", "nvidia_smi_power"]


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices; raises
    RuntimeError when JAX's default backend is not a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {backend!r} "
            f"({jax.devices()}); this entry point measures the GPU only"
        )
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def nvidia_smi_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()

"""Test configuration.

Tests run on a virtual 8-device CPU platform so that multi-device sharding
code paths (``sparse_matrix_tpu.parallel``) are exercised without GPUs.
``SPMX_GPU_TESTS=1`` keeps the real backend instead, for the tests marked
``gpu`` (``chip_smoke.py`` runs them in its own process on the card).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# tests must not read this machine's autotune calibration cache: dispatch
# assertions are written against the packaged defaults (individual tests
# repoint this to tmp files to test calibration-driven dispatch)
os.environ.setdefault("SPMX_AUTOTUNE_CACHE", "/nonexistent/spmx-autotune-off.json")

import jax  # noqa: E402

if os.environ.get("SPMX_GPU_TESTS", "0") in ("", "0"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hypothesis import settings, HealthCheck  # noqa: E402

settings.register_profile(
    "default",
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
    max_examples=50,
)
settings.register_profile("deep", parent=settings.get_profile("default"), max_examples=1000)
settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "default"))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is a GPU (decided per test, never at
    import: workers must all collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: `python chip_smoke.py` runs the gpu tests "
                    "on the card (SPMX_GPU_TESTS=1)")

"""The pieces every device measurement stands on: the compile-cache
location, the peak table, one-push transfers, the GPU requirement, the
device-memory budget and the block_until_ready timing loops."""

import os

import numpy as np
import pytest


def test_compile_cache_env_var_is_left_to_jax(monkeypatch, tmp_path):
    import jax

    from sparse_matrix_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # untouched


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import jax

    from sparse_matrix_tpu.utils.compile_cache import (
        default_cache_dir, enable_compile_cache,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert default_cache_dir() == os.path.join(root, ".jax_cache")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == default_cache_dir()
        assert jax.config.jax_compilation_cache_dir == default_cache_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_peak_table_known_kind():
    from sparse_matrix_tpu.bench.roofline import device_spec, roofline_pct

    spec = device_spec("NVIDIA H100 80GB HBM3")
    assert (spec.hbm_gbps, spec.bf16_tflops, spec.f32_tflops) == (3350.0, 989.0, 67.0)
    assert "data sheet" in spec.source
    assert roofline_pct(1675.0, spec) == pytest.approx(50.0)


def test_peak_table_unknown_kind_raises():
    from sparse_matrix_tpu.bench.roofline import device_spec

    with pytest.raises(KeyError, match="no published peaks"):
        device_spec("cpu")


def test_to_device_large_array_is_one_push(monkeypatch):
    import jax.numpy as jnp

    from sparse_matrix_tpu.utils import transfer

    calls = []
    real = jnp.asarray
    monkeypatch.setattr(jnp, "asarray", lambda a, *k, **kw: calls.append(a) or real(a, *k, **kw))
    a = np.arange(10_000_000, dtype=np.float32)  # 40 MB
    b0, s0 = transfer.transfer_bytes(), transfer.transfer_seconds()
    out = transfer.to_device(a)
    assert len(calls) == 1 and out.shape == a.shape
    assert float(out[-1]) == a[-1]
    assert transfer.transfer_bytes() - b0 == a.nbytes
    assert transfer.transfer_seconds() >= s0
    assert transfer.to_device(out) is out  # device arrays pass through


def test_require_gpu_refuses_cpu():
    from sparse_matrix_tpu.utils.gpu import require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def test_hbm_budget_env_override_and_device_default(monkeypatch):
    import jax

    from sparse_matrix_tpu.utils.debugflags import hbm_budget_bytes

    monkeypatch.setenv("SPMX_HBM_BYTES", "123")
    assert hbm_budget_bytes() == 123.0
    monkeypatch.delenv("SPMX_HBM_BYTES")
    stats = jax.devices()[0].memory_stats() or {}
    assert hbm_budget_bytes() == float(stats.get("bytes_limit", 0))


def test_bench_device_loop_times_to_completion():
    import jax.numpy as jnp

    from sparse_matrix_tpu.bench.runner import bench_device_loop

    r = bench_device_loop("scale", lambda v: v * 0.5, jnp.ones(1024),
                          iters=10, repeats=2, min_loop_seconds=0.01)
    assert r.seconds > 0 and r.iters >= 10 and len(r.all_runs) == 2
    p = bench_device_loop("params", lambda p, v: v * p, jnp.ones(8),
                          iters=5, repeats=1, min_loop_seconds=0.0,
                          params=jnp.float32(0.5))
    assert p.iters == 5


def test_autotune_bench_loop_positive():
    import jax.numpy as jnp

    from sparse_matrix_tpu.utils.autotune import _bench_loop

    assert _bench_loop(lambda v: v + 1.0, jnp.zeros(16), 10) > 0

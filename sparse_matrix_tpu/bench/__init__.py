"""Benchmark harness: corpus, criterion-like runner, roofline accounting."""

from .corpus import generate_corpus, iter_corpus, DEFAULT_CORPUS_DIR  # noqa: F401
from .runner import BenchResult, bench_host, bench_device_loop  # noqa: F401
from .roofline import PEAKS, DeviceSpec, device_spec, spmv_ideal_bytes, spgemm_flops, roofline_pct  # noqa: F401

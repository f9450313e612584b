"""Block-dense MXU SpGEMM tests (BCSR format + block pair planner + kernel)."""

import numpy as np
import pytest
from hypothesis import given, settings

from sparse_matrix_tpu.core import DokMatrix
from sparse_matrix_tpu.formats import CsrMatrix
from sparse_matrix_tpu.formats.bcsr import BsrMatrix
from sparse_matrix_tpu.ops.spgemm_block import (
    block_pairs_plan,
    spgemm_auto,
    spgemm_block_device,
)
from sparse_matrix_tpu.verify.strategies import finite_f64s, mul_pairs

# bounded magnitude: this test uses plain rtol/atol against an f64 dense
# reference, which catastrophic cancellation at extreme magnitudes breaks;
# the Higham-bound fuzz oracle covers the full value domain
F32 = finite_f64s().map(lambda v: np.float32(np.clip(v, -1e6, 1e6)))


def test_bcsr_roundtrip():
    rng = np.random.default_rng(0)
    a = (rng.random((300, 200)) < 0.05) * rng.standard_normal((300, 200))
    A = CsrMatrix.from_dok(DokMatrix.from_dense(a.astype(np.float32)))
    B = BsrMatrix.from_csr(A, 128)
    assert B.nnzb <= B.brows * B.bcols
    back = B.to_csr()
    np.testing.assert_allclose(back.to_dense(), a.astype(np.float32))


def test_bcsr_small_blocks():
    rng = np.random.default_rng(1)
    a = (rng.random((20, 20)) < 0.3) * rng.standard_normal((20, 20))
    A = CsrMatrix.from_dok(DokMatrix.from_dense(a.astype(np.float32)))
    B = BsrMatrix.from_csr(A, 8)
    np.testing.assert_allclose(B.to_csr().to_dense(), a.astype(np.float32))


def test_block_pairs_plan_counts():
    rng = np.random.default_rng(2)
    a = (rng.random((100, 120)) < 0.02) * 1.0
    b = (rng.random((120, 90)) < 0.02) * 1.0
    A = BsrMatrix.from_csr(CsrMatrix.from_dok(DokMatrix.from_dense(a)), 32)
    B = BsrMatrix.from_csr(CsrMatrix.from_dok(DokMatrix.from_dense(b)), 32)
    pa, pb, pc, keys = block_pairs_plan(A, B)
    assert len(pa) == len(pb) == len(pc)
    # pairs sorted by C block (revisit-accumulation contract)
    assert np.all(np.diff(pc) >= 0)
    assert pc.max() == len(keys) - 1 if len(pa) else True


@settings(max_examples=20)
@given(mul_pairs(F32, dtype=np.float32))
def test_spgemm_block_commutes(pair):
    la = CsrMatrix.from_dok(pair.a, dtype=np.float32)
    lb = CsrMatrix.from_dok(pair.b, dtype=np.float32)
    out = spgemm_block_device(la, lb, bs=8)
    assert out.invariants()
    a64 = pair.a.to_dense().astype(np.float64)
    b64 = pair.b.to_dense().astype(np.float64)
    expected = a64 @ b64
    # Higham-style per-element bound: |err| <= c*u*(|A| @ |B|)
    bound = 1e-5 + 4 * np.finfo(np.float32).eps * (np.abs(a64) @ np.abs(b64))
    assert np.all(np.abs(out.to_dense().astype(np.float64) - expected) <= bound)


def test_spgemm_block_medium():
    rng = np.random.default_rng(3)
    a = (rng.random((300, 260)) < 0.03) * rng.standard_normal((300, 260))
    b = (rng.random((260, 310)) < 0.03) * rng.standard_normal((260, 310))
    A = CsrMatrix.from_dok(DokMatrix.from_dense(a.astype(np.float32)))
    B = CsrMatrix.from_dok(DokMatrix.from_dense(b.astype(np.float32)))
    out = spgemm_block_device(A, B, bs=128)
    ref = a.astype(np.float32) @ b.astype(np.float32)
    np.testing.assert_allclose(out.to_dense(), ref, rtol=1e-3, atol=1e-4)


def test_spgemm_auto_dispatches():
    rng = np.random.default_rng(4)
    a = (rng.random((64, 64)) < 0.05) * rng.standard_normal((64, 64))
    A = CsrMatrix.from_dok(DokMatrix.from_dense(a.astype(np.float32)))
    out = spgemm_auto(A, A)
    np.testing.assert_allclose(
        out.to_dense(), (a @ a).astype(np.float32), rtol=1e-3, atol=1e-4
    )


def test_block_spgemm_bf16_storage():
    # bf16 block storage halves DMA; result within bf16 operand tolerance
    import numpy as np

    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats import CsrMatrix
    from sparse_matrix_tpu.ops.spgemm_block import BlockSpgemm

    rng = np.random.default_rng(21)
    a = (rng.random((384, 384)) < 0.05) * rng.standard_normal((384, 384))
    A = CsrMatrix.from_dok(DokMatrix.from_dense(a.astype(np.float32)))
    ref = a.astype(np.float32) @ a.astype(np.float32)
    eng = BlockSpgemm(A, A, storage="bf16")
    C = np.asarray(eng.multiply_device())
    assert C.dtype == np.float32
    got = eng.multiply().to_dense()
    scale = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got / scale, ref / scale, atol=3e-2)
    # f32 storage stays exact-operand
    eng32 = BlockSpgemm(A, A)
    np.testing.assert_allclose(eng32.multiply().to_dense(), ref, rtol=1e-4, atol=1e-4)


def test_spgemm_auto_tiny_banded_stays_on_host(monkeypatch):
    """A tiny banded product must answer on host: every device engine pays
    device_call_sync_s (plus, first time, a compile), so the banded->DIA
    shortcut may only fire when the host estimate exceeds the sync
    constant. Regression for the 4x4 MatrixMarket A@A verify flow stalling
    on device backend init."""
    import json

    import importlib

    dia_mod = importlib.import_module("sparse_matrix_tpu.ops.spgemm_dia")
    from sparse_matrix_tpu.solvers import poisson_2d_csr
    from sparse_matrix_tpu.utils import autotune

    a = poisson_2d_csr(8, dtype=np.float32)  # banded, 64 rows: host-tiny

    def boom(*_a, **_k):
        raise AssertionError("device DIA engine reached for a tiny product")

    monkeypatch.setattr(dia_mod, "spgemm_dia", boom)
    out = spgemm_auto(A := a, A)
    ref = a.to_dense().astype(np.float32) @ a.to_dense().astype(np.float32)
    np.testing.assert_allclose(out.to_dense(), ref, rtol=1e-4, atol=1e-4)

    # and the shortcut still fires once the host estimate clears the sync
    # constant: shrink the sync to zero via the calibration cache
    called = {}

    def mark(da, db):
        called["yes"] = True
        raise RuntimeError("stop after dispatch")

    monkeypatch.setattr(dia_mod, "spgemm_dia", mark)
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump({"device_call_sync_s": 1e-12}, f)
        path = f.name
    monkeypatch.setenv("SPMX_AUTOTUNE_CACHE", path)
    autotune.reset_cache()
    try:
        import pytest as _pytest

        with _pytest.raises(RuntimeError):
            spgemm_auto(a, a)
        assert called.get("yes")
    finally:
        autotune.reset_cache()


def test_colmap_spgemm_parity_and_gate():
    """rhs with <=1 entry/row routes to the native colmap engine
    (hash-free relabel+merge; degenerate mul_hash case,
    /root/reference/spam_csr/src/mul_hash.rs). Parity vs the hash engine
    on duplicate-target merges, empty rhs rows, and computed zeros."""
    from sparse_matrix_tpu.native import colmap_spgemm_native, native_available
    from sparse_matrix_tpu.ops.spgemm_host import spgemm_hash_host

    if not native_available():
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(7)
    for dtype in (np.float64, np.float32):
        for _ in range(20):
            n, m, k = (int(v) for v in rng.integers(1, 30, 3))
            d = DokMatrix.new(n, m)
            for _ in range(int(rng.integers(0, 60))):
                d.set_element(
                    (int(rng.integers(n)), int(rng.integers(m))),
                    float(rng.normal()),
                )
            a = CsrMatrix.from_dok(d)
            a = CsrMatrix(a.rows, a.cols, a.vals.astype(dtype), a.indices, a.offsets, is_sorted=True)
            ro = np.zeros(m + 1, np.int64)
            ri, rv = [], []
            for j in range(m):
                ro[j + 1] = ro[j]
                if rng.random() < 0.6:  # 40% empty rows
                    # duplicate targets force per-row merges; zero values
                    # must be KEPT (hash-engine semantics)
                    ri.append(int(rng.integers(max(1, k // 2))))
                    rv.append(float(rng.choice([0.0, rng.normal()])))
                    ro[j + 1] += 1
            t = CsrMatrix(
                m, k, np.array(rv, dtype),
                np.array(ri, np.uint32) if ri else np.zeros(0, np.uint32),
                ro, is_sorted=True,
            )
            got = colmap_spgemm_native(a, t)
            ref = spgemm_hash_host(a, t, output_sorted=True)
            assert got is not None
            np.testing.assert_array_equal(np.asarray(got.offsets), np.asarray(ref.offsets))
            np.testing.assert_array_equal(np.asarray(got.indices), np.asarray(ref.indices))
            np.testing.assert_allclose(np.asarray(got.vals), np.asarray(ref.vals), rtol=1e-6)
            assert got.invariants()

    # spgemm_auto gates onto it (returns sorted even for output_sorted=False)
    out = spgemm_auto(a, t, output_sorted=False)
    np.testing.assert_allclose(
        out.to_dense(), a.to_dense() @ t.to_dense(), rtol=1e-5, atol=1e-6
    )


def test_spgemm_auto_cpu_backend_runs_host_engine(monkeypatch, tmp_path):
    """On the CPU backend a non-banded product that clears the device
    floors still runs on the host hash engine: the device engines are
    never priced or called."""
    import json

    import sparse_matrix_tpu.ops.spgemm_block as sb
    from sparse_matrix_tpu.ops.spgemm_host import spgemm_hash_host
    from sparse_matrix_tpu.utils import autotune

    def boom(*_a, **_k):
        raise AssertionError("device SpGEMM engine reached on the CPU backend")

    monkeypatch.setattr(sb, "spgemm_cost_estimates", boom)
    monkeypatch.setattr(sb, "spgemm_block_device", boom)
    monkeypatch.setattr(sb, "spgemm_dense_xla", boom)
    p = tmp_path / "autotune.json"
    p.write_text(json.dumps({"device_call_sync_s": 1e-12,
                             "device_oneshot_compile_s": 1e-12}))
    monkeypatch.setenv("SPMX_AUTOTUNE_CACHE", str(p))
    autotune.reset_cache()
    try:
        rng = np.random.default_rng(8)
        n = 600
        r = rng.integers(0, n, 6000)
        c = rng.integers(0, n, 6000)
        a = CsrMatrix.from_coo(n, n, r, c, rng.standard_normal(6000).astype(np.float32))
        out = spgemm_auto(a, a)
        ref = spgemm_hash_host(a, a, output_sorted=True)
        np.testing.assert_array_equal(out.offsets, ref.offsets)
        np.testing.assert_array_equal(out.indices, ref.indices)
        np.testing.assert_allclose(out.vals, ref.vals, rtol=1e-6)
    finally:
        autotune.reset_cache()

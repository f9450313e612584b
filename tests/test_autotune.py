"""Autotuned cost-model constants drive dispatch (VERDICT r1 item 5).

The constants (LanePack kw/pack model, spgemm_auto rates) must come from the
calibration cache when one exists, and changing the cache must change the
decisions."""

import json

import numpy as np
import pytest

from sparse_matrix_tpu.core import DokMatrix
from sparse_matrix_tpu.formats import CsrMatrix
from sparse_matrix_tpu.formats.lanepack import plan_lanepack
from sparse_matrix_tpu.ops.spgemm_block import spgemm_cost_estimates
from sparse_matrix_tpu.utils import autotune


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"

    def put(**kw):
        path.write_text(json.dumps(kw))
        autotune.reset_cache()

    monkeypatch.setenv("SPMX_AUTOTUNE_CACHE", str(path))
    autotune.reset_cache()
    yield put
    autotune.reset_cache()


def _scatter_matrix(rng, n=2048, per_row=6):
    r = np.repeat(np.arange(n, dtype=np.int64), per_row)
    c = rng.integers(0, n, size=len(r)).astype(np.int64)
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    v = rng.standard_normal(len(r)).astype(np.float32)
    offs = np.zeros(n + 1, np.int64)
    np.add.at(offs, r + 1, 1)
    np.cumsum(offs, out=offs)
    return CsrMatrix(n, n, v, c.astype(np.uint32), offs, is_sorted=True)


def test_defaults_without_cache(cache):
    assert autotune.get("lanepack_fixed_ns") == autotune.DEFAULTS["lanepack_fixed_ns"]
    with pytest.raises(KeyError):
        autotune.get("no_such_constant")


def test_cache_overrides_defaults(cache):
    cache(lanepack_fixed_ns=123.0)
    assert autotune.get("lanepack_fixed_ns") == 123.0
    # unknown / invalid entries are ignored
    cache(lanepack_fixed_ns=-5, bogus=1.0)
    assert autotune.get("lanepack_fixed_ns") == autotune.DEFAULTS["lanepack_fixed_ns"]


def test_lanepack_kw_choice_follows_calibration(cache):
    # scattered matrix: wider windows merge groups (fewer slabs). When the
    # calibration says kw is free, the planner picks a wide window; when it
    # says kw is hugely expensive, it must pick kw=1.
    rng = np.random.default_rng(0)
    m = _scatter_matrix(rng, per_row=20)
    cache(lanepack_fixed_ns=30.0, lanepack_kw_ns=0.001)
    kw_cheap = plan_lanepack(m).kw
    cache(lanepack_fixed_ns=30.0, lanepack_kw_ns=1e6)
    kw_dear = plan_lanepack(m).kw
    assert kw_dear == 1
    assert kw_cheap > kw_dear


def test_pack_choice_follows_calibration(cache):
    # near-equal slab counts: making per_rb free flips the auto choice
    rng = np.random.default_rng(1)
    a = (rng.random((640, 640)) < 0.05) * rng.standard_normal((640, 640))
    m = CsrMatrix.from_dok(DokMatrix.from_dense(a.astype(np.float32)))
    cache(lanepack_per_rb_slab_ns=0.001, lanepack_dense_slab_ns=1e6)
    assert plan_lanepack(m, kw=1, pack="auto").pack == "per_rb"
    cache(lanepack_per_rb_slab_ns=1e6, lanepack_dense_slab_ns=0.001)
    assert plan_lanepack(m, kw=1, pack="auto").pack == "dense"


def test_spgemm_engine_choice_follows_calibration(cache):
    rng = np.random.default_rng(2)
    m = _scatter_matrix(rng, n=1024, per_row=4)
    cache(spgemm_host_products_per_s=1e30)
    c = spgemm_cost_estimates(m, m)
    assert c["host"] < min(c["mxu"], c["dense"])
    cache(
        spgemm_host_products_per_s=1e-3,
        spgemm_dense_mac_per_s=1e30,
        spgemm_host_touch_s_per_byte=1e-30,
    )
    c = spgemm_cost_estimates(m, m)
    assert c["dense"] < c["host"]


def test_calibrate_host_constants_and_persist(cache, tmp_path, monkeypatch):
    # host-side calibration runs anywhere and persists a loadable cache
    got = autotune.calibrate(save=True)
    assert got["spgemm_host_products_per_s"] > 0
    assert got["spgemm_host_touch_s_per_byte"] > 0
    autotune.reset_cache()
    assert autotune.get("spgemm_host_products_per_s") == pytest.approx(
        got["spgemm_host_products_per_s"]
    )


def test_esc_engine_choice_follows_calibration(cache):
    rng = np.random.default_rng(3)
    m = _scatter_matrix(rng, n=1024, per_row=4)
    cache(
        spgemm_esc_products_per_s=1e30,
        device_call_sync_s=1e-30,
        spgemm_host_products_per_s=1e-3,
        spgemm_host_touch_s_per_byte=1e-30,
        spgemm_mxu_pair_s=1e3,
        spgemm_dense_mac_per_s=1e-3,
    )
    c = spgemm_cost_estimates(m, m)
    assert c["esc"] < min(c["host"], c["mxu"], c["dense"])
    # a slow device sync keeps one-shot calls off the device engines
    cache(device_call_sync_s=1e9)
    c = spgemm_cost_estimates(m, m)
    assert c["host"] < min(c["esc"], c["mxu"], c["dense"])


def test_oneshot_compile_term_guards_device_engines(monkeypatch, tmp_path):
    """spgemm_auto's device entries must carry the first-call XLA compile
    cost: a calibrated cache with fast device rates but a large compile
    constant keeps one-shot dispatch on host (regression: a calibrated
    cache routed amg_setup's Galerkin products to the ESC engine, which
    stalled minutes per level on compiles)."""
    import json

    import numpy as np

    from sparse_matrix_tpu.core import DokMatrix
    from sparse_matrix_tpu.formats import CsrMatrix
    from sparse_matrix_tpu.ops.spgemm_block import spgemm_cost_estimates

    rng = np.random.default_rng(0)
    d = ((rng.random((400, 400)) < 0.05) * rng.standard_normal((400, 400)))
    a = CsrMatrix.from_dok(DokMatrix.from_dense(d.astype(np.float32)))

    base = {
        "spgemm_esc_products_per_s": 1e12,  # absurdly fast device engine
        "spgemm_host_products_per_s": 1e6,  # slow host
        "spgemm_host_touch_s_per_byte": 1e-12,
        "device_call_sync_s": 1e-9,  # loader drops non-positive values
    }
    for compile_s, device_should_win in ((1000.0, False), (1e-9, True)):
        p = tmp_path / f"cache_{compile_s}.json"
        p.write_text(json.dumps({**base, "device_oneshot_compile_s": compile_s}))
        monkeypatch.setenv("SPMX_AUTOTUNE_CACHE", str(p))
        autotune.reset_cache()
        costs = spgemm_cost_estimates(a, a)
        best = min(costs, key=costs.get)
        if device_should_win:
            assert best != "host", costs
        else:
            assert best == "host", costs
    autotune.reset_cache()


def test_dispatch_boundaries_with_v2_rates(cache):
    """VERDICT r4 #9: the one-shot table re-priced with the ESC v2 rate.
    Three class boundaries under direct-attached-like device constants
    (sync ~50 us, compile ~2 s — the default 40 s compile keeps one-shot
    work on host, which the previous test pins):
    tiny products -> host; large unstructured -> esc (the v2 rate beats
    the 1-core host hash); block-dense -> mxu."""
    rng = np.random.default_rng(9)
    direct = dict(
        device_call_sync_s=5e-5,
        device_oneshot_compile_s=2.0,
        spgemm_esc_products_per_s=1.7e8,  # v2 measured (esc_v3_bench)
        spgemm_host_products_per_s=5e7,
        spgemm_host_touch_s_per_byte=4e-9,
        spgemm_mxu_pair_s=4.5e-7,
        spgemm_dense_mac_per_s=2e13,
    )
    cache(**direct)

    # tiny: the fixed device costs dominate -> host
    tiny = _scatter_matrix(rng, n=256, per_row=3)
    c = spgemm_cost_estimates(tiny, tiny)
    assert c["host"] < min(c["esc"], c["mxu"], c["dense"])

    # large unstructured: even at the v2 rate, one-shot esc stays behind
    # the host hash — its HOST plan build (~48 ns/product of expand+pack
    # numpy) alone exceeds the 20 ns/product hash engine, which is exactly
    # why amortizing callers (EscSpgemm re-multiply, FixedSideSpgemm)
    # bypass this dispatcher and one-shot unstructured work stays on host.
    # Among the DEVICE engines esc is still the unstructured best.
    big = _scatter_matrix(rng, n=1 << 15, per_row=48)
    c = spgemm_cost_estimates(big, big)
    assert c["host"] < c["esc"], c
    assert c["esc"] < min(c["mxu"], c["dense"]), c

    # block-dense: a few dense 128-blocks -> mxu beats esc (products per
    # block pair are huge, pair count tiny)
    bs = 128
    rows = []
    cols = []
    for bi in range(4):
        r0 = bi * bs
        rr, cc = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
        rows.append((r0 + rr).ravel())
        cols.append((r0 + cc).ravel())
    r = np.concatenate(rows)
    c_ = np.concatenate(cols)
    from sparse_matrix_tpu.formats.csr import CsrMatrix

    blocky = CsrMatrix.from_coo(512, 512, r, c_,
                                rng.standard_normal(len(r)))
    c = spgemm_cost_estimates(blocky, blocky)
    assert c["mxu"] < c["esc"], c

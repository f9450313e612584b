"""chip_smoke.py's phases at tiny size on the CPU (the card runs them at
Poisson 2048^2), and the script's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_phase_spmv_tiny():
    chip_smoke.phase_spmv(32, "tiny", timing=False)


def test_phase_matmat_tiny():
    chip_smoke.phase_matmat(32, "tiny", timing=False)


def test_phase_solvers_tiny():
    # 40^2 = 1600 rows: above solve()'s dense cutoff, so IC(0)-PCG runs
    iters, _res = chip_smoke.amg_pcg_iterations(40)
    chip_smoke.phase_solvers(40, amg_cpu_iterations=iters)


def test_phase_solvers_rejects_iteration_drift():
    iters, _res = chip_smoke.amg_pcg_iterations(24)
    with pytest.raises(AssertionError, match="iterations"):
        chip_smoke.phase_solvers(
            24, amg_cpu_iterations=iters + chip_smoke.AMG_ITER_SLACK + 5)


def test_phase_spgemm_tiny():
    chip_smoke.phase_spgemm(32, 2048, timing=False)


def test_phase_four_on_virtual_devices():
    # conftest provides 8 virtual CPU devices; the strategies take 4
    assert chip_smoke.phase_four(24, 16, 4) == 9


def test_check_apply_rejects_tf32_grade_error():
    import numpy as np
    import scipy.sparse as sp

    a = sp.random(50, 50, density=0.2, random_state=0, format="csr")
    x = np.random.default_rng(0).standard_normal(50)
    y = a @ x
    assert chip_smoke.check_apply("exact", a, x, y, chip_smoke.TOL_F32) < 1e-12
    with pytest.raises(AssertionError):
        chip_smoke.check_apply("tf32", a, x, y * (1 + 2.0 ** -11),
                               chip_smoke.TOL_F32)


def test_script_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr

    # alone in a directory, without the library, it fails too
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout

"""Contract tests for bench.py: the device line, the CPU shape check, the
refusal to measure without a GPU, and the helpers it drives on a tiny
CPU cohort."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, REPO)
    import bench as bench_mod
    return bench_mod


def _run(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "bench.py", *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_contract_only_prints_shapes_and_no_rate():
    res = _run("--contract-only")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("device platform=cpu kind=")
    out = json.loads(lines[-1])
    assert out["contract_only"] is True
    assert out["bmu_idx_shape"] == [4096]
    assert "value" not in out and "vs_baseline" not in out


def test_device_run_refuses_without_gpu():
    res = _run()
    assert res.returncode != 0
    assert "needs a GPU" in res.stderr
    assert '"value"' not in res.stdout


def test_bmu_rate_helper(bench):
    assert bench._bench_bmu(4096, 16, 100, reps=2) > 0


def test_segmentation_e2e_fields(bench):
    """The e2e helper returns its metric fields with a positive rate on a
    tiny CPU cohort (guards the bench against drift in the Mesmer/
    watershed surfaces it drives)."""
    out = bench._bench_segmentation_e2e(n_fovs=2, size=64)
    assert out["segmentation_e2e_fov_size"] == 64
    assert out["segmentation_e2e_fovs_per_s"] > 0

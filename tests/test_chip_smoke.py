"""chip_smoke.py and bench.py off the GPU: both refuse to run (non-zero
exit, no result line), and the smoke run's CLI phases and checks work at a
tiny size on the CPU (the GPU run uses the same code at config 4)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    proc = _run(ROOT, script)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"rows"' not in proc.stdout


def test_refuses_alone_outside_the_repo(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    it fails too."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_checks_reject_bad_trajectories():
    chip_smoke._check_monotone([-10.0, -5.0, -5.0, -1.0], "ok")
    for bad in ([-10.0, -12.0], [-1.0, float("nan")], []):
        with pytest.raises(AssertionError):
            chip_smoke._check_monotone(bad, "bad")
    assert chip_smoke.rel_err([1.0, 2.0], [1.0, 2.5]) == pytest.approx(0.2)


def test_cli_phases_at_tiny_size(tmp_path, monkeypatch):
    """GPLVM -T 5 + --load resume, SGPR and SVGP through the CLI with the
    smoke run's own checks (XLA engine here; memory stats are GPU-only)."""
    import jax

    monkeypatch.setattr(chip_smoke, "_peak", lambda dev: "n/a")
    dev = jax.devices()[0]
    chip_smoke.phase_gplvm_cli(dev, str(tmp_path), 240, 2, 8, 4, 0)
    chip_smoke.phase_sgpr_cli(dev, str(tmp_path), 240, 2, 8, 3, 0)
    chip_smoke.phase_svgp_cli(dev, str(tmp_path), 400, 2, 8, 2, 32, 60, 0)


def test_mesh_phase_needs_the_named_device_count(tmp_path):
    with pytest.raises(AssertionError, match="need 4 GPUs"):
        chip_smoke.phase_mesh(str(tmp_path), 4, 64, 2, 4, 3, 0)


def test_bench_shapes_and_peaks():
    assert bench._shapes(bench.DEFAULT_SHAPES) == [
        (1_000_000, 200), (100_000, 500), (10_000_000, 500)]
    peaks = bench.PEAKS["NVIDIA H100 80GB HBM3"]
    assert peaks["fp32_tflops"] == 67.0 and peaks["hbm_tb_per_s"] == 3.35
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.device_record()


def test_bench_problem_shapes():
    p, y = bench.gplvm_problem(32, 5, q=3, d=2)
    assert y.shape == (32, 2) and p.lat.mu.shape == (32, 3)
    assert p.glob.z.shape == (5, 3)
    assert json.dumps(np.asarray(p.glob.u_beta).tolist())

"""The port's example twins run on the CPU with ``--device cpu``, each in
about a minute or less."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args, threads="1", timeout=60):
    # one thread: the examples' products are small at these sizes, and the
    # suite runs beside other workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=threads)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_topology_analysis_twin_sweeps_on_the_cpu():
    out = _run("examples/topology_analysis_torch.py", "--sweep",
               "--ref-servers", "200", "--max-routers", "64", "--skip-bench",
               "--device", "cpu")
    assert out.returncode == 0, out.stderr
    for family in ("slimfly", "polarfly", "torus", "dragonfly"):
        assert family in out.stdout


def test_serve_demo_twin_serves_on_the_cpu():
    out = _run("examples/serve_demo_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "served 16 requests, 256 tokens" in out.stdout


def test_quickstart_twin_trains_a_step_on_the_cpu():
    out = _run("examples/quickstart_torch.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("generated: ") and "diameter: 2" in out.stdout
    assert any(l.startswith("one train step: {'loss': ") for l in lines)
    assert lines[-1] == "OK"


def test_train_100m_twin_quick_path_on_the_cpu(tmp_path):
    """The ~14M-parameter --quick path for 50 steps (the fewest at which
    the example's ``last < first - 0.5`` holds: its loss is read every 25
    steps, and at step 25 it has fallen by 0.44) and its checkpoint at step
    50."""
    out = _run("examples/train_100m_torch.py", "--quick", "--steps", "50",
               "--device", "cpu", "--ckpt", str(tmp_path / "ckpt"),
               threads="2", timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "model: 13.8M params (6L x 384d)"
    assert "step   50  nll" in out.stdout and out.stdout.endswith("OK\n")
    assert (tmp_path / "ckpt" / "step_00000050" / "manifest.json").exists()


def test_example_twins_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for example in ("serve_demo_torch.py", "quickstart_torch.py",
                    "train_100m_torch.py"):
        out = _run(f"examples/{example}")
        assert out.returncode != 0 and "no CUDA device" in out.stderr, example

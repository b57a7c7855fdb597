"""The port's example twins run on the CPU with ``--device cpu``, each in
well under a minute."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args):
    # one thread: the examples' products are small at these sizes, and the
    # suite runs beside other workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)


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


def test_example_twins_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run("examples/serve_demo_torch.py")
    assert out.returncode != 0 and "no CUDA device" in out.stderr

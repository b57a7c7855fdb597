"""The port stands alone: repro_torch and chip_smoke.py import neither JAX
nor the JAX package, and chip_smoke.py fails without a card or a checkout."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    """Absolute module names a file imports (relative imports excluded)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in _FORBIDDEN, f"{path.name} imports {mod}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_sweep_loads_neither_package():
    code = ("import sys, repro_torch.core.sweep, repro_torch.kernels.build, "
            "repro_torch.core.routing, repro_torch.core.traffic, "
            "repro_torch.core.workload, repro_torch.obs.report, "
            "repro_torch.core.collectives, "
            "repro_torch.core.analysis.mesh_ranks, repro_torch.configs, "
            "repro_torch.models, repro_torch.launch.serve, "
            "repro_torch.optim, repro_torch.data, repro_torch.runtime, "
            "repro_torch.checkpoint, repro_torch.launch.train, "
            "repro_torch.launch.dryrun, repro_torch.launch.hillclimb, "
            "repro_torch.kernels.autotune; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{_FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_tests_avoid_removed_jax_api():
    for path in sorted((ROOT / "tests").glob("test_torch_*.py")):
        tree = ast.parse(path.read_text())
        attrs = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        assert "ClosedJaxpr" not in attrs, path.name


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr

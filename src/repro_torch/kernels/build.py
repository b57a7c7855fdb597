"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each source compiles, at first use, into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which `ctypes`
loads. Libraries land in ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the source and the flags, so an edit to either
rebuilds and an unchanged tree reuses what is there. Nothing is compiled or
loaded when this module is imported.

The target is Hopper, ``sm_90a``. The flags leave out ``--use_fast_math``:
the kernels test ``isinf`` and must keep IEEE fp32 arithmetic.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List, Sequence

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "BuildResult", "find_nvcc",
           "nvcc_command", "build_all", "load"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: kernel library name -> its source under ``csrc/``
SOURCES: Dict[str, str] = {"semiring": "semiring.cu", "tropical": "tropical.cu",
                           "seghist": "seghist.cu", "packed": "packed.cu"}
#: ``<checkout>/build/repro_torch_kernels`` (src/repro_torch/kernels -> root)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    """One compiled library: where it is, how long ``nvcc`` took (0 when
    an existing build was reused) and what the compiler printed (register
    and shared-memory use per kernel, from ``-Xptxas -v``)."""

    name: str
    path: pathlib.Path
    seconds: float
    log: str


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc`` on
    the PATH; raises RuntimeError when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "build only where the CUDA toolkit is installed")
    return found


def nvcc_command(src: pathlib.Path, out: pathlib.Path,
                 nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


def _target(name: str) -> pathlib.Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, BuildResult]:
    """Compile every named source that has no current build, one ``nvcc``
    per source, all started together. Raises RuntimeError with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = []
    for name in names:
        out = _target(name)
        if out.exists():
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            nvcc_command(CSRC / SOURCES[name], tmp, find_nvcc()),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    try:
        for name, out, tmp, proc, t0 in running:
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCES[name]} "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            results[name] = BuildResult(name, out, seconds, log)
    finally:
        for *_, proc, _ in running:  # a failed build stops the others
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed (once per
    process)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build_all([name])[name].path))
    return _LOADED[name]

"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each source compiles, at first use, into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which `ctypes`
loads. Libraries land in ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the source, every header under ``csrc/``
(``*.cuh``: the sources include them) and the flags, so an edit to
any of them rebuilds and an unchanged tree reuses what is there. Nothing is
compiled or loaded when this module is imported.

Generated sources (the kernels of user semirings, `kernels.semiring`) go
the same way: `build_generated` writes each into the build directory and
compiles it against the headers in ``csrc/`` (``semiring_generic.cuh``,
``vpu_tiles.cuh``, ``counting_tiles.cuh``), named by a hash of the
generated text, the headers and the flags.

The target is Hopper, ``sm_90a``. The flags leave out ``--use_fast_math``:
the kernels test ``isinf`` and must keep IEEE fp32 arithmetic.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["SOURCES", "GENERIC_HEADER", "BUILD_DIR", "NVCC_FLAGS",
           "BuildResult", "find_nvcc", "nvcc_command", "build_all", "load",
           "generated_target", "build_generated", "load_generated",
           "kernel_usage"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: kernel library name -> its source under ``csrc/``
SOURCES: Dict[str, str] = {"semiring": "semiring.cu", "tropical": "tropical.cu",
                           "seghist": "seghist.cu", "packed": "packed.cu"}
#: the template header that generated sources include. It and the other
#: headers under ``csrc/`` (``counting_tiles.cuh``, the counting GEMM that
#: ``semiring.cu``, ``tropical.cu`` and the generated MXU-path sources
#: include; ``vpu_tiles.cuh``, the generated VPU-path sources' large tile)
#: are no library of their own: every ``*.cuh`` there is hashed into every
#: library's name
GENERIC_HEADER = "semiring_generic.cuh"
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
                 nvcc: str = "nvcc",
                 include: Optional[pathlib.Path] = None) -> List[str]:
    inc = [] if include is None else ["-I", str(include)]
    return [nvcc, *NVCC_FLAGS, *inc, "-o", str(out), str(src)]


def _digest(text: bytes) -> str:
    """A hash of ``text``, every header under ``csrc/`` and the flags."""
    h = hashlib.sha256(text)
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> pathlib.Path:
    src = CSRC / SOURCES[name]
    return BUILD_DIR / f"lib{name}_{_digest(src.read_bytes())}.so"


def generated_target(key: str, source: str) -> pathlib.Path:
    """Where the library of the generated ``source`` goes: named by ``key``
    and a hash of the text, the headers and the flags."""
    return BUILD_DIR / f"lib{key}_{_digest(source.encode())}.so"


def _compile(jobs) -> Dict[str, BuildResult]:
    """Build every ``(name, source path, library path, include dir)`` job
    whose library is missing, one ``nvcc`` per job, all started together.
    Raises RuntimeError with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = []
    for name, src, out, include in jobs:
        if out.exists():
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            nvcc_command(src, tmp, find_nvcc(), include),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, src, out, tmp, proc, time.perf_counter()))
    try:
        for name, src, out, tmp, proc, t0 in running:
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            results[name] = BuildResult(name, out, seconds, log)
    finally:
        for *_, proc, _ in running:  # a failed build stops the others
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def build_all(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, BuildResult]:
    """Compile every named source under ``csrc/`` that has no current
    build, all in parallel; raises RuntimeError on a failed build."""
    return _compile([(name, CSRC / SOURCES[name], _target(name), None)
                     for name in names])


def build_generated(sources: Dict[str, str]) -> Dict[str, BuildResult]:
    """Compile generated sources, ``key -> CUDA text``, that have no current
    build, all in parallel, each against ``csrc/`` (for its headers);
    raises RuntimeError on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for key, text in sources.items():
        out = generated_target(key, text)
        src = out.with_suffix(".cu")
        if not out.exists():
            tmp = src.with_suffix(f".{os.getpid()}.cu.tmp")
            tmp.write_text(text)
            os.replace(tmp, src)
        jobs.append((key, src, out, CSRC))
    return _compile(jobs)


def kernel_usage(log: str) -> List[Dict[str, object]]:
    """Per kernel of an ``nvcc -Xptxas -v`` log (a :class:`BuildResult`'s
    ``log``): its mangled ``name``, ``registers`` per thread, ``spill_stores``
    and ``spill_loads`` in bytes and static ``smem`` in bytes, in the
    order ptxas reports them."""
    out: List[Dict[str, object]] = []
    name, spills = "", (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$.]+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(dict(name=name, registers=int(m.group(1)),
                            spill_stores=spills[0], spill_loads=spills[1],
                            smem=int(smem.group(1)) if smem else 0))
            spills = (0, 0)
    return out


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed (once per
    process)."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build_all([name])[name].path))
    return _LOADED[name]


def load_generated(key: str, source: str) -> ctypes.CDLL:
    """The loaded library of the generated ``source``, built first if
    needed (once per process and text)."""
    path = generated_target(key, source)
    if path.name not in _LOADED:
        built = build_generated({key: source})[key].path
        _LOADED[path.name] = ctypes.CDLL(str(built))
    return _LOADED[path.name]

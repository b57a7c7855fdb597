"""The counting-semiring kernels of the sweep: wrappers and plain versions.

Two hand-written CUDA kernels (``csrc/semiring.cu``) carry the equal-cost
sweep's device path:

* :func:`frontier_step` — ``where((F@A > 0) & (D == +inf), F@A, 0)``, the
  fused BFS level step (replaces ``repro/kernels/semiring.py``
  ``frontier_step_batched_pallas`` and its 2D twin ``frontier_step_pallas``);
* :func:`count_matmul` — the plain fp32 counting product ``A@B`` (replaces
  ``semiring_matmul_batched_pallas`` / ``semiring_matmul_pallas`` with
  ``COUNTING``). ``A`` is read through its strides, so a transposed view
  costs no copy.

Both take 2D operands or stacks with a leading batch axis, any M, N, K, and
fp32 only. A wrapper launches its kernel on a CUDA tensor (or raises), and
runs the plain version beside it only for tensors on the CPU or when the
caller passes ``use_kernel=False``. :data:`launches` counts kernel launches
per wrapper.

The plain versions keep the names of their ``repro/kernels/ref.py``
counterparts. They run ``torch.matmul`` in IEEE fp32: on the card that
requires TF32 to be off, and they raise if it is not.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

__all__ = ["frontier_step", "count_matmul", "frontier_step_ref",
           "count_matmul_ref", "batched_count_matmul_ref", "launches",
           "reset_launches"]

#: kernel launches per wrapper since the last :func:`reset_launches`
launches: Dict[str, int] = {"frontier_step": 0, "count_matmul": 0}

_MAX_BATCH = 65535  # gridDim.z
_MAX_ROWS = 65535 * 128  # gridDim.y times the 128-row tile


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# -- plain versions -------------------------------------------------------------

def _ieee_fp32(*xs: torch.Tensor) -> None:
    if any(x.is_cuda for x in xs) and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("TF32 matmul is enabled: counts must be exact "
                           "below 2**24, set torch.backends.cuda.matmul."
                           "allow_tf32 = False")


def frontier_step_ref(f: torch.Tensor, a: torch.Tensor,
                      d: torch.Tensor) -> torch.Tensor:
    """Fused wavefront step: the counting product masked to pairs that are
    newly reached (positive count, dist still +inf). 2D or batched."""
    _ieee_fp32(f, a)
    x = torch.matmul(f.float(), a.float())
    return torch.where((x > 0) & (d == float("inf")), x, 0.0)


def count_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Counting semiring (+, x) product — the plain matmul over f32 counts."""
    _ieee_fp32(a, b)
    return a.float() @ b.float()


def batched_count_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stacked counting product — plain batched matmul over f32 counts."""
    _ieee_fp32(a, b)
    return torch.einsum("bik,bkj->bij", a.float(), b.float())


# -- the kernels -----------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("semiring")
        lib.repro_frontier_step_f32.argtypes = [_P, _P, _P, _P, _I, _I, _I,
                                                _I, _P]
        lib.repro_frontier_step_f32.restype = _I
        lib.repro_count_matmul_f32.argtypes = [_P, _L, _L, _L, _P, _P, _I,
                                               _I, _I, _I, _P]
        lib.repro_count_matmul_f32.restype = _I
        _LIB = lib
    return _LIB


def _use_kernel(use_kernel: bool, *xs: torch.Tensor) -> bool:
    """Kernel for CUDA tensors, plain version for CPU tensors or on request;
    anything else (mixed devices, other backends) raises."""
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"operands on different devices: "
                         f"{[str(x.device) for x in xs]}")
    if not use_kernel or dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if dev.index not in (None, 0):
        # the library's own CUDA runtime launches on its current device, 0
        raise ValueError(f"kernels launch on cuda:0 only, got {dev}")
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"kernel takes float32, got {x.dtype}")
    return True


def _dims(a: torch.Tensor, b: torch.Tensor):
    """(batch, m, n, k) of a 2D or stacked product; raises on a mismatch."""
    if a.ndim != b.ndim or a.ndim not in (2, 3):
        raise ValueError(f"operands must both be 2D or 3D: {tuple(a.shape)} "
                         f"x {tuple(b.shape)}")
    batch = a.shape[0] if a.ndim == 3 else 1
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2 or (a.ndim == 3 and b.shape[0] != batch):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if batch > _MAX_BATCH or m > _MAX_ROWS:
        raise ValueError(f"batch {batch} or rows {m} exceed the launch grid")
    return batch, m, n, k


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def frontier_step(f: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                  use_kernel: bool = True) -> torch.Tensor:
    """One fused wavefront step: ``where((F@A > 0) & (D == inf), F@A, 0)``.

    ``f`` is the (.., M, K) level-k multiplicity frontier, ``a`` the
    (.., K, N) adjacency, ``d`` the (.., M, N) running distances (+inf =
    unreached); all fp32 and contiguous on the card. Returns the newly
    reached pairs with their shortest-path multiplicities.
    """
    if not _use_kernel(use_kernel, f, a, d):
        return frontier_step_ref(f, a, d)
    batch, m, n, k = _dims(f, a)
    if tuple(d.shape) != (*f.shape[:-1], n):
        raise ValueError(f"dist shape {tuple(d.shape)} does not match the "
                         f"product {tuple(f.shape[:-1]) + (n,)}")
    for name, x in (("f", f), ("a", a), ("d", d)):
        if not x.is_contiguous():
            raise ValueError(f"frontier_step needs a contiguous {name}")
    x = torch.empty(d.shape, dtype=torch.float32, device=d.device)
    if x.numel() == 0:
        return x
    _check(_lib().repro_frontier_step_f32(
        f.data_ptr(), a.data_ptr(), d.data_ptr(), x.data_ptr(), batch, m, n,
        k, torch.cuda.current_stream(d.device).cuda_stream), "frontier_step")
    launches["frontier_step"] += 1
    return x


def count_matmul(a: torch.Tensor, b: torch.Tensor,
                 use_kernel: bool = True) -> torch.Tensor:
    """Counting product ``A@B`` of fp32 counts, 2D or batched.

    ``a`` may be any strided view (a transposed stack needs no copy); ``b``
    must be contiguous. For another output dtype, cast the result.
    """
    if not _use_kernel(use_kernel, a, b):
        return (batched_count_matmul_ref(a, b) if a.ndim == 3
                else count_matmul_ref(a, b))
    batch, m, n, k = _dims(a, b)
    if not b.is_contiguous():
        raise ValueError("count_matmul needs a contiguous b")
    sb = a.stride(0) if a.ndim == 3 else 0
    c = torch.empty((*a.shape[:-1], n), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    _check(_lib().repro_count_matmul_f32(
        a.data_ptr(), sb, a.stride(-2), a.stride(-1), b.data_ptr(),
        c.data_ptr(), batch, m, n, k,
        torch.cuda.current_stream(a.device).cuda_stream), "count_matmul")
    launches["count_matmul"] += 1
    return c

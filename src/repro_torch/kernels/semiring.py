"""The semiring kernels of the analysis stack: wrappers and plain versions.

Hand-written CUDA kernels carry the device path:

* :func:`frontier_step` (``csrc/semiring.cu``) —
  ``where((F@A > 0) & (D == +inf), F@A, 0)``, the fused BFS level step
  (replaces ``repro/kernels/semiring.py`` ``frontier_step_batched_pallas``
  and its 2D twin ``frontier_step_pallas``);
* :func:`count_matmul` (``csrc/semiring.cu``) — the plain fp32 counting
  product ``A@B`` (replaces ``semiring_matmul_batched_pallas`` /
  ``semiring_matmul_pallas`` with ``COUNTING``). ``A`` is read through its
  strides, so a transposed view costs no copy. An int32 ``A`` with a uint8
  ``B`` goes to the narrow kernel (``csrc/packed.cu``), the streamed
  pump's panel product (``semiring_matmul_pallas`` with a uint32 left and
  uint8 right operand and ``out_dtype=f32``);
* :func:`frontier_step_packed` (``csrc/packed.cu``) — the fused BFS step
  over narrow cells: int32 frontier, uint8 adjacency, int16 distances with
  the :data:`DIST_UNREACHED` sentinel, counts clamped at :data:`MULT_SAT`
  (replaces ``frontier_step_packed_pallas`` and
  ``frontier_step_packed_batched_pallas``);
* :func:`minplus_matmul` (``csrc/tropical.cu``) — the tropical product
  ``min_k a[i,k] + b[k,j]`` (replaces ``minplus_matmul_pallas``, the
  ``TROPICAL`` instantiation of ``semiring_matmul_pallas``), optionally
  with a fused "changed" flag for the squaring loop's convergence test;
* :func:`minplus_count_matmul` (``csrc/tropical.cu``) — the two-field
  (dist, count) product with counts summed over tying k (replaces
  ``semiring_matmul_pallas`` with ``TROPICAL_COUNT``).

The counting kernels take 2D operands or stacks with a leading batch axis;
the tropical ones take 2D operands. All take any M, N, K; the fp32 ones
take fp32 only, the narrow ones the dtypes above. A
wrapper launches its kernel on a CUDA tensor (or raises), and runs the
plain version beside it only for tensors on the CPU or when the caller
passes ``use_kernel=False``. :data:`launches` counts kernel launches per
wrapper, for these and for ``kernels.seghist.value_histogram``.

**Packed cells.** The extreme-scale engines keep distances in int16
(:data:`DIST_UNREACHED` plays +inf) and multiplicities in a counter that
saturates at :data:`MULT_SAT` = 2**24, the fp32 exact-integer ceiling: a
count that reaches it is clamped there, never wrapped. The JAX package
stores the counter as uint32; torch computes nothing on ``torch.uint32``,
so the device cell here is int32 (:data:`MULT_DTYPE`), which holds every
value the uint32 cell can hold, and the host boundary returns
:data:`HOST_MULT_DTYPE` (uint32) arrays, as the JAX package does.

The plain versions keep the names of their ``repro/kernels/ref.py``
counterparts. The counting ones run ``torch.matmul`` in IEEE fp32: on the
card that requires TF32 to be off, and they raise if it is not. The
tropical ones evaluate the (rows, k, n) broadcast a block of rows at a
time, so their working memory stays bounded.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["frontier_step", "count_matmul", "minplus_matmul",
           "minplus_count_matmul", "frontier_step_packed",
           "frontier_step_ref", "count_matmul_ref",
           "batched_count_matmul_ref", "minplus_matmul_ref",
           "minplus_count_matmul_ref", "frontier_step_packed_ref",
           "DIST_DTYPE", "MULT_DTYPE", "HOST_MULT_DTYPE", "DIST_UNREACHED",
           "MULT_SAT", "pack_dist", "unpack_dist", "launches",
           "reset_launches"]

#: kernel launches per wrapper since the last :func:`reset_launches`; the
#: packed step counts its 2D and batched launches apart, as the JAX package
#: has two kernels for them
launches: Dict[str, int] = {"frontier_step": 0, "count_matmul": 0,
                            "minplus_matmul": 0, "minplus_count_matmul": 0,
                            "value_histogram": 0, "frontier_step_packed": 0,
                            "frontier_step_packed_batched": 0,
                            "count_matmul_narrow": 0}

#: packed distance cell; DIST_UNREACHED (int16 max) plays the role of +inf
DIST_DTYPE = torch.int16
#: packed multiplicity cell on the device (see the module docstring)
MULT_DTYPE = torch.int32
#: packed multiplicities as the host entry points return them
HOST_MULT_DTYPE = np.uint32
#: sentinel for "not yet reached" in packed distance cells
DIST_UNREACHED = 32767
#: saturation point for packed counts: the f32 exact-integer ceiling
MULT_SAT = 2 ** 24

_MAX_BATCH = 65535  # gridDim.z
_MAX_ROWS = 65535 * 128  # gridDim.y times the 128-row tile
_MAX_TROPICAL_ROWS = 65535 * 32  # gridDim.y times the 32-row tropical tile
_MAX_NARROW_ROWS = 65535 * 32  # gridDim.y times the 32-row narrow tile
#: elements of one (rows, k, n) broadcast block in the tropical plain versions
_BROADCAST_BLOCK = 1 << 24


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def pack_dist(d: torch.Tensor) -> torch.Tensor:
    """fp32 distances (+inf = unreached) -> int16 (DIST_UNREACHED sentinel)."""
    return torch.where(torch.isfinite(d), d,
                       float(DIST_UNREACHED)).to(DIST_DTYPE)


def unpack_dist(d: torch.Tensor) -> torch.Tensor:
    """int16 packed distances -> fp32 with +inf for unreached."""
    return torch.where(d == DIST_UNREACHED, float("inf"), d.float())


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


def frontier_step_packed_ref(f: torch.Tensor, a: torch.Tensor,
                             d: torch.Tensor) -> torch.Tensor:
    """Packed wavefront step over narrow cells: the fp32 counting product,
    masked to pairs newly reached (positive count, dist DIST_UNREACHED),
    clamped at MULT_SAT — saturate, never wrap — and returned as int32.
    2D or batched."""
    _ieee_fp32(f, a)
    x = torch.matmul(f.float(), a.float())
    new = (x > 0) & (d == DIST_UNREACHED)
    return torch.where(new, x.clamp(max=float(MULT_SAT)),
                       0.0).to(MULT_DTYPE)


def count_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Counting semiring (+, x) product — the plain matmul over f32 counts."""
    _ieee_fp32(a, b)
    return a.float() @ b.float()


def batched_count_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stacked counting product — plain batched matmul over f32 counts."""
    _ieee_fp32(a, b)
    return torch.einsum("bik,bkj->bij", a.float(), b.float())


def _row_blocks(m: int, k: int, n: int, fields: int = 1):
    """Row ranges of a (rows, k, n) broadcast within the element budget."""
    rows = max(1, _BROADCAST_BLOCK // max(1, fields * k * n))
    return ((lo, min(m, lo + rows)) for lo in range(0, m, rows))


def minplus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical (min, +) matrix product: out[i,j] = min_k a[i,k] + b[k,j].
    An empty k gives +inf, the semiring's zero."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.full((m, n), float("inf"), dtype=torch.float32,
                     device=a.device)
    if k == 0:
        return out
    a, b = a.float(), b.float()
    for lo, hi in _row_blocks(m, k, n):
        out[lo:hi] = (a[lo:hi, :, None] + b[None]).amin(dim=1)
    return out


def minplus_count_matmul_ref(da: torch.Tensor, ca: torch.Tensor,
                             db: torch.Tensor, cb: torch.Tensor):
    """Fused tropical-with-count product over (dist, count) pairs.

    out_d[i,j] = min_k da[i,k] + db[k,j];
    out_c[i,j] = sum over minimizing k of ca[i,k] * cb[k,j].
    Unreachable entries (dist inf) must carry count 0 so inf==inf ties
    contribute nothing.
    """
    m, k = da.shape
    n = db.shape[1]
    d = torch.full((m, n), float("inf"), dtype=torch.float32,
                   device=da.device)
    c = torch.zeros((m, n), dtype=torch.float32, device=da.device)
    if k == 0:
        return d, c
    da, ca, db, cb = (x.float() for x in (da, ca, db, cb))
    for lo, hi in _row_blocks(m, k, n, fields=3):
        s = da[lo:hi, :, None] + db[None]
        d[lo:hi] = s.amin(dim=1)
        prod = ca[lo:hi, :, None] * cb[None]
        c[lo:hi] = torch.where(s == d[lo:hi, None, :], prod, 0.0).sum(dim=1)
    return d, c


# -- the kernels -----------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = None
_TROPICAL_LIB = None
_PACKED_LIB = None


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


def _tropical_lib() -> ctypes.CDLL:
    global _TROPICAL_LIB
    if _TROPICAL_LIB is None:
        from .build import load

        lib = load("tropical")
        lib.repro_minplus_f32.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.repro_minplus_f32.restype = _I
        lib.repro_minplus_count_f32.argtypes = [_P, _P, _P, _P, _P, _P, _I,
                                                _I, _I, _P]
        lib.repro_minplus_count_f32.restype = _I
        _TROPICAL_LIB = lib
    return _TROPICAL_LIB


def _packed_lib() -> ctypes.CDLL:
    global _PACKED_LIB
    if _PACKED_LIB is None:
        from .build import load

        lib = load("packed")
        lib.repro_frontier_step_packed.argtypes = [_P, _P, _P, _P, _I, _I,
                                                   _I, _I, _P]
        lib.repro_frontier_step_packed.restype = _I
        lib.repro_count_matmul_narrow.argtypes = [_P, _L, _L, _L, _P, _P, _I,
                                                  _I, _I, _I, _P]
        lib.repro_count_matmul_narrow.restype = _I
        _PACKED_LIB = lib
    return _PACKED_LIB


def _use_kernel(use_kernel: bool, *xs: torch.Tensor,
                dtypes: Optional[Sequence[torch.dtype]] = None) -> bool:
    """Kernel for CUDA tensors, plain version for CPU tensors or on request;
    anything else (mixed devices, other backends) raises. The kernel takes
    ``dtypes`` (one per operand; fp32 for all by default)."""
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
    for x, want in zip(xs, dtypes or (torch.float32,) * len(xs)):
        if x.dtype != want:
            raise TypeError(f"kernel takes {want}, got {x.dtype}")
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
    _contiguous("frontier_step", f=f, a=a, d=d)
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
    """Counting product ``A@B``, 2D or batched, as fp32.

    fp32 operands run the fp32 kernel; an int32 ``a`` with a uint8 ``b``
    (a packed frontier slab against an adjacency panel) runs the narrow
    kernel, exact while ``a``'s values stay at or below 2**24. ``a`` may be
    any strided view (a transposed stack or a column slab needs no copy);
    ``b`` must be contiguous. For another output dtype, cast the result.
    """
    narrow = a.dtype == torch.int32 and b.dtype == torch.uint8
    dtypes = (torch.int32, torch.uint8) if narrow else None
    if not _use_kernel(use_kernel, a, b, dtypes=dtypes):
        return (batched_count_matmul_ref(a, b) if a.ndim == 3
                else count_matmul_ref(a, b))
    batch, m, n, k = _dims(a, b)
    if narrow and m > _MAX_NARROW_ROWS:
        raise ValueError(f"rows {m} exceed the launch grid")
    _contiguous("count_matmul", b=b)
    sb = a.stride(0) if a.ndim == 3 else 0
    c = torch.empty((*a.shape[:-1], n), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    name = "count_matmul_narrow" if narrow else "count_matmul"
    launch = (_packed_lib().repro_count_matmul_narrow if narrow
              else _lib().repro_count_matmul_f32)
    _check(launch(a.data_ptr(), sb, a.stride(-2), a.stride(-1), b.data_ptr(),
                  c.data_ptr(), batch, m, n, k,
                  torch.cuda.current_stream(a.device).cuda_stream), name)
    launches[name] += 1
    return c


def frontier_step_packed(f: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                         use_kernel: bool = True) -> torch.Tensor:
    """One fused wavefront step over packed cells.

    ``f`` is the (.., M, K) int32 multiplicity frontier (values at most
    MULT_SAT), ``a`` the (.., K, N) uint8 {0,1} adjacency, ``d`` the (.., M,
    N) int16 running distances (DIST_UNREACHED = unreached); all contiguous
    on the card. Returns the int32 next frontier: the newly reached pairs
    with their counts clamped at MULT_SAT (a cell equal to MULT_SAT is a
    lower bound). Below MULT_SAT it equals :func:`frontier_step` as
    integers.
    """
    if not _use_kernel(use_kernel, f, a, d,
                       dtypes=(torch.int32, torch.uint8, DIST_DTYPE)):
        return frontier_step_packed_ref(f, a, d)
    batch, m, n, k = _dims(f, a)
    if m > _MAX_NARROW_ROWS:
        raise ValueError(f"rows {m} exceed the launch grid")
    if tuple(d.shape) != (*f.shape[:-1], n):
        raise ValueError(f"dist shape {tuple(d.shape)} does not match the "
                         f"product {tuple(f.shape[:-1]) + (n,)}")
    _contiguous("frontier_step_packed", f=f, a=a, d=d)
    x = torch.empty(d.shape, dtype=MULT_DTYPE, device=d.device)
    if x.numel() == 0:
        return x
    _check(_packed_lib().repro_frontier_step_packed(
        f.data_ptr(), a.data_ptr(), d.data_ptr(), x.data_ptr(), batch, m, n,
        k, torch.cuda.current_stream(d.device).cuda_stream),
        "frontier_step_packed")
    launches["frontier_step_packed_batched" if f.ndim == 3
             else "frontier_step_packed"] += 1
    return x


def _dims_2d(a: torch.Tensor, b: torch.Tensor):
    """(m, n, k) of a 2D tropical product; raises on a mismatch."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tropical operands must be (m, k) x (k, n): "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if m > _MAX_TROPICAL_ROWS:
        raise ValueError(f"rows {m} exceed the launch grid")
    return m, n, k


def _contiguous(what: str, **xs: torch.Tensor) -> None:
    for name, x in xs.items():
        if not x.is_contiguous():
            raise ValueError(f"{what} needs a contiguous {name}")


def minplus_matmul(a: torch.Tensor, b: torch.Tensor, use_kernel: bool = True,
                   compare: Optional[torch.Tensor] = None):
    """Tropical product ``min_k a[i,k] + b[k,j]`` of fp32 (m, k) x (k, n).

    Pads (ragged edges) behave as +inf. With ``compare``, an (m, n) tensor,
    returns ``(out, changed)``: ``changed`` is a one-element int32 tensor on
    the operands' device, nonzero iff ``out`` differs from ``compare``
    anywhere. The kernel computes it in its store, so the squaring loop's
    convergence test costs no extra pass over the matrix.
    """
    xs = (a, b) if compare is None else (a, b, compare)
    if not _use_kernel(use_kernel, *xs):
        out = minplus_matmul_ref(a, b)
        if compare is None:
            return out
        return out, (out != compare).any().reshape(1).to(torch.int32)
    m, n, k = _dims_2d(a, b)
    _contiguous("minplus_matmul", a=a, b=b)
    if compare is not None:
        _contiguous("minplus_matmul", compare=compare)
        if tuple(compare.shape) != (m, n):
            raise ValueError(f"compare shape {tuple(compare.shape)} is not "
                             f"the product's {(m, n)}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    changed = (torch.zeros(1, dtype=torch.int32, device=a.device)
               if compare is not None else None)
    if out.numel():
        _check(_tropical_lib().repro_minplus_f32(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if compare is None else compare.data_ptr(),
            None if changed is None else changed.data_ptr(), m, n, k,
            torch.cuda.current_stream(a.device).cuda_stream),
            "minplus_matmul")
        launches["minplus_matmul"] += 1
    return out if compare is None else (out, changed)


def minplus_count_matmul(da: torch.Tensor, ca: torch.Tensor,
                         db: torch.Tensor, cb: torch.Tensor,
                         use_kernel: bool = True):
    """Lexicographic min-plus over (dist, count) pairs, fp32 (m, k) x (k, n).

    Returns ``(d, c)``: ``d`` the min-plus product of the dists, ``c`` the
    sum of ``ca[i,k] * cb[k,j]`` over the k that attain ``d[i,j]``. Pads
    behave as (+inf, 0), which never contributes. Counts are exact below
    2**24.
    """
    if not _use_kernel(use_kernel, da, ca, db, cb):
        return minplus_count_matmul_ref(da, ca, db, cb)
    m, n, k = _dims_2d(da, db)
    if ca.shape != da.shape or cb.shape != db.shape:
        raise ValueError("count fields must match their dist fields")
    _contiguous("minplus_count_matmul", da=da, ca=ca, db=db, cb=cb)
    d = torch.empty((m, n), dtype=torch.float32, device=da.device)
    c = torch.empty((m, n), dtype=torch.float32, device=da.device)
    if d.numel():
        _check(_tropical_lib().repro_minplus_count_f32(
            da.data_ptr(), ca.data_ptr(), db.data_ptr(), cb.data_ptr(),
            d.data_ptr(), c.data_ptr(), m, n, k,
            torch.cuda.current_stream(da.device).cuda_stream),
            "minplus_count_matmul")
        launches["minplus_count_matmul"] += 1
    return d, c

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
* :func:`reachability_step` (``csrc/semiring.cu``) — the boolean-semiring
  product ``(A@B > 0.5)`` of {0,1} fp32 masks, the same tile as
  :func:`count_matmul` with a threshold epilogue (replaces
  ``semiring_matmul_pallas`` with ``BOOLEAN``, i.e. ``reachability.py``
  ``reachability_step_pallas``);
* :func:`frontier_step_packed` (``csrc/packed.cu``) — the fused BFS step
  over narrow cells: int32 frontier, uint8 adjacency, int16 distances with
  the :data:`DIST_UNREACHED` sentinel, counts clamped at :data:`MULT_SAT`
  (replaces ``frontier_step_packed_pallas`` and
  ``frontier_step_packed_batched_pallas``). It and the narrow
  :func:`count_matmul` share one int8 tensor-core GEMM: the frontier is
  split into four u8 limbs (:func:`_u8_limbs`), the limb products are
  summed exactly in int32 and folded into a total every 32,256 k
  (:func:`_limbed_u8_matmul_ref` is its CPU emulation);
* :func:`minplus_matmul` (``csrc/tropical.cu``) — the tropical product
  ``min_k a[i,k] + b[k,j]`` (replaces ``minplus_matmul_pallas``, the
  ``TROPICAL`` instantiation of ``semiring_matmul_pallas``), optionally
  with a fused "changed" flag for the squaring loop's convergence test;
* :func:`batched_minplus_matmul` (``csrc/tropical.cu``) — the same
  tropical product over a stack, (B, M, K) x (B, K, N), with the
  "changed" flag taken over the whole stack (replaces
  ``semiring_matmul_batched_pallas`` with ``TROPICAL``);
* :func:`minplus_count_matmul` (``csrc/tropical.cu``) — the two-field
  (dist, count) product with counts summed over tying k (replaces
  ``semiring_matmul_pallas`` with ``TROPICAL_COUNT``);
* :func:`semiring_matmul` and :func:`semiring_matmul_batched` — the
  extension point: the product over any :class:`Semiring` (replaces
  ``semiring_matmul_pallas`` / ``semiring_matmul_batched_pallas`` run with
  a user's algebra). A spec carries its algebra twice: as torch callables,
  which the plain versions run, and as C++ device code, from which a CUDA
  kernel is generated and built with ``nvcc`` at its first launch, one
  library per algebra and dtypes: a VPU-path algebra over two tiles (see
  below), an MXU-path one over ``count_matmul``'s GEMM
  (``csrc/counting_tiles.cuh``) with its epilogue at the store. The four
  shipped specs :data:`TROPICAL`, :data:`BOOLEAN`, :data:`COUNTING` and
  :data:`TROPICAL_COUNT` carry device code too.

**The counting tiles.** :func:`frontier_step`, :func:`count_matmul` (fp32),
:func:`reachability_step` and the generic MXU path of
:func:`semiring_matmul` share one GEMM on two tiles,
``csrc/counting_tiles.cuh``, each with its own store policy, so the
generic kernel on :data:`COUNTING` is :func:`count_matmul` bit for bit.
Each call converts ``B`` to a bf16 scratch copy and, on the card, sets a
flag if any value of ``B`` is not finite or not exact in bf16
(:func:`_takes_simt_tile`). With the flag, the fp32
SIMT tile runs: a pipelined fp32 FMA tile, one ``fmaf`` per k in order
from 0. Without it, the tensor-core tile runs: ``A`` split into
three bf16 limbs (:func:`_split_bf16_limbs`), three exact bf16 products
per k step, summed in fp32 (:func:`_limbed_matmul_ref` on the CPU): on a
{0,1} adjacency it is bit-equal to the SIMT tile wherever the partial
sums are integers below 2**24. The choice costs no host sync; each tile
counts its launches on the card (:func:`tile_launches`). ``A``'s layout
(row-major, column-major, any strides) picks the loader
(:func:`_a_layout`).

**The min-plus tiles.** :func:`minplus_matmul`,
:func:`batched_minplus_matmul` and :func:`minplus_count_matmul` run on two
tiles of ``csrc/tropical.cu``, picked on the host from the grid and K
alone (:func:`_minplus_plan`): a register-blocked 128 x 128 tile with a
pipelined ``cp.async`` ring for plain min-plus grids of at least 256 such
blocks (the sweep's stacks), and the split tile everywhere else (the MWU
oracle's p = 384..512 products, the count product at every size): the
same register-blocked, pipelined design on a smaller block tile, whose K
range is split over the blocks of a thread-block cluster where the grid
is small, the partials combined through distributed shared memory in one
launch. Min is exact in any order and the split fold keeps the order of
its operands, so every tile and split agrees bit for bit on the min-plus;
the count sums are regrouped (:func:`_split_k_minplus_count_ref`), exact
below 2**24. :func:`tile_launches` counts each tile and split.

**The VPU tiles.** A VPU-path algebra's kernel runs on one of two tiles,
picked on the host from the output grid and the algebra's field count
(:func:`_vpu_tile`): the register-blocked tile of
``csrc/vpu_tiles.cuh``, the large min-plus tile's design made generic and
sized by the field count (:func:`_vpu_config`), for grids of at least 256
of its blocks, and the 32 x 32 tile of ``csrc/semiring_generic.cuh``
elsewhere and for algebras of more than 12 fields. Both fold ``accumulate`` over k in order, so they agree bit for
bit on every algebra; :func:`tile_launches` counts each under
``semiring_matmul_vpu``.

**NaN.** The min-plus kernels, their plain versions and the shipped
``TROPICAL`` / ``TROPICAL_COUNT`` device code propagate NaN as the JAX
package's ``jnp.min``/``jnp.minimum`` do: a NaN sum anywhere along k
makes the distance NaN, and its tropical count 0.

The JAX package's ``reachability.py`` and ``minplus.py`` are thin
instantiations of its generic kernel; their counterparts here are
:func:`reachability_step` and :func:`minplus_matmul` in this module, and
the library surface over all of them is ``kernels.ops``.

The counting and boolean kernels take 2D operands or stacks with a leading
batch axis; the 2D tropical ones take 2D operands. All take any M, N, K;
the fp32 ones take fp32 only, the narrow ones the dtypes above. A
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
import dataclasses
import functools
import math
import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["frontier_step", "count_matmul", "reachability_step",
           "minplus_matmul", "batched_minplus_matmul",
           "minplus_count_matmul", "frontier_step_packed",
           "frontier_step_ref", "count_matmul_ref",
           "batched_count_matmul_ref", "reachability_step_ref",
           "minplus_matmul_ref", "batched_minplus_matmul_ref",
           "minplus_count_matmul_ref", "frontier_step_packed_ref",
           "tile_launches",
           "DIST_DTYPE", "MULT_DTYPE", "HOST_MULT_DTYPE", "DIST_UNREACHED",
           "MULT_SAT", "pack_dist", "unpack_dist", "launches",
           "reset_launches", "Semiring", "TROPICAL", "BOOLEAN", "COUNTING",
           "TROPICAL_COUNT", "semiring_matmul", "semiring_matmul_batched",
           "semiring_matmul_ref", "semiring_matmul_batched_ref",
           "device_types", "build_key", "algebra_source", "semiring_source"]

#: kernel launches per wrapper since the last :func:`reset_launches`; the
#: packed step counts its 2D and batched launches apart, as the JAX package
#: has two kernels for them; ``semiring_matmul`` counts the generated
#: kernels of every algebra, 2D and batched
launches: Dict[str, int] = {"frontier_step": 0, "count_matmul": 0,
                            "minplus_matmul": 0, "minplus_count_matmul": 0,
                            "value_histogram": 0, "frontier_step_packed": 0,
                            "frontier_step_packed_batched": 0,
                            "count_matmul_narrow": 0, "reachability_step": 0,
                            "batched_minplus_matmul": 0,
                            "semiring_matmul": 0}

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
_MAX_TROPICAL_ROWS = 65535 * 32  # gridDim.y times 32, at most the row tile
_MAX_NARROW_ROWS = 65535 * 32  # gridDim.y times the 32-row narrow tile
#: ``csrc/packed.cu``'s row tile and k stage: the limb scratch's padding
_NARROW_BM, _NARROW_BK = 32, 64
#: k between two folds of ``csrc/packed.cu``'s limb sums (504 stages of 64):
#: 255 * 255 * 32,256 plus a carry of 2**24 stays below 2**31
_FOLD_K = 32_256
#: elements of one (rows, k, n) broadcast block in the tropical plain versions
_BROADCAST_BLOCK = 1 << 24


def reset_launches() -> None:
    """Zero :data:`launches` and the counting tiles' device counters
    (:func:`tile_launches`)."""
    for name in launches:
        launches[name] = 0
    if _TILE_COUNTS is not None:
        _TILE_COUNTS.zero_()


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


def reachability_step_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean semiring product: out[i,j] = OR_k (a[i,k] AND b[k,j]).

    Inputs/outputs are {0,1}-valued float32 masks, 2D or batched.
    """
    _ieee_fp32(a, b)
    counts = torch.matmul(a.float(), b.float())
    return (counts > 0.5).float()


#: clears an fp32's low 16 bits: what is left is exact in bf16
_BF16_MASK = -(1 << 16)  # 0xffff0000 as an int32


def _split_bf16_limbs(x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three bf16 limbs ``(hi, mid, lo)`` of fp32 ``x``, as fp32
    tensors, as ``csrc/semiring.cu``'s tensor-core tile forms them in
    registers: ``hi`` is ``x`` with its low 16 bits cleared (bf16 rounded
    toward zero), ``mid`` the same of ``x - hi``, ``lo = x - hi - mid``;
    a zero limb carries ``x``'s sign. ``hi + mid + lo == x`` bit for bit
    for every finite ``x``, and each limb is exact in bf16 where ``|x| >=
    2**-110``, zero included (below that ``lo`` can hold bits under
    bf16's smallest subnormal, 2**-133, which the card's bf16 copy drops).
    A non-finite ``x`` splits as ``(x, 0, 0)``, NaN as the canonical NaN.
    """
    x = x.float()
    hi = (x.view(torch.int32) & _BF16_MASK).view(torch.float32)
    r = x - hi
    mid = (r.view(torch.int32) & _BF16_MASK).view(torch.float32)
    lo = r - mid
    sign = x.view(torch.int32) & torch.iinfo(torch.int32).min
    finite = torch.isfinite(x)
    zero = torch.zeros_like(x)
    hi = torch.where(finite, hi, torch.where(torch.isnan(x), float("nan"), x))
    mid = torch.where(finite, (mid.view(torch.int32) | sign)
                      .view(torch.float32), zero)
    lo = torch.where(finite, (lo.view(torch.int32) | sign)
                     .view(torch.float32), zero)
    return hi, mid, lo


def _takes_simt_tile(b: torch.Tensor) -> bool:
    """Whether a counting product with right operand ``b`` (float32, int32
    or uint8; the generic MXU path takes all three) runs on
    ``csrc/counting_tiles.cuh``'s SIMT tile, as its ``to_bf16`` pass decides
    on the card: some value of ``b.float()`` is not exact in bf16 (low 16
    bits set) or is not finite. A non-finite ``b`` would meet zero limbs on
    the tensor cores and give 0 * inf = NaN where ``fmaf`` gives inf. A
    uint8 ``b`` never takes it."""
    bits = b.float().contiguous().view(torch.int32)
    inexact = (bits & 0xffff) != 0
    return bool((inexact | ~torch.isfinite(b.float())).any())


def _limbed_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product ``a @ b`` (2D or batched) as ``csrc/semiring.cu``'s
    tensor-core tile sums it, for a ``b`` exact in bf16: per 16-deep k
    step, the three limb products of :func:`_split_bf16_limbs` summed in
    float64, rounded to fp32 and added to an fp32 accumulator that starts
    at 0. Where the card's step sums are exact (every partial sum an
    integer below 2**24), this is the card's answer bit for bit."""
    limbs = [x.double() for x in _split_bf16_limbs(a)]
    b = b.double()
    k = a.shape[-1]
    acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, k, 16):
        part = sum(x[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :] for x in limbs)
        acc = acc + part.float()
    return acc


def _u8_limbs(f: torch.Tensor) -> torch.Tensor:
    """The four u8 limbs of int32 ``f`` read as uint32 bits, bits 0-7,
    8-15, 16-23 and 24-31, stacked on a new leading axis (as int64), as
    ``csrc/packed.cu``'s split pass forms them: ``sum_l limbs[l] << 8 l ==
    f`` for every nonnegative ``f``."""
    bits = f.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(bits >> (8 * l)) & 0xFF for l in range(4)])


def _limbed_u8_matmul_ref(f: torch.Tensor, b: torch.Tensor,
                          chunk: int = _FOLD_K) -> torch.Tensor:
    """The product ``f @ b`` (int32 ``f``, uint8 ``b``, 2D or batched) as
    ``csrc/packed.cu`` sums it, as int64: per ``chunk`` of k, each limb of
    :func:`_u8_limbs` times ``b`` summed in an int32 register (wrapping as
    the card's would), limb 0's starting from the carry; at the end of a
    chunk that is not the last the four sums fold into a total clamped at
    MULT_SAT, the next chunk's carry. The last fold is returned unclamped.
    With the card's chunk (:data:`_FOLD_K`) no limb sum can wrap, so the
    result is ``f @ b`` wherever that is below MULT_SAT and at least
    MULT_SAT elsewhere; a chunk past 33,025 k can wrap."""
    limbs = _u8_limbs(f)
    b = b.to(torch.int64)
    k = f.shape[-1]
    carry = torch.zeros((*f.shape[:-1], b.shape[-1]), dtype=torch.int64,
                        device=f.device)
    total = carry
    for k0 in range(0, k, chunk):
        sums = [limbs[l][..., k0:k0 + chunk] @ b[..., k0:k0 + chunk, :]
                for l in range(4)]
        sums[0] = sums[0] + carry
        # what an int32 register holds after the same adds
        sums = [(s + 2 ** 31) % 2 ** 32 - 2 ** 31 for s in sums]
        total = sum(s << (8 * l) for l, s in enumerate(sums))
        carry = total.clamp(max=MULT_SAT)
    return total


def _row_blocks(m: int, k: int, n: int, fields: int = 1):
    """Row ranges of a (rows, k, n) broadcast within the element budget."""
    rows = max(1, _BROADCAST_BLOCK // max(1, fields * k * n))
    return ((lo, min(m, lo + rows)) for lo in range(0, m, rows))


def _neg_zero(x: torch.Tensor) -> torch.Tensor:
    """Where ``x`` is -0."""
    return (x == 0) & torch.signbit(x)


def _prefer_neg_zero(out: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """``out``, the min-plus product of ``a`` and ``b``, with a zero made -0
    wherever some k sums to -0 (both terms -0, the only way to a -0 sum),
    as ``min.NaN.f32`` and the JAX package's ``jnp.min`` rank -0 below +0;
    ``torch.amin`` returns whichever zero its reduction meets first."""
    na, nb = _neg_zero(a), _neg_zero(b)
    if not (bool(na.any()) and bool(nb.any())):
        return out
    neg = (na.float() @ nb.float()) > 0
    return torch.where(neg & (out == 0), -0.0, out)


def minplus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical (min, +) matrix product: out[i,j] = min_k a[i,k] + b[k,j].
    An empty k gives +inf, the semiring's zero; NaN propagates, and -0
    ranks below +0."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.full((m, n), float("inf"), dtype=torch.float32,
                     device=a.device)
    if k == 0:
        return out
    a, b = a.float(), b.float()
    for lo, hi in _row_blocks(m, k, n):
        out[lo:hi] = (a[lo:hi, :, None] + b[None]).amin(dim=1)
    return _prefer_neg_zero(out, a, b)


def batched_minplus_matmul_ref(a: torch.Tensor, b: torch.Tensor
                               ) -> torch.Tensor:
    """Stacked tropical product: out[z,i,j] = min_k a[z,i,k] + b[z,k,j]."""
    out = torch.empty((a.shape[0], a.shape[1], b.shape[2]),
                      dtype=torch.float32, device=a.device)
    for z in range(a.shape[0]):
        out[z] = minplus_matmul_ref(a[z], b[z])
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
    return _prefer_neg_zero(d, da, db), c


def _min_nan(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``min.NaN.f32`` elementwise: NaN if either is NaN, else the smaller,
    -0 below +0 (``torch.minimum`` returns its first operand on a tie)."""
    return torch.where(x == y, torch.where(torch.signbit(x), x, y),
                       torch.minimum(x, y))


def _count_update(d, c, s, p):
    """One k of the count product, and its split combine: (d, c) folds in
    (s, p) as ``csrc/tropical.cu``'s ``count_update``, the form of
    :func:`_tc_accumulate` with :func:`_min_nan`."""
    m = _min_nan(d, s)
    return m, torch.where(d == m, c, 0.0) + torch.where(s == m, p, 0.0)


def _split_ranges(k: int, splits: int):
    """The K ranges ``csrc/tropical.cu``'s split tile gives ``splits``
    blocks of a cluster: split s folds K steps s T / S .. (s + 1) T / S of
    the T steps of BK (empty where T < S)."""
    bk = _MINPLUS_SPLIT["bk"]
    t = -(-k // bk)
    return [(min(k, s * t // splits * bk), min(k, (s + 1) * t // splits * bk))
            for s in range(splits)]


def _split_k_minplus_ref(a: torch.Tensor, b: torch.Tensor,
                         splits: int) -> torch.Tensor:
    """The min-plus product (2D or batched) as the split tile computes it
    with K split ``splits`` ways: each split folds its K range in k order
    from +inf, and the partials fold in split order, all with
    :func:`_min_nan`."""
    shape = (*a.shape[:-1], b.shape[-1])
    out = None
    for lo, hi in _split_ranges(a.shape[-1], splits):
        part = torch.full(shape, float("inf"), dtype=torch.float32,
                          device=a.device)
        for k in range(lo, hi):
            part = _min_nan(part, a[..., :, k, None] + b[..., k, None, :])
        out = part if out is None else _min_nan(out, part)
    return out


def _split_k_minplus_count_ref(da, ca, db, cb, splits: int):
    """The count product as the split tile computes it with K split
    ``splits`` ways: each split folds its K range in k order from (+inf,
    0) with :func:`_count_update`, and the partials fold in split order
    with the same update. The card fuses each k's product into its add
    (``count_step``), which gives the same bits wherever the products and
    sums are exact (integer counts below 2**24)."""
    shape = (*da.shape[:-1], db.shape[-1])
    out = None
    for lo, hi in _split_ranges(da.shape[-1], splits):
        d = torch.full(shape, float("inf"), dtype=torch.float32,
                       device=da.device)
        c = torch.zeros(shape, dtype=torch.float32, device=da.device)
        for k in range(lo, hi):
            d, c = _count_update(d, c, da[..., :, k, None] + db[..., k, None, :],
                                 ca[..., :, k, None] * cb[..., k, None, :])
        out = (d, c) if out is None else _count_update(*out, d, c)
    return out


# -- the kernels -----------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_LIB = None
_TROPICAL_LIB = None
#: the entry points of ``csrc/semiring.cu``, which share one pair of tiles
_COUNTING_TILES = ("frontier_step", "count_matmul", "reachability_step")
#: ``csrc/tropical.cu``'s split-K limit: at most this many blocks of a
#: cluster share one output tile (the portable cluster size)
_MINPLUS_SPLIT_MAX = 8
#: the counters of ``csrc/tropical.cu``'s tiles, in its order: the split
#: tile at split 1 ("small"), the large tile, the split tile at splits 2..8
_MINPLUS_TILES = ("small", "large") + tuple(
    f"split{s}" for s in range(2, _MINPLUS_SPLIT_MAX + 1))
#: the wrappers whose kernels count their launches per tile on the card, and
#: the names of their tiles: the counting tiles (``csrc/counting_tiles.cuh``,
#: also the generic MXU path's, ``semiring_matmul``), the min-plus tiles
#: and splits (``csrc/tropical.cu``) and the generic VPU path's
#: (``semiring_matmul_vpu``: ``csrc/semiring_generic.cuh``'s 32 x 32 tile and
#: ``csrc/vpu_tiles.cuh``'s)
_TILED = {**{name: ("simt", "tensor") for name in _COUNTING_TILES},
          "semiring_matmul": ("simt", "tensor"),
          "minplus_matmul": _MINPLUS_TILES,
          "batched_minplus_matmul": _MINPLUS_TILES,
          "minplus_count_matmul": _MINPLUS_TILES,
          "semiring_matmul_vpu": ("small", "large")}
_TILE_COUNTS: Optional[torch.Tensor] = None
#: wrapper name -> the address of its counters in :data:`_TILE_COUNTS`
_TILE_PTRS: Dict[str, int] = {}
_PACKED_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("semiring")
        for name in _COUNTING_TILES:
            fn = getattr(lib, f"repro_{name}_f32")
            fn.argtypes = [_I, _P, _L, _L, _L, _P, _P, _P, _P, _P, _P, _I,
                           _I, _I, _I, _P]
            fn.restype = _I
        _LIB = lib
    return _LIB


def _tropical_lib() -> ctypes.CDLL:
    global _TROPICAL_LIB
    if _TROPICAL_LIB is None:
        from .build import load

        lib = load("tropical")
        lib.repro_minplus_f32.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                          _I, _P]
        lib.repro_minplus_f32.restype = _I
        lib.repro_minplus_batched_f32.argtypes = [_P, _P, _P, _P, _P, _P, _I,
                                                  _I, _I, _I, _I, _P]
        lib.repro_minplus_batched_f32.restype = _I
        lib.repro_minplus_count_f32.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                                                _I, _I, _I, _I, _P]
        lib.repro_minplus_count_f32.restype = _I
        _TROPICAL_LIB = lib
    return _TROPICAL_LIB


def _packed_lib() -> ctypes.CDLL:
    global _PACKED_LIB
    if _PACKED_LIB is None:
        from .build import load

        lib = load("packed")
        lib.repro_frontier_step_packed.argtypes = [_P, _P, _P, _P, _P, _I,
                                                   _I, _I, _I, _P]
        lib.repro_frontier_step_packed.restype = _I
        lib.repro_count_matmul_narrow.argtypes = [_P, _L, _L, _L, _P, _P, _P,
                                                  _I, _I, _I, _I, _P]
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
    return _counting_gemm("frontier_step", f, a, d)


def count_matmul(a: torch.Tensor, b: torch.Tensor,
                 use_kernel: bool = True) -> torch.Tensor:
    """Counting product ``A@B``, 2D or batched, as fp32.

    fp32 operands run the fp32 kernel; an int32 ``a`` with a uint8 ``b``
    (a packed frontier slab against an adjacency panel) runs the narrow
    kernel: for a nonnegative ``a`` it is exact (bit-equal to the plain
    version) wherever the sum is below 2**24, and at least 2**24 wherever
    the sum is at or above it. ``a`` may be
    any strided view (a transposed stack or a column slab needs no copy);
    ``b`` must be contiguous. For another output dtype, cast the result.
    """
    narrow = a.dtype == torch.int32 and b.dtype == torch.uint8
    dtypes = (torch.int32, torch.uint8) if narrow else None
    if not _use_kernel(use_kernel, a, b, dtypes=dtypes):
        return (batched_count_matmul_ref(a, b) if a.ndim == 3
                else count_matmul_ref(a, b))
    if narrow:
        return _narrow_product(a, b)
    return _counting_gemm("count_matmul", a, b)


def _limb_scratch(batch: int, m: int, k: int,
                  device: torch.device) -> torch.Tensor:
    """The u8 scratch of ``csrc/packed.cu``'s split pass: four limbs of the
    (batch, m, k) left operand, padded to the GEMM's row tile and k stage,
    then one 32-bit flag word per row tile (its nonzero limbs)."""
    mp = -(-m // _NARROW_BM) * _NARROW_BM
    kp = -(-k // _NARROW_BK) * _NARROW_BK
    return torch.empty(batch * 4 * mp * kp + batch * (mp // _NARROW_BM) * 4,
                       dtype=torch.uint8, device=device)


def _limb_passes(f: torch.Tensor) -> torch.Tensor:
    """The limb products ``csrc/packed.cu`` runs for the left operand ``f``
    (.., M, K): per row tile of 32 rows, limb 0 and each other u8 limb
    (:func:`_u8_limbs`) that is not zero somewhere in the tile; shape
    (.., ceil(M / 32)). The other limbs' products are skipped."""
    limbs = _u8_limbs(f)  # (4, .., M, K)
    m = f.shape[-2]
    mp = -(-m // _NARROW_BM) * _NARROW_BM
    pad = torch.zeros((*limbs.shape[:-2], mp - m, limbs.shape[-1]),
                      dtype=limbs.dtype, device=limbs.device)
    tiles = torch.cat([limbs, pad], dim=-2).unflatten(
        -2, (mp // _NARROW_BM, _NARROW_BM))
    return 1 + (tiles[1:] != 0).any(-1).any(-1).sum(0)


def _narrow_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``csrc/packed.cu``'s narrow product: ``a`` (int32) read through its
    (batch, row, col) strides, ``b`` (uint8) contiguous, into a new fp32
    (.., m, n) output; counts the launch."""
    name = "count_matmul_narrow"
    batch, m, n, k = _dims(a, b)
    if m > _MAX_NARROW_ROWS:
        raise ValueError(f"rows {m} exceed the launch grid")
    _contiguous(name, b=b)
    sb = a.stride(0) if a.ndim == 3 else 0
    c = torch.empty((*a.shape[:-1], n), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    limbs = _limb_scratch(batch, m, k, a.device)
    _check(_packed_lib().repro_count_matmul_narrow(
        a.data_ptr(), sb, a.stride(-2), a.stride(-1), b.data_ptr(),
        c.data_ptr(), limbs.data_ptr(), batch, m, n, k,
        torch.cuda.current_stream(a.device).cuda_stream), name)
    launches[name] += 1
    return c


#: A's layouts in ``csrc/semiring.cu`` (its ``Layout`` enum)
_ROW_MAJOR, _COL_MAJOR, _STRIDED = 0, 1, 2
#: the counting tiles' K step and M, N tile; the bf16 copy of B is padded to
#: the K step and the N tile
_TILE_K, _TILE_N = 32, 128


def _a_layout(a: torch.Tensor, b: torch.Tensor,
              vec: Optional[bool] = None) -> int:
    """Which of ``csrc/counting_tiles.cuh``'s left-operand loaders reads
    ``a`` (2D or a stack) in a product with the contiguous ``b``:
    _ROW_MAJOR (unit stride along k) or _COL_MAJOR (unit stride along m),
    whose 16-byte copies need the other strides, the unit axis's extent, N
    and both bases' byte offsets to be multiples of 4 elements (16 bytes),
    or _STRIDED (4-byte copies) for any other view. ``vec`` says whether
    the fp32 bases the tiles read are 16-byte aligned (by default those of
    ``a`` and ``b``; the generic MXU path reads its fp32 copies instead)."""
    sr, sc = a.stride(-2), a.stride(-1)
    sb = a.stride(0) if a.ndim == 3 else 0
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if vec is None:
        vec = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    vec = vec and n % 4 == 0 and sb % 4 == 0
    if vec and sc == 1 and k % 4 == 0 and (sr % 4 == 0 or m == 1):
        return _ROW_MAJOR
    if vec and sr == 1 and m % 4 == 0 and (sc % 4 == 0 or k == 1):
        return _COL_MAJOR
    return _STRIDED


def _tile_counts(device: torch.device, name: str) -> int:
    """The address of the device counters of ``name``'s tiles
    (:data:`_TILED`, one int each), allocated at the first launch."""
    global _TILE_COUNTS
    if _TILE_COUNTS is None:
        width = max(len(tiles) for tiles in _TILED.values())
        _TILE_COUNTS = torch.zeros((len(_TILED), width), dtype=torch.int32,
                                   device=device)
        _TILE_PTRS.update((n, row.data_ptr())
                          for n, row in zip(_TILED, _TILE_COUNTS))
    return _TILE_PTRS[name]


def tile_launches() -> Dict[str, Dict[str, int]]:
    """Launches of each tile since the last :func:`reset_launches`, per
    wrapper: ``{"frontier_step": {"simt": n, "tensor": m}, ...,
    "semiring_matmul": {"simt": .., "tensor": ..}, "minplus_matmul":
    {"small": .., "large": .., "split2": .., ..., "split8": ..},
    "batched_minplus_matmul": {...}, "minplus_count_matmul": {...},
    "semiring_matmul_vpu": {"small": .., "large": ..}}`` (the generic
    kernel's MXU-path launches under ``semiring_matmul``, its VPU-path ones
    under ``semiring_matmul_vpu``; a min-plus product's split tile under
    "small" at split 1 and "split<S>" at split S, see
    :func:`_minplus_column`). The counters live on the card and are read
    here, one host sync: call it outside timed windows. All zero before
    the first launch."""
    width = max(len(tiles) for tiles in _TILED.values())
    counts = (np.zeros((len(_TILED), width), np.int64)
              if _TILE_COUNTS is None else _TILE_COUNTS.cpu().numpy())
    return {name: {tile: int(n) for tile, n in zip(tiles, c)}
            for (name, tiles), c in zip(_TILED.items(), counts)}


def _counting_smem_bytes() -> Dict[str, Dict[str, int]]:
    """Dynamic shared memory of one block of each counting tile, per
    left-operand layout: ``{"simt": {"row-major": bytes, ...}, "tensor":
    {...}}``, from the tile constants of ``csrc/semiring.cu`` (its
    ``simt_smem_bytes`` / ``tc_smem_bytes``)."""
    bm = bn = _TILE_N
    bk, stages = _TILE_K, 3
    a_floats = {"row-major": bm * (bk + 4), "column-major": bk * (bm + 4),
                "strided": bk * (bm + 4)}
    return {"simt": {name: stages * (af + bk * bn) * 4
                     for name, af in a_floats.items()},
            "tensor": {name: stages * (af + bk * (bn + 8) // 2) * 4
                       + 3 * bm * (bk + 8) * 2
                       for name, af in a_floats.items()}}


def _packed_smem_bytes() -> int:
    """Dynamic shared memory of one block of ``csrc/packed.cu``'s GEMM, from
    its tile constants (its ``SMEM_BYTES``): four stages of the 32-row limb
    tiles (rows padded to 80 bytes) and a 64 x 256 byte adjacency tile."""
    stages, limbs, a_ld = 4, 4, _NARROW_BK + 16
    return stages * (limbs * _NARROW_BM * a_ld + _NARROW_BK * 256)


#: ``csrc/tropical.cu``'s large min-plus tile: output edge, K stage, ring
#: depth, and the fewest blocks of its grid for which the host picks it
_MINPLUS_LARGE, _MINPLUS_BK, _MINPLUS_STAGES = 128, 32, 3
_MINPLUS_LARGE_MIN_BLOCKS = 256
#: ``csrc/tropical.cu``'s split tile (its ``SPLIT_SHAPE``, for one field and
#: two): block tile, micro-tile, k per read of A, K step and ring depth
_MINPLUS_SPLIT = dict(bm=64, bn=64, tm=4, tn=4, kv=4, bk=32, stages=3)
#: its split rule: a grid of at most this many blocks (one an SM), at
#: least this many splits, and at least this many K steps a split
_MINPLUS_SPLIT_BLOCKS, _MINPLUS_SPLIT_LEAST = 128, 2
_MINPLUS_SPLIT_MIN_STEPS = 2


def _minplus_tile(batch: int, m: int, n: int) -> str:
    """The tile ``csrc/tropical.cu`` runs a plain min-plus product of
    ``batch`` (m, n) outputs on, as its ``plan`` decides on the host:
    "large" (128 x 128 outputs a block) where that grid has at least 256
    blocks, about two per SM, else "small" (the split tile). The tropical
    count product always runs on the split tile."""
    blocks = batch * -(-m // _MINPLUS_LARGE) * -(-n // _MINPLUS_LARGE)
    return "large" if blocks >= _MINPLUS_LARGE_MIN_BLOCKS else "small"


def _minplus_plan(batch: int, m: int, n: int, k: int, nf: int = 1,
                  split: Optional[int] = None) -> Tuple[str, int]:
    """The tile and split of K that ``csrc/tropical.cu``'s ``plan`` gives a
    product of ``batch`` (m, n, k) over ``nf`` fields (1: min-plus, 2: the
    count product): ("large", 1) where :func:`_minplus_tile` takes the
    large tile (min-plus only), else ("small", S): the split tile with K
    split over S blocks of a cluster, as many as keep the grid within 128
    blocks (one an SM) but at least 2, as far as every split keeps two K
    steps, at most 8. ``split`` forces the split tile with that split."""
    if split is not None:
        return "small", split
    if nf == 1 and _minplus_tile(batch, m, n) == "large":
        return "large", 1
    c = _MINPLUS_SPLIT
    blocks = batch * -(-m // c["bm"]) * -(-n // c["bn"])
    steps = -(-k // c["bk"])
    s = max(_MINPLUS_SPLIT_BLOCKS // max(blocks, 1), _MINPLUS_SPLIT_LEAST)
    s = min(s, steps // _MINPLUS_SPLIT_MIN_STEPS, _MINPLUS_SPLIT_MAX)
    return "small", max(1, s)


def _minplus_column(tile: str, split: int) -> str:
    """The :func:`tile_launches` entry a min-plus launch on ``tile`` at
    ``split`` adds to."""
    return tile if tile == "large" or split == 1 else f"split{split}"


def _minplus_smem_bytes() -> int:
    """Dynamic shared memory of one block of the large min-plus tile, from
    ``csrc/tropical.cu``'s constants (its ``LARGE_SMEM``): per stage of the
    ring, A as [128][32 + 4] and B as [32][128] fp32."""
    t, bk = _MINPLUS_LARGE, _MINPLUS_BK
    return _MINPLUS_STAGES * (t * (bk + 4) + bk * t) * 4


def _counting_gemm(name: str, a: torch.Tensor, b: torch.Tensor,
                   d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One call of ``csrc/semiring.cu``'s entry point ``name``: ``a`` read
    through its strides in the layout :func:`_a_layout` picks, ``b`` (and
    ``d``) contiguous; a new fp32 (.., m, n) output. The kernel converts
    ``b`` into a bf16 scratch copy and picks its tile on the device;
    counts the launch under ``name``."""
    batch, m, n, k = _dims(a, b)
    _contiguous(name, b=b)
    out = torch.empty((*a.shape[:-1], n), dtype=torch.float32,
                      device=a.device)
    if out.numel() == 0:
        return out
    kp = -(-k // _TILE_K) * _TILE_K
    np_ = -(-n // _TILE_N) * _TILE_N
    b16 = torch.empty(batch * kp * np_, dtype=torch.bfloat16,
                      device=a.device)
    flag = torch.empty(1, dtype=torch.int32, device=a.device)
    counters = _tile_counts(a.device, name)
    sb = a.stride(0) if a.ndim == 3 else 0
    _check(getattr(_lib(), f"repro_{name}_f32")(
        _a_layout(a, b), a.data_ptr(), sb, a.stride(-2), a.stride(-1),
        b.data_ptr(), None if d is None else d.data_ptr(), out.data_ptr(),
        b16.data_ptr(), flag.data_ptr(), counters, batch, m, n, k,
        torch.cuda.current_stream(a.device).cuda_stream), name)
    launches[name] += 1
    return out


def reachability_step(a: torch.Tensor, b: torch.Tensor,
                      use_kernel: bool = True) -> torch.Tensor:
    """Boolean-semiring product ``(A@B > 0.5)`` of {0,1} fp32 masks, 2D or
    batched, as fp32 {0,1}: ``out[i,j] = OR_k (a[i,k] AND b[k,j])``.

    ``a`` may be any strided view, as in :func:`count_matmul`; ``b`` must
    be contiguous. The counts stay in registers: only the threshold is
    stored.
    """
    if not _use_kernel(use_kernel, a, b):
        return reachability_step_ref(a, b)
    return _counting_gemm("reachability_step", a, b)


def frontier_step_packed(f: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                         use_kernel: bool = True) -> torch.Tensor:
    """One fused wavefront step over packed cells.

    ``f`` is the (.., M, K) int32 multiplicity frontier, ``a`` the (.., K,
    N) uint8 adjacency, ``d`` the (.., M, N) int16 running distances
    (DIST_UNREACHED = unreached); all contiguous on the card. Returns the
    int32 next frontier: the newly reached pairs with their counts clamped
    at MULT_SAT (a cell equal to MULT_SAT is a lower bound). The callers
    pass counts of at most MULT_SAT and a {0,1} adjacency, but the domain
    is any nonnegative int32 ``f`` and any uint8 ``a``: a cell is exact
    where ``f@a`` is below MULT_SAT and MULT_SAT where it is at or above
    it, as in :func:`frontier_step_packed_ref`. Below MULT_SAT it equals
    :func:`frontier_step` as integers.
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
    limbs = _limb_scratch(batch, m, k, d.device)
    _check(_packed_lib().repro_frontier_step_packed(
        f.data_ptr(), a.data_ptr(), d.data_ptr(), x.data_ptr(),
        limbs.data_ptr(), batch, m, n, k,
        torch.cuda.current_stream(d.device).cuda_stream),
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
    return _minplus(a, b, use_kernel, compare, batched=False)


def batched_minplus_matmul(a: torch.Tensor, b: torch.Tensor,
                           use_kernel: bool = True,
                           compare: Optional[torch.Tensor] = None):
    """Stacked tropical product of fp32 (B, m, k) x (B, k, n): one launch
    for the whole stack. With ``compare``, a (B, m, n) tensor, returns
    ``(out, changed)`` as :func:`minplus_matmul` does, with one flag for
    the whole stack: the stacked squaring loop reads one flag per
    squaring."""
    return _minplus(a, b, use_kernel, compare, batched=True)


def _split_arg(batch: int, split: Optional[int]) -> int:
    """``csrc/tropical.cu``'s split argument: 0 for its own rule, else the
    forced split, checked against the cluster and the grid."""
    if split is None:
        return 0
    if not 1 <= split <= _MINPLUS_SPLIT_MAX or batch * split > _MAX_BATCH:
        raise ValueError(f"split {split} of batch {batch}: want 1 to "
                         f"{_MINPLUS_SPLIT_MAX}, batch x split <= "
                         f"{_MAX_BATCH}")
    return split


def _minplus(a, b, use_kernel, compare, batched, split=None):
    """The two min-plus wrappers' body. ``split`` runs the split tile with
    K split over that many blocks of a cluster, whatever the grid (a
    private seam: every tile and split agrees bit for bit, and the card's
    checks hold them to it); None runs what :func:`_minplus_plan` picks."""
    name = "batched_minplus_matmul" if batched else "minplus_matmul"
    xs = (a, b) if compare is None else (a, b, compare)
    if not _use_kernel(use_kernel, *xs):
        out = (batched_minplus_matmul_ref if batched
               else minplus_matmul_ref)(a, b)
        if compare is None:
            return out
        return out, (out != compare).any().reshape(1).to(torch.int32)
    if batched:
        if a.ndim != 3:
            raise ValueError(f"batched operands must be (B, m, k) x "
                             f"(B, k, n): {tuple(a.shape)} x "
                             f"{tuple(b.shape)}")
        batch, m, n, k = _dims(a, b)
        if m > _MAX_TROPICAL_ROWS:
            raise ValueError(f"rows {m} exceed the launch grid")
    else:
        batch, (m, n, k) = 1, _dims_2d(a, b)
    forced = _split_arg(batch, split)
    _contiguous(name, a=a, b=b)
    shape = (*a.shape[:-1], n)
    if compare is not None:
        _contiguous(name, compare=compare)
        if tuple(compare.shape) != shape:
            raise ValueError(f"compare shape {tuple(compare.shape)} is not "
                             f"the product's {shape}")
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    changed = (torch.zeros(1, dtype=torch.int32, device=a.device)
               if compare is not None else None)
    if out.numel():
        lib = _tropical_lib()
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(),
                None if compare is None else compare.data_ptr(),
                None if changed is None else changed.data_ptr(),
                _tile_counts(a.device, name), forced)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _check(lib.repro_minplus_batched_f32(*args, batch, m, n, k, stream)
               if batched else lib.repro_minplus_f32(*args, m, n, k, stream),
               name)
        launches[name] += 1
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
    return _minplus_count(da, ca, db, cb, use_kernel)


def _minplus_count(da, ca, db, cb, use_kernel, split=None):
    """:func:`minplus_count_matmul`'s body; ``split`` forces the split of K,
    as in :func:`_minplus`."""
    if not _use_kernel(use_kernel, da, ca, db, cb):
        return minplus_count_matmul_ref(da, ca, db, cb)
    m, n, k = _dims_2d(da, db)
    if ca.shape != da.shape or cb.shape != db.shape:
        raise ValueError("count fields must match their dist fields")
    forced = _split_arg(1, split)
    _contiguous("minplus_count_matmul", da=da, ca=ca, db=db, cb=cb)
    d = torch.empty((m, n), dtype=torch.float32, device=da.device)
    c = torch.empty((m, n), dtype=torch.float32, device=da.device)
    if d.numel():
        _check(_tropical_lib().repro_minplus_count_f32(
            da.data_ptr(), ca.data_ptr(), db.data_ptr(), cb.data_ptr(),
            d.data_ptr(), c.data_ptr(),
            _tile_counts(da.device, "minplus_count_matmul"), forced, m, n, k,
            torch.cuda.current_stream(da.device).cuda_stream),
            "minplus_count_matmul")
        launches["minplus_count_matmul"] += 1
    return d, c


# -- the Semiring extension point --------------------------------------------------

Fields = Tuple[torch.Tensor, ...]

#: K slab of the plain VPU version, as the JAX kernel's default ``sub_k``
_SUB_K = 8
#: the generic VPU tiles' field limit (the small tile's shared memory stays
#: under 48 KB)
_MAX_FIELDS = 16
_MAX_GRID_Y = 65535  # gridDim.y: the rows of a product are at most this
#                      many times the row tile that runs it
#: the small VPU tile's output edge (``csrc/semiring_generic.cuh``'s VTILE)
_VPU_SMALL = 32
#: ``csrc/vpu_tiles.cuh``'s large VPU tile: per field count, the
#: micro-tile and read widths ``(most fields, (tm, tn, kv, bv))`` (its
#: ``shape``; none past 12 fields), a block's shared-memory limit
#: (``SMEM_MAX``), the K steps it tries and the fewest blocks of a grid
#: that takes it. Fields are 4 bytes (``FIELD_BYTES``): the VPU path runs
#: float32 and int32 only (:func:`device_types`).
_VPU_SHAPES = ((1, (8, 8, 2, 4)), (2, (4, 8, 2, 4)), (4, (4, 4, 2, 4)),
               (8, (2, 4, 2, 4)), (12, (2, 2, 2, 2)))
_VPU_FIELD_BYTES = 4
_VPU_SMEM_MAX = 113 * 1024 - 512
_VPU_BKS = (32, 16, 8)
_VPU_LARGE_MIN_BLOCKS = 256
#: dtype -> C type of the generated kernels
_C_TYPES = {torch.float32: "float", torch.int32: "int",
            torch.uint8: "unsigned char"}
_SHORT = {torch.float32: "f32", torch.int32: "i32", torch.uint8: "u8"}


@dataclasses.dataclass(frozen=True)
class Semiring:
    """Spec of one blocked-matmul algebra: the port of the JAX package's
    ``Semiring``, with the same fields, plus its device form.

    A semiring element is a tuple of ``num_fields`` scalars (one tensor per
    field at matrix level). ``pad_a``/``pad_b`` are the multiplicative
    annihilators that ragged edges act as: padding must never win a
    reduction. ``acc_init`` is the additive identity the accumulator starts
    from.

    VPU path (``mxu=False``), callables over field tuples of torch tensors:
      combine(a, b):    elementwise semiring multiply on a broadcast
                        (rows, sub_k, n) slab; a is (rows, sub_k, 1)-shaped,
                        b is (1, sub_k, n)-shaped.
      kreduce(f):       semiring-add reduce over axis 1 -> (rows, n) fields.
      accumulate(x, y): binary semiring add of two (rows, n) field tuples.

    MXU path (``mxu=True``, single field only): the product is the plain
    IEEE fp32 dot; ``epilogue`` maps the accumulated fp32 sums to the
    output. On the card it runs on :func:`count_matmul`'s two tiles, so its
    results are :func:`count_matmul`'s: bit-equal to the plain version
    wherever every partial sum is an integer below 2**24, within rtol 1e-5
    elsewhere (the tensor-core tile, taken when ``b`` is exact in bf16,
    rounds once per 16-deep k step), and a ``b`` value that is not finite
    takes the SIMT tile, which keeps ``fmaf``'s inf and NaN. Its pads must
    be annihilators of x (``pad_a * pad_b == 0``): the kernel zero-fills
    ragged K.

    **Device code** runs the same algebra in the generated CUDA kernel
    (``csrc/semiring_generic.cuh``); without it the spec runs only on CPU
    tensors. Each is a C++ string, compiled with ``nvcc`` at first use:
      cuda_combine:    a body over ``a[f]`` and ``b[f]`` that writes
                       ``out[f]`` for every field f (VPU path);
      cuda_accumulate: a body that folds ``t[f]`` into ``acc[f]`` in place
                       (VPU path);
      cuda_epilogue:   an expression in ``float acc`` (MXU path), cast to
                       the output type.
    The bodies may use ``T`` (the fields' C type), ``NF``, ``<math.h>`` and
    the header's ``sr_min``/``sr_max``/``sr_fmin_nan``. Write
    ``cuda_accumulate`` with selects (``c ? x : y``), not ``if``/``else``:
    the register-blocked tile runs data-dependent branches 2.4x slower (see
    ``csrc/vpu_tiles.cuh``). ``kreduce`` has no device form:
    the kernel folds ``accumulate`` over k, which is what a semiring's
    reduce is, so ``accumulate`` must be associative and commutative (the
    JAX kernel assumes the same when it reduces block by block).
    """

    name: str
    pad_a: Tuple[float, ...]
    pad_b: Tuple[float, ...]
    acc_init: Tuple[float, ...]
    num_fields: int = 1
    mxu: bool = False
    combine: Optional[Callable[[Fields, Fields], Fields]] = None
    kreduce: Optional[Callable[[Fields], Fields]] = None
    accumulate: Optional[Callable[[Fields, Fields], Fields]] = None
    epilogue: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    cuda_combine: Optional[str] = None
    cuda_accumulate: Optional[str] = None
    cuda_epilogue: Optional[str] = None

    def __post_init__(self):
        for name in ("pad_a", "pad_b", "acc_init"):
            values = tuple(float(v) for v in getattr(self, name))
            if len(values) != self.num_fields:
                raise ValueError(f"{self.name}: {name} has {len(values)} "
                                 f"values for {self.num_fields} fields")
            object.__setattr__(self, name, values)
        if self.mxu:
            if self.num_fields != 1:
                raise ValueError(f"{self.name}: the MXU path is single-field")
            if self.epilogue is None:
                raise ValueError(f"{self.name}: the MXU path needs an "
                                 f"epilogue")
        elif not (self.combine and self.kreduce and self.accumulate):
            raise ValueError(f"{self.name}: the VPU path needs combine, "
                             f"kreduce and accumulate")


def _require_device_code(sr: Semiring) -> None:
    """Raises NotImplementedError, naming the unset fields, when ``sr`` has
    no device code for its path."""
    want = ("cuda_epilogue",) if sr.mxu else ("cuda_combine",
                                              "cuda_accumulate")
    missing = [f for f in want if not getattr(sr, f)]
    if missing:
        raise NotImplementedError(
            f"Semiring {sr.name!r} has no device code ({', '.join(missing)} "
            f"unset): it runs on CPU tensors only")


def _literal(v: float, dtype: torch.dtype) -> str:
    """``v`` as a C literal of the field type."""
    if dtype == torch.float32:
        v = float(np.float32(v))
        if math.isnan(v):
            return "NAN"
        if math.isinf(v):
            return "INFINITY" if v > 0 else "(-INFINITY)"
        return f"({v!r}f)"
    if not (float(v).is_integer() and -2**31 <= v < 2**31):
        raise ValueError(f"{v} is not an int32 value")
    return f"({int(v)})"


def _ident(name: str) -> str:
    return re.sub(r"\W", "_", name)


def device_types(sr: Semiring, a: Sequence[torch.Tensor],
                 b: Sequence[torch.Tensor], out_dtype=None):
    """The dtypes a generated kernel is built for: ``(field dtype,)`` on
    the VPU path, ``(a, b, out)`` dtypes on the MXU path. Raises TypeError
    for dtypes the kernel does not take: VPU fields are float32 or int32,
    one dtype for every field of both operands; MXU operands float32, int32
    or uint8, the output float32 or int32."""
    if sr.mxu:
        out = out_dtype or a[0].dtype
        if a[0].dtype not in _C_TYPES or b[0].dtype not in _C_TYPES:
            raise TypeError(f"{sr.name}: the kernel takes float32, int32 or "
                            f"uint8 operands, got {a[0].dtype} x "
                            f"{b[0].dtype}")
        if out not in (torch.float32, torch.int32):
            raise TypeError(f"{sr.name}: the kernel writes float32 or int32, "
                            f"not {out}")
        return a[0].dtype, b[0].dtype, out
    dtypes = {x.dtype for x in (*a, *b)}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.int32}:
        raise TypeError(f"{sr.name}: the kernel takes float32 or int32 "
                        f"fields, one dtype for all, got {sorted(map(str, dtypes))}")
    return (dtypes.pop(),)


def build_key(sr: Semiring, types: Sequence[torch.dtype]) -> str:
    """The name of the generated library for ``sr`` and ``types``."""
    return "_".join(["semiring", _ident(sr.name), *(_SHORT[t] for t in types)])


def algebra_source(sr: Semiring, types: Sequence[torch.dtype]) -> str:
    """The C++ algebra struct of ``sr`` for ``types`` (`device_types`), as
    ``csrc/semiring_generic.cuh`` documents it. Raises NotImplementedError
    when the spec has no device code."""
    _require_device_code(sr)
    name = f"Algebra_{_ident(sr.name)}"
    if sr.mxu:
        if sr.pad_a[0] * sr.pad_b[0] != 0:
            raise ValueError(f"{sr.name}: the MXU kernel zero-fills ragged "
                             f"K, so pad_a * pad_b must be 0")
        ta, tb, tout = (_C_TYPES[t] for t in types)
        return (f"struct {name} {{\n"
                f"  using A = {ta};\n  using B = {tb};\n  using Out = {tout};\n"
                f"  static SR_FN float pad_a() {{ return "
                f"{_literal(sr.pad_a[0], torch.float32)}; }}\n"
                f"  static SR_FN float pad_b() {{ return "
                f"{_literal(sr.pad_b[0], torch.float32)}; }}\n"
                f"  static SR_FN auto epilogue(float acc) {{\n"
                f"    return ({sr.cuda_epilogue});\n  }}\n}};\n")
    (dtype,) = types
    nf = sr.num_fields
    if nf > _MAX_FIELDS:
        raise ValueError(f"{sr.name}: the kernel takes at most "
                         f"{_MAX_FIELDS} fields, not {nf}")

    def fill(var, values):
        return " ".join(f"{var}[{f}] = {_literal(v, dtype)};"
                        for f, v in enumerate(values))

    return (f"struct {name} {{\n"
            f"  using T = {_C_TYPES[dtype]};\n"
            f"  static constexpr int NF = {nf};\n"
            f"  static SR_FN void pad_a(T (&v)[NF]) {{ {fill('v', sr.pad_a)} }}\n"
            f"  static SR_FN void pad_b(T (&v)[NF]) {{ {fill('v', sr.pad_b)} }}\n"
            f"  static SR_FN void init(T (&acc)[NF]) "
            f"{{ {fill('acc', sr.acc_init)} }}\n"
            f"  static SR_FN void combine(const T (&a)[NF], const T (&b)[NF],\n"
            f"                            T (&out)[NF]) {{\n"
            f"    {sr.cuda_combine}\n  }}\n"
            f"  static SR_FN void accumulate(T (&acc)[NF], const T (&t)[NF]) {{\n"
            f"    {sr.cuda_accumulate}\n  }}\n}};\n")


def semiring_source(sr: Semiring, types: Sequence[torch.dtype]) -> str:
    """The CUDA source of ``sr``'s kernel for ``types``: the algebra struct
    and one C entry point over ``csrc/vpu_tiles.cuh`` (the VPU path: its
    large tile or ``csrc/semiring_generic.cuh``'s 32 x 32 tile, picked by
    the grid, each counting its launches) or ``csrc/counting_tiles.cuh``
    (the MXU path: ``count_matmul``'s GEMM with the algebra's epilogue as
    its store policy)."""
    struct = algebra_source(sr, types)
    alg = f"Algebra_{_ident(sr.name)}"
    include = '#include "semiring_generic.cuh"\n'
    if sr.mxu:
        include += '#include "counting_tiles.cuh"\n'
        entry = ("extern \"C\" int repro_semiring_mxu(int layout, "
                 "const void* a, void* a32,\n    const void* b, void* b32, "
                 "void* out, void* b16, void* flag, void* counters,\n"
                 "    int batch, int m, int n, int k, void* stream) {\n"
                 f"  using Alg = {alg};\n"
                 "  return counting_tiles::launch_typed(\n"
                 "      layout, static_cast<const Alg::A*>(a), "
                 "static_cast<float*>(a32),\n"
                 "      static_cast<const Alg::B*>(b), "
                 "static_cast<float*>(b32),\n"
                 "      repro_semiring::MxuStore<Alg>{static_cast<Alg::Out*>"
                 "(out)}, b16, flag,\n"
                 "      counters, batch, m, n, k, stream);\n}\n")
    else:
        include += '#include "vpu_tiles.cuh"\n'
        entry = ("extern \"C\" int repro_semiring_vpu(const void* const* a, "
                 "const void* const* b,\n    void* const* out, void* counters, "
                 "int tile, int batch, int m, int n, int k,\n    void* stream) "
                 "{\n"
                 f"  return vpu_tiles::launch<{alg}>(a, b, out, "
                 "static_cast<int*>(counters),\n      tile, batch, m, n, k, "
                 "stream);\n}\n")
    return (f"// Generated by repro_torch.kernels.semiring from the Semiring "
            f"{sr.name!r}\n// ({', '.join(map(str, types))}).\n"
            f"{include}\n{struct}\n{entry}")


#: (spec, dtypes) -> the loaded entry point of its generated kernel
_GENERATED: Dict[tuple, object] = {}


def _generated_kernel(sr: Semiring, types: Tuple[torch.dtype, ...]):
    fn = _GENERATED.get((sr, types))
    if fn is None:
        from .build import load_generated

        lib = load_generated(build_key(sr, types), semiring_source(sr, types))
        if sr.mxu:
            fn = lib.repro_semiring_mxu
            fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _P]
        else:
            fn = lib.repro_semiring_vpu
            fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        _GENERATED[(sr, types)] = fn
    return fn


def _pad_slab(x: torch.Tensor, dim: int, width: int, value: float):
    short = width - x.shape[dim]
    if short == 0:
        return x
    shape = list(x.shape)
    shape[dim] = short
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def semiring_matmul_ref(sr: Semiring, a: Sequence[torch.Tensor],
                        b: Sequence[torch.Tensor], out_dtype=None) -> Fields:
    """Plain (M, K) x (K, N) product over ``sr``, one tensor per field.

    VPU path in the JAX kernel's order (``_vpu_block``): the accumulator
    starts at ``acc_init``; each ``sub_k = 8`` slab of K, in order, gives
    ``acc = accumulate(acc, kreduce(combine(a_slab, b_slab)))``, the last
    slab padded with ``pad_a``/``pad_b``; a block of rows at a time, so the
    (rows, 8, N) broadcast stays bounded. Fields keep ``a``'s dtypes. MXU
    path: ``epilogue(a.float() @ b.float())`` in IEEE fp32, cast to
    ``out_dtype`` or ``a[0]``'s dtype.
    """
    a, b = tuple(a), tuple(b)
    if sr.mxu:
        _ieee_fp32(a[0], b[0])
        acc = torch.matmul(a[0].float(), b[0].float())
        return (sr.epilogue(acc).to(out_dtype or a[0].dtype),)
    m, k = a[0].shape
    n = b[0].shape[1]
    outs = tuple(torch.empty((m, n), dtype=x.dtype, device=x.device)
                 for x in a)
    for lo, hi in _row_blocks(m, _SUB_K, n, sr.num_fields):
        acc = tuple(torch.full((hi - lo, n), v, dtype=x.dtype, device=x.device)
                    for v, x in zip(sr.acc_init, a))
        for k0 in range(0, k, _SUB_K):
            a_slab = tuple(_pad_slab(x[lo:hi, k0:k0 + _SUB_K], 1, _SUB_K,
                                     v)[:, :, None]
                           for x, v in zip(a, sr.pad_a))
            b_slab = tuple(_pad_slab(x[k0:k0 + _SUB_K], 0, _SUB_K, v)[None]
                           for x, v in zip(b, sr.pad_b))
            acc = sr.accumulate(acc, sr.kreduce(sr.combine(a_slab, b_slab)))
        for o, v in zip(outs, acc):
            o[lo:hi] = v
    return outs


def semiring_matmul_batched_ref(sr: Semiring, a: Sequence[torch.Tensor],
                                b: Sequence[torch.Tensor],
                                out_dtype=None) -> Fields:
    """Plain (B, M, K) x (B, K, N) product over ``sr``: the MXU path as one
    batched product, the VPU path one problem of the stack at a time."""
    a, b = tuple(a), tuple(b)
    if sr.mxu:
        return semiring_matmul_ref(sr, a, b, out_dtype)
    per = [semiring_matmul_ref(sr, tuple(x[z] for x in a),
                               tuple(x[z] for x in b))
           for z in range(a[0].shape[0])]
    if not per:
        return tuple(torch.empty((0, a[0].shape[1], b[0].shape[2]),
                                 dtype=x.dtype, device=x.device) for x in a)
    return tuple(torch.stack([p[f] for p in per])
                 for f in range(sr.num_fields))


def semiring_matmul(sr: Semiring, a: Sequence[torch.Tensor],
                    b: Sequence[torch.Tensor], out_dtype=None,
                    use_kernel: bool = True) -> Fields:
    """Blocked (M, K) x (K, N) product over any ``sr``, one tensor per
    field (the port of ``semiring_matmul_pallas``).

    Takes any M, N, K: ragged edges act as ``pad_a``/``pad_b``. On CUDA
    tensors it launches the kernel generated from ``sr``'s device code
    (built at first use; a spec without device code raises
    NotImplementedError); on CPU tensors, or with ``use_kernel=False``, it
    runs :func:`semiring_matmul_ref`. ``out_dtype`` is an MXU-path control.
    The kernel reads contiguous fields: others are copied first.
    """
    return _semiring(sr, a, b, out_dtype, use_kernel, batched=False)


def semiring_matmul_batched(sr: Semiring, a: Sequence[torch.Tensor],
                            b: Sequence[torch.Tensor], out_dtype=None,
                            use_kernel: bool = True) -> Fields:
    """Batched (B, M, K) x (B, K, N) product over ``sr``: one launch for the
    whole stack (the port of ``semiring_matmul_batched_pallas``); otherwise
    as :func:`semiring_matmul`."""
    return _semiring(sr, a, b, out_dtype, use_kernel, batched=True)


@functools.lru_cache(maxsize=None)
def _vpu_config(nf: int) -> Optional[Dict[str, int]]:
    """The large VPU tile's configuration for ``nf`` fields, as
    ``csrc/vpu_tiles.cuh``'s ``config`` computes it: output tile ``bm`` x
    ``bn`` (16 ``tm`` x 16 ``tn``), the thread's ``tm`` x ``tn`` micro-tile,
    ``kv`` k per read of A and ``bv`` n per read of B, the deepest K step
    ``bk`` at which two ring stages fit in the block's shared memory,
    ``stages`` (3 where they fit at that depth, else 2) and ``smem``, its
    dynamic shared memory in bytes. None past 12 fields, which keep the
    32 x 32 tile. Cached: every launch asks, so callers must not modify
    the dict."""
    shape = next((s for most, s in _VPU_SHAPES if nf <= most), None)
    if shape is None:
        return None
    tm, tn, kv, bv = shape
    bm, bn = 16 * tm, 16 * tn
    for bk in _VPU_BKS:
        stage = nf * (bm * (bk + 4) + bk * bn) * _VPU_FIELD_BYTES
        if 2 * stage <= _VPU_SMEM_MAX:
            stages = 3 if 3 * stage <= _VPU_SMEM_MAX else 2
            return dict(bm=bm, bn=bn, tm=tm, tn=tn, kv=kv, bv=bv, bk=bk,
                        stages=stages, smem=stages * stage)
    return None


def _vpu_tile(batch: int, m: int, n: int, nf: int) -> str:
    """The tile a VPU-path product of ``batch`` (m, n) outputs over ``nf``
    fields runs on, as the generated kernel's ``vpu_tiles::large_tile``
    decides on the host: "large" where the large tile's grid
    (:func:`_vpu_config`) has at least 256 blocks, about two per SM, else
    "small" (32 x 32), as always past 12 fields."""
    c = _vpu_config(nf)
    if c is None:
        return "small"
    blocks = batch * -(-m // c["bm"]) * -(-n // c["bn"])
    return "large" if blocks >= _VPU_LARGE_MIN_BLOCKS else "small"


#: the generated VPU entry point's tile argument
_VPU_TILE_ARG = {None: -1, "small": 0, "large": 1}


def _semiring(sr, a, b, out_dtype, use_kernel, batched, tile=None):
    """The two wrappers' body. ``tile`` ("small" or "large") makes a
    VPU-path product run on that tile whatever the grid (a private seam:
    the tiles agree bit for bit, and the card's checks hold them to it);
    None runs the tile :func:`_vpu_tile` picks."""
    a, b = tuple(a), tuple(b)
    nf, ndim = sr.num_fields, 3 if batched else 2
    if len(a) != nf or len(b) != nf:
        raise ValueError(f"{sr.name}: {len(a)} x {len(b)} fields, want {nf}")
    if out_dtype is not None and not sr.mxu:
        raise ValueError("out_dtype is an MXU-path control")
    lead = a[0].shape[:-1]
    if (a[0].ndim != ndim or b[0].ndim != ndim
            or any(x.shape != a[0].shape for x in a)
            or any(x.shape != b[0].shape for x in b)
            or a[0].shape[:-2] != b[0].shape[:-2]
            or a[0].shape[-1] != b[0].shape[-2]):
        raise ValueError(f"{sr.name}: fields must be {ndim}D products, one "
                         f"shape per operand: "
                         f"{[tuple(x.shape) for x in (*a, *b)]}")
    if not _use_kernel(use_kernel, *a, *b,
                       dtypes=[x.dtype for x in (*a, *b)]):
        return (semiring_matmul_batched_ref if batched
                else semiring_matmul_ref)(sr, a, b, out_dtype)
    _require_device_code(sr)
    types = device_types(sr, a, b, out_dtype)
    batch, m, n, k = _dims(a[0], b[0])
    if not sr.mxu:
        picked = tile or _vpu_tile(batch, m, n, nf)
        if picked == "large" and _vpu_config(nf) is None:
            raise ValueError(f"{sr.name}: no large VPU tile for {nf} fields")
        rows = _VPU_SMALL if picked == "small" else _vpu_config(nf)["bm"]
        if m > _MAX_GRID_Y * rows:
            raise ValueError(f"rows {m} exceed the launch grid")
    a = tuple(x.contiguous() for x in a)
    b = tuple(x.contiguous() for x in b)
    out = tuple(torch.empty((*lead, n), dtype=types[-1] if sr.mxu
                            else x.dtype, device=x.device) for x in a)
    if out[0].numel() == 0:
        return out
    fn = _generated_kernel(sr, types)
    stream = torch.cuda.current_stream(a[0].device).cuda_stream
    if sr.mxu:
        rc = _mxu_launch(fn, a[0], b[0], out[0], batch, m, n, k, stream)
    else:
        ptrs = [(_P * nf)(*(x.data_ptr() for x in xs)) for xs in (a, b, out)]
        rc = fn(*ptrs, _tile_counts(a[0].device, "semiring_matmul_vpu"),
                _VPU_TILE_ARG[tile], batch, m, n, k, stream)
    _check(rc, f"semiring_matmul ({sr.name})")
    launches["semiring_matmul"] += 1
    return out


#: alignment of each part of the generic MXU path's scratch, in bytes
_SCRATCH_ALIGN = 256


def _mxu_launch(fn, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                batch: int, m: int, n: int, k: int, stream: int) -> int:
    """One launch of a generated MXU-path kernel (``count_matmul``'s tiles)
    on contiguous operands of any of its dtypes, with its scratch in one
    allocation: the bf16 copy of ``b``, the tile flag, an fp32 copy of
    ``a`` unless it is fp32 and an fp32 copy of an int32 ``b`` (tile (a)'s
    operand; a uint8 ``b`` always takes tile (b)). Returns the kernel's
    status."""
    kp = -(-k // _TILE_K) * _TILE_K
    np_ = -(-n // _TILE_N) * _TILE_N
    sizes = [batch * kp * np_ * 2, 4,
             0 if a.dtype == torch.float32 else a.numel() * 4,
             b.numel() * 4 if b.dtype == torch.int32 else 0]
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += -(-size // _SCRATCH_ALIGN) * _SCRATCH_ALIGN
    scratch = torch.empty(total, dtype=torch.uint8, device=a.device)
    b16, flag, a32, b32 = (scratch.data_ptr() + off for off in offsets)
    a32 = a32 if sizes[2] else a.data_ptr()
    b32 = b32 if sizes[3] else None
    layout = _a_layout(a, b, vec=(a32 % 16 == 0
                                  and (b32 or b.data_ptr()) % 16 == 0))
    return fn(layout, a.data_ptr(), a32, b.data_ptr(), b32, out.data_ptr(),
              b16, flag, _tile_counts(a.device, "semiring_matmul"), batch, m,
              n, k, stream)


def _tc_combine(a: Fields, b: Fields) -> Fields:
    return (a[0] + b[0], a[1] * b[1])


def _amin_nan(f: torch.Tensor) -> torch.Tensor:
    """``jnp.min(f, axis=1)``: NaN propagates and -0 ranks below +0
    (``torch.amin`` keeps whichever zero it meets first). A zero minimum
    means no element along k is below zero, so a sign bit there is a -0."""
    d = torch.amin(f, dim=1)
    if not d.is_floating_point():
        return d
    return torch.where((d == 0) & torch.signbit(f).any(dim=1), -0.0, d)


def _tc_kreduce(f: Fields) -> Fields:
    d = _amin_nan(f[0])
    c = torch.where(f[0] == d[:, None, :], f[1], 0.0).sum(dim=1)
    return (d, c)


def _tc_accumulate(x: Fields, y: Fields) -> Fields:
    d = _min_nan(x[0], y[0])
    c = torch.where(x[0] == d, x[1], 0.0) + torch.where(y[0] == d, y[1], 0.0)
    return (d, c)


_INF = float("inf")

#: (min, +) over distances — the APSP hot spot
TROPICAL = Semiring(
    name="tropical",
    pad_a=(_INF,), pad_b=(_INF,), acc_init=(_INF,),
    combine=lambda a, b: (a[0] + b[0],),
    kreduce=lambda f: (_amin_nan(f[0]),),
    accumulate=lambda x, y: (_min_nan(x[0], y[0]),),
    cuda_combine="out[0] = a[0] + b[0];",
    cuda_accumulate="acc[0] = sr_fmin_nan(acc[0], t[0]);",
)

#: (or, and) over {0,1} masks — the fp32 dot thresholded in the epilogue
BOOLEAN = Semiring(
    name="boolean",
    pad_a=(0.0,), pad_b=(0.0,), acc_init=(0.0,),
    mxu=True,
    epilogue=lambda acc: acc > 0.5,
    cuda_epilogue="acc > 0.5f",
)

#: (+, x) over nonneg counts — exact while counts stay below 2**24
COUNTING = Semiring(
    name="counting",
    pad_a=(0.0,), pad_b=(0.0,), acc_init=(0.0,),
    mxu=True,
    epilogue=lambda acc: acc,
    cuda_epilogue="acc",
)

#: fused (dist, count) pairs: lexicographic (min, +) on dist with counts
#: summed over ties; pads (inf, 0) never contribute
TROPICAL_COUNT = Semiring(
    name="tropical_count",
    num_fields=2,
    pad_a=(_INF, 0.0), pad_b=(_INF, 0.0), acc_init=(_INF, 0.0),
    combine=_tc_combine,
    kreduce=_tc_kreduce,
    accumulate=_tc_accumulate,
    cuda_combine="out[0] = a[0] + b[0]; out[1] = a[1] * b[1];",
    # _tc_accumulate's form, without branches: the NaN-propagating min, and
    # the counts of both sides that attain it (a NaN min attains nothing)
    cuda_accumulate=("const T d = sr_fmin_nan(acc[0], t[0]);\n"
                     "    acc[1] = (acc[0] == d ? acc[1] : T(0)) + "
                     "(t[0] == d ? t[1] : T(0));\n"
                     "    acc[0] = d;"),
)

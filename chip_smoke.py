#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port, ``repro_torch``.

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc/``, holds each
against its plain PyTorch version on the card, runs the equal-cost sweep at
the committed configuration (checked against
``experiments/sweep/comparison.json``) and at full width (~10k servers,
12 families padded to 2048 routers), once on the kernels and once on the
plain versions, and checks that the full-width run went through both
kernels the expected number of times. Phase 6 runs the analysis path of
``examples/topology_analysis.py`` at full width: ``AnalysisEngine.report()``
on six families at ~10k servers and the max-concurrent-flow throughput on
two at ~2k servers, held to ``experiments/analysis/reference.json`` (made
by the JAX package), and checks that it went through all five kernels.
Phase 7 runs the extreme-scale path: the sampled sweep at 4096 routers
held to ``experiments/extreme/reference.json`` (made by the JAX package),
six families at ~100k routers with the adjacency resident, dragonfly
again with it streamed, and the packed wavefront on phase 5's stack, and
checks that it went through the three narrow-cell kernels. Phase 8 runs
the kernel library, ``repro_torch.kernels.ops`` (each of its eleven ops
once against its ``_ref`` alias, on non-fp32 inputs), the sweep's stacked
min-plus squaring APSP (``core.sweep._apsp_from_stack``) on phase 5's
stack against the wavefront, and boolean reachability closures against
the wavefront's ``isfinite(dist)``, and checks that it went through the
boolean and batched min-plus kernels (the squarings on the large min-plus
tile). Phase 9 drives the ``Semiring`` extension point
(``kernels.semiring.semiring_matmul`` and ``semiring_matmul_batched``): it
builds the kernels generated from sixteen algebras' and dtypes' device
code (VPU-path algebras over ``csrc/vpu_tiles.cuh`` and
``csrc/semiring_generic.cuh``, MXU-path ones over
``count_matmul``'s GEMM, ``csrc/counting_tiles.cuh``), holds the generic
kernel bit-equal to the specialized kernels on the four shipped algebras
and to its plain version on user algebras (max-plus, max-min, an MXU
algebra on narrow operands), runs the MXU path on every operand form
(uint8 x uint8, int32 and non-finite right operands, a float left one)
with each pick of tile read from the device counters, runs every VPU
product on the tile its grid picks (``csrc/vpu_tiles.cuh``'s register-
blocked tile or the 32 x 32 tile, read from the device counters), holds
the two VPU tiles bit-equal to each other on every algebra (algebras of
3, 8 and 16 fields in float32 and int32, a float sum-product, odd shapes
on unaligned bases, NaN inputs), checks that a spec
without device code raises on the card, and times it beside the
specialized kernels, ``torch.mm``/``torch.bmm`` and its bound. Phase 3 holds all ten kernels
(``csrc/semiring.cu``: frontier step, counting and boolean products;
``csrc/tropical.cu``: min-plus 2D and batched, tropical count;
``csrc/seghist.cu``; ``csrc/packed.cu``: packed step 2D and batched,
narrow product, on the int8 tensor cores) to their plain versions and
times them; the packed ones also at a uint8 right operand up to 255 past
33,025 k (the limb sums fold), frontier cells at 2**31 - 1 and bases off
the 16-byte grid. The counting
products run on two tiles, picked on the device from whether the right
operand is exact in bf16: phase 3 holds the SIMT tile bit-equal to the
generic COUNTING kernel on a float operand, the tensor-core tile
bit-equal to the plain version with sums in [2**23, 2**24) and within
rtol 1e-5 on the float z x adj product, and sends an inexact or
non-finite right operand to the SIMT tile; phase 5 reads the per-tile
device counters of the sweep. Phases 3 and 9 feed NaN to the min-plus
kernels and the generic TROPICAL / TROPICAL_COUNT kernels, NaN-equal to
their plain versions. The min-plus products run on two tiles picked on
the host from the grid and K (``_minplus_plan``): phases 3 and 8 hold
the batched product bit-equal to its plain version on both (B=12 at
2048^3 and ragged on the large tile, NaN inputs on each) and read which
tile ran from the device counters; phase 3 holds both products of the
split tile (K split over a thread-block cluster) bit-equal to their plain
versions at p = 384..1536, ragged and B=3, on the host's split and on
forced splits, with -0 and +0 in both operands and NaN inputs. Phase 9
feeds -0 and +0 to the generic TROPICAL / TROPICAL_COUNT kernels on
every tile, sign bits compared with their plain versions. Phase 3 holds
the value histogram (one launch, one shared histogram per block) equal
to its plain version
at storage offsets 1-3, n = 1, 3, 5, (4096, 4096) and 4096 and 12,288
bins, and times it L2-warm and L2-cold beside its byte bound. Phase 10
runs the routing path (``core.routing``, ``core.traffic``,
``core.workload``) on the ported kernels, counted: (a) the routing table
of ``examples/topology_analysis.py`` (six families at ~10k servers: a
``permutation:flows=2048`` workload sampled and evaluated, and the exact
ECMP, Valiant and slack-1 loads of its demand), each model held on every
link to its f64 path on the card within rtol 1e-5, each row to
``experiments/routing/reference.json`` (made by the JAX package), and
each model's counting launches to the number its term list predicts;
(b) the demand-weighted Brandes engine on dragonfly against a
200-sample hotspot stack, held to its f64 path; (c) the same engine on
phase 5's stack under a demand of ones, bit-equal to the uniform
all-pairs loads; (d) ``max_concurrent_flow`` under a ``TrafficSpec``,
bit-equal to the call on its matrix and held to the reference. Phase 11
runs the resilience and traffic path (``core.resilience``,
``core.traffic.scenarios`` and ``grid``, the sweep's ``traffic=``) on the
ported kernels, each part counted, run on the kernels and again on the
float64 oracle, and its launches held to the number the counted run's own
wavefront diameters predict: (a) ``experiments/resilience/
degradation.json`` and ``experiments/congestion/grid.json`` (made by the
JAX package) reproduced; (b) ``python -m repro_torch.core.resilience
--check`` and ``python -m repro_torch.core.traffic --check`` at their
defaults; (c) one degradation point and the ``--traffic`` sweep at the
sweep's full width; (d) ``saturation_search`` (a ring's tornado closed
form, hotspot on a dragonfly). The slack counts are held to the f64 path
only where a float64 walk-count bound stays below 2**24. Phase 12 runs
the mesh engines (``core.analysis.distributed`` on ``torch.distributed``)
on two gloo ranks sharing the one card, spawned by ``launch_mesh`` and
counted in each rank: (a) the row-sharded sweep at phase 5's full width
(12 families padded to 2048, 1024 rows a rank), its rows equal to phase
5's, and at phase 4's committed configuration, held to
``experiments/sweep/comparison.json``; (b) the composed extreme sweep,
packed, on 7b's ~100k dragonfly (32 sampled sources, each rank's
adjacency rows resident), its row equal to 7b's resident run; (c)
``AnalysisEngine(mesh=)`` on an example family at ~10k servers, equal to
the single-device engine; (d) ``pod_traffic_report`` on the default
16 x 16 torus against its float64 path; (e) each kernel at the rank's
shapes (the frontier step on its (12, 1024, 2048) block, both Brandes
products over its rows, the narrow product of its packed K-slab) bit-equal
to its plain version; and each rank's bytes all-reduced held to the
engines' rule. It prints each rank's launches, walls and peak device
memory, and claims no speed: the two ranks share one card.
Phase 13 runs the serving path of the LM substrate (``repro_torch.configs``,
``models``, ``launch.serve``), which launches none of the kernels: (a) the
port held to ``experiments/serve/reference.json`` (made by the JAX
package) on weights rebuilt by the file's numpy rule, for gemma-2b,
phi3-mini-3.8b and qwen1.5-32b cut to two layers: prefill and
teacher-forced decode logits and the ``Server``'s decode calls in float32
and bfloat16, and the int8-cache decode logits; (b) gemma-2b at full width
(18 layers, ~2.5 B parameters, bf16 weights drawn on the card): the
``Server`` answers 8 requests, prefill of 512 tokens against
teacher-forced decode (layer 0's caches held), the flash forward over 2 x 2
chunks of a 2048-token prompt against ``chunked_attention`` in float32;
it prints the decode step's median time, tokens/s, the busy share of 10
profiled decode steps, peak device memory and the weight-read bound, and
claims no speed.
Phase 14 runs the training path of the LM substrate (``optim``, the flash
backward, ``lm_loss``, ``steps.make_train_step``, ``data``,
``checkpoint``), which launches none of the kernels either: (a) the port
held to ``experiments/train/reference.json`` (made by the JAX package):
the three reference configs in float32 and bfloat16, the first step's
loss and gradients, the params after one AdamW step, a 5-step
trajectory, accum_steps=2 and remat "none" against "full"; (b)
``examples/train_100m.py``'s configuration (110,119,680 parameters) for
its 300 steps, held to the example's ``last < first - 0.5``, then N
steps straight against N with a save/restore at N/2 in a subprocess under
deterministic algorithms, bit-equal; (c) gemma-2b at full width (remat
full, float32 master and moments, ~49 GiB) for 2 steps of 2048 tokens,
finite and moving, and the flash backward at its attention shapes
against autograd through ``chunked_attention``; (d) with
``allow_bf16_reduced_precision_reduction`` on, the train and decode steps
refuse a CUDA model. It prints each step's median time against the 6 N T
bound at the bf16 peak, tokens/s, the busy share of a short profiled
window and peak device memory, and claims no speed.
Phase 15 runs the other layer kinds of the LM substrate (the MoE local
path, the Mamba-2 SSD mixer, the Jamba hybrid pattern, PaliGemma's
prefix, Whisper's encoder-decoder), which launch none of the kernels:
(a) the port held to ``experiments/layers/reference.json`` (made by the
JAX package) for granite-moe-1b-a400m, mamba2-370m, jamba-1.5-large-398b,
whisper-tiny and paligemma-3b, each ``.reduced()`` on conditioned weights
(``convert.conditioned_params``), in float32 and bfloat16: the prefill's
last-token logits, teacher-forced decode
continuing from a prefill's caches, each MoE layer's routing above a
margin, what the ``Server`` serves, and one train step's loss, grad_norm
and every leaf's gradient (in bfloat16 also the whole gradient's distance
from float32, so that float32 arithmetic fails), under the tolerances that
``experiments/layers/conditioning.py`` measures; (b) granite-moe-1b-a400m,
mamba2-370m, whisper-tiny and paligemma-3b at full width (bf16 weights
drawn on the card): the ``Server`` answers 8 requests, the decode step is
timed against its byte bound (for MoE the experts its routing touches),
and a prefill of half a prompt (after 1500 frames or 256 prefix
embeddings) continued by teacher-forced decode holds layer 0's caches or
SSM state to the prefill of the whole prompt; (c) the same four train 2
steps of one 2048-position sequence (remat full), timed against 6 N T;
(d) the exact-GEMM guard refuses an MoE, an SSM and an enc-dec step.
Phase 16 runs ``sharding/`` on four gloo ranks sharing the card
(``distributed.launch_mesh``), which launch none of the kernels: (a)
``sharding.mesh_cases`` held to ``experiments/sharding/reference.json``
(made by the JAX package on four fake CPU devices): ``shard_tree`` blocks
bit-equal to ``addressable_shards``, the expert-parallel MoE in each
branch, the seq-sharded decode, ``pipeline_apply``, the int8 compressed
step and its exchange, two sharded train steps each of gemma-2b and
granite-moe-1b-a400m; the plans, spec trees and launch costs of the ten
archs; (b) granite-moe-1b-a400m at full width trained one step by
``launch.train.build_trainer`` on a 2 x 2 mesh (FSDP over data, EP over
model), its full-width EP layer held to ``_moe_local``; (c) gemma-2b
decoding at full width, each rank on its blocks of the weights (the MLP
and the vocabulary over model) with its 256-slot cache sequence-sharded
over 4 ranks, layer 0 held to the whole layer's gathered decode; (d) the
int8 pod-compressed step at train_100m.py's configuration beside the
uncompressed one. It prints step times, each rank's peak memory and the
bytes each collective moved, and claims no speed (the ranks share one
card). Phase 18, on the same ranks, serves under a plan on each rank's
blocks of the weights and caches (tensor parallelism over model): (a)
``sharding.mesh_cases``' ``tp`` cases (MHA, GQA with qkv bias, MQA under
both decode forms, MoE; ``.reduced()``) held to the reference's JAX
sharded steps and to the port's unsharded steps, each rank's storage to
its blocks' bytes; (b) phi3-mini-3.8b at full width on (data, model) =
(1, 4) and (c) yi-34b at full width cut to 8 of its 60 layers on (2, 2)
(FSDP over data): a 64-token prefill, then 64 and 16 decode steps, each
rank's weights and caches held to its blocks' bytes and layer 0's
prefill caches to rank 0's whole-model oracle; times, peaks and each
collective's bytes and wall a step printed.
Phase 17 runs the dry run and the autotuner (``launch.dryrun``,
``kernels.autotune``): (a) in a child process that sees no card, phase
16's three cells and 18b's decode traced on meta tensors in a fake
process group of their meshes' ranks, each collective kind's bytes a step
held equal to what phases 16 and 18 measured on rank 0, the argument
bytes to the step's resident
state and batch, and the predicted peak (arguments + temp) to within
[0.8, 1.25] of the step's own peak; (b) in the same child, gemma-2b's
``train_4k`` and ``decode_32k`` and hill-climb's ``podfsdp`` on the
production meshes, held to ``experiments/dryrun/reference.json`` (made by
the JAX package) in plan notes, the analytic roofline and the argument
bytes of the JAX step's spec trees; (c) on the card, the min-plus tile
and split picks tuned into a temporary table (``minplus`` and
``minplus_count`` at p = 512, ``batched_minplus`` at B=12, 2048), every
candidate bit-equal to the default pick and timed beside it, and the
next op call on the winner's tile counter.
Every phase prints its wall (``[wall]`` lines).

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

The second-to-last line of output is a JSON summary of the kernels (times,
bounds, launches); the last line is ``{"ok": true, "device": {...}}``. Any
failed check ends the run with a nonzero exit and no result line, as does a
machine without a CUDA device or a directory without the package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
EXACT = 2.0 ** 24  # f32 counts are exact integers below this

# Published peaks (NVIDIA H100 data sheet, dense, at the full power limit):
# IEEE fp32 on the CUDA cores, and device-memory bandwidth.
PEAKS = {"SXM": (67e12, 3.35e12), "PCIe": (51e12, 2.0e12),
         "NVL": (60e12, 3.9e12)}


#: fp32 operations that are not fused multiply-adds (an add, a min, a
#: compare) execute at one per lane per clock: half the FMA-counted peak
NON_FMA = 0.5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def part_of(name: str) -> str:
    """H100 form factor from the device name ("H100 80GB HBM3" is SXM)."""
    for part in ("PCIe", "NVL"):
        if part.lower() in name.lower():
            return part
    return "SXM"


def timed_ms(fn, iters: int = 10, warmup: int = 2, before=None) -> float:
    """Median time of one call, by CUDA events around each call (each
    after ``before`` has run to its end, outside the events, if given)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if before is not None:
            before()
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(fn):
    """Run ``fn`` under torch.profiler with CPU and CUDA activity; returns
    (the profile's device kernel rows, host wall ms of the window). Each
    row is (name, launches, device ms in total)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[2]), wall


def kernel_device_ms(fn, marker: str, reps: int = 20, tries: int = 1,
                     seen: list | None = None):
    """Device time of one launch of the kernel whose name holds ``marker``,
    from a profile of ``reps`` calls of ``fn``, profiled again up to
    ``tries`` times while that kernel is missing; None when no profile
    holds it (no device activity recorded). ``seen``, if given, receives
    the last profile's rows."""
    for attempt in range(tries):
        if attempt:
            print(f"  (no device row for {marker!r} in profile {attempt}; "
                  f"profiling again)")
        rows, _ = profiled(lambda: [fn() for _ in range(reps)])
        if seen is not None:
            seen[:] = rows
        hits = [(c, t) for name, c, t in rows if marker in name]
        if hits and sum(t for _, t in hits) > 0:
            return sum(t for _, t in hits) / sum(c for c, _ in hits)
    return None


def queued_device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn`` that launches one kernel, without
    the profiler: CUDA events recorded around the call while the card is
    still busy with a spin kernel (about 2.5 ms), so that the host's time
    to enqueue the call is hidden and the events time only its device
    work (a few microseconds of event overhead included); median of
    ``reps``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, part: str):
    """Least time for the work on this part, and what bounds it."""
    peak_flops, peak_bw = PEAKS[part]
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# -- phase 3: each kernel against its plain version ------------------------------

def _inputs(gen, b, m, n, k):
    """BFS- and ECMP-like operands: sparse integer counts f (b,m,k) and
    g (b,k,m), a {0,1} adjacency a (b,k,n), distances d (b,m,n) half +inf,
    and a sparse float operand z (b,k,n) in (0, 1)."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def counts(*shape):
        x = torch.randint(1, 4, shape, generator=gen, device="cuda").float()
        return x * (rand(*shape) < 0.3)

    f, g = counts(b, m, k), counts(b, k, m)
    a = (rand(b, k, n) < 0.05).float()
    d = torch.where(rand(b, m, n) < 0.5, float("inf"),
                    torch.randint(0, 5, (b, m, n), generator=gen,
                                  device="cuda").float())
    z = rand(b, k, n) * (rand(b, k, n) < 0.25)
    return f, g, a, d, z


def kernel_checks(S, part):
    """Both kernels, 2D and batched, at the sweep's shape and two ragged
    ones: bit-equal to the plain version on integer inputs, rtol 1e-5 on
    the float ECMP-like operand, read transposed through its strides
    (g^T x z, the SIMT tile) and as a contiguous left operand against the
    adjacency (z x a, the tensor-core tile). Then times at the sweep's
    shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    gen_z = torch.Generator(device="cuda").manual_seed(1)
    main_ops = None
    errs = {"frontier_step": 0.0, "count_matmul": 0.0,
            "count_matmul (z, adj)": 0.0}
    for b, m, n, k in ((12, 2048, 2048, 2048), (3, 200, 200, 200),
                       (2, 200, 136, 72)):
        ops = _inputs(gen, b, m, n, k)
        for batched in (True, False):
            f, g, a, d, z = ops if batched else (x[0] for x in ops)
            gt = g.transpose(-1, -2)
            tag = (f"B={b} " if batched else "2D ") + f"{m}x{n}x{k}"
            x, x_ref = S.frontier_step(f, a, d), S.frontier_step_ref(f, a, d)
            c = S.count_matmul(f, a)
            c_ref = (S.batched_count_matmul_ref(f, a) if batched
                     else S.count_matmul_ref(f, a))
            ct, ct_ref = S.count_matmul(gt, z), S.count_matmul_ref(gt, z)
            # the second Brandes product's form: a float left operand like z,
            # (.., m, k), against the {0,1} adjacency
            zl = torch.rand(f.shape, generator=gen_z, device="cuda") * (
                torch.rand(f.shape, generator=gen_z, device="cuda") < 0.25)
            cz, cz_ref = S.count_matmul(zl, a), S.count_matmul_ref(zl, a)
            torch.cuda.synchronize()
            check(torch.equal(x, x_ref), f"frontier_step {tag}: not bit-equal")
            check(bool((x > 0).any()), f"frontier_step {tag}: all zero")
            check(torch.equal(c, c_ref), f"count_matmul {tag}: not bit-equal")
            check(torch.allclose(ct, ct_ref, rtol=1e-5, atol=0.0),
                  f"count_matmul {tag} transposed float: beyond rtol 1e-5")
            check(torch.allclose(cz, cz_ref, rtol=1e-5, atol=0.0),
                  f"count_matmul {tag} (z, adj): beyond rtol 1e-5")
            err_z = float((cz - cz_ref).abs().max())
            rel_z = float(((cz - cz_ref).abs() / cz_ref.abs().clamp_min(
                torch.finfo(torch.float32).tiny)).max())
            errs["count_matmul (z, adj)"] = max(errs["count_matmul (z, adj)"],
                                                err_z)
            err_f = float((x - x_ref).abs().max())
            err_c = max(float((c - c_ref).abs().max()),
                        float((ct - ct_ref).abs().max()))
            errs["frontier_step"] = max(errs["frontier_step"], err_f)
            errs["count_matmul"] = max(errs["count_matmul"], err_c)
            print(f"  {tag:22s} frontier_step max_abs_err={err_f:g}  "
                  f"count_matmul max_abs_err={err_c:g}  (z, adj) "
                  f"max_abs_err={err_z:g} max_rel_err={rel_z:g}")
            if batched and main_ops is None:
                main_ops = (f, gt, a, d, z)
    tile_checks(S, main_ops)

    f, gt, a, d, z = main_ops
    m, k, n = f.shape[-2], f.shape[-1], a.shape[-1]
    out = {}
    for batched in (True, False):
        # the sweep's launches are batched; the 2D form is the same kernel
        # with B = 1, timed for the record
        ff, gg, aa, dd, zz = ((f, gt, a, d, z) if batched
                              else (f[0], gt[0], a[0], d[0], z[0]))
        bsz = ff.shape[0] if batched else 1
        library = torch.bmm if batched else torch.mm
        flops = 2.0 * bsz * m * n * k
        cases = {  # name -> (kernel, plain, lhs, rhs, bytes, tile)
            "frontier_step": (lambda: S.frontier_step(ff, aa, dd),
                              lambda: S.frontier_step_ref(ff, aa, dd), ff, aa,
                              4.0 * (ff.numel() + aa.numel() + 2 * dd.numel()),
                              "tensor"),
            "count_matmul": (lambda: S.count_matmul(gg, zz),
                             lambda: S.count_matmul_ref(gg, zz), gg, zz,
                             4.0 * (gg.numel() + zz.numel() + dd.numel()),
                             "simt"),
            # Z x A, the second Brandes product: contiguous left operand, a
            # {0,1} right one, so the tensor-core tile
            "count_matmul (z, adj)": (lambda: S.count_matmul(zz, aa),
                                      lambda: S.count_matmul_ref(zz, aa), zz,
                                      aa, 4.0 * (zz.numel() + aa.numel()
                                                 + dd.numel()), "tensor"),
        }
        for name, (kern, plain, lhs, rhs, nbytes, tile) in cases.items():
            before = tile_counts(S)
            ms, plain_ms = timed_ms(kern), timed_ms(plain)
            took = {t: n for t, n in tile_counts(S).items() if n > before[t]}
            key = name.split(" ")[0]
            check(set(t for (e, t) in took if e == key) == {tile},
                  f"{name}: ran on tiles {took}, expected {tile}")
            library_ms = timed_ms(lambda: library(lhs, rhs))
            bms, by = tile_bound_ms(tile, flops, nbytes, part)
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bms, bound_by=by, max_abs_err=errs[name],
                       tile=tile)
            if batched and name == "count_matmul (z, adj)":
                out["count_matmul"]["tensor_route"] = row
            elif batched:
                out[name] = row
            shape = (f"B={bsz} " if batched else "2D ") + f"{m}x{n}x{k}"
            # device time of the call's three kernels: the bf16 copy of B,
            # the tile that ran, the other tile's launch that returns at once
            other = "tc" if tile == "simt" else "simt"
            dev = [kernel_device_ms(kern, marker, reps=5) for marker in
                   ("to_bf16", f"{'tc' if tile == 'tensor' else 'simt'}_tile",
                    f"{other}_tile")]
            dev = ", ".join("not measured" if t is None else f"{t:.4f} ms"
                            for t in dev)
            print(f"  {name} {shape}, tile {tile}: {ms:.3f} ms (plain "
                  f"{plain_ms:.3f}, torch.{library.__name__} "
                  f"{library_ms:.3f}, bound {bms:.3f} by {by}; fp32-equivalent "
                  f"{flops / ms / 1e9:.1f} TFLOP/s); device: bf16 copy, "
                  f"tile, empty launch of the other tile {dev}")
    return out


#: tensor-core peak of the bf16 products (dense, H100 SXM data sheet)
BF16_PEAK = {"SXM": 989e12, "PCIe": 756e12, "NVL": 835e12}
#: tensor-core peak of the int8 products, dense (NVIDIA H100 data sheet:
#: SXM 3,958, PCIe 3,026, NVL 3,341 TOPS with sparsity, halved)
INT8_PEAK = {"SXM": 1979e12, "PCIe": 1513e12, "NVL": 1670.5e12}


def tile_bound_ms(tile, flops, nbytes, part):
    """The bound of a counting product on the route its tile takes: fp32
    FMAs on the CUDA cores (simt), or three bf16 passes on the tensor cores
    (tensor), against the bytes either way."""
    if tile == "simt":
        return bound_ms(flops, nbytes, part)
    t_ops = 3.0 * flops / BF16_PEAK[part] * 1e3
    t_bytes = nbytes / PEAKS[part][1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tile_counts(S):
    """(entry point, tile) -> launches, from the device counters (one host
    sync: outside timed windows)."""
    return {(e, t): n for e, c in S.tile_launches().items()
            for t, n in c.items()}


def tile_checks(S, main_ops):
    """The two counting tiles against the plain version and each other:
    (a) the SIMT tile on the float transposed operand (gt, z) bit-equal to
    the generic COUNTING kernel, whose k order it keeps; (b) the
    tensor-core tile on integer counts whose sums land in [2**23, 2**24)
    bit-equal to the plain version, 2D and B=12; a right operand that is
    not exact in bf16 forced onto tile (a). Each case reads the device
    counters to see which tile ran."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    f, gt, a, d, z = main_ops

    def ran(fn):
        before = tile_counts(S)
        out = fn()
        after = tile_counts(S)
        return out, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    ct, took = ran(lambda: S.count_matmul(gt, z))
    generic = S.semiring_matmul_batched(S.COUNTING, (gt.contiguous(),), (z,))
    torch.cuda.synchronize()
    check(took == {("count_matmul", "simt"): 1},
          f"count_matmul (gt, z): tiles {took}, expected simt")
    check(torch.equal(ct, generic[0]), "tile (a) (gt, z): not bit-equal to "
                                       "the generic COUNTING kernel")
    print(f"  tile (a) B={gt.shape[0]} count_matmul(gt, z), column-major "
          f"float operand: bit-equal to the generic COUNTING kernel")

    for lead in ((12,), ()):
        p = a.shape[-1]
        big = torch.randint(2 ** 23 // p, 2 ** 24 // p, (*lead, p, p),
                            generator=gen, device="cuda").float()
        dense = (torch.rand((*lead, p, p), generator=gen, device="cuda")
                 < 0.9).float()
        dist = torch.where(torch.rand((*lead, p, p), generator=gen,
                                      device="cuda") < 0.5, float("inf"), 1.0)
        c, took_c = ran(lambda: S.count_matmul(big, dense))
        x, took_x = ran(lambda: S.frontier_step(big, dense, dist))
        c_ref = S.count_matmul_ref(big, dense)
        torch.cuda.synchronize()
        tag = (f"B={lead[0]} " if lead else "2D ") + f"{p}^3"
        check(took_c == {("count_matmul", "tensor"): 1}
              and took_x == {("frontier_step", "tensor"): 1},
              f"tile (b) {tag}: tiles {took_c} {took_x}")
        check(torch.equal(c, c_ref), f"tile (b) {tag}: count_matmul near "
                                     f"2**24 not bit-equal")
        check(torch.equal(x, S.frontier_step_ref(big, dense, dist)),
              f"tile (b) {tag}: frontier_step near 2**24 not bit-equal")
        share = float(((c_ref >= 2 ** 23) & (c_ref < 2 ** 24)).float().mean())
        check(share > 0.5 and float(c_ref.max()) < 2 ** 24,
              f"tile (b) {tag}: sums not in [2**23, 2**24)")
        print(f"  tile (b) {tag} count_matmul and frontier_step: bit-equal, "
              f"{100 * share:.1f}% of sums in [2**23, 2**24), largest "
              f"{float(c_ref.max()):.0f}")
    del big, dense, dist, c, x, c_ref

    # a right operand bf16 cannot hold: the device flag sends it to tile (a)
    weighted = a[0].clone()
    weighted.view(-1)[::7919] = 1.0 + 2.0 ** -10
    c, took = ran(lambda: S.count_matmul(f[0], weighted))
    generic = S.semiring_matmul(S.COUNTING, (f[0],), (weighted,))
    torch.cuda.synchronize()
    check(took == {("count_matmul", "simt"): 1},
          f"count_matmul, inexact right operand: tiles {took}, expected simt")
    check(torch.equal(c, generic[0]), "forced tile (a): not bit-equal to the "
                                      "generic COUNTING kernel")
    print("  forced tile (a): a right operand with 1 + 2**-10 took the SIMT "
          "tile, bit-equal to the generic COUNTING kernel")

    # a right operand with +-inf and NaN cells, bf16-exact in their top 16
    # bits: the device flag sends it to tile (a), where fmaf gives inf (the
    # tensor cores would meet zero limbs: 0 * inf = NaN)
    special = a.clone()
    for i, v in enumerate((float("inf"), -float("inf"), float("nan"))):
        special.view(-1)[i * 104729::3 * 104729] = v
    for lhs, rhs, tag in ((f[0], special[0], "2D"),
                          (f, special, f"B={f.shape[0]}")):
        c, took = ran(lambda: S.count_matmul(lhs, rhs))
        c_ref = S.count_matmul_ref(lhs, rhs)
        torch.cuda.synchronize()
        check(took == {("count_matmul", "simt"): 1},
              f"count_matmul {tag}, non-finite right operand: tiles {took}, "
              f"expected simt")
        check(nan_equal(c, c_ref), f"count_matmul {tag}, non-finite right "
                                   f"operand: differs from its plain version")
        check(bool(torch.isinf(c_ref).any()) and bool(torch.isnan(c_ref).any()),
              f"count_matmul {tag}, non-finite right operand: no inf and NaN "
              f"in the plain version")
        print(f"  non-finite right operand {tag}: took the SIMT tile, "
              f"NaN-equal to the plain version ({int(torch.isinf(c).sum())} "
              f"inf, {int(torch.isnan(c).sum())} NaN cells)")


def _abs_err(x, y):
    """Largest |x - y| where the two differ (equal +inf cells count 0)."""
    if x.numel() == 0:
        return 0.0
    return float(torch.where(x == y, 0.0, (x.float() - y.float()).abs()).max())


def _lengths(gen, shape, p_inf, integer=False):
    """Edge-length-like fp32 operands: uniform in [0.5, 4) (or integers in
    [0, 4)) with a share of +inf holes."""
    if integer:
        x = torch.randint(0, 4, shape, generator=gen, device="cuda").float()
    else:
        x = 0.5 + 3.5 * torch.rand(shape, generator=gen, device="cuda")
    holes = torch.rand(shape, generator=gen, device="cuda") < p_inf
    return torch.where(holes, float("inf"), x)


def tropical_checks(S, H, part):
    """The min-plus, tropical-count and histogram kernels against their
    plain versions: bit-equal (min is exact in any order; counts below
    2**24 and histogram bins are integers), at the main path's shapes and
    at ragged ones with +inf, NaN, negative and >= num_bins inputs. Then
    times at the main path's shapes: p = 512 (fattree's padded squaring
    seed) and a (1536, 1536) distance matrix into 65 bins."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {"minplus_matmul": 0.0, "minplus_count_matmul": 0.0,
            "value_histogram": 0.0}
    for m, n, k in ((512, 512, 512), (200, 136, 72), (33, 65, 1),
                    (1, 1, 100)):
        a = _lengths(gen, (m, k), 0.5)
        b = _lengths(gen, (k, n), 0.5)
        a[0] = float("inf")  # an unreached row stays unreached
        out, out_ref = S.minplus_matmul(a, b), S.minplus_matmul_ref(a, b)
        da = _lengths(gen, (m, k), 0.3, integer=True)
        db = _lengths(gen, (k, n), 0.3, integer=True)
        ca = torch.where(torch.isfinite(da), torch.randint(
            1, 4, (m, k), generator=gen, device="cuda").float(), 0.0)
        cb = torch.where(torch.isfinite(db), torch.randint(
            1, 4, (k, n), generator=gen, device="cuda").float(), 0.0)
        d, c = S.minplus_count_matmul(da, ca, db, cb)
        d_ref, c_ref = S.minplus_count_matmul_ref(da, ca, db, cb)
        torch.cuda.synchronize()
        tag = f"{m}x{n}x{k}"
        check(torch.equal(out, out_ref), f"minplus_matmul {tag}: not bit-equal")
        check(bool(torch.isinf(out[0]).all()),
              f"minplus_matmul {tag}: an all-inf row became finite")
        check(torch.equal(d, d_ref) and torch.equal(c, c_ref),
              f"minplus_count_matmul {tag}: not bit-equal")
        errs["minplus_matmul"] = max(errs["minplus_matmul"],
                                     _abs_err(out, out_ref))
        errs["minplus_count_matmul"] = max(
            errs["minplus_count_matmul"], _abs_err(d, d_ref),
            _abs_err(c, c_ref))
        print(f"  {tag:14s} minplus_matmul bit-equal; minplus_count_matmul "
              f"bit-equal (largest count {float(c_ref.max()):g})")
        if m == n == k:
            # the fused convergence flag against the squaring it tests
            sq = torch.where(torch.eye(m, device="cuda", dtype=torch.bool),
                             0.0, a)
            prod, changed = S.minplus_matmul(sq, sq, compare=sq)
            check(int(changed) == int(not torch.equal(prod, sq)) == 1,
                  "minplus_matmul changed flag: wrong on a first squaring")
            while int(changed):
                sq = prod
                prod, changed = S.minplus_matmul(sq, sq, compare=sq)
            check(torch.equal(prod, sq) and torch.equal(
                S.minplus_matmul_ref(sq, sq), sq),
                "minplus_matmul changed flag: 0 before convergence")
            main = (a, b, da, ca, db, cb)

    tropical_nan_checks(S, gen)
    split_checks(S, gen)

    hist_x = histogram_checks(H, gen, errs)

    a, b, da, ca, db, cb = main
    p = a.shape[0]
    valid = torch.isfinite(hist_x) & (hist_x >= 0) & (hist_x < 65)
    idx = hist_x[valid].long()
    markers = {"minplus_matmul": "split_tile<1",
               "minplus_count_matmul": "split_tile<2",
               "value_histogram": "value_hist"}
    cases = {
        # p^3 adds and p^3 mins; operands read once, output written once
        "minplus_matmul": (lambda: S.minplus_matmul(a, b),
                           lambda: S.minplus_matmul_ref(a, b), None,
                           2.0 * p ** 3, 3 * p * p * 4.0),
        # per (i, j, k): the add, the compare, the count product and its
        # accumulation; two fields in and out
        "minplus_count_matmul": (
            lambda: S.minplus_count_matmul(da, ca, db, cb),
            lambda: S.minplus_count_matmul_ref(da, ca, db, cb), None,
            4.0 * p ** 3, 6 * p * p * 4.0),
        # one read of the matrix; the bins are negligible
        "value_histogram": (
            lambda: H.value_histogram(hist_x, 65),
            lambda: H.value_histogram_ref(hist_x, 65),
            lambda: torch.bincount(idx, minlength=65),
            3.0 * hist_x.numel(), hist_x.numel() * 4.0 + 65 * 4),
    }
    out = {}
    for name, (kern, plain, library, ops, nbytes) in cases.items():
        before = tile_counts(S)
        ms, plain_ms = timed_ms(kern), timed_ms(plain)
        took = sorted({t for (e, t), n in tile_counts(S).items()
                       if e == name and n > before[(e, t)]})
        library_ms = timed_ms(library) if library is not None else None
        bms, by = bound_ms(ops / NON_FMA, nbytes, part)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bms, bound_by=by, max_abs_err=errs[name])
        lib = ("" if library_ms is None
               else f", torch.bincount {library_ms:.4f}")
        tile = ""
        if name != "value_histogram":  # p = 512: the split tile, split
            want = minplus_column(S, 1, p, p, p,
                                  2 if name == "minplus_count_matmul" else 1)
            check(took == [want] and want != "large",
                  f"{name} p={p}: ran on tiles {took}, expected {want}")
            out[name]["tile"] = took[0]
            tile = f", tile {took[0]}"
        # the events bracket one call from the host, wrapper included;
        # the profile gives the kernel's own device time
        dev = kernel_device_ms(kern, markers[name])
        dev = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f}{lib}, bound "
              f"{bms:.4f} by {by}{tile}); kernel device time {dev}")
    histogram_times(H, gen, hist_x, part)
    return out


#: the histogram's specials row: NaN, +-inf, -0 and -0.5 (bin 0 and
#: dropped), just below the top bin's end, at it (dropped), far past it
HIST_SPECIALS = (float("nan"), float("inf"), -float("inf"), -0.0, -0.5, -3.0,
                 64.999, 65.0, 1e9, 0.0)


def _hist_input(gen, shape, bins=65, spread=False):
    """The main path's distances (integers 0..7, 10% +inf), or values over
    all ``bins`` when ``spread``; led by the specials row (scaled to
    ``bins``)."""
    if spread:
        x = torch.rand(shape, generator=gen, device="cuda") * (bins + 3) - 1.5
    else:
        x = torch.randint(0, 8, shape, generator=gen, device="cuda").float()
        x = torch.where(torch.rand(shape, generator=gen, device="cuda")
                        < 0.1, float("inf"), x)
    specials = torch.tensor(HIST_SPECIALS, device="cuda")
    specials[6:8] = torch.tensor([bins - 0.001, float(bins)])
    flat = x.reshape(-1)
    flat[:len(specials)] = specials[:flat.numel()]
    return x


def histogram_checks(H, gen, errs):
    """``value_histogram`` equal to ``value_histogram_ref`` (integer counts)
    on the main path's shape and ragged ones, contiguous views at storage
    offsets 1-3 (the scalar head), n = 1, 3, 5 at offsets 0-3 (head and
    tail only), (4096, 4096), and 4096 and 12,288 bins with values over
    all bins; one launch a call. Returns the (1536, 1536) input."""
    cases = [(f"{shape}", _hist_input(gen, shape), 65)
             for shape in ((1536, 1536), (7, 13), (1,), (0,), (4096, 4096))]
    for n in (1, 3, 5):  # head and tail only: values off + i, one a bin
        for off in (0, 1, 2, 3):
            cases.append((f"n={n} offset {off}", torch.arange(
                n + 3, dtype=torch.float32, device="cuda")[off:off + n], 65))
    main_x = cases[0][1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flat = main_x.reshape(-1)
    for off in (1, 2, 3):  # buf[off:off + n], buf on a 16-byte boundary
        buf = torch.full((flat.numel() + 3,), float("nan"), device="cuda")
        view = buf[off:off + flat.numel()]
        view.copy_(flat)
        check(view.is_contiguous() and view.data_ptr() % 16 == 4 * off,
              f"offset {off}: view not {4 * off} bytes past a 16-byte "
              f"boundary")
        cases.append((f"offset {off}", view, 65))
    for bins in (4096, 12288):
        cases.append((f"{bins} bins", _hist_input(gen, (1536, 1536), bins,
                                                  spread=True), bins))
    for tag, x, bins in cases:
        before = H.launches["value_histogram"]
        h = H.value_histogram(x, bins)
        check(H.launches["value_histogram"] - before == (x.numel() > 0),
              f"value_histogram {tag}: not one launch")
        h_ref = H.value_histogram_ref(x, bins)
        torch.cuda.synchronize()
        check(torch.equal(h, h_ref), f"value_histogram {tag}: not equal")
        errs["value_histogram"] = max(errs["value_histogram"],
                                      _abs_err(h, h_ref))
        if bins > 65:
            check(bool((h_ref > 0).all()), f"{tag}: some bin empty")
        if tag.startswith("n="):
            check(int(h.sum()) == x.numel(), f"{tag}: not every value counted")
        blocks = H._hist_plan(x.numel(), sms) if x.numel() else 0
        print(f"  {tag:14s} value_histogram equal ({int(h.sum())} of "
              f"{x.numel()} counted; {bins} bins, {blocks} blocks)")
    return main_x


def histogram_times(H, gen, hist_x, part):
    """Row 7 L2-warm (20 calls back to back) and L2-cold (a 128 MB buffer
    written before each call), at (1536, 1536) and (4096, 4096) into 65
    bins and at 4096 and 12,288 bins: event ms of one call from the host
    (wrapper included; cold: each after the write has finished), the
    kernel's device ms (profiler) and the byte bound."""
    flush = torch.empty(32 << 20, device="cuda")

    def cold():
        flush.fill_(1.0)

    big = _hist_input(gen, (4096, 4096))
    for tag, x, bins in (("(1536, 1536), 65", hist_x, 65),
                         ("(4096, 4096), 65", big, 65),
                         ("(1536, 1536), 4096", _hist_input(
                             gen, (1536, 1536), 4096, spread=True), 4096),
                         ("(1536, 1536), 12288", _hist_input(
                             gen, (1536, 1536), 12288, spread=True), 12288)):
        def kern():
            return H.value_histogram(x, bins)

        bms, by = bound_ms(0.0, x.numel() * 4.0 + bins * 4, part)
        warm, warm_dev = timed_ms(kern), kernel_device_ms(kern, "value_hist")
        cold_ms = timed_ms(kern, before=cold)
        cold_dev = kernel_device_ms(lambda: (cold(), kern()), "value_hist")
        fmt = (lambda v: "not measured" if v is None else f"{v:.4f} ms")
        print(f"  value_histogram {tag}: L2-warm event {warm:.4f} ms, "
              f"device {fmt(warm_dev)}; L2-cold event {cold_ms:.4f} ms, "
              f"device {fmt(cold_dev)}; bound {bms:.4f} ms by {by}")
    del flush, big


def nan_equal(x, y):
    """Equal, NaN matching NaN."""
    return torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(
        x.nan_to_num(0.0, 0.0, 0.0), y.nan_to_num(0.0, 0.0, 0.0))


def with_nans(gen, x, share=0.005):
    return torch.where(torch.rand(x.shape, generator=gen, device="cuda")
                       < share, float("nan"), x)


def tropical_nan_checks(S, gen):
    """The three tropical.cu kernels on NaN inputs against their plain
    versions, NaN-aware: a NaN sum anywhere along k makes the distance NaN
    and its count 0, as the JAX package's jnp.min / jnp.minimum give. The
    min-plus products on both tiles: the 2D ones and the B=3 stacks on the
    small tile, B=12 stacks (a ragged one, and 2048^3 with 16-byte copies)
    on the large one."""
    for m, n, k in ((512, 512, 512), (200, 136, 72)):
        a = with_nans(gen, _lengths(gen, (m, k), 0.3))
        b = with_nans(gen, _lengths(gen, (k, n), 0.3))
        out, out_ref = S.minplus_matmul(a, b), S.minplus_matmul_ref(a, b)
        sa = with_nans(gen, _lengths(gen, (3, m, k), 0.3))
        sb = with_nans(gen, _lengths(gen, (3, k, n), 0.3))
        before = tile_counts(S)
        bout = S.batched_minplus_matmul(sa, sb)
        took = {t for (e, t), c in tile_counts(S).items()
                if e == "batched_minplus_matmul" and c > before[(e, t)]}
        want = minplus_column(S, 3, m, n, k)
        check(took == {want} and want != "large",
              f"batched NaN {m}x{n}x{k}: tiles {took}, expected {want}")
        bref = S.batched_minplus_matmul_ref(sa, sb)
        da = with_nans(gen, _lengths(gen, (m, k), 0.3, integer=True))
        db = with_nans(gen, _lengths(gen, (k, n), 0.3, integer=True))
        ca = torch.where(torch.isfinite(da), 2.0, 0.0)
        cb = torch.where(torch.isfinite(db), 3.0, 0.0)
        d, c = S.minplus_count_matmul(da, ca, db, cb)
        d_ref, c_ref = S.minplus_count_matmul_ref(da, ca, db, cb)
        torch.cuda.synchronize()
        tag = f"{m}x{n}x{k}"
        check(nan_equal(out, out_ref), f"minplus_matmul NaN {tag}: differs")
        check(nan_equal(bout, bref), f"batched_minplus_matmul NaN {tag}: "
                                     f"differs")
        check(nan_equal(d, d_ref) and nan_equal(c, c_ref),
              f"minplus_count_matmul NaN {tag}: differs")
        nan = torch.isnan(d_ref)
        check(bool(torch.isnan(out_ref).any()) and bool(nan.any())
              and not bool(c_ref[nan].any()),
              f"NaN {tag}: no NaN reached the output")
        print(f"  {tag:14s} NaN inputs: minplus_matmul, batched ({want}) "
              f"and minplus_count_matmul NaN-equal to their plain "
              f"versions ({int(torch.isnan(out_ref).sum())}, "
              f"{int(torch.isnan(bref).sum())}, {int(nan.sum())} NaN cells)")
    for b_, m, n, k in ((12, 520, 600, 70), (12, 2048, 2048, 2048)):
        sa = with_nans(gen, _lengths(gen, (b_, m, k), 0.3), share=0.0005)
        sb = with_nans(gen, _lengths(gen, (b_, k, n), 0.3), share=0.0005)
        before = tile_counts(S)
        bout = S.batched_minplus_matmul(sa, sb)
        took = {t for (e, t), c in tile_counts(S).items()
                if e == "batched_minplus_matmul" and c > before[(e, t)]}
        bref = S.batched_minplus_matmul_ref(sa, sb)
        torch.cuda.synchronize()
        tag = f"B={b_} {m}x{n}x{k}"
        check(took == {"large"}, f"batched NaN {tag}: tiles {took}")
        check(nan_equal(bout, bref), f"batched_minplus_matmul NaN {tag}: "
                                     f"differs")
        nan = torch.isnan(bref)
        check(bool(nan.any()) and not bool(nan.all()),
              f"batched NaN {tag}: no NaN, or only NaN, in the output")
        print(f"  {tag} NaN inputs: batched_minplus_matmul on the large "
              f"tile NaN-equal to its plain version ({int(nan.sum())} of "
              f"{nan.numel()} NaN cells)")
        del sa, sb, bout, bref


def minplus_column(S, batch, m, n, k, nf=1, split=None):
    """The device counter (``S.tile_launches()`` entry) that a min-plus
    product (nf 1) or count product (nf 2) of ``batch`` (m, n, k) adds to:
    "large", "small" (the split tile unsplit) or "split<S>"."""
    return S._minplus_column(*S._minplus_plan(batch, m, n, k, nf, split))


def bit_equal(x, y):
    """NaN-equal, and equal in sign bit wherever not NaN (so -0 differs
    from +0); NaN payloads are not compared."""
    def signs(t):
        return torch.signbit(t) & ~torch.isnan(t)
    return nan_equal(x, y) and torch.equal(signs(x), signs(y))


def with_signed_zeros(gen, x):
    """``x`` with half of its zeros made -0: a -0 sum needs -0 on both
    sides, and ties +0 sums."""
    flip = torch.rand(x.shape, generator=gen, device="cuda") < 0.5
    return torch.where((x == 0) & flip, -0.0, x)


#: the split tile's shapes in phase 3, (batch, m, n, k) (batch 0: 2D): the
#: MWU oracle's p = 384..512, the mid-size grids that stay off the large
#: tile, a ragged one and a small stack; and the splits forced on each
SPLIT_SHAPES = ((0, 384, 384, 384), (0, 512, 512, 512),
                (0, 1024, 1024, 1024), (0, 1536, 1536, 1536),
                (0, 300, 200, 260), (3, 512, 512, 512))
FORCED_SPLITS = (1, 2, 4, 8)


def split_checks(S, gen):
    """The split tile (``csrc/tropical.cu``) at every SPLIT_SHAPES shape,
    on the split the host picks and on each of FORCED_SPLITS: both
    products (the count product 2D only) bit-equal to their plain versions
    on integer lengths and counts with -0 and +0 in both operands (sign
    bits compared), and NaN-equal on the same operands with NaN cells;
    each run's tile and split read from the device counters. Then the
    changed flag under a split: 1 on a first squaring, 0 at convergence."""
    for batch, m, n, k in SPLIT_SHAPES:
        lead = (batch,) if batch else ()
        b_ = max(batch, 1)
        a = with_signed_zeros(gen, _lengths(gen, (*lead, m, k), 0.3, True))
        b = with_signed_zeros(gen, _lengths(gen, (*lead, k, n), 0.3, True))
        share = min(0.005, 0.2 / k)
        an, bn = with_nans(gen, a, share), with_nans(gen, b, share)
        ref = S.batched_minplus_matmul_ref if batch else S.minplus_matmul_ref
        want = {"": ref(a, b), "NaN ": ref(an, bn)}
        ops = {"": (a, b), "NaN ": (an, bn)}
        if not batch:
            ca = torch.where(torch.isfinite(a), torch.randint(
                1, 4, (m, k), generator=gen, device="cuda").float(), 0.0)
            cb = torch.where(torch.isfinite(b), torch.randint(
                1, 4, (k, n), generator=gen, device="cuda").float(), 0.0)
            cwant = {"": S.minplus_count_matmul_ref(a, ca, b, cb),
                     "NaN ": S.minplus_count_matmul_ref(an, ca, bn, cb)}
        zeros = int(((want[""] == 0) & torch.signbit(want[""])).sum())
        nans = int(torch.isnan(want["NaN "]).sum())
        check(zeros > 0 and 0 < nans < want["NaN "].numel(),
              f"split {batch} {m}x{n}x{k}: {zeros} -0 cells, {nans} NaN")
        tag = f"{'B=%d ' % batch if batch else ''}{m}x{n}x{k}"
        ran = []
        for split in (None,) + FORCED_SPLITS:
            for kind, (x, y) in ops.items():
                col = minplus_column(S, b_, m, n, k, 1, split)
                before = tile_counts(S)
                out = S._minplus(x, y, True, None, bool(batch), split=split)
                name = ("batched_minplus_matmul" if batch
                        else "minplus_matmul")
                took = {t for (e, t), c in tile_counts(S).items()
                        if e == name and c > before[(e, t)]}
                check(took == {col}, f"{name} {tag} split {split}: tiles "
                                     f"{took}, expected {col}")
                check(bit_equal(out, want[kind]),
                      f"{name} {kind}{tag} split {split}: not bit-equal")
                if batch:
                    continue
                col = minplus_column(S, 1, m, n, k, 2, split)
                before = tile_counts(S)
                d, c = S._minplus_count(x, ca, y, cb, True, split=split)
                took = {t for (e, t), n_ in tile_counts(S).items()
                        if e == "minplus_count_matmul"
                        and n_ > before[(e, t)]}
                check(took == {col}, f"minplus_count_matmul {tag} split "
                                     f"{split}: tiles {took}, expected {col}")
                dw, cw = cwant[kind]
                check(bit_equal(d, dw) and bit_equal(c, cw),
                      f"minplus_count_matmul {kind}{tag} split {split}: "
                      f"not bit-equal")
            if split is None:
                ran.append(f"host {minplus_column(S, b_, m, n, k)}"
                           + ("" if batch else
                              f"/{minplus_column(S, 1, m, n, k, 2)}"))
        print(f"  {tag:14s} split tile: both products bit-equal to their "
              f"plain versions with +-0 ({zeros} -0 cells) and NaN-equal "
              f"({nans} NaN cells) on the host's split ({ran[0]}) and at "
              f"forced splits {FORCED_SPLITS}")

    # the changed flag under a split, at the host's split and at 8
    p = 512
    for split in (None, 8):
        sq = _lengths(gen, (p, p), 0.7)
        sq = torch.where(torch.eye(p, device="cuda", dtype=torch.bool), 0.0,
                         sq)
        prod, changed = S._minplus(sq, sq, True, sq, False, split=split)
        check(int(changed) == 1, f"changed flag split {split}: 0 on a "
                                 f"first squaring")
        rounds = 1
        while int(changed):
            sq = prod
            prod, changed = S._minplus(sq, sq, True, sq, False, split=split)
            rounds += 1
        check(torch.equal(prod, sq) and bit_equal(
            S.minplus_matmul_ref(sq, sq), sq),
            f"changed flag split {split}: 0 before convergence")
        print(f"  changed flag at split {minplus_column(S, 1, p, p, p, 1, split)}: "
              f"1 on the first squaring, 0 at convergence after {rounds} "
              f"squarings")


# -- phase 3: the narrow-cell kernels --------------------------------------------

#: the extreme path's padded router count (781 x 128, ~100k routers)
EXTREME_WIDTH = 99_968


def _packed_operands(gen, lead, m, n, k, density, hi=4, sat_share=0.0):
    """Packed-cell operands: an int32 frontier f of sparse counts in
    [0, hi), with a share ``sat_share`` of cells at or above MULT_SAT; a
    {0,1} uint8 adjacency a of ``density``, drawn in row blocks so a 10 GB
    one needs no float copy; int16 distances d, half DIST_UNREACHED."""
    from repro_torch.kernels.semiring import DIST_UNREACHED, MULT_SAT

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    f = torch.randint(0, hi, (*lead, m, k), generator=gen, device="cuda",
                      dtype=torch.int32) * (rand(*lead, m, k) < 0.3)
    if sat_share:
        f = torch.where(rand(*lead, m, k) < sat_share,
                        MULT_SAT + torch.randint(0, 8, f.shape, generator=gen,
                                                 device="cuda",
                                                 dtype=torch.int32), f)
    a = torch.empty((*lead, k, n), dtype=torch.uint8, device="cuda")
    rows = a.view(-1, n)
    for r0 in range(0, rows.shape[0], 4096):
        r1 = min(rows.shape[0], r0 + 4096)
        rows[r0:r1] = rand(r1 - r0, n) < density
    d = torch.randint(0, 5, (*lead, m, n), generator=gen, device="cuda",
                      dtype=torch.int16)
    d = torch.where(rand(*lead, m, n) < 0.5, DIST_UNREACHED, d)
    return f.to(torch.int32), a, d.to(torch.int16)


def packed_limb_ops(S, f, n, k):
    """The int8 operations of ``csrc/packed.cu`` on the left operand ``f``
    (.., M, k) against a (k, n) right operand: 2 n k per row and limb pass,
    over the limbs each 32-row tile does not skip (``S._limb_passes``)."""
    passes = S._limb_passes(f).double()
    m = f.shape[-2]
    rows = torch.clamp(m - 32 * torch.arange(passes.shape[-1],
                                             device=passes.device), max=32)
    return 2.0 * n * k * float((passes * rows).sum())


def packed_bound_ms(limb_ops, nbytes, part):
    """The bound of a packed kernel: its int8 limb products on the tensor
    cores (``packed_limb_ops``), against the bytes."""
    t_ops = limb_ops / INT8_PEAK[part] * 1e3
    t_bytes = nbytes / PEAKS[part][1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _unaligned(x, offset):
    """A contiguous copy of ``x`` whose base lies ``offset`` elements past
    an aligned allocation."""
    flat = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    y = flat[offset:].view(x.shape)
    y.copy_(x)
    return y


def packed_edge_checks(S, gen, step_check, narrow_check):
    """The int8 GEMM's edges: a uint8 B up to 255 at K past 33,025 (the
    limb sums fold), sums below 2**24 and, with a dense frontier of 255s,
    above it; frontier cells at 2**31 - 1 against a sparse B (clamped at
    MULT_SAT); bases off the 16-byte grid."""
    m, n, k = 32, 384, 40_000
    # values 192..255: 255 * sum_k b passes 2**31 for a row of 255s
    b = torch.randint(192, 256, (k, n), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.uint8)
    f = (torch.rand((m, k), generator=gen, device="cuda") < 0.01).to(
        torch.int32) * torch.randint(0, 3, (m, k), generator=gen,
                                     device="cuda", dtype=torch.int32)
    d = torch.where(torch.rand((m, n), generator=gen, device="cuda") < 0.5,
                    S.DIST_UNREACHED, 1).to(torch.int16)
    step_check("frontier_step_packed", f, b, d, f"u8 B <= 255, K={k}")
    narrow_check(f, b, f"u8 B <= 255, K={k}")
    big = f.clone()
    big[:8] = 255  # limb 0's sum alone passes 2**31 without a fold
    check(step_check("frontier_step_packed", big, b, d,
                     f"u8 B <= 255, K={k}, rows of 255s") > 0,
          "no cell clamped with rows of 255s")
    c, c_ref = S.count_matmul(big, b), S.count_matmul_ref(big, b)
    torch.cuda.synchronize()
    small = c_ref < EXACT
    check(torch.equal(c[small], c_ref[small])
          and bool((c[~small] >= EXACT).all()) and bool((~small).any()),
          "count_matmul_narrow rows of 255s: not exact below 2**24 or not "
          ">= 2**24 above it")
    # above 2**24 the card's sum is the limb emulation's, bit for bit
    emu = S._limbed_u8_matmul_ref(big[:10].cpu(), b.cpu()).float()
    check(torch.equal(c[:10].cpu(), emu), "count_matmul_narrow rows of "
          "255s: not bit-equal to the limb emulation")
    print(f"  count_matmul_narrow u8 B <= 255, K={k}, rows of 255s: "
          f"bit-equal below 2**24, >= 2**24 in all {int((~small).sum())} "
          f"cells above; rows 0-9 bit-equal to the limb emulation (one "
          f"fold)")

    m, n, k = 40, 520, 3000
    f = torch.where(torch.rand((m, k), generator=gen, device="cuda") < 0.002,
                    2 ** 31 - 1, 0).to(torch.int32)
    a = (torch.rand((k, n), generator=gen, device="cuda") < 0.01).to(
        torch.uint8)
    d = torch.full((m, n), S.DIST_UNREACHED, dtype=torch.int16,
                   device="cuda")
    check(step_check("frontier_step_packed", f, a, d,
                     "cells at 2**31 - 1, sparse B") > 0,
          "no cell at 2**31 - 1 clamped")

    f, a, d = _packed_operands(gen, (2,), 33, 272, 200, 0.2, sat_share=0.02)
    fu, au, du = _unaligned(f, 1), _unaligned(a, 1), _unaligned(d, 1)
    check(au.data_ptr() % 16 and du.data_ptr() % 8 and fu.data_ptr() % 16,
          "the unaligned copies are aligned")
    step_check("frontier_step_packed_batched", fu, au, du,
               "B=2 33x272x200, unaligned bases")
    step_check("frontier_step_packed", fu[1], au[1], du[1],
               "33x272x200, unaligned bases")
    g, _, _ = _packed_operands(gen, (2,), 33, 1, 400, 0.2)
    narrow_check(_unaligned(g, 3)[..., 200:], au,
                 "B=2 33x272x200 strided, unaligned bases")


def packed_checks(S, part):
    """The packed frontier step (2D and batched) and the narrow counting
    product against their plain versions, bit-equal: at the extreme path's
    shapes (a 32-row source tile against a 99,968-wide uint8 adjacency;
    the pump's (32 x 256) slab against a (256 x 99,968) panel; the
    sweep's stack, B=12, 2048^3), at ragged ones, with frontier cells
    at and above MULT_SAT so the clamp is exercised (the narrow product's
    inputs keep their sums below 2**24, where fp32 sums are exact in any
    order), and at the int8 GEMM's edges (``packed_edge_checks``). Then
    times at the main shapes, with the split pass's device time apart."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = ("frontier_step_packed", "frontier_step_packed_batched",
             "count_matmul_narrow")
    errs = dict.fromkeys(names, 0.0)
    k0 = 128

    def step_check(name, f, a, d, tag):
        x, x_ref = S.frontier_step_packed(f, a, d), S.frontier_step_packed_ref(
            f, a, d)
        torch.cuda.synchronize()
        check(torch.equal(x, x_ref), f"{name} {tag}: not bit-equal")
        errs[name] = max(errs[name], _abs_err(x, x_ref))
        sat = int((x_ref == S.MULT_SAT).sum())
        print(f"  {name} {tag}: bit-equal ({int((x_ref > 0).sum())} new "
              f"cells, {sat} clamped at MULT_SAT)")
        return sat

    def narrow_check(f, b, tag):
        c, c_ref = S.count_matmul(f, b), S.count_matmul_ref(f, b)
        torch.cuda.synchronize()
        check(torch.equal(c, c_ref), f"count_matmul_narrow {tag}: not "
                                     f"bit-equal")
        errs["count_matmul_narrow"] = max(errs["count_matmul_narrow"],
                                          _abs_err(c, c_ref))
        print(f"  count_matmul_narrow {tag}: bit-equal (largest sum "
              f"{float(c_ref.max()):g})")

    for b, m, n, k in ((3, 40, 136, 72), (2, 33, 65, 1), (1, 1, 1, 100),
                       (2, 32, 137, 300)):
        f, a, d = _packed_operands(gen, (b,), m, n, k, 0.2, sat_share=0.02)
        step_check("frontier_step_packed_batched", f, a, d,
                   f"B={b} {m}x{n}x{k}")
        step_check("frontier_step_packed", f[0], a[0], d[0], f"{m}x{n}x{k}")
        g, _, _ = _packed_operands(gen, (b,), m, 1, 2 * k, 0.2)
        narrow_check(g[..., k:], a, f"B={b} {m}x{n}x{k} strided")
        narrow_check(g[0, :, k:], a[0], f"{m}x{n}x{k} strided")

    packed_edge_checks(S, gen, step_check, narrow_check)

    fb, ab, db = _packed_operands(gen, (12,), 2048, 2048, 2048, 0.05,
                                  sat_share=1e-4)
    check(step_check("frontier_step_packed_batched", fb, ab, db,
                     "B=12 2048x2048x2048") > 0, "no cell clamped at B=12")
    f, a, d = _packed_operands(gen, (), 32, EXTREME_WIDTH, EXTREME_WIDTH,
                               1e-3, sat_share=1e-4)
    check(step_check("frontier_step_packed", f, a, d,
                     f"32x{EXTREME_WIDTH}x{EXTREME_WIDTH}") > 0,
          "no cell clamped at the extreme shape")
    g, _, _ = _packed_operands(gen, (), 32, 1, EXTREME_WIDTH, 1.0)
    slab, panel = g[:, k0:k0 + 256], a[k0:k0 + 256]
    check(not slab.is_contiguous(), "the pump's slab should be strided")
    narrow_check(slab, panel, f"32x{EXTREME_WIDTH}x256 strided slab")

    cases = {  # name -> (kernel, plain, lhs, rhs, library, ops, bytes)
        "frontier_step_packed": (
            lambda: S.frontier_step_packed(f, a, d),
            lambda: S.frontier_step_packed_ref(f, a, d), f, a, torch.mm,
            2.0 * f.shape[0] * a.shape[0] * a.shape[1],
            4.0 * f.numel() + a.numel() + (2.0 + 4.0) * d.numel()),
        "frontier_step_packed_batched": (
            lambda: S.frontier_step_packed(fb, ab, db),
            lambda: S.frontier_step_packed_ref(fb, ab, db), fb, ab, torch.bmm,
            2.0 * 12 * 2048 ** 3,
            4.0 * fb.numel() + ab.numel() + (2.0 + 4.0) * db.numel()),
        "count_matmul_narrow": (
            lambda: S.count_matmul(slab, panel),
            lambda: S.count_matmul_ref(slab, panel), slab, panel, torch.mm,
            2.0 * slab.shape[0] * panel.shape[0] * panel.shape[1],
            4.0 * slab.numel() + panel.numel()
            + 4.0 * slab.shape[0] * panel.shape[1]),
    }
    markers = {"frontier_step_packed": "packed_gemm<true",
               "frontier_step_packed_batched": "packed_gemm<true",
               "count_matmul_narrow": "packed_gemm<false"}
    out = {}
    for name, (kern, plain, lhs, rhs, library, ops, nbytes) in cases.items():
        ms, plain_ms = timed_ms(kern), timed_ms(plain)
        lf, rf = lhs.float(), rhs.float()  # library: the product only
        library_ms = timed_ms(lambda: library(lf, rf))
        del lf, rf
        dev = kernel_device_ms(kern, markers[name], reps=5)
        split = kernel_device_ms(kern, "split_limbs", reps=5)
        limb_ops = packed_limb_ops(S, lhs, rhs.shape[-1], rhs.shape[-2])
        bms, by = packed_bound_ms(limb_ops, nbytes, part)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bms, bound_by=by, max_abs_err=errs[name])
        dev, split = ("not measured" if t is None else f"{t:.4f} ms"
                      for t in (dev, split))
        print(f"  {name} {tuple(lhs.shape)}x{tuple(rhs.shape)}: {ms:.4f} ms "
              f"(plain {plain_ms:.4f}, torch.{library.__name__} "
              f"{library_ms:.4f}, bound {bms:.4f} by {by}; "
              f"{limb_ops / ops:g} limb passes, {limb_ops / ms / 1e9:.1f} "
              f"int8 TOP/s, {nbytes / ms / 1e9:.3f} TB/s); "
              f"device: GEMM {dev}, split pass {split}")
    del f, a, d, fb, ab, db, g, slab, panel
    torch.cuda.empty_cache()
    return out


# -- phase 3: the boolean and batched min-plus kernels ---------------------------

def library_kernel_checks(S, part):
    """The boolean product (2D and stacked, A also read transposed) and
    the batched min-plus product against their plain versions, bit-equal:
    {0,1} masks at three densities at 2048^3 and at ragged shapes; the
    min-plus at B=12, 2048^3 and a ragged stack with +inf holes and an
    all-inf row, with and without ``compare`` (a squaring that changes
    nothing among them). Then times at the main shapes: 2048^3 for the
    boolean product (phase 8's closure), B=12, 2048^3 for the min-plus
    (phase 8's stacked squaring)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {"reachability_step": 0.0, "batched_minplus_matmul": 0.0}

    def mask(shape, density):
        return (torch.rand(shape, generator=gen, device="cuda")
                < density).float()

    for lead, m, n, k in (((), 2048, 2048, 2048), ((3,), 2048, 2048, 2048),
                          ((2,), 200, 136, 72), ((), 200, 136, 72),
                          ((2,), 33, 65, 1), ((), 1, 1, 100)):
        for density in (0.005, 0.02, 0.1):
            a, b = mask((*lead, m, k), density), mask((*lead, k, n), density)
            at = a.transpose(-1, -2).contiguous().transpose(-1, -2)
            r, r_ref = S.reachability_step(a, b), S.reachability_step_ref(a, b)
            rt = S.reachability_step(at, b)
            torch.cuda.synchronize()
            tag = f"{'B=%d ' % lead[0] if lead else '2D '}{m}x{n}x{k} " \
                  f"density {density}"
            check(torch.equal(r, r_ref), f"reachability_step {tag}: not "
                                         f"bit-equal")
            check(torch.equal(rt, r_ref), f"reachability_step {tag}, "
                                          f"transposed A: not bit-equal")
            errs["reachability_step"] = max(errs["reachability_step"],
                                            _abs_err(r, r_ref))
            if m == 2048:
                print(f"  reachability_step {tag}: bit-equal "
                      f"({float(r_ref.mean()):.4f} of cells set)")
        if m == 2048 and not lead:
            main_mask = (a, b)
    print("  reachability_step ragged shapes: bit-equal")

    for b_, m, n, k in ((12, 2048, 2048, 2048), (12, 600, 520, 300),
                        (12, 520, 600, 71), (3, 200, 136, 72),
                        (2, 33, 65, 1), (1, 1, 1, 100)):
        a = _lengths(gen, (b_, m, k), 0.5, integer=True)
        b = _lengths(gen, (b_, k, n), 0.5, integer=True)
        a[:, 0] = float("inf")  # an unreached row stays unreached
        before = tile_counts(S)
        out = S.batched_minplus_matmul(a, b)
        took = {t for (e, t), c in tile_counts(S).items()
                if e == "batched_minplus_matmul" and c > before[(e, t)]}
        out_ref = S.batched_minplus_matmul_ref(a, b)
        same, changed_same = S.batched_minplus_matmul(a, b, compare=out_ref)
        noise = out_ref.clone()
        noise.view(-1)[-1] = -1.0  # one cell of the whole stack differs
        _, changed_one = S.batched_minplus_matmul(a, b, compare=noise)
        torch.cuda.synchronize()
        tile = minplus_column(S, b_, m, n, k)
        tag = f"B={b_} {m}x{n}x{k}, {tile} tile"
        check(took == {tile}, f"batched_minplus_matmul {tag}: ran on tiles "
                              f"{took}")
        check(torch.equal(out, out_ref) and torch.equal(same, out_ref),
              f"batched_minplus_matmul {tag}: not bit-equal")
        check(bool(torch.isinf(out[:, 0]).all()),
              f"batched_minplus_matmul {tag}: an all-inf row became finite")
        check(int(changed_same) == 0 and int(changed_one) == 1,
              f"batched_minplus_matmul {tag}: changed flag "
              f"{int(changed_same)}/{int(changed_one)}, want 0/1")
        errs["batched_minplus_matmul"] = max(errs["batched_minplus_matmul"],
                                             _abs_err(out, out_ref))
        print(f"  batched_minplus_matmul {tag}: bit-equal, changed flag 0 "
              f"against itself and 1 against one changed cell")
        if b_ == 12 and m == 2048:
            main_stack = (a, b)

    ma, mb = main_mask
    sa, sb = main_stack
    p, bsz = ma.shape[0], sa.shape[0]
    cases = {  # name -> (kernel, plain, library, ops, bytes, marker, plain iters)
        "reachability_step": (
            lambda: S.reachability_step(ma, mb),
            lambda: S.reachability_step_ref(ma, mb),
            lambda: torch.mm(ma, mb) > 0.5,
            2.0 * p ** 3, 3 * p * p * 4.0, "tc_tile", 10),
        # B p^3 adds and B p^3 mins, at the non-FMA rate; the large tile
        "batched_minplus_matmul": (
            lambda: S.batched_minplus_matmul(sa, sb),
            lambda: S.batched_minplus_matmul_ref(sa, sb), None,
            2.0 * bsz * p ** 3 / NON_FMA, 3 * bsz * p * p * 4.0,
            "tropical_big_tile", 3),
    }
    out = {}
    for name, (kern, plain, library, ops, nbytes, marker,
               iters) in cases.items():
        ms = timed_ms(kern)
        plain_ms = timed_ms(plain, iters=iters, warmup=1)
        library_ms = timed_ms(library) if library is not None else None
        bms, by = bound_ms(ops, nbytes, part)
        dev = kernel_device_ms(kern, marker, reps=10)
        if name == "reachability_step":  # {0,1} masks: tile (b)
            bms, by = tile_bound_ms("tensor", ops, nbytes, part)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bms, bound_by=by, max_abs_err=errs[name])
        out[name]["tile"] = ("tensor" if name == "reachability_step"
                             else S._minplus_tile(bsz, p, p))
        lib = ("" if library_ms is None
               else f", torch.mm then > 0.5 {library_ms:.4f}")
        dev = "not measured" if dev is None else f"{dev:.4f} ms"
        print(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f}{lib}, bound "
              f"{bms:.4f} by {by}, tile {out[name]['tile']}, "
              f"{100 * bms / ms:.1f}% of the bound); kernel device time "
              f"{dev}")
    return out


# -- phases 4 and 5: the sweep ------------------------------------------------------

_EXACT_COLS = ("routers", "servers", "radix", "diameter", "cables_electrical",
               "cables_optical")


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


def check_committed(result, path):
    ref = {r["family"]: r for r in json.loads(path.read_text())["rows"]}
    rows = {r["family"]: r for r in result["rows"]}
    check(rows.keys() == ref.keys(),
          f"families differ: {sorted(rows)} vs {sorted(ref)}")
    for fam, want in ref.items():
        got = rows[fam]
        for col in _EXACT_COLS:
            check(got[col] == want[col], f"{fam}.{col}: {got[col]} != {want[col]}")
        for col in ("avg_spl", "mult_mean", "cost", "power_kw"):
            check(_close(got[col], want[col], 1e-9),
                  f"{fam}.{col}: {got[col]} vs {want[col]} (rtol 1e-9)")
        check(_close(got["tput_lb"], want["tput_lb"], 1e-5),
              f"{fam}.tput_lb: {got['tput_lb']} vs {want['tput_lb']} (rtol 1e-5)")


def compare_chains(WF, S, adj_np):
    """Full-width stack through the kernels and through the plain versions,
    on the card: dist bit-equal, mult bit-equal below 2**24 (rtol 1e-5
    above), loads rtol 1e-5."""
    adj = torch.from_numpy(WF.pad_operand(adj_np, WF.pad_block(adj_np.shape[-1]),
                                          0.0)).cuda()
    dk, mk = WF.dist_mult_device(adj)
    dp, mp = WF.dist_mult_device(adj, use_kernel=False)
    check(torch.equal(dk, dp), "full width: dist not bit-equal")
    big = mp >= EXACT
    check(torch.equal(mk[~big], mp[~big]),
          "full width: mult below 2**24 not bit-equal")
    check(torch.allclose(mk[big], mp[big], rtol=1e-5, atol=0.0),
          "full width: mult above 2**24 beyond rtol 1e-5")
    lk = WF.ecmp_loads_device(dk, mk, adj)
    lp = WF.ecmp_loads_device(dp, mp, adj, use_kernel=False)
    check(torch.allclose(lk, lp, rtol=1e-5, atol=0.0),
          "full width: loads beyond rtol 1e-5")
    rel = float(((lk - lp).abs() / lp.abs().clamp_min(1e-30)).max())
    print(f"  chains: dist bit-equal; mult >= 2**24 in {int(big.sum())} cells "
          f"(max {float(mp.max()):.4g}); loads max rel diff {rel:.3g}")


# -- phase 6: the analysis path ------------------------------------------------------

ANALYSIS_FAMILIES = ("slimfly", "jellyfish", "xpander", "hyperx",
                     "dragonfly", "fattree")
THROUGHPUT_FAMILIES = ("slimfly", "fattree")
SPECTRAL_KEYS = ("fiedler_lambda2", "laplacian_lambda_max",
                 "bisection_lower_bound", "edge_expansion_lower_bound",
                 "diameter_upper_bound")
_TP_EXACT = ("rounds", "converged", "commodities", "dropped_unreachable",
             "demand_pattern")
_TP_CLOSE = ("throughput", "upper_bound", "gap", "aggregate_throughput")
#: the kernels the analysis path runs
ANALYSIS_KERNELS = ("frontier_step", "count_matmul", "minplus_matmul",
                    "minplus_count_matmul", "value_histogram")


def check_report(fam, got, want, spectral_rtol=1e-2):
    """Integer keys and histograms exact, float keys within rtol 1e-5,
    spectral keys within ``spectral_rtol`` (each package draws its own
    power-iteration start vector). Returns the largest spectral relative
    deviation."""
    check(got.keys() == want.keys(),
          f"{fam}: report keys differ: {sorted(set(got) ^ set(want))}")
    worst = 0.0
    for key, w in want.items():
        g = got[key]
        if key in SPECTRAL_KEYS:
            dev = abs(g - w) / max(abs(w), 1e-30)
            worst = max(worst, dev)
            check(dev <= spectral_rtol,
                  f"{fam}.{key}: {g} vs {w} (rtol {spectral_rtol})")
        elif isinstance(w, float):
            check(_close(g, w, 1e-5), f"{fam}.{key}: {g} vs {w} (rtol 1e-5)")
        else:
            check(g == w, f"{fam}.{key}: {g!r} != {w!r}")
    return worst


def check_throughput(fam, got, want):
    for key in _TP_EXACT:
        check(got[key] == want[key],
              f"{fam} throughput.{key}: {got[key]!r} != {want[key]!r}")
    loads = got["link_loads"]
    for key, g in [(k, got[k]) for k in _TP_CLOSE] + [
            ("link_loads_sum", float(loads.sum())),
            ("link_loads_max", float(loads.max()))]:
        check(_close(g, want[key], 1e-9),
              f"{fam} throughput.{key}: {g} vs {want[key]} (rtol 1e-9)")


def analysis_phase(obs, S, T, AnalysisEngine, paths, ref):
    """The example's analysis path on the card at full width, counted:
    six reports at ~10k servers, the hyperx wavefront against its
    tropical-count oracle, and two all-pairs throughputs at ~2k servers,
    held to the reference ``ref``. Returns (launches, reports)."""
    stages = AnalysisEngine.DEFAULT_STAGES + ("comparison",)
    graphs = {fam: T.by_servers(fam, ref["servers"]["reports"])
              for fam in ANALYSIS_FAMILIES}
    tp_graphs = {fam: T.by_servers(fam, ref["servers"]["throughput"])
                 for fam in THROUGHPUT_FAMILIES}
    spans, reports, results = {}, {}, {}
    obs.enable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.reset_launches()
    t0 = time.perf_counter()
    for fam, g in graphs.items():
        obs.reset()
        reports[fam] = AnalysisEngine(g, device="cuda").report(stages)
        spans[fam] = obs.span_summary()
    g = graphs["hyperx"]
    obs.reset()
    with obs.span("oracle.wavefront"):
        dw, mw = paths.shortest_path_multiplicity(g, device="cuda")
        torch.cuda.synchronize()
    with obs.span("oracle.tropical_count"):
        dt, ct = paths.tropical_count_relaxation(g, device="cuda")
        torch.cuda.synchronize()
    spans["hyperx oracle"] = obs.span_summary()
    for fam, g in tp_graphs.items():
        obs.reset()
        results[fam] = AnalysisEngine(
            g, device="cuda", **ref["throughput_settings"]).throughput()
        spans[f"{fam} throughput"] = obs.span_summary()
    wall = time.perf_counter() - t0
    counts = dict(S.launches)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    obs.disable()

    print(f"[6 analysis] {wall:.3f} s; launches {counts}; peak device "
          f"memory {peak_mb:.1f} MiB")
    for label, row in spans.items():
        cells = ", ".join(f"{name} {r['total_ms']:.3f} ms"
                          for name, r in sorted(row.items()))
        print(f"  spans {label}: {cells}")
    worst = 0.0
    for fam, rep in reports.items():
        worst = max(worst, check_report(fam, rep, ref["reports"][fam]))
        print(f"  {fam}: {rep['routers']} routers, diameter "
              f"{rep['diameter']}, mult mean "
              f"{rep['path_multiplicity_mean']:.6g}, +2 mean "
              f"{rep['nonminimal_plus2_mean']:.6g}, ecmp tput "
              f"{rep['ecmp_saturation_throughput']:.6g}, lambda2 "
              f"{rep['fiedler_lambda2']:.6g}")
    print(f"  reports match reference.json; largest spectral deviation "
          f"{worst:.3g} (rtol 1e-2)")
    check(torch.equal(dw, dt) and torch.equal(mw, ct),
          "hyperx: wavefront (dist, mult) != tropical_count_relaxation")
    print(f"  hyperx ({graphs['hyperx'].n} routers): wavefront dist and mult "
          f"bit-equal to tropical_count_relaxation on the card")
    for fam, res in results.items():
        check_throughput(fam, res, ref["throughput"][fam])
        print(f"  {fam} throughput ({tp_graphs[fam].n} routers): lambda in "
              f"[{res['throughput']:.9g}, {res['upper_bound']:.9g}], "
              f"rounds {res['rounds']}, converged {res['converged']}: "
              f"matches reference.json (rtol 1e-9)")
    for name in ANALYSIS_KERNELS:
        check(counts[name] > 0, f"analysis path: {name} never launched")

    # where the device time goes: one report and one throughput again,
    # under the profiler (after the counted run, so it does not count)
    for label, run in (
            ("dragonfly report", lambda: AnalysisEngine(
                graphs["dragonfly"], device="cuda").report(stages)),
            ("fattree throughput", lambda: AnalysisEngine(
                tp_graphs["fattree"], device="cuda",
                **ref["throughput_settings"]).throughput())):
        rows, wall = profiled(run)
        busy = sum(t for _, _, t in rows)
        if busy <= 0:
            print(f"  profile {label}: device busy share not measured "
                  f"(no device activity in the profile)")
            continue
        print(f"  profile {label}: wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.2f}%), idle "
              f"{100 * (1 - busy / wall):.2f}%")
        for name, c, t in rows[:6]:
            print(f"    {t:9.3f} ms x{c:<5d} {name[:90]}")
    return counts, reports


def plain_chain(T, AnalysisEngine, card_reports, ref, fam="hyperx"):
    """The same report on the CPU through the plain versions, held to the
    card's: the kernel and plain chains agree at full width."""
    g = T.by_servers(fam, ref["servers"]["reports"])
    t0 = time.perf_counter()
    rep = AnalysisEngine(g, device="cpu").report(
        AnalysisEngine.DEFAULT_STAGES + ("comparison",))
    worst = check_report(f"{fam} (plain vs card)", rep, card_reports[fam])
    print(f"  plain chain ({fam}, CPU, {time.perf_counter() - t0:.2f} s) "
          f"matches the card's report; spectral deviation {worst:.3g}")


# -- phase 7: the extreme-scale path ----------------------------------------------

#: the families whose numpy generators build ~100k routers in seconds
#: (experiments/extreme/time_generators.py times all twelve)
EXTREME_FAMILIES = ("hammingmesh", "hypercube", "megafly", "dragonfly",
                    "fattree", "torus")
#: keeps a ~100k-router uint8 adjacency (10-17 GB) resident on the card
RESIDENT_BUDGET = 24 << 30


def check_same(got, want, what, rtol=1e-9):
    """Integers, bools, strings and None equal; floats (the CI bounds
    among them) within ``rtol``; timing keys skipped."""
    if isinstance(want, dict):
        keys = set(want) - {"elapsed_s", "peak_rss_mb"}
        check(set(got) - {"elapsed_s", "peak_rss_mb"} == keys,
              f"{what}: keys differ")
        for k in keys:
            check_same(got[k], want[k], f"{what}.{k}", rtol)
    elif isinstance(want, list):
        check(len(got) == len(want), f"{what}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            check_same(g, w, f"{what}[{i}]", rtol)
    elif isinstance(want, float):
        check(_close(got, want, rtol), f"{what}: {got} vs {want} (rtol {rtol})")
    else:
        check(got == want, f"{what}: {got!r} != {want!r}")


def spot_checked(D, packed=True):
    """Wrap the tiled pump so the first row of every run's first tile is
    kept; ``verify()`` then holds each kept row to the CSR Brandes oracle,
    bit-equal after packing (the JAX CLI's spot check), after the timed
    run."""
    real = D.tiled_dist_mult_tiles
    kept = []

    def pump(source, *args, **kw):
        ids = kw.get("source_ids")
        first = True
        for r0, r1, d, m in real(source, *args, **kw):
            if first:
                i = int(ids[r0]) if ids is not None else r0
                kept.append((source, i, d[0].copy(), m[0].copy()))
                first = False
            yield r0, r1, d, m

    def verify():
        for g, i, d, m in kept:
            od, osig = D.oracle_rows(g, i, packed)
            check(np.array_equal(d, od) and np.array_equal(m, osig),
                  f"{g.name}: source {i} differs from the BFS oracle")
        return [(g, i, int((m == D.S.MULT_SAT).sum())) for g, i, _, m
                in kept]

    D.tiled_dist_mult_tiles = pump
    return real, verify


def extreme_phase(obs, S, SW, D, WF, ref, stack):
    """The extreme-scale path on the card, counted: (a) the 4096-router
    sampled sweep and tiled summary held to ``ref``; (b) six families at
    ~100k routers, adjacency resident, one sampled source each held to the
    BFS oracle; (c) dragonfly streamed under the default budget, rows
    equal to (b)'s; (d) the packed wavefront on phase 5's stack against
    the fp32 one. Returns the launches."""
    obs.enable()
    torch.cuda.synchronize()
    S.reset_launches()
    t_phase = time.perf_counter()

    # (a) the reference
    t0 = time.perf_counter()
    got = SW.sweep_extreme(device="cuda", **ref["sweep_settings"])
    check_same(json.loads(json.dumps(got)), ref["sweep"], "sweep@4096")
    st = ref["tiled_settings"]
    from repro_torch.core import topology as T

    g = T.make(st["family"], n=st["n"], r=st["r"], seed=st["seed"])
    summ = D.tiled_summary(g, sources=tuple(st["sources"]),
                           packed=st["packed"], device="cuda")
    check_same(json.loads(json.dumps(summ)), ref["tiled_summary"],
               "tiled_summary")
    print(f"[7a reference] 12-family sweep at 4096 routers and the "
          f"{g.name} tiled summary match reference.json "
          f"({time.perf_counter() - t0:.2f} s)")

    # (b) full width, resident
    real, verify = spot_checked(D)
    rows = {}
    try:
        for fam in EXTREME_FAMILIES:
            obs.reset()
            before = dict(S.launches)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = SW.sweep_extreme([fam], target_routers=100_000,
                                   k_sources=32, seed=0,
                                   adjacency_budget=RESIDENT_BUDGET,
                                   device="cuda")
            (row,) = res["rows"]
            check("error" not in row, f"{fam}: {row.get('error')}")
            rows[fam] = row
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            spans = obs.span_summary()
            levels = [ev["args"].get("levels") for ev in obs.events()
                      if ev.get("name") == "tiled.tile"]
            per_level = (spans["tiled.tile"]["total_ms"]
                         / max(1, sum(v or 0 for v in levels)))
            launched = {k: v - before[k] for k, v in S.launches.items()
                        if v != before[k]}
            print(f"[7b 100k resident] {row['family']}: {row['routers']} "
                  f"routers, diameter >= {row['diameter_lb']}, avg_spl "
                  f"{row['avg_spl']:.6g}, mult_mean {row['mult_mean']:.6g}, "
                  f"saturated {row['saturated']}; build "
                  f"{spans['sweep.extreme.build']['total_ms']:.1f} ms, "
                  f"levels {levels} in "
                  f"{spans['tiled.tile']['total_ms']:.1f} ms "
                  f"({per_level:.3f} ms a level), family "
                  f"{spans['sweep.extreme.family']['total_ms']:.1f} ms; "
                  f"launches {launched}; peak device memory "
                  f"{peak_gb:.2f} GiB")
            check(row["sampled_sources"] == 32
                  and np.isfinite(row["avg_spl"]) and row["avg_spl"] > 1
                  and 0 < row["reached_frac"] <= 1, f"bad row {row}")
    finally:
        D.tiled_dist_mult_tiles = real
    t0 = time.perf_counter()
    graphs = {}
    for g, i, sat in verify():
        graphs[g.name.split("(")[0]] = g
        print(f"  {g.name}: sampled source {i} bit-equal to bfs_dist_sigma "
              f"({sat} cells clamped at MULT_SAT)")
    print(f"  oracle checks {time.perf_counter() - t0:.2f} s")

    # (c) dragonfly again, streamed through the pinned pump
    obs.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = S.launches["count_matmul_narrow"]
    t0 = time.perf_counter()
    res = SW.sweep_extreme(["dragonfly"], target_routers=100_000,
                           k_sources=32, seed=0, device="cuda")
    wall = time.perf_counter() - t0
    (row,) = res["rows"]
    check_same(row, rows["dragonfly"], "dragonfly streamed vs resident",
               rtol=0.0)
    dragonfly_row = rows["dragonfly"]
    spans = obs.span_summary()
    print(f"[7c 100k streamed] {row['family']}: rows equal to the resident "
          f"run; {wall:.2f} s (family "
          f"{spans['sweep.extreme.family']['total_ms']:.1f} ms, resident "
          f"{rows['dragonfly']['elapsed_s']} s in the estimator); "
          f"{S.launches['count_matmul_narrow'] - before} panel products; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    obs.disable()

    # (d) the packed wavefront on the full-width stack
    p = WF.pad_block(stack.shape[-1])
    adj8 = torch.from_numpy(WF.pad_operand(stack, p, 0, np.uint8)).cuda()
    t0 = time.perf_counter()
    dp, mp, sat = WF.dist_mult_device(adj8, packed=True)
    torch.cuda.synchronize()
    t_packed = time.perf_counter() - t0
    adj = adj8.float()
    t0 = time.perf_counter()
    df, mf = WF.dist_mult_device(adj)
    torch.cuda.synchronize()
    t_f32 = time.perf_counter() - t0
    check(torch.equal(S.unpack_dist(dp), df), "packed stack: dist differs")
    big = mf >= EXACT
    check(torch.equal(mp[~big].float(), mf[~big]),
          "packed stack: mult below 2**24 differs")
    check(bool((mp[big] == S.MULT_SAT).all()),
          "packed stack: mult at or above 2**24 not clamped at MULT_SAT")
    check(bool(sat) == bool(big.any()) and bool(big.any()),
          "packed stack: the saturation flag is wrong")
    print(f"[7d packed stack] B={stack.shape[0]} p={p}: dist equal, mult "
          f"equal below 2**24 and MULT_SAT in all {int(big.sum())} cells at "
          f"or above it; packed {t_packed:.3f} s, fp32 {t_f32:.3f} s")
    del adj8, adj, dp, mp, df, mf, big

    counts = dict(S.launches)
    print(f"[7 extreme] {time.perf_counter() - t_phase:.2f} s; launches "
          f"{counts}")
    for name in ("frontier_step_packed", "frontier_step_packed_batched",
                 "count_matmul_narrow"):
        check(counts[name] > 0, f"extreme path: {name} never launched")

    # where the device time goes: one 32-source tile of the pump again,
    # resident and streamed, under the profiler (after the counted run)
    ids = np.random.default_rng(0).choice(97_000, size=32, replace=False)
    for label, fam, budget in (("hammingmesh resident", "hammingmesh",
                                RESIDENT_BUDGET),
                               ("dragonfly streamed", "dragonfly",
                                D._ADJ_BUDGET)):
        rows, wall = profiled(lambda: list(D.tiled_dist_mult_tiles(
            graphs[fam], source_ids=np.sort(ids), packed=True,
            adjacency_budget=budget, device="cuda")))
        busy = sum(t for _, _, t in rows)
        if busy <= 0:
            print(f"  profile {label}: device busy share not measured "
                  f"(no device activity in the profile)")
            continue
        print(f"  profile {label}: wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.2f}%), idle "
              f"{100 * (1 - busy / wall):.2f}%")
        for name, c, t in rows[:6]:
            print(f"    {t:9.3f} ms x{c:<5d} {name[:90]}")
    return counts, dragonfly_row, graphs["dragonfly"]


# -- phase 8: the kernel library ---------------------------------------------------

def _cast_inputs(gen, S):
    """One operand set per op of ``kernels.ops``, in the dtypes the JAX ops
    accept besides fp32: int64 counts, bool masks, float64 distances with
    +inf, a uint32 packed frontier, int64 packed distances."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def counts(*shape):
        return torch.randint(0, 4, shape, generator=gen,
                             device="cuda") * (rand(*shape) < 0.3)

    def dist(*shape):
        x = torch.randint(0, 6, shape, generator=gen, device="cuda").double()
        return torch.where(rand(*shape) < 0.3, float("inf"), x)

    def packed_dist(*shape):
        return torch.where(rand(*shape) < 0.5, S.DIST_UNREACHED,
                           torch.randint(0, 5, shape, generator=gen,
                                         device="cuda"))

    m, k, n = 300, 200, 260
    pdist = packed_dist(m, n)
    da, db = dist(m, k), dist(k, n)
    return {
        "minplus_matmul": (dist(m, k), dist(k, n)),
        "reachability_step": (rand(m, k) < 0.02, rand(k, n) < 0.02),
        "count_matmul": (counts(m, k), rand(k, n) < 0.1),
        # unreached entries carry count 0, the pairs' contract
        "minplus_count_matmul": (da, torch.where(torch.isfinite(da),
                                                 counts(m, k), 0),
                                 db, torch.where(torch.isfinite(db),
                                                 counts(k, n), 0)),
        "frontier_step": (counts(m, k), rand(k, n) < 0.1, dist(m, n)),
        "frontier_step_packed": (counts(m, k).to(torch.uint32),
                                 rand(k, n) < 0.1, pdist),
        "batched_minplus_matmul": (dist(2, m, k), dist(2, k, n)),
        "batched_count_matmul": (counts(2, m, k), rand(2, k, n) < 0.1),
        "batched_frontier_step": (counts(2, m, k), rand(2, k, n) < 0.1,
                                  dist(2, m, n)),
        "batched_frontier_step_packed": (counts(2, m, k), rand(2, k, n) < 0.1,
                                         packed_dist(2, m, n)),
        "value_histogram": (torch.where(rand(m, n) < 0.1, float("inf"),
                                        dist(m, n) * 11 - 3),),
    }


def _closure(ops, adj):
    """Reachability closure of a 2D fp32 adjacency: R <- R (x) R from
    A + I over the boolean semiring until nothing changes. Returns (R,
    products)."""
    eye = torch.eye(adj.shape[-1], device=adj.device)
    r = ((adj + eye) > 0).float()
    steps = 0
    while True:
        nxt = ops.reachability_step(r, r)
        steps += 1
        if torch.equal(nxt, r):
            return nxt, steps
        r = nxt


def squaring_seed(SW, WF, graphs):
    """Phase 5's stack as the stacked squaring's seed: edge lengths, +inf
    off the edges, padded to the wavefront's block with +inf and zero
    (phantom) diagonals; and the stack's adjacency. Both numpy."""
    seed, adj_np = SW._stack_seeds(graphs)
    p = WF.pad_block(seed.shape[-1])
    seed = WF.pad_operand(seed, p, np.inf)
    seed[:, np.arange(p), np.arange(p)] = 0.0  # phantom diagonals
    return seed, adj_np


def library_phase(S, ops, SW, WF, graphs):
    """The kernel library on the card, counted: (a) every op of
    ``kernels.ops`` once against its ``_ref`` alias, on non-fp32 inputs;
    (b) the stacked min-plus squaring APSP (``_apsp_from_stack`` with
    ``_batched_minplus(True)``) on phase 5's full-width stack, padded to
    2048, against the wavefront's distances; (c) the boolean closure of
    the largest-diameter graph and of a block-diagonal pair of the two
    largest (disconnected) against ``isfinite(dist)`` of the wavefront.
    Returns the launches."""
    torch.cuda.synchronize()
    S.reset_launches()
    t_phase = time.perf_counter()

    # (a) every op against its plain alias
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, xs in _cast_inputs(gen, S).items():
        extra = (65,) if name == "value_histogram" else ()
        got = getattr(ops, name)(*xs, *extra)
        want = getattr(ops, f"{name}_ref".replace("batched_frontier_step",
                                                   "frontier_step"))(
            *xs, *extra)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        check(all(g.dtype == w.dtype and torch.equal(g, w)
                  for g, w in zip(got, want)),
              f"ops.{name}: not bit-equal to its plain version")
        print(f"  [8a] ops.{name}({', '.join(str(x.dtype)[6:] for x in xs)})"
              f" -> {', '.join(str(g.dtype)[6:] for g in got)} "
              f"{tuple(got[0].shape)}: bit-equal to its _ref")

    # (b) stacked min-plus squaring vs the wavefront, full width
    seed, adj_np = squaring_seed(SW, WF, graphs)
    p = seed.shape[-1]
    adj = torch.from_numpy(WF.pad_operand(adj_np, p, 0.0)).cuda()
    dw, _ = WF.dist_mult_device(adj)
    seed_d = torch.from_numpy(seed).cuda()
    before = S.launches["batched_minplus_matmul"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    da = SW._apsp_from_stack(seed_d, SW._batched_minplus(True))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    squarings = S.launches["batched_minplus_matmul"] - before
    tiles = S.tile_launches()["batched_minplus_matmul"]  # after the window
    check(torch.equal(da, dw), "stacked squaring APSP: dist != wavefront")
    check(S._minplus_tile(seed.shape[0], p, p) == "large"
          and tiles["large"] == squarings,
          f"stacked squaring: tiles {tiles} for {squarings} squarings")
    diam = int(torch.where(torch.isfinite(dw), dw, 0.0).max())
    check(squarings == int(np.ceil(np.log2(diam))) + 1,
          f"stacked squaring: {squarings} squarings for diameter {diam}")
    print(f"[8b squaring APSP] B={seed.shape[0]} p={p}: dist bit-equal to "
          f"the wavefront; {squarings} squarings (diameter {diam}) in "
          f"{wall:.3f} ms, {wall / squarings:.3f} ms per squaring; tiles "
          f"{tiles}")
    del seed_d, da

    # (c) boolean closures against the wavefront's reachability
    deepest = int(torch.where(torch.isfinite(dw), dw, 0.0).amax(
        dim=(1, 2)).argmax())
    t0 = time.perf_counter()
    r, steps = _closure(ops, adj[deepest])
    check(torch.equal(r, torch.isfinite(dw[deepest]).float()),
          f"closure of {graphs[deepest].name}: != isfinite(dist)")
    print(f"[8c closure] {graphs[deepest].name} ({graphs[deepest].n} "
          f"routers, p={p}): equal to isfinite(dist) after {steps} boolean "
          f"products ({(time.perf_counter() - t0) * 1e3:.3f} ms)")
    i, j = sorted(range(len(graphs)), key=lambda g: -graphs[g].n)[:2]
    ni, nj = graphs[i].n, graphs[j].n
    q = WF.pad_block(ni + nj)
    pair = torch.zeros((q, q), device="cuda")
    pair[:ni, :ni] = adj[i, :ni, :ni]
    pair[ni:ni + nj, ni:ni + nj] = adj[j, :nj, :nj]
    dpair, _ = WF.dist_mult_device(pair)
    t0 = time.perf_counter()
    r, steps = _closure(ops, pair)
    reach = torch.isfinite(dpair).float()
    check(torch.equal(r, reach), "closure of the disconnected pair: != "
                                 "isfinite(dist)")
    check(not bool(reach[:ni, ni:].any()) and bool(reach[:ni, :ni].all()),
          "disconnected pair: the blocks reach each other")
    print(f"[8c closure] {graphs[i].name} + {graphs[j].name} "
          f"({ni} + {nj} routers, p={q}, disconnected): equal to "
          f"isfinite(dist) after {steps} boolean products "
          f"({(time.perf_counter() - t0) * 1e3:.3f} ms; "
          f"{float(reach.mean()):.4f} of pairs reachable)")
    del adj, dw, pair, dpair, r, reach
    torch.cuda.empty_cache()

    counts = dict(S.launches)
    print(f"[8d launches] reachability_step {counts['reachability_step']}, "
          f"batched_minplus_matmul {counts['batched_minplus_matmul']}")
    print(f"[8 kernel library] {time.perf_counter() - t_phase:.2f} s; "
          f"launches {counts}")
    # the ops cast to fp32, so the narrow panel product is off this path;
    # the generic semiring kernel runs in phase 9
    for name in set(counts) - {"count_matmul_narrow", "semiring_matmul"}:
        check(counts[name] > 0, f"kernel library: {name} never launched")
    return counts


# -- phase 9: the semiring extension point -----------------------------------------

def _user_semirings(S):
    """The user algebras phase 9 drives: max-plus (the JAX package's
    extension-point test, ``tests/test_semiring.py``), max-min (bottleneck,
    widest paths) and an MXU algebra that marks the pairs joined by at
    least two walks, into int32."""
    inf = float("inf")
    maxplus = S.Semiring(
        name="maxplus", pad_a=(-inf,), pad_b=(-inf,), acc_init=(-inf,),
        combine=lambda a, b: (a[0] + b[0],),
        kreduce=lambda f: (torch.amax(f[0], dim=1),),
        accumulate=lambda x, y: (torch.maximum(x[0], y[0]),),
        cuda_combine="out[0] = a[0] + b[0];",
        cuda_accumulate="acc[0] = fmaxf(acc[0], t[0]);")
    maxmin = S.Semiring(
        name="maxmin", pad_a=(-inf,), pad_b=(-inf,), acc_init=(-inf,),
        combine=lambda a, b: (torch.minimum(a[0], b[0]),),
        kreduce=lambda f: (torch.amax(f[0], dim=1),),
        accumulate=lambda x, y: (torch.maximum(x[0], y[0]),),
        cuda_combine="out[0] = fminf(a[0], b[0]);",
        cuda_accumulate="acc[0] = fmaxf(acc[0], t[0]);")
    two_walks = S.Semiring(
        name="two_walks", pad_a=(0.0,), pad_b=(0.0,), acc_init=(0.0,),
        mxu=True, epilogue=lambda acc: acc >= 2, cuda_epilogue="acc >= 2.f")
    return maxplus, maxmin, two_walks


def _wide_semirings(S):
    """The algebras phase 9 adds for the VPU tiles: per-field max-plus of
    3, 8 and 16 fields, float32 (-inf pads) and int32 (pads -2**30, so pad
    + pad is -2**31 and nothing wraps), keyed (fields, dtype), and a float
    sum-product, whose result depends on the order of the fold."""
    inf = float("inf")

    def maxplus(nf, integer):
        pad, init = (-2.0 ** 30, -2.0 ** 31) if integer else (-inf, -inf)
        return S.Semiring(
            name=f"maxplus{nf}{'_int' if integer else ''}", num_fields=nf,
            pad_a=(pad,) * nf, pad_b=(pad,) * nf, acc_init=(init,) * nf,
            combine=lambda a, b: tuple(x + y for x, y in zip(a, b)),
            kreduce=lambda f: tuple(torch.amax(x, dim=1) for x in f),
            accumulate=lambda x, y: tuple(torch.maximum(p, q)
                                          for p, q in zip(x, y)),
            cuda_combine="for (int f = 0; f < NF; ++f) out[f] = a[f] + b[f];",
            cuda_accumulate="for (int f = 0; f < NF; ++f) "
                            "acc[f] = sr_max(acc[f], t[f]);")

    wide = {(nf, dt): maxplus(nf, dt == torch.int32) for nf in (3, 8, 16)
            for dt in (torch.float32, torch.int32)}
    sumprod = S.Semiring(
        name="sumprod", pad_a=(0.0,), pad_b=(0.0,), acc_init=(0.0,),
        combine=lambda a, b: (a[0] * b[0],),
        kreduce=lambda f: (f[0].sum(dim=1),),
        accumulate=lambda x, y: (x[0] + y[0],),
        cuda_combine="out[0] = a[0] * b[0];", cuda_accumulate="acc[0] += t[0];")
    return wide, sumprod


def semiring_phase(S, build, seed, part):
    """The extension point on the card, counted: (a) every algebra's
    kernel built in one parallel call; (b) the generic kernel bit-equal to
    the specialized kernels on the shipped algebras (TROPICAL 2D 2048^3 and
    batched on ``seed``, phase 5's 12 x 2048^2 squaring seed; COUNTING 2D
    and B=12 on integer counts; BOOLEAN 2048^3; TROPICAL_COUNT p=512;
    ragged 300 x 200 x 260 on each), and (b'') the MXU path, which runs on
    ``count_matmul``'s two tiles, on each operand form at 2048^3 and ragged
    300 x 200 x 260 (B=3): uint8 x uint8 -> f32 and a non-integer float A
    on the tensor-core tile, an int32 B above 256 and a float B with +-inf
    and NaN on the SIMT tile, each checked against the tile its dtype and
    values pick by the device counters; (c) the user algebras bit-equal to
    their plain versions (max-plus and max-min 2D 2048^3 and B=12, the MXU
    algebra on a uint8 operand into int32); (d) a spec without device code
    raises. Every VPU-path product is also held bit-equal (NaN-equal) to
    its plain version, on the tile that the device counters must show
    (``_vpu_tile``: vpu_tiles.cuh's register-blocked tile for grids of 256
    or more of its blocks, the 32 x 32 tile elsewhere), and (f) the two
    tiles to each other on every algebra through the private seam
    ``S._semiring(..., tile=...)``: the shipped ones, max-plus, max-min, a
    float sum-product whose rounding depends on the fold order (within rtol
    k * 2**-24 of its plain version), per-field max-plus of 3 and 8 fields
    in float32 and int32 at B=2, 1024^3 (and of 16 fields, which run on
    the 32 x 32 tile at any grid, held to the plain version), odd K and N
    with bases off the 16-byte grid (the single-element loader), TROPICAL
    and TROPICAL_COUNT on NaN inputs at B=2, 2048^3 (the large tile); (g)
    TROPICAL and TROPICAL_COUNT on {0, -0, 1, 2} at 512^3, B=2 and ragged,
    on the picked and both forced tiles, sign bits held to the plain
    versions. Then (e) times. Returns (the kernel's stats, its launches)."""
    maxplus, maxmin, two_walks = _user_semirings(S)
    wide, sumprod = _wide_semirings(S)
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8
    algebras = [(S.TROPICAL, (f32,)), (S.TROPICAL_COUNT, (f32,)),
                (S.COUNTING, (f32,) * 3), (S.BOOLEAN, (f32,) * 3),
                (maxplus, (f32,)), (maxmin, (f32,)), (two_walks, (u8, i32, i32)),
                (S.COUNTING, (u8, u8, f32)), (S.COUNTING, (f32, i32, f32))]
    added = [(sr, (dt,)) for (_, dt), sr in wide.items()] + [(sumprod, (f32,))]
    t_phase = time.perf_counter()
    built = build.build_generated({S.build_key(sr, t): S.semiring_source(sr, t)
                                   for sr, t in algebras})
    print(f"[9a build] {len(built)} generated kernels in "
          f"{time.perf_counter() - t_phase:.2f} s, all nvcc calls at once")
    t0 = time.perf_counter()
    built_added = build.build_generated(
        {S.build_key(sr, t): S.semiring_source(sr, t) for sr, t in added})
    print(f"[9a build] {len(built_added)} more (the wide algebras and the "
          f"sum-product) in {time.perf_counter() - t0:.2f} s, all at once")
    for res in (*built.values(), *built_added.values()):
        print(f"  {res.path.name}: nvcc {res.seconds:.2f} s")
        for u in build.kernel_usage(res.log):
            tile = ("large VPU tile" if "big_tile" in u["name"] else
                    "32x32 VPU tile" if "vpu_tile" in u["name"] else
                    u["name"][:60])
            vec = (" (16-byte loader)" if "Lb1E" in u["name"] else
                   " (single-element loader)" if "big_tile" in u["name"]
                   else "")
            print(f"    {tile}{vec}: {u['registers']} registers, spills "
                  f"{u['spill_stores']} / {u['spill_loads']} B, static smem "
                  f"{u['smem']} B")
    for nf in (1, 2, 3, 4, 8, 12, 16):
        print(f"  large VPU tile, {nf} field(s): {S._vpu_config(nf)}")

    torch.cuda.synchronize()
    S.reset_launches()
    expected = 0
    err = 0.0

    def gen(sr, a, b, out_dtype=None):
        nonlocal expected
        expected += 1
        fn = S.semiring_matmul_batched if a[0].ndim == 3 else S.semiring_matmul
        return fn(sr, a, b, out_dtype=out_dtype)

    def same(tag, got, want):
        nonlocal err
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        check(len(got) == len(want) and all(
            g.dtype == w.dtype and torch.equal(g, w)
            for g, w in zip(got, want)), f"{tag}: not bit-equal")
        err = max([err] + [_abs_err(g, w) for g, w in zip(got, want)])
        print(f"  {tag}: bit-equal")

    picks = {"simt": 0, "tensor": 0}  # the MXU path's expected tiles
    vpu_picks = {"small": 0, "large": 0}  # the VPU path's

    def vpu(sr, a, b, tile=None):
        """A VPU-path product, on ``tile`` (the seam) or on the one the
        grid picks, checked by the device counters."""
        nonlocal expected
        lead = a[0].shape[0] if a[0].ndim == 3 else 1
        want = tile or S._vpu_tile(lead, a[0].shape[-2], b[0].shape[-1],
                                   sr.num_fields)
        before = S.tile_launches()["semiring_matmul_vpu"]
        expected += 1
        got = S._semiring(sr, a, b, None, True, a[0].ndim == 3, tile=tile)
        after = S.tile_launches()["semiring_matmul_vpu"]
        took = {t: after[t] - before[t] for t in after if after[t] != before[t]}
        check(took == {want: 1}, f"{sr.name} {tuple(a[0].shape)} x "
                                 f"{tuple(b[0].shape)}: VPU tiles {took}, "
                                 f"expected {want}")
        vpu_picks[want] += 1
        return got

    def plain(sr, a, b):
        return (S.semiring_matmul_batched_ref if a[0].ndim == 3
                else S.semiring_matmul_ref)(sr, a, b)

    def fields_equal(got, want):
        return len(got) == len(want) and all(
            g.dtype == w.dtype and (nan_equal(g, w) if g.is_floating_point()
                                    else torch.equal(g, w))
            for g, w in zip(got, want))

    def tiles_agree(tag, sr, a, b, big=None, against_plain=True):
        """(f) the product on both tiles (``big``: the large tile's result,
        if already made), bit-equal (NaN-equal) to each other and, unless
        ``against_plain`` is False, to the plain version. Past 12 fields,
        where there is no large tile, ``big`` is the 32x32 tile's result
        on the same grid, held to the plain version."""
        lead = a[0].shape[0] if a[0].ndim == 3 else 1
        if S._vpu_config(sr.num_fields) is None:
            check(big is not None and against_plain, f"[9f] {tag}: no "
                  f"large tile, and nothing to hold the 32x32 tile to")
            check(fields_equal(big, plain(sr, a, b)),
                  f"[9f] {tag}: differs from its plain version")
            print(f"  [9f] {tag}: 32x32 tile (no large tile past 12 "
                  f"fields) == plain version")
            return big
        check(big is None or S._vpu_tile(
            lead, a[0].shape[-2], b[0].shape[-1],
            sr.num_fields) == "large", f"[9f] {tag}: not a large-tile grid")
        big = big if big is not None else vpu(sr, a, b, "large")
        small = vpu(sr, a, b, "small")
        torch.cuda.synchronize()
        check(fields_equal(big, small), f"[9f] {tag}: the large and the "
                                        f"32x32 VPU tile differ")
        if against_plain:
            check(fields_equal(big, plain(sr, a, b)),
                  f"[9f] {tag}: differs from its plain version")
        print(f"  [9f] {tag}: large tile == 32x32 tile"
              + (" == plain version" if against_plain else ""))
        return big

    def mxu(tile, sr, a, b, out_dtype=None):
        """The generic MXU-path product, checked to run on ``tile``."""
        before = S.tile_launches()["semiring_matmul"]
        got = gen(sr, a, b, out_dtype)
        after = S.tile_launches()["semiring_matmul"]
        took = {t: after[t] - before[t] for t in after if after[t] != before[t]}
        check(took == {tile: 1}, f"{sr.name} {tuple(a[0].shape)} "
                                 f"{a[0].dtype} x {b[0].dtype}: tiles {took}, "
                                 f"expected {tile}")
        picks[tile] += 1
        return got

    gen_t = torch.Generator(device="cuda").manual_seed(9)

    def mxu_forms(tag, f, adj):
        """(b'') the MXU path on each operand form, 2D (f[0], adj[0]) and
        stacked (f, adj): u8 x u8 -> f32 and a float A x {0,1} B (tensor-core
        tile), an int32 B up to 299 and a float B with +-inf and NaN (SIMT
        tile). Integer sums stay below 2**24: bit-equal to the plain
        version; the float A within rtol 1e-5 of it and bit-equal to
        count_matmul on the same operands."""
        for lhs, rhs in ((f[0], adj[0]), (f, adj)):
            form = f"{'B=%d ' % lhs.shape[0] if lhs.ndim == 3 else '2D '}{tag}"
            shape_a, shape_b = lhs.shape, rhs.shape
            ua = torch.randint(0, 16, shape_a, generator=gen_t,
                               device="cuda").to(u8)
            ub = torch.randint(0, 16, shape_b, generator=gen_t,
                               device="cuda").to(u8)
            same(f"[9b''] COUNTING {form} u8 x u8 -> f32 vs its plain version "
                 f"and count_matmul on fp32 casts",
                 mxu("tensor", S.COUNTING, (ua,), (ub,), f32),
                 S.semiring_matmul_batched_ref(S.COUNTING, (ua,), (ub,), f32))
            check(torch.equal(gen(S.COUNTING, (ua,), (ub,), f32)[0],
                              S.count_matmul(ua.float(), ub.float())),
                  f"COUNTING {form} u8 x u8: not count_matmul on the casts")
            ib = torch.randint(0, 300, shape_b, generator=gen_t,
                               device="cuda").to(i32)
            same(f"[9b''] COUNTING {form} f32 x i32 (values to 299) -> f32 vs "
                 f"its plain version (SIMT tile)",
                 mxu("simt", S.COUNTING, (lhs,), (ib,), f32),
                 S.semiring_matmul_batched_ref(S.COUNTING, (lhs,), (ib,), f32))
            special = rhs.clone()
            for i, v in enumerate((float("inf"), -float("inf"),
                                   float("nan"))):
                special.view(-1)[7919 * i::3 * 7919] = v
            got = mxu("simt", S.COUNTING, (lhs,), (special,))[0]
            want = S.count_matmul_ref(lhs, special)
            torch.cuda.synchronize()
            check(nan_equal(got, want) and nan_equal(
                got, S.count_matmul(lhs, special)),
                f"COUNTING {form}, +-inf and NaN in B: differs from its "
                f"plain version or count_matmul")
            check(bool(torch.isinf(want).any()) and bool(
                torch.isnan(want).any()), f"{form}: no inf and NaN")
            print(f"  [9b''] COUNTING {form}, B with +-inf and NaN (SIMT "
                  f"tile): NaN-equal to its plain version and count_matmul "
                  f"({int(torch.isinf(got).sum())} inf, "
                  f"{int(torch.isnan(got).sum())} NaN cells)")
            za = torch.rand(shape_a, generator=gen_t, device="cuda")
            got = mxu("tensor", S.COUNTING, (za,), (rhs,))[0]
            want = S.count_matmul_ref(za, rhs)
            torch.cuda.synchronize()
            rel = float(((got - want).abs() / want.abs().clamp_min(
                torch.finfo(torch.float32).tiny)).max())
            check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
                  f"COUNTING {form}, float A: beyond rtol 1e-5 ({rel:g})")
            check(torch.equal(got, S.count_matmul(za, rhs)),
                  f"COUNTING {form}, float A: not count_matmul bit for bit")
            print(f"  [9b''] COUNTING {form}, non-integer float A x {{0,1}} "
                  f"(tensor-core tile): within rtol 1e-5 of its plain "
                  f"version (max rel err {rel:g}), bit-equal to count_matmul")

    # (b) the shipped algebras against the specialized kernels
    stack = seed
    bsz, p = stack.shape[0], stack.shape[-1]
    main = {}
    for m, n, k, b_ in ((p, p, p, bsz), (300, 200, 260, 3)):
        tag = f"{m}x{n}x{k}"
        a = _lengths(gen_t, (m, k), 0.5)
        b = _lengths(gen_t, (k, n), 0.5)
        got = vpu(S.TROPICAL, (a,), (b,))
        same(f"[9b] TROPICAL {tag} vs minplus_matmul", got,
             S.minplus_matmul(a, b))
        same(f"[9b] TROPICAL {tag} vs its plain version", got,
             S.semiring_matmul_ref(S.TROPICAL, (a,), (b,)))
        sa, sb = ((stack, stack) if m == p else
                  (_lengths(gen_t, (b_, m, k), 0.5),
                   _lengths(gen_t, (b_, k, n), 0.5)))
        got = vpu(S.TROPICAL, (sa,), (sb,))
        same(f"[9b] TROPICAL B={b_} {tag} vs batched_minplus_matmul"
             + (" (phase 5's squaring seed)" if m == p else ""), got,
             S.batched_minplus_matmul(sa, sb))
        same(f"[9b] TROPICAL B={b_} {tag} vs its plain version", got,
             S.batched_minplus_matmul_ref(sa, sb))
        if m == p:
            tiles_agree(f"TROPICAL B={b_} {tag}", S.TROPICAL, (sa,), (sb,),
                        big=got, against_plain=False)
        f, _, adj, _, _ = _inputs(gen_t, b_, m, n, k)
        same(f"[9b] COUNTING B={b_} {tag} vs count_matmul (tensor-core tile)",
             mxu("tensor", S.COUNTING, (f,), (adj,)), S.count_matmul(f, adj))
        same(f"[9b] COUNTING {tag} vs count_matmul (tensor-core tile)",
             mxu("tensor", S.COUNTING, (f[0],), (adj[0],)),
             S.count_matmul(f[0], adj[0]))
        ma = (torch.rand((m, k), generator=gen_t, device="cuda") < 0.02).float()
        mb = (torch.rand((k, n), generator=gen_t, device="cuda") < 0.02).float()
        same(f"[9b] BOOLEAN {tag} vs reachability_step (tensor-core tile)",
             mxu("tensor", S.BOOLEAN, (ma,), (mb,)),
             S.reachability_step(ma, mb))
        mxu_forms(tag, f, adj)
        if m == p:
            main.update(trop=(a, b), count=(f, adj), mask=(ma, mb))
            m, n, k = 512, 512, 512
        da = _lengths(gen_t, (m, k), 0.3, integer=True)
        db = _lengths(gen_t, (k, n), 0.3, integer=True)
        ca = torch.where(torch.isfinite(da), torch.randint(
            1, 4, (m, k), generator=gen_t, device="cuda").float(), 0.0)
        cb = torch.where(torch.isfinite(db), torch.randint(
            1, 4, (k, n), generator=gen_t, device="cuda").float(), 0.0)
        got = vpu(S.TROPICAL_COUNT, (da, ca), (db, cb))
        same(f"[9b] TROPICAL_COUNT {m}x{n}x{k} vs minplus_count_matmul", got,
             S.minplus_count_matmul(da, ca, db, cb))
        same(f"[9b] TROPICAL_COUNT {m}x{n}x{k} vs its plain version", got,
             S.semiring_matmul_ref(S.TROPICAL_COUNT, (da, ca), (db, cb)))
        if m == 512:
            main["tc"] = (da, ca, db, cb)

    # (b') NaN inputs: the shipped TROPICAL and TROPICAL_COUNT device code
    # propagates NaN as the plain versions (and the JAX package) do
    for m, n, k in ((512, 512, 512), (300, 200, 260)):
        a = with_nans(gen_t, _lengths(gen_t, (m, k), 0.3))
        b = with_nans(gen_t, _lengths(gen_t, (k, n), 0.3))
        got = vpu(S.TROPICAL, (a,), (b,))
        want = S.semiring_matmul_ref(S.TROPICAL, (a,), (b,))
        sa = with_nans(gen_t, _lengths(gen_t, (2, m, k), 0.3))
        sb = with_nans(gen_t, _lengths(gen_t, (2, k, n), 0.3))
        bgot = vpu(S.TROPICAL, (sa,), (sb,))
        bwant = S.semiring_matmul_batched_ref(S.TROPICAL, (sa,), (sb,))
        da = with_nans(gen_t, _lengths(gen_t, (m, k), 0.3, integer=True))
        db = with_nans(gen_t, _lengths(gen_t, (k, n), 0.3, integer=True))
        ca = torch.where(torch.isfinite(da), 2.0, 0.0)
        cb = torch.where(torch.isfinite(db), 3.0, 0.0)
        tc = vpu(S.TROPICAL_COUNT, (da, ca), (db, cb))
        tc_want = S.semiring_matmul_ref(S.TROPICAL_COUNT, (da, ca), (db, cb))
        torch.cuda.synchronize()
        tag = f"{m}x{n}x{k}"
        check(nan_equal(got[0], want[0]) and nan_equal(bgot[0], bwant[0]),
              f"[9b] TROPICAL NaN {tag}: differs from its plain version")
        check(all(nan_equal(g, w) for g, w in zip(tc, tc_want)),
              f"[9b] TROPICAL_COUNT NaN {tag}: differs from its plain version")
        check(bool(torch.isnan(want[0]).any())
              and bool(torch.isnan(tc_want[0]).any()),
              f"[9b] NaN {tag}: no NaN reached the output")
        print(f"  [9b] TROPICAL (2D, B=2) and TROPICAL_COUNT {tag} on NaN "
              f"inputs: NaN-equal to their plain versions")

    # (g) -0 inputs: the shipped TROPICAL and TROPICAL_COUNT device code
    # ranks -0 below +0, as the plain versions (and jnp.min) do; sign bits
    # compared, on the tile the grid picks and on both tiles forced
    def signed(*shape):
        vals = torch.tensor([0.0, -0.0, 1.0, 2.0], device="cuda")
        pick = torch.multinomial(torch.tensor([0.3, 0.1, 0.3, 0.3],
                                              device="cuda"),
                                 int(np.prod(shape)), replacement=True,
                                 generator=gen_t)
        return vals[pick].reshape(shape)

    for lead, m, n, k in (((), 512, 512, 512), ((2,), 512, 512, 512),
                          ((), 300, 200, 260)):
        a, b = signed(*lead, m, k), signed(*lead, k, n)
        ca = torch.randint(1, 4, a.shape, generator=gen_t,
                           device="cuda").float()
        cb = torch.randint(1, 4, b.shape, generator=gen_t,
                           device="cuda").float()
        tag = f"{'B=2 ' if lead else ''}{m}x{n}x{k}"
        for sr, fa, fb in ((S.TROPICAL, (a,), (b,)),
                           (S.TROPICAL_COUNT, (a, ca), (b, cb))):
            want = plain(sr, fa, fb)
            torch.cuda.synchronize()
            zero = want[0] == 0
            neg, pos = zero & torch.signbit(want[0]), zero & ~torch.signbit(
                want[0])
            check(bool(neg.any()) and bool(pos.any()),
                  f"[9g] {sr.name} {tag}: the plain version holds not both "
                  f"-0 and +0")
            for tile in (None, "small", "large"):
                got = vpu(sr, fa, fb, tile)
                torch.cuda.synchronize()
                check(bit_equal(got[0], want[0]) and all(
                    torch.equal(g, w) for g, w in zip(got[1:], want[1:])),
                    f"[9g] {sr.name} {tag} on tile {tile or 'picked'}: "
                    f"differs from its plain version in value or sign bit")
            print(f"  [9g] {sr.name} {tag} on {{0, -0, 1, 2}}: the picked "
                  f"tile and both forced tiles bit-equal to the plain "
                  f"version, sign bits included ({int(neg.sum())} -0 and "
                  f"{int(pos.sum())} +0 cells)")

    # (c) the user algebras against their plain versions
    def scores(*shape):
        x = 10 * torch.rand(shape, generator=gen_t, device="cuda")
        return torch.where(torch.rand(shape, generator=gen_t, device="cuda")
                           < 0.1, -float("inf"), x)

    plain_once = {}
    for sr in (maxplus, maxmin):
        a, b = scores(p, p), scores(p, p)
        same(f"[9c] {sr.name} {p}^3 vs its plain version",
             vpu(sr, (a,), (b,)), S.semiring_matmul_ref(sr, (a,), (b,)))
        sa, sb = scores(bsz, p, p), scores(bsz, p, p)
        got = vpu(sr, (sa,), (sb,))
        tiles_agree(f"{sr.name} B={bsz} {p}^3", sr, (sa,), (sb,), big=got,
                    against_plain=False)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = S.semiring_matmul_batched_ref(sr, (sa,), (sb,))
        end.record()
        end.synchronize()
        plain_once[sr.name] = start.elapsed_time(end)
        same(f"[9c] {sr.name} B={bsz} {p}^3 vs its plain version "
             f"({plain_once[sr.name]:.1f} ms)", got, want)
        main[sr.name] = ((a, b), (sa, sb))
        del want
    wa = (torch.rand((p, p), generator=gen_t, device="cuda") < 0.01).to(u8)
    wb = (torch.rand((p, p), generator=gen_t, device="cuda") < 0.05).to(i32)
    got = mxu("tensor", two_walks, (wa,), (wb,), out_dtype=i32)
    same(f"[9c] two_walks {p}^3, uint8 x int32 -> int32 vs its plain "
         f"version ({float(got[0].float().mean()):.4f} of pairs set)", got,
         S.semiring_matmul_ref(two_walks, (wa,), (wb,), out_dtype=i32))
    main["two_walks"] = (wa, wb)

    # (f) the two VPU tiles agree on every algebra; the wide algebras, odd
    # shapes and NaN inputs on the large tile
    wide_ops = {}
    for (nf, dt), sr in wide.items():
        def field(*shape):
            if dt == i32:
                return torch.randint(0, 1000, shape, generator=gen_t,
                                     device="cuda", dtype=i32)
            return scores(*shape)
        a = tuple(field(2, 1024, 1024) for _ in range(nf))
        b = tuple(field(2, 1024, 1024) for _ in range(nf))
        tiles_agree(f"{sr.name} ({nf} fields, {str(dt)[6:]}) B=2 1024^3",
                    sr, a, b, big=vpu(sr, a, b))
        wide_ops[sr.name] = (a, b)
    for sr, (m, n, k) in ((S.TROPICAL_COUNT, (2048, 2048, 2048)),
                          (maxplus, (1024, 1024, 1024)),
                          (maxmin, (1024, 1024, 1024))):
        lead = (2,) if sr is S.TROPICAL_COUNT else (4,)
        if sr is S.TROPICAL_COUNT:
            da = _lengths(gen_t, (*lead, m, k), 0.3, integer=True)
            db = _lengths(gen_t, (*lead, k, n), 0.3, integer=True)
            a = (da, torch.where(torch.isfinite(da), 2.0, 0.0))
            b = (db, torch.where(torch.isfinite(db), 3.0, 0.0))
        else:
            a, b = (scores(*lead, m, k),), (scores(*lead, k, n),)
        tiles_agree(f"{sr.name} B={lead[0]} {m}x{n}x{k}", sr, a, b,
                    big=vpu(sr, a, b))
    # a float sum of products: the fold order decides the rounding, so the
    # tiles must agree bit for bit; the plain version (slabs of 8 summed
    # first) within rtol k * 2**-24
    sa_, sb_ = (torch.rand((4, 1024, 1024), generator=gen_t, device="cuda")
                for _ in range(2))
    big = tiles_agree("sumprod B=4 1024^3 (non-integer values)", sumprod,
                      (sa_,), (sb_,), big=vpu(sumprod, (sa_,), (sb_,)),
                      against_plain=False)
    want = plain(sumprod, (sa_,), (sb_,))
    torch.cuda.synchronize()
    rel = float(((big[0] - want[0]).abs() / want[0].abs()).max())
    check(torch.allclose(big[0], want[0], rtol=1024 * 2.0 ** -24, atol=0.0),
          f"sumprod: beyond rtol k * 2**-24 of its plain version ({rel:g})")
    check(not torch.equal(big[0], want[0]),
          "sumprod: the fold order changed nothing; pick other values")
    print(f"  [9f] sumprod B=4 1024^3: within rtol k * 2**-24 of its plain "
          f"version (max rel err {rel:g}; not bit-equal to it, as expected)")
    # odd K and N, and bases one element off the 16-byte grid: the large
    # tile's single-element loader (4 x 8 x 8 = 256 blocks)
    def offset(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
        y = buf[1:].view(x.shape)
        y.copy_(x)
        return y

    m, n, k = 1023, 1021, 1025
    for sr in (maxplus, wide[(3, i32)], S.TROPICAL_COUNT):
        if sr is S.TROPICAL_COUNT:
            da = _lengths(gen_t, (4, m, k), 0.3, integer=True)
            db = _lengths(gen_t, (4, k, n), 0.3, integer=True)
            a = (da, torch.where(torch.isfinite(da), 2.0, 0.0))
            b = (db, torch.where(torch.isfinite(db), 3.0, 0.0))
        elif sr.num_fields == 1:
            a, b = (scores(4, m, k),), (scores(4, k, n),)
        else:
            a = tuple(torch.randint(0, 1000, (4, m, k), generator=gen_t,
                                    device="cuda", dtype=i32)
                      for _ in range(sr.num_fields))
            b = tuple(torch.randint(0, 1000, (4, k, n), generator=gen_t,
                                    device="cuda", dtype=i32)
                      for _ in range(sr.num_fields))
        a, b = tuple(map(offset, a)), tuple(map(offset, b))
        check(a[0].data_ptr() % 16 != 0, "offset base is 16-byte aligned")
        tiles_agree(f"{sr.name} B=4 {m}x{n}x{k}, bases 4 bytes off the "
                    f"16-byte grid (single-element loader)", sr, a, b,
                    big=vpu(sr, a, b))
    # NaN inputs on the large tile
    sa_ = with_nans(gen_t, _lengths(gen_t, (2, p, p), 0.3))
    sb_ = with_nans(gen_t, _lengths(gen_t, (2, p, p), 0.3))
    got = tiles_agree(f"TROPICAL B=2 {p}^3 on NaN inputs", S.TROPICAL,
                      (sa_,), (sb_,), big=vpu(S.TROPICAL, (sa_,), (sb_,)))
    check(bool(torch.isnan(got[0]).any()), "TROPICAL NaN: none reached")
    da = with_nans(gen_t, _lengths(gen_t, (2, p, p), 0.3, integer=True))
    db = with_nans(gen_t, _lengths(gen_t, (2, p, p), 0.3, integer=True))
    ca = torch.where(torch.isfinite(da), 2.0, 0.0)
    cb = torch.where(torch.isfinite(db), 3.0, 0.0)
    got = tiles_agree(f"TROPICAL_COUNT B=2 {p}^3 on NaN inputs",
                      S.TROPICAL_COUNT, (da, ca), (db, cb),
                      big=vpu(S.TROPICAL_COUNT, (da, ca), (db, cb)))
    check(bool(torch.isnan(got[0]).any()), "TROPICAL_COUNT NaN: none reached")
    print(f"  [9f] VPU tiles run: {vpu_picks}")

    # (d) no device code: the card refuses, the plain version never runs
    bare = dataclasses.replace(maxplus, cuda_combine=None,
                               cuda_accumulate=None)
    try:
        S.semiring_matmul(bare, main["maxplus"][0][:1], main["maxplus"][0][1:])
        check(False, "a spec without device code ran on the card")
    except NotImplementedError as e:
        print(f"  [9d] without device code: NotImplementedError ({e})")

    torch.cuda.synchronize()
    launched = S.launches["semiring_matmul"]
    check(launched == expected, f"semiring_matmul launches {launched}, "
                                f"expected {expected}")
    counters = S.tile_launches()["semiring_matmul"]
    print(f"  [9b''] the generic MXU path's tile counters {counters}, "
          f"expected picks {picks} plus the unchecked repeats")
    check(all(counters[t] >= picks[t] > 0 for t in picks),
          f"generic MXU tile counters {counters} below the picks {picks}")
    vpu_counters = S.tile_launches()["semiring_matmul_vpu"]
    print(f"  [9f] the generic VPU path's tile counters {vpu_counters}, "
          f"checked picks {vpu_picks}")
    check(all(vpu_counters[t] >= vpu_picks[t] > 0 for t in vpu_picks),
          f"generic VPU tile counters {vpu_counters} below the picks "
          f"{vpu_picks}")
    print(f"[9 semiring] launches {dict(S.launches)}; semiring_matmul "
          f"{launched} as expected")

    # (e) times at the main shapes
    def bounds(sr, a, b):
        """(ops at the rate of their kind, bytes) of one product: each
        field of each operand read once, each output field (fp32 or int32)
        written once."""
        lead = a.shape[0] if a.ndim == 3 else 1
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        ijk = float(lead) * m * n * k
        nbytes = sr.num_fields * (a.numel() * a.element_size()
                                  + b.numel() * b.element_size()
                                  + 4.0 * lead * m * n)
        if sr.mxu:  # 2 M N K at the FMA-counted fp32 peak
            return 2.0 * ijk, nbytes
        # one op per combine and per accumulate, per field, at one per lane
        # per clock: for TROPICAL_COUNT 4, as phase 3 bounds its specialized
        # kernel (the add, the compare, the count product and its
        # accumulation), whatever its device code issues
        return 2.0 * sr.num_fields * ijk / NON_FMA, nbytes

    (ta, tb), (fc, adjc), (ma, mb) = main["trop"], main["count"], main["mask"]
    da, ca, db, cb = main["tc"]
    (xa, xb), (xsa, xsb) = main["maxplus"]
    (na, nb), (nsa, nsb) = main["maxmin"]
    tda = _lengths(gen_t, (bsz, p, p), 0.3, integer=True)
    tdb = _lengths(gen_t, (bsz, p, p), 0.3, integer=True)
    tc12 = ((tda, torch.where(torch.isfinite(tda), 2.0, 0.0)),
            (tdb, torch.where(torch.isfinite(tdb), 3.0, 0.0)))
    ra, rb = scores(300, 260), scores(260, 200)
    rsa, rsb = scores(3, 300, 260), scores(3, 260, 200)
    rta, rtb = _lengths(gen_t, (300, 260), 0.5), _lengths(gen_t, (260, 200), 0.5)
    cases = [  # label, spec, a, b, out_dtype, specialized, library, plain
        ("TROPICAL 2D", S.TROPICAL, (ta,), (tb,), None,
         lambda: S.minplus_matmul(ta, tb), None, None),
        (f"TROPICAL B={bsz}", S.TROPICAL, (stack,), (stack,), None,
         lambda: S.batched_minplus_matmul(stack, stack), None, None),
        ("COUNTING 2D", S.COUNTING, (fc[0],), (adjc[0],), None,
         lambda: S.count_matmul(fc[0], adjc[0]),
         ("torch.mm", lambda: torch.mm(fc[0], adjc[0])), None),
        (f"COUNTING B={bsz}", S.COUNTING, (fc,), (adjc,), None,
         lambda: S.count_matmul(fc, adjc),
         ("torch.bmm", lambda: torch.bmm(fc, adjc)), None),
        ("BOOLEAN 2D", S.BOOLEAN, (ma,), (mb,), None,
         lambda: S.reachability_step(ma, mb),
         ("torch.mm then > 0.5", lambda: torch.mm(ma, mb) > 0.5), None),
        ("TROPICAL_COUNT 512", S.TROPICAL_COUNT, (da, ca), (db, cb), None,
         lambda: S.minplus_count_matmul(da, ca, db, cb), None, None),
        ("maxplus 2D", maxplus, (xa,), (xb,), None, None, None,
         lambda: S.semiring_matmul_ref(maxplus, (xa,), (xb,))),
        (f"maxplus B={bsz}", maxplus, (xsa,), (xsb,), None, None, None,
         plain_once["maxplus"]),
        ("maxmin 2D", maxmin, (na,), (nb,), None, None, None,
         lambda: S.semiring_matmul_ref(maxmin, (na,), (nb,))),
        (f"maxmin B={bsz}", maxmin, (nsa,), (nsb,), None, None, None,
         plain_once["maxmin"]),
        (f"TROPICAL_COUNT B={bsz}", S.TROPICAL_COUNT, *tc12, None, None, None,
         None),
        ("maxplus 300x200x260", maxplus, (ra,), (rb,), None, None, None,
         lambda: S.semiring_matmul_ref(maxplus, (ra,), (rb,))),
        ("maxplus B=3 300x200x260", maxplus, (rsa,), (rsb,), None, None, None,
         lambda: S.semiring_matmul_batched_ref(maxplus, (rsa,), (rsb,))),
        ("TROPICAL 300x200x260", S.TROPICAL, (rta,), (rtb,), None,
         lambda: S.minplus_matmul(rta, rtb), None, None),
        ("two_walks 2D u8 x i32 -> i32", two_walks, main["two_walks"][:1],
         main["two_walks"][1:], i32, None, None,
         lambda: S.semiring_matmul_ref(two_walks, main["two_walks"][:1],
                                       main["two_walks"][1:], out_dtype=i32)),
    ]
    stats = None
    for label, sr, a, b, out_dtype, special, library, plain in cases:
        def kern():
            return gen(sr, a, b, out_dtype)

        before = S.tile_launches()["semiring_matmul"]
        ms = timed_ms(kern)
        after = S.tile_launches()["semiring_matmul"]
        ops, nbytes = bounds(sr, a[0], b[0])
        marker, tile = f"Algebra_{sr.name}", ""
        if sr.mxu:  # count_matmul's tiles: the bound of the one that ran
            (tile,) = [t for t in after if after[t] > before[t]]
            bms, by = tile_bound_ms(tile, ops, nbytes, part)
            marker = (f"{'tc' if tile == 'tensor' else 'simt'}_tile<"
                      f"repro_semiring::MxuStore<Algebra_{sr.name}>")
            tile = f", {'tensor-core' if tile == 'tensor' else 'SIMT'} tile"
        else:
            bms, by = bound_ms(ops, nbytes, part)
            lead = a[0].shape[0] if a[0].ndim == 3 else 1
            tile = S._vpu_tile(lead, a[0].shape[-2], b[0].shape[-1],
                               sr.num_fields)
            tile = f", {'large' if tile == 'large' else '32x32'} VPU tile"
        seen = []
        dev = kernel_device_ms(kern, marker, reps=10,
                               tries=1 if sr.mxu else 3, seen=seen)
        how = ""
        if dev is None and not sr.mxu:
            # the profiler came back without the kernel three times (in
            # this process, after phases 1-8, it can lose whole profiles):
            # the call launches one kernel (the counters show which), so
            # events queued behind a spin kernel time it instead
            print(f"  [9e] {label}: no device row for {marker!r} in 3 "
                  f"profiles (the last held "
                  f"{[(n[:100], c, t) for n, c, t in seen[:4]]})")
            dev, how = queued_device_ms(kern), " (events behind a spin)"
        line = (f"  [9e] {label}: {ms:.4f} ms{tile}, device "
                f"{'not measured' if dev is None else f'{dev:.4f} ms{how}'}; "
                f"bound {bms:.4f} by {by} ({100 * bms / ms:.1f}%)")
        if special is not None:
            spec_tile = ""
            if sr.name == "tropical":  # the min-plus tile the grid picks
                lead = a[0].shape[0] if a[0].ndim == 3 else 1
                spec_tile = (f" ({S._minplus_tile(lead, a[0].shape[-2], b[0].shape[-1])}"
                             f" tile)")
            line += (f"; specialized kernel {timed_ms(special):.4f} ms"
                     f"{spec_tile}")
        library_ms = None
        if library is not None:
            library_ms = timed_ms(library[1])
            line += f"; {library[0]} {library_ms:.4f} ms"
        plain_ms = None
        if plain is not None:
            plain_ms = (plain if isinstance(plain, float)
                        else timed_ms(plain, iters=3, warmup=1))
            line += f"; plain {plain_ms:.3f} ms"
        print(line)
        if label == "maxplus 2D":
            stats = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=bms, bound_by=by, max_abs_err=err)
    print(f"[9 semiring] {time.perf_counter() - t_phase:.2f} s")
    del main, cases
    torch.cuda.empty_cache()
    return stats, launched


# -- phase 10: the routing path ---------------------------------------------------

#: 10b: the weighted engine on a shared graph against a demand stack of the
#: traffic grid's default depth
DEMAND_STACK = ("dragonfly", "hotspot:zipf_a=1.4,samples=200")
#: the kernels the routing path runs
ROUTING_KERNELS = ("frontier_step", "count_matmul", "minplus_matmul",
                   "value_histogram")


def _levels(dist, weight):
    """The pair distances that carry nonzero ``weight`` (host numpy)."""
    sel = (weight != 0) & np.isfinite(dist) & (dist > 0)
    return sorted({int(x) for x in np.unique(dist[sel])})


def predicted_launches(key, dist, mult, plus1, demand):
    """Counting products the routing engine must launch for ``demand``,
    from the host's term list: the O(diameter^2) bilinear engine runs two
    products per (level, position) term of every level whose weights are
    not all zero, and the slack engine first diameter + 1 walk powers."""
    def ecmp(dem):
        ok = np.isfinite(dist) & (dist > 0) & (mult > 0)
        return sum(2 * lv for lv in _levels(dist, np.where(ok, dem, 0.0)))

    if key == "ecmp":
        return ecmp(demand)
    if key == "valiant":  # the two legs, as models.ValiantVLB builds them
        reach = np.isfinite(dist)
        dem = np.where(reach & (dist > 0), demand, 0.0)
        comp = reach.sum(axis=1, keepdims=True).astype(np.float64)
        leg1 = dem.sum(axis=1, keepdims=True) * reach / comp
        leg2 = (dem.sum(axis=0, keepdims=True).T * reach / comp).T
        return ecmp(leg1) + ecmp(leg2)
    diam = int(dist[np.isfinite(dist)].max())
    classes = ((0, mult), (1, plus1))  # slack 1: class j over its counts
    return diam + 1 + sum(
        2 * (lv + j) for j, counts in classes
        for lv in _levels(dist, np.where(counts > 0, demand, 0.0)))


def _rel_gap(got, want):
    """Largest |got - want| / |want| over want != 0, and whether got is 0
    wherever want is."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    nz = want != 0
    gap = float((np.abs(got - want)[nz] / np.abs(want[nz])).max(initial=0))
    return gap, bool((got[~nz] == 0).all())


def check_stats(what, got, want, rtol=1e-5):
    """A stats dict against the reference's: float keys within ``rtol``,
    the rest equal."""
    check(got.keys() == want.keys(), f"{what}: keys differ: "
          f"{sorted(set(got) ^ set(want))}")
    for key, w in want.items():
        if isinstance(w, float):
            check(_close(got[key], w, rtol),
                  f"{what}.{key}: {got[key]} vs {w} (rtol {rtol})")
        else:
            check(got[key] == w, f"{what}.{key}: {got[key]!r} != {w!r}")


def routing_phase(S, T, R, W, A, WF, TR, AnalysisEngine, ref, stack):
    """The routing path at full width on the card, counted: (a) the
    example's routing table (six families at ~10k servers: the sampled
    workload and ECMP, Valiant and slack-1 loads on the kernels), (b) the
    weighted Brandes engine on one graph against a 200-sample hotspot
    stack, (c) the same engine on phase 5's stack of per-sample graphs,
    (d) a TrafficSpec demand in max_concurrent_flow. Returns the launches
    of its counted run. ``stack`` is phase 5's padded adjacency stack."""
    t_phase = time.perf_counter()
    graphs = {fam: T.by_servers(fam, ref["servers"])
              for fam in ANALYSIS_FAMILIES}
    spec = TR.TrafficSpec.parse(ref["workload"])
    stack_fam, stack_spec = DEMAND_STACK
    t0 = time.perf_counter()
    batch = TR.TrafficSpec.parse(stack_spec).batch(graphs[stack_fam])
    t_gen = time.perf_counter() - t0
    tp = ref["throughput_settings"]
    tp_graph = T.by_servers(tp["family"], tp["servers"])
    tp_kw = dict(eps=tp["eps"], max_rounds=tp["max_rounds"], seed=tp["seed"],
                 device="cuda")

    # the counted run: every kernel launch of the routing path
    torch.cuda.synchronize()
    S.reset_launches()
    t_run = time.perf_counter()
    engines, rows, loads, deltas = {}, {}, {}, {}
    for fam, g in graphs.items():
        eng = engines[fam] = AnalysisEngine(g, device="cuda")
        rep = eng.report()
        wl = W.Workload(pairs=spec.pairs(g), name=spec.describe())
        rows[fam] = (rep, W.evaluate_workload(
            g, wl, dist=eng.distances(),
            mult=eng.multiplicities()["multiplicity"]), wl.demand_matrix(g))
        for key, model in routing_models(R, eng).items():
            before = S.launches["count_matmul"]
            loads[fam, key] = model.link_loads(rows[fam][2])
            deltas[fam, key] = S.launches["count_matmul"] - before
    t_table = time.perf_counter() - t_run
    eng = engines[stack_fam]
    dist_b, mult_b = eng._dist(), eng._paths()["multiplicity"]
    adj_b = torch.from_numpy(graphs[stack_fam].adjacency_dense(
        np.float32)).cuda()
    batch_d = torch.from_numpy(batch).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = S.launches["count_matmul"]
    t0 = time.perf_counter()
    loads_b = A.ecmp_demand_loads(dist_b, mult_b, adj_b, batch_d)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    delta_b = S.launches["count_matmul"] - before
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    adj_c = torch.from_numpy(stack).cuda()
    before = dict(S.launches)
    dist_c, mult_c = WF.dist_mult_device(adj_c)
    ones = (torch.isfinite(dist_c) & (dist_c > 0)).float()
    loads_c = A.ecmp_demand_loads(dist_c, mult_c, adj_c, ones)
    uniform_c = A.ecmp_all_pairs_loads(dist_c, mult_c, adj_c)
    delta_c = {k: S.launches[k] - before[k] for k in before}
    before = S.launches["minplus_matmul"]
    flow = R.max_concurrent_flow(tp_graph, tp["demand"], **tp_kw)
    flow_m = R.max_concurrent_flow(
        tp_graph, TR.as_spec(tp["demand"]).matrix(tp_graph), **tp_kw)
    delta_d = S.launches["minplus_matmul"] - before
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    counts = dict(S.launches)
    print(f"[10 routing] counted run {wall:.3f} s (10a table "
          f"{t_table:.3f} s); launches {counts}")

    # 10a: the table, each model held to its f64 path and to reference.json
    print(f"  {'family':<11}{'routers':>8}{'diam':>6}{'avg':>7}"
          f"{'mult':>7}{'+1':>8}{'interf':>8}"
          f"{'samp-max':>9}{'ecmp-max':>9}{'vlb-max':>9}{'slack1-max':>11}")
    for fam, g in graphs.items():
        rep, tr, _ = rows[fam]
        print(f"  {fam:<11}{g.n:>8}{rep['diameter']:>6}"
              f"{rep['avg_path_length']:>7.2f}"
              f"{rep['path_multiplicity_mean']:>7.2f}"
              f"{rep['nonminimal_plus1_mean']:>8.1f}"
              f"{rep['edge_interference_mean']:>8.3f}"
              f"{tr['max_link_load']:>9.1f}"
              f"{tr['max_expected_link_load']:>9.1f}"
              f"{loads[fam, 'valiant'].max():>9.1f}"
              f"{loads[fam, 'slack1'].max():>11.1f}")
    for fam, g in graphs.items():
        want = ref["families"][fam]
        rep, tr, demand = rows[fam]
        eng = engines[fam]
        check((g.n, g.name, rep["diameter"]) == (
            want["routers"], want["name"], want["diameter"]),
            f"{fam}: graph differs from reference.json")
        check_stats(f"{fam} workload", tr,
                    want["workload"])
        for key in ("max_link_load", "avg_hops", "flows", "links_used"):
            check(tr[key] == want["workload"][key],
                  f"{fam}: sampled {key} {tr[key]} != "
                  f"{want['workload'][key]}")
        host = [np.asarray(x) for x in (
            eng.distances(), eng.multiplicities()["multiplicity"],
            eng.multiplicities()["plus1"])]
        ids = np.asarray(want["link_ids"])
        cells = []
        for key, oracle in routing_models(R, eng, use_kernel=False).items():
            got = loads[fam, key]
            f64 = oracle.link_loads(demand)
            gap, zeros = _rel_gap(got, f64)
            check(zeros and gap <= 1e-5,
                  f"{fam} {key}: kernel loads vs f64: largest relative gap "
                  f"{gap:.3g} (rtol 1e-5), zeros kept {zeros}")
            pred = predicted_launches(key, *host, demand)
            check(deltas[fam, key] == pred,
                  f"{fam} {key}: {deltas[fam, key]} counting launches, the "
                  f"host's term list predicts {pred}")
            for what, x in (("kernel", got), ("f64", f64)):
                check_stats(f"{fam} {key} {what}",
                            A.link_load_stats(x, g.num_edges),
                            want["models"][key]["stats"])
                gap_ref, _ = _rel_gap(x[ids], want["models"][key]["loads"])
                check(gap_ref <= 1e-5, f"{fam} {key} {what}: loads at the "
                      f"reference's link ids, gap {gap_ref:.3g}")
            cells.append(f"{key} {deltas[fam, key]} launches, gap "
                         f"{gap:.3g}")
        print(f"  {fam}: " + "; ".join(cells))
    print("  10a: every row matches experiments/routing/reference.json "
          "(stats and 64 loads within rtol 1e-5, sampled columns equal); "
          "counting launches as predicted")

    # 10b: the kernel's loads held to the f64 path on the card
    g = graphs[stack_fam]
    diam_b = rows[stack_fam][0]["diameter"]
    check(delta_b == 2 * diam_b,
          f"10b: {delta_b} counting launches, expected 2 x {diam_b}")
    t0 = time.perf_counter()
    f64_b = A.ecmp_demand_loads(dist_b, mult_b, adj_b, batch_d,
                                use_kernel=False)
    torch.cuda.synchronize()
    t_b64 = time.perf_counter() - t0
    worst_b = 0.0
    for lo in range(0, len(batch), 25):  # chunks bound the temporaries
        k, f = loads_b[lo:lo + 25].double(), f64_b[lo:lo + 25]
        nz = f != 0
        check(bool((k[~nz] == 0).all()), "10b: a load off the support")
        worst_b = max(worst_b, float(((k - f).abs()[nz] / f[nz]).max()))
    check(worst_b <= 1e-5, f"10b: kernel vs f64 gap {worst_b:.3g}")
    del loads_b, f64_b
    # the counted call was the first to allocate its ~20 GiB; time both
    # paths again on the warm caching allocator
    warm = {use_kernel: timed_ms(lambda: A.ecmp_demand_loads(
        dist_b, mult_b, adj_b, batch_d, use_kernel=use_kernel),
        iters=2, warmup=1) for use_kernel in (True, False)}
    print(f"  10b {stack_fam} ({g.n} routers) x {stack_spec}: demand "
          f"generated in {t_gen:.3f} s (host); kernel {t_b:.3f} s on its "
          f"first call ({delta_b} launches), {warm[True]:.3f} ms warm; f64 "
          f"{t_b64:.3f} s, {warm[False]:.3f} ms warm; all {len(batch)} "
          f"samples within rtol 1e-5 (largest gap {worst_b:.3g}); peak "
          f"device memory {peak_b:.2f} GiB")
    print_profile("10b kernel", lambda: A.ecmp_demand_loads(
        dist_b, mult_b, adj_b, batch_d))
    del batch_d

    # 10c: demand of ones == uniform, bit for bit
    diam_c = int(torch.where(torch.isfinite(dist_c), dist_c, 0.0).max())
    check(torch.equal(loads_c, uniform_c),
          "10c: weighted loads under reachable ones != uniform loads")
    check(delta_c["count_matmul"] == 4 * diam_c
          and delta_c["frontier_step"] == diam_c + 1,
          f"10c: launches {delta_c}, diameter {diam_c}")
    print(f"  10c stack {tuple(adj_c.shape)}: weighted (reachable ones) "
          f"bit-equal to ecmp_all_pairs_loads; {delta_c['count_matmul']} "
          f"counting, {delta_c['frontier_step']} frontier launches")
    del adj_c, dist_c, mult_c, ones, loads_c, uniform_c

    # 10d: the spec is its matrix, and matches the JAX package
    for key, v in flow.items():
        check(np.array_equal(np.asarray(v), np.asarray(flow_m[key])),
              f"10d: {key} differs between the spec and its matrix")
    want = ref["throughput"]
    for key in _TP_EXACT[:-1]:
        check(flow[key] == want[key],
              f"10d {key}: {flow[key]!r} != {want[key]!r}")
    for key, v in [(k, flow[k]) for k in _TP_CLOSE] + [
            ("link_loads_sum", float(flow["link_loads"].sum())),
            ("link_loads_max", float(flow["link_loads"].max()))]:
        check(_close(v, want[key], 1e-9),
              f"10d {key}: {v} vs {want[key]} (rtol 1e-9)")
    check(delta_d > 0, "10d: the MWU oracle never launched")
    print(f"  10d {tp['family']} ({tp_graph.n} routers) max_concurrent_flow("
          f"{tp['demand']!r}): lambda in [{flow['throughput']:.9g}, "
          f"{flow['upper_bound']:.9g}], {flow['rounds']} rounds, "
          f"{delta_d} min-plus launches; bit-equal to the matrix call, "
          f"matches reference.json (rtol 1e-9)")
    for name in ROUTING_KERNELS:
        check(counts[name] > 0, f"routing path: {name} never launched")

    # timings, after the counted run: each model on the kernels against
    # its f64 path, one family per diameter
    for fam in ("slimfly", "dragonfly", "fattree"):
        eng, demand = engines[fam], rows[fam][2]
        kern = routing_models(R, eng)
        cells = []
        for key, oracle in routing_models(R, eng, use_kernel=False).items():
            ms_k = timed_ms(lambda: kern[key].directed_link_loads(demand),
                            iters=5, warmup=1)
            ms_f = timed_ms(lambda: oracle.directed_link_loads(demand),
                            iters=5, warmup=1)
            cells.append(f"{key} {ms_k:.3f} / {ms_f:.3f}")
        print(f"  {fam} ({graphs[fam].n} routers) ms a call, kernel / f64: "
              + ", ".join(cells))
    eng, demand = engines["dragonfly"], rows["dragonfly"][2]
    print_profile("dragonfly models", lambda: [
        m.directed_link_loads(demand)
        for m in routing_models(R, eng).values()])
    print(f"[10 routing] {time.perf_counter() - t_phase:.2f} s")
    return counts


def print_profile(label, fn, top=6):
    """Profile one run of ``fn`` (after the counted run, so it does not
    count) and print its device busy share and heaviest device rows."""
    rows, wall = profiled(fn)
    busy = sum(t for _, _, t in rows)
    if busy <= 0:
        print(f"  profile {label}: device busy share not measured (no "
              f"device activity in the profile)")
        return
    print(f"  profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} "
          f"ms ({100 * busy / wall:.2f}%), idle "
          f"{100 * (1 - busy / wall):.2f}%")
    for name, c, t in rows[:top]:
        print(f"    {t:9.3f} ms x{c:<5d} {name[:90]}")


def routing_models(R, eng, use_kernel=True):
    """The example's three models over an engine's device tensors."""
    kw = {"use_kernel": use_kernel}
    return {"ecmp": R.UniformShortest.from_engine(eng, **kw),
            "valiant": R.ValiantVLB.from_engine(eng, **kw),
            "slack1": R.SlackRouting.from_engine(eng, slack=1, **kw)}


# -- phase 11: the resilience and traffic path -------------------------------------

#: (a) the CI suite's arguments, which made experiments/resilience/
#: degradation.json (the file records all but the family list and the cap)
DEGRADATION_ARGS = dict(families=["slimfly", "jellyfish", "torus"],
                        max_routers=128, rates=(0.0, 0.02, 0.05, 0.1),
                        samples=100, bootstrap=200, slack=True)
#: (c) the sweep's full width (phase 5's families), one failure rate; the
#: samples cut from 32 to 16: the phase took 99.2 s at 32 (NVIDIA H100
#: 80GB HBM3, 700 W), past its 90 s aim
FULL_WIDTH = dict(ref=("slimfly", 10000), max_routers=2048)
FULL_WIDTH_SAMPLES = 16
#: (c) the sweep's --traffic scenario, and (d) the saturation search's
SWEEP_TRAFFIC = "hotspot:zipf_a=1.4,samples=8"
#: per-sample metrics held equal: counts and distances
_RES_EQUAL = frozenset((
    "reachable_frac", "diameter", "avg_spl", "frac_multipath",
    "links_used_frac"))
#: demand volumes summed by numpy on the host: equal on one host; against
#: a file made on another, within ``host_rtol`` (numpy's summation order
#: follows the host's SIMD width)
_RES_HOST = frozenset(("demand_total", "dropped_demand_frac"))
#: multiplicity picks: equal below 2**24 (f32 counts exact), else rtol
_RES_MULT = frozenset(("mult_mean", "mult_p10", "mult_p50", "mult_p90"))
#: loads and what derives from them: rtol 1e-5 (kernel), 1e-12 (f64)
_RES_CLOSE = frozenset((
    "tput_lb", "max_link_load", "mean_link_load", "p50_link_load",
    "p90_link_load", "p99_link_load", "avg_hops"))
#: slack counts: float32 on both paths; rtol 1e-5 only where the walk
#: counts stay below 2**24
_RES_SLACK = frozenset(("plus1_mean", "plus1_p50", "plus2_mean"))


def _metric_of(path):
    for part in reversed(path):
        if part in _RES_EQUAL | _RES_HOST | _RES_MULT | _RES_CLOSE | _RES_SLACK:
            return part
    return None


def compare_result(what, got, want, rtol, exact_mult=True, slack_held=None,
                   host_rtol=0.0, skip=("elapsed_s", "use_kernel")):
    """A degradation or grid result dict against another, key by key: the
    rules above, every other value equal. ``slack_held(family)`` says
    whether that family's slack counts are held to ``rtol``; where not,
    their gaps are only recorded. Returns {metric: largest relative gap}
    and {family: largest slack gap}."""
    gaps, slack_gaps = {}, {}

    def walk(a, b, path, fam):
        if isinstance(b, dict):
            check(isinstance(a, dict), f"{what} {'/'.join(path)}: not a dict")
            for k in set(a) - set(b):
                check(a[k] is None, f"{what} {'/'.join(path + [k])}: extra "
                      f"key with value {a[k]!r}")
            for k, v in b.items():
                if not path and k in skip:
                    continue
                check(k in a, f"{what} {'/'.join(path + [k])}: missing")
                walk(a[k], v, path + [k], b.get("family", fam))
        elif isinstance(b, list):
            check(isinstance(a, list) and len(a) == len(b),
                  f"{what} {'/'.join(path)}: lengths differ")
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + [str(i)], fam)
        elif isinstance(b, float) and not isinstance(b, bool):
            check(isinstance(a, float), f"{what} {'/'.join(path)}: {a!r} "
                  f"is not a float")
            metric = _metric_of(path)
            gap = abs(a - b) / abs(b) if b else abs(a)
            if metric is not None:
                gaps[metric] = max(gaps.get(metric, 0.0), gap)
            where = f"{what} {fam} {'/'.join(path)}: {a!r} vs {b!r}"
            if metric in _RES_SLACK:
                slack_gaps[fam] = max(slack_gaps.get(fam, 0.0), gap)
                if slack_held(fam):
                    check(gap <= rtol, f"{where} (rtol {rtol})")
            elif metric in _RES_CLOSE or (metric in _RES_MULT
                                          and not exact_mult):
                check(gap <= rtol, f"{where} (rtol {rtol})")
            elif metric in _RES_HOST and host_rtol:
                check(gap <= host_rtol, f"{where} (rtol {host_rtol})")
            else:
                check(a == b, f"{where} (equal)")
        else:
            check(a == b, f"{what} {fam} {'/'.join(path)}: {a!r} != {b!r}")

    walk(got, want, [], None)
    return gaps, slack_gaps


def host_sums(TRF, SW, res, gargs):
    """Each grid baseline's ``demand_total`` is the sum numpy gives on this
    host, bit for bit: the offered demand of sample 0 (diagonal zeroed)."""
    graphs, _ = SW.equal_cost_graphs(None, res["budget"], None,
                                     gargs["max_routers"])
    by_fam = {g.meta["spec"].family: g for g in graphs}
    differ = []
    for fam in res["families"]:
        g = by_fam[fam["family"]]
        for desc, base in fam["baseline"].items():
            m = TRF.TrafficSpec.parse(desc).batch(
                g, samples=gargs["samples"])[:1].copy()
            m[:, np.arange(g.n), np.arange(g.n)] = 0.0
            here = float(m.reshape(1, -1).sum(1)[0])
            check(base["demand_total"] == here,
                  f"11a grid {fam['family']} {desc}: demand_total "
                  f"{base['demand_total']!r}, numpy here {here!r}")
    print(f"    11a grid: every baseline demand_total is numpy's sum on "
          f"this host (numpy {np.__version__}), bit for bit")


def walk_count_bound(g, length):
    """The largest walk count and one-bounce count the slack recurrence
    meets up to ``length`` on ``g``'s unfailed graph, in float64 on the
    card: the recurrences are monotone in the adjacency, so this bounds
    every failure sample's counts at those lengths."""
    a = torch.from_numpy(g.adjacency_dense(np.float64)).cuda()
    deg = a.sum(-1)[None, :]
    walks = torch.eye(g.n, dtype=torch.float64, device=a.device)
    bounce = walks * deg
    top = float(bounce.max())
    for _ in range(length):
        walks = walks @ a
        bounce = bounce @ a + walks * deg
        top = max(top, float(walks.max()), float(bounce.max()))
    return top


def _chunks(n, size):
    return -(-n // size)


def span_launches(events, slack, auto_chunk):
    """The frontier steps and counting products a counted run must launch,
    from its own spans: each wavefront's per-graph diameters (device
    telemetry: the last level that reached a pair) give its steps,
    diameter + 1; each Brandes pass 2 x the diameter of the dist it reads,
    each slack recurrence 2 x (diameter + 2). Returns (the prediction,
    {family: largest chunk diameter} for degradation families)."""
    pred = {"frontier_step": 0, "count_matmul": 0}
    pending, fam_diam = [], {}
    stack, last2d, source, row = None, 0, None, 0
    family_max = 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name, a = ev["name"], ev["args"]
        if name in ("wavefront.dist_mult", "sweep.dist_mult"):
            per = a.get("levels_per_graph") or [a["converged_level"]]
            pred["frontier_step"] += max(per) + 1
            if name == "sweep.dist_mult":
                stack, source, row = per, "sweep", 0
            elif a.get("batched"):
                stack = per
                pending.append(max(per))
            else:
                last2d, source = max(per), "2d"
        elif name == "sweep.ecmp_loads":
            pred["count_matmul"] += 2 * max(stack)
        elif name == "resilience.severity":
            for d in pending:
                pred["count_matmul"] += 2 * d + (2 * (d + 2) if slack else 0)
                family_max = max(family_max, d)
            pending = []
        elif name == "resilience.family":
            fam_diam[a["family"]] = family_max
            family_max = 0
        elif name == "traffic.scenario":
            if source == "sweep":
                d, row = stack[row], row + 1
            else:
                d = last2d
            pred["count_matmul"] += 2 * d * _chunks(a["samples"],
                                                    a["mask_chunk"])
        elif name == "traffic.cell":
            s, mc = a["samples"], a["mask_chunk"]
            pred["count_matmul"] += sum(2 * max(stack[lo:lo + mc])
                                        for lo in range(0, s, mc))
        elif name == "traffic.saturation":
            s, grid = a["samples"], a["grid"]
            mc = auto_chunk(a["routers"], s * max(grid, 2))
            passes = _chunks(s, mc) + a["rounds"] * _chunks(grid * s, mc)
            pred["count_matmul"] += 2 * last2d * passes
    return pred, fam_diam


class Counted:
    """One counted run: launches set to 0 and tracing reset just before,
    read just after (with its wall, spans and peak device memory)."""

    def __init__(self, S, obs, label):
        self.S, self.obs, self.label = S, obs, label

    def __enter__(self):
        self.obs.enable()
        self.obs.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.S.reset_launches()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.counts = dict(self.S.launches)
        self.events = self.obs.events()
        self.spans = self.obs.span_summary()
        self.peak_gib = torch.cuda.max_memory_allocated() / 2**30
        self.obs.disable()
        return False

    def report(self, top=8):
        live = {k: v for k, v in self.counts.items() if v}
        print(f"  {self.label}: {self.wall:.3f} s; launches {live}; peak "
              f"device memory {self.peak_gib:.2f} GiB")
        rows = sorted(self.spans.items(), key=lambda kv: -kv[1]["total_ms"])
        print("    spans: " + "; ".join(
            f"{k} {v['total_ms']:.1f} ms x{v['count']}" for k, v in rows[:top]))

    def check_launches(self, slack, auto_chunk):
        pred, fam_diam = span_launches(self.events, slack, auto_chunk)
        got = {k: self.counts[k] for k in pred}
        check(got == pred, f"{self.label}: launches {got}, the spans' "
              f"diameters predict {pred}")
        others = {k: v for k, v in self.counts.items() if k not in pred and v}
        check(not others, f"{self.label}: other kernels launched {others}")
        return fam_diam

    def check_none(self):
        check(not any(self.counts.values()),
              f"{self.label}: the f64 path launched {self.counts}")


def slack_rule(fam_diam, graphs):
    """{family: walk-count bound}, and the predicate: held where the bound
    at the family's largest diameter + 2 stays below 2**24."""
    bounds = {}
    for g in graphs:
        fam = g.meta["spec"].family
        if fam in fam_diam:
            bounds[fam] = walk_count_bound(g, fam_diam[fam] + 2)
    return bounds, (lambda fam: bounds[fam] < EXACT)


def print_gaps(label, gaps, slack_gaps, bounds):
    """The largest gap per metric; per family, the slack counts' gap beside
    their walk-count bound (kernel runs) and whether it was held."""
    print(f"    {label} largest gaps: " + (", ".join(
        f"{k} {v:.3g}" for k, v in sorted(gaps.items()) if v) or "none"))
    for fam in sorted(bounds):
        held = "held" if bounds[fam] < EXACT else "past 2**24, not held"
        print(f"    slack {fam}: walk counts to {bounds[fam]:.4g} ({held});"
              f" largest gap {slack_gaps.get(fam, 0.0):.3g}")


def resilience_phase(obs, S, SW, T, RES, TRF, part):
    """The resilience and traffic path on the card, counted per part: (a)
    the committed degradation.json and grid.json, (b) both CLIs at their
    defaults, (c) one degradation point and the --traffic sweep at the
    sweep's full width, (d) saturation_search. Each part's kernel run is
    counted and held to its f64 run. Returns the kernel runs' launches."""
    from repro_torch.core.resilience import degradation as DG
    from repro_torch.core.traffic import grid as GR
    from repro_torch.core.traffic import scenarios as SC

    t_phase = time.perf_counter()
    total = {k: 0 for k in S.launches}

    def add(run):
        for k, v in run.counts.items():
            total[k] += v

    # (a) the committed references
    t_part = time.perf_counter()
    dref = json.loads((ROOT / "experiments" / "resilience"
                       / "degradation.json").read_text())
    gref = json.loads((ROOT / "experiments" / "congestion"
                       / "grid.json").read_text())
    dargs = dict(DEGRADATION_ARGS, seed=dref["seed"], kind=dref["kind"])
    gargs = dict(scenarios=gref["scenarios"], rates=gref["rates"],
                 samples=gref["samples"], bootstrap=gref["bootstrap"],
                 seed=gref["seed"], kind=gref["kind"], max_routers=128)
    check(list(dargs["rates"]) == dref["rates"]
          and dargs["samples"] == dref["samples"]
          and dargs["bootstrap"] == dref["bootstrap"],
          "11a: degradation.json's header differs from the CI arguments")
    graphs_a, _ = SW.equal_cost_graphs(dargs["families"], None,
                                       ("slimfly", 2000), 128)
    for kind, want in (("degradation", dref), ("grid", gref)):
        for use_kernel in (True, False):
            tag = "kernel" if use_kernel else "f64"
            with Counted(S, obs, f"11a {kind}, {tag}") as run:
                if kind == "degradation":
                    res = RES.degradation_curves(use_kernel=use_kernel,
                                                 device="cuda", **dargs)
                else:
                    res = TRF.traffic_failure_grid(use_kernel=use_kernel,
                                                   device="cuda", **gargs)
            run.report()
            res = json.loads(json.dumps(res, default=str))
            gate = (RES.check_degradation if kind == "degradation"
                    else TRF.check_grid)(res)
            check(gate == [], f"11a {kind} {tag}: gate fails: {gate[:3]}")
            bounds, held = {}, (lambda fam: True)  # f64: every count exact
            if use_kernel:
                fam_diam = run.check_launches(kind == "degradation",
                                              DG._auto_chunk)
                add(run)
                if kind == "degradation":
                    bounds, held = slack_rule(fam_diam, graphs_a)
            else:
                run.check_none()
            gaps, slack_gaps = compare_result(
                f"11a {kind} {tag}", res, want,
                1e-5 if use_kernel else 1e-12, slack_held=held,
                host_rtol=1e-12)
            if kind == "grid" and use_kernel:
                host_sums(TRF, SW, res, gargs)
            print_gaps(f"11a {kind} {tag} vs committed", gaps, slack_gaps,
                       bounds)
    print(f"  11a: degradation.json and grid.json reproduced on the kernels "
          f"and the f64 path; both gates pass; launches as predicted "
          f"({time.perf_counter() - t_part:.2f} s)")
    # one profiled severity pass and one grid cell, after the counted runs
    g = {x.meta["spec"].family: x for x in graphs_a}["torus"]
    plan = RES.failure_plan(g, samples=dargs["samples"], seed=0)
    batch = RES.failure_batch(plan, RES.rate_to_k(plan, 0.1))
    print_profile("11a torus severity 0.1", lambda: RES.evaluate_failure_batch(
        g, batch, slack=True))
    dem = TRF.TrafficSpec.parse("hotspot:zipf_a=1.4").batch(
        g, samples=dargs["samples"])
    print_profile("11a torus grid cell 0.1", lambda: (
        TRF.evaluate_traffic_failure_batch(g, dem, batch.adjacency)))

    # (b) the CLI defaults, through main(argv), kernels and f64 path
    import contextlib
    import io

    t_part = time.perf_counter()
    out_dir = ROOT / "build" / "phase11"
    cli = {}
    for kind, mod, fname in (("resilience", DG, "degradation.json"),
                             ("traffic", GR, "grid.json")):
        for tag, extra in (("kernel", []), ("f64", ["--no-kernel"])):
            dest = out_dir / f"{kind}-{tag}"
            buf = io.StringIO()
            with Counted(S, obs, f"11b {kind} --check, {tag}") as run:
                with contextlib.redirect_stdout(buf):
                    rc = mod.main(["--check", "--device", "cuda", "--out",
                                   str(dest)] + extra)
            text = buf.getvalue().splitlines()
            print("  " + next(line for line in text if line.startswith(
                ("degradation sweep:", "traffic x failure grid:"))))
            print(f"  {text[-1]}")
            check(rc == 0, f"11b {kind} {tag}: --check exit {rc}")
            cli[kind, tag] = (run, json.loads((dest / fname).read_text()))
    graphs_b, _ = SW.equal_cost_graphs(None, None, ("slimfly", 2000), 256)
    for kind in ("resilience", "traffic"):
        (run_k, res_k), (run_f, res_f) = cli[kind, "kernel"], cli[kind, "f64"]
        for run in (run_k, run_f):
            run.report()
        fam_diam = run_k.check_launches(kind == "resilience",
                                        DG._auto_chunk)
        run_f.check_none()
        add(run_k)
        bounds, held = (slack_rule(fam_diam, graphs_b)
                        if kind == "resilience" else ({}, None))
        gaps, slack_gaps = compare_result(f"11b {kind}", res_k, res_f, 1e-5,
                                          slack_held=held)
        print_gaps(f"11b {kind} kernel vs f64", gaps, slack_gaps, bounds)
    print(f"  11b: both CLIs pass --check at their defaults; kernel results "
          f"match the f64 path's ({time.perf_counter() - t_part:.2f} s)")
    g = {x.meta["spec"].family: x for x in graphs_b}["torus"]
    plan = RES.failure_plan(g, samples=1000, seed=0)
    batch = RES.failure_batch(plan, RES.rate_to_k(plan, 0.1))
    print(f"  11b torus ({g.n} routers): auto chunk "
          f"{DG._auto_chunk(g.n, 1000)} masks")
    print_profile("11b torus severity 0.1 (1000 masks)",
                  lambda: RES.evaluate_failure_batch(g, batch, slack=True))
    del batch

    # (c) one point at the sweep's full width, and the --traffic sweep
    t_part = time.perf_counter()
    print(f"  11c: samples cut from 32 to {FULL_WIDTH_SAMPLES} to keep phase "
          f"11 near 90 s")
    graphs_c, _ = SW.equal_cost_graphs(None, None, **FULL_WIDTH)
    cargs = dict(graphs=graphs_c, rates=(0.0, 0.05),
                 samples=FULL_WIDTH_SAMPLES, slack=True, bootstrap=200)
    full = {}
    for use_kernel in (True, False):
        tag = "kernel" if use_kernel else "f64"
        with Counted(S, obs, f"11c degradation, {tag}") as run:
            res = RES.degradation_curves(use_kernel=use_kernel, **cargs)
        full["deg", tag] = (run, json.loads(json.dumps(res, default=str)))
        with Counted(S, obs, f"11c sweep --traffic, {tag}") as run:
            res = SW.sweep(graphs=graphs_c, use_kernel=use_kernel,
                           traffic=SWEEP_TRAFFIC, device="cuda")
        full["sweep", tag] = (run, res)
    for kind in ("deg", "sweep"):
        (run_k, res_k), (run_f, res_f) = full[kind, "kernel"], \
            full[kind, "f64"]
        for run in (run_k, run_f):
            run.report()
        fam_diam = run_k.check_launches(kind == "deg", DG._auto_chunk)
        run_f.check_none()
        add(run_k)
        if kind == "deg":
            check(RES.check_degradation(res_k) == []
                  and RES.check_degradation(res_f) == [], "11c: gate fails")
            bounds, held = slack_rule(fam_diam, graphs_c)
            gaps, slack_gaps = compare_result(
                "11c degradation", res_k, res_f, 1e-5, exact_mult=False,
                slack_held=held)
            print_gaps("11c degradation kernel vs f64", gaps, slack_gaps,
                       bounds)
            print("    " + RES.format_degradation_table(res_k).replace(
                "\n", "\n    "))
        else:
            print("    " + SW.format_table(res_k).replace("\n", "\n    "))
            rows_f = {r["family"]: r for r in res_f["rows"]}
            worst = 0.0
            for r in res_k["rows"]:
                f = rows_f[r["family"]]
                for col in ("traffic_max_load", "traffic_tput_lb"):
                    check(isinstance(r[col], float) and _close(
                        r[col], f[col], 1e-5), f"11c sweep {r['family']} "
                        f"{col}: {r[col]} vs {f[col]} (rtol 1e-5)")
                    worst = max(worst, abs(r[col] - f[col]) / abs(f[col]))
            print(f"    11c sweep --traffic {SWEEP_TRAFFIC}: tr-load, "
                  f"tr-tput within rtol 1e-5 of the f64 run (largest gap "
                  f"{worst:.3g})")
    print(f"  11c: full width ({len(graphs_c)} families, "
          f"{min(g.n for g in graphs_c)}-{max(g.n for g in graphs_c)} "
          f"routers, {FULL_WIDTH_SAMPLES} samples) ({time.perf_counter() - t_part:.2f} s)")
    g = {x.meta["spec"].family: x for x in graphs_c}["torus"]
    plan = RES.failure_plan(g, samples=FULL_WIDTH_SAMPLES, seed=0)
    batch = RES.failure_batch(plan, RES.rate_to_k(plan, 0.05))
    print_profile(f"11c torus severity 0.05 ({g.n} routers)",
                  lambda: RES.evaluate_failure_batch(g, batch, slack=True))
    del batch, full

    # (d) saturation_search: the ring's tornado closed form, and hotspot on
    # (b)'s dragonfly, kernel against the f64 path
    t_part = time.perf_counter()
    ring = T.make("torus", dims=(64,))
    dfly = {x.meta["spec"].family: x for x in graphs_b}["dragonfly"]
    sat = {}
    for use_kernel in (True, False):
        tag = "kernel" if use_kernel else "f64"
        with Counted(S, obs, f"11d saturation, {tag}") as run:
            sat["ring", tag] = SC.saturation_search(
                ring, "tornado", use_kernel=use_kernel)
            sat["dfly", tag] = SC.saturation_search(
                dfly, SWEEP_TRAFFIC, use_kernel=use_kernel)
        run.report()
        if use_kernel:
            run.check_launches(False, DG._auto_chunk)
            add(run)
        else:
            run.check_none()
        ring_sat = sat["ring", tag]
        check(_close(ring_sat["per_sample_mean"], 4 / ring.n, 1e-6)
              and _close(ring_sat["sat_rate"], 4 / ring.n, 0.02),
              f"11d ring tornado {tag}: {ring_sat['per_sample_mean']}, "
              f"sat {ring_sat['sat_rate']}, closed form {4 / ring.n}")
    k, f = sat["dfly", "kernel"], sat["dfly", "f64"]
    # the bracket starts at twice the largest per-sample crossing, so the
    # rates carry the peaks' rounding: the same feasible counts each round
    check([r["feasible"] for r in k["rounds"]]
          == [r["feasible"] for r in f["rounds"]],
          f"11d dragonfly: bisection differs: {k['rounds']} vs {f['rounds']}")
    for key in ("per_sample", "peak_at_probe", "ci95", "sat_rate"):
        gap, zeros = _rel_gap(k[key], f[key])
        check(zeros and gap <= 1e-5, f"11d dragonfly {key}: gap {gap:.3g}")
    print(f"  11d ring({ring.n}) tornado: {sat['ring', 'kernel']['per_sample_mean']!r}"
          f" (closed form 4/n = {4 / ring.n}); dragonfly ({dfly.n} routers) "
          f"{SWEEP_TRAFFIC}: sat_rate {k['sat_rate']:.6g}, per-sample mean "
          f"{k['per_sample_mean']:.6g} (f64 {f['per_sample_mean']:.6g}); "
          f"the same bisection, rates within rtol 1e-5 "
          f"({time.perf_counter() - t_part:.2f} s)")
    print_profile("11d dragonfly saturation", lambda: SC.saturation_search(
        dfly, SWEEP_TRAFFIC))

    print(f"[11 resilience] {time.perf_counter() - t_phase:.2f} s; launches "
          f"{ {k: v for k, v in total.items() if v} }")
    for name in ("frontier_step", "count_matmul"):
        check(total[name] > 0, f"resilience path: {name} never launched")
    return total


# -- phase 12: the mesh (two ranks on the one card) ------------------------------

#: ranks of phase 12's mesh: gloo ranks sharing the one card
MESH_RANKS = 2
#: what phase 12 runs: (a) phase 5's full width and phase 4's committed
#: configuration, (b) 7b's ~100k dragonfly and its 32 sampled sources, (c)
#: one of the example's families at ~10k servers
MESH_SIZES = {"sweep": FULL_WIDTH,
              "committed": dict(ref=("slimfly", 2000), max_routers=200),
              "extreme": 100_000, "sources": 32, "engine": ("slimfly", 10_000)}
#: 12's wall limit on the ranks (they are killed past it)
MESH_TIMEOUT_S = 400


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dyadic(x):
    """A float operand that bf16 cannot hold (so the counting product runs
    on the SIMT tile, as Z does in the Brandes loop) while every sum of
    its products with small integers stays exact in fp32: counts + 2**-8."""
    return torch.where(x > 0, x + 2.0 ** -8, 0.0)


def _shard_checks(S, D, SW, WF, mesh, graph, p_graph, sizes):
    """(e) the kernels at this rank's shapes against their plain versions on
    the same card tensors, bit for bit: the frontier step on the rank's
    (12, 1024, 2048) block of phase 5's stack, both Brandes products over
    its 1024 source rows, the narrow product of 12b's packed K-slab (32
    sources) against the rank's uint8 adjacency rows. Uncounted."""
    dev = mesh.device
    out = {}
    graphs, _ = SW.equal_cost_graphs(**sizes["sweep"])
    stack = SW._stack_adjacency(graphs)
    p = D.pad_block_sharded(stack.shape[-1], mesh.size, batched=True)[0]
    adj = torch.from_numpy(WF.pad_operand(stack, p, 0.0)).to(dev)
    r0, r1 = mesh.rows(p)
    # the level-1 frontier of the rank's sources is their adjacency rows;
    # distances 0 on the diagonal, 1 on the rows, +inf elsewhere
    f = adj[:, r0:r1].contiguous()
    d = torch.where(f > 0, 1.0, float("inf"))
    d[:, torch.arange(r1 - r0, device=dev),
      torch.arange(r0, r1, device=dev)] = 0.0
    x = S.frontier_step(f, adj, d)
    want = S.frontier_step(f, adj, d, use_kernel=False)
    out["frontier_step"] = (tuple(f.shape), tuple(adj.shape),
                            _abs_err(x, want))
    z = _dyadic(x)
    for name, a, b in (("count_matmul F^T Z", f.transpose(-1, -2), z),
                       ("count_matmul Z A", z, adj)):
        got = S.count_matmul(a, b)
        want = S.count_matmul(a, b, use_kernel=False)
        out[name] = (tuple(a.shape), tuple(b.shape), _abs_err(got, want))
    del adj, f, d, x, z, got, want
    # the composed engine's slab product: 32 sources' level-1 frontier
    n = graph.n
    g0, g1 = mesh.rows(p_graph)
    k = sizes["sources"]
    ids = np.sort(np.random.default_rng(0).choice(n, size=k, replace=False))
    rows = D._device_adjacency(graph, n, p_graph, torch.uint8, dev,
                               rows=(g0, g1))
    front = torch.zeros((k, p_graph), dtype=torch.int32, device=dev)
    indptr, indices = graph.csr()
    for i, s in enumerate(ids):
        front[i, torch.from_numpy(indices[indptr[s]:indptr[s + 1]]).to(
            dev)] = 1
    slab = front[:, g0:g1]
    got = S.count_matmul(slab, rows)
    err = 0.0
    for c0 in range(0, p_graph, 8192):  # the plain version, by columns
        want = S.count_matmul(slab, rows[:, c0:c0 + 8192].contiguous(),
                              use_kernel=False)
        err = max(err, _abs_err(got[:, c0:c0 + 8192], want))
    out["count_matmul_narrow"] = (tuple(slab.shape), tuple(rows.shape), err)
    for name, (sa, sb, e) in out.items():
        check(e == 0.0, f"rank {mesh.rank}: {name} {sa} x {sb} differs "
                        f"from its plain version by {e}")
    return out


def mesh_rank(mesh, dragonfly, sizes):
    """Phase 12 on one rank of the mesh: (a) the sharded sweep at full width
    and at the committed configuration, (b) the composed extreme sweep on
    the ~100k dragonfly, packed, (c) ``AnalysisEngine(mesh=)`` on one
    example family, (d) ``pod_traffic_report`` on the default torus, all
    counted; then (e) the per-shard kernel checks. Every rank's record goes
    to rank 0, which returns them all with its rows."""
    import torch.distributed as tdist

    from repro_torch import obs
    from repro_torch.core import collectives as C
    from repro_torch.core import sweep as SW
    from repro_torch.core import topology as T
    from repro_torch.core.analysis import AnalysisEngine
    from repro_torch.core.analysis import distributed as D
    from repro_torch.core.analysis import wavefront as WF
    from repro_torch.kernels import semiring as S

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    rec = {"rank": mesh.rank, "device": str(dev), "walls": {},
           "all_reduce_bytes": {}, "checks": {}}

    def part(name, fn):
        before = obs.counter("mesh.all_reduce_bytes").value
        _sync(dev)
        tdist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        rec["walls"][name] = time.perf_counter() - t0
        rec["all_reduce_bytes"][name] = (
            obs.counter("mesh.all_reduce_bytes").value - before)
        return res

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    S.reset_launches()
    t_all = time.perf_counter()
    full = part("a full width", lambda: SW.sweep(
        **sizes["sweep"], device=dev, mesh=mesh))
    small = part("a committed", lambda: SW.sweep(
        **sizes["committed"], device=dev, mesh=mesh))
    ext = part("b composed", lambda: SW.sweep_extreme(
        ["dragonfly"], target_routers=sizes["extreme"],
        k_sources=sizes["sources"], seed=0,
        adjacency_budget=RESIDENT_BUDGET, device=dev, mesh=mesh))
    g = T.by_servers(*sizes["engine"])
    eng = AnalysisEngine(g, device=dev, mesh=mesh)
    dist, mult = part("c engine", lambda: (eng.distances(),
                                           eng.shortest_path_mult()))
    fab = C.PhysicalFabric()
    n = fab.chips_per_pod
    demands = {"all-to-all": np.ones((n, n)) - np.eye(n),
               "random": np.random.default_rng(0).random((n, n))}
    reports = part("d pod report", lambda: {
        k: C.pod_traffic_report(fab, v, device=dev)
        for k, v in demands.items()})
    rec["wall"] = time.perf_counter() - t_all
    rec["launches"] = dict(S.launches)
    rec["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if dev.type == "cuda" else 0.0)
    for name in ("frontier_step", "count_matmul", "count_matmul_narrow"):
        # (on the host, in a rehearsal, the plain versions run instead)
        check(rec["launches"][name] > 0 or dev.type != "cuda",
              f"rank {mesh.rank}: {name} never launched in phase 12")

    # the uncounted checks: the single-device engine and the f64 path
    one = AnalysisEngine(g, device=dev, mesh=None)
    check(np.array_equal(dist, one.distances())
          and np.array_equal(mult, one.shortest_path_mult()),
          f"rank {mesh.rank}: 12c AnalysisEngine(mesh=) differs from the "
          f"single-device engine")
    gaps = {}
    for k, v in demands.items():
        f64 = C.pod_traffic_report(fab, v, use_kernel=False, device=dev)
        for key, w in f64.items():
            got = reports[k][key]
            if isinstance(w, str) or key in ("links_total", "links_used"):
                check(got == w, f"12d {k}.{key}: {got} != {w}")
            else:
                check(_close(got, w, 1e-5) or got == w,
                      f"12d {k}.{key}: {got} vs f64 {w} (rtol 1e-5)")
                gaps[f"{k}.{key}"] = abs(got - w) / max(abs(w), 1e-30)
    rec["checks"]["d max rel gap"] = max(gaps.values())
    p_graph = D._pad128(dragonfly.n)
    p_graph += (-p_graph) % (mesh.size * 128)
    rec["shard_checks"] = _shard_checks(S, D, SW, WF, mesh, dragonfly,
                                        p_graph, sizes)
    rec["engine"] = (g.name, g.n)
    everyone = [None] * mesh.size
    tdist.all_gather_object(everyone, rec, group=mesh.group)
    return {"ranks": everyone, "full": full, "small": small,
            "extreme": ext, "reports": reports}


def mesh_phase(D, full, dragonfly_row, dragonfly, sizes=MESH_SIZES,
               device="cuda"):
    """Phase 12: ``mesh_rank`` on a mesh of two gloo ranks sharing the one
    card (spawned by ``distributed.launch_mesh``); the rows held to phases
    4, 5 and 7b here. Returns the launches summed over the ranks.
    (``sizes`` and ``device="cpu"`` rehearse it at a small size on the
    host, where the kernels' plain versions run.)"""
    t_phase = time.perf_counter()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the ranks have the card to themselves
    res = D.launch_mesh(mesh_rank, MESH_RANKS, dragonfly, sizes,
                        device=device, timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t_phase
    # (a) bit-equal dist/mult give equal integer columns and means; loads
    # sum the ranks' partials in another order: rtol 1e-5
    rows = {r["family"]: r for r in res["full"]["rows"]}
    for r in full["rows"]:
        got = rows[r["family"]]
        for col in _EXACT_COLS + ("avg_spl", "mult_mean", "mult_min",
                                  "reachable_frac"):
            check(got[col] == r[col],
                  f"12a {r['family']}.{col}: {got[col]} != phase 5 {r[col]}")
        check(_close(got["tput_lb"], r["tput_lb"], 1e-5),
              f"12a {r['family']}.tput_lb: {got['tput_lb']} vs phase 5 "
              f"{r['tput_lb']}")
    check_committed(res["small"],
                    ROOT / "experiments" / "sweep" / "comparison.json")
    (row,) = res["extreme"]["rows"]
    check_same(row, dragonfly_row, "12b composed vs 7b resident", rtol=0.0)
    print(f"[12 mesh] {MESH_RANKS} gloo ranks on the one card: 12a rows "
          f"equal to phase 5's (tput_lb within 1e-5) and the committed "
          f"table to comparison.json; 12b {row['family']} rows equal to "
          f"7b's resident run; 12c, 12d, 12e checked in each rank")
    launches = {}
    for rec in res["ranks"]:
        print(f"  rank {rec['rank']} ({rec['device']}): wall "
              f"{rec['wall']:.3f} s; parts " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in rec["walls"].items())
              + f"; peak device memory {rec['peak_gib']:.2f} GiB")
        print(f"    launches {rec['launches']}")
        print(f"    all-reduced bytes " + ", ".join(
            f"{k} {v}" for k, v in rec["all_reduce_bytes"].items()))
        for name, (sa, sb, e) in rec["shard_checks"].items():
            print(f"    12e {name}: {sa} x {sb} bit-equal to its plain "
                  f"version")
        print(f"    12c {rec['engine'][0]} ({rec['engine'][1]} routers) "
              f"equal to the single-device engine; 12d largest gap to the "
              f"f64 path {rec['checks']['d max rel gap']:.3g}")
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    # the bytes each rank all-reduced, against the engines' rule: 12a one
    # int a BFS level, the diameter, the (12, p, p) Brandes partials once;
    # 12b the (32, p) partial product a level and the saturation flag
    levels_a = max(r["diameter"] for r in full["rows"]) + 1
    p_a = D.pad_block_sharded(max(r["routers"] for r in full["rows"]),
                              MESH_RANKS, batched=True)[0]
    want_a = 4 * levels_a + 4 + 4 * len(full["rows"]) * p_a * p_a
    levels_b = row["diameter_lb"] + 1
    p_b = D._pad128(dragonfly.n)
    p_b += (-p_b) % (MESH_RANKS * 128)
    k = sizes["sources"]
    want_b = levels_b * (k + (-k) % 8) * p_b * 4 + 4
    for rec in res["ranks"]:
        got = rec["all_reduce_bytes"]
        check(got["a full width"] == want_a and got["b composed"] == want_b,
              f"rank {rec['rank']}: all-reduced {got}, expected 12a "
              f"{want_a}, 12b {want_b}")
    print(f"  bytes all-reduced a level, each rank: 12a BFS 4 ({levels_a} "
          f"levels), then {4 * len(full['rows']) * p_a * p_a} of Brandes "
          f"partials once; 12b {(want_b - 4) // levels_b} ({levels_b} "
          f"levels, one {k}-source tile of p = {p_b})")
    print(f"[12 mesh] {wall:.2f} s in all (spawn, ranks, checks); no claim "
          f"of speed: the two ranks share one card")
    return launches


# -- phase 13: the serving path (the LM substrate) ---------------------------------

#: float32 logits against the JAX package (prefill's last token)
F32_RTOL, F32_ATOL = 1e-4, 1e-5
#: float32 logits of every position (teacher-forced decode): the JAX
#: package's own float32 decode logits are 2.0e-5 from a float64
#: evaluation of the same weights, the port's 2.78e-5
#: (``experiments/serve/conditioning.py``; the scores are of order 10^2,
#: so the softmax amplifies ulp-level differences): a gap below 1e-5
#: cannot be met by another float32 implementation; held at 5e-5
F32_SEQ_ATOL = 5e-5
#: bfloat16: eight bfloat16 epsilons (2^-7 each) on a logit, and the top-2
#: gap below which a served token may differ
BF16_TOL = 2.0 ** -4
#: the int8-cache decode logits: one int8 code is 1/127 of a token's
#: largest |k| or |v|, and a one-ulp difference before quantization can
#: move a value by a code, so sixteen bfloat16 epsilons
INT8_TOL = 2.0 ** -3
#: phase 13b's serving run at full width, and the prompts of its checks
FULL_SERVE = {"max_batch": 4, "max_len": 256, "requests": 8, "min_len": 4,
              "max_len_prompt": 12, "max_new": 32, "seed": 0}
PREFILL_DECODE_LEN, FLASH_LEN = 512, 2048
#: decode steps in 13b's profiled window
PROFILED_CALLS = 10
#: prefill against teacher-forced decode at full width, bf16: layer 0's k
#: and v caches (which depend on no attention) held within one bf16
#: epsilon (2^-7) of their largest entry. Deeper layers and the last
#: token's logits are printed, not held: init_params' stddevs (fan-in
#: from the stacked leaves' shape[-2]: wk's is 1 for one KV head) give
#: attention scores of std ~720, and the softmax's near-ties turn
#: rounding into different attention rows: on a 6-layer cut, float32
#: prefill and decode logits differ by 1.42, float64's by 8.2e-8
#: (``experiments/serve/conditioning.py``)
PREFILL_DECODE_TOL = 2.0 ** -7


def _ref_array(d):
    import base64

    return np.frombuffer(base64.b64decode(d["b64"]), dtype="<f4").reshape(
        d["shape"])


def _recording(srv):
    """Wrap ``srv.decode`` to keep each call's position, next tokens and
    whether its logits are all finite."""
    calls, inner = [], srv.decode

    def recording(model, tok, caches, pos):
        nxt, logits, new = inner(model, tok, caches, pos)
        calls.append({"pos": int(pos), "next": nxt[:, 0].cpu().numpy(),
                      "finite": bool(torch.isfinite(logits).all())})
        return nxt, logits, new

    srv.decode = recording
    return calls


def _serve_requests(cfg, spec, Request):
    rng = np.random.default_rng(spec["seed"])
    reqs = []
    for rid in range(spec["requests"]):
        plen = int(rng.integers(spec["min_len"], spec["max_len_prompt"] + 1))
        reqs.append(Request(rid, rng.integers(0, cfg.vocab_size, plen,
                                              dtype=np.int32),
                            max_new=spec["max_new"]))
    return reqs


def _teacher_forced(steps, transformer, cfg, model, toks, cache_dtype, dev):
    b, s = toks.shape
    caches = transformer.init_decode_caches(cfg, b, s, dtype=cache_dtype,
                                            device=dev)
    step = steps.make_decode_step(cfg)
    out = []
    for t in range(s):
        _, logits, caches = step(model, toks[:, t:t + 1], caches, t)
        out.append(logits[:, 0].float().cpu().numpy())
    return np.stack(out)


def _held(what, got, want, rtol, atol):
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    check(np.isfinite(got).all(), f"{what}: non-finite logits")
    check(not bad.any(), f"{what}: {int(bad.sum())} logits off by up to "
          f"{err.max():.3g} (rtol {rtol}, atol {atol})")
    return float(err.max())


def _served_tokens_held(what, calls, want, exact, near=BF16_TOL):
    """Hold a run's decode calls to the file's, call by call: each call's
    next tokens (all slots) equal, except, where ``exact`` is false, at a
    slot whose top-2 gap in the file is within ``near``; the first such
    difference ends the comparison (the histories part there). Returns
    (calls compared, the near-tie differences printed)."""
    check(len(calls) == len(want["calls"]),
          f"{what}: {len(calls)} decode calls, the file {len(want['calls'])}")
    for i, (got, ref) in enumerate(zip(calls, want["calls"])):
        check(got["pos"] == ref["pos"], f"{what}: call {i} at position "
              f"{got['pos']}, the file {ref['pos']}")
        check(got["finite"], f"{what}: call {i} has non-finite logits")
        diff = np.flatnonzero(got["next"] != np.asarray(ref["next"]))
        if diff.size == 0:
            continue
        gaps = np.asarray(ref["gap"])[diff]
        check(not exact and (gaps <= near).all(),
              f"{what}: call {i} slots {diff.tolist()} serve "
              f"{got['next'][diff].tolist()}, the file "
              f"{np.asarray(ref['next'])[diff].tolist()} (top-2 gaps "
              f"{gaps.tolist()})")
        print(f"  {what}: call {i} (position {ref['pos']}) slots "
              f"{diff.tolist()} differ at top-2 gaps {gaps.tolist()} <= "
              f"{near:.3g}; compared up to there")
        return i, 1
    return len(calls), 0


def _device_busy(fn):
    """(busy share, device ms, wall ms) of ``fn``: the kernels' device time
    over the host's wall, from a profile of CUDA activity alone (the host
    ops of ~100k launches would make the profile slower to read than the
    run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA) / 1e3
    return dev / wall, dev, wall


def serve_reference_phase(ref, device="cuda"):
    """13a: the port held to ``experiments/serve/reference.json`` (made by
    the JAX package): each config's spec tree and seeded weights, then in
    float32 and bfloat16 the prefill logits, the teacher-forced decode
    logits and what the ``Server`` serves; the int8-cache decode logits.
    Returns {case: largest logit gap}."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import convert, steps, transformer
    from repro_torch.models.common import tree_leaves

    dev = torch.device(device)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gaps = {}
    for arch, rec in ref["configs"].items():
        base = get_config(arch).reduced(**rec["overrides"])
        specs = sorted([p, list(s.shape)] for p, s in
                       tree_leaves(transformer.param_specs(base)))
        check(specs == rec["specs"], f"{arch}: the port's spec tree differs "
              f"from the file's")
        tree = convert.numpy_params(base, ref["seed"])
        check(convert.params_sha256(tree) == rec["weights_sha256"],
              f"{arch}: the numpy weight rule drew other weights than the "
              f"file's (numpy {np.__version__})")
        toks = torch.tensor(rec["prompt"], dtype=torch.int32, device=dev)
        for name, dt in dtypes.items():
            f32 = name == "float32"
            rtol, atol = (F32_RTOL, F32_ATOL) if f32 else (0.0, BF16_TOL)
            want = rec[name]
            cfg = dataclasses.replace(base, param_dtype=name)
            model = steps.cast_model(
                cfg, convert.from_jax_params(cfg, tree, dev))
            logits, _ = steps.make_prefill_step(cfg)(model, {"tokens": toks})
            key = f"{arch} {name}"
            gaps[f"{key} prefill"] = _held(
                f"13a {key} prefill", logits[:, 0].float().cpu().numpy(),
                _ref_array(want["prefill_logits"]), rtol, atol)
            got = _teacher_forced(steps, transformer, cfg, model, toks,
                                  dtypes[want["decode_cache_dtype"]], dev)
            gaps[f"{key} decode"] = _held(
                f"13a {key} decode", got, _ref_array(want["decode_logits"]),
                rtol, F32_SEQ_ATOL if f32 else atol)
            srv = Server(cfg, model, max_batch=ref["serve"]["max_batch"],
                         max_len=ref["serve"]["max_len"])
            calls = _recording(srv)
            for req in _serve_requests(cfg, ref["serve"], Request):
                srv.submit(req)
            while srv.step():
                pass
            # the server's caches are bf16 in both dtypes (init_decode_caches'
            # default, as in the JAX package), so a cache entry rounded the
            # other way moves its logits by far more than float32 round-off
            # (on an H100, gemma-2b float32's decode call 73 served another
            # token at a top-2 gap of 3.4e-4): both dtypes' tokens are held
            # to the file by the near-tie rule
            compared, ties = _served_tokens_held(
                f"13a {key} serve", calls, want["serve"], exact=False)
            check(srv.steps == want["serve"]["steps"]
                  and [r.rid for r in srv.done] == want["serve"]["done_order"],
                  f"13a {key} serve: {srv.steps} steps, done order "
                  f"{[r.rid for r in srv.done]}")
            if not ties:
                served = {str(r.rid): r.out for r in srv.done}
                check(served == want["serve"]["tokens"],
                      f"13a {key} serve: tokens differ from the file's")
            print(f"  13a {key}: prefill {gaps[f'{key} prefill']:.3g}, "
                  f"decode {gaps[f'{key} decode']:.3g} largest logit gap; "
                  f"served {compared}/{len(calls)} decode calls equal"
                  + (" (then a near-tie)" if ties else
                     f", {srv.steps} steps, all tokens equal"))
    rec = ref["int8"]
    cfg = dataclasses.replace(get_config(rec["arch"]).reduced(
        **rec["overrides"]), param_dtype=rec["param_dtype"])
    model = steps.cast_model(cfg, convert.from_jax_params(
        cfg, convert.numpy_params(cfg, ref["seed"]), dev))
    toks = torch.tensor(ref["configs"][rec["arch"]]["prompt"],
                        dtype=torch.int32, device=dev)
    got = _teacher_forced(steps, transformer, cfg, model, toks,
                          torch.bfloat16, dev)
    gaps["int8 decode"] = _held("13a int8 decode", got,
                                _ref_array(rec["decode_logits"]), 0.0,
                                INT8_TOL)
    print(f"  13a {rec['arch']} int8 cache: decode {gaps['int8 decode']:.3g} "
          f"largest logit gap")
    return gaps


def serve_full_width_phase(cfg, part, device="cuda", serve=FULL_SERVE,
                           prefill_len=PREFILL_DECODE_LEN,
                           flash_len=FLASH_LEN):
    """13b: ``cfg`` (gemma-2b as configured on the card) on weights drawn
    by ``init_params`` in float32 on the device, cast to bf16 as the JAX
    serve CLI casts its params; the ``Server`` answers ``serve``'s
    requests (tokens in range, logits finite); prefill of one
    ``prefill_len``-token prompt against teacher-forced decode, layer 0's
    caches held (the deeper layers' and the last logits' agreement
    printed); prefill of one ``flash_len``-token prompt, whose layer-0
    attention (flash forward over its chunks) is held to
    ``chunked_attention`` in float32. Prints and returns the decode
    step's median ms, tokens/s, busy share, peak memory and the step's
    weight-read bound."""
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import attention, steps, transformer
    from repro_torch.models.common import apply_rope, init_params

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(transformer.param_specs(cfg), gen, torch.float32, dev)
    model = transformer.Transformer(cfg, params).to(torch.bfloat16)
    del params  # the float32 copy goes before serving
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    print(f"  13b {cfg.arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.padded_vocab}: {n_params:,} parameters, "
          f"{weight_bytes / 1e9:.3f} GB bf16, built in "
          f"{time.perf_counter() - t0:.2f} s")

    # serving: a checked run (which also warms up), a timed run, a profiled run
    def run_server(check_calls):
        srv = Server(cfg, model, max_batch=serve["max_batch"],
                     max_len=serve["max_len"])
        calls = _recording(srv) if check_calls else None
        for req in _serve_requests(cfg, serve, Request):
            srv.submit(req)
        while srv.step():
            pass
        return srv, calls

    t1 = time.perf_counter()
    srv, calls = run_server(True)
    t_checked = time.perf_counter() - t1
    for i, c in enumerate(calls):
        check(c["finite"], f"13b serve: non-finite logits in decode call {i}")
        check(((c["next"] >= 0) & (c["next"] < cfg.vocab_size)).all(),
              f"13b serve: call {i} serves {c['next'].tolist()}")
    served = [t for r in srv.done for t in r.out]
    check(len(srv.done) == serve["requests"]
          and all(len(r.out) == serve["max_new"] for r in srv.done),
          f"13b serve: {len(srv.done)} requests done")
    check(all(0 <= t < cfg.vocab_size for t in served),
          "13b serve: a token outside the vocabulary")
    n_calls = len(calls)
    del calls
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv, _ = run_server(False)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tok_s = len(served) / wall
    busy = None
    # the decode step alone, batch max_batch over a max_len cache; then a
    # short window of it profiled (a profile of the whole serve loop took
    # 44 s to read)
    step = steps.make_decode_step(cfg)
    caches = transformer.init_decode_caches(cfg, serve["max_batch"],
                                            serve["max_len"], device=dev)
    tok = torch.zeros((serve["max_batch"], 1), dtype=torch.int32, device=dev)
    if on_card:
        step_ms = timed_ms(lambda: step(model, tok, caches, 100), iters=20,
                           warmup=3)
        t1 = time.perf_counter()
        busy, dev_ms, pwall = _device_busy(lambda: [
            step(model, tok, caches, 100) for _ in range(PROFILED_CALLS)])
        print(f"  13b {PROFILED_CALLS} decode steps profiled (CUDA activity "
              f"only): device {dev_ms:.1f} ms of {pwall:.1f} ms; profile "
              f"read in {time.perf_counter() - t1:.2f} s")
    else:
        step_ms = None
    bound = weight_bytes / PEAKS[part][1] * 1e3
    print(f"  13b serve: {len(srv.done)} requests, {len(served)} tokens in "
          f"{srv.steps} batch steps and {n_calls} decode calls (the naive "
          f"prefill feeds prompts through decode); every token in "
          f"[0, {cfg.vocab_size}), every logit finite (checked run "
          f"{t_checked:.2f} s, the first)")

    # prefill against teacher-forced decode: the caches each leaves
    t1 = time.perf_counter()
    rng = np.random.default_rng(serve["seed"] + 1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, prefill_len),
                                         dtype=np.int32)).to(dev)
    prefill = steps.make_prefill_step(cfg)
    logits_p, caches_p = prefill(model, {"tokens": toks})
    caches_d = transformer.init_decode_caches(cfg, 1, prefill_len, device=dev)
    for t in range(prefill_len):
        _, logits_d, caches_d = step(model, toks[:, t:t + 1], caches_d, t)
    lp = logits_p[0, 0].float().cpu().numpy()
    ld = logits_d[0, 0].float().cpu().numpy()
    check(np.isfinite(lp).all() and np.isfinite(ld).all(),
          "13b prefill/decode: non-finite logits")
    agree = []
    for name in ("k", "v"):
        kp = caches_p["l0"][name].float()
        kd = caches_d["l0"][name].float()
        err0 = float((kp[0] - kd[0]).abs().max())
        tol0 = PREFILL_DECODE_TOL * float(kd[0].abs().max())
        check(err0 <= tol0, f"13b prefill vs decode: layer 0's {name} cache "
              f"differs by {err0:.4g} > {tol0:.4g}")
        row_tol = PREFILL_DECODE_TOL * kd.abs().amax(dim=(2, 3, 4))
        agree.append(((kp - kd).abs().amax(dim=(2, 3, 4)) <= row_tol)
                     .float().mean(dim=(1,)).cpu().numpy())
    del caches_p, caches_d
    share = np.minimum(agree[0], agree[1])
    print(f"  13b prefill of {prefill_len} tokens against teacher-forced "
          f"decode ({time.perf_counter() - t1:.2f} s): layer 0's k and v "
          f"caches at every position within 2^-7 of their largest entry "
          f"(held); positions "
          f"whose k and v agree so, by layer: "
          + " ".join(f"{x:.3f}" for x in share)
          + f"; last-token logits {np.abs(lp - ld).max():.4g} apart, top-1 "
          f"{int(lp.argmax())} / {int(ld.argmax())} (not held: with these "
          f"weights the scores reach O(10^3) and the softmax's near-ties "
          f"make deeper layers chaotic even in float32)")

    # the flash forward over several chunks, layer 0 against the oracle
    t1 = time.perf_counter()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, flash_len),
                                         dtype=np.int32)).to(dev)
    nq = -(-flash_len // cfg.q_chunk)
    nk = -(-flash_len // cfg.kv_chunk)
    check(nq > 1 and nk > 1, f"13b: {flash_len} tokens are one chunk")
    with torch.no_grad():
        block = model.layers[0]
        h = transformer._apply_norm(block.norm1, model.embed_tokens(toks), cfg)
        q, k, v = attention._project_qkv(block.attn, h)
        pos = torch.arange(flash_len, device=dev)
        q = apply_rope(q, pos[None, :], cfg.rope_theta)
        k = apply_rope(k, pos[None, :], cfg.rope_theta)
        got = attention._flash(q, k, v, causal=True, prefix_len=0, cfg=cfg)
        want = attention.chunked_attention(
            q.float(), k.float(), v.float(), pos, pos, causal=True,
            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    tol_fl = 2.0 ** -7 * float(v.float().abs().max())
    err_fl = float((got.float() - want).abs().max())
    check(err_fl <= tol_fl, f"13b flash ({nq} x {nk} chunks) against "
          f"chunked_attention in float32: {err_fl:.4g} > {tol_fl:.4g}")
    logits_f, caches = prefill(model, {"tokens": toks})
    check(tuple(logits_f.shape) == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits_f).all())
          and tuple(caches["l0"]["k"].shape) == (
              cfg.n_layers, 1, flash_len, cfg.n_kv_heads, cfg.head_dim),
          f"13b prefill of {flash_len} tokens: logits "
          f"{tuple(logits_f.shape)}, caches {tuple(caches['l0']['k'].shape)}")
    del caches
    print(f"  13b flash forward over {nq} x {nk} chunks of {cfg.q_chunk} x "
          f"{cfg.kv_chunk} ({flash_len} tokens; {time.perf_counter() - t1:.2f}"
          f" s with the prefill below), layer 0 against "
          f"chunked_attention in float32: {err_fl:.4g} (<= 2^-7 max|v| = "
          f"{tol_fl:.4g}); prefill of {flash_len} tokens finite")
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    stats = {"step_ms": step_ms, "tok_s": tok_s, "busy": busy,
             "peak_gib": peak, "bound_ms": bound, "wall_s": wall,
             "calls": n_calls, "steps": srv.steps, "tokens": len(served)}
    if on_card:
        print(f"  13b decode step (batch {serve['max_batch']}, cache "
              f"{serve['max_len']}): median {step_ms:.3f} ms against a "
              f"weight-read bound of {bound:.3f} ms ({weight_bytes:,} bf16 "
              f"bytes at {PEAKS[part][1] / 1e12:.2f} TB/s); serve loop "
              f"{wall:.3f} s, {tok_s:.1f} tokens/s; device busy "
              f"{100 * busy:.1f}% of {PROFILED_CALLS} profiled decode steps; "
              f"peak device "
              f"memory {peak:.2f} GiB")
    return stats


# -- phase 14: training (the LM substrate) -----------------------------------------

#: float32 gradients against the JAX package: per leaf max |delta| within
#: F32_GRAD_TOL x the leaf's largest |entry|. The JAX package's own float32
#: gradients are up to 1.97e-4 x max |g| from a float64 evaluation of the
#: same loss, the port's up to 2.19e-4 (``experiments/train/conditioning.py``:
#: the attention scores of these weights are O(10^2)), so two float32
#: implementations may differ by twice that
F32_GRAD_TOL = 5e-4
#: float32 losses of the first step (rtol 1e-5) and of the
#: trajectory, whose later steps follow updates of +-lr where a gradient
#: entry near zero flips sign
F32_LOSS_RTOL, F32_TRAJ_RTOL = 1e-5, 1e-4
#: bfloat16 against the JAX package's bfloat16, both recorded in the file:
#: each gradient leaf's relative L2 distance (estimated from the file's
#: sketch) within BF16_GAP_FRACTION of the JAX package's own bfloat16-vs-
#: float32 distance of that leaf, and never past BF16_GRAD_RTOL; the loss
#: and grad_norm of a step within BF16_GAP_FRACTION of their own gaps. On
#: the CPU the port is at most 0.25 of the way (0.059-0.247 relative L2
#: against gaps of 0.042-1.52; tests/test_torch_train.py), so a gradient
#: computed in float32 (at the full gap), zero (1) or negated (2) fails
BF16_GAP_FRACTION, BF16_GRAD_RTOL = 0.5, 0.4
#: remat "full" against "none" on one device: the same operations, so equal
#: within float32 round-off of the atomically summed embedding gradient
REMAT_TOL = 1e-5
#: train_100m.py's configuration (examples/train_100m.py:39-40)
TRAIN_100M = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                  head_dim=64, d_ff=2048, vocab_size=16_384, loss_chunk=2048,
                  q_chunk=256, kv_chunk=256, remat="none")
TRAIN_100M_RUN = {"steps": 300, "batch": 8, "seq": 256, "lr": 6e-4,
                  "weight_decay": 0.01, "warmup": 30, "seed": 17,
                  "resume_steps": 20, "profiled_steps": 10}
#: 14c: gemma-2b at full width, one sequence of 2048 tokens a step
FULL_TRAIN = {"batch": 1, "seq": 2048, "steps": 2, "seed": 5}
#: the flash backward at gemma's shapes against autograd through
#: chunked_attention, both float32: max |delta| within FLASH_GRAD_TOL x
#: max |grad| of each of dq, dk, dv (2^-14; two float32 sums of 2048 terms
#: in other orders)
FLASH_GRAD_TOL = 2.0 ** -14


def _train_batches(cfg, spec, n, start=0):
    from repro_torch.data import DataConfig, SyntheticLM

    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                 seq_len=spec["seq"],
                                 global_batch=spec["batch"],
                                 seed=spec["seed"]))
    return [src.batch_at(i) for i in range(start, start + n)]


def _leaf_entries(t):
    flat = t.detach().float().reshape(-1).cpu().numpy()
    idx = np.linspace(0, flat.size - 1, 8).round().astype(np.int64)
    return float(np.linalg.norm(flat.astype(np.float64))), flat[idx]


def _sketch(t, path, rows, seed):
    """experiments/train/make_reference.py's ``sketch`` of a leaf."""
    flat = t.detach().double().reshape(-1).cpu().numpy()
    rng = np.random.default_rng([seed, *path.encode()])
    return np.array([np.sum(rng.standard_normal(flat.size) * flat)
                     for _ in range(rows)]) / rows ** 0.5


def _grads_held(what, grads, want, tol_of, seed=None):
    """Each gradient leaf against the file's: its L2 distance (estimated
    from the file's sketch, where it has one) and its norm's gap within
    ``tol_of(path)`` x the file's norm, its entries within ``tol_of(path)``
    x the file's largest |entry|; ``seed`` is the file's sketch seed.
    Returns the largest relative distance (or entry gap over max |g|,
    without a sketch)."""
    from repro_torch.models.common import sorted_leaves

    worst = 0.0
    got = dict(sorted_leaves(grads))
    check(sorted(got) == sorted(want), f"{what}: leaves {sorted(got)}")
    for path, rec in want.items():
        norm, vals = _leaf_entries(got[path])
        tol = tol_of(path)
        entry_err = float(np.abs(vals - np.asarray(rec["values"])).max())
        rel = (float(np.linalg.norm(
            _sketch(got[path], path, len(rec["sketch"]), seed)
            - np.asarray(rec["sketch"]))) / rec["norm"]
               if "sketch" in rec else 0.0)
        check(np.isfinite(vals).all() and entry_err <= tol * rec["absmax"]
              and abs(norm - rec["norm"]) <= tol * rec["norm"]
              and rel <= tol,
              f"{what} {path}: relative distance {rel:.4g}, norm {norm} "
              f"against {rec['norm']}, entries off by {entry_err:.4g} "
              f"(tol {tol:.4g})")
        worst = max(worst, rel if "sketch" in rec
                    else entry_err / rec["absmax"])
    return worst


def _params_held(what, params, want, grads, p0, lr, eps, grad_norm, clip,
                 gtol_of, norm_rtol):
    """The params after one AdamW step: per entry within the change a
    gradient held to ``gtol`` can make. Step 1 moves a param by -lr (x /
    (|x| + eps) + wd p) with x the clipped gradient: where |g| > 2 gtol
    the sign is fixed and x's error moves the ratio by at most eps gtol s /
    (|x| (|x| - s gtol)); elsewhere the sign may flip (2 lr). Each leaf's
    norm within ``norm_rtol``, or, with ``norm_rtol`` None (every sign may
    flip), within 2 lr sqrt(n)."""
    from repro_torch.models.common import sorted_leaves

    s = min(1.0, clip / (grad_norm + 1e-9)) if clip > 0 else 1.0
    got = dict(sorted_leaves(params))
    init = dict(sorted_leaves(p0))
    worst = 0.0
    for path, rec in want.items():
        norm, vals = _leaf_entries(got[path])
        _, start = _leaf_entries(torch.as_tensor(init[path]))
        ref = np.asarray(rec["values"])
        g = np.abs(np.asarray(grads[path]["values"]))
        gtol = gtol_of(path) * grads[path]["absmax"]
        x = s * g
        ratio_err = np.where(g > 2 * gtol, eps * s * gtol / np.maximum(
            x * (x - s * gtol), 1e-45), 2.0)
        tol = lr * np.minimum(ratio_err, 2.0) + 1e-6 * np.abs(start) + 1e-9
        err = np.abs(vals - ref)
        check(np.isfinite(vals).all() and (err <= tol).all(),
              f"{what} {path}: entries off by {err.max():.4g} (tol "
              f"{tol[np.argmax(err - tol)]:.4g})")
        norm_tol = (norm_rtol * rec["norm"] if norm_rtol is not None
                    else 2 * lr * got[path].numel() ** 0.5)
        check(abs(norm - rec["norm"]) <= norm_tol,
              f"{what} {path}: norm {norm} against {rec['norm']}")
        worst = max(worst, float(err.max()))
    return worst


def train_reference_phase(ref, device="cuda"):
    """14a: the port held to ``experiments/train/reference.json`` (made by
    the JAX package) for each config and dtype: the first step's loss and
    gradients (value and grad), the params after one AdamW step, a 5-step
    loss trajectory, a step with accum_steps=2 and remat "none" beside
    "full". bfloat16 is held to the file's bfloat16 within a fraction of
    the JAX package's own bfloat16-vs-float32 gap (``BF16_GAP_FRACTION``,
    ``BF16_GRAD_RTOL``), so a port that ran the bfloat16 config in float32
    fails. Returns {case: largest gap}."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import convert, steps
    from repro_torch.models.common import tree_map
    from repro_torch.optim import AdamWConfig, adamw

    dev = torch.device(device)
    spec = ref["data"]
    opt = ref["adamw"]
    gaps = {}
    for arch, rec in ref["configs"].items():
        base = get_config(arch).reduced(n_layers=ref["n_layers"])
        tree = convert.numpy_params(base, ref["seed"])
        data = _train_batches(base, spec, ref["trajectory_steps"])
        f32 = rec["float32"]
        for name in ("float32", "bfloat16"):
            want = rec[name]
            cfg = dataclasses.replace(base, param_dtype=name)
            is32 = name == "float32"
            if is32:
                gtol_of = lambda path: F32_GRAD_TOL  # noqa: E731
                # a gradient entry's error, for the params after a step
                gerr_of = gtol_of
                loss_tol = F32_LOSS_RTOL * abs(want["step1"]["loss"])
                traj_tol = F32_TRAJ_RTOL * abs(want["step1"]["loss"])
                gn_tol = F32_GRAD_TOL * want["step1"]["grad_norm"]
            else:
                g = want["grads"]
                gtol_of = lambda path, g=g: min(  # noqa: E731
                    BF16_GAP_FRACTION * g[path]["bf16_gap"], BF16_GRAD_RTOL)
                # an L2 distance bounds no entry below itself
                gerr_of = lambda path, g=g: (  # noqa: E731
                    gtol_of(path) * g[path]["norm"] / g[path]["absmax"])
                loss_tol = BF16_GAP_FRACTION * abs(want["step1"]["loss"]
                                                   - f32["step1"]["loss"])
                gn_tol = BF16_GAP_FRACTION * abs(want["step1"]["grad_norm"]
                                                 - f32["step1"]["grad_norm"])
                # the later steps move params by +-lr wherever a gradient
                # entry near zero differs in sign: as far as the dtypes
                traj_tol = 2 * max(abs(a - b) for a, b in zip(
                    want["trajectory"], f32["trajectory"]))

            def fresh():
                params = tree_map(lambda a: torch.from_numpy(a.copy()).to(dev),
                                  tree)
                return {"params": params,
                        "opt": adamw.init_state(params, AdamWConfig())}

            key = f"{arch} {name}"
            grad_fn = steps._value_and_grad(steps._forward_loss(cfg))
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data[0].items()}
            (loss, nll), grads = grad_fn(fresh()["params"], batch)
            check(abs(float(loss) - want["step1"]["value_and_grad_loss"])
                  <= loss_tol, f"14a {key}: loss {float(loss)} against "
                  f"{want['step1']['value_and_grad_loss']} (tol {loss_tol:.3g})")
            gaps[f"{key} grads"] = _grads_held(f"14a {key} grads", grads,
                                               want["grads"], gtol_of,
                                               ref["sketch_seed"])
            none_fn = steps._value_and_grad(steps._forward_loss(
                dataclasses.replace(cfg, remat="none")))
            (loss_n, _), grads_n = none_fn(fresh()["params"], batch)
            check(float(loss_n) == float(loss),
                  f"14a {key}: remat none loss {float(loss_n)} != full "
                  f"{float(loss)}")
            remat_gap = max(
                float((a - grads_n_leaf).abs().max() / a.abs().max())
                for a, grads_n_leaf in zip(_flat(grads), _flat(grads_n)))
            check(remat_gap <= REMAT_TOL, f"14a {key}: remat none against "
                  f"full: gradients {remat_gap:.3g} apart")
            none_want = {p: {"values": v, "norm": want["grads"][p]["norm"],
                             "absmax": want["grads"][p]["absmax"]}
                         for p, v in want["remat_none"]["grads"].items()}
            _grads_held(f"14a {key} remat none", grads_n, none_want, gtol_of)
            del grads, grads_n

            step = steps.make_train_step(cfg, AdamWConfig())
            state, m = step(fresh(), data[0])
            check(abs(float(m["loss"]) - want["step1"]["loss"]) <= loss_tol
                  and abs(float(m["grad_norm"]) - want["step1"]["grad_norm"])
                  <= gn_tol, f"14a {key}: step 1 loss {float(m['loss'])}, "
                  f"grad_norm {float(m['grad_norm'])} against {want['step1']}")
            gaps[f"{key} params"] = _params_held(
                f"14a {key} params", state["params"], want["params"],
                want["grads"], tree, opt["lr"], opt["eps"],
                want["step1"]["grad_norm"], opt["grad_clip"], gerr_of,
                F32_LOSS_RTOL if is32 else None)
            traj = [float(m["loss"])]
            for b in data[1:]:
                state, m = step(state, b)
                traj.append(float(m["loss"]))
            traj_gap = max(abs(a - b) for a, b in zip(traj, want["trajectory"]))
            check(np.isfinite(traj).all() and traj_gap <= traj_tol,
                  f"14a {key}: trajectory {traj} against {want['trajectory']} "
                  f"(tol {traj_tol:.3g})")
            gaps[f"{key} trajectory"] = traj_gap

            accum = steps.make_train_step(
                cfg, AdamWConfig(), accum_steps=2,
                accum_dtype=steps._dtype(name))
            state2, m2 = accum(fresh(), data[0])
            w2 = want["accum2"]
            check(abs(float(m2["loss"]) - w2["loss"]) <= loss_tol
                  and abs(float(m2["grad_norm"]) - w2["grad_norm"])
                  <= gn_tol,
                  f"14a {key}: accum_steps=2 loss {float(m2['loss'])}, "
                  f"grad_norm {float(m2['grad_norm'])} against {w2}")
            got2 = dict(_paths(state2["params"]))
            accum_gap = 0.0
            # the params after a step move by at most lr (1 + wd |p|) each,
            # and by 2 lr where a gradient entry near zero flips sign
            for p, vals_want in w2["params"].items():
                _, vals = _leaf_entries(got2[p])
                err = float(np.abs(vals - np.asarray(vals_want)).max())
                check(np.isfinite(vals).all() and err <= 2.02 * opt["lr"]
                      * (1 + opt["weight_decay"]) + 1e-6,
                      f"14a {key}: accum_steps=2 {p} off by {err:.4g}")
                accum_gap = max(accum_gap, err)
            del state, state2
            print(f"  14a {key}: loss {float(loss):.7f} (file "
                  f"{want['step1']['value_and_grad_loss']:.7f}); gradients "
                  f"within {gaps[f'{key} grads']:.3g} relative L2 (tol "
                  + (f"{F32_GRAD_TOL}" if is32 else "the JAX package's own "
                     f"bf16 gap per leaf x {BF16_GAP_FRACTION}, at most "
                     f"{BF16_GRAD_RTOL}") + f"); params after "
                  f"a step within "
                  f"{gaps[f'{key} params']:.3g}; 5-step trajectory within "
                  f"{traj_gap:.3g} (tol {traj_tol:.3g}); accum_steps=2 "
                  f"params within {accum_gap:.3g}; remat none vs full "
                  f"{remat_gap:.3g} x max|g|")
    return gaps


def _paths(tree):
    from repro_torch.models.common import sorted_leaves

    return list(sorted_leaves(tree))


def _flat(tree):
    return [t for _, t in _paths(tree)]


def _phi3(overrides):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("phi3-mini-3.8b"), **overrides)


def _train_100m_step(cfg, run):
    from repro_torch.models import steps
    from repro_torch.optim import AdamWConfig, warmup_cosine

    opt_cfg = AdamWConfig(lr=run["lr"], weight_decay=run["weight_decay"])
    sched = lambda s: warmup_cosine(s, run["lr"], run["warmup"],  # noqa: E731
                                    run["steps"])
    return steps.make_train_step(cfg, opt_cfg, sched), opt_cfg


def resume_child(overrides: dict, run: dict, ckpt_dir: str,
                 device: str = "cuda") -> int:
    """14b's crash/restore check, in its own process (``CUBLAS_WORKSPACE_
    CONFIG`` set by the caller before the first cuBLAS handle; on the card
    deterministic algorithms on): ``run["resume_steps"]`` steps of the phi3
    config with ``overrides`` straight, then half of them from a fresh
    init, a save through ``CheckpointManager``, a restore into a state
    drawn from another seed, and the other half. Prints one JSON line; 0
    when the two runs' params and every step's metrics are bit-equal."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import steps

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.use_deterministic_algorithms(True)
        steps.set_exact_gemms()
    cfg = _phi3(overrides)
    steps_n = run["resume_steps"]
    run = dict(run, steps=steps_n)
    step, opt_cfg = _train_100m_step(cfg, run)
    data = _train_batches(cfg, run, steps_n)

    def init(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return steps.init_train_state(cfg, gen, opt_cfg, dev)

    def metrics_of(m):
        return [float(m[k]) for k in ("loss", "nll", "grad_norm", "lr")]

    state = init(0)
    straight = []
    for i in range(steps_n):
        state, m = step(state, data[i])
        straight.append(metrics_of(m))
    final = {p: t.cpu() for p, t in _paths(state["params"])}
    del state

    half = steps_n // 2
    mgr = CheckpointManager(ckpt_dir, keep=2)
    state = init(0)
    resumed = []
    for i in range(half):
        state, m = step(state, data[i])
        resumed.append(metrics_of(m))
    mgr.save(half, state, extra={"arch": "phi3-100m"})
    del state
    state, info = mgr.restore_latest(init(1), dev)
    for i in range(info["step"], steps_n):
        state, m = step(state, data[i])
        resumed.append(metrics_of(m))
    equal_params = all(torch.equal(t.cpu(), final[p])
                       for p, t in _paths(state["params"]))
    out = {"steps": steps_n, "restored_at": info["step"],
           "metrics_equal": straight == resumed,
           "params_equal": equal_params,
           "deterministic": torch.are_deterministic_algorithms_enabled(),
           "last": straight[-1]}
    print(json.dumps(out))
    return 0 if out["metrics_equal"] and equal_params else 1


def train_100m_phase(part, device="cuda", run=TRAIN_100M_RUN,
                     overrides=TRAIN_100M, n_params_want=110_119_680,
                     min_drop=0.5, ckpt_root=None):
    """14b: train_100m.py's configuration (phi3 family, 12 x 768, 16,384
    vocab) for ``run["steps"]`` steps of batch 8 x 256 on ``SyntheticLM``
    seed 17, held to the example's ``last < first - 0.5``; each step timed
    by CUDA events; the busy share of a short profiled window; peak memory;
    then the crash/restore check in a subprocess under deterministic
    algorithms. Returns the printed numbers."""
    import tempfile

    from repro_torch.models import steps

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = _phi3(overrides)
    n_params = cfg.param_count()
    check(n_params == n_params_want, f"14b: {n_params:,} parameters")
    step, opt_cfg = _train_100m_step(cfg, run)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = steps.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), opt_cfg, dev)
    data = _train_batches(cfg, run, run["steps"])
    nlls, times = [], []
    t0 = time.perf_counter()
    for i in range(run["steps"]):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        state, m = step(state, data[i])
        if on_card:
            end.record()
            times.append((start, end))
        nlls.append(m["nll"])
    nll = torch.stack(nlls).cpu().numpy()
    wall = time.perf_counter() - t0
    first, last = float(nll[0]), float(nll[run["steps"] - 1])
    check(np.isfinite(nll).all(), "14b: a non-finite loss")
    check(last < first - min_drop, f"14b: nll {first:.3f} -> {last:.3f}, "
          f"not a fall of more than {min_drop}")
    tokens = run["batch"] * run["seq"]
    bound = 6 * n_params * tokens / BF16_PEAK[part] * 1e3
    out = {"first": first, "last": last, "wall_s": wall,
           "params": n_params, "bound_ms": bound}
    if on_card:
        ms = [s.elapsed_time(e) for s, e in times]
        med = statistics.median(ms[1:])
        busy, dev_ms, pwall = _device_busy(lambda: [
            step(state, data[i]) for i in range(run["profiled_steps"])])
        peak = torch.cuda.max_memory_allocated() / 2**30
        out.update(step_ms=med, tok_s=tokens / med * 1e3, share=bound / med,
                   busy=busy, peak_gib=peak, first_ms=ms[0])
        print(f"  14b {cfg.n_layers} x {cfg.d_model}, vocab "
              f"{cfg.padded_vocab}: {n_params:,} parameters; {run['steps']} "
              f"steps of {run['batch']} x {run['seq']} in {wall:.2f} s; nll "
              f"{first:.3f} -> {last:.3f}; step median {med:.3f} ms (first "
              f"{ms[0]:.1f} ms), {tokens / med * 1e3:,.0f} tokens/s; 6 N T "
              f"bound {bound:.3f} ms at {BF16_PEAK[part] / 1e12:.0f} TFLOP/s bf16: "
              f"{100 * bound / med:.2f}% of it (param_dtype "
              f"{cfg.param_dtype}, float32 master and AdamW); device busy "
              f"{100 * busy:.1f}% of {run['profiled_steps']} profiled steps "
              f"({dev_ms:.1f} of {pwall:.1f} ms); peak device memory "
              f"{peak:.2f} GiB")
    del state, nlls
    if on_card:
        torch.cuda.empty_cache()
    # the crash/restore check in its own process: deterministic algorithms
    # need CUBLAS_WORKSPACE_CONFIG before the first cuBLAS handle, and the
    # mode must not reach the other phases
    t1 = time.perf_counter()
    ckpt_root = pathlib.Path(ckpt_root or ROOT / "build")
    ckpt_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ckpt_root) as tmp:
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
                   PYTHONPATH=str(ROOT / "src"))
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                f"import chip_smoke; sys.exit(chip_smoke.resume_child("
                f"{overrides!r}, {run!r}, {tmp!r}, {device!r}))")
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines, f"14b crash/restore: exit "
          f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    res = json.loads(lines[-1])
    check(res["metrics_equal"] and res["params_equal"]
          and res["deterministic"] == on_card, f"14b crash/restore: {res}")
    print(f"  14b crash/restore ({time.perf_counter() - t1:.2f} s, a "
          f"subprocess, deterministic algorithms {res['deterministic']}): "
          f"{res['steps']} steps straight and with a save/restore at step "
          f"{res['restored_at']} give bit-equal params and metrics (last "
          f"loss {res['last'][0]:.6f})")
    return out


def _flash_grad_check(dev, b, s, kvh, g, d, chunk, seed=0):
    """The flash backward against autograd through chunked_attention, both
    float32; returns {name: max |delta| / max |grad|}."""
    from repro_torch.models import attention
    from repro_torch.models.flash import flash_attention

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, kvh, g, d), generator=gen, device=dev)
    k = torch.randn((b, s, kvh, d), generator=gen, device=dev)
    v = torch.randn((b, s, kvh, d), generator=gen, device=dev)
    dout = torch.randn((b, s, kvh, g, d), generator=gen, device=dev)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ins, True, 0, chunk, chunk, 0)
    got = torch.autograd.grad(out, ins, dout)
    ins2 = [x.clone().requires_grad_() for x in (q, k, v)]
    pos = torch.arange(s, device=dev)
    ref = attention.chunked_attention(
        ins2[0].reshape(b, s, kvh * g, d), ins2[1], ins2[2], pos, pos,
        causal=True, q_chunk=chunk, kv_chunk=chunk)
    want = torch.autograd.grad(ref, ins2, dout.reshape(b, s, kvh * g, d))
    return {name: float((x - y).abs().max() / y.abs().max())
            for name, x, y in zip(("dq", "dk", "dv"), got, want)}


def train_full_width_phase(cfg, part, device="cuda", run=FULL_TRAIN):
    """14c: ``cfg`` (gemma-2b as configured, remat "full") trains
    ``run["steps"]`` steps of one 2048-token sequence on a float32 master
    drawn by ``init_params`` on the device: finite loss and grad_norm,
    params that change; each step timed by CUDA events against the 6 N T
    bound; peak memory; the flash backward at the config's attention
    shapes against autograd through ``chunked_attention``. It checks
    memory, time and finiteness, not learning: ``init_params``' stacked
    fan-in makes these weights chaotic (a grad_norm of ~1e14, clipped to
    near-sign steps), so its losses and grad_norms are printed, not
    held."""
    from repro_torch.models import steps
    from repro_torch.optim import AdamWConfig

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt_cfg = AdamWConfig(moment_dtype=steps._dtype(cfg.moment_dtype))
    state = steps.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), opt_cfg, dev)
    n_params = sum(t.numel() for t in _flat(state["params"]))
    check(n_params == cfg.param_count(), f"14c: {n_params:,} parameters")
    if on_card:
        torch.cuda.synchronize()
    print(f"  14c {cfg.arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}, remat {cfg.remat}: "
          f"{n_params:,} parameters, float32 master, m and v drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    watch = {p: t[..., :64].clone() for p, t in _paths(state["params"])}
    step = steps.make_train_step(cfg, opt_cfg)
    data = _train_batches(cfg, run, run["steps"] + 1)
    ms, metrics = [], []
    for i in range(run["steps"]):
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, data[i])
        if on_card:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    busy = None
    if on_card:   # one more step, profiled (CUDA activity only)
        busy, dev_ms, pwall = _device_busy(
            lambda: step(state, data[run["steps"]]))
    for i, m in enumerate(metrics):
        check(all(np.isfinite(v) for v in m.values()),
              f"14c step {i + 1}: {m}")
    moved = sum(not torch.equal(t[..., :64], watch[p])
                for p, t in _paths(state["params"]))
    check(moved == len(watch), f"14c: {len(watch) - moved} leaves did not "
          f"change")
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    del state, watch
    if on_card:
        torch.cuda.empty_cache()
    tokens = run["batch"] * run["seq"]
    bound = 6 * n_params * tokens / BF16_PEAK[part] * 1e3
    t1 = time.perf_counter()
    flash = _flash_grad_check(dev, run["batch"], run["seq"], cfg.n_kv_heads,
                              cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
                              cfg.q_chunk)
    check(all(x <= FLASH_GRAD_TOL for x in flash.values()),
          f"14c flash backward against chunked_attention: {flash}")
    out = {"step_ms": ms, "bound_ms": bound, "peak_gib": peak,
           "metrics": metrics, "flash": flash, "busy": busy,
           "tok_s": tokens / ms[-1] * 1e3}
    print(f"  14c {run['steps']} steps of {run['batch']} x {run['seq']}: "
          + "; ".join(f"step {i + 1} loss {m['loss']:.4f} grad_norm "
                      f"{m['grad_norm']:.4g} in {t:.1f} ms"
                      for i, (m, t) in enumerate(zip(metrics, ms)))
          + f" (printed, not held: chaotic weights); every leaf changed; "
          f"step {run['steps']}: "
          f"{out['tok_s']:,.0f} tokens/s, 6 N T bound {bound:.2f} ms at "
          f"{BF16_PEAK[part] / 1e12:.0f} TFLOP/s, "
          f"{100 * bound / ms[-1]:.2f}% of it"
          + (f"; device busy {100 * busy:.1f}% of one more step, profiled "
             f"({dev_ms:.1f} of {pwall:.1f} ms); peak device memory "
             f"{peak:.2f} GiB" if on_card else ""))
    print(f"  14c flash backward (B {run['batch']}, S {run['seq']}, KV "
          f"{cfg.n_kv_heads}, G {cfg.n_heads // cfg.n_kv_heads}, D "
          f"{cfg.head_dim}, chunks of {cfg.q_chunk}) against autograd through "
          f"chunked_attention in float32: "
          + ", ".join(f"{k} {v:.3g}" for k, v in flash.items())
          + f" x max|grad| (<= 2^-14) ({time.perf_counter() - t1:.2f} s)")
    return out


def guard_phase(sref, device="cuda"):
    """14d: with ``allow_bf16_reduced_precision_reduction`` True, the train
    step and the decode step (13a's teacher-forced decode on its first
    config) refuse a CUDA model; the flag is reset after."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import convert, steps, transformer
    from repro_torch.optim import AdamWConfig, adamw

    dev = torch.device(device)
    arch, rec = next(iter(sref["configs"].items()))
    cfg = dataclasses.replace(get_config(arch).reduced(**rec["overrides"]),
                              param_dtype="bfloat16")
    tree = convert.numpy_params(cfg, sref["seed"])
    model = steps.cast_model(cfg, convert.from_jax_params(cfg, tree, dev))
    params = convert.tree_from_jax(tree, dev)
    state = {"params": params, "opt": adamw.init_state(params, AdamWConfig())}
    toks = torch.tensor(rec["prompt"], dtype=torch.int32, device=dev)
    refused = []
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        for name, call in (
                ("make_train_step", lambda: steps.make_train_step(cfg)(
                    state, {"tokens": toks, "labels": toks})),
                ("13a teacher-forced decode", lambda: _teacher_forced(
                    steps, transformer, cfg, model, toks, torch.bfloat16,
                    dev))):
            try:
                call()
            except RuntimeError as exc:
                if "exact GEMMs" not in str(exc):
                    raise
                refused.append(name)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    check(refused == ["make_train_step", "13a teacher-forced decode"],
          f"14d: the guard refused {refused}")
    print(f"  14d with allow_bf16_reduced_precision_reduction=True: "
          f"{' and '.join(refused)} refuse a CUDA model ({arch}); the flag "
          f"reset to {flag}")
    return refused


# -- phase 15: the other layer kinds (MoE, SSD, hybrid, enc-dec, prefix) -----

#: 15a's float32 tolerances, per config: LAYERS_F32_MULTIPLE x the larger
#: of the JAX package's and the port's own float32-vs-float64 gap on the
#: CPU (experiments/layers/conditioning.py (A), on the reference's
#: conditioned weights): the prefill's last-token logits (atol), the
#: teacher-forced decode continuing from a prefill's caches (atol) and the
#: gradients (per leaf max |delta| / max |g|). The prefill writes those
#: caches in bf16 in both packages, so another float32 round-off re-rounds
#: the entries next to a bf16 rounding boundary by an ulp: the decode's
#: gap is at least the largest change that round-off-sized weight moves
#: make (conditioning.py (A'): 4.4e-4 on paligemma, as on the card)
LAYERS_F32_MULTIPLE = 4
LAYERS_F32_GAPS = {
    "granite-moe-1b-a400m": {"prefill": 7.41e-7, "decode": 4.88e-5,
                             "grads": 1.96e-6},
    "mamba2-370m": {"prefill": 1.17e-6, "decode": 3.2e-5, "grads": 3.18e-6},
    "jamba-1.5-large-398b": {"prefill": 1.15e-6, "decode": 3.83e-4,
                             "grads": 9.84e-6},
    "whisper-tiny": {"prefill": 3.75e-7, "decode": 3.28e-5, "grads": 1.27e-6},
    "paligemma-3b": {"prefill": 1.14e-6, "decode": 4.39e-4, "grads": 1.64e-6},
}
#: the JAX package's own gaps between its two bf16 programs (XLA's excess
#: precision on, the default, and off; conditioning.py (B), (B')): the
#: logits (15a holds the port's within LAYERS_F32_MULTIPLE x these, at
#: least BF16_TOL; granite's decode gap is a token routed otherwise), the
#: train step's loss and the gradients' global norm. The port's gaps to the
#: file on the CPU are of the same size (0.1-1.6 x these)
LAYERS_BF16_GAPS = {
    "granite-moe-1b-a400m": {"prefill": 0.0137, "decode": 0.194,
                             "loss": 4.35e-4, "grad_norm": 3.97e-3},
    "mamba2-370m": {"prefill": 0.0117, "decode": 0.0127, "loss": 2.68e-4,
                    "grad_norm": 6.33e-3},
    "jamba-1.5-large-398b": {"prefill": 0.0186, "decode": 0.0244,
                             "loss": 3.2e-4, "grad_norm": 1.94e-3},
    "whisper-tiny": {"prefill": 5.86e-3, "decode": 7.81e-3, "loss": 5.39e-5,
                     "grad_norm": 2.94e-3},
    "paligemma-3b": {"prefill": 9.77e-3, "decode": 0.0117, "loss": 2.48e-4,
                     "grad_norm": 3.11e-3},
}
#: 15a's bfloat16 train step against the file's bfloat16, every leaf held
#: (conditioning.py (B)). Two bf16 programs round in other places, and
#: their gradients lie about as far apart as each lies from float32: XLA's
#: two are up to 1.07 x a leaf's own bf16-vs-f32 gap apart, the port is up
#: to 1.02 x from the JAX package's on the CPU. So a distance to the bf16
#: file cannot tell a bf16 gradient from a float32 one (at 1.0 x), and
#: 14a's half-gap rule is out of reach of XLA itself. 15a holds each leaf's
#: relative L2 distance (from the file's sketch) within BF16_NOISE_MULTIPLE
#: x its gap, at most BF16_GRAD_RTOL (on these weights the gaps are
#: 0.003-0.29, so a zero (1) or negated (2) gradient misses), and the whole
#: gradient at least BF16_ROUNDING_FLOOR x the JAX package's whole bf16 gap
#: from the file's float32 (a float32 gradient is ~1e-6 from it); the
#: loss within BF16_NOISE_MULTIPLE x its bf16 gap or LAYERS_F32_MULTIPLE x
#: XLA's own, whichever is larger, and grad_norm within BF16_NOISE_MULTIPLE
#: x the whole gap (the triangle inequality over the leaves' rule)
BF16_NOISE_MULTIPLE, BF16_ROUNDING_FLOOR = 2.0, 0.25
#: a MoE token's routing (its set of k expert ids) is held equal to the
#: file's where the file's top-k margin (k-th minus (k+1)-th router
#: probability) exceeds ROUTE_MARGIN[dtype]: the router probabilities of
#: the port and the JAX package are at most 1.8e-6 apart in float32 and
#: 1.6e-3 / 7.7e-3 in the first MoE layer in bfloat16 (granite / jamba;
#: conditioning.py (C)). From the first layer where a token below the
#: margin routes otherwise, later layers' inputs differ by a whole
#: expert's output (carried to other tokens by attention; 0.13 of a
#: probability in granite's second), so their routing is printed, not
#: held; in float32 so are the logits (bf16's tolerances cover XLA's own
#: flips)
ROUTE_MARGIN = {"float32": 2.0 ** -12, "bfloat16": 2.0 ** -6}


def _whole_gap(want, f32):
    """The JAX package's whole-gradient bf16-vs-f32 distance over the f32
    gradient's norm, from the file's per-leaf gaps and norms (its bf16 and
    float32 ``train`` records)."""
    n32 = {p: r["norm"] for p, r in f32["grads"].items()}
    num = sum((want["grads"][p]["bf16_gap"] * n) ** 2 for p, n in n32.items())
    return (num / sum(n * n for n in n32.values())) ** 0.5


def _layers_bf16_tols(arch, want, f32):
    """15a's bfloat16 train-step tolerances from the file's bf16 and
    float32 ``train`` records: (tol_of(path), loss_tol, grad_norm_tol)."""
    g = want["grads"]

    def tol_of(path):
        return min(BF16_NOISE_MULTIPLE * g[path]["bf16_gap"], BF16_GRAD_RTOL)

    loss_tol = max(BF16_NOISE_MULTIPLE * abs(want["step"]["loss"]
                                             - f32["step"]["loss"]),
                   LAYERS_F32_MULTIPLE * LAYERS_BF16_GAPS[arch]["loss"])
    gn_tol = min(BF16_NOISE_MULTIPLE * _whole_gap(want, f32),
                 BF16_GRAD_RTOL) * want["step"]["grad_norm"]
    return tol_of, loss_tol, gn_tol


def _bf16_rounding_held(what, grads, want, f32, seed):
    """The whole gradient's distance to the file's float32 one (from the
    sketches) at least BF16_ROUNDING_FLOOR x the JAX package's whole bf16
    gap: a bfloat16 config run in float32 fails. Returns that distance
    over the gap."""
    from repro_torch.models.common import sorted_leaves

    got = dict(sorted_leaves(grads))
    sq = sum(float(np.sum((_sketch(got[p], p, len(r["sketch"]), seed)
                           - np.asarray(r["sketch"])) ** 2))
             for p, r in f32["grads"].items())
    dist = (sq / sum(r["norm"] ** 2 for r in f32["grads"].values())) ** 0.5
    gap = _whole_gap(want, f32)
    check(dist >= BF16_ROUNDING_FLOOR * gap, f"{what}: the whole gradient "
          f"is {dist:.3g} from the float32 file's, under "
          f"{BF16_ROUNDING_FLOOR} x the bf16 gap {gap:.3g}: not rounded as "
          f"bfloat16")
    return dist / gap


def _layers_extra(cfg, batch, seed):
    """experiments/layers/make_reference.py's ``extra_inputs``."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model), np.float32)}
    if cfg.n_prefix_tokens:
        return {"prefix_embeds": rng.standard_normal(
            (batch, cfg.n_prefix_tokens, cfg.d_model), np.float32)}
    return {}


def _layers_batch(cfg, toks, extra, dt, dev):
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32).to(dev)}
    batch.update({k: torch.from_numpy(v).to(dev).to(dt)
                  for k, v in extra.items()})
    return batch


def _layers_train_batch(cfg, spec, dev):
    """experiments/layers/make_reference.py's ``train_batch``, on ``dev``
    (float32 frames / prefix embeddings: the step casts them)."""
    batch = dict(_train_batches(cfg, spec, 1)[0])
    batch.update(_layers_extra(cfg, spec["batch"], spec["input_seed"]))
    if cfg.n_prefix_tokens:
        batch["tokens"] = batch["tokens"][:, :spec["seq"] - cfg.n_prefix_tokens]
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def _continued_caches(cfg, caches, batch, window, dt, dev):
    """A prefill's caches in zeroed decode caches of ``window`` positions
    and dtype ``dt`` (make_reference.py's ``continued_caches``)."""
    from repro_torch.models import encdec, transformer
    from repro_torch.models.common import sorted_leaves, unflatten

    mod = encdec if cfg.is_encdec else transformer
    out = dict(sorted_leaves(mod.init_decode_caches(cfg, batch, window,
                                                    dtype=dt, device=dev)))
    for path, got in sorted_leaves(caches):
        zero = out[path]
        got = got.to(zero.dtype)
        if zero.shape == got.shape:
            out[path] = got.clone()
        else:
            zero[:, :, :got.shape[2]] = got
    return unflatten(out)


def _decode_from_prefill(cfg, model, batch, half, at, dev):
    """Prefill of the first ``half`` tokens (with the frames or prefix),
    teacher-forced decode of the rest from its caches in the model's
    dtype; the logits at the steps ``at`` as (len(at), B, V) float32."""
    from repro_torch.models import steps

    toks = batch["tokens"]
    b, s = toks.shape
    p = cfg.n_prefix_tokens
    _, caches = steps.make_prefill_step(cfg)(
        model, dict(batch, tokens=toks[:, :half]))
    caches = _continued_caches(cfg, caches, b, p + s, model.dtype, dev)
    step = steps.make_decode_step(cfg)
    out = []
    for t in range(half, s):
        _, logits, caches = step(model, toks[:, t:t + 1], caches, p + t)
        if t - half in at:
            out.append(logits[:, 0].float().cpu().numpy())
    return np.stack(out)


class _RouteRecorder:
    """While active, keeps each ``moe._route`` call's expert ids and router
    probabilities (host copies: outside timed windows)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.calls = moe, []

    def __enter__(self):
        route = self._route = self.moe._route

        def recording(xf, router, k):
            gate, idx, p_mean = route(xf, router, k)
            probs = torch.softmax(xf @ router, dim=-1)
            self.calls.append((idx.cpu().numpy(), probs.float().cpu().numpy()))
            return gate, idx, p_mean

        self.moe._route = recording
        return self

    def __exit__(self, *exc):
        self.moe._route = self._route


def _margins(probs, k):
    top = -np.sort(-probs, axis=-1)
    return top[:, k - 1] - top[:, k]


def _routing_held(what, calls, want, threshold):
    """Each MoE layer's routed expert sets equal to the file's on every
    token whose file margin exceeds ``threshold``, layer by layer up to the
    first layer where a token below the margin routed otherwise. Returns
    {"held", "below", "moved": token-layers, "layers": layers compared,
    "smallest": the file's smallest margin}."""
    check(len(calls) == len(want), f"{what}: {len(calls)} MoE layers routed, "
          f"the file {len(want)}")
    out = {"held": 0, "below": 0, "moved": 0, "layers": 0,
           "smallest": min(float(_ref_array(r["margin"]).min())
                           for r in want) if want else None}
    for li, ((idx, _probs), rec) in enumerate(zip(calls, want)):
        ref_idx = np.sort(np.asarray(rec["idx"]), axis=1)
        margin = _ref_array(rec["margin"])
        ok = margin > threshold
        same = (np.sort(idx, axis=1) == ref_idx).all(axis=1)
        bad = np.flatnonzero(ok & ~same)
        check(bad.size == 0, f"{what} MoE layer {li}: tokens {bad.tolist()} "
              f"routed to {idx[bad].tolist()}, the file "
              f"{np.asarray(rec['idx'])[bad].tolist()} at margins "
              f"{margin[bad].tolist()} > {threshold}")
        out["layers"] += 1
        out["held"] += int(ok.sum())
        out["below"] += int((~ok).sum())
        out["moved"] += int((~ok & ~same).sum())
        if out["moved"]:
            break
    return out


def layers_reference_phase(ref, device="cuda", archs=None, dtypes=None):
    """15a: the port held to ``experiments/layers/reference.json`` (made by
    the JAX package) for each config (``archs``, default all) in float32
    and bfloat16 (``dtypes``): the spec tree and seeded weights; the
    prefill's last-token logits; teacher-forced decode continuing from a
    prefill's caches; each MoE layer's routing above the margin threshold;
    what the ``Server`` serves (the near-tie rule of 13a); one train
    step's loss, nll, grad_norm and per-leaf gradients. Returns {case:
    largest gap}."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import convert, steps
    from repro_torch.models.common import sorted_leaves, tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw

    dev = torch.device(device)
    dtypes_of = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gaps = {}
    for arch in archs or list(ref["configs"]):
        rec = ref["configs"][arch]
        base = get_config(arch).reduced()
        specs = sorted([p, list(s.shape)] for p, s in
                       tree_leaves(steps.model_param_specs(base)))
        check(specs == rec["specs"], f"15a {arch}: the port's spec tree "
              f"differs from the file's")
        tree = convert.conditioned_params(base, ref["seed"])
        check(convert.params_sha256(tree) == rec["weights_sha256"],
              f"15a {arch}: the numpy weight rule drew other weights than "
              f"the file's (numpy {np.__version__})")
        toks = np.asarray(rec["prompt"], np.int32)
        extra = _layers_extra(base, toks.shape[0], ref["input_seed"])
        f32 = rec["float32"]
        for name in dtypes or ("float32", "bfloat16"):
            dt = dtypes_of[name]
            is32 = name == "float32"
            want = rec[name]
            key = f"{arch} {name}"
            cfg = dataclasses.replace(base, param_dtype=name)
            model = steps.cast_model(cfg, convert.from_jax_params(cfg, tree,
                                                                  dev))
            batch = _layers_batch(cfg, toks, extra, dt, dev)
            if is32:
                tol = {k: LAYERS_F32_MULTIPLE * v
                       for k, v in LAYERS_F32_GAPS[arch].items()}
            else:
                tol = {k: max(BF16_TOL, LAYERS_F32_MULTIPLE
                              * LAYERS_BF16_GAPS[arch][k])
                       for k in ("prefill", "decode")}
            with _RouteRecorder() as rr:
                logits, _ = steps.make_prefill_step(cfg)(model, batch)
            route = _routing_held(f"15a {key} routing", rr.calls,
                                  want["routing"], ROUTE_MARGIN[name])
            # in float32 a token routed otherwise (below the margin) moves
            # the logits of every later position by a whole expert's output
            tied = is32 and route["moved"] > 0
            got = logits[:, 0].float().cpu().numpy()
            pre = _ref_array(want["prefill_logits"])
            gaps[f"{key} prefill"] = (
                float(np.abs(got - pre).max()) if tied else
                _held(f"15a {key} prefill", got, pre, 0.0, tol["prefill"]))
            got = _decode_from_prefill(cfg, model, batch, ref["half"],
                                       ref["decode_at"], dev)
            dec = _ref_array(want["decode_logits"])
            gaps[f"{key} decode"] = (
                float(np.abs(got - dec).max()) if tied else
                _held(f"15a {key} decode", got, dec, 0.0, tol["decode"]))
            srv = Server(cfg, model, max_batch=ref["serve"]["max_batch"],
                         max_len=ref["serve"]["max_len"])
            calls = _recording(srv)
            for req in _serve_requests(cfg, ref["serve"], Request):
                srv.submit(req)
            while srv.step():
                pass
            # the server's caches are bf16 in both dtypes: a served token may
            # differ where the file's top-2 gap is within twice the prefill
            # logits' tolerance (at least BF16_TOL); the first difference
            # ends the comparison
            near = max(BF16_TOL, 2 * tol["prefill"])
            compared, ties = _served_tokens_held(
                f"15a {key} serve", calls, want["serve"], exact=False,
                near=near)
            check(srv.steps == want["serve"]["steps"]
                  and [r.rid for r in srv.done] == want["serve"]["done_order"],
                  f"15a {key} serve: {srv.steps} steps, done order "
                  f"{[r.rid for r in srv.done]}")
            if not ties:
                check({str(r.rid): r.out for r in srv.done}
                      == want["serve"]["tokens"],
                      f"15a {key} serve: tokens differ from the file's")
            del model, srv

            # one train step from the float32 master
            tb = _layers_train_batch(cfg, ref["train"], dev)
            wt = want["train"]
            g = wt["grads"]
            if is32:
                gtol_of = lambda path: tol["grads"]  # noqa: E731
                loss_tol = F32_LOSS_RTOL * abs(wt["step"]["loss"])
                gn_tol = tol["grads"] * wt["step"]["grad_norm"]
            else:
                gtol_of, loss_tol, gn_tol = _layers_bf16_tols(
                    arch, wt, f32["train"])
            params = tree_map(lambda a: torch.from_numpy(a.copy()).to(dev),
                              tree)
            (loss, nll), grads = steps._value_and_grad(
                steps._forward_loss(cfg))(params, tb)
            check(abs(float(loss) - wt["step"]["value_and_grad_loss"])
                  <= loss_tol, f"15a {key}: loss {float(loss)} against "
                  f"{wt['step']['value_and_grad_loss']} (tol {loss_tol:.3g})")
            gaps[f"{key} grads"] = _grads_held(
                f"15a {key} grads", grads, g, gtol_of, ref["sketch_seed"])
            rounded = (None if is32 else _bf16_rounding_held(
                f"15a {key} grads", grads, wt, f32["train"],
                ref["sketch_seed"]))
            del grads
            state = {"params": params,
                     "opt": adamw.init_state(params, AdamWConfig())}
            state, m = steps.make_train_step(cfg, AdamWConfig())(state, tb)
            check(abs(float(m["loss"]) - wt["step"]["loss"]) <= loss_tol
                  and abs(float(m["grad_norm"]) - wt["step"]["grad_norm"])
                  <= gn_tol, f"15a {key}: train step loss "
                  f"{float(m['loss'])}, grad_norm {float(m['grad_norm'])} "
                  f"against {wt['step']} (tols {loss_tol:.3g}, {gn_tol:.3g})")
            del state
            print(f"  15a {key}: prefill {gaps[f'{key} prefill']:.3g} (tol "
                  f"{tol['prefill']:.3g}), decode from prefill "
                  f"{gaps[f'{key} decode']:.3g} (tol {tol['decode']:.3g}) "
                  f"largest logit gap"
                  + (" (printed, not held: a token below the margin routed "
                     "otherwise)" if tied else "")
                  + (f"; routing of {route['layers']}/{len(want['routing'])}"
                     f" MoE layers: {route['held']} token-layers held equal, "
                     f"{route['below']} below margin "
                     f"{ROUTE_MARGIN[name]:.3g} ({route['moved']} routed "
                     f"otherwise), the file's smallest margin "
                     f"{route['smallest']:.3g}" if want["routing"] else "")
                  + f"; served {compared}/{len(calls)} decode calls equal"
                  + (f" (then a near-tie within {near:.3g})" if ties else "")
                  + f"; train step loss {float(m['loss']):.6f} (file "
                  f"{wt['step']['loss']:.6f}, tol {loss_tol:.3g}), grad_norm "
                  f"{float(m['grad_norm']):.5g} (file "
                  f"{wt['step']['grad_norm']:.5g}, tol {gn_tol:.3g}); all "
                  f"{len(g)} gradient leaves held, within "
                  f"{gaps[f'{key} grads']:.3g} relative L2"
                  + ("" if is32 else
                     f" (each within {BF16_NOISE_MULTIPLE} x its own bf16 "
                     f"gap, at most {BF16_GRAD_RTOL}; the gaps "
                     f"{min(r['bf16_gap'] for r in g.values()):.3g}-"
                     f"{max(r['bf16_gap'] for r in g.values()):.3g}); the "
                     f"whole gradient {rounded:.3g} x the bf16 gap from the "
                     f"float32 file (at least {BF16_ROUNDING_FLOOR})"))
    return gaps


#: 15b and 15c: the four configs at full width
LAYERS_FULL = ("granite-moe-1b-a400m", "mamba2-370m", "whisper-tiny",
               "paligemma-3b")
#: 15b: prefill of the first half of LAYERS_PROMPT tokens (with 1500
#: frames or 256 prefix embeddings), teacher-forced decode of the rest from
#: its caches, against the prefill of the whole prompt (within one SSD
#: chunk: the decode runs at ~60 ms a step; 15c's 2048 tokens run eight
#: chunks). 128 since phase 16 came (256 before): the script's wall
LAYERS_PROMPT = 128
#: 15b's serving run: 13b's, 8 new tokens a request (16 before phase 16)
LAYERS_SERVE = dict(FULL_SERVE, max_new=8)
#: 15c: one sequence a step: 2048 positions (paligemma: 256 prefix + 1792
#: tokens; whisper: 1500 frames + 448 decoder tokens)
LAYERS_TRAIN = {"batch": 1, "seq": 2048, "steps": 2, "seed": 5,
                "input_seed": 6, "whisper_tokens": 448}


def _full_model(cfg, dev):
    """Weights drawn by ``init_params`` in float32 on the device, cast to
    bf16 as the serve CLI casts them; (model, parameters, weight bytes)."""
    from repro_torch.models import steps
    from repro_torch.models.common import init_params

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(steps.model_param_specs(cfg), gen, torch.float32, dev)
    model = steps.make_model(cfg, params).to(torch.bfloat16)
    del params
    n = sum(p.numel() for p in model.parameters())
    return model, n, sum(p.numel() * p.element_size()
                         for p in model.parameters())


def _expert_bytes(model, cfg):
    """bf16 bytes of one expert of one MoE layer, and of all experts of
    all MoE layers."""
    total = sum(p.numel() * p.element_size()
                for name, p in model.named_parameters()
                if ".moe." in f".{name}." and not name.endswith("router"))
    n_moe = sum(ffn == "moe" for _, ffn in cfg.layer_kinds())
    return (total // (n_moe * cfg.n_experts) if n_moe else 0), total


def _cache_bytes(caches):
    from repro_torch.models.common import tree_leaves

    return sum(t.numel() * t.element_size() for _, t in tree_leaves(caches))


def layers_serve_full_width(cfg, part, device="cuda", serve=LAYERS_SERVE,
                            prompt_len=LAYERS_PROMPT):
    """15b: ``cfg`` at full width on weights drawn on the device, bf16:
    the ``Server`` answers ``serve``'s requests (tokens in range, logits
    finite); prefill of half a ``prompt_len``-token prompt (with 1500
    seeded frames or 256 seeded prefix embeddings) and teacher-forced
    decode of the rest from its caches, layer 0's caches (or SSM state)
    held to the prefill of the whole prompt. Prints and returns the decode
    step's median ms, tokens/s, busy share, peak memory and the step's
    byte bound: the weights it reads (for MoE, the experts its batch's
    routing touches) and its caches, at the card's memory rate."""
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import encdec, steps, transformer

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, n_params, weight_bytes = _full_model(cfg, dev)
    check(n_params == cfg.param_count(), f"15b {cfg.arch}: {n_params:,} "
          f"parameters, the config {cfg.param_count():,}")
    one_expert, all_experts = _expert_bytes(model, cfg)
    kinds = sorted({k for k in cfg.layer_kinds()})
    print(f"  15b {cfg.arch}: {cfg.n_layers} layers {kinds}"
          + (f" + {cfg.n_enc_layers} encoder layers over {cfg.enc_seq} "
             f"frames" if cfg.is_encdec else "")
          + f", d_model {cfg.d_model}, vocab {cfg.padded_vocab}: "
          f"{n_params:,} parameters ({cfg.active_param_count():,} active), "
          f"{weight_bytes / 1e9:.3f} GB bf16, built in "
          f"{time.perf_counter() - t0:.2f} s")

    def run_server(record):
        srv = Server(cfg, model, max_batch=serve["max_batch"],
                     max_len=serve["max_len"])
        calls = _recording(srv) if record else None
        for req in _serve_requests(cfg, serve, Request):
            srv.submit(req)
        with (_RouteRecorder() if record else contextlib.nullcontext()) as rr:
            while srv.step():
                pass
        return srv, calls, rr.calls if record else None

    t1 = time.perf_counter()
    srv, calls, routes = run_server(True)
    t_checked = time.perf_counter() - t1
    # argmax runs over the padded vocabulary, as in the JAX package, and
    # random weights fill the padded rows too: a served id may lie past
    # vocab_size (whisper: 51,865 of 51,968)
    for i, c in enumerate(calls):
        check(c["finite"], f"15b {cfg.arch} serve: non-finite logits in "
              f"decode call {i}")
        check(((c["next"] >= 0) & (c["next"] < cfg.padded_vocab)).all(),
              f"15b {cfg.arch} serve: call {i} serves {c['next'].tolist()}")
    served = [t for r in srv.done for t in r.out]
    check(len(srv.done) == serve["requests"]
          and all(len(r.out) == serve["max_new"] for r in srv.done),
          f"15b {cfg.arch} serve: {len(srv.done)} requests done")
    n_moe = sum(ffn == "moe" for _, ffn in cfg.layer_kinds())
    touched = ([len(np.unique(idx)) for idx, _ in routes] if n_moe else [])
    if on_card:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    srv, _, _ = run_server(False)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    tok_s = len(served) / wall

    # the decode step alone at batch max_batch over a max_len cache, on
    # distinct tokens; its own routing gives its bound
    mod = encdec if cfg.is_encdec else transformer
    step = steps.make_decode_step(cfg)
    caches = mod.init_decode_caches(cfg, serve["max_batch"], serve["max_len"],
                                    device=dev)
    rng = np.random.default_rng(serve["seed"] + 2)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (serve["max_batch"], 1),
                                        dtype=np.int32)).to(dev)
    with _RouteRecorder() as rr:
        step(model, tok, caches, 100)
    step_touched = [len(np.unique(idx)) for idx, _ in rr.calls]
    read = (weight_bytes - all_experts + one_expert * sum(step_touched)
            + _cache_bytes(caches))
    bound = read / PEAKS[part][1] * 1e3
    busy = step_ms = peak = None
    if on_card:
        step_ms = timed_ms(lambda: step(model, tok, caches, 100), iters=20,
                           warmup=3)
        busy, dev_ms, pwall = _device_busy(lambda: [
            step(model, tok, caches, 100) for _ in range(PROFILED_CALLS)])
    del caches
    print(f"  15b {cfg.arch} serve: {len(srv.done)} requests, {len(served)} "
          f"tokens in {srv.steps} batch steps and {len(calls)} decode calls; "
          f"every token in [0, {cfg.padded_vocab}), every logit finite "
          f"(checked run {t_checked:.2f} s)"
          + (f"; experts touched per MoE layer per decode call (batch "
             f"{serve['max_batch']} x top-{cfg.top_k} of {cfg.n_experts}): "
             f"mean {np.mean(touched):.2f}, min {min(touched)}, max "
             f"{max(touched)} over {len(touched)} layer-calls" if n_moe
             else ""))

    # prefill of half the prompt, teacher-forced decode of the rest from its
    # caches, against the prefill of the whole prompt: layer 0
    t1 = time.perf_counter()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, prompt_len),
                                         dtype=np.int32)).to(dev)
    extra = {k: torch.from_numpy(v).to(dev).to(torch.bfloat16)
             for k, v in _layers_extra(cfg, 1, serve["seed"] + 3).items()}
    batch = dict(extra, tokens=toks)
    half = prompt_len // 2
    p = cfg.n_prefix_tokens
    prefill = steps.make_prefill_step(cfg)
    logits_w, full = prefill(model, batch)
    _, part_c = prefill(model, dict(batch, tokens=toks[:, :half]))
    caches = _continued_caches(cfg, part_c, 1, p + prompt_len,
                               torch.bfloat16, dev)
    del part_c
    for t in range(half, prompt_len):
        _, logits_d, caches = step(model, toks[:, t:t + 1], caches, p + t)
    lw = logits_w[0, 0].float().cpu().numpy()
    ld = logits_d[0, 0].float().cpu().numpy()
    check(np.isfinite(lw).all() and np.isfinite(ld).all(),
          f"15b {cfg.arch} prefill/decode: non-finite logits")
    # layer 0: the decoded rows of its k/v, or its SSM state
    if cfg.is_encdec:
        rows = slice(half, prompt_len)
        pairs = {f"self {k}": (full["self"][k][0][:, rows],
                               caches["self"][k][0][:, rows])
                 for k in ("k", "v")}
    elif "ssm" in full["l0"]:
        pairs = {f"SSM {k}": (full["l0"][k][0], caches["l0"][k][0])
                 for k in ("ssm", "conv")}
    else:
        rows = slice(p + half, p + prompt_len)
        pairs = {k: (full["l0"][k][0][:, rows], caches["l0"][k][0][:, rows])
                 for k in ("k", "v")}
    held = []
    for name, (want, got) in pairs.items():
        err = float((got.float() - want.float()).abs().max())
        tol = PREFILL_DECODE_TOL * float(want.float().abs().max())
        check(err <= tol, f"15b {cfg.arch}: layer 0's {name} after decode "
              f"from the prefill's caches differs from the whole prefill's "
              f"by {err:.4g} > {tol:.4g}")
        held.append(f"{name} {err:.3g} (<= {tol:.3g})")
    del full, caches
    print(f"  15b {cfg.arch} prefill of {half} tokens"
          + (f" after {p} prefix embeddings" if p else "")
          + (f" over {cfg.enc_seq} frames" if cfg.is_encdec else "")
          + f", teacher-forced decode of {prompt_len - half} more from its "
          f"caches, against the prefill of all {prompt_len} "
          f"({time.perf_counter() - t1:.2f} s): layer 0's "
          + ", ".join(held) + f" (held within 2^-7 of the largest entry); "
          f"last-token logits {np.abs(lw - ld).max():.4g} apart, top-1 "
          f"{int(lw.argmax())} / {int(ld.argmax())} (printed, not held: "
          f"chaotic weights)")
    if on_card:
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  15b {cfg.arch} decode step (batch {serve['max_batch']}, "
              f"cache {serve['max_len']}): median {step_ms:.3f} ms against a "
              f"byte bound of {bound:.3f} ms ({read:,} bytes: weights"
              + (f" with the {sum(step_touched)} experts its routing touches "
                 f"of {n_moe * cfg.n_experts}" if n_moe else "")
              + f" and caches, at {PEAKS[part][1] / 1e12:.2f} TB/s); serve "
              f"loop {wall:.3f} s, {tok_s:.1f} tokens/s; device busy "
              f"{100 * busy:.1f}% of {PROFILED_CALLS} profiled decode steps "
              f"({dev_ms:.1f} of {pwall:.1f} ms); peak device memory "
              f"{peak:.2f} GiB")
    del model
    return {"step_ms": step_ms, "tok_s": tok_s, "busy": busy,
            "peak_gib": peak, "bound_ms": bound, "wall_s": wall,
            "touched": touched}


def _layers_full_batch(cfg, run, dev):
    """15c's batch: SyntheticLM tokens and labels over ``run["seq"]``
    positions, with seeded prefix embeddings (paligemma: the first 256
    positions) or 1500 seeded frames and ``whisper_tokens`` decoder
    tokens (whisper), in bf16 as the JAX package's arch smoke test feeds
    them."""
    spec = dict(run)
    if cfg.is_encdec:
        spec["seq"] = run["whisper_tokens"]
    return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in _layers_train_batch(cfg, spec, dev).items()}


def layers_train_full_width(cfg, part, device="cuda", run=LAYERS_TRAIN):
    """15c: ``cfg`` at full width (remat "full") trains ``run["steps"]``
    steps of one sequence on a float32 master drawn by ``init_params`` on
    the device: finite loss and grad_norm, params that change; each step
    timed against the 6 N T bound (MoE: N active; whisper: the encoder's
    parameters over the frames, the rest over the decoder tokens); the
    device's busy share over one more step, profiled; peak memory. It
    checks memory, time and finiteness, not learning (chaotic weights)."""
    from repro_torch.models import steps
    from repro_torch.optim import AdamWConfig

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt_cfg = AdamWConfig(moment_dtype=steps._dtype(cfg.moment_dtype))
    state = steps.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), opt_cfg, dev)
    paths = _paths(state["params"])
    n_params = sum(t.numel() for _, t in paths)
    check(n_params == cfg.param_count(), f"15c: {n_params:,} parameters")
    batch = _layers_full_batch(cfg, run, dev)
    if cfg.is_encdec:
        n_enc = sum(t.numel() for p, t in paths if p.startswith("enc_"))
        work = n_enc * cfg.enc_seq + (n_params - n_enc) * batch[
            "tokens"].shape[1]
        shape = (f"{cfg.enc_seq} frames + {batch['tokens'].shape[1]} tokens")
    else:
        work = cfg.active_param_count() * run["seq"]
        shape = (f"{cfg.n_prefix_tokens} prefix + "
                 f"{batch['tokens'].shape[1]} tokens" if cfg.n_prefix_tokens
                 else f"{run['seq']} tokens")
    bound = 6 * work * run["batch"] / BF16_PEAK[part] * 1e3
    print(f"  15c {cfg.arch}: {n_params:,} parameters "
          f"({cfg.active_param_count():,} active), remat {cfg.remat}, float32 "
          f"master, m and v drawn in {time.perf_counter() - t0:.2f} s")
    watch = {p: t.reshape(-1)[:64].clone() for p, t in paths}
    step = steps.make_train_step(cfg, opt_cfg)
    ms, metrics = [], []
    for i in range(run["steps"]):
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, batch)
        if on_card:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    busy = dev_ms = pwall = peak = None
    if on_card:
        busy, dev_ms, pwall = _device_busy(lambda: step(state, batch))
        peak = torch.cuda.max_memory_allocated() / 2**30
    for i, m in enumerate(metrics):
        check(all(np.isfinite(v) for v in m.values()),
              f"15c {cfg.arch} step {i + 1}: {m}")
    moved = sum(not torch.equal(t.reshape(-1)[:64], watch[p])
                for p, t in _paths(state["params"]))
    check(moved == len(watch), f"15c {cfg.arch}: {len(watch) - moved} leaves "
          f"did not change")
    del state, watch, batch
    if on_card:
        torch.cuda.empty_cache()
    print(f"  15c {cfg.arch}: {run['steps']} steps of {run['batch']} x "
          f"({shape}): "
          + "; ".join(f"step {i + 1} loss {m['loss']:.4f} grad_norm "
                      f"{m['grad_norm']:.4g} in {t:.1f} ms"
                      for i, (m, t) in enumerate(zip(metrics, ms)))
          + f" (printed, not held: chaotic weights); every leaf changed; 6 N "
          f"T bound {bound:.2f} ms at {BF16_PEAK[part] / 1e12:.0f} TFLOP/s, "
          f"{100 * bound / ms[-1]:.2f}% of step {run['steps']}"
          + (f"; device busy {100 * busy:.1f}% of one more step, profiled "
             f"({dev_ms:.1f} of {pwall:.1f} ms); peak device memory "
             f"{peak:.2f} GiB" if on_card else ""))
    return {"step_ms": ms, "bound_ms": bound, "busy": busy, "peak_gib": peak,
            "metrics": metrics}


def layers_guard_phase(ref, device="cuda"):
    """15d: with ``allow_bf16_reduced_precision_reduction`` True, an MoE
    train step, an SSM decode step and an enc-dec prefill step refuse a
    CUDA model; the flag is reset after."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import convert, steps, transformer
    from repro_torch.optim import AdamWConfig, adamw

    dev = torch.device(device)

    def cfg_of(arch):
        return dataclasses.replace(get_config(arch).reduced(),
                                   param_dtype="bfloat16")

    moe_cfg = cfg_of("granite-moe-1b-a400m")
    params = convert.tree_from_jax(convert.numpy_params(moe_cfg, ref["seed"]),
                                   dev)
    state = {"params": params, "opt": adamw.init_state(params, AdamWConfig())}
    tb = _layers_train_batch(moe_cfg, ref["train"], dev)
    ssm_cfg = cfg_of("mamba2-370m")
    ssm_model = steps.cast_model(ssm_cfg, convert.from_jax_params(
        ssm_cfg, convert.numpy_params(ssm_cfg, ref["seed"]), dev))
    ed_cfg = cfg_of("whisper-tiny")
    ed_model = steps.cast_model(ed_cfg, convert.from_jax_params(
        ed_cfg, convert.numpy_params(ed_cfg, ref["seed"]), dev))
    toks = torch.tensor(ref["configs"]["whisper-tiny"]["prompt"],
                        dtype=torch.int32, device=dev)
    ed_batch = _layers_batch(ed_cfg, toks.cpu().numpy(), _layers_extra(
        ed_cfg, toks.shape[0], ref["input_seed"]), torch.bfloat16, dev)
    refused = []
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        for name, call in (
                ("MoE train step", lambda: steps.make_train_step(moe_cfg)(
                    state, tb)),
                ("SSM decode step", lambda: steps.make_decode_step(ssm_cfg)(
                    ssm_model, toks[:, :1], transformer.init_decode_caches(
                        ssm_cfg, toks.shape[0], 4, device=dev), 0)),
                ("enc-dec prefill step", lambda: steps.make_prefill_step(
                    ed_cfg)(ed_model, ed_batch))):
            try:
                call()
            except RuntimeError as exc:
                if "exact GEMMs" not in str(exc):
                    raise
                refused.append(name)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    want = ["MoE train step", "SSM decode step", "enc-dec prefill step"]
    check(refused == want, f"15d: the guard refused {refused}")
    print(f"  15d with allow_bf16_reduced_precision_reduction=True: "
          f"{', '.join(refused)} refuse a CUDA model; the flag reset to {flag}")
    return refused


# -- phase 16: sharding (four gloo ranks on the one card) ---------------------------

#: ranks of phase 16: gloo ranks sharing the one card, as phase 12's
SHARD_RANKS = 4
#: 16's wall limit on the ranks (they are killed past it; it also bounds
#: each collective)
SHARD_TIMEOUT_S = 600
#: 16b: granite-moe-1b-a400m as configured on (data, model) = (2, 2):
#: FSDP over data, EP over model, a global batch of 2 x 2048 (one sequence
#: per data rank), one step of build_trainer (two before phase 18 came: the
#: script's wall)
SHARD_TRAIN = {"arch": "granite-moe-1b-a400m", "mesh": (2, 2), "batch": 2,
               "seq": 2048, "steps": 1, "seed": 5}
#: 16c: gemma-2b as configured on (1, 4), decode_attention="sharded", on
#: each rank's blocks (the MLP and the vocabulary over model): its one KV
#: head does not divide 4, so the heads stay whole and the 256-slot cache
#: shards its sequence over model (64 slots a rank); batch 4, 8 decode
#: steps
SHARD_SERVE = {"arch": "gemma-2b", "mesh": (1, 4), "batch": 4,
               "max_len": 256, "steps": 8, "seed": 0}
#: 16d: the int8 pod-compressed step on (pod, data, model) = (2, 1, 1) at
#: train_100m.py's configuration, 10 steps, beside the uncompressed step
SHARD_COMPRESSED = {"mesh": (2, 1, 1), "steps": 10}
#: 16d: the compressed run's last loss within this fraction of the
#: uncompressed run's (error feedback keeps the two together)
COMPRESSED_LOSS_RTOL = 1e-2
#: lr of the reference's steps (AdamWConfig's default)
SHARD_LR = 3e-4


def _peak_gib(dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _mesh_bytes():
    from repro_torch import obs

    return {f"{k} {unit}": obs.counter(f"mesh.{k}_{unit}").value
            for k in ("all_gather", "reduce_scatter", "all_reduce",
                      "all_to_all", "ppermute") for unit in ("bytes", "us")}


def _storage_bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees`` (a step's resident
    arguments)."""
    from torch.utils._pytree import tree_leaves

    seen = {}
    for t in tree_leaves(list(trees)):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _batch_block_bytes(batch, plan) -> int:
    """Bytes of this rank's block of a global batch over the plan's batch
    axes (the whole batch where it does not divide them)."""
    from repro_torch.sharding.partition import batch_axis

    b = next(iter(batch.values())).shape[0]
    n = (plan.axis_size(plan.batch_axes) if batch_axis(plan, b) is not None
         else 1)
    return sum(v.nbytes // n for v in batch.values())


def _step_start(dev) -> int:
    """Before a step: the peak reset (so the step alone sets it); returns
    the bytes allocated now."""
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _step_growth(dev, start: int) -> int:
    """After a step: how far its peak rose above the bytes allocated at
    its start."""
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - start


def _ep_layer_check(cfg, mesh, plan, spec, dev):
    """16b: one granite MoE layer at full width (capacity_factor 8: no
    drops) on the mesh's EP path against the port's ``_moe_local`` on the
    whole batch, bf16; tokens whose top-k router margin is below
    ROUTE_MARGIN["float32"] are left out (a near-tie may route otherwise
    between two float32 products). Returns (the largest gap over the
    layer's largest |out|, tokens held, tokens)."""
    from repro_torch.models import moe
    from repro_torch.models.common import init_params
    from repro_torch.sharding.comm import all_gather
    from repro_torch.sharding.partition import activation_ctx, rebatch

    cfg8 = dataclasses.replace(cfg, capacity_factor=8.0)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    p = init_params(moe.param_specs(cfg8), gen, torch.float32, dev)
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    x = (torch.randn((spec["batch"], spec["seq"], cfg.d_model), generator=gen,
                     device=dev) * 0.5).to(torch.bfloat16)
    with torch.no_grad(), activation_ctx(plan, True):
        y = moe.moe(p, rebatch(x, plan, False, True), cfg8)[0]
        y = all_gather(y, mesh, plan.batch_axes, 0)
    if mesh.rank != 0:
        return None
    with torch.no_grad():
        x2 = x.reshape(-1, cfg.d_model)
        want = moe._moe_local(x2, p["router"], p["wi"], p["wg"], p["wo"],
                              cfg8)[0]
        probs = torch.softmax(x2.float() @ p["router"].float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        held = (top[:, cfg.top_k - 1] - top[:, cfg.top_k]
                >= ROUTE_MARGIN["float32"])
    got = y.reshape(-1, cfg.d_model)
    gap = float((got - want).float().abs()[held].max()) / float(
        want.float().abs().max())
    return gap, int(held.sum()), int(held.numel())


def _shard_train(mesh, dev, spec=SHARD_TRAIN):
    """16b on this rank: ``build_trainer`` on the (2, 2) mesh,
    ``spec["steps"]`` steps."""
    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import build_trainer

    cfg = get_config(spec["arch"])
    if spec.get("reduced"):
        cfg = cfg.reduced()
    m = make_debug_mesh(spec["mesh"], device=dev)
    _reset_peak(dev)
    init_state, step_fn, data_at, _, plan = build_trainer(
        cfg, m, seed=spec["seed"], data_cfg=DataConfig(
            vocab_size=cfg.vocab_size, seq_len=spec["seq"],
            global_batch=spec["batch"], seed=spec["seed"]), device=dev)
    t0 = time.perf_counter()
    state = init_state()
    _sync(dev)
    rec = {"init_s": time.perf_counter() - t0, "notes": list(plan.notes),
           "ms": [], "loss": [], "bytes": [], "step_mem": [],
           "resident": (_storage_bytes(state)
                        + _batch_block_bytes(data_at(0), plan))}
    for i in range(spec["steps"]):
        before = _mesh_bytes()
        start = _step_start(dev)
        tdist.barrier()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data_at(i))
        _sync(dev)
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        rec["step_mem"].append((start, _step_growth(dev, start)))
        rec["loss"].append(float(metrics["loss"]))
        rec["bytes"].append({k: v - before[k]
                             for k, v in _mesh_bytes().items()})
    rec["peak_gib"] = _peak_gib(dev)
    rec["block_params"] = sum(t.numel() for _, t in
                              _flat_leaves(state["params"]))
    del state
    _reset_peak(dev)
    rec["ep_layer"] = _ep_layer_check(cfg, m, plan, spec, dev)
    return rec


def _flat_leaves(tree):
    from repro_torch.models.common import sorted_leaves

    return list(sorted_leaves(tree))


def _rank_model(cfg, m, plan, dev, seed=0):
    """This rank's model at full width: its blocks of every leaf
    (``partition.serving_shardings``), each drawn whole on the card from
    one seeded generator in ``init_params``' order and cut at once, so the
    whole model never exists here; rank 0's oracle draws the same stream
    whole (``init_params``). Returns (model, its blocks' bytes from the
    spec tree, the whole model's bytes)."""
    from repro_torch.models import steps
    from repro_torch.models.common import init_params, sorted_leaves
    from repro_torch.sharding.partition import block, serving_shardings

    specs = dict(sorted_leaves(serving_shardings(cfg, plan)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = init_params(steps.model_param_specs(cfg), gen, torch.bfloat16,
                         dev, cut=lambda path, t: block(t, specs[path], m))
    model = steps.make_model(cfg, blocks, plan)
    whole = held = 0
    for path, sp in sorted_leaves(steps.model_param_specs(cfg)):
        n = 2 * math.prod(sp.shape)
        whole += n
        for e in specs[path]:
            if e is not None:
                n //= m.axis_size(e)
        held += n
    return model, held, whole


def _oracle_model(cfg, dev, seed=0):
    from repro_torch.models import steps
    from repro_torch.models.common import init_params

    gen = torch.Generator(device=dev).manual_seed(seed)
    return steps.make_model(cfg, init_params(steps.model_param_specs(cfg),
                                             gen, torch.bfloat16, dev))


def _layer0_oracle(model, m):
    """Layer 0 whole, from this rank's blocks (gathered over every axis):
    a `Block` outside any plan."""
    from repro_torch.models import transformer as TT
    from repro_torch.sharding.partition import gather_leaf

    b = model.layers[0]
    return TT.Block({name: {k: gather_leaf(t, b.spec[name][k], m)[None]
                            for k, t in getattr(b, name).items()}
                     for name in b.names}, 0)


def _shard_serve(mesh, dev, spec=SHARD_SERVE):
    """16c on this rank: gemma-2b's decode steps on this rank's blocks of
    the weights (``params_only_shardings``: the MLP and the vocabulary over
    model, the heads whole) with the cache seq-sharded over model; then
    layer 0 at the next position, sharded against the gathered decode of
    the whole layer on the whole cache."""
    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import steps, transformer as TT
    from repro_torch.sharding import make_plan
    from repro_torch.sharding.partition import (activation_ctx,
                                                decode_input_shardings,
                                                gather_leaf)
    from repro_torch.sharding.rules import P

    cfg = get_config(spec["arch"])
    if spec.get("reduced"):
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, decode_attention="sharded")
    m = make_debug_mesh(spec["mesh"], device=dev)
    plan = make_plan(cfg, m)
    _reset_peak(dev)
    model, held, whole_bytes = _rank_model(cfg, m, plan, dev)
    n = sum(p.numel() for p in model.parameters())
    b, smax = spec["batch"], spec["max_len"]
    whole = TT.init_decode_caches(cfg, b, smax, device="meta")
    cspec = decode_input_shardings(cfg, plan, {"caches": whole})["caches"]
    caches = TT.init_decode_caches(cfg, b, smax, device=dev, plan=plan)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    toks = torch.randint(0, cfg.vocab_size, (spec["steps"] + 1, b, 1),
                         generator=gen, device=dev, dtype=torch.int32)
    step = steps.make_decode_step(cfg)
    params_bytes = _storage_bytes(list(model.parameters())
                                  + list(model.buffers()))
    rec = {"ms": [], "cache_spec": list(map(str, cspec["l0"]["k"])),
           "slots": caches["l0"]["k"].shape[2],
           "cache_seq_axis": plan.cache_seq_axis, "params": n,
           "params_bytes": params_bytes, "block_bytes": held,
           "whole_bytes": whole_bytes, "bytes": [], "step_mem": [],
           "resident": (params_bytes + _storage_bytes(caches)
                        + toks[0].numel() * toks.element_size())}
    with activation_ctx(plan, True):
        for t in range(spec["steps"]):
            before = _mesh_bytes()
            start = _step_start(dev)
            tdist.barrier()
            t0 = time.perf_counter()
            step(model, toks[t], caches, t)
            _sync(dev)
            rec["ms"].append(1e3 * (time.perf_counter() - t0))
            rec["step_mem"].append((start, _step_growth(dev, start)))
            rec["bytes"].append({k: v - before[k]
                                 for k, v in _mesh_bytes().items()})
    # layer 0 at the next position: the rank's blocks under the plan
    # against the whole layer's gathered decode on the whole cache
    pos = spec["steps"]
    seq = P(None, "model", None, None)
    mine = {k: v[0].clone() for k, v in caches["l0"].items()}
    full = {k: gather_leaf(v, seq, m) for k, v in mine.items()}
    layer0 = _layer0_oracle(model, m)
    with torch.no_grad():
        with activation_ctx(plan, True, blocks=True):
            x0 = model.embed_tokens(toks[pos])
            y_sh = model.layers[0].decode(x0, mine, pos, cfg)
        y_g = layer0.decode(x0, full, pos, cfg)
    rec["layer0_gap"] = float((y_sh - y_g).float().abs().max()) / float(
        y_g.float().abs().max())
    rec["peak_gib"] = _peak_gib(dev)
    del model, caches, layer0
    return rec


def _shard_compressed(dev, spec=SHARD_COMPRESSED, run=TRAIN_100M_RUN,
                      overrides=TRAIN_100M):
    """16d on ranks 0 and 1: the compressed step at train_100m.py's
    configuration, then (rank 0) the uncompressed step from the same
    init on the same batches."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import steps
    from repro_torch.models.common import init_params
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.optim.compression import init_error_state
    from repro_torch.sharding import make_plan

    m = make_debug_mesh(spec["mesh"], ("pod", "data", "model"), device=dev)
    if m is None:
        return None
    cfg = _phi3(overrides)
    opt_cfg = AdamWConfig(lr=run["lr"], weight_decay=run["weight_decay"])
    batches = _train_batches(cfg, run, spec["steps"])

    def fresh():
        gen = torch.Generator(device=dev).manual_seed(run["seed"])
        params = init_params(steps.model_param_specs(cfg), gen,
                             torch.float32, dev)
        return {"params": params, "opt": adamw.init_state(params, opt_cfg)}

    _reset_peak(dev)
    state, err = fresh(), None
    err = init_error_state(state["params"])
    plan = make_plan(cfg, m)
    step = steps.make_compressed_train_step(cfg, plan, opt_cfg)
    rec = {"loss": [], "ms": [], "bytes": [], "step_mem": [],
           "resident": (_storage_bytes(state, err)
                        + _batch_block_bytes(batches[0], plan))}
    for batch in batches:
        before = _mesh_bytes()
        start = _step_start(dev)
        t0 = time.perf_counter()
        state, metrics, err = step(state, batch, err)
        rec["loss"].append(float(metrics["loss"]))
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        rec["step_mem"].append((start, _step_growth(dev, start)))
        rec["bytes"].append({k: v - before[k]
                             for k, v in _mesh_bytes().items()})
    rec["peak_gib"] = _peak_gib(dev)
    del state, err
    if m.rank == 0:
        state = fresh()
        plain = steps.make_train_step(cfg, opt_cfg)
        rec["plain_loss"] = []
        for batch in batches:
            state, metrics = plain(state, batch)
            rec["plain_loss"].append(float(metrics["loss"]))
        del state
    return rec


# -- phase 18: serving on the rank's blocks (tensor parallelism over model) ---

#: 18b: phi3-mini-3.8b as configured on (data, model) = (1, 4): pure tensor
#: parallelism (8 q and 8 kv heads, d_ff 2048 and 8032 vocabulary rows a
#: rank); a batch of 4, a 64-token prefill padded to a 256-slot window,
#: then 64 decode steps
TP_FULL = {"arch": "phi3-mini-3.8b", "mesh": (1, 4), "batch": 4,
           "prompt": 64, "max_len": 256, "steps": 64, "seed": 1}
#: 18c: yi-34b at full width cut to 8 of its 60 layers, on (2, 2): FSDP
#: over data on embed, GQA over model (28 q and 4 kv heads a rank); a batch
#: of 2, a 64-token prefill padded to a 256-slot window, 16 decode steps
TP_FSDP = {"arch": "yi-34b", "n_layers": 8, "mesh": (2, 2), "batch": 2,
           "prompt": 64, "max_len": 256, "steps": 16, "seed": 2}


def _tp_config(spec):
    from repro_torch.configs import get_config

    cfg = get_config(spec["arch"])
    if spec.get("reduced"):
        cfg = cfg.reduced(**spec.get("overrides", {}))
    if spec.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    return cfg


def _tp_serve(mesh, dev, spec):
    """18b / 18c on this rank: the model on its blocks (drawn leaf by leaf
    and cut), the prefill of its block of the batch, the caches padded to
    the window, the teacher-forced decode steps, each timed with its
    collectives' bytes and wall; then, on rank 0 only, the whole model as
    the oracle on the whole batch: layer 0's prefill caches held, the
    logits' gaps printed."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import steps, transformer as TT
    from repro_torch.sharding import make_plan
    from repro_torch.sharding.partition import (
        activation_ctx, batch_axis, block, decode_input_shardings,
        gather_leaf, serving_cache_shardings)
    from repro_torch.sharding.rules import P

    cfg = _tp_config(spec)
    m = make_debug_mesh(spec["mesh"], device=dev)
    plan = make_plan(cfg, m)
    b, pr, n = spec["batch"], spec["prompt"], spec["steps"]
    _reset_peak(dev)
    t0 = time.perf_counter()
    model, held, whole_bytes = _rank_model(cfg, m, plan, dev, spec["seed"])
    _sync(dev)
    init_peak = _peak_gib(dev)
    # the serving peak: from the blocks on (a whole leaf at a time was drawn
    # before, init_peak_gib)
    _reset_peak(dev)
    rec = {"init_s": time.perf_counter() - t0, "init_peak_gib": init_peak,
           "block_bytes": held,
           "whole_bytes": whole_bytes,
           "params_bytes": _storage_bytes(list(model.parameters())),
           "heads": model.layers[0].attn["wq"].shape[1],
           "kv_heads": model.layers[0].attn["wk"].shape[1],
           "d_ff": model.layers[0].mlp["wo"].shape[0],
           "vocab_rows": (model.embed.shape[0] if cfg.tie_embeddings
                          else model.lm_head.shape[1]),
           "ms": [], "bytes": [], "step_mem": []}
    gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 100)
    toks = torch.randint(0, cfg.vocab_size, (b, pr + n), generator=gen,
                         device=dev, dtype=torch.int32)
    split = batch_axis(plan, b) is not None
    bspec = P(plan.batch_axes if split else None, None)
    mine = block(toks, bspec, m)
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    prompt_caches = TT.init_decode_caches(cfg, b, pr, device="meta")
    pspec = serving_cache_shardings(cfg, plan, prompt_caches, split)["l0"]
    window = TT.init_decode_caches(cfg, b, spec["max_len"], device="meta")
    wspec = decode_input_shardings(cfg, plan, {"caches": window})["caches"]
    rec["cache_block_bytes"] = sum(
        2 * math.prod(t.shape) // math.prod(
            m.axis_size(e) for e in wspec[name][k] if e is not None)
        for name, c in window.items() for k, t in c.items())
    with activation_ctx(plan, split):
        before = _mesh_bytes()
        tdist.barrier()
        t0 = time.perf_counter()
        logits, caches = prefill(model, {"tokens": mine[:, :pr]})
        _sync(dev)
        rec["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["prefill_bytes"] = {k: v - before[k]
                                for k, v in _mesh_bytes().items()}
        pre_logits = gather_leaf(logits, P(bspec[0], None, None), m)
        pre_l0 = {k: gather_leaf(caches["l0"][k][0], P(*pspec[k][1:]), m)
                  for k in ("k", "v")}
        caches = model.pad_caches(caches, spec["max_len"])
        rec["cache_bytes"] = _storage_bytes(caches)
        rec["resident"] = (rec["params_bytes"] + rec["cache_bytes"]
                           + mine[:, :1].numel() * mine.element_size())
        step_logits = []
        for t in range(n):
            before = _mesh_bytes()
            start = _step_start(dev)
            tdist.barrier()
            t0 = time.perf_counter()
            _, logits, caches = decode(model, mine[:, pr + t:pr + t + 1],
                                       caches, pr + t)
            _sync(dev)
            rec["ms"].append(1e3 * (time.perf_counter() - t0))
            rec["step_mem"].append((start, _step_growth(dev, start)))
            rec["bytes"].append({k: v - before[k]
                                 for k, v in _mesh_bytes().items()})
            step_logits.append(gather_leaf(logits, P(bspec[0], None, None),
                                           m))
    rec["peak_gib"] = _peak_gib(dev)
    rec["finite"] = bool(torch.isfinite(pre_logits).all()) and all(
        bool(torch.isfinite(x).all()) for x in step_logits)
    rec["shape_ok"] = tuple(pre_logits.shape) == (b, 1, cfg.padded_vocab)
    del model, caches
    if m.rank == 0:
        _reset_peak(dev)
        oracle = _oracle_model(cfg, dev, spec["seed"])
        rec["oracle_peak_gib"] = _peak_gib(dev)
        with torch.no_grad():
            t0 = time.perf_counter()
            lo, co = prefill(oracle, {"tokens": toks[:, :pr]})
            _sync(dev)
            rec["oracle_prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            rec["layer0"] = {}
            for k in ("k", "v"):
                want = co["l0"][k][0].float()
                err = float((pre_l0[k].float() - want).abs().max())
                rec["layer0"][k] = (err, float(want.abs().max()))
            rec["prefill_logits_gap"] = float(
                (pre_logits.float() - lo.float()).abs().max())
            rec["logits_max"] = float(lo.float().abs().max())
            co = oracle.pad_caches(co, spec["max_len"])
            rec["oracle_ms"], rec["step_gaps"], rec["top1"] = [], [], []
            for t in range(n):
                t0 = time.perf_counter()
                _, lg, co = decode(oracle, toks[:, pr + t:pr + t + 1], co,
                                   pr + t)
                _sync(dev)
                rec["oracle_ms"].append(1e3 * (time.perf_counter() - t0))
                got = step_logits[t].float()
                rec["step_gaps"].append(float((got - lg.float()).abs()
                                              .max()))
                rec["top1"].append(float((got.argmax(-1) == lg.float()
                                          .argmax(-1)).float().mean()))
        del oracle, co
    return rec


def _tp_reference(mesh, tp_start):
    """18a on this rank: ``mesh_cases.run``'s ``tp`` part (the shared
    decode start ``tp_start`` from the reference file); rank 0 keeps the
    arrays (every rank's bytes and collectives are among them)."""
    arrays, walls = _mc().run(mesh, ("tp",), tp_start)
    return {"walls": walls, "arrays": arrays if mesh.rank == 0 else None}


def _mc():
    from repro_torch.sharding import mesh_cases

    return mesh_cases


#: what phase 16's ranks run (``sharding_rank``'s ``sizes``; a rehearsal on
#: the host passes smaller ones)
SHARD_SIZES = {"train": SHARD_TRAIN, "serve": SHARD_SERVE,
               "compressed": SHARD_COMPRESSED, "run": TRAIN_100M_RUN,
               "overrides": TRAIN_100M, "tp_full": TP_FULL,
               "tp_fsdp": TP_FSDP}


def sharding_rank(mesh, exchange, sizes=SHARD_SIZES, tp_start=None):
    """Phases 16 and 18 on one of four ranks: (16a)
    ``sharding.mesh_cases.run`` and the compressed exchange on the
    reference's gradients (ranks 0-1), (16b) granite-moe-1b-a400m's
    sharded training, (16c) gemma-2b's seq-sharded decode on its blocks,
    (16d) the compressed step; (18a) ``mesh_cases.run``'s ``tp`` part,
    (18b) phi3-mini-3.8b and (18c) yi-34b served on their blocks. Every
    rank's record goes to rank 0, which returns them with 16a's and 18a's
    arrays."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import steps
    from repro_torch.sharding import mesh_cases as MC

    t_enter = time.time()
    dev = mesh.device
    steps.set_exact_gemms()
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    rec = {"rank": mesh.rank, "walls": {}, "peaks": {}, "t_enter": t_enter}
    t0 = time.perf_counter()
    _reset_peak(dev)
    rec["cuda_init_s"] = time.perf_counter() - t0
    # ``sizes["parts"]``: the labels to run (a driver iterating on some)
    parts = sizes.get("parts", ("a", "b", "c", "d", "18a", "18b", "18c"))
    arrays = exch = None
    pods = make_debug_mesh((2, 1, 1), ("pod", "data", "model"), device=dev)
    if "a" in parts:
        arrays, rec["a_walls"] = MC.run(mesh)
        exch = (MC.pod_exchange(pods, *exchange) if pods is not None
                else None)
        rec["peaks"]["a"] = _peak_gib(dev)
        rec["walls"]["a"] = time.perf_counter() - t0
    for label, fn in (
            ("b", lambda: _shard_train(mesh, dev, sizes["train"])),
            ("c", lambda: _shard_serve(mesh, dev, sizes["serve"])),
            ("d", lambda: _shard_compressed(dev, sizes["compressed"],
                                            sizes["run"],
                                            sizes["overrides"])),
            ("18a", lambda: _tp_reference(mesh, tp_start)),
            ("18b", lambda: _tp_serve(mesh, dev, sizes["tp_full"])),
            ("18c", lambda: _tp_serve(mesh, dev, sizes["tp_fsdp"]))):
        if label not in parts:
            continue
        _sync(dev)
        tdist.barrier()
        t0 = time.perf_counter()
        rec[label] = fn()
        _sync(dev)
        rec["walls"][label] = time.perf_counter() - t0
        tdist.barrier()
    rec["t_exit"] = time.time()
    everyone = [None] * mesh.size
    tdist.all_gather_object(everyone, rec)
    return arrays, exch, everyone


# -- 16a's comparisons against experiments/sharding/reference.json -------------

def _ref_decode(rec):
    """A reference.json array: whole (float32 or int32) or its summary."""
    if "b64" in rec:
        import base64

        return np.frombuffer(base64.b64decode(rec["b64"]),
                             dtype=rec["dtype"]).reshape(rec["shape"])
    return rec


def _sketch_of(flat, key, rows):
    """experiments/sharding/make_reference.py's sketch of a flat array."""
    rng = np.random.default_rng([REF_SKETCH_SEED, *key.encode()])
    return np.array([np.sum(rng.standard_normal(flat.size) * flat)
                     for _ in range(rows)]) / rows ** 0.5


def _array_held(key, got, rec, rtol, atol):
    """``got`` against the file's ``rec`` within ``atol + rtol x |want|``
    per entry; for a summarized array (past the file's ``whole`` entries)
    its 8 entries within ``atol + rtol x absmax``, its norm within that
    times sqrt(n), and its sketch's distance within 1.5 times that times
    sqrt(n) (a 64-row Gaussian sketch estimates the L2 distance to ~18%).
    Returns the largest gap over its limit."""
    want = _ref_decode(rec)
    got = np.asarray(got)
    if isinstance(want, np.ndarray):
        check(got.shape == want.shape, f"16a {key}: shape {got.shape} "
                                       f"against {want.shape}")
        lim = atol + rtol * np.abs(want.astype(np.float64))
        err = np.abs(got.astype(np.float64) - want.astype(np.float64))
        check(np.isfinite(got).all() and (err <= lim).all(),
              f"16a {key}: off by {err.max():.4g} (limit "
              f"{lim.reshape(-1)[np.argmax(err - lim)]:.4g})")
        return float((err / np.maximum(lim, 1e-30)).max())
    check(list(got.shape) == want["shape"], f"16a {key}: shape")
    flat = got.astype(np.float64).reshape(-1)
    lim = atol + rtol * want["absmax"]
    idx = np.linspace(0, flat.size - 1, len(want["values"])).round().astype(
        np.int64)
    err = float(np.abs(flat[idx] - np.asarray(want["values"])).max())
    root = flat.size ** 0.5
    norm_err = abs(float(np.linalg.norm(flat)) - want["norm"])
    sk_err = float(np.linalg.norm(_sketch_of(flat, key, len(want["sketch"]))
                                  - np.asarray(want["sketch"])))
    check(np.isfinite(flat).all() and err <= lim and norm_err <= lim * root
          and sk_err <= 1.5 * lim * root,
          f"16a {key}: entries off by {err:.4g}, norm by {norm_err:.4g}, "
          f"sketch by {sk_err:.4g} (limit {lim:.4g} an entry)")
    return max(err / lim, norm_err / (lim * root),
               sk_err / (1.5 * lim * root))


#: experiments/sharding/make_reference.py's sketch seed
REF_SKETCH_SEED = 16


def _tolerance(key, want):
    """(rtol, atol) of a 16a array: ``tests/test_torch_sharding_mesh.py``'s
    rules."""
    part = key.split("/")
    if part[0] == "ep":
        return (1e-3, 0.0) if part[-1] == "aux" else (2e-4, 2e-4)
    if part[0] == "decode":
        if part[1] == "int8" and part[-1] == "out":
            return 0.0, 2.0 ** -6 * float(np.abs(_ref_decode(want)).max())
        if part[-1] in ("k_scale", "v_scale"):
            return 2.0 ** -7, 0.0
        return (0.0, 1.0) if part[1] == "int8" else (0.0, 5e-5)
    if part[0] == "pipeline":
        return (2e-5, 2e-5) if part[-1] == "out" else (1e-4, 1e-4)
    if part[0] == "compressed":
        if part[1] == "params":
            return 0.0, 2 * SHARD_LR * 2 + 1e-6
        return 1e-4, 0.0
    if part[0] == "train":
        if part[2] == "grad":
            return 0.0, 5e-4 * (want["absmax"] if "absmax" in want else
                                float(np.abs(_ref_decode(want)).max()))
        if part[2] == "params":
            return 0.0, 2 * SHARD_LR * 2 + 1e-6
        if part[2] in ("loss", "nll"):
            return 1e-5, 0.0
        return 1e-4, 0.0
    raise KeyError(key)


def sharding_reference_check(ref, arrays, exch):
    """16a: the ranks' arrays against the file's ``mesh`` part, the
    compressed exchange on the file's gradients, and the port's plans,
    spec trees and launch costs against its ``plans`` and ``costs``.
    Returns {part: largest gap over its limit}."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs import specs
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.analytic import analytic_cost
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models import steps
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding import make_plan, partition, spec_to_pspec

    mesh_ref = ref["mesh"]
    worst = {}
    check(sorted(k for k in arrays if not k.startswith(("roundtrip/",
                                                        "decode_gathered/")))
          == sorted(k for k in mesh_ref if "/grad/0/" not in k
                    and "/grad/1/" not in k and not k.startswith(
                        ("compressed/0/q8", "compressed/1/q8",
                         "compressed/0/scale", "compressed/1/scale",
                         "compressed/0/err", "compressed/1/err",
                         "tp/", "tp_plain/"))),
          "16a: the ranks' arrays and the file's differ in their names")
    for key, got in sorted(arrays.items()):
        part = key.split("/")[0]
        if part == "roundtrip":
            check(bool(got), f"16a {key}: gather_tree of shard_tree differs")
            continue
        if part == "blocks":
            check(str(got) == mesh_ref[key]["sha256"],
                  f"16a {key}: block differs from addressable_shards")
            continue
        if part == "decode_gathered":
            want = arrays[key.replace("decode_gathered", "decode")]
            rtol, atol = _tolerance(key.replace("decode_gathered", "decode"),
                                    mesh_ref[key.replace("decode_gathered",
                                                         "decode")])
            err = float(np.abs(got - want).max())
            check(err <= atol, f"16a {key}: the gathered decode differs "
                               f"from the sharded by {err:.4g}")
            continue
        rtol, atol = _tolerance(key, mesh_ref[key])
        worst[part] = max(worst.get(part, 0.0),
                          _array_held(key, got, mesh_ref[key], rtol, atol))
    # the exchange: int8 codes bit-equal, scales equal, errors 2 ulp
    n = 0
    for pod, leaves in exch.items():
        for path, (red, new_e, q8, s, allq) in leaves.items():
            want_q = _ref_decode(mesh_ref[f"compressed/1/q8/{pod}/{path}"])
            check(np.array_equal(q8, want_q),
                  f"16a compressed exchange {pod} {path}: int8 codes differ")
            check(np.array_equal(allq, np.stack([_ref_decode(mesh_ref[
                f"compressed/1/q8/{i}/{path}"]) for i in range(2)])),
                f"16a compressed exchange {path}: gathered codes differ")
            want_s = _ref_decode(mesh_ref[f"compressed/1/scale/{pod}/{path}"])
            check(float(s) == float(want_s),
                  f"16a compressed exchange {pod} {path}: scale {s} "
                  f"against {want_s}")
            g = _ref_decode(mesh_ref[f"compressed/1/grad/{pod}/{path}"])
            e0 = _ref_decode(mesh_ref[f"compressed/0/err/{pod}/{path}"])
            ulp = np.spacing(np.float32(np.abs(g + e0).max()))
            err = np.abs(new_e - _ref_decode(
                mesh_ref[f"compressed/1/err/{pod}/{path}"])).max()
            check(err <= 2 * ulp, f"16a compressed exchange {pod} {path}: "
                                  f"error state off by {err}")
            n += 1
    check(n > 0, "16a: no leaf of the compressed exchange was checked")
    # plans, spec trees and costs: bit-equal, on the host

    class Shape:
        def __init__(self, shape):
            self.shape = shape

    def as_json(spec):
        return json.loads(json.dumps([list(e) if isinstance(e, tuple)
                                      else e for e in spec]))

    for arch in ARCHS:
        cfg = get_config(arch)
        for name, want in ref["plans"][arch].items():
            axes = (("pod", "data", "model") if name == "2x16x16"
                    else ("data", "model"))
            shape = (2, 16, 16) if name == "2x16x16" else (16, 16)
            plan = make_plan(cfg, Shape(dict(zip(axes, shape))))
            check(json.loads(json.dumps(plan.rules)) == want["rules"]
                  and list(plan.notes) == want["notes"]
                  and list(plan.batch_axes) == want["batch_axes"]
                  and plan.seq_axis == want["seq_axis"]
                  and plan.cache_seq_axis == want["cache_seq_axis"],
                  f"16a {arch} {name}: plan differs from the file's")
            check({p: as_json(spec_to_pspec(s, plan)) for p, s in
                   tree_leaves(steps.model_param_specs(cfg))}
                  == want["params"], f"16a {arch} {name}: param specs")
            for shape_name in SHAPES:
                inputs = specs.input_specs(cfg, shape_name)
                fn = (partition.decode_input_shardings
                      if specs.step_kind(shape_name) == "decode"
                      else partition.batch_shardings)
                check({p: as_json(s) for p, s in tree_leaves(
                    fn(cfg, plan, inputs))} == want["inputs"][shape_name],
                    f"16a {arch} {name} {shape_name}: input specs")
        for shape_name, rec in ref["costs"][arch].items():
            sh = SHAPES[shape_name]
            check(model_flops(cfg, sh) == rec["model_flops"] and all(
                json.loads(json.dumps(analytic_cost(cfg, sh, int(c))
                                      .to_dict())) == rec[c]
                for c in ("256", "512")),
                f"16a {arch} {shape_name}: analytic cost differs")
    return worst


def sharding_phase(ref, device="cuda", sizes=SHARD_SIZES):
    """Phase 16: ``sharding_rank`` on four gloo ranks sharing the one card
    (spawned by ``distributed.launch_mesh``); 16a's arrays held to
    ``experiments/sharding/reference.json`` here, 16b-d's records checked
    and printed. (``sizes`` and ``device="cpu"`` rehearse it at a small
    size on the host.)"""
    from repro_torch.core.analysis import distributed as D

    t_phase = time.perf_counter()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the ranks have the card to themselves
    mesh_ref = ref["mesh"]
    small = [k[len("compressed/1/grad/0/"):] for k, v in mesh_ref.items()
             if k.startswith("compressed/1/grad/0/") and "b64" in v]
    exchange = ({p: {k: _ref_decode(mesh_ref[f"compressed/1/grad/{p}/{k}"])
                     for k in small} for p in range(2)},
                {p: {k: _ref_decode(mesh_ref[f"compressed/0/err/{p}/{k}"])
                     for k in small} for p in range(2)})
    tp_start = _mc().tp_start_caches(
        {k: _ref_decode(v) for k, v in mesh_ref.items()
         if k.startswith("tp/")})
    t_launch = time.time()
    arrays, exch, ranks = D.launch_mesh(
        sharding_rank, SHARD_RANKS, exchange, sizes, tp_start, device=device,
        timeout_s=SHARD_TIMEOUT_S)
    t_back = time.time()
    wall = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    worst = sharding_reference_check(ref, arrays, exch)
    print(f"[16 sharding] {SHARD_RANKS} gloo ranks on the one card; 16a "
          f"held to experiments/sharding/reference.json in "
          f"{time.perf_counter() - t0:.2f} s (largest gap over its limit: "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items()))
          + f"); blocks bit-equal to addressable_shards, the compressed "
            f"exchange's int8 codes bit-equal on {len(small)} leaves a "
            f"pod, plans, spec trees and costs bit-equal")
    print("  16a parts (rank 0): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in ranks[0]["a_walls"].items()))
    b0 = ranks[0]["b"]
    spec = sizes["train"]
    for note in b0["notes"]:
        print(f"  [plan] {note}")
    for rec in ranks:
        b = rec["b"]
        check(all(np.isfinite(b["loss"])),
              f"16b rank {rec['rank']}: loss {b['loss']}")
        check(b["loss"] == b0["loss"],
              f"16b: rank {rec['rank']}'s loss {b['loss']} differs from "
              f"rank 0's {b0['loss']}")
    print(f"[16 sharding] 16b: {spec['arch']} at full width on (data, "
          f"model) = {spec['mesh']}, global batch {spec['batch']} x "
          f"{spec['seq']}: loss {b0['loss']}; step ms (rank 0) "
          + ", ".join(f"{t:.1f}" for t in b0["ms"]))
    for rec in ranks:
        b = rec["b"]
        print(f"  rank {rec['rank']}: peak {b['peak_gib']:.2f} GiB; "
              f"{b['block_params']} parameters in its blocks; init "
              f"{b['init_s']:.2f} s; step ms "
              + ", ".join(f"{t:.1f}" for t in b["ms"])
              + "; collectives a step (bytes in, wall us) " + "; ".join(
                  ", ".join(f"{k} {v}" for k, v in s.items())
                  for s in b["bytes"]))
    gap, held, total = b0["ep_layer"]
    check(gap <= BF16_TOL, f"16b: the EP layer at full width differs from "
                           f"_moe_local by {gap:.4g} of its largest |out| "
                           f"(limit {BF16_TOL})")
    print(f"  16b EP layer (capacity_factor 8, bf16): {held} of {total} "
          f"tokens above the router margin, largest gap to _moe_local "
          f"{gap:.4g} of max |out| (limit {BF16_TOL})")
    c0 = ranks[0]["c"]
    for rec in ranks:
        c = rec["c"]
        check(c["layer0_gap"] <= BF16_TOL,
              f"16c rank {rec['rank']}: layer 0's sharded decode differs "
              f"from the gathered by {c['layer0_gap']:.4g} of its largest "
              f"|out|")
    serve = sizes["serve"]
    for rec in ranks:
        c = rec["c"]
        check(c["params_bytes"] == c["block_bytes"] < c["whole_bytes"],
              f"16c rank {rec['rank']}: {c['params_bytes']} B of weights, "
              f"its blocks {c['block_bytes']} B")
    print(f"[16 sharding] 16c: {serve['arch']} at full width on "
          f"{serve['mesh']}, each rank on its blocks "
          f"({c0['params']} parameters, {c0['block_bytes']} B of the whole "
          f"{c0['whole_bytes']} B: the MLP and the vocabulary over model, "
          f"the heads whole), cache sequence over "
          f"{c0['cache_seq_axis']} ({c0['slots']} of "
          f"{serve['max_len']} slots a rank, spec {c0['cache_spec']}),"
          f" batch {serve['batch']}: layer 0 within "
          f"{max(r['c']['layer0_gap'] for r in ranks):.3g} of the whole "
          f"layer's gathered decode's max |out|")
    for rec in ranks:
        c = rec["c"]
        print(f"  rank {rec['rank']}: decode step ms "
              + ", ".join(f"{t:.1f}" for t in c["ms"])
              + f"; peak {c['peak_gib']:.2f} GiB (9.23 GiB when every rank "
              f"held the weights whole)")
    d0 = ranks[0]["d"]
    check(all(np.isfinite(d0["loss"])) and abs(
        d0["loss"][-1] - d0["plain_loss"][-1])
        <= COMPRESSED_LOSS_RTOL * abs(d0["plain_loss"][-1]),
        f"16d: compressed loss {d0['loss']} against uncompressed "
        f"{d0['plain_loss']}")
    print(f"[16 sharding] 16d: train_100m.py's configuration on (pod, data, "
          f"model) = {sizes['compressed']['mesh']}, int8 pod-compressed, "
          f"{sizes['compressed']['steps']} steps: loss "
          + ", ".join(f"{x:.4f}" for x in d0["loss"])
          + "; uncompressed " + ", ".join(f"{x:.4f}"
                                          for x in d0["plain_loss"])
          + f"; step ms (rank 0) " + ", ".join(f"{t:.1f}" for t in d0["ms"])
          + f"; peak {d0['peak_gib']:.2f} GiB")
    for rec in ranks:
        print(f"  rank {rec['rank']}: walls " + ", ".join(
            f"{'' if k.startswith('18') else '16'}{k} {v:.2f} s"
            for k, v in rec["walls"].items())
            + "; peaks " + ", ".join(f"16{k} {v:.2f} GiB"
                                     for k, v in rec["peaks"].items()))
    print(f"  spawn to the ranks' first line "
          f"{min(r['t_enter'] for r in ranks) - t_launch:.2f}-"
          f"{max(r['t_enter'] for r in ranks) - t_launch:.2f} s; CUDA "
          f"initialization {max(r['cuda_init_s'] for r in ranks):.2f} s; "
          f"the ranks' last line to the result "
          f"{t_back - max(r['t_exit'] for r in ranks):.2f} s")
    print(f"[16 sharding] {wall:.2f} s for the ranks (spawn included, "
          f"phase 18's parts too); no claim of speed: the four ranks share "
          f"one card and every collective goes through the host (gloo)")
    return ranks


#: 18a / 18b-c: a bf16 prefill cache entry may sit one bf16 rounding from
#: the other program's (a float32 gap of ~1e-7 crossing a rounding)
TP_ATOL = 5e-5
TP_BF16_RTOL = 2.0 ** -7


def _tp_tolerance(key):
    """(rtol, atol) of an 18a array: ``tests/test_torch_sharding_tp.py``'s
    rule (logits and the float32 decode window atol 5e-5; the bf16
    prefill caches plus one bf16 rounding)."""
    return (TP_BF16_RTOL if "/prefill/l" in key else 0.0), TP_ATOL


def tp_serving_phase(ref, ranks, sizes=SHARD_SIZES):
    """Phase 18 from the ranks' records: (a) the ``tp`` cases against
    ``experiments/sharding/reference.json`` and the port's unsharded
    steps, each rank's storage against its blocks; (b) phi3-mini-3.8b and
    (c) yi-34b on their blocks: prefill and decode times, each rank's peak
    beside its blocks' bytes, the collectives' bytes and wall a step,
    layer 0 against rank 0's whole-model oracle."""
    MC = _mc()
    fails = []
    if "18a" in ranks[0]:
        fails += _tp_reference_check(ref, ranks, MC)
    for label, spec in (("18b", sizes["tp_full"]), ("18c", sizes["tp_fsdp"])):
        if label in ranks[0]:
            fails += _tp_serve_report(label, spec, ranks)
    check(not fails, "; ".join(fails))


def _tp_reference_check(ref, ranks, MC) -> list:
    """18a: the ``tp`` cases against the file and the port's unsharded
    steps, each rank's storage against its blocks. Returns the failures."""
    from repro_torch.configs.specs import abstract_params_tree
    from repro_torch.models import transformer as TT
    from repro_torch.models.common import sorted_leaves
    from repro_torch.sharding import (decode_input_shardings, make_plan,
                                      params_only_shardings)

    arrays = ranks[0]["18a"]["arrays"]
    mesh_ref = ref["mesh"]
    keys = sorted(k for k in mesh_ref if k.startswith("tp/"))
    check(keys and keys == sorted(k for k in arrays if k.startswith("tp/")
                                  and "/continued/" not in k),
          "18a: the ranks' tp arrays and the file's differ in their names")
    fails = []
    worst = {}
    mine = sorted(k for k in arrays if k.startswith("tp/"))
    for key in mine:
        rtol, atol = _tp_tolerance(key)
        case = key.split("/")[1]
        wants = [("plain", arrays[key.replace("tp/", "tp_plain/", 1)])]
        if key in mesh_ref:
            wants.append(("jax", _ref_decode(mesh_ref[key])))
        for against, want in wants:
            want = np.asarray(want, np.float64)
            err = np.abs(np.asarray(arrays[key], np.float64) - want)
            over = float((err / (atol + rtol * np.abs(want))).max())
            worst[(case, against)] = max(worst.get((case, against), 0.0),
                                         over)
            if not np.isfinite(arrays[key]).all() or over > 1.0:
                what = ("reference" if against == "jax"
                        else "unsharded port")
                fails.append(f"18a {key} off the {what} by "
                             f"{err.max():.4g}")
    for case in MC.TP_CASES:
        print(f"  18a {case}: largest gap over its limit, against the "
              f"reference {worst[(case, 'jax')]:.3g}, against the "
              f"unsharded port {worst[(case, 'plain')]:.3g}")

    class Shape:
        def __init__(self, shape):
            self.shape = shape

    for case, (_arch, shape, _over) in MC.TP_CASES.items():
        cfg = MC.tp_config(case)
        plan = make_plan(cfg, Shape(dict(zip(("data", "model"), shape))))

        def blocks(tree, specs):
            spec_of = dict(sorted_leaves(specs))
            return sum(math.prod(t.shape) * t.element_size() // math.prod(
                plan.axis_size(e) for e in spec_of[p] if e is not None)
                for p, t in sorted_leaves(tree))

        window = TT.init_decode_caches(cfg, MC.TP["batch"],
                                       MC.TP["max_len"], dtype=torch.float32,
                                       device="meta")
        want = (blocks(abstract_params_tree(cfg),
                       params_only_shardings(cfg, plan)),
                blocks(window, decode_input_shardings(
                    cfg, plan, {"caches": window})["caches"]))
        for c in ("".join(map(str, x)) for x in np.ndindex(*shape)):
            got = (int(arrays[f"tp_bytes/{case}/{c}/params"]),
                   int(arrays[f"tp_bytes/{case}/{c}/caches"]))
            if got != want:
                fails.append(f"18a {case} rank {c}: storage {got} B, its "
                             f"blocks {want} B")
    print(f"[18 tp serving] 18a: {len(MC.TP_CASES)} cases ("
          + ", ".join(MC.TP_CASES) + ") against "
          f"experiments/sharding/reference.json (largest gap over its "
          f"limit {max(v for (c, a), v in worst.items() if a == 'jax'):.3g})"
          f" and the port's unsharded steps ("
          f"{max(v for (c, a), v in worst.items() if a == 'plain'):.3g}); "
          f"every rank's weights and caches against its blocks' bytes; rank 0 "
          + ", ".join(f"{k} {v:.2f} s" for k, v in
                      ranks[0]["18a"]["walls"].items()))
    return fails


def _tp_serve_report(label, spec, ranks) -> list:
    """18b / 18c: each rank's storage against its blocks, layer 0 against
    rank 0's oracle; the times, peaks and collectives printed. Returns the
    failures."""
    fails = []
    cfg = _tp_config(spec)
    r0 = ranks[0][label]
    for rec in ranks:
        r = rec[label]
        if not r["params_bytes"] == r["block_bytes"] < r["whole_bytes"]:
            fails.append(f"{label} rank {rec['rank']}: "
                         f"{r['params_bytes']} B of weights, its blocks "
                         f"{r['block_bytes']} B")
        if r["cache_bytes"] != r["cache_block_bytes"]:
            fails.append(f"{label} rank {rec['rank']}: "
                         f"{r['cache_bytes']} B of caches, its blocks "
                         f"{r['cache_block_bytes']} B")
        if not (r["finite"] and r["shape_ok"]):
            fails.append(f"{label} rank {rec['rank']}: non-finite "
                         f"logits or a wrong shape")
    for k, (err, top) in r0["layer0"].items():
        if err > PREFILL_DECODE_TOL * top:
            fails.append(f"{label}: layer 0's prefill {k} cache off the "
                         f"oracle by {err:.4g} (limit "
                         f"{PREFILL_DECODE_TOL * top:.4g})")
    cut = (f", cut to {cfg.n_layers} of "
           f"{_tp_config(dict(spec, n_layers=0)).n_layers} layers"
           if spec.get("n_layers") else "")
    print(f"[18 tp serving] {label}: {cfg.arch} at full width{cut} on "
          f"(data, model) = {spec['mesh']}: {r0['heads']} q and "
          f"{r0['kv_heads']} kv heads, d_ff {r0['d_ff']}, "
          f"{r0['vocab_rows']} vocabulary rows a rank; batch "
          f"{spec['batch']}, {spec['prompt']}-token prefill into a "
          f"{spec['max_len']}-slot window, {spec['steps']} decode steps")
    print(f"  rank 0: prefill {r0['prefill_ms']:.1f} ms; decode step "
          f"median {statistics.median(r0['ms']):.1f} ms (min "
          f"{min(r0['ms']):.1f}, max {max(r0['ms']):.1f}); the whole "
          f"model on one rank (oracle): prefill "
          f"{r0['oracle_prefill_ms']:.1f} ms, decode median "
          f"{statistics.median(r0['oracle_ms']):.1f} ms")
    print(f"  layer 0's prefill k, v against the oracle: " + ", ".join(
        f"{k} {e:.4g} of max {t:.4g}" for k, (e, t) in
        r0["layer0"].items()) + f" (held within 2^-7); prefill logits "
        f"{r0['prefill_logits_gap']:.4g} apart (max |logit| "
        f"{r0['logits_max']:.4g}); decode logits apart by step: "
        + " ".join(f"{g:.3g}" for g in r0["step_gaps"][:8])
        + f" ...; top-1 agreement by step: "
        + " ".join(f"{a:.2f}" for a in r0["top1"][:8])
        + " ... (printed, not held: chaotic full-width weights)")
    for rec in ranks:
        r = rec[label]
        per = {}
        for step in r["bytes"]:
            for k, v in step.items():
                per[k] = per.get(k, 0) + v / len(r["bytes"])
        print(f"  rank {rec['rank']}: peak {r['peak_gib']:.2f} GiB "
              f"beside its blocks' {r['block_bytes'] / 2**30:.3f} GiB "
              f"(the whole model {r['whole_bytes'] / 2**30:.3f} GiB) "
              f"and caches {r['cache_bytes'] / 2**20:.1f} MiB; init "
              f"{r['init_s']:.2f} s (peak {r['init_peak_gib']:.2f} GiB "
              f"drawing a leaf at a time); decode median "
              f"{statistics.median(r['ms']):.1f} ms; a step: "
              + ", ".join(f"{k} {v:.0f}" for k, v in per.items() if v)
              + "; prefill: " + ", ".join(
                  f"{k} {v}" for k, v in r["prefill_bytes"].items()
                  if v))
    if "oracle_peak_gib" in r0:
        print(f"  rank 0's oracle: {r0['oracle_peak_gib']:.2f} GiB")
    return fails


# -- phase 17: the dry run and the autotuner ---------------------------------------

#: 17a: a dry run's predicted step peak (arguments + temp) within these
#: factors of the peak phase 16 measured for the step alone
DRYRUN_PEAK = (0.8, 1.25)
#: 17a/17b's child process: its wall limit
DRYRUN_TIMEOUT_S = 600
#: 17b: production cells held to experiments/dryrun/reference.json (the
#: grid's gemma-2b train and decode on 16x16, hill-climb's podfsdp)
DRYRUN_PRODUCTION = (("gemma-2b", "train_4k", False, None, ""),
                     ("gemma-2b", "decode_32k", False, None, ""),
                     ("phi3-mini-3.8b", "train_4k", True,
                      {"fsdp": "pod_data"}, "+podfsdp"))
#: 17c: the autotuner's cells (op, size, batch): the MWU's min-plus and
#: the count product at p = 512, the sweep's squarings at B=12, 2048
TUNE_CELLS = (("minplus", 512, 0), ("minplus_count", 512, 0),
              ("batched_minplus", 2048, 12))
_KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all",
          "ppermute")


def dryrun_cells(sizes) -> dict:
    """17a and 17b in this process (a child with no card): phase 16's three
    cells and 18b's decode dry-run on meta in fake groups of their meshes'
    ranks, then the
    production cells through ``launch.dryrun.run_cell``. Returns
    {"a": {"b"|"c"|"d": trace summary}, "b": {key: record}}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    def cfg_of(spec, **over):
        cfg = get_config(spec["arch"])
        cfg = cfg.reduced() if spec.get("reduced") else cfg
        return dataclasses.replace(cfg, **over)

    train, serve = sizes["train"], sizes["serve"]
    run = sizes["run"]
    cells = {
        "b": (cfg_of(train), ShapeSpec("16b", train["seq"], train["batch"],
                                       "train"),
              train["mesh"], ("data", "model")),
        "c": (cfg_of(serve, decode_attention="sharded"),
              ShapeSpec("16c", serve["max_len"], serve["batch"], "decode"),
              serve["mesh"], ("data", "model")),
        "d": (dataclasses.replace(_phi3(sizes["overrides"]),
                                  grad_compression="int8_pod"),
              ShapeSpec("16d", run["seq"], run["batch"], "train"),
              sizes["compressed"]["mesh"], ("pod", "data", "model")),
    }
    full = sizes["tp_full"]
    cells["18b"] = (_tp_config(full), ShapeSpec(
        "18b", full["max_len"], full["batch"], "decode"), full["mesh"],
        ("data", "model"))
    out = {"a": {}, "b": {}}
    for label, (cfg, shape, mesh, axes) in cells.items():
        t0 = time.perf_counter()
        tr = dryrun.dry_run(cfg, shape, mesh, axes)
        out["a"][label] = {"collective_bytes": tr["collective_bytes"],
                           "memory": tr["memory"],
                           "n_collectives": len(tr["ops"]),
                           "port_notes": tr["port_notes"],
                           "trace_s": time.perf_counter() - t0}
    for arch, shape, multi, overrides, tag in DRYRUN_PRODUCTION:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi, save=False,
                              overrides=overrides, tag=tag)
        rec.pop("collectives", None)
        rec["wall_s"] = time.perf_counter() - t0
        out["b"][f"{arch}__{shape}__{rec['mesh']}{tag}"] = rec
    return out


def _dryrun_child(sizes):
    """``dryrun_cells`` in a child process that sees no card."""
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    with tempfile.TemporaryDirectory() as tmp:
        spec, out = pathlib.Path(tmp) / "sizes.json", pathlib.Path(tmp) / "out.json"
        spec.write_text(json.dumps(sizes))
        res = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-child",
             str(spec), str(out)], env=env, capture_output=True, text=True,
            timeout=DRYRUN_TIMEOUT_S)
        check(res.returncode == 0, f"17: the dry-run child failed:\n"
                                   f"{res.stdout[-3000:]}{res.stderr[-6000:]}")
        return json.loads(out.read_text())


def dryrun_phase(ranks, device="cuda", sizes=SHARD_SIZES):
    """Phase 17a-b: the dry run of phase 16's three cells against what
    phase 16 measured on rank 0 (each collective kind's bytes a step equal
    exactly, the argument bytes equal to the step's resident state and
    batch, the predicted peak within DRYRUN_PEAK of the step's own), then
    the production cells against experiments/dryrun/reference.json."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    got = _dryrun_child(sizes)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    names = {"b": "16b granite-moe-1b-a400m train (2, 2)",
             "c": "16c gemma-2b seq-sharded decode (1, 4)",
             "d": "16d compressed 110M step (2, 1, 1)",
             "18b": "18b phi3-mini-3.8b decode on its blocks (1, 4)"}
    for label, name in names.items():
        pred, meas = got["a"][label], r0[label]
        mem = pred["memory"]
        for i, step in enumerate(meas["bytes"]):
            seen = {k: step[f"{k} bytes"] for k in _KINDS}
            check(seen == pred["collective_bytes"],
                  f"17a {name} step {i}: measured collective bytes {seen}, "
                  f"the dry run predicts {pred['collective_bytes']}")
        check(mem["argument_bytes"] == meas["resident"],
              f"17a {name}: the dry run's argument bytes "
              f"{mem['argument_bytes']} != the step's resident "
              f"{meas['resident']}")
        predicted = mem["argument_bytes"] + mem["temp_bytes"]
        ratios = []
        for start, growth in meas["step_mem"]:
            if device == "cuda":
                alone = meas["resident"] + growth
                ratios.append(predicted / alone)
                check(DRYRUN_PEAK[0] <= ratios[-1] <= DRYRUN_PEAK[1],
                      f"17a {name}: predicted peak {predicted} B against "
                      f"the step's {alone} B (ratio {ratios[-1]:.3f})")
        print(f"[17 dryrun] 17a {name}: collectives a step (bytes) "
              + ", ".join(f"{k} {v}" for k, v in
                          pred["collective_bytes"].items() if v)
              + f" = phase 16's on every step ({len(meas['bytes'])}); "
              f"argument bytes {mem['argument_bytes']} = resident; "
              f"predicted peak {predicted / 2**30:.3f} GiB (temp "
              f"{mem['temp_bytes'] / 2**30:.3f}) against the step's "
              + (", ".join(f"{(meas['resident'] + g) / 2**30:.3f}"
                           for _, g in meas["step_mem"])
                 + " GiB: ratio " + ", ".join(f"{x:.3f}" for x in ratios)
                 if device == "cuda" else "not measured (host rehearsal)")
              + f"; {pred['n_collectives']} collectives; traced in "
              f"{pred['trace_s']:.2f} s; allocated at the step's start "
              + ", ".join(str(st) for st, _ in meas["step_mem"]))
        for note in pred["port_notes"]:
            print(f"  [port] {note}")
    ref = json.loads((ROOT / "experiments" / "dryrun"
                      / "reference.json").read_text())["cells"]
    for key, rec in got["b"].items():
        bad = dryrun.compare_to_reference(rec, ref[key])
        check(not bad, f"17b {key}: {bad}")
        mem, xla = rec["memory"], ref[key]["memory"]
        r = rec["roofline"]
        print(f"[17 dryrun] 17b {key}: plan notes, analytic roofline and "
              f"the JAX argument bytes ({mem['jax_argument_bytes']}) equal "
              f"the reference's; traced in {rec['trace_s']:.1f} s; port "
              f"argument {mem['argument_bytes']} B, temp "
              f"{mem['temp_bytes']} B (XLA's {xla['temp_bytes']}), "
              f"{r['n_collectives']} collectives (XLA's "
              f"{ref[key]['roofline']['n_collectives']}), wire "
              f"{r['collective_wire_bytes']:.6g} B (XLA's "
              f"{ref[key]['roofline']['collective_wire_bytes']:.6g}), in "
              + ", ".join(f"{k} {v}" for k, v in
                          rec["collective_bytes"].items() if v)
              + f"; traced flops {r['traced_flops']:.4g}")
    print(f"[17 dryrun] 17a-b in a child process with no card: "
          f"{wall:.2f} s")


def autotune_phase(S, ops):
    """Phase 17c: the autotuner on the card into a temporary table: every
    candidate's median time beside the default pick's, every candidate
    bit-equal to the default (autotune raises otherwise), and a following
    op call on the winner's column of ``tile_launches()``."""
    import tempfile

    from repro_torch.kernels import autotune as AT

    old = os.environ.get("REPRO_TORCH_TUNE_TABLE")
    t_ph = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        table = pathlib.Path(tmp) / "tuning_table.json"
        os.environ["REPRO_TORCH_TUNE_TABLE"] = str(table)
        AT.load_table(refresh=True)
        try:
            for op, size, batch in TUNE_CELLS:
                t0 = time.perf_counter()
                res = AT.autotune(op, size, batch=batch)
                wall = time.perf_counter() - t0
                wrapper, column = res["column"]
                gen = torch.Generator(device="cuda").manual_seed(3)
                shape = (batch, size, size) if batch else (size, size)
                x = torch.randint(0, 5, shape, generator=gen,
                                  device="cuda").float()
                before = S.tile_launches()[wrapper][column]
                if op == "minplus":
                    ops.minplus_matmul(x, x)
                elif op == "batched_minplus":
                    ops.batched_minplus_matmul(x, x)
                else:
                    ops.minplus_count_matmul(x, x + 1, x, x + 1)
                after = S.tile_launches()[wrapper][column]
                check(after == before + 1,
                      f"17c {op}: the call after tuning did not run on the "
                      f"winner's {column} ({before} -> {after})")
                saved = json.loads(table.read_text())[op][res["key"]]
                print(f"[17 autotune] 17c {op} at {res['key']} (batch "
                      f"{batch or 1}): default {res['default']} "
                      f"{res['default_ms']:.4f} ms; winner "
                      f"{saved} {1e3 * res['seconds']:.4f} ms; candidates "
                      + ", ".join(f"{k} {v:.4f}" for k, v in
                                  res["times"].items())
                      + f" ms (median of 7 after a warm-up, CUDA events); "
                      f"all bit-equal to the default; not launchable here: "
                      f"{res['skipped'] or 'none'}; the next call ran on "
                      f"{wrapper}'s {column}; {wall:.2f} s")
        finally:
            if old is None:
                os.environ.pop("REPRO_TORCH_TUNE_TABLE", None)
            else:
                os.environ["REPRO_TORCH_TUNE_TABLE"] = old
            AT.load_table(refresh=True)
    print(f"[17 autotune] {time.perf_counter() - t_ph:.2f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import obs
    from repro_torch.core import resilience as RES
    from repro_torch.core import routing as R
    from repro_torch.core import sweep as SW
    from repro_torch.core import topology as T
    from repro_torch.core import traffic as TR
    from repro_torch.core import workload as W
    from repro_torch.core.routing import assign as A
    from repro_torch.core.analysis import AnalysisEngine, paths
    from repro_torch.core.analysis import distributed as D
    from repro_torch.core.analysis import wavefront as WF
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import seghist as H
    from repro_torch.kernels import semiring as S

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip()
    name = torch.cuda.get_device_name(0)
    part = part_of(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the LM phases' bf16 GEMMs accumulate in float32, as XLA's do (the
    # default lets cuBLAS reduce them in bf16; the LM steps refuse it)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"[1 device] {smi}")
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name} ({part} peaks used for bounds); "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    phase_walls = {}

    def wall(label, since):
        phase_walls[label] = time.perf_counter() - since
        print(f"[wall] phase {label}: {phase_walls[label]:.2f} s")

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[2 build] {len(built)} libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for res in built.values():
        print(f"  {res.path.name}: nvcc {res.seconds:.2f} s")
        for line in res.log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"    {line.strip()}")

    print(f"  counting tiles' dynamic shared memory per block: "
          f"{S._counting_smem_bytes()}; packed GEMM's: "
          f"{S._packed_smem_bytes()} B; large min-plus tile's: "
          f"{S._minplus_smem_bytes()} B")

    wall("2", t0)

    # 3. kernel vs plain
    t_ph = time.perf_counter()
    print("[3 kernels] kernel vs plain version on the card")
    kstats = kernel_checks(S, part)
    kstats.update(tropical_checks(S, H, part))
    kstats.update(packed_checks(S, part))
    kstats.update(library_kernel_checks(S, part))
    print("kernels: " + " ".join(f"{k}=pass" for k in kstats))
    wall("3", t_ph)

    # 4. the committed configuration
    t0 = time.perf_counter()
    small = SW.sweep(ref=("slimfly", 2000), max_routers=200, device="cuda")
    check_committed(small, ROOT / "experiments" / "sweep" / "comparison.json")
    print(f"[4 committed] 12-family table matches comparison.json "
          f"({time.perf_counter() - t0:.2f} s)")
    wall("4", t0)

    # 5. full width: the main path, counted
    t_ph = time.perf_counter()
    obs.enable()
    obs.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    S.reset_launches()
    t0 = time.perf_counter()
    full = SW.sweep(ref=("slimfly", 10000), max_routers=2048, device="cuda")
    wall_k = time.perf_counter() - t0
    counts = dict(S.launches)
    tiles = S.tile_launches()  # read after the timed window
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    spans = obs.span_summary()
    obs.disable()
    diam = max(r["diameter"] for r in full["rows"])
    print(SW.format_table(full))
    print(f"[5 full width] kernel sweep {wall_k:.3f} s; launches {counts}; "
          f"max diameter {diam}; peak device memory {peak_mb:.1f} MiB")
    for span, row in sorted(spans.items()):
        print(f"  span {span}: {row['total_ms']:.3f} ms x{row['count']}")
    print("  BFS levels per family: " + ", ".join(
        f"{r['family']} {r['wavefront_levels']}" for r in full["rows"]))
    check(counts["frontier_step"] == diam + 1,
          f"frontier launches {counts['frontier_step']} != diameter+1 {diam + 1}")
    check(counts["count_matmul"] == 2 * diam,
          f"counting launches {counts['count_matmul']} != 2*diameter {2 * diam}")
    print(f"  counting tiles: {tiles}")
    # every frontier step and every Z x A is against the {0,1} adjacency
    # (tensor-core tile); every F_a^T x Z has a float right operand (SIMT)
    want = {"frontier_step": {"simt": 0, "tensor": diam + 1},
            "count_matmul": {"simt": diam, "tensor": diam},
            "reachability_step": {"simt": 0, "tensor": 0},
            "semiring_matmul": {"simt": 0, "tensor": 0}}
    check({k: tiles[k] for k in want} == want,
          f"counting tiles {tiles}, expected {want}")
    for op in ("minplus_matmul", "batched_minplus_matmul"):
        check(sum(tiles[op].values()) == counts[op],
              f"{op}: tile counters {tiles[op]} against {counts[op]} "
              f"launches")
    for r in full["rows"]:
        check(r["routers"] <= 2048 and np.isfinite(r["tput_lb"])
              and 0 < r["tput_lb"] <= 1, f"bad row {r}")

    obs.enable()
    obs.reset()
    t0 = time.perf_counter()
    plain = SW.sweep(ref=("slimfly", 10000), max_routers=2048, device="cuda",
                     use_kernel=False)
    wall_p = time.perf_counter() - t0
    spans = obs.span_summary()
    obs.disable()
    print(f"[5 full width] plain sweep {wall_p:.3f} s")
    for span, row in sorted(spans.items()):
        print(f"  span {span}: {row['total_ms']:.3f} ms x{row['count']}")
    rows_p = {r["family"]: r for r in plain["rows"]}
    for r in full["rows"]:
        p = rows_p[r["family"]]
        for col in _EXACT_COLS + ("avg_spl",):
            check(r[col] == p[col], f"{r['family']}.{col} kernel != plain")
        check(_close(r["mult_mean"], p["mult_mean"], 1e-5),
              f"{r['family']}.mult_mean kernel vs plain")
        check(_close(r["tput_lb"], p["tput_lb"], 1e-5),
              f"{r['family']}.tput_lb kernel vs plain")
    graphs, _ = SW.equal_cost_graphs(ref=("slimfly", 10000), max_routers=2048)
    compare_chains(WF, S, SW._stack_adjacency(graphs))
    # the host spans (build, download, rows) vary between runs by more than
    # the kernels save, so the pair runs again in the other order: kernel,
    # plain, plain, kernel in all (these two untraced)
    walls = {}
    for label, use_kernel in (("plain", False), ("kernel", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        SW.sweep(ref=("slimfly", 10000), max_routers=2048, device="cuda",
                 use_kernel=use_kernel)
        walls[label] = time.perf_counter() - t0
    mean_k = (wall_k + walls["kernel"]) / 2
    mean_p = (wall_p + walls["plain"]) / 2
    print(f"[5 full width] again, untraced: plain sweep {walls['plain']:.3f} "
          f"s, kernel sweep {walls['kernel']:.3f} s; kernel mean {mean_k:.3f} "
          f"s against plain mean {mean_p:.3f} s "
          f"({100 * (mean_k - mean_p) / mean_p:+.1f}%)")

    sweep_counts = counts
    wall("5", t_ph)

    # 6. the analysis path at full width, counted
    t_ph = time.perf_counter()
    ref = json.loads((ROOT / "experiments" / "analysis"
                      / "reference.json").read_text())
    analysis_counts, reports = analysis_phase(obs, S, T, AnalysisEngine,
                                              paths, ref)
    plain_chain(T, AnalysisEngine, reports, ref)
    wall("6", t_ph)

    # 7. the extreme-scale path, counted
    t_ph = time.perf_counter()
    xref = json.loads((ROOT / "experiments" / "extreme"
                       / "reference.json").read_text())
    extreme_counts, dragonfly_row, dragonfly = extreme_phase(
        obs, S, SW, D, WF, xref, SW._stack_adjacency(graphs))
    wall("7", t_ph)

    # 8. the kernel library and the stacked squaring APSP, counted
    t_ph = time.perf_counter()
    library_counts = library_phase(S, ops, SW, WF, graphs)
    wall("8", t_ph)

    # 9. the semiring extension point, counted
    t_ph = time.perf_counter()
    seed = torch.from_numpy(squaring_seed(SW, WF, graphs)[0]).cuda()
    semiring_stats, semiring_launches = semiring_phase(S, build, seed, part)
    del seed
    wall("9", t_ph)

    # 10. the routing path, counted
    t_ph = time.perf_counter()
    rref = json.loads((ROOT / "experiments" / "routing"
                       / "reference.json").read_text())
    stack = SW._stack_adjacency(graphs)
    routing_counts = routing_phase(
        S, T, R, W, A, WF, TR, AnalysisEngine, rref,
        WF.pad_operand(stack, WF.pad_block(stack.shape[-1]), 0.0))
    del stack
    wall("10", t_ph)

    # 11. the resilience and traffic path, counted
    t_ph = time.perf_counter()
    resilience_counts = resilience_phase(obs, S, SW, T, RES, TR, part)
    wall("11", t_ph)

    # 12. the mesh: two ranks on the one card, counted in each rank
    t_ph = time.perf_counter()
    mesh_counts = mesh_phase(D, full, dragonfly_row, dragonfly)
    wall("12", t_ph)

    # 13. the serving path: the reference configs, then gemma-2b at full width
    check(not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "bf16 GEMMs would reduce in bf16")
    from repro_torch.configs import get_config
    before = dict(S.launches)
    t0 = time.perf_counter()
    sref = json.loads((ROOT / "experiments" / "serve"
                       / "reference.json").read_text())
    print("[13 serve] 13a: the port against experiments/serve/reference.json")
    serve_reference_phase(sref)
    t_a = time.perf_counter() - t0
    print(f"[13 serve] 13b: gemma-2b at full width ({smi})")
    serve_full_width_phase(get_config("gemma-2b"), part)
    check(dict(S.launches) == before,
          f"the serving path launched a kernel: {dict(S.launches)} against "
          f"{before}")
    print(f"[13 serve] {time.perf_counter() - t0:.2f} s (13a {t_a:.2f} s); "
          f"none of the 11 kernels launched")
    wall("13", t0)

    # 14. the training path: the reference configs, train_100m.py's
    # configuration, gemma-2b at full width, the GEMM guard
    before = dict(S.launches)
    t0 = time.perf_counter()
    tref = json.loads((ROOT / "experiments" / "train"
                       / "reference.json").read_text())
    print("[14 train] 14a: the port against experiments/train/reference.json")
    train_reference_phase(tref)
    wall("14a", t0)
    t1 = time.perf_counter()
    print(f"[14 train] 14b: train_100m.py's configuration ({smi})")
    train_100m_phase(part)
    wall("14b", t1)
    t1 = time.perf_counter()
    print(f"[14 train] 14c: gemma-2b at full width ({smi})")
    train_full_width_phase(get_config("gemma-2b"), part)
    wall("14c", t1)
    print("[14 train] 14d: the exact-GEMM guard")
    guard_phase(sref)
    check(not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "14d left bf16 reduction on")
    check(dict(S.launches) == before,
          f"the training path launched a kernel: {dict(S.launches)} against "
          f"{before}")
    print(f"[14 train] {time.perf_counter() - t0:.2f} s; none of the 11 "
          f"kernels launched")
    wall("14", t0)

    # 15. the other layer kinds: the reference configs, four configs at full
    # width serving and training, the GEMM guard
    before = dict(S.launches)
    t0 = time.perf_counter()
    lref = json.loads((ROOT / "experiments" / "layers"
                       / "reference.json").read_text())
    print("[15 layers] 15a: the port against experiments/layers/reference.json")
    layers_reference_phase(lref)
    wall("15a", t0)
    t1 = time.perf_counter()
    print(f"[15 layers] 15b: serving at full width ({smi})")
    for arch in LAYERS_FULL:
        layers_serve_full_width(get_config(arch), part)
    wall("15b", t1)
    t1 = time.perf_counter()
    print(f"[15 layers] 15c: training at full width ({smi})")
    for arch in LAYERS_FULL:
        layers_train_full_width(get_config(arch), part)
    wall("15c", t1)
    print("[15 layers] 15d: the exact-GEMM guard")
    layers_guard_phase(lref)
    check(not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "15d left bf16 reduction on")
    check(dict(S.launches) == before,
          f"the layer kinds launched a kernel: {dict(S.launches)} against "
          f"{before}")
    print(f"[15 layers] {time.perf_counter() - t0:.2f} s; none of the 11 "
          f"kernels launched")
    wall("15", t0)

    # 16. sharding: four gloo ranks on the one card (16a the reference,
    # 16b granite's sharded training, 16c gemma's seq-sharded decode on
    # its blocks, 16d the compressed step; phase 18's parts after them)
    before = dict(S.launches)
    t0 = time.perf_counter()
    shref = json.loads((ROOT / "experiments" / "sharding"
                        / "reference.json").read_text())
    print(f"[16 sharding] four gloo ranks sharing the card ({smi})")
    shard_ranks = sharding_phase(shref)
    check(dict(S.launches) == before,
          f"the sharding phase launched a kernel: {dict(S.launches)} "
          f"against {before}")
    print(f"[16 sharding] {time.perf_counter() - t0:.2f} s; none of the 11 "
          f"kernels launched")
    wall("16", t0)

    # 18. serving on the rank's blocks (the same ranks: 18a the tp cases
    # against the reference, 18b phi3-mini-3.8b on (1, 4), 18c yi-34b cut
    # to 8 layers on (2, 2))
    t0 = time.perf_counter()
    print(f"[18 tp serving] the ranks of phase 16 ({smi}); their walls: "
          + ", ".join(f"{k} {max(r['walls'][k] for r in shard_ranks):.2f} s"
                      for k in ("18a", "18b", "18c")))
    tp_serving_phase(shref, shard_ranks)
    print(f"[18 tp serving] {time.perf_counter() - t0:.2f} s to check; none "
          f"of the 11 kernels launched")
    phase_walls["18 (ranks)"] = sum(
        max(r["walls"][k] for r in shard_ranks) for k in ("18a", "18b",
                                                          "18c"))

    # 17. the dry run (phase 16's cells on meta, production cells against
    # experiments/dryrun/reference.json) and the autotuner on the card
    t0 = time.perf_counter()
    print(f"[17 dryrun] one rank's step on meta in a fake process group; "
          f"17c tunes on the card ({smi})")
    dryrun_phase(shard_ranks)
    autotune_phase(S, ops)
    wall("17", t0)
    print("[wall] " + ", ".join(f"{k} {v:.1f}" for k, v in
                                phase_walls.items()))

    csrc = "src/repro_torch/kernels/csrc/"
    sources = {  # name -> (CUDA source, the TPU kernel it replaces)
        "frontier_step": ("semiring.cu", "src/repro/kernels/semiring.py:343"),
        "count_matmul": ("semiring.cu", "src/repro/kernels/semiring.py:486"),
        "minplus_matmul": ("tropical.cu", "src/repro/kernels/minplus.py:18"),
        "minplus_count_matmul": ("tropical.cu",
                                 "src/repro/kernels/semiring.py:566"),
        "value_histogram": ("seghist.cu", "src/repro/kernels/seghist.py:39"),
        "frontier_step_packed": ("packed.cu",
                                 "src/repro/kernels/semiring.py:370"),
        "frontier_step_packed_batched": ("packed.cu",
                                         "src/repro/kernels/semiring.py:406"),
        "count_matmul_narrow": ("packed.cu",
                                "src/repro/kernels/semiring.py:437"),
        "reachability_step": ("semiring.cu",
                              "src/repro/kernels/reachability.py:17"),
        "batched_minplus_matmul": ("tropical.cu",
                                   "src/repro/kernels/semiring.py:486"),
    }
    kernels = []
    for kname, st in kstats.items():
        launches = (sweep_counts[kname] + analysis_counts[kname]
                    + extreme_counts[kname] + library_counts[kname]
                    + routing_counts[kname] + resilience_counts[kname]
                    + mesh_counts[kname])
        print(f"  {kname}: {sweep_counts[kname]} launches in the sweep, "
              f"{analysis_counts[kname]} in the analysis path, "
              f"{extreme_counts[kname]} in the extreme path, "
              f"{library_counts[kname]} in the kernel library phase, "
              f"{routing_counts[kname]} in the routing path, "
              f"{resilience_counts[kname]} in the resilience path, "
              f"{mesh_counts[kname]} in the mesh phase (both ranks)")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": csrc + sources[kname][0],
            "replaces": sources[kname][1], "launches": launches,
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": st["library_ms"],
            "tile": st.get("tile")})
        if "tensor_route" in st:
            kernels[-1]["tensor_route"] = {
                k: st["tensor_route"][k] for k in
                ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "max_abs_err")}
    # the generic kernel: launches in phase 9, times of the 2D max-plus
    st = semiring_stats
    check(resilience_counts["semiring_matmul"] == 0
          and mesh_counts["semiring_matmul"] == 0,
          "the resilience or mesh path launched the generic kernel")
    print(f"  semiring_matmul: {semiring_launches} launches in the semiring "
          f"extension point phase")
    kernels.append({
        "name": "semiring_matmul", "route": "cuda",
        "source": csrc + "semiring_generic.cuh",
        "replaces": "src/repro/kernels/semiring.py:437",
        "launches": semiring_launches, "max_abs_err": st["max_abs_err"],
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": st["library_ms"], "tile": None})
    check(len(kernels) == len(sources) + 1 == 11,
          f"{len(kernels)} kernels measured, {len(sources)} named")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-child"]:
        sys.path.insert(0, str(ROOT / "src"))
        sizes = json.loads(pathlib.Path(sys.argv[2]).read_text())
        pathlib.Path(sys.argv[3]).write_text(json.dumps(dryrun_cells(sizes)))
        sys.exit(0)
    sys.exit(main())

"""Three-term roofline from a compiled dry-run artifact.

A verbatim copy of the JAX package's ``launch/roofline.py`` (numpy and
regular expressions over HLO text), on the port's ``core.collectives``;
held bit-equal to it by ``tests/test_torch_sharding.py``. Its constants
are the TPU ``HardwareModel``'s (v5e peak FLOP/s, HBM and ICI/DCN rates),
not the H100's: a report from it describes the TPU mesh.

  compute term    = HLO_FLOPs / (chips x peak_FLOP/s)
  memory term     = HLO_bytes / (chips x HBM_bw)
  collective term = wire_bytes / bandwidth, two ways:
      (flat)      total collective bytes / (chips x ici_link_bw)  [spec formula]
      (topology)  per-op, over the EvalNet axis model (ICI ring vs DCN) —
                  this is where the paper's toolchain feeds the analysis.

Collectives are parsed out of ``compiled.as_text()``: every all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute with its
result shape and replica-group iota, which is decoded against the mesh to
attribute the op to mesh axes (model/data/pod).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.collectives import AxisLink, HardwareModel

__all__ = [
    "CollectiveOp", "parse_collectives", "roofline_report", "model_flops",
]

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\S+))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(",
)
_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|f8e4m3fn|f8e5m2|s64|u64|s32|u32|s16|u16|s8|u8|pred)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([0-9,]+)\](?:T\(([0-9,]+)\))?"
)
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_PAIRS_RE = re.compile(r"source_target_pairs=\{\{(\d+),(\d+)\}")


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int        # per-device result bytes (sum over tuple)
    group_size: int
    axes: Tuple[str, ...]    # mesh axes the group spans ("?" if unknown)
    wire_bytes: float        # modeled per-device wire traffic

    def to_dict(self):
        return dataclasses.asdict(self) | {"axes": list(self.axes)}


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _wire_factor(kind: str, n: int) -> float:
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * frac
    if kind in ("all-gather", "all-to-all"):
        return frac
    if kind == "reduce-scatter":
        return float(n - 1)  # operand = n x result
    if kind == "collective-permute":
        return 1.0
    raise ValueError(kind)


def _decode_iota_groups(m: re.Match, mesh_shape: Dict[str, int]) -> Tuple[int, Tuple[str, ...]]:
    """Decode `[G,S]<=[dims](T(perm))` replica groups; return (group_size, axes)."""
    n_groups, group_size = int(m.group(1)), int(m.group(2))
    reshape_dims = [int(x) for x in m.group(3).split(",")]
    perm = [int(x) for x in m.group(4).split(",")] if m.group(4) else None
    n_dev = int(np.prod(reshape_dims))
    iota = np.arange(n_dev).reshape(reshape_dims)
    if perm is not None:
        iota = iota.transpose(perm)
    groups = iota.reshape(n_groups, group_size)
    member = groups[0]
    # exact attribution: unravel member ids into mesh coordinates (row-major,
    # last axis fastest — jax device order for make_mesh) and report every
    # axis along which the group members vary.
    names = list(mesh_shape)
    sizes = tuple(mesh_shape[n] for n in names)
    coords = np.stack(np.unravel_index(member, sizes), axis=1)  # (S, n_axes)
    axes = tuple(
        names[i] for i in range(len(names))
        if len(np.unique(coords[:, i])) > 1
    )
    return group_size, (axes or ("?",))


def parse_collectives(hlo_text: str, mesh_shape: Dict[str, int]) -> List[CollectiveOp]:
    ops: List[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        kind = m.group(3)
        shape_txt = m.group(1) if m.group(1) is not None else m.group(2)
        rbytes = _shape_bytes(shape_txt)
        gm = _GROUPS_RE.search(line)
        if gm:
            gsize, axes = _decode_iota_groups(gm, mesh_shape)
        else:
            gl = _GROUPS_LIST_RE.search(line)
            if gl:
                gsize = len([x for x in gl.group(1).split(",") if x.strip() != ""])
                axes = ("?",)
            elif kind == "collective-permute":
                gsize, axes = 2, ("?",)
            else:
                gsize, axes = int(np.prod(list(mesh_shape.values()))), ("?",)
        wire = _wire_factor(kind, gsize) * rbytes
        ops.append(CollectiveOp(kind, rbytes, gsize, axes, wire))
    return ops


def _axis_links(mesh_shape: Dict[str, int], hw: HardwareModel) -> Dict[str, AxisLink]:
    return {
        name: AxisLink(name, size, "dcn" if name == "pod" else "ici_ring")
        for name, size in mesh_shape.items()
    }


def collective_seconds(ops: Sequence[CollectiveOp], mesh_shape: Dict[str, int],
                       hw: Optional[HardwareModel] = None) -> Tuple[float, float, Dict]:
    """Returns (flat_seconds, topology_seconds, per-axis breakdown)."""
    hw = hw or HardwareModel()
    links = _axis_links(mesh_shape, hw)
    flat_bytes = sum(op.wire_bytes for op in ops)
    flat_s = flat_bytes / hw.ici_link_bw
    topo_s = 0.0
    by_axis: Dict[str, float] = {}
    for op in ops:
        # pick the slowest axis the group spans (serialized worst case link)
        bw = None
        for a in op.axes:
            link = links.get(a)
            b = link.bandwidth(hw) if link else 2 * hw.ici_link_bw
            bw = b if bw is None else min(bw, b)
        if bw is None:
            bw = 2 * hw.ici_link_bw
        t = op.wire_bytes / bw
        lat_ax = op.axes[0] if op.axes and op.axes[0] in links else None
        lat = links[lat_ax].latency(hw) if lat_ax else hw.ici_latency
        t += (op.group_size - 1) * lat
        topo_s += t
        key = "+".join(op.axes)
        by_axis[key] = by_axis.get(key, 0.0) + t
    return flat_s, topo_s, by_axis


def model_flops(cfg, shape, n_active: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (prefill) / decode per-token."""
    n = n_active if n_active is not None else cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    # decode: one token per sequence + attention over the cache
    per_tok = 2.0 * n * shape.global_batch
    attn_layers = sum(1 for m, _ in cfg.layer_kinds() if m == "attn")
    if cfg.is_encdec:
        attn_layers = cfg.n_layers  # self-attn; cross adds enc_seq reads
    kv_read = (4.0 * shape.global_batch * shape.seq_len * cfg.n_kv_heads *
               (cfg.head_dim or 0) * attn_layers)
    return per_tok + kv_read


def roofline_report(flops: float, hlo_bytes: float,
                    ops: Sequence[CollectiveOp], mesh_shape: Dict[str, int],
                    mflops: float, hw: Optional[HardwareModel] = None) -> Dict:
    hw = hw or HardwareModel()
    chips = int(np.prod(list(mesh_shape.values())))
    compute_s = flops / chips / hw.peak_flops
    memory_s = hlo_bytes / chips / hw.hbm_bw
    flat_s, topo_s, by_axis = collective_seconds(ops, mesh_shape, hw)
    terms = {"compute": compute_s, "memory": memory_s, "collective": flat_s}
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    return {
        "chips": chips,
        "hlo_flops": flops,
        "hlo_bytes": hlo_bytes,
        "collective_wire_bytes": sum(op.wire_bytes for op in ops),
        "n_collectives": len(ops),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_flat_s": flat_s,
        "collective_topo_s": topo_s,
        "collective_by_axis": by_axis,
        "dominant": dominant,
        "model_flops": mflops,
        "useful_flops_ratio": (mflops / chips / max(flops / chips, 1e-30)),
        "mfu_bound": (mflops / chips / hw.peak_flops) / max(step_s, 1e-30),
        "roofline_step_s": step_s,
    }

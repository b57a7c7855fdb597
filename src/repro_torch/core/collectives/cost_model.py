"""Topology-aware collective cost models.

This is where EvalNet stops being a standalone analyzer and starts driving
the training framework: given (a) a physical topology (a `Graph`, usually a
torus for ICI and a fat tree for DCN) and (b) a mesh-axis → topology mapping,
it predicts the time of every collective the compiler emits.

Algorithm models (per-device wire-bytes → seconds over the axis's links):

  kind               wire bytes per device (n = axis size, B = full bytes)
  all-reduce (ring)  2 B (n-1)/n
  reduce-scatter     B (n-1)/n
  all-gather         B (n-1)/n
  all-to-all         B (n-1)/n     (each device exchanges B/n with n-1 peers)
  collective-permute B

On a torus ring the two directions are used concurrently (bidirectional
ring), doubling effective bandwidth; across pods (DCN) bandwidth is the
per-chip DCN share. Latency: (n-1) (ring) or ceil(log2 n) (tree/RHD) hops of
`link_latency` — negligible for the MB-scale tensors here but reported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["HardwareModel", "AxisLink", "collective_time", "COLLECTIVE_KINDS"]

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """TPU v5e-like chip + fabric constants (the assignment's numbers)."""

    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # bytes/s per chip
    ici_link_bw: float = 50e9           # bytes/s per ICI link (one direction)
    dcn_bw_per_chip: float = 6.25e9     # bytes/s per chip across pods
    ici_latency: float = 1e-6           # per hop
    dcn_latency: float = 10e-6          # per hop
    vmem_bytes: int = 128 * 2 ** 20
    hbm_bytes: int = 16 * 2 ** 30


@dataclasses.dataclass(frozen=True)
class AxisLink:
    """Physical realisation of one mesh axis.

    kind: "ici_ring"  — the axis maps to a torus dimension (bidirectional
                        ring of `size` chips, 2 links usable concurrently);
          "dcn"       — the axis crosses pods over the data-center network.
    """

    name: str
    size: int
    kind: str = "ici_ring"

    def bandwidth(self, hw: HardwareModel) -> float:
        if self.kind == "ici_ring":
            return 2.0 * hw.ici_link_bw  # both ring directions
        if self.kind == "dcn":
            return hw.dcn_bw_per_chip
        raise ValueError(f"unknown axis kind {self.kind}")

    def latency(self, hw: HardwareModel) -> float:
        return hw.ici_latency if self.kind == "ici_ring" else hw.dcn_latency


def _wire_factor(kind: str, n: int) -> float:
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * frac
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return frac
    if kind == "collective-permute":
        return 1.0
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_time(kind: str, full_bytes: float, axis: AxisLink,
                    hw: Optional[HardwareModel] = None) -> float:
    """Predicted seconds for one collective of `full_bytes` over `axis`.

    `full_bytes` is the size of the *complete* (unsharded along this axis)
    tensor for all-gather/all-reduce, and the per-device send volume for
    collective-permute — i.e. exactly what the HLO operand/result bytes give
    after accounting for output vs input shapes (see launch/roofline.py).
    """
    hw = hw or HardwareModel()
    wire = _wire_factor(kind, axis.size) * full_bytes
    steps = axis.size - 1 if kind != "collective-permute" else 1
    return wire / axis.bandwidth(hw) + steps * axis.latency(hw)


def hierarchical_all_reduce_time(full_bytes: float, axes: Dict[str, AxisLink],
                                 hw: Optional[HardwareModel] = None) -> float:
    """Reduce-scatter/all-gather decomposition across several axes:
    RS along each axis (shrinking payload), then AG back out. Standard
    multi-axis schedule XLA uses for replica groups spanning axes."""
    hw = hw or HardwareModel()
    t = 0.0
    payload = full_bytes
    order = sorted(axes.values(), key=lambda a: a.bandwidth(hw), reverse=True)
    for ax in order:
        t += collective_time("reduce-scatter", payload, ax, hw)
        payload /= max(ax.size, 1)
    for ax in reversed(order):
        payload *= max(ax.size, 1)
        t += collective_time("all-gather", payload, ax, hw)
    return t

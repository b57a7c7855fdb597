"""HammingMesh (Hoefler et al., SC'22): 2D meshes of boards stitched by
row/column networks.

Chips sit on a x b boards (2D mesh links on-board, cheap electrical
traces); boards form an x x y grid. Every chip row of the machine is
connected by a row network and every chip column by a column network —
the paper builds them as two-level fat trees; this generator models each
as a single non-blocking crossbar router, the standard flattening for
path-diversity analysis (document: switch radix x*b / y*a is realized by
a fat tree in hardware).

Vertices: a*b*x*y chips (one server each), then a*y row switches — one
per (board-row, on-board row) — then b*x column switches. A chip connects
to its on-board mesh neighbors, its row switch, and its column switch,
so any two chips are within 4 hops (chip -> row switch -> chip -> column
switch -> chip); mesh links only shorten that. BFS diameter is 4 for
x, y >= 2 on boards bigger than 1x1.
"""
from __future__ import annotations

import numpy as np

from ..graph import Graph
from .base import register
from .spec import LinkClass, TopologySpec, optical_length

__all__ = ["make_hammingmesh", "spec_hammingmesh"]

#: on-board mesh trace length (meters) — board-local, far below rack scale
BOARD_TRACE_M = 0.5


def _hm_diameter(a: int, b: int, x: int, y: int) -> int:
    # With more than one board, a row (or column) network spans boards, so
    # any two routers sit within the chip -> row net -> chip -> column net
    # -> chip envelope of 4 hops, and some pair always needs all 4.
    if x > 1 or y > 1:
        return 4
    # Single board: worst pairs are switch<->switch across rows/columns
    # (row switches i, i' are min(4, 2 + |i - i'|) apart via mesh or the
    # column-network detour) and mesh-distant chips, capped at 4 by the
    # switch route. Verified against BFS over the (a, b, x, y) <= 3 grid.
    cands = [2]  # chip <-> its switches, row switch <-> column switch
    if a * b > 1:
        cands.append(min(4, (a - 1) + (b - 1)))
    if a > 1:
        cands.append(min(4, a + 1))
    if b > 1:
        cands.append(min(4, b + 1))
    return max(cands)


def _chip_mesh_degrees(a: int, b: int) -> np.ndarray:
    i, j = np.meshgrid(np.arange(a), np.arange(b), indexing="ij")
    return ((i > 0).astype(int) + (i < a - 1) + (j > 0) + (j < b - 1)).ravel()


def spec_hammingmesh(a: int = 4, b: int = 4, x: int = 4,
                     y: int = 4) -> TopologySpec:
    chips = a * b * x * y
    n = chips + a * y + b * x
    mesh_links = x * y * (a * (b - 1) + b * (a - 1))
    # radix histogram: chips by mesh degree (+2 switch ports, +1 server),
    # then the two switch tiers
    counts: dict[int, int] = {}
    for d in _chip_mesh_degrees(a, b):
        r = int(d) + 2 + 1
        counts[r] = counts.get(r, 0) + x * y
    for r, c in ((x * b, a * y), (y * a, b * x)):
        counts[r] = counts.get(r, 0) + c
    return TopologySpec(
        family="hammingmesh", params={"a": a, "b": b, "x": x, "y": y},
        n_routers=n, n_servers=chips, concentration=0,
        network_radix=max(_chip_mesh_degrees(a, b).max(initial=0) + 2,
                          x * b, y * a),
        expected_diameter=_hm_diameter(a, b, x, y),
        link_classes=(
            LinkClass("board-mesh", mesh_links, BOARD_TRACE_M, "electrical"),
            LinkClass("row-net", chips, optical_length(n), "optical"),
            LinkClass("col-net", chips, optical_length(n), "optical"),
        ),
        radix_counts=tuple(sorted(counts.items())),
    )


@register("hammingmesh", spec=spec_hammingmesh,
          ladder=lambda i: {"a": 4, "b": 4, "x": i + 1, "y": i + 1})
def make_hammingmesh(a: int = 4, b: int = 4, x: int = 4, y: int = 4) -> Graph:
    chips = a * b * x * y
    n = chips + a * y + b * x

    # chip (bx, by, i, j) -> id, boards row-major, chips row-major on-board
    bx, by, i, j = np.meshgrid(np.arange(x), np.arange(y), np.arange(a),
                               np.arange(b), indexing="ij")
    cid = ((bx * y + by) * a + i) * b + j
    edges = []
    # on-board mesh links
    for axis, size in (("i", a), ("j", b)):
        coord = i if axis == "i" else j
        keep = coord < size - 1
        step = b if axis == "i" else 1
        edges.append(np.stack([cid[keep], cid[keep] + step], axis=1))
    # row networks: one switch per (by, i) plane, attached to every chip
    # sharing that machine row; column networks per (bx, j) likewise
    row_sw = chips + by * a + i
    col_sw = chips + a * y + bx * b + j
    edges.append(np.stack([cid.ravel(), row_sw.ravel()], axis=1))
    edges.append(np.stack([cid.ravel(), col_sw.ravel()], axis=1))
    e = np.concatenate(edges, axis=0)
    return Graph(
        n=n, edges=e, concentration=0,
        name=f"hammingmesh({a}x{b},{x}x{y})",
        meta={"a": a, "b": b, "x": x, "y": y,
              "diameter": _hm_diameter(a, b, x, y),
              "num_servers": chips, "n_row_switches": a * y,
              "n_col_switches": b * x},
    )

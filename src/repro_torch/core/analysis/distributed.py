"""Out-of-core wavefront analysis on torch — the single-device extreme-scale
engine.

:func:`tiled_dist_mult_tiles` runs the BFS level loop one source tile at a
time, so no N x N matrix of dist or mult ever exists: the device holds a
(tile, N) dist, mult and frontier, plus either the whole adjacency or one
adjacency panel at a time.

* **Resident**: when the padded adjacency fits ``adjacency_budget`` bytes,
  it is scattered from the graph's CSR straight into one (N, N) device
  matrix, and each level is one fused frontier-step launch
  (`kernels.semiring.frontier_step`, or `frontier_step_packed`).
* **Streamed**: past the budget, each level streams ``(panel_rows, N)``
  adjacency panels, filled on the host from CSR, through pinned staging
  buffers used in turn, into the counting product
  (`kernels.semiring.count_matmul`) accumulated over the panels; the
  first-reach mask is applied to the accumulated (tile, N) product.

``packed=True`` shrinks the cells: int16 distances (``DIST_UNREACHED``
plays +inf), multiplicities saturating at ``MULT_SAT`` = 2**24 (clamped,
never wrapped), uint8 {0,1} adjacency. Results are bit-equal to the fp32
engine wherever values fit, and to the JAX package's tiled engine
throughout: distances are small integers and counts integer sums, exact in
fp32 below 2**24, so neither the tile split nor the panel split changes a
bit.

The sharded engines of the JAX package (a row mesh, the composed
sharding x streaming engine) are not ported yet: ``mesh=`` with more than
one shard, :func:`dist_mult_sharded`, :func:`ecmp_loads_sharded` and
:func:`composed_dist_mult_tiles` raise NotImplementedError (ROADMAP Queue 1
item 6, second half).

CLI::

  python -m repro_torch.core.analysis.distributed [--family F] [--routers N]
      [--tile-rows T] [--sources K] [--packed] [--adjacency-budget BYTES]
      [--check C] [--checkpoint FILE] [--device cuda|cpu]
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ... import obs
from ...kernels import semiring as S
from .engine_select import _mesh_shards
from .wavefront import resolve_device

__all__ = ["tiled_dist_mult", "tiled_dist_mult_tiles", "tiled_summary",
           "bfs_dist_sigma", "oracle_rows", "widest_divisor_block",
           "dist_mult_sharded", "ecmp_loads_sharded",
           "composed_dist_mult_tiles"]

#: f32 row/col tile width every padded size is a multiple of
_TILE = 128

#: dense adjacency larger than this (bytes) makes the tiled engine stream
#: CSR-built panels instead of keeping the full matrix device-resident
_ADJ_BUDGET = 1 << 28

#: pinned staging buffers the streamed pump fills in turn
_STAGING = 2


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 item 6, "
        f"second half: the sharded engines on torch.distributed); run the "
        f"single-device tiled engine (mesh=None)")


def dist_mult_sharded(*args, **kw):
    """Row-sharded wavefront over a device mesh: not ported (raises)."""
    _not_ported("dist_mult_sharded")


def ecmp_loads_sharded(*args, **kw):
    """Row-sharded ECMP loads over a device mesh: not ported (raises)."""
    _not_ported("ecmp_loads_sharded")


def composed_dist_mult_tiles(*args, **kw):
    """Sharded adjacency x streamed tiles: not ported (raises)."""
    _not_ported("composed_dist_mult_tiles")


def _pad128(n: int) -> int:
    """Router count padded up to the f32 lane tile (the one padding rule
    shared by the tile pump and the CLI probe)."""
    return max(_TILE, n + ((-n) % _TILE))


# -- adjacency sources -----------------------------------------------------------

def _csr_panel(indptr: np.ndarray, indices: np.ndarray, n: int, k0: int,
               k1: int, out: np.ndarray) -> np.ndarray:
    """Fill ``out[:k1-k0, :n]`` with dense adjacency rows k0..k1 from CSR.

    ``out`` is a staging buffer of the tile pump; rows past ``k1 - k0``
    (panel padding) and columns past ``n`` stay zero."""
    out[...] = 0
    span = indptr[k0:k1 + 1]
    counts = np.diff(span)
    out[np.repeat(np.arange(k1 - k0), counts),
        indices[span[0]:span[-1]]] = 1
    return out


def _adjacency_source(source) -> Tuple[Callable[[int, int, np.ndarray],
                                                np.ndarray], int]:
    """(panel filler, n) from a Graph (CSR rows, nothing dense ever built)
    or a dense (n, n) array (sliced views)."""
    if hasattr(source, "csr"):
        indptr, indices = source.csr()
        n = source.n

        def fill(k0: int, k1: int, out: np.ndarray) -> np.ndarray:
            return _csr_panel(indptr, indices, n, k0, k1, out)

        return fill, n
    dense = np.asarray(source, np.float32)
    n = dense.shape[-1]

    def fill(k0: int, k1: int, out: np.ndarray) -> np.ndarray:
        out[...] = 0
        out[:k1 - k0, :n] = dense[k0:k1]
        return out

    return fill, n


def _router_count(source) -> int:
    return source.n if hasattr(source, "csr") else np.asarray(source).shape[-1]


def _device_adjacency(source, n: int, pc: int, dtype: torch.dtype,
                      dev: torch.device) -> torch.Tensor:
    """The (pc, pc) padded adjacency on ``dev``: a Graph's CSR is scattered
    straight into a device zero matrix (only the flat edge indices cross
    to the card), a dense array is uploaded as it is. Bit-identical to
    assembling the panels on the host."""
    adj = torch.zeros((pc, pc), dtype=dtype, device=dev)
    if hasattr(source, "csr"):
        indptr, indices = source.csr()
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        flat = torch.from_numpy(rows * pc + indices.astype(np.int64))
        obs.record_h2d(flat.numel() * flat.element_size(), "adjacency")
        adj.view(-1)[flat.to(dev)] = 1
    else:
        dense = torch.from_numpy(np.asarray(source, np.float32)).to(dtype)
        obs.record_h2d(dense.numel() * dense.element_size(), "adjacency")
        adj[:n, :n] = dense.to(dev)
    return adj


def widest_divisor_block(size: int, cap: int) -> int:
    """Largest multiple of ``_TILE`` <= cap dividing ``size`` — ANY
    multiplier, not just powers of two. ``size`` must be a multiple of
    ``_TILE`` (padded extents always are). The JAX package sizes its
    kernel blocks with it; the CUDA kernels take any shape, so here it only
    fills the ``block`` the extreme sweep reports."""
    q = size // _TILE
    qcap = max(1, cap // _TILE)
    best = 1
    d = 1
    while d * d <= q:
        if q % d == 0:
            if d <= qcap:
                best = max(best, d)
            if q // d <= qcap:
                best = max(best, q // d)
        d += 1
    return best * _TILE


def _record_panel(nbytes: int, dtype) -> None:
    """Pump accounting: bytes streamed through the staging buffers plus a
    per-dtype panel-size gauge."""
    obs.record_h2d(nbytes, "panel")
    obs.counter("pump.bytes_streamed").add(nbytes)
    obs.gauge(f"pump.panel_mb.{np.dtype(dtype).name}").set(
        round(nbytes / 2**20, 3))


# -- one level -------------------------------------------------------------------

def _tile_level(frontier: torch.Tensor, adj: torch.Tensor, dist: torch.Tensor,
                mult: torch.Tensor, level: int, packed: bool):
    """One resident level: the fused step, then dist/mult in place.
    Returns (next frontier, any-new device flag)."""
    step = S.frontier_step_packed if packed else S.frontier_step
    x = step(frontier, adj, dist)
    new = x > 0
    dist.masked_fill_(new, level)
    mult.add_(x)
    return x, new.any()


def _mask_update(x: torch.Tensor, dist: torch.Tensor, mult: torch.Tensor,
                 level: int, packed: bool):
    """The first-reach mask over the panel-accumulated fp32 product ``x``;
    packed counts clamp at MULT_SAT on the way into the int32 cell —
    saturate, never wrap. Returns (next frontier, any-new device flag)."""
    if packed:
        new = (x > 0) & (dist == S.DIST_UNREACHED)
        x = torch.where(new, x.clamp(max=float(S.MULT_SAT)),
                        0.0).to(S.MULT_DTYPE)
    else:
        new = (x > 0) & torch.isinf(dist)
        x = torch.where(new, x, 0.0)
    dist.masked_fill_(new, level)
    mult.add_(x)
    return x, new.any()


# -- source tiles ----------------------------------------------------------------

def _resolve_source_ids(n: int, sources, source_ids
                        ) -> Tuple[np.ndarray, Optional[int]]:
    """(ids array, base) for the tile pump: ``base`` is the router id of
    the first row when the ids are a contiguous range (yields stay absolute
    row indices) and None for an arbitrary id list (yields index the ids
    list)."""
    if source_ids is not None:
        if sources is not None:
            raise ValueError("pass sources=(lo, hi) or source_ids=, "
                             "not both")
        ids = np.asarray(source_ids, np.int64).ravel()
        if len(ids) == 0 or ids.min() < 0 or ids.max() >= n:
            raise ValueError(f"source_ids must be non-empty router ids "
                             f"in [0, {n})")
        return ids, None
    lo, hi = (0, n) if sources is None else sources
    if not (0 <= lo < hi <= n):
        raise ValueError(f"sources {sources!r} outside [0, {n})")
    return np.arange(lo, hi, dtype=np.int64), lo


def _seed_tile(ids: np.ndarray, tp: int, pc: int, packed: bool):
    """(frontier/mult seed, dist seed) host arrays for one source tile:
    rows 0..len(ids) seed router columns ``ids``; padding rows are inert
    phantom sources (frontier 0 everywhere, dist all-unreached)."""
    t = len(ids)
    if packed:
        eye = np.zeros((tp, pc), np.int32)
        seed = np.full((tp, pc), S.DIST_UNREACHED, np.int16)
    else:
        eye = np.zeros((tp, pc), np.float32)
        seed = np.full((tp, pc), np.inf, np.float32)
    eye[np.arange(t), ids] = 1
    seed[np.arange(t), ids] = 0
    return eye, seed


def _tile_shape(t: int, cap: int = 512) -> int:
    """Padded tile rows for a t-row source tile (the JAX package's
    shapes: a multiple of 8 up to ``cap``, of 128 above)."""
    return t + ((-t) % 8) if t <= cap else _pad128(t)


def tiled_dist_mult_tiles(
        source, tile_rows: int = 512, panel_rows: Optional[int] = None,
        sources: Optional[Tuple[int, int]] = None,
        source_ids=None,
        adjacency_budget: int = _ADJ_BUDGET,
        block: Optional[int] = None, interpret: Optional[bool] = None,
        packed: bool = False, mesh=None, device="cuda",
) -> Iterator[Tuple[int, int, np.ndarray, np.ndarray]]:
    """Out-of-core exact dist+mult, one source tile at a time.

    Yields ``(r0, r1, dist_tile, mult_tile)`` with (r1 - r0, n) numpy tiles
    for source rows [r0, r1) — bit-equal to the corresponding rows of
    `wavefront.wavefront_dist_mult`.

    ``source`` is a Graph (adjacency built from its CSR; the dense N x N
    host matrix never exists) or a dense (n, n) array. When the padded
    adjacency fits ``adjacency_budget`` bytes it lives on the device and
    each level is one fused frontier-step launch; past the budget each
    level streams ``(panel_rows, n)`` panels through pinned staging
    buffers into the counting product and masks the accumulated (tile, n)
    product.

    ``sources=(lo, hi)`` restricts to a row range; ``source_ids=`` takes an
    arbitrary id array instead (the sampled-sources estimator's path) —
    tiles then cover ``ids[r0:r1]`` and the yielded (r0, r1) index the ids
    list, not router rows. ``packed=True`` shrinks every cell (uint8
    adjacency, int16 dist, counts saturating at MULT_SAT) and yields
    (int16, uint32) tiles. ``device`` is where the levels run: ``"cuda"``
    by default, which raises without a card; ``"cpu"`` runs the kernels'
    plain versions.

    ``block=`` and ``interpret=`` are accepted and ignored: they size the
    JAX package's Pallas grid, and the CUDA kernels take any shape.
    ``mesh=`` with more than one shard raises NotImplementedError (the
    composed engine is not ported).
    """
    if _mesh_shards(mesh) > 1:
        _not_ported("mesh= (the composed sharding x streaming engine)")
    dev = resolve_device(device)
    fill, n = _adjacency_source(source)
    pc = _pad128(n)                                # padded column count
    ids_all, base = _resolve_source_ids(n, sources, source_ids)
    tile_rows = max(1, min(tile_rows, len(ids_all)))

    adtype = np.uint8 if packed else np.float32
    adtype_t = torch.uint8 if packed else torch.float32
    abytes = np.dtype(adtype).itemsize
    stream = pc * pc * abytes > adjacency_budget
    if panel_rows is None:
        panel_rows = min(pc, max(_TILE,
                                 adjacency_budget // (8 * pc * abytes)))
    # panels tile the padded width exactly: round down to the largest
    # 128-multiple that divides pc
    panel_rows = max(_TILE, min(pc, panel_rows) - (min(pc, panel_rows) % _TILE))
    while pc % panel_rows:
        panel_rows -= _TILE
    adj_dev = staging = None
    if stream:
        # pinned host buffers, filled in turn: the host refills one only
        # after the event of its last upload, so a panel in flight is
        # never overwritten
        pinned = dev.type == "cuda"
        staging = [torch.zeros((panel_rows, pc), dtype=adtype_t,
                               pin_memory=pinned) for _ in range(_STAGING)]
        uploaded = [None] * _STAGING
    else:
        adj_dev = _device_adjacency(source, n, pc, adtype_t, dev)
    # panels fully inside the column padding are all-zero: skipped
    panels = [(k0, min(n, k0 + panel_rows))
              for k0 in range(0, pc, panel_rows) if k0 < n]
    max_level = min(n, S.DIST_UNREACHED - 1) if packed else n

    for c0 in range(0, len(ids_all), tile_rows):
        ids = ids_all[c0:c0 + tile_rows]
        t = len(ids)
        r0 = c0 if base is None else base + c0
        r1 = r0 + t
        tp = _tile_shape(t)
        with obs.span("tiled.tile", cat="tiled", r0=r0, r1=r1,
                      streamed=stream, packed=packed) as sp:
            eye, seed = _seed_tile(ids, tp, pc, packed)
            obs.record_h2d(eye.nbytes + seed.nbytes, "tile_seed")
            dist = torch.from_numpy(seed).to(dev)
            mult = torch.from_numpy(eye).to(dev)
            frontier = mult.clone()

            pumped = 0
            level = 1
            while level <= max_level:
                if stream:
                    x = torch.zeros((tp, pc), dtype=torch.float32, device=dev)
                    for k0, k1 in panels:
                        j = pumped % _STAGING
                        if uploaded[j] is not None:
                            uploaded[j].synchronize()
                        fill(k0, k1, staging[j].numpy())
                        panel = staging[j].to(dev, non_blocking=True)
                        if dev.type == "cuda":
                            uploaded[j] = torch.cuda.Event()
                            uploaded[j].record()
                        _record_panel(panel_rows * pc * abytes, adtype)
                        x.add_(S.count_matmul(
                            frontier[:, k0:k0 + panel_rows], panel))
                        pumped += 1
                    frontier, more = _mask_update(x, dist, mult, level,
                                                  packed)
                else:
                    frontier, more = _tile_level(frontier, adj_dev, dist,
                                                 mult, level, packed)
                if not bool(more):  # the level's one host sync
                    break
                level += 1
            sp.set(levels=level, panels_pumped=pumped)
            d = dist[:t, :n].cpu().numpy()
            m = mult[:t, :n].cpu().numpy()
            yield r0, r1, d, (m.astype(S.HOST_MULT_DTYPE) if packed else m)


def tiled_dist_mult(source, tile_rows: int = 512,
                    panel_rows: Optional[int] = None,
                    out: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                    **kw) -> Tuple[np.ndarray, np.ndarray]:
    """Assembled (n, n) dist+mult through the tiled engine.

    This materializes two full N x N host matrices — the point of the tiled
    engine is that the *device* never does; pass ``out=(dist, mult)``
    (e.g. an np.memmap pair) to keep the host side out-of-core as well, or
    use :func:`tiled_dist_mult_tiles` / :func:`tiled_summary` to avoid the
    N x N buffers entirely.
    """
    from .wavefront import _warn_if_inexact

    n = _router_count(source)
    packed = bool(kw.get("packed"))
    if out is None:
        if packed:
            out = (np.empty((n, n), np.int16),
                   np.empty((n, n), S.HOST_MULT_DTYPE))
        else:
            out = (np.empty((n, n), np.float32),
                   np.empty((n, n), np.float32))
    dist, mult = out
    for r0, r1, d, m in tiled_dist_mult_tiles(source, tile_rows, panel_rows,
                                              **kw):
        dist[r0:r1] = d
        mult[r0:r1] = m
    if not packed:
        # packed counts saturate at MULT_SAT instead of losing f32 integer
        # precision, so the 2**24 exactness check is an f32-engine concern
        _warn_if_inexact(mult)
    return dist, mult


def tiled_summary(source, tile_rows: int = 512,
                  panel_rows: Optional[int] = None,
                  sources: Optional[Tuple[int, int]] = None,
                  on_tile=None, checkpoint=None, **kw) -> Dict[str, object]:
    """Streaming aggregate of the tiled engine — no N x N buffer anywhere.

    Folds each (tile, n) dist/mult tile into diameter, reached-pair count,
    average shortest-path length and multiplicity stats, and reports the
    peak RSS next to what the single-buffer engine would need (6 padded
    N^2 f32 buffers), through the `repro_torch.obs` meters
    (``tiled.peak_rss_mb`` gauge, ``tiled.tiles`` counter).

    ``on_tile(r0, r1, dist, mult)``, when given, sees every tile before it
    is folded — callers spot-check rows without paying a second pass.

    ``checkpoint=`` (a path) makes long runs crash-safe: after every
    folded tile the partial aggregates are persisted atomically
    (`resilience.checkpoint.TileCheckpoint`), and a rerun with the same
    arguments resumes from the last completed tile — tiles are
    independent and the fold order is preserved, so a killed-and-resumed
    run returns aggregates bit-identical to an uninterrupted one. A
    mismatched checkpoint raises; a completed run removes its file. On
    resume ``on_tile`` only sees the recomputed tiles.
    """
    import time

    n = _router_count(source)
    packed = bool(kw.get("packed"))
    t0 = time.perf_counter()
    diam = 0
    pairs = 0
    dist_sum = 0.0
    mult_sum = 0.0
    mult_min = np.inf
    mult_max = 0.0
    rows_done = 0
    tiles = 0

    source_ids = kw.pop("source_ids", None)
    ids_all, base = _resolve_source_ids(n, sources, source_ids)
    eff_tile = max(1, min(tile_rows, len(ids_all)))
    ckpt = fp = None
    if checkpoint is not None:
        from ..resilience.checkpoint import (TileCheckpoint,
                                             source_fingerprint)

        ckpt = TileCheckpoint(checkpoint)
        fp = source_fingerprint(source, tile_rows, packed, sources=sources,
                                source_ids=source_ids)
        state = ckpt.load(fp)
        if state is not None:
            diam = state["diameter"]
            pairs = state["reached_pairs"]
            dist_sum = state["dist_sum"]
            mult_sum = state["mult_sum"]
            mult_min = np.inf if state["mult_min"] is None else state["mult_min"]
            mult_max = state["mult_max"]
            rows_done = state["rows_done"]
            tiles = state["tiles"]
            obs.log("tiled.resume", checkpoint=str(checkpoint),
                    rows_done=rows_done, tiles=tiles)
    # the pump restarts at the first incomplete tile; rows_done is always
    # a whole number of tiles, so the remaining tile boundaries — and with
    # them every yielded tile — are identical to the uninterrupted run's
    if rows_done and base is not None:
        kw_sel = dict(sources=(base + rows_done, base + len(ids_all)))
    elif rows_done:
        kw_sel = dict(source_ids=ids_all[rows_done:])
    elif source_ids is not None:
        kw_sel = dict(source_ids=source_ids)
    else:
        kw_sel = dict(sources=sources)
    remaining = len(ids_all) - rows_done

    with obs.span("tiled.summary", cat="tiled", routers=n,
                  tile_rows=tile_rows, resumed_rows=rows_done) as sp:
        tile_iter = (tiled_dist_mult_tiles(source, eff_tile, panel_rows,
                                           **kw_sel, **kw)
                     if remaining > 0 else ())
        for r0, r1, d, m in tile_iter:
            if on_tile is not None:
                on_tile(r0, r1, d, m)
            # packed tiles carry the int16 DIST_UNREACHED sentinel instead
            # of +inf (int16 is always "finite")
            if packed:
                off = (d > 0) & (d != S.DIST_UNREACHED)
            else:
                off = np.isfinite(d) & (d > 0)
            if off.any():
                diam = max(diam, int(d[off].max()))
                pairs += int(off.sum())
                dist_sum += float(d[off].sum())
                mult_sum += float(m[off].sum())
                mult_min = min(mult_min, float(m[off].min()))
                mult_max = max(mult_max, float(m[off].max()))
            rows_done += r1 - r0
            tiles += 1
            obs.counter("tiled.tiles").add()
            obs.sample_process("tiled")
            if ckpt is not None:
                ckpt.save(fp, {
                    "diameter": diam, "reached_pairs": pairs,
                    "dist_sum": dist_sum, "mult_sum": mult_sum,
                    "mult_min": None if mult_min == np.inf else mult_min,
                    "mult_max": mult_max, "rows_done": rows_done,
                    "tiles": tiles,
                })
        sp.set(tiles=tiles, diameter=diam)
    if ckpt is not None:
        ckpt.remove()
    pc = _pad128(n)
    obs.gauge("tiled.peak_rss_mb").set(round(obs.peak_rss_mb(), 1))
    return {
        "routers": n,
        "rows_analyzed": rows_done,
        "tiles": tiles,
        "tile_rows": tile_rows,
        "diameter": diam,
        "reached_pairs": pairs,
        "avg_spl": dist_sum / pairs if pairs else 0.0,
        "mult_mean": mult_sum / pairs if pairs else 0.0,
        "mult_min": 0.0 if pairs == 0 else mult_min,
        "mult_max": mult_max,
        "elapsed_s": round(time.perf_counter() - t0, 2),
        "peak_rss_mb": round(obs.peak_rss_mb(), 1),
        "single_buffer_mb": round(6 * pc * pc * 4 / 2**20, 1),
        "packed": packed,
        "saturated": bool(packed and mult_max >= S.MULT_SAT),
    }


# -- host oracle -----------------------------------------------------------------

def bfs_dist_sigma(g, s: int) -> Tuple[np.ndarray, np.ndarray]:
    """Single-source hop distances + shortest-path counts over CSR (host
    Brandes forward pass) — the O(E) per-source oracle the tiled engine is
    spot-checked against at sizes where dense N^2 references are
    unaffordable. Returns (dist, sigma) length-n arrays, dist +inf where
    unreachable."""
    indptr, indices = g.csr()
    n = g.n
    dist = np.full(n, np.inf, np.float64)
    sigma = np.zeros(n, np.float64)
    dist[s] = 0.0
    sigma[s] = 1.0
    frontier = [s]
    level = 0
    while frontier:
        level += 1
        nxt: Dict[int, float] = {}
        for u in frontier:
            su = sigma[u]
            for v in indices[indptr[u]:indptr[u + 1]]:
                v = int(v)
                if dist[v] == np.inf or dist[v] == level:
                    dist[v] = level
                    nxt[v] = nxt.get(v, 0.0) + su
        for v, sv in nxt.items():
            sigma[v] += sv
        frontier = list(nxt)
    return dist, sigma


def oracle_rows(g, i: int, packed: bool) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`bfs_dist_sigma` for source ``i`` in the tiled engine's cells:
    (int16, uint32) with the sentinel and the clamp when ``packed``, f32
    otherwise."""
    od, osig = bfs_dist_sigma(g, i)
    if packed:
        od = np.where(np.isfinite(od), od, S.DIST_UNREACHED).astype(np.int16)
        osig = np.minimum(osig, S.MULT_SAT).astype(S.HOST_MULT_DTYPE)
        return od, osig
    return od.astype(np.float32), osig.astype(np.float32)


# -- CLI: the extreme-scale demo / memory-budget probe ---------------------------

def main(argv=None) -> int:
    """``python -m repro_torch.core.analysis.distributed`` — tiled demo.

    Runs the out-of-core engine on a generated topology, spot-checks a few
    sources against the CSR Brandes oracle, and prints the summary JSON
    (incl. measured peak RSS vs the single-buffer requirement).
    """
    import argparse
    import json

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--family", default="jellyfish")
    ap.add_argument("--routers", type=int, default=16384)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--tile-rows", type=int, default=256)
    ap.add_argument("--panel-rows", type=int, default=None)
    ap.add_argument("--sources", type=int, default=None,
                    help="analyze only the first K source rows "
                         "(tiles are independent; default: all)")
    ap.add_argument("--adjacency-budget", type=int, default=_ADJ_BUDGET,
                    help="device bytes before adjacency panels stream")
    ap.add_argument("--packed", action="store_true",
                    help="packed cells: uint8 adjacency, int16 dist, mult "
                         "saturating at 2**24 (4x less streamed/resident "
                         "memory; bit-exact where values fit)")
    ap.add_argument("--shards", type=int, default=None,
                    help="row-shard over this many devices (not ported: "
                         "more than 1 raises)")
    ap.add_argument("--block", type=int, default=None,
                    help="accepted for the JAX package's command line; the "
                         "CUDA kernels take any shape")
    ap.add_argument("--check", type=int, default=2,
                    help="spot-check this many sources vs the CSR oracle")
    ap.add_argument("--checkpoint", default=None, metavar="FILE.json",
                    help="crash-safe mode: persist partial aggregates "
                         "after every tile (atomic write + rename) and "
                         "resume from the last completed tile on rerun")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions on the host)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable tracing and write a Chrome trace-event "
                         "file (load in https://ui.perfetto.dev)")
    args = ap.parse_args(argv)

    from .. import topology as topo

    if args.shards and args.shards > 1:
        _not_ported("--shards")
    if args.trace:
        obs.enable()

    if args.family == "jellyfish":
        g = topo.make("jellyfish", n=args.routers, r=args.degree, seed=0)
    else:
        g = topo.by_servers(args.family, args.routers)
    srcs = (0, min(args.sources, g.n)) if args.sources else None

    # the oracle spot-check rides the summary stream itself (on_tile sees
    # every tile before it is folded) — one pass, not two
    check_lo = srcs[0] if srcs else 0
    check_hi = min(check_lo + args.check, g.n) if args.check else check_lo
    checked = [0]

    def spot_check(r0, r1, d, m):
        for i in range(max(check_lo, r0), min(check_hi, r1)):
            od, osig = oracle_rows(g, i, args.packed)
            np.testing.assert_array_equal(d[i - r0], od)
            np.testing.assert_array_equal(m[i - r0], osig)
            checked[0] += 1

    summary = tiled_summary(g, tile_rows=args.tile_rows,
                            panel_rows=args.panel_rows, sources=srcs,
                            adjacency_budget=args.adjacency_budget,
                            packed=args.packed, block=args.block,
                            on_tile=spot_check if args.check else None,
                            checkpoint=args.checkpoint, device=args.device)
    if args.check and not args.checkpoint:
        # a checkpoint resume skips completed tiles, so the spot-check may
        # legitimately see fewer sources than requested
        if checked[0] != check_hi - check_lo:
            raise RuntimeError(f"spot-checked {checked[0]} sources, not "
                               f"{check_hi - check_lo}")
        obs.log("distributed.check", status="oracle spot-check OK",
                sources=checked[0])
    summary["family"] = g.name
    summary["shards"] = 1
    summary["adjacency_streamed"] = bool(
        _pad128(g.n) ** 2 * (1 if args.packed else 4) > args.adjacency_budget)
    print(json.dumps(summary, indent=1))
    if args.trace:
        obs.export(args.trace)
        obs.log("distributed.trace", path=args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

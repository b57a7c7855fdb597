"""Crash-safe checkpointing for long tiled/streaming analysis runs.

The tiled engine (`analysis.distributed.tiled_dist_mult_tiles`) computes
independent source tiles in a fixed order, so a long run's progress is
fully described by (a) how many tiles have been folded and (b) the partial
aggregates so far. :class:`TileCheckpoint` persists exactly that after
every folded tile, atomically — the state is serialized to a temporary
file in the same directory and moved into place with ``os.replace``, so a
kill at ANY instant leaves either the previous complete checkpoint or the
new complete checkpoint, never a torn file.

Resume is bit-identical: floats round-trip exactly through JSON (Python
serializes them via ``repr``, which is shortest-round-trip), the remaining
tiles are recomputed by the same engine in the same order, and the fold
order of the scalar aggregates is unchanged — so a killed-and-resumed
`tiled_summary(checkpoint=...)` run returns byte-for-byte the aggregates
of an uninterrupted one (asserted by the injected-kill test in
``tests/test_torch_extreme.py``).

A checkpoint binds to its run through a fingerprint (router count, edge
hash or dense-array signature, tile size, packed flag, source selection):
loading with a different fingerprint is refused, so a stale file can never
silently seed the wrong run.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
import zlib
from typing import Dict, Optional

import numpy as np

__all__ = ["TileCheckpoint", "source_fingerprint"]


def source_fingerprint(source, tile_rows: int, packed: bool,
                       sources=None, source_ids=None) -> Dict[str, object]:
    """Identity of one tiled run: same fingerprint <=> same tile stream."""
    from ..graph import Graph

    if isinstance(source, Graph):
        ident = {"routers": source.n, "edges": int(len(source.edges)),
                 "edges_crc": int(zlib.crc32(
                     np.ascontiguousarray(source.edges).tobytes()))}
    else:
        arr = np.asarray(source)
        ident = {"routers": int(arr.shape[0]),
                 "shape": list(arr.shape), "dtype": str(arr.dtype),
                 "sample_crc": int(zlib.crc32(
                     np.ascontiguousarray(arr[0]).tobytes()))}
    ident["tile_rows"] = int(tile_rows)
    ident["packed"] = bool(packed)
    ident["sources"] = None if sources is None else list(map(int, sources))
    ident["source_ids"] = (None if source_ids is None else
                           int(zlib.crc32(np.asarray(
                               source_ids, np.int64).tobytes())))
    return ident


class TileCheckpoint:
    """Atomic JSON checkpoint of a tiled run's partial aggregates."""

    def __init__(self, path):
        self.path = pathlib.Path(path)

    def load(self, fingerprint: Dict[str, object]) -> Optional[Dict]:
        """The saved state, or None when absent/corrupt/mismatched.

        A fingerprint mismatch raises — resuming a DIFFERENT run from this
        file is almost certainly an operator error, while a missing or
        torn file just means "start from scratch".
        """
        try:
            payload = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return None
        if payload.get("fingerprint") != fingerprint:
            raise ValueError(
                f"checkpoint {self.path} belongs to a different run "
                f"(fingerprint mismatch); delete it to start over")
        return payload["state"]

    def save(self, fingerprint: Dict[str, object], state: Dict) -> None:
        """Write-to-temp + rename: readers always see a complete file."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = json.dumps({"fingerprint": fingerprint, "state": state})
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=self.path.name + ".tmp.")
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def remove(self) -> None:
        """Delete the checkpoint (a completed run needs no resume point)."""
        try:
            self.path.unlink()
        except OSError:
            pass

"""Checkpointing with atomic commits, keep-k rotation and restore onto a
device.

The port of the JAX package's ``checkpoint/manager.py``, in the same
on-disk format, so a checkpoint written by either package restores in the
other bit for bit. Layout (one directory per step)::

  <root>/step_00000100.tmp/        # written first
      manifest.json                # step, time, extra, and per leaf its
                                   #  key, file, shape and dtype string
      arr_00000.npy ...            # one file per leaf, in the JAX order
  <root>/step_00000100/            # atomic rename on success

A leaf's key joins its dict keys with "/" (``params/layers/l0/attn/wq``,
``opt/step``), and leaves are numbered in the JAX package's order (keys
sorted at every level). bfloat16 leaves are stored through their uint16
view with the logical dtype ``"bfloat16"`` in the manifest. Directories
ending in ``.tmp`` (torn writes) are ignored.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.common import host_array, sorted_leaves, unflatten

__all__ = ["CheckpointManager", "save", "restore", "latest_step"]

_MANIFEST = "manifest.json"
_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
           torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH = {name: dt for dt, name in _DTYPES.items()}


def save(root: os.PathLike, step: int, tree: Any,
         extra: Optional[Dict] = None) -> pathlib.Path:
    """Write a checkpoint atomically; returns the committed directory."""
    root = pathlib.Path(root)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "leaves": []}
    for i, (key, leaf) in enumerate(sorted_leaves(tree)):
        arr = (host_array(leaf) if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        logical = (_DTYPES[leaf.dtype] if isinstance(leaf, torch.Tensor)
                   else str(arr.dtype))
        fname = f"arr_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape),
             "dtype": logical})
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    return final


def latest_step(root: os.PathLike) -> Optional[int]:
    root = pathlib.Path(root)
    if not root.exists():
        return None
    steps = []
    for d in root.iterdir():
        if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp"):
            if (d / _MANIFEST).exists():  # ignore torn checkpoints
                steps.append(int(d.name[5:]))
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.array(arr, order="C")  # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device=device, dtype=_TORCH[dtype])


def restore(root: os.PathLike, step: int, like: Any, device=None) -> Any:
    """Load checkpoint ``step`` into the structure of ``like`` (a tree of
    tensors or anything with a ``shape``; meta tensors do). Each leaf comes
    back in the file's dtype on ``device``, or where the leaf of ``like``
    lies when ``device`` is None (the CPU for a meta or non-tensor leaf);
    a leaf whose shape differs from ``like``'s raises."""
    root = pathlib.Path(root)
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / _MANIFEST).read_text())
    by_key = {rec["key"]: rec for rec in manifest["leaves"]}
    out = {}
    for key, leaf in sorted_leaves(like):
        rec = by_key.get(key)
        if rec is None:
            raise KeyError(f"checkpoint {d} missing leaf {key!r}")
        arr = np.load(d / rec["file"])
        want_shape = tuple(leaf.shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != expected {want_shape}")
        dev = device
        if dev is None:
            dev = (leaf.device if isinstance(leaf, torch.Tensor)
                   and leaf.device.type != "meta" else "cpu")
        out[key] = _tensor(arr, rec["dtype"], dev)
    return unflatten(out)


@dataclasses.dataclass
class CheckpointManager:
    """Keep-last-k rotation + convenience wrappers."""

    root: pathlib.Path
    keep: int = 3

    def __post_init__(self):
        self.root = pathlib.Path(self.root)
        self.root.mkdir(parents=True, exist_ok=True)

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        path = save(self.root, step, tree, extra)
        self._gc()
        return path

    def latest(self) -> Optional[int]:
        return latest_step(self.root)

    def restore_latest(self, like: Any, device=None):
        step = self.latest()
        if step is None:
            return None, None
        extra = json.loads(
            (self.root / f"step_{step:08d}" / _MANIFEST).read_text()
        )["extra"]
        return restore(self.root, step, like, device), {"step": step, **extra}

    def _gc(self):
        steps = sorted(
            int(d.name[5:]) for d in self.root.iterdir()
            if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

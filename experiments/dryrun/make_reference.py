"""Reference for the port's dry run, computed by the JAX package.

Writes ``experiments/dryrun/reference.json``: one record per cell of
``repro.launch.dryrun`` (the ten archs x the four shapes x the 16x16 and
2x16x16 meshes) and per ``repro.launch.hillclimb`` experiment, keyed
``<arch>__<shape>__<mesh><tag>`` as the JAX dry run names its files. A
record keeps what the port's dry run can be held to or set beside:

* ``arch``, ``shape``, ``mesh``, ``kind``, ``plan_notes``, ``status``
  (``ok``, ``skipped`` with its ``reason``, or ``failed`` with the
  exception's ``error``);
* ``memory``: XLA's ``memory_analysis()`` (argument, output and temp bytes
  a device, ``per_device_total_gb``);
* ``roofline``: ``roofline_report``'s fields (the loop-aware
  ``analytic_cost`` terms, ``model_flops``, XLA's collective count, wire
  bytes and terms) with ``raw_hlo_flops_once`` / ``raw_hlo_bytes_once``
  and ``analytic_detail``;
* ``xla_collective_bytes``: the parsed collectives' result bytes a device
  summed per HLO kind.

No HLO text, no collective list, no compile time. The JAX dry run must set
``XLA_FLAGS`` (512 host devices) before ``import jax``, so the cells run
in a subprocess of this script (``--worker``); the records it writes are
never the JAX dry run's own ``experiments/dryrun/*.json``.

  PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/dryrun/make_reference.py
  ... --worker OUT.json [KEY ...]   # the listed cells only, into OUT.json
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
OUT = ROOT / "experiments" / "dryrun" / "reference.json"


def cell_key(arch: str, shape: str, multi_pod: bool, tag: str = "") -> str:
    return f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}{tag}"


def experiments() -> dict:
    """``repro.launch.hillclimb.EXPERIMENTS``, read from its source: the
    module sets ``XLA_FLAGS`` (512 host devices) when imported, which must
    not leak into a process that runs JAX otherwise."""
    import ast

    src = ROOT / "src" / "repro" / "launch" / "hillclimb.py"
    for node in ast.parse(src.read_text()).body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "EXPERIMENTS"):
            return ast.literal_eval(node.value)
    raise LookupError(f"no EXPERIMENTS in {src}")


def cells() -> dict:
    """{key: (arch, shape, multi_pod, overrides, tag)}: the grid, then the
    hill-climb experiments (in ``EXPERIMENTS`` order)."""
    from repro.configs import ARCHS
    from repro.configs.base import SHAPES

    out = {}
    for arch in ARCHS:
        for shape in SHAPES:
            for multi in (False, True):
                out[cell_key(arch, shape, multi)] = (arch, shape, multi,
                                                     None, "")
    for arch, shape, multi, overrides, tag in experiments().values():
        out[cell_key(arch, shape, multi, tag)] = (arch, shape, multi,
                                                  dict(overrides), tag)
    return out


def summary(rec: dict) -> dict:
    """The reference's fields of one ``run_cell`` record."""
    out = {k: rec[k] for k in ("arch", "shape", "mesh", "kind", "plan_notes",
                               "status", "reason") if k in rec}
    if rec["status"] != "ok":
        return out
    out["memory"] = rec["memory"]
    out["roofline"] = rec["roofline"]
    by_kind: dict = {}
    for op in rec["collectives"]:
        by_kind[op["kind"]] = by_kind.get(op["kind"], 0) + op["result_bytes"]
    out["xla_collective_bytes"] = by_kind
    return out


def worker(path: str, keys) -> None:
    """Runs the cells ``keys`` (all when empty) through the JAX dry run and
    writes {key: record} to ``path``; prints one line a cell."""
    from repro.launch import dryrun  # sets XLA_FLAGS before jax loads

    dryrun._save = lambda rec, tag="": None  # never the JAX run's files
    grid = cells()
    out = {}
    for key in (keys or list(grid)):
        arch, shape, multi, overrides, tag = grid[key]
        t0 = time.time()
        try:
            rec = summary(dryrun.run_cell(arch, shape, multi, save=False,
                                          overrides=overrides, tag=tag))
        except Exception as e:  # noqa: BLE001 - a failure is a record
            first = (str(e).strip().splitlines() or [""])[0].replace(
                f"{ROOT}/", "")  # paths relative to the checkout
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if multi else "16x16",
                   "status": "failed",
                   "error": f"{type(e).__name__}: {first}"[:400]}
        out[key] = rec
        print(f"{rec['status']:8s} {key} {time.time() - t0:.1f} s",
              flush=True)
    pathlib.Path(path).write_text(json.dumps(out, indent=1, sort_keys=True,
                                             default=float) + "\n")


def run(keys=(), path=None) -> dict:
    """The records of ``keys`` (every cell when empty), computed in a
    subprocess of this script."""
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(path or pathlib.Path(tmp) / "cells.json")
        subprocess.run([sys.executable, __file__, "--worker", str(out),
                        *keys], env=env, check=True)
        return json.loads(out.read_text())


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        worker(argv[1], argv[2:])
        return
    t0 = time.time()
    recs = run()
    import jax

    OUT.write_text(json.dumps({"jax": jax.__version__, "cells": recs},
                              indent=1, sort_keys=True, default=float) + "\n")
    print(f"wrote {OUT} ({len(recs)} cells) in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()

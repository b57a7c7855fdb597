"""Holds the port's dry run to the JAX package's over the whole grid.

Runs ``repro_torch.launch.dryrun.run_cell`` on every cell of
``experiments/dryrun/reference.json`` (the ten archs x four shapes x two
meshes and the hill-climb registry), in ``--jobs`` processes, and checks
each record's shared fields against the reference with
``dryrun.compare_to_reference`` (status, skip reason, plan notes, the
analytic roofline, the JAX spec trees' argument bytes against XLA's).
Prints one line a cell beside XLA's numbers: the port's per-rank
collective count, input bytes and modelled wire bytes (``roofline``'s,
as XLA's), its temp (peak live) bytes, its trace time; writes them to
``experiments/dryrun/torch/held.json``. Everything runs on meta tensors
on the CPU (no card). The 32k-token prefill cells
trace 1024 flash blocks a layer (minutes to half an hour each);
``--skip prefill_32k`` leaves them out.

  PYTHONPATH=src python experiments/dryrun/hold_port.py --jobs 4 [--skip prefill_32k] [KEY ...]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "experiments" / "dryrun" / "reference.json"


def _cells():
    """{key: (arch, shape, multi_pod, overrides, tag)} from the port's
    registry (the same keys as the reference's)."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.hillclimb import EXPERIMENTS

    out = {}
    for arch in ARCHS:
        for shape in SHAPES:
            for multi in (False, True):
                out[f"{arch}__{shape}__{'2x16x16' if multi else '16x16'}"] = (
                    arch, shape, multi, None, "")
    for arch, shape, multi, overrides, tag in EXPERIMENTS.values():
        key = f"{arch}__{shape}__{'2x16x16' if multi else '16x16'}{tag}"
        out[key] = (arch, shape, multi, dict(overrides), tag)
    return out


def _one(item):
    key, (arch, shape, multi, overrides, tag), want = item
    import torch

    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    t0 = time.time()
    try:
        rec = dryrun.run_cell(arch, shape, multi, save=False,
                              overrides=overrides, tag=tag)
    except Exception as e:  # noqa: BLE001 - a failure is a result
        return key, {"status": "failed", "error": f"{type(e).__name__}: {e}",
                     "bad": [] if want["status"] == "failed" else
                     [f"failed where the reference is {want['status']}"]}
    out = {"status": rec["status"], "wall_s": round(time.time() - t0, 1)}
    if want["status"] == "failed":
        out["bad"] = []  # the JAX cell failed: nothing to hold
    else:
        out["bad"] = dryrun.compare_to_reference(rec, want)
    if rec["status"] == "ok":
        out.update(memory=rec["memory"],
                   collective_bytes=rec["collective_bytes"],
                   n_collectives=rec["roofline"]["n_collectives"],
                   wire_bytes=rec["roofline"]["collective_wire_bytes"],
                   trace_s=rec["trace_s"], port_notes=rec["port_notes"])
    return key, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--skip", action="append", default=[],
                    help="leave out cells whose shape is this")
    ap.add_argument("keys", nargs="*")
    args = ap.parse_args(argv)
    ref = json.loads(REFERENCE.read_text())["cells"]
    grid = _cells()
    if sorted(grid) != sorted(ref):
        raise SystemExit("the port's registry and the reference's cells differ")
    keys = args.keys or [k for k in grid
                         if k.split("__")[1] not in args.skip]
    items = [(k, grid[k], ref[k]) for k in keys]
    out_dir = ROOT / "experiments" / "dryrun" / "torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    held, n_bad = {}, 0
    t0 = time.time()
    with mp.get_context("spawn").Pool(args.jobs) as pool:
        for key, res in pool.imap_unordered(_one, items):
            held[key] = res
            n_bad += bool(res["bad"])
            want = ref[key]
            line = f"{'DIFF' if res['bad'] else 'held'} {key:48s} {res['status']:8s}"
            if res["status"] == "ok":
                m = res["memory"]
                xla = (f" (XLA {want['memory']['temp_bytes'] / 2**30:.2f} GiB, "
                       f"{want['roofline']['n_collectives']} collectives, wire "
                       f"{want['roofline']['collective_wire_bytes'] / 1e9:.3f}"
                       f" GB)" if want["status"] == "ok"
                       else f" (XLA {want['status']})")
                line += (f" temp {m['temp_bytes'] / 2**30:.2f} GiB, "
                         f"{res['n_collectives']} collectives in "
                         f"{sum(res['collective_bytes'].values()) / 1e9:.3f}"
                         f" GB, wire {res['wire_bytes'] / 1e9:.3f} GB{xla};"
                         f" trace {res['trace_s']} s")
            print(line + ("  " + "; ".join(res["bad"]) if res["bad"] else ""),
                  flush=True)
    (out_dir / "held.json").write_text(json.dumps(held, indent=1,
                                                  sort_keys=True))
    print(f"held {len(held) - n_bad} of {len(held)} cells "
          f"({n_bad} differ) in {time.time() - t0:.1f} s")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    raise SystemExit(main())

"""Device time of the resident tiled pump at ~100k routers, per family.

Runs the PyTorch port's extreme-scale sampled sweep (``sweep_extreme``,
32 sampled sources, the uint8 adjacency resident on the card) for each
named family and prints one JSON line per family with the ``tiled.tile``
span (the packed BFS levels of the 32-source tile), its level count and
milliseconds per level. ``--src`` picks the tree whose ``repro_torch`` is
imported, so two checkouts can be compared on one card in turns::

    python experiments/extreme/time_tiled.py --families torus,hammingmesh
    python experiments/extreme/time_tiled.py --src /path/to/other/src

Needs a CUDA device (the sweep runs its kernels); the first line is the
card's name and power limit as ``nvidia-smi`` prints them.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--families", default="torus,hammingmesh")
    ap.add_argument("--target", type=int, default=100_000)
    ap.add_argument("--label", default=None,
                    help="tag for the output lines (default: --src)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_tiled: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch import obs
    from repro_torch.core import sweep as SW

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    obs.enable()
    for fam in args.families.split(","):
        obs.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = SW.sweep_extreme([fam], target_routers=args.target,
                               k_sources=32, seed=0,
                               adjacency_budget=24 << 30, device="cuda")
        wall = time.perf_counter() - t0
        (row,) = res["rows"]
        spans = obs.span_summary()
        levels = sum(ev["args"].get("levels") or 0 for ev in obs.events()
                     if ev.get("name") == "tiled.tile")
        tile_ms = spans["tiled.tile"]["total_ms"]
        print(json.dumps({
            "label": args.label or args.src, "family": row["family"],
            "routers": row["routers"], "levels": levels,
            "tile_ms": tile_ms, "ms_per_level": tile_ms / max(1, levels),
            "family_ms": spans["sweep.extreme.family"]["total_ms"],
            "wall_s": wall, "avg_spl": row["avg_spl"],
            "mult_mean": row["mult_mean"]}))
    obs.disable()
    return 0


if __name__ == "__main__":
    sys.exit(main())

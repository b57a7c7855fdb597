"""Host time to size and build each topology family at a router target.

Runs ``topology.solve(family, n_routers, target)`` and ``topology.make``
of the PyTorch port (numpy generators, no device) once per family, each
in its own process with a time limit, and prints one JSON line per
family: routers built and seconds, or the limit when it was reached.
This is what sets which families ``chip_smoke.py`` phase 7 drives at
~100k routers::

    PYTHONPATH=src python experiments/extreme/time_generators.py \
        --target 100000 --limit 120
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import queue
import time


def _build(family: str, target: int, out) -> None:
    from repro_torch.core import topology as T

    t0 = time.perf_counter()
    params = T.solve(family, lambda s: s.n_routers, target, "closest")
    g = T.make(family, **params)
    out.put({"routers": g.n, "name": g.name,
             "seconds": round(time.perf_counter() - t0, 2)})


def main(argv=None) -> int:
    from repro_torch.core import topology as T

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", type=int, default=100_000)
    ap.add_argument("--limit", type=float, default=120.0,
                    help="seconds before a family's build is stopped")
    ap.add_argument("--families", default=None,
                    help="comma-separated (default: all registered)")
    args = ap.parse_args(argv)
    fams = args.families.split(",") if args.families else T.families()
    ctx = mp.get_context("spawn")
    for fam in fams:
        out = ctx.Queue()
        proc = ctx.Process(target=_build, args=(fam, args.target, out))
        proc.start()
        try:  # drain the queue before joining its writer
            row = {"family": fam, **out.get(timeout=args.limit)}
        except queue.Empty:
            row = ({"family": fam, "seconds": f"more than {args.limit:g}"}
                   if proc.is_alive() else
                   {"family": fam, "error": f"exit {proc.exitcode}"})
            proc.kill()
        proc.join()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Reference for the extreme-scale path, computed by the JAX package.

Writes ``experiments/extreme/reference.json``:

* ``sweep``: ``sweep_extreme(target_routers=4096, k_sources=32, seed=0,
  throughput=True)`` over all 12 registered families — 32 sampled exact
  source rows each through the packed tiled engine, with bootstrap CIs and
  the sampled ECMP throughput bound (a family whose ladder cannot reach
  the target keeps its ``error`` row);
* ``tiled_summary``: ``tiled_summary(jellyfish n=4096 r=16 seed=0,
  sources=(0, 256), packed=True)``, the out-of-core aggregate.

Timings (``elapsed_s``, ``peak_rss_mb``) are dropped: they describe the
host that ran this script, not the result. It imports the JAX package only
and runs on the CPU (Pallas kernels in interpret mode)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/extreme/make_reference.py

The PyTorch port is held to this file by ``tests/test_torch_extreme.py``
and ``chip_smoke.py``.
"""
from __future__ import annotations

import json
import pathlib
import time

from repro.core import topology as T
from repro.core.analysis.distributed import tiled_summary
from repro.core.sweep import sweep_extreme

OUT = pathlib.Path(__file__).resolve().parent / "reference.json"
SWEEP = {"target_routers": 4096, "k_sources": 32, "seed": 0,
         "throughput": True}
TILED = {"family": "jellyfish", "n": 4096, "r": 16, "seed": 0,
         "sources": [0, 256], "packed": True}
#: keys that are timings of the host that made the file
TIMINGS = ("elapsed_s", "peak_rss_mb")


def _drop_timings(d):
    return {k: v for k, v in d.items() if k not in TIMINGS}


def main():
    import jax

    t0 = time.perf_counter()
    sweep = sweep_extreme(**SWEEP)
    print(f"sweep_extreme: {time.perf_counter() - t0:.1f} s", flush=True)
    g = T.make(TILED["family"], n=TILED["n"], r=TILED["r"],
               seed=TILED["seed"])
    t0 = time.perf_counter()
    summary = tiled_summary(g, sources=tuple(TILED["sources"]),
                            packed=TILED["packed"])
    print(f"tiled_summary: {time.perf_counter() - t0:.1f} s", flush=True)
    doc = {
        "generated_by": "experiments/extreme/make_reference.py",
        "jax": jax.__version__,
        "sweep_settings": SWEEP,
        "sweep": dict(_drop_timings(sweep),
                      rows=[_drop_timings(r) for r in sweep["rows"]]),
        "tiled_settings": TILED,
        "tiled_summary": _drop_timings(summary),
    }
    OUT.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()

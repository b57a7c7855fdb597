"""Full-width reference for the analysis path, computed by the JAX package.

Writes ``experiments/analysis/reference.json``:

* ``reports``: ``AnalysisEngine(g).report()`` over the default stages plus
  ``comparison`` for the six families of ``examples/topology_analysis.py``
  at ~10k servers (slimfly, jellyfish, xpander, hyperx, dragonfly,
  fattree);
* ``throughput``: ``AnalysisEngine(g, throughput_demand="all-pairs",
  throughput_eps=0.5, throughput_rounds=32).throughput()`` for slimfly and
  fattree at ~2k servers, with the (E,) link loads reduced to their sum
  and maximum.

It imports the JAX package only and runs on the CPU (Pallas kernels in
interpret mode), in a few minutes::

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/analysis/make_reference.py

The PyTorch port is held to this file by ``tests/test_torch_analysis.py``
and ``chip_smoke.py``.
"""
from __future__ import annotations

import json
import pathlib
import time

import numpy as np

from repro.core import topology as T
from repro.core.analysis import AnalysisEngine

OUT = pathlib.Path(__file__).resolve().parent / "reference.json"
FAMILIES = ("slimfly", "jellyfish", "xpander", "hyperx", "dragonfly",
            "fattree")
THROUGHPUT_FAMILIES = ("slimfly", "fattree")
#: the example's throughput settings (examples/topology_analysis.py)
THROUGHPUT = {"throughput_demand": "all-pairs", "throughput_eps": 0.5,
              "throughput_rounds": 32}


def _plain(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def reports():
    out = {}
    for fam in FAMILIES:
        g = T.by_servers(fam, 10_000)
        t0 = time.perf_counter()
        rep = AnalysisEngine(g).report(AnalysisEngine.DEFAULT_STAGES
                                       + ("comparison",))
        print(f"{fam}: {g.n} routers, {time.perf_counter() - t0:.1f} s",
              flush=True)
        out[fam] = {k: _plain(v) for k, v in rep.items()}
    return out


def throughputs():
    out = {}
    for fam in THROUGHPUT_FAMILIES:
        g = T.by_servers(fam, 2_000)
        t0 = time.perf_counter()
        res = dict(AnalysisEngine(g, **THROUGHPUT).throughput())
        loads = np.asarray(res.pop("link_loads"))
        res["link_loads_sum"] = float(loads.sum())
        res["link_loads_max"] = float(loads.max())
        res["routers"] = g.n
        res["name"] = g.name
        print(f"{fam} throughput: {g.n} routers, {res['rounds']} rounds, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out[fam] = {k: _plain(v) for k, v in res.items()}
    return out


def main():
    import jax

    doc = {
        "generated_by": "experiments/analysis/make_reference.py",
        "jax": jax.__version__,
        "servers": {"reports": 10_000, "throughput": 2_000},
        "throughput_settings": THROUGHPUT,
        "reports": reports(),
        "throughput": throughputs(),
    }
    OUT.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()

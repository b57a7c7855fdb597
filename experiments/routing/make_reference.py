"""Full-width reference for the routing path, computed by the JAX package.

Writes ``experiments/routing/reference.json``:

* ``families``: for the six families of ``examples/topology_analysis.py``
  at ~10k servers (slimfly, jellyfish, xpander, hyperx, dragonfly,
  fattree), the example's routing row: routers, diameter, the
  ``evaluate_workload`` report of ``permutation:flows=2048`` (sampled
  loads and the exact expected ECMP loads), and ``link_load_stats`` of the
  ECMP (``UniformShortest``), Valiant and slack-1 loads of the same
  demand, each model on its f64 path (``use_kernel=False``) over the
  engine's distances and multiplicities, as the example runs them; plus
  each model's loads at 64 fixed link ids;
* ``throughput``: ``max_concurrent_flow`` of slimfly at ~2k servers under
  the ``permutation:flows=256`` spec (eps 0.5, 32 rounds, seed 0), with
  the (E,) link loads reduced to their sum and maximum.

It imports the JAX package only and runs on the CPU (Pallas kernels in
interpret mode)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python experiments/routing/make_reference.py

The PyTorch port is held to this file by ``tests/test_torch_routing.py``
and ``chip_smoke.py`` phase 10.
"""
from __future__ import annotations

import json
import pathlib
import time

import numpy as np

from repro.core import routing as R
from repro.core import topology as T
from repro.core import workload as W
from repro.core.analysis import AnalysisEngine
from repro.core.traffic import TrafficSpec

OUT = pathlib.Path(__file__).resolve().parent / "reference.json"
FAMILIES = ("slimfly", "jellyfish", "xpander", "hyperx", "dragonfly",
            "fattree")
SERVERS = 10_000
WORKLOAD = "permutation:flows=2048"
LINK_IDS = 64
#: phase 10d: a TrafficSpec demand in max_concurrent_flow
THROUGHPUT = {"family": "slimfly", "servers": 2_000,
              "demand": "permutation:flows=256", "eps": 0.5,
              "max_rounds": 32, "seed": 0}


def _plain(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def link_ids(num_edges: int) -> np.ndarray:
    """The fixed link ids whose loads the reference keeps."""
    return np.unique(np.linspace(0, num_edges - 1, LINK_IDS).round()
                     .astype(np.int64))


def family_row(fam: str) -> dict:
    g = T.by_servers(fam, SERVERS)
    eng = AnalysisEngine(g)
    dist = eng.distances()
    mult = eng.multiplicities()["multiplicity"]
    spec = TrafficSpec.parse(WORKLOAD)
    wl = W.Workload(pairs=spec.pairs(g), name=spec.describe())
    report = W.evaluate_workload(g, wl, dist=dist, mult=mult)
    demand = wl.demand_matrix(g)
    ids = link_ids(g.num_edges)
    models = {
        "ecmp": R.UniformShortest.from_engine(eng, use_kernel=False),
        "valiant": R.ValiantVLB.from_engine(eng, use_kernel=False),
        "slack1": R.SlackRouting.from_engine(eng, slack=1,
                                             use_kernel=False),
    }
    row = {"routers": g.n, "name": g.name,
           "diameter": int(dist[np.isfinite(dist)].max()),
           "workload": {k: _plain(v) for k, v in report.items()},
           "link_ids": ids.tolist(), "models": {}}
    for key, model in models.items():
        loads = model.link_loads(demand)
        row["models"][key] = {
            "stats": {k: _plain(v) for k, v in
                      R.link_load_stats(loads, g.num_edges).items()},
            "loads": loads[ids].tolist()}
    return row


def throughput() -> dict:
    g = T.by_servers(THROUGHPUT["family"], THROUGHPUT["servers"])
    res = dict(R.max_concurrent_flow(
        g, THROUGHPUT["demand"], eps=THROUGHPUT["eps"],
        max_rounds=THROUGHPUT["max_rounds"], seed=THROUGHPUT["seed"]))
    loads = np.asarray(res.pop("link_loads"))
    res["link_loads_sum"] = float(loads.sum())
    res["link_loads_max"] = float(loads.max())
    res["routers"] = g.n
    res["name"] = g.name
    return {k: _plain(v) for k, v in res.items()}


def main():
    import jax

    t_all = time.perf_counter()
    families = {}
    for fam in FAMILIES:
        t0 = time.perf_counter()
        families[fam] = family_row(fam)
        print(f"{fam}: {families[fam]['routers']} routers, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tp = throughput()
    print(f"throughput: {tp['routers']} routers, {tp['rounds']} rounds, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    doc = {
        "generated_by": "experiments/routing/make_reference.py",
        "jax": jax.__version__,
        "servers": SERVERS,
        "workload": WORKLOAD,
        "throughput_settings": THROUGHPUT,
        "families": families,
        "throughput": tp,
    }
    OUT.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT} in {time.perf_counter() - t_all:.1f} s")


if __name__ == "__main__":
    main()

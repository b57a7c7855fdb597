"""The port's row-sharded and composed engines vs the JAX package's, on the CPU.

The port's mesh is P gloo ranks on the host (`distributed.launch_mesh`,
``device="cpu"``): one module fixture per mesh size (2 and 4) spawns the
ranks once, each running `mesh_ranks.engine_cases` — every case below —
and rank 0 writes one ``.npz``. The JAX package's sharded engines run on
meshes of 2 and 4 fake CPU devices in one subprocess (this file as a
script under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``) that
writes another, while the ranks run. Each test then compares one case,
so every case still counts.

Tolerances: dist, mult, packed cells, tile bounds, telemetry (levels and
per-level sizes) and the sweep's integer columns are bit-equal, to the
JAX package's sharded engines and to the single-device engines of both
packages; ``avg_spl`` / ``mult_mean`` follow from bit-equal matrices
through the same numpy, so they are equal too. ECMP loads divide by
sigma and sum the ranks' partials in another order: rtol 1e-5 (ROADMAP).
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

import jax

from repro.core import sweep as RSW
from repro.core import topology as RT
from repro.core.analysis import AnalysisEngine as RAnalysisEngine
from repro.core.analysis import apsp_dense as r_apsp_dense
from repro.core.analysis import distributed as RD
from repro.core.analysis import wavefront as RWF
from repro.core.analysis.paths import (
    shortest_path_multiplicity as r_shortest_path_multiplicity,
)
from repro.core.graph import Graph as RGraph
from repro.core.routing.assign import ecmp_all_pairs_loads as r_ecmp_loads
from repro_torch.core import topology as T
from repro_torch.core.analysis import distributed as D
from repro_torch.core.analysis import mesh_ranks as MR
from repro_torch.core.analysis import wavefront as WF
from repro_torch.core.routing.assign import ecmp_all_pairs_loads

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: seconds a mesh or the JAX reference may take before it is killed
TIMEOUT = 240
SHARDS = (2, 4)
RTOL = 1e-5


# -- the JAX package's reference (this file as a script) -------------------------

def _jax_reference(out_path):
    """Every case on the JAX package's meshes of 2 and 4 fake devices,
    under ``P<size>/`` keys, and its ``mesh="auto"`` engine under
    ``auto/``."""
    out = {}
    for shards in SHARDS:
        mesh = RD.device_mesh(shards)
        k = f"P{shards}/"
        for name in ("slimfly", "indivisible", "disconnected", "edgeless"):
            adj = MR.build_graph(MR.GRAPHS[name], RT.make,
                                 RGraph).adjacency_dense(np.float32)
            out[k + f"dist_mult/{name}/dist"], \
                out[k + f"dist_mult/{name}/mult"] = \
                RD.sharded_dist_mult(adj, mesh)
        stack = MR.build_stack(RT.make)
        sd, sm = RD.sharded_dist_mult(stack, mesh)
        out[k + "dist_mult/stack/dist"], out[k + "dist_mult/stack/mult"] = \
            sd, sm
        for name, adj in (("indivisible", MR.build_graph(
                MR.GRAPHS["indivisible"], RT.make).adjacency_dense(
                    np.float32)), ("stack", stack)):
            p, _, block = RD.pad_block_sharded(adj.shape[-1], shards,
                                               batched=adj.ndim == 3)
            x = jax.numpy.asarray(RWF.pad_operand(adj, p, 0.0))
            *_, aux = RD.dist_mult_sharded(x, mesh, block=block,
                                           telemetry=True)
            out[k + f"telemetry/{name}"] = np.array(
                json.dumps(RWF.telemetry_attrs(aux)))
        g = MR.build_graph(MR.GRAPHS["loads"], RT.make)
        d, m = RWF.wavefront_dist_mult(g.adjacency_dense(np.float32))
        out[k + "loads/loads"] = np.asarray(r_ecmp_loads(
            d, m, g.adjacency_dense(np.float64), mesh=mesh))
        out[k + "loads/stack"] = np.asarray(r_ecmp_loads(sd, sm, stack,
                                                         mesh=mesh))
        g = MR.build_graph(MR.GRAPHS["indivisible"], RT.make)
        for packed in (False, True):
            key = k + ("composed/packed/" if packed else "composed/f32/")
            (out[key + "dist"], out[key + "mult"],
             out[key + "bounds"]) = MR._assemble(
                RD.composed_dist_mult_tiles(
                    g, mesh, tile_rows=MR.COMPOSED_TILE_ROWS,
                    packed=packed), g.n, g.n)
        gs = RT.make(MR.SAMPLED[0], **MR.SAMPLED[1])
        (out[k + "composed/sampled/dist"], out[k + "composed/sampled/mult"],
         out[k + "composed/sampled/bounds"]) = MR._assemble(
            RD.composed_dist_mult_tiles(gs, mesh, tile_rows=3,
                                        source_ids=list(MR.SAMPLED_IDS)),
            len(MR.SAMPLED_IDS), gs.n)
        g = MR.build_graph(MR.GRAPHS["slimfly"], RT.make)
        try:
            next(RD.composed_dist_mult_tiles(g, mesh, adjacency_budget=1))
        except ValueError as exc:
            out[k + "composed/budget/error"] = np.array(str(exc))
        p = RD._pad128(g.n)
        p += (-p) % (shards * 128)
        (out[k + "composed/budget/dist"], out[k + "composed/budget/mult"],
         _) = MR._assemble(RD.composed_dist_mult_tiles(
            g, mesh, adjacency_budget=p * p // shards, packed=True),
            g.n, g.n)
        g = MR.build_graph(MR.GRAPHS["composed"], RT.make)
        out[k + "apsp/composed"] = r_apsp_dense(g, mesh=mesh, tile_rows=32)
        out[k + "paths/composed/dist"], out[k + "paths/composed/mult"] = \
            r_shortest_path_multiplicity(g, mesh=mesh, tile_rows=32)
        rows = RSW.sweep(graphs=MR.sweep_graphs(RT.by_servers), budget=0.0,
                         mesh=mesh)["rows"]
        for col in _SWEEP_COLS:
            out[k + f"sweep/mesh/{col}"] = np.array([r[col] for r in rows])
    g = MR.build_graph(MR.GRAPHS["auto"], RT.make)
    e = RAnalysisEngine(g)                 # mesh="auto": the 4 devices
    out["auto/shards"] = np.array(RD.default_mesh(g.n).size)
    out["auto/dist"], out["auto/mult"] = e.distances(), e.shortest_path_mult()
    np.savez(out_path, **out)


_SWEEP_COLS = ("routers", "diameter", "avg_spl", "mult_mean", "mult_min",
               "tput_lb", "reachable_frac")


# -- fixtures --------------------------------------------------------------------

class _Reference:
    """The JAX reference subprocess, started at once and read on first use."""

    def __init__(self, out_path):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        self.path = out_path
        self.proc = subprocess.Popen(
            [sys.executable, __file__, str(out_path)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._data = None

    def get(self):
        if self._data is None:
            _, err = self.proc.communicate(timeout=TIMEOUT)
            assert self.proc.returncode == 0, err[-4000:]
            self._data = dict(np.load(self.path))
        return self._data

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("jax") / "reference.npz")
    yield ref
    ref.close()


@pytest.fixture(scope="module", params=SHARDS, ids=lambda p: f"P{p}")
def port(request, jax_ref, tmp_path_factory):
    """(shards, the port's cases on a mesh of that many gloo ranks)."""
    path = tmp_path_factory.mktemp(f"port{request.param}") / "cases.npz"
    D.launch_mesh(MR.engine_cases, request.param, str(path), device="cpu",
                  timeout_s=TIMEOUT)
    return request.param, dict(np.load(path))


def _ref(jax_ref, shards, key):
    return jax_ref.get()[f"P{shards}/{key}"]


def _graph(name):
    return MR.build_graph(MR.GRAPHS[name])


def _equal(x, w):
    assert x.dtype == w.dtype and x.shape == w.shape, (x.dtype, w.dtype)
    np.testing.assert_array_equal(x, w)


# -- the row-sharded wavefront ---------------------------------------------------

@pytest.mark.parametrize("name", ["slimfly", "indivisible", "disconnected",
                                  "edgeless", "stack"])
def test_sharded_dist_mult_bit_equal(port, jax_ref, name):
    shards, got = port
    adj = (MR.build_stack() if name == "stack"
           else _graph(name).adjacency_dense(np.float32))
    want_d, want_m = WF.wavefront_dist_mult(adj, device="cpu")
    for what, want in (("dist", want_d), ("mult", want_m)):
        x = got[f"dist_mult/{name}/{what}"]
        _equal(x, want)
        _equal(x, _ref(jax_ref, shards, f"dist_mult/{name}/{what}"))


def test_sharded_disconnected_and_edgeless(port):
    _, got = port
    dist, mult = got["dist_mult/disconnected/dist"], \
        got["dist_mult/disconnected/mult"]
    assert np.isinf(dist[0, 3]) and mult[0, 3] == 0
    assert dist[0, 2] == 2 and mult[0, 2] == 1
    dist2, mult2 = got["dist_mult/edgeless/dist"], \
        got["dist_mult/edgeless/mult"]
    off = ~np.eye(4, dtype=bool)
    assert np.isinf(dist2[off]).all() and (mult2[off] == 0).all()
    assert (np.diag(dist2) == 0).all() and (np.diag(mult2) == 1).all()


@pytest.mark.parametrize("name", ["indivisible", "stack"])
def test_sharded_telemetry_matches(port, jax_ref, name):
    shards, got = port
    attrs = json.loads(str(got[f"telemetry/{name}"]))
    assert attrs == json.loads(str(_ref(jax_ref, shards, f"telemetry/{name}")))
    dist = got[f"dist_mult/{name}/dist"]
    if name == "stack":
        for i, (fam, params) in enumerate(MR.STACK):
            n = T.make(fam, **params).n
            d = dist[i, :n, :n]
            diam = int(d[np.isfinite(d)].max())
            assert attrs["levels_per_graph"][i] == diam
            sizes = attrs["frontier_sizes_per_graph"][i]
            assert sizes[:diam] == [int((d == k).sum())
                                    for k in range(1, diam + 1)]
            assert not any(sizes[diam:])
        return
    diam = int(dist[np.isfinite(dist)].max())
    assert attrs["converged_level"] == diam
    assert attrs["levels"] == diam + 1
    assert attrs["frontier_sizes"] == [int((dist == k).sum())
                                       for k in range(1, diam + 1)]


# -- the sharded Brandes loads ---------------------------------------------------

@pytest.mark.parametrize("name", ["loads", "stack"])
def test_sharded_loads_match(port, jax_ref, name):
    shards, got = port
    if name == "stack":
        adj = MR.build_stack()
        dist, mult = WF.wavefront_dist_mult(adj, device="cpu")
    else:
        g = _graph(name)
        adj = g.adjacency_dense(np.float64)
        dist, mult = WF.wavefront_dist_mult(g.adjacency_dense(np.float32),
                                            device="cpu")
    want = ecmp_all_pairs_loads(dist, mult, adj, device="cpu").numpy()
    x = got[f"loads/{name}"]
    assert x.dtype == np.float32 and x.shape == want.shape
    for w in (want, _ref(jax_ref, shards, f"loads/{name}")):
        np.testing.assert_allclose(x, w, rtol=RTOL, atol=RTOL)
        assert abs(x.max() - w.max()) <= RTOL * max(1.0, w.max())


# -- the composed engine ---------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["f32", "packed"])
def test_composed_bit_equal_to_tiled(port, jax_ref, packed):
    shards, got = port
    key = "composed/packed/" if packed else "composed/f32/"
    g = _graph("indivisible")
    tiles = list(D.tiled_dist_mult_tiles(g, tile_rows=MR.COMPOSED_TILE_ROWS,
                                         packed=packed, device="cpu"))
    want_d = np.concatenate([t[2] for t in tiles])
    want_m = np.concatenate([t[3] for t in tiles])
    assert want_d.dtype == (np.int16 if packed else np.float32)
    for what, want in (("dist", want_d), ("mult", want_m)):
        _equal(got[key + what], want)
        _equal(got[key + what], _ref(jax_ref, shards, key + what))
    _equal(got[key + "bounds"], _ref(jax_ref, shards, key + "bounds"))


def test_composed_source_ids_sampled_rows(port, jax_ref):
    shards, got = port
    want_d, want_m = D.tiled_dist_mult(T.make(MR.SAMPLED[0], **MR.SAMPLED[1]),
                                       device="cpu")
    ids = list(MR.SAMPLED_IDS)
    assert got["composed/sampled/bounds"].tolist() == [[0, 3], [3, 5]]
    _equal(got["composed/sampled/dist"], want_d[ids])
    _equal(got["composed/sampled/mult"], want_m[ids])
    for what in ("dist", "mult", "bounds"):
        _equal(got[f"composed/sampled/{what}"],
               _ref(jax_ref, shards, f"composed/sampled/{what}"))


def test_composed_budget_bounds_the_per_device_panel(port, jax_ref):
    shards, got = port
    assert str(got["composed/budget/error"]) == str(
        _ref(jax_ref, shards, "composed/budget/error"))
    want_d, want_m = D.tiled_dist_mult(_graph("slimfly"), packed=True,
                                       device="cpu")
    _equal(got["composed/budget/dist"], want_d)
    _equal(got["composed/budget/mult"], want_m)


def test_mesh_and_tile_rows_compose_through_apsp_dense(port, jax_ref):
    shards, got = port
    want_d, want_m = WF.wavefront_dist_mult(
        _graph("composed").adjacency_dense(np.float32), device="cpu")
    _equal(got["apsp/composed"], want_d)
    _equal(got["paths/composed/dist"], want_d)
    _equal(got["paths/composed/mult"], want_m)
    for key in ("apsp/composed", "paths/composed/dist",
                "paths/composed/mult"):
        _equal(got[key], _ref(jax_ref, shards, key))


# -- the callers: the sweep and the engine ---------------------------------------

@pytest.mark.parametrize("mesh", ["mesh", "auto"])
def test_sweep_rows_match_single_device(port, jax_ref, mesh):
    shards, got = port
    for col in _SWEEP_COLS:
        x, single = got[f"sweep/{mesh}/{col}"], got[f"sweep/none/{col}"]
        ref = _ref(jax_ref, shards, f"sweep/mesh/{col}")
        if col == "tput_lb":
            np.testing.assert_allclose(x, single, rtol=RTOL)
            np.testing.assert_allclose(x, ref, rtol=RTOL)
        else:
            _equal(x, single)
            _equal(x, ref)


def test_engine_auto_mesh_matches_pinned_single_device(port, jax_ref):
    _, got = port
    ref = jax_ref.get()
    # jellyfish(200) keeps whole row tiles on two shards, on both sides
    assert int(got["engine/auto/shards"]) == int(ref["auto/shards"]) == 2
    for what in ("dist", "mult"):
        _equal(got[f"engine/auto/{what}"], got[f"engine/none/{what}"])
        _equal(got[f"engine/auto/{what}"], ref[f"auto/{what}"])


def test_device_mesh_needs_enough_ranks(port):
    shards, got = port
    assert str(got["mesh/too_many"]).startswith(
        f"mesh wants {shards + 1} ranks, the process group has {shards}")


# -- without a group, in this process --------------------------------------------

def test_shard_count_and_padding_helpers():
    for n in (1, 100, 128, 129, 300, 1000, 5000):
        for cap in (1, 2, 3, 8):
            assert D.best_shard_count(n, max_shards=cap) == \
                RD.best_shard_count(n, max_shards=cap)
    assert D.best_shard_count(1000, max_shards=8) == 8
    assert D.best_shard_count(300, max_shards=8) == 3
    for n, shards in ((50, 2), (137, 4), (1000, 8), (2025, 2)):
        assert D.pad_block_sharded(n, shards, block=128) == \
            RD.pad_block_sharded(n, shards, block=128)
        p, row, col = D.pad_block_sharded(n, shards)
        assert p % (shards * 128) == 0 and p % col == 0 and \
            (p // shards) % row == 0 and p >= n
    with pytest.raises(ValueError, match="pad_block_sharded"):
        D._check_padded(200, 2)


def test_no_group_is_the_single_device_path():
    assert D.device_mesh() is None and D.device_mesh(1) is None
    assert D.default_mesh(10_000, device="cpu") is None
    assert D.best_shard_count(10_000) == 1
    with pytest.raises(ValueError, match="mesh wants 2 ranks"):
        D.device_mesh(2, device="cpu")
    g = _graph("slimfly")
    adj = g.adjacency_dense(np.float32)
    want_d, want_m = WF.wavefront_dist_mult(adj, device="cpu")
    for mesh in (None, D.device_mesh(1)):
        d, m = D.sharded_dist_mult(adj, mesh, device="cpu")
        _equal(d, want_d)
        _equal(m, want_m)
    tiles = list(D.composed_dist_mult_tiles(g, None, tile_rows=16,
                                            device="cpu"))
    want = list(D.tiled_dist_mult_tiles(g, tile_rows=16, device="cpu"))
    assert [t[:2] for t in tiles] == [t[:2] for t in want]
    for (_, _, d, m), (_, _, wd, wm) in zip(tiles, want):
        _equal(d, wd)
        _equal(m, wm)


def test_launch_mesh_raises_a_rank_failure(tmp_path):
    # analysis_cases on no graph fails on every rank: the first failure
    # ends the mesh and its traceback is raised here
    with pytest.raises(RuntimeError, match=r"(?s)rank \d of 2 failed.*"
                                           r"AttributeError"):
        D.launch_mesh(MR.analysis_cases, 2, str(tmp_path / "x.npz"), None,
                      device="cpu", timeout_s=TIMEOUT)


def _clocks(mesh):
    """Every rank's clock when its body began (a `start_mesh` body)."""
    import torch.distributed as tdist

    out = [None] * mesh.size
    tdist.all_gather_object(out, time.time())
    return out


def test_started_ranks_wait_for_their_go():
    # start_mesh's ranks join the group and wait: no rank's body begins
    # before result() lets them run
    run = D.start_mesh(_clocks, 2, device="cpu", timeout_s=TIMEOUT)
    clocks = run.result()
    assert len(clocks) == 2 and min(clocks) >= run.t_go
    assert not any(proc.is_alive() for proc in run.procs)


def test_launch_mesh_kills_ranks_past_the_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="ran past"):
        D.launch_mesh(MR.engine_cases, 2, str(tmp_path / "x.npz"),
                      device="cpu", timeout_s=0.5)
    assert time.monotonic() - t0 < 30
    assert not (tmp_path / "x.npz").exists()


def test_cuda_default_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.launch_mesh(MR.engine_cases, 2, "unused.npz")


if __name__ == "__main__":
    _jax_reference(sys.argv[1])

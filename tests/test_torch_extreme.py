"""The port's extreme-scale path vs the JAX package's, on the CPU.

The single-device tiled engine (resident and streamed, fp32 and packed
cells), the sampled-sources estimator, the extreme sweep, the
checkpointed summary and the engine selection. Graphs come from each
package's own generator with the same parameters (their equality is
tests/test_torch_topology.py's business); the JAX engines run their Pallas
kernels in interpret mode, the port its kernels' plain versions on CPU
tensors.

Tolerances: dist and mult are integers, held bit-equal, dtypes included.
The estimator's and the sweep's float aggregates come from identical rows
through identical numpy code, and are held to rtol 1e-12.
"""
import json
import pathlib
import types
import warnings

import numpy as np
import pytest
import torch

from repro.core import sweep as RSW
from repro.core import topology as RT
from repro.core.analysis import AnalysisEngine as RAnalysisEngine
from repro.core.analysis import distributed as RD
from repro.core.analysis.estimator import (
    sampled_sources_summary as r_sampled_sources_summary,
)
from repro.core.graph import Graph as RGraph
from repro_torch.core import sweep as SW
from repro_torch.core import topology as T
from repro_torch.core.analysis import AnalysisEngine, apsp_dense
from repro_torch.core.analysis import distributed as D
from repro_torch.core.analysis import wavefront as WF
from repro.core.analysis.engine_select import (
    resolve_engine as r_resolve_engine,
)
from repro_torch.core.analysis.engine_select import resolve_engine
from repro_torch.core.analysis.estimator import sampled_sources_summary
from repro_torch.core.analysis.paths import shortest_path_multiplicity
from repro_torch.core.graph import Graph
from repro_torch.kernels import semiring as S

REFERENCE = (pathlib.Path(__file__).resolve().parents[1] / "experiments"
             / "extreme" / "reference.json")
#: keys that time the run instead of describing its result
TIMINGS = ("elapsed_s", "peak_rss_mb")
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    S.reset_launches()
    yield
    assert not any(S.launches.values()), S.launches


def _pair(fam, **params):
    return RT.make(fam, **params), T.make(fam, **params)


def _assert_tiles_equal(got, want):
    assert len(got) == len(want)
    for (r0, r1, d, m), (w0, w1, wd, wm) in zip(got, want):
        assert (r0, r1) == (w0, w1)
        for x, w in ((d, wd), (m, wm)):
            assert x.dtype == w.dtype and x.shape == w.shape
            np.testing.assert_array_equal(x, w)


def _assert_same(got, want, path="", rtol=RTOL):
    """Equal dicts/lists: ints, bools, strings and None exact; floats to
    ``rtol``; timing keys skipped."""
    if isinstance(want, dict):
        keys = set(want) - set(TIMINGS)
        assert set(got) - set(TIMINGS) == keys, (path, sorted(got), sorted(want))
        for k in keys:
            _assert_same(got[k], want[k], f"{path}.{k}", rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]", rtol)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=rtol, abs=0.0), path
    else:
        assert got == want and type(got) is type(want), (path, got, want)


# -- the tiled engine ------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["f32", "packed"])
@pytest.mark.parametrize("budget", [1 << 28, 1], ids=["resident", "streamed"])
def test_tiled_tiles_bit_equal(packed, budget):
    """Tile rows not dividing n, 128-row panels over 384 padded columns
    (three panels per level when streamed)."""
    rg, g = _pair("jellyfish", n=300, r=8, seed=0)
    kw = dict(tile_rows=100, panel_rows=128, adjacency_budget=budget,
              packed=packed)
    want = list(RD.tiled_dist_mult_tiles(rg, **kw))
    got = list(D.tiled_dist_mult_tiles(g, device="cpu", **kw))
    _assert_tiles_equal(got, want)


@pytest.mark.parametrize("packed", [False, True], ids=["f32", "packed"])
def test_tiled_source_ids_and_sources(packed):
    rg, g = _pair("slimfly", q=13)
    ids = [1, 9, 33, 34, 80, 337]
    for kw in (dict(source_ids=ids, tile_rows=4),
               dict(sources=(32, 64), tile_rows=16, adjacency_budget=1)):
        want = list(RD.tiled_dist_mult_tiles(rg, packed=packed, **kw))
        got = list(D.tiled_dist_mult_tiles(g, packed=packed, device="cpu",
                                           **kw))
        _assert_tiles_equal(got, want)


def test_tiled_dense_source_and_disconnected_graph():
    edges = np.array([(0, 1), (1, 2), (3, 4), (4, 5)])
    rg, g = RGraph(n=6, edges=edges), Graph(n=6, edges=edges)
    for packed in (False, True):
        for budget in (1 << 28, 1):
            want = RD.tiled_dist_mult(rg, tile_rows=4, packed=packed,
                                      adjacency_budget=budget)
            got = D.tiled_dist_mult(g, tile_rows=4, packed=packed,
                                    adjacency_budget=budget, device="cpu")
            _assert_tiles_equal([(0, 6, *got)], [(0, 6, *want)])
    # a dense (n, n) array is a source too
    dense = rg.adjacency_dense(np.float32)
    want = RD.tiled_dist_mult(dense, tile_rows=4, adjacency_budget=1)
    got = D.tiled_dist_mult(dense, tile_rows=4, adjacency_budget=1,
                            device="cpu")
    _assert_tiles_equal([(0, 6, *got)], [(0, 6, *want)])


def test_tiled_saturation_clamps_in_both_pumps():
    """Counts past 2**24 clamp at MULT_SAT in the resident step and in the
    streamed pump's mask alike — never wrap — as in the JAX pump."""
    width, stages = 48, 5
    edges, node, prev = [], 1, 0
    for _ in range(stages):
        mids = list(range(node, node + width))
        tail = node + width
        node = tail + 1
        edges += [(prev, v) for v in mids] + [(v, tail) for v in mids]
        prev = tail
    rg, g = RGraph(n=node, edges=np.array(edges)), Graph(
        n=node, edges=np.array(edges))
    for budget in (1 << 28, 1):
        want = RD.tiled_dist_mult(rg, tile_rows=64, packed=True,
                                  adjacency_budget=budget)
        got = D.tiled_dist_mult(g, tile_rows=64, packed=True,
                                adjacency_budget=budget, device="cpu")
        _assert_tiles_equal([(0, node, *got)], [(0, node, *want)])
        assert int(got[1][0, stages * (width + 1)]) == S.MULT_SAT
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s = D.tiled_summary(g, tile_rows=64, packed=True, device="cpu")
    assert s["saturated"] is True


def test_tiled_summary_matches():
    rg, g = _pair("jellyfish", n=200, r=6, seed=1)
    for kw in (dict(tile_rows=64), dict(tile_rows=48, packed=True,
                                        adjacency_budget=1),
               dict(tile_rows=3, source_ids=[3, 9, 17, 40, 77, 99, 120])):
        want = RD.tiled_summary(rg, **kw)
        got = D.tiled_summary(g, device="cpu", **kw)
        _assert_same(got, want)


def test_tiled_checkpoint_kill_and_resume_bit_identical(tmp_path):
    _, g = _pair("jellyfish", n=300, r=6, seed=1)
    clean = D.tiled_summary(g, tile_rows=64, packed=True, device="cpu")
    ck = tmp_path / "run.ckpt.json"
    seen = [0]

    class Kill(Exception):
        pass

    def killer(r0, r1, d, m):
        seen[0] += 1
        if seen[0] == 3:
            raise Kill

    with pytest.raises(Kill):
        D.tiled_summary(g, tile_rows=64, packed=True, on_tile=killer,
                        checkpoint=str(ck), device="cpu")
    state = json.loads(ck.read_text())["state"]
    assert state["tiles"] == 2 and state["rows_done"] == 128
    resumed_tiles = []
    resumed = D.tiled_summary(
        g, tile_rows=64, packed=True, checkpoint=str(ck), device="cpu",
        on_tile=lambda r0, r1, d, m: resumed_tiles.append((r0, r1)))
    assert resumed_tiles[0][0] == 128 and not ck.exists()
    for key in ("diameter", "reached_pairs", "avg_spl", "mult_mean",
                "mult_min", "mult_max", "rows_analyzed", "tiles",
                "saturated"):
        assert clean[key] == resumed[key], key


def test_bfs_oracle_and_spot_check_rows():
    rg, g = _pair("torus", dims=(4, 5))
    want_d, want_m = D.tiled_dist_mult(g, packed=True, device="cpu")
    for s in (0, 7, g.n - 1):
        od, osig = D.oracle_rows(g, s, packed=True)
        np.testing.assert_array_equal(want_d[s], od)
        np.testing.assert_array_equal(want_m[s], osig)
        rd, rsig = RD.bfs_dist_sigma(rg, s)
        np.testing.assert_array_equal(D.bfs_dist_sigma(g, s)[0], rd)
        np.testing.assert_array_equal(D.bfs_dist_sigma(g, s)[1], rsig)


def test_block_helpers_match():
    for size, cap in ((104960, 16384), (131072, 16384), (640, 16384),
                      (128, 16384), (104960, 128), (99840, 2048)):
        assert D.widest_divisor_block(size, cap) == RD.widest_divisor_block(
            size, cap)
    for n in (1, 127, 128, 129, 99_999):
        assert D._pad128(n) == RD._pad128(n)


def test_cli_runs_and_spot_checks(capsys):
    assert D.main(["--family", "jellyfish", "--routers", "150",
                   "--degree", "6", "--tile-rows", "40", "--packed",
                   "--adjacency-budget", "1", "--check", "3",
                   "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "spot-check OK sources=3" in printed
    out = json.loads(printed[printed.index("\n{") + 1:])
    assert out["routers"] == 150 and out["rows_analyzed"] == 150
    assert out["adjacency_streamed"] is True and out["packed"] is True


# -- the estimator and the extreme sweep -----------------------------------------

@pytest.mark.parametrize("throughput", [False, True])
def test_sampled_sources_summary_matches(throughput):
    rg, g = _pair("jellyfish", n=256, r=8, seed=2)
    kw = dict(k=16, seed=3, tile_rows=6, throughput=throughput)
    want = r_sampled_sources_summary(rg, **kw)
    got = sampled_sources_summary(g, device="cpu", **kw)
    _assert_same(got, want)


def test_sampled_sources_streamed_f32_matches():
    rg, g = _pair("dragonfly", h=2)
    kw = dict(k=12, seed=1, packed=False, adjacency_budget=1)
    _assert_same(sampled_sources_summary(g, device="cpu", **kw),
                 r_sampled_sources_summary(rg, **kw))


def test_sweep_extreme_rows_match():
    kw = dict(target_routers=500, k_sources=8, seed=0)
    want = RSW.sweep_extreme(["slimfly", "torus"], **kw)
    got = SW.sweep_extreme(["slimfly", "torus"], device="cpu", **kw)
    _assert_same(got, want)
    table = SW.format_extreme_table(got)
    assert "slimfly" in table and "torus" in table


def test_sweep_extreme_unreachable_target_error_row():
    kw = dict(target_routers=10**9, k_sources=4)
    want = RSW.sweep_extreme(["polarfly"], **kw)
    got = SW.sweep_extreme(["polarfly"], device="cpu", **kw)
    _assert_same(got, want)
    assert "error" in got["rows"][0]
    assert "SKIP" in SW.format_extreme_table(got)


def test_sweep_cli_extreme(capsys):
    assert SW.main(["--extreme", "300", "--families", "hypercube",
                    "--sample-sources", "4", "--device", "cpu"]) == 0
    assert "hypercube" in capsys.readouterr().out


# -- engine selection and the analysis entry points ------------------------------

_MESH = types.SimpleNamespace(size=2)


@pytest.mark.parametrize("kw,engine", [
    (dict(), "wavefront"), (dict(packed=True), "wavefront"),
    (dict(tile_rows=64), "tiled"), (dict(tile_rows=64, packed=True), "tiled"),
    (dict(source_ids=[1, 2]), "tiled"),
    (dict(use_kernel=False), "squaring")])
def test_engine_select_ported_plans_pass(kw, engine):
    plan = resolve_engine(**kw)
    assert plan.engine == engine


@pytest.mark.parametrize("kw", [dict(mesh=_MESH),
                                dict(mesh=_MESH, tile_rows=64),
                                dict(mesh=_MESH, packed=True)],
                         ids=["sharded", "composed-tiled", "composed-packed"])
def test_engine_select_sharded_and_composed_raise(kw):
    # the name is kept from when these plans raised; since the mesh engines
    # are ported they resolve, as the JAX package resolves them
    plan, want = resolve_engine(**kw), r_resolve_engine(**kw)
    assert plan.engine == want.engine in ("sharded", "composed")
    assert (plan.mesh, plan.tile_rows, plan.packed) == \
        (want.mesh, want.tile_rows, want.packed)


def _rows(out):
    """The extreme table's family rows without the seconds column."""
    lines = out.strip().splitlines()[3:]
    return [line.rsplit(None, 1)[0] for line in lines]


def test_sharded_entry_points_raise(capsys):
    # the name is kept from when --shards raised: it now runs the composed
    # engine on two gloo ranks and prints the rows of the unsharded run
    args = ["--extreme", "300", "--sample-sources", "8", "--device", "cpu"]
    assert SW.main(args) == 0
    want = _rows(capsys.readouterr().out)
    assert SW.main(args + ["--shards", "2"]) == 0
    got = _rows(capsys.readouterr().out)
    assert len(got) == 12 and got == want


@pytest.mark.parametrize("kw", [dict(tile_rows=16), dict(packed=True),
                                dict(tile_rows=16, packed=True)],
                         ids=["tiled", "packed", "tiled-packed"])
def test_engine_distances_and_mult_match(kw):
    rg, g = _pair("slimfly", q=5)
    want = RAnalysisEngine(rg, mesh=None, **kw)
    got = AnalysisEngine(g, device="cpu", **kw)
    for name in ("distances", "shortest_path_mult"):
        w, x = getattr(want, name)(), getattr(got, name)()
        assert x.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(x, w)


def test_callsite_knobs_route_to_the_tiled_engine():
    rg, g = _pair("dragonfly", h=2)
    want_d, want_m = WF.wavefront_dist_mult(rg.adjacency_dense(np.float32),
                                            device="cpu")
    np.testing.assert_array_equal(
        apsp_dense(g, tile_rows=16, device="cpu").numpy(), want_d)
    d, m = shortest_path_multiplicity(g, tile_rows=16, device="cpu")
    np.testing.assert_array_equal(d, want_d)
    np.testing.assert_array_equal(m, want_m)
    d, m = shortest_path_multiplicity(g, packed=True, device="cpu")
    assert d.dtype == np.int16 and m.dtype == np.uint32
    np.testing.assert_array_equal(
        np.where(d == S.DIST_UNREACHED, np.inf, d).astype(np.float32), want_d)


def test_extreme_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, g = _pair("slimfly", q=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(D.tiled_dist_mult_tiles(g))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampled_sources_summary(g, k=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SW.sweep_extreme(["slimfly"], target_routers=50, k_sources=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WF.wavefront_dist_mult(g.adjacency_dense(np.float32), packed=True)


# -- the committed reference -----------------------------------------------------

def _reference():
    return json.loads(REFERENCE.read_text())


def test_reference_is_complete():
    ref = _reference()
    assert sorted(r["family"].split("(")[0] for r in ref["sweep"]["rows"]
                  ) == sorted(T.families())
    assert ref["sweep_settings"] == {"target_routers": 4096,
                                     "k_sources": 32, "seed": 0,
                                     "throughput": True}
    assert ref["tiled_summary"]["rows_analyzed"] == 256


def _reproduce_sweep_row(family):
    ref = _reference()
    (want,) = [r for r in ref["sweep"]["rows"]
               if r["family"].split("(")[0] == family]
    got = SW.sweep_extreme([family], device="cpu", **ref["sweep_settings"])
    (row,) = got["rows"]
    _assert_same(json.loads(json.dumps(row)), want, family, rtol=1e-9)


@pytest.mark.parametrize("family", ["hammingmesh", "hypercube"])
def test_reference_sweep_rows_reproduce(family):
    _reproduce_sweep_row(family)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["dragonfly", "fattree", "hyperx",
                                    "jellyfish", "megafly", "oft",
                                    "polarfly", "slimfly", "torus",
                                    "xpander"])
def test_reference_sweep_rows_reproduce_slow(family):
    _reproduce_sweep_row(family)


@pytest.mark.slow
def test_reference_tiled_summary_reproduces():
    ref = _reference()
    st = ref["tiled_settings"]
    g = T.make(st["family"], n=st["n"], r=st["r"], seed=st["seed"])
    got = D.tiled_summary(g, sources=tuple(st["sources"]),
                          packed=st["packed"], device="cpu")
    _assert_same(json.loads(json.dumps(got)), ref["tiled_summary"],
                 rtol=1e-9)

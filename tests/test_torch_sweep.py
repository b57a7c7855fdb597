"""repro_torch.core.sweep vs the JAX package's sweep and its committed table.

The port runs on CPU tensors here (its kernels' plain versions). Tolerances
follow the sweep's columns: integer columns exact; ``avg_spl``,
``mult_mean``, ``cost`` and ``power_kw`` within rtol 1e-9 (the same host
arithmetic on bit-equal dist/mult); ``tput_lb`` within rtol 1e-5 (1 / max
ECMP load, f32 round-off).
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import sweep as RS
from repro.core import topology as RT
from repro_torch import obs
from repro_torch.core import sweep as S
from repro_torch.core.graph import graph_from_arrays
from repro_torch.kernels import semiring as K

ROOT = pathlib.Path(__file__).resolve().parents[1]
_EXACT = ("routers", "servers", "radix", "diameter", "cables_electrical",
          "cables_optical")
_CLOSE = ("avg_spl", "mult_mean", "cost", "power_kw")


def _assert_rows_match(got_rows, want_rows):
    got = {r["family"]: r for r in got_rows}
    want = {r["family"]: r for r in want_rows}
    assert got.keys() == want.keys()
    for fam, w in want.items():
        g = got[fam]
        for col in _EXACT:
            assert g[col] == w[col], (fam, col)
        for col in _CLOSE:
            np.testing.assert_allclose(g[col], w[col], rtol=1e-9,
                                       err_msg=f"{fam}.{col}")
        np.testing.assert_allclose(g["tput_lb"], w["tput_lb"], rtol=1e-5,
                                   err_msg=f"{fam}.tput_lb")


def _carry(r):
    """A JAX-package graph rebuilt in the port from plain arrays."""
    s = r.spec
    fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    fields["link_classes"] = [dataclasses.asdict(lc)
                              for lc in s.link_classes]
    return graph_from_arrays(r.n, np.asarray(r.edges), r.concentration,
                             r.name, fields)


@pytest.fixture(scope="module")
def committed():
    K.reset_launches()
    out = S.sweep(ref=("slimfly", 2000), max_routers=200, device="cpu")
    assert not any(K.launches.values()), K.launches
    return out


def test_committed_configuration_reproduces_table(committed):
    want = json.loads(
        (ROOT / "experiments" / "sweep" / "comparison.json").read_text())
    assert len(committed["rows"]) == 12
    np.testing.assert_allclose(committed["budget"], want["budget"],
                               rtol=1e-12)
    _assert_rows_match(committed["rows"], want["rows"])
    assert committed["device"] == "cpu" and committed["use_kernel"]


def test_matches_reference_oracle_on_carried_graphs(committed):
    rgraphs, _ = RS.equal_cost_graphs(ref=("slimfly", 2000),
                                           max_routers=200)
    want = RS.sweep(graphs=rgraphs, use_kernel=False, mesh=None)
    got = S.sweep(graphs=[_carry(g) for g in rgraphs], device="cpu")
    _assert_rows_match(got["rows"], want["rows"])
    _assert_rows_match(committed["rows"], want["rows"])


def test_small_stack_matches_reference_kernel_path():
    rgraphs = [RT.make("slimfly", q=5), RT.make("torus", dims=(7, 6)),
               RT.make("hypercube", dim=6), RT.make("dragonfly", h=2)]
    assert max(g.n for g in rgraphs) <= 64
    want = RS.sweep(graphs=rgraphs, use_kernel=True, mesh=None)
    got = S.sweep(graphs=[_carry(g) for g in rgraphs], device="cpu")
    _assert_rows_match(got["rows"], want["rows"])
    plain = S.sweep(graphs=[_carry(g) for g in rgraphs], device="cpu",
                    use_kernel=False)
    assert plain["rows"] == got["rows"]


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.sweep(graphs=[RT.make("slimfly", q=5)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.main(["--families", "slimfly", "--ref-servers", "200",
                "--max-routers", "64"])


def test_check_flag(capsys):
    assert S.check_families() == []
    assert S.main(["--check"]) == 0
    assert "12 families OK" in capsys.readouterr().out


def test_out_and_trace_flags(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    try:
        rc = S.main(["--families", "slimfly,torus,hypercube",
                     "--ref-servers", "200", "--max-routers", "64",
                     "--device", "cpu", "--out", str(tmp_path / "o"),
                     "--trace", str(trace)])
    finally:
        obs.disable()
        obs.reset()
    assert rc == 0
    table = (tmp_path / "o" / "comparison.txt").read_text()
    assert table.startswith("equal-cost sweep")
    assert table.strip() in capsys.readouterr().out
    result = json.loads((tmp_path / "o" / "comparison.json").read_text())
    assert {r["family"] for r in result["rows"]} == {"slimfly", "torus",
                                                     "hypercube"}
    for r in result["rows"]:
        assert r["wavefront_levels"] == r["diameter"]
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"sweep", "sweep.build", "sweep.stack", "sweep.dist_mult",
            "sweep.ecmp_loads", "sweep.download", "sweep.rows"} <= names


def test_format_table_covers_all_rows(committed):
    table = S.format_table(committed)
    for r in committed["rows"]:
        assert r["family"] in table
    assert "tput-lb" in table.splitlines()[1]

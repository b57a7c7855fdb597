"""``obs.log`` prints once per mesh: inside a process group of several
ranks only rank 0 prints, and every rank records the trace event. The
sharded extreme sweep's CLI (two gloo ranks on the CPU) prints each
``[sweep.*]`` line once, as the JAX package's one process does."""
import collections
import os
import pathlib
import re
import subprocess
import sys
import types

import pytest

from repro_torch import obs
from repro_torch.obs import trace

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _group(rank, world):
    return types.SimpleNamespace(
        is_available=lambda: True, is_initialized=lambda: True,
        get_world_size=lambda: world, get_rank=lambda: rank)


@pytest.mark.parametrize("rank, world, prints", [(0, 2, True), (1, 2, False),
                                                 (3, 4, False), (0, 1, True)])
def test_log_prints_on_rank_zero_only(monkeypatch, capsys, rank, world, prints):
    monkeypatch.setitem(sys.modules, "torch.distributed", _group(rank, world))
    obs.enable()
    obs.reset()
    try:
        obs.log("unit.event", k=1)
        events = [e for e in obs.events() if e.get("name") == "unit.event"]
    finally:
        obs.disable()
    assert (capsys.readouterr().out == "[unit.event] k=1\n") == prints
    assert len(events) == 1


def test_log_prints_without_a_process_group(monkeypatch, capsys):
    monkeypatch.delitem(sys.modules, "torch.distributed", raising=False)
    assert not trace._other_rank()
    obs.log("unit.alone")
    assert capsys.readouterr().out == "[unit.alone]\n"


def test_sharded_sweep_cli_prints_each_line_once(tmp_path):
    """--shards 2 on two gloo ranks: the skipped family's line and the
    trace's line once each, and the table once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    trace_path = tmp_path / "trace.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.sweep", "--extreme", "300",
         "--families", "slimfly,nosuch", "--sample-sources", "4",
         "--shards", "2", "--device", "cpu", "--trace", str(trace_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = collections.Counter(
        m.group(1) for m in re.finditer(r"^\[(sweep[.\w]*)\]", out.stdout,
                                        re.M))
    assert lines == {"sweep.extreme.skip": 1, "sweep.trace": 1}, out.stdout
    assert out.stdout.count("extreme-scale sampled sweep") == 1
    assert "slimfly" in out.stdout and trace_path.exists()

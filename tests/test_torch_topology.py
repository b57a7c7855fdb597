"""repro_torch's copied host layer vs the JAX package's, on the CPU.

Topology generators, specs, sizers and the cost model are numpy-only and
copied into the port, so they must agree exactly: adjacencies bit-equal
(the seeded jellyfish and xpander included), spec fields equal, and
``by_cost`` / ``cost_report`` returning equal results.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import costmodel as RC
from repro.core import topology as RT
from repro_torch.core import costmodel as C
from repro_torch.core import topology as T
from repro_torch.core.graph import graph_from_arrays

_MAX_ROUTERS = 600


def _rungs(fam):
    """The family's ladder rungs of at most ``_MAX_ROUTERS`` routers."""
    out = []
    for i in range(64):
        try:
            params = T.ladder_params(fam, i)
            s = T.spec(fam, **params)
        except (IndexError, ValueError):
            break
        if s.n_routers <= _MAX_ROUTERS:
            out.append(params)
        elif out:
            break
    return out


def _spec_dict(s):
    return dataclasses.asdict(s)


def test_same_families():
    assert T.families() == RT.families()
    assert len(T.families()) == 12


@pytest.mark.parametrize("fam", RT.families())
def test_ladder_graphs_bit_equal(fam):
    rungs = _rungs(fam)
    assert rungs, fam
    for params in rungs:
        g, r = T.make(fam, **params), RT.make(fam, **params)
        assert (g.n, g.name, g.concentration, g.num_servers) == \
            (r.n, r.name, r.concentration, r.num_servers)
        np.testing.assert_array_equal(g.edges, r.edges)
        np.testing.assert_array_equal(g.adjacency_dense(np.float32),
                                      r.adjacency_dense(np.float32))
        assert _spec_dict(g.spec) == _spec_dict(r.spec)
        assert C.cost_report(g.spec) == RC.cost_report(r.spec)


@pytest.mark.parametrize("budget", [4e5, 2e6, 6.553e6])
def test_by_cost_and_cost_report_agree(budget):
    for fam in RT.families():
        try:
            want = RT.by_cost(fam, budget, max_routers=_MAX_ROUTERS,
                              params_only=True)
        except ValueError:
            with pytest.raises(ValueError):
                T.by_cost(fam, budget, max_routers=_MAX_ROUTERS,
                          params_only=True)
            continue
        got = T.by_cost(fam, budget, max_routers=_MAX_ROUTERS,
                        params_only=True)
        assert got == want, fam
        assert C.cost_report(T.spec(fam, **got)) == \
            RC.cost_report(RT.spec(fam, **want))


@pytest.mark.parametrize("fam", ["fattree", "jellyfish", "hammingmesh",
                                 "torus"])
def test_graph_from_arrays_carries_a_graph_across(fam):
    r = RT.by_servers(fam, 200)
    s = r.spec
    fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    fields["link_classes"] = [dataclasses.asdict(lc)
                              for lc in s.link_classes]
    g = graph_from_arrays(r.n, np.asarray(r.edges), r.concentration, r.name,
                          fields)
    np.testing.assert_array_equal(g.edges, r.edges)
    assert g.num_servers == r.num_servers
    assert g.radix == r.radix
    assert _spec_dict(g.spec) == _spec_dict(s)
    assert C.cost_report(g.spec) == RC.cost_report(s)
    assert g.spec.describe() == s.describe()
    plain = graph_from_arrays(3, [[0, 1], [1, 2]], 1, "path")
    assert plain.spec is None and plain.num_edges == 2

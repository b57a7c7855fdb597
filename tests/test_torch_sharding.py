"""The port's sharding plans, spec trees, meta trees and launch cost models
against the JAX package's, bit for bit (no ranks).

* ``sharding.rules``: every arch on {16x16, 2x16x16, 2x2, 1x4, 1x1} x
  ``fsdp`` in {True, "pod_data", False} x ``seq_parallel`` in {None, True,
  False}: rules, batch / seq / cache-seq axes, notes, the hidden and batch
  specs, and every parameter's spec (a mesh stand-in with only ``shape``,
  as ``tests/test_sharding.py``'s ``_FakeMesh``);
* ``sharding.partition``: ``train_state_shardings``,
  ``params_only_shardings``, ``batch_shardings`` and
  ``decode_input_shardings`` for every arch x shape on the production
  meshes (the JAX side on an ``AbstractMesh``), on ``specs.input_specs``
  trees;
* ``configs.specs``: paths, shapes and dtypes of ``input_specs``,
  ``abstract_params_tree`` and ``abstract_train_state`` for every arch x
  shape;
* ``launch.analytic`` and ``launch.roofline``: ``analytic_cost`` and
  ``model_flops`` on every applicable arch x shape x chip count,
  ``parse_collectives``, ``collective_seconds`` and ``roofline_report``
  on ``tests/test_sharding.py``'s HLO snippet; ``bubble_fraction``.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS, get_config as jget_config
from repro.configs import specs as jspecs
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import analytic as janalytic
from repro.launch import roofline as jroofline
from repro.models import steps as jsteps
from repro.models.common import Spec as JSpec
from repro.sharding import partition as jpartition
from repro.sharding import pipeline as jpipeline
from repro.sharding import rules as jrules
from repro_torch.configs import get_config
from repro_torch.configs import specs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import analytic, roofline
from repro_torch.models import steps
from repro_torch.models.common import tree_leaves
from repro_torch.sharding import partition, pipeline, rules

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
          "1x1": {"data": 1, "model": 1}}
FSDP = (True, "pod_data", False)
SEQ_PARALLEL = (None, True, False)
PRODUCTION = ("16x16", "2x16x16")


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _jax_flat(tree):
    """{"a/b/c": leaf} of a JAX pytree (dict keys joined as the port's
    ``tree_leaves`` joins them)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)
            or isinstance(x, JSpec))[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path)] = leaf
    return out


def _spec(sharding):
    return tuple(sharding.spec if hasattr(sharding, "spec") else sharding)


def _specs_equal(port_tree, jax_tree):
    want = {k: _spec(v) for k, v in _jax_flat(jax_tree).items()}
    got = {k: tuple(v) for k, v in tree_leaves(port_tree)}
    assert got == want


# -- rules -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_plans_and_param_specs_bit_equal(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    pspecs = steps.model_param_specs(cfg)
    jspecs_tree = jsteps.model_param_specs(jcfg)
    for name, shape in MESHES.items():
        mesh = _FakeMesh(shape)
        for fsdp in FSDP:
            for sp in SEQ_PARALLEL:
                plan = rules.make_plan(cfg, mesh, fsdp=fsdp, seq_parallel=sp)
                jplan = jrules.make_plan(jcfg, mesh, fsdp=fsdp,
                                         seq_parallel=sp)
                what = (name, fsdp, sp)
                assert plan.rules == jplan.rules, what
                assert plan.batch_axes == jplan.batch_axes, what
                assert plan.seq_axis == jplan.seq_axis, what
                assert plan.cache_seq_axis == jplan.cache_seq_axis, what
                assert plan.notes == jplan.notes, what
                assert tuple(plan.hidden_pspec()) == tuple(
                    jplan.hidden_pspec()), what
                for nd in (1, 2, 3):
                    assert tuple(plan.batch_pspec(nd)) == tuple(
                        jplan.batch_pspec(nd)), what
                for key in ("data", "model", ("data", "model"), None):
                    if key is None or all(k in shape for k in (
                            key if isinstance(key, tuple) else (key,))):
                        assert plan.axis_size(key) == jplan.axis_size(key)
                got = {k: tuple(rules.spec_to_pspec(s, plan))
                       for k, s in tree_leaves(pspecs)}
                want = {k: tuple(jrules.spec_to_pspec(s, jplan))
                        for k, s in _jax_flat(jspecs_tree).items()}
                assert got == want, what
                assert {k: tuple(v) for k, v in tree_leaves(
                    rules.param_shardings(pspecs, plan))} == want, what


def test_partition_spec_compares_to_the_jax_spec():
    from jax.sharding import PartitionSpec as JP

    for entries in [(), (None,), ("data", None), (("pod", "data"), "model"),
                    (None, None, ("data", "model"), None, None)]:
        assert rules.P(*entries) == tuple(JP(*entries))
        assert rules.P(*entries) == entries


# -- partition ---------------------------------------------------------------------

def _plans(arch, name):
    shape = MESHES[name]
    plan = rules.make_plan(get_config(arch), _FakeMesh(shape))
    amesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    jplan = jrules.make_plan(jget_config(arch), amesh)
    return plan, jplan


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_bit_equal(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in PRODUCTION:
        plan, jplan = _plans(arch, name)
        _specs_equal(partition.train_state_shardings(cfg, plan),
                     jpartition.train_state_shardings(jcfg, jplan))
        _specs_equal(partition.params_only_shardings(cfg, plan),
                     jpartition.params_only_shardings(jcfg, jplan))
        for shape in SHAPES:
            inputs = specs.input_specs(cfg, shape)
            jinputs = jspecs.input_specs(jcfg, shape)
            if specs.step_kind(shape) == "decode":
                _specs_equal(
                    partition.decode_input_shardings(cfg, plan, inputs),
                    jpartition.decode_input_shardings(jcfg, jplan, jinputs))
            else:
                _specs_equal(partition.batch_shardings(cfg, plan, inputs),
                             jpartition.batch_shardings(jcfg, jplan, jinputs))


def test_decode_specs_spread_the_long_cache_over_every_axis():
    """long_500k's batch of one: the cache's sequence over (data, model)
    where heads cannot shard (partition.py:121-160's branch)."""
    cfg = get_config("jamba-1.5-large-398b")
    plan, _ = _plans("jamba-1.5-large-398b", "16x16")
    tree = partition.decode_input_shardings(
        cfg, plan, specs.input_specs(cfg, "long_500k"))
    kv = [tuple(v) for k, v in tree_leaves(tree) if k.endswith("/k")]
    assert kv and all(s[2] is not None for s in kv), kv


def test_seq_axis_for_is_the_jax_maybe_constrain_rule():
    """The JAX ``maybe_constrain(x, "hidden")`` shards a stream's sequence
    over ``plan.seq_axis`` where the sequence divides it; the port's
    training forward takes the same axis (`seq_axis_for`) under a context
    with ``seq`` set, and keeps the stream whole elsewhere (serving)."""
    for arch in ("gemma-2b", "granite-moe-1b-a400m"):
        plan, jplan = _plans(arch, "16x16")
        assert plan.seq_axis == jplan.seq_axis == "model"
        n = jplan.axis_size(jplan.seq_axis)
        for s in (4096, 4095, 48, 30):
            want = jplan.seq_axis if s % n == 0 else None
            with partition.activation_ctx(plan, seq=True):
                assert partition.current_plan() is plan
                assert partition.seq_axis_for(s) == want, (arch, s)
            with partition.activation_ctx(plan):
                assert partition.seq_axis_for(s) is None
    assert partition.current_plan() is None
    assert partition.seq_axis_for(4096) is None


# -- specs ---------------------------------------------------------------------

def _meta(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree_leaves(tree)}


def _abstract(tree):
    return {k: (tuple(v.shape), str(np.dtype(v.dtype)))
            for k, v in _jax_flat(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trees_bit_equal(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert _meta(specs.abstract_train_state(cfg)) == _abstract(
        jspecs.abstract_train_state(jcfg))
    for dt in (None, "float32"):
        assert _meta(specs.abstract_params_tree(cfg, dt)) == _abstract(
            jspecs.abstract_params_tree(jcfg, dt))
    for shape in SHAPES:
        assert specs.cell_is_applicable(cfg, shape) == \
            jspecs.cell_is_applicable(jcfg, shape)
        assert specs.step_kind(shape) == jspecs.step_kind(shape)
        got = specs.input_specs(cfg, shape)
        assert all(v.device.type == "meta" for _, v in tree_leaves(got))
        assert _meta(got) == _abstract(jspecs.input_specs(jcfg, shape)), shape


# -- analytic and roofline -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_cost_and_model_flops_bit_equal(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, sh in SHAPES.items():
        if not specs.cell_is_applicable(cfg, name)[0]:
            continue
        jsh = JSHAPES[name]
        for chips in (1, 4, 256, 512):
            got = analytic.analytic_cost(cfg, sh, chips).to_dict()
            want = janalytic.analytic_cost(jcfg, jsh, chips).to_dict()
            assert got == want, (name, chips)
        assert roofline.model_flops(cfg, sh) == jroofline.model_flops(jcfg,
                                                                      jsh)


HLO_SNIPPET = """
  %all-gather.1 = f32[8,4096,3072]{2,1,0} all-gather(%x), channel_id=1, replica_groups=[32,16]<=[512], dimensions={2}, use_global_device_ids=true
  %all-reduce.2 = bf16[1024,512]{1,0} all-reduce(%y), replica_groups=[16,32]<=[32,16]T(1,0), to_apply=%add
  %collective-permute.3 = f32[128]{0} collective-permute(%z), source_target_pairs={{0,1},{1,2}}
  %all-to-all.4 = (bf16[4,64]{1,0}, bf16[4,64]{1,0}) all-to-all(%a, %b), replica_groups={{0,1},{2,3}}
  %reduce-scatter.5 = f32[256]{0} reduce-scatter(%w), replica_groups=[2,2]<=[4], dimensions={0}
"""


HLO_SMALL = """
  %all-gather.1 = f32[8,64]{1,0} all-gather(%x), channel_id=1, replica_groups=[2,2]<=[4], dimensions={1}, use_global_device_ids=true
  %all-reduce.2 = bf16[32,16]{1,0} all-reduce(%y), replica_groups=[2,2]<=[2,2]T(1,0), to_apply=%add
  %all-to-all.3 = (f32[4,64]{1,0}, f32[4,64]{1,0}) all-to-all(%a, %b), replica_groups={{0,1},{2,3}}
  %collective-permute.4 = f32[128]{0} collective-permute(%z), source_target_pairs={{0,2},{2,0}}
  %all-reduce-start.5 = f32[64]{0} all-reduce-start(%w), replica_groups=[1,4]<=[4], to_apply=%add
"""


@pytest.mark.parametrize("hlo,mesh", [
    (HLO_SNIPPET, {"pod": 2, "data": 16, "model": 16}),
    (HLO_SMALL, {"data": 2, "model": 2})], ids=["2x16x16", "2x2"])
def test_roofline_bit_equal(hlo, mesh):
    ops = [o.to_dict() for o in roofline.parse_collectives(hlo, mesh)]
    jops = [o.to_dict() for o in jroofline.parse_collectives(hlo, mesh)]
    assert ops == jops and len(ops) == 5
    port_ops = roofline.parse_collectives(hlo, mesh)
    jax_ops = jroofline.parse_collectives(hlo, mesh)
    assert roofline.collective_seconds(port_ops, mesh) == \
        jroofline.collective_seconds(jax_ops, mesh)
    kw = dict(flops=1e18, hlo_bytes=1e12, mesh_shape=mesh, mflops=0.6e18)
    assert roofline.roofline_report(ops=port_ops, **kw) == \
        jroofline.roofline_report(ops=jax_ops, **kw)


def test_bubble_fraction_bit_equal():
    for s in range(1, 9):
        for m in range(1, 17):
            assert pipeline.bubble_fraction(s, m) == \
                jpipeline.bubble_fraction(s, m)


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch import mesh as M

    with pytest.raises(ValueError, match=r"256 ranks"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match=r"512 ranks"):
        M.make_production_mesh(multi_pod=True, device="cpu")
    one = M.make_debug_mesh((1, 1), device="cpu")
    assert one.shape == {"data": 1, "model": 1} and one.coords == {
        "data": 0, "model": 0}
    plan = rules.make_plan(get_config("gemma-2b").reduced(), one)
    jplan = jrules.make_plan(jget_config("gemma-2b").reduced(),
                             _FakeMesh({"data": 1, "model": 1}))
    assert plan.notes == jplan.notes and plan.rules == jplan.rules
    assert plan.batch_axes == ("data",)

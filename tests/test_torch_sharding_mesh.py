"""The port's mesh paths on 4 gloo CPU ranks against the JAX package on 4
fake CPU devices.

One module fixture spawns the four ranks once (``launch_mesh(
sharding.mesh_cases.run, 4)``), which build every mesh they need; beside
them one JAX subprocess (``experiments/sharding/make_reference.py --npz``
under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``) starts at
once and is read on first use. Tolerances:

* ``shard_tree`` blocks: bit-equal (sha256) to JAX's ``addressable_shards``
  on the same mesh, under (data, model) and a ("pod", "data") entry;
  ``gather_tree`` of them bit-equal to the whole;
* ``pipeline_apply``: outputs rtol/atol 2e-5, gradients 1e-4
  (``tests/test_pipeline.py``'s own);
* the expert-parallel MoE against the JAX ``_moe_ep`` in each branch and a
  dropping capacity: outputs and gradients rtol/atol 2e-4, the aux loss
  rtol 1e-3 (``tests/test_moe_ep.py``'s); without drops also against the
  port's ``_moe_local``;
* the seq-sharded decode (float32 and int8 caches, ``cache_pos`` at each
  slice boundary) against the JAX sharded decode and the port's gathered
  decode: atol 5e-5 with the float32 cache (the serving reference's
  float32 decode rule, ``chip_smoke.F32_SEQ_ATOL``),
  2**-6 x max |out| with the int8 one (``tests/test_torch_models.py``'s:
  it dequantizes to bf16 and casts P to bf16); the written cache within
  5e-5 (float32) or one int8 step and one bf16 rounding (int8);
* the compressed exchange on JAX's own gradients and errors: int8 codes
  bit-equal, scales equal, errors within 2 float32 ulp of the leaf's
  largest ``|g + e|`` (``tests/test_torch_optim.py``'s rule); two
  compressed steps against the JAX recipe (the JAX package's
  ``make_compressed_train_step`` does not run under jax 0.9; see
  ``experiments/sharding/make_reference.py``);
* two sharded train steps, dense (gemma-2b) and MoE
  (granite-moe-1b-a400m), 2 x 2, float32, against the JAX step jitted with
  ``in_shardings``: the first step's loss rtol 1e-5 and each gradient leaf
  within 5e-4 x its largest |g|, each step's metrics rtol 1e-4
  (``tests/test_torch_train.py``'s float32 tolerances), the params after
  two steps within 2 lr per step (a gradient entry near zero may flip its
  Adam sign);
* ``launch.train --mesh debug`` prints the JAX driver's ``[plan]`` lines.
"""
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.analysis import distributed as D
from repro_torch.models import moe
from repro_torch.sharding import mesh_cases as MC

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "experiments" / "sharding" / "make_reference.py"
TIMEOUT = 400
LR = 3e-4


class _Reference:
    """The JAX reference subprocess, started at once and read on first use."""

    def __init__(self, out_path):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        self.path = out_path
        self.proc = subprocess.Popen(
            [sys.executable, str(SCRIPT), "--npz", str(out_path)], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
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


@pytest.fixture(scope="module")
def port(jax_ref):
    """The port's arrays from one mesh of four gloo ranks."""
    out, _walls = D.launch_mesh(MC.run, 4, device="cpu", timeout_s=TIMEOUT)
    return out


def _close(got, want, rtol, atol, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# -- blocks ----------------------------------------------------------------------

def test_blocks_bit_equal_to_addressable_shards(port, jax_ref):
    want = {k: v for k, v in jax_ref.get().items() if k.startswith("blocks/")}
    got = {k: v for k, v in port.items() if k.startswith("blocks/")}
    assert len(want) > 50 and sorted(got) == sorted(want)
    for k in want:
        assert str(got[k]) == str(want[k]), k
    rounds = {k: bool(v) for k, v in port.items() if k.startswith("roundtrip/")}
    assert len(rounds) == 8 and all(rounds.values()), rounds


# -- the pipeline -------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MC.PIPELINE["meshes"]))
def test_pipeline_matches_jax_with_gradients(port, jax_ref, mesh):
    ref = jax_ref.get()
    k = f"pipeline/{mesh}"
    _close(port[f"{k}/out"], ref[f"{k}/out"], 2e-5, 2e-5, k)
    for g in ("grad_w", "grad_b"):
        _close(port[f"{k}/{g}"], ref[f"{k}/{g}"], 1e-4, 1e-4, g)


# -- expert parallelism ---------------------------------------------------------------

@pytest.mark.parametrize("case", list(MC.EP_X))
def test_expert_parallel_moe_matches_jax(port, jax_ref, case):
    ref = jax_ref.get()
    k = f"ep/{case}"
    _close(port[f"{k}/out"], ref[f"{k}/out"], 2e-4, 2e-4, k)
    np.testing.assert_allclose(port[f"{k}/aux"], ref[f"{k}/aux"], rtol=1e-3)
    for leaf in ("router", "wi", "wg", "wo"):
        _close(port[f"{k}/grad/{leaf}"], ref[f"{k}/grad/{leaf}"], 2e-4,
               2e-4, leaf)


@pytest.mark.parametrize("case", [c for c in MC.EP_X if c != "dropping"])
def test_expert_parallel_without_drops_is_the_local_path(port, case):
    """At capacity_factor 8 no token drops, so the EP output is the local
    path's (``tests/test_moe_ep.py``'s oracle)."""
    cfg, p, x = MC.ep_inputs(case)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    out, _ = moe._moe_local(torch.from_numpy(x).reshape(-1, cfg.d_model),
                            t["router"], t["wi"], t["wg"], t["wo"], cfg)
    _close(port[f"ep/{case}/out"], out.reshape(x.shape).numpy(), 2e-4,
           2e-4, case)


# -- the seq-sharded decode -----------------------------------------------------------

@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_sharded_decode_matches_jax_and_the_gathered_path(port, jax_ref,
                                                          cache):
    ref = jax_ref.get()
    for pos in MC.DECODE["pos"]:
        k = f"decode/{cache}/{pos}"
        # the int8 cache dequantizes to bf16 and P is cast to bf16 before
        # the PV product: tests/test_torch_models.py's 2**-6 x max |out|
        tol = (5e-5 if cache == "float32" else
               2.0 ** -6 * float(np.abs(ref[f"{k}/out"]).max()))
        _close(port[f"{k}/out"], ref[f"{k}/out"], 0.0, tol, k)
        _close(port[f"{k}/out"], port[f"decode_gathered/{cache}/{pos}/out"],
               0.0, tol, k + " gathered")
        for name in ("k", "v"):
            got, want = port[f"{k}/{name}"], ref[f"{k}/{name}"]
            if cache == "int8":
                assert np.abs(got.astype(np.int32)
                              - want.astype(np.int32)).max() <= 1, k
            else:
                _close(got, want, 0.0, 5e-5, k + name)
        if cache == "int8":
            for name in ("k_scale", "v_scale"):
                _close(port[f"{k}/{name}"], ref[f"{k}/{name}"], 2 ** -7,
                       0.0, k + name)


# -- the compressed step -----------------------------------------------------------

def _paths(ref, prefix):
    return sorted(k[len(prefix):] for k in ref if k.startswith(prefix))


@pytest.fixture(scope="module")
def exchange(jax_ref):
    """``steps.pod_reduce`` on each of ``MC.COMPRESSED_MESHES`` (one spawn
    of four ranks), fed the JAX recipe's second-step gradients and carried
    errors: {tag: every rank's (coords, results)}; also the leaves' paths
    and the inputs."""
    ref = jax_ref.get()
    paths = _paths(ref, "compressed/1/grad/0/")
    grads = {p: {k: ref[f"compressed/1/grad/{p}/{k}"] for k in paths}
             for p in range(2)}
    errs = {p: {k: ref[f"compressed/0/err/{p}/{k}"] for k in paths}
            for p in range(2)}
    got = D.launch_mesh(MC.pod_exchanges, 4, grads, errs, device="cpu",
                        timeout_s=TIMEOUT)
    return got, paths, grads, errs


def _specs_of(shape, paths):
    """{path: spec} of the compressed config on ``shape`` (None: whole)."""
    if shape == MC.COMPRESSED_MESHES[0]:
        return {k: () for k in paths}
    return MC.compressed_specs(shape)


@pytest.mark.parametrize("shape", MC.COMPRESSED_MESHES,
                         ids=MC.compressed_tag)
def test_compressed_exchange_on_jax_gradients(jax_ref, exchange, shape):
    """On (2, 1, 1) each pod's rank holds whole leaves; on (2, 1, 2) and
    (2, 2, 1) each rank its blocks of them: the codes are the blocks of
    the file's codes, the scales the whole leaf's."""
    ref = jax_ref.get()
    got, paths, grads, errs = exchange
    ranks = got[MC.compressed_tag(shape)]
    assert len(ranks) == int(np.prod(shape))
    specs = _specs_of(shape, paths)
    sizes = dict(zip(MC.COMPRESSED_AXES, shape))
    for coords, leaves in ranks:
        p = coords["pod"]

        def cut(a):
            return MC.block_of(a, specs[k], coords, sizes)

        for k in paths:
            red, new_e, q8, s, allq = leaves[k]
            np.testing.assert_array_equal(
                q8, cut(ref[f"compressed/1/q8/{p}/{k}"]))
            np.testing.assert_array_equal(
                allq, np.stack([cut(ref[f"compressed/1/q8/{i}/{k}"])
                                for i in range(2)]))
            assert float(s) == float(ref[f"compressed/1/scale/{p}/{k}"])
            gf = grads[p][k].astype(np.float32) + errs[p][k]
            ulp = np.spacing(np.float32(np.abs(gf).max()))
            assert np.abs(new_e - cut(ref[f"compressed/1/err/{p}/{k}"])
                          ).max() <= 2 * ulp, k
            mean = sum(ref[f"compressed/1/q8/{i}/{k}"].astype(np.float32)
                       * ref[f"compressed/1/scale/{i}/{k}"]
                       for i in range(2)) / 2
            np.testing.assert_allclose(red, cut(mean), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("shape", MC.COMPRESSED_MESHES,
                         ids=MC.compressed_tag)
def test_compressed_steps_match_the_jax_recipe(port, jax_ref, shape):
    ref = jax_ref.get()
    tag = MC.compressed_tag(shape)
    for t in range(MC.STEPS):
        for k in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(port[f"compressed/{tag}/{t}/{k}"],
                                       ref[f"compressed/{t}/{k}"], rtol=1e-4,
                                       err_msg=f"{t} {k}")
    paths = _paths(ref, "compressed/params/")
    assert paths == _paths(port, f"compressed/{tag}/params/")
    for k in paths:
        _close(port[f"compressed/{tag}/params/{k}"],
               ref[f"compressed/params/{k}"], 0.0, 2 * LR * MC.STEPS + 1e-6,
               k)


@pytest.mark.parametrize("shape", MC.COMPRESSED_MESHES,
                         ids=MC.compressed_tag)
def test_compressed_state_is_the_ranks_blocks(port, shape):
    """After the steps each rank's params, AdamW moments and error tree
    have the shapes of its ``train_state_shardings`` blocks (the error in
    the params' specs)."""
    tag = MC.compressed_tag(shape)
    whole = _flat_shapes(MC.compressed_config())
    specs = MC.compressed_specs(shape)
    sizes = dict(zip(MC.COMPRESSED_AXES, shape))
    n = int(np.prod(shape))
    assert not _paths(port, f"compressed_blocks/{tag}/{n}/")
    for r in range(n):
        head = f"compressed_blocks/{tag}/{r}/"
        coords = dict(zip(MC.COMPRESSED_AXES, port[head + "coords"]))
        assert np.ravel_multi_index(tuple(port[head + "coords"]), shape) == r
        for part in ("params", "m", "v", "err"):
            got = {k: tuple(port[head + f"{part}/{k}"])
                   for k in _paths(port, head + f"{part}/")}
            assert sorted(got) == sorted(whole)
            for k, shp in whole.items():
                want = MC.block_of(np.empty(shp, np.int8), specs[k], coords,
                                   sizes).shape
                assert got[k] == want, (r, part, k)
    if shape != MC.COMPRESSED_MESHES[0]:
        # some leaf is cut on these meshes
        assert any(any(e is not None for e in sp) for sp in specs.values())


def _flat_shapes(cfg):
    from repro_torch.models import steps
    from repro_torch.models.common import sorted_leaves

    return {k: tuple(v.shape) for k, v in
            sorted_leaves(steps.model_param_specs(cfg))}


@pytest.mark.parametrize("shape", MC.COMPRESSED_MESHES,
                         ids=MC.compressed_tag)
def test_compressed_scale_is_the_whole_leafs(port, shape):
    """A leaf whose largest |x| lies on one rank's block: every rank of its
    pod takes the whole leaf's scale (the JAX ``quantize_int8`` of the
    whole leaf, jitted) and cuts the block of the whole leaf's codes; the
    pods' scales differ."""
    import jax
    from repro.optim.compression import quantize_int8

    tag = MC.compressed_tag(shape)
    sizes = dict(zip(MC.COMPRESSED_AXES, shape))
    scales = set()
    for r in range(int(np.prod(shape))):
        head = f"compressed_scale/{tag}/{r}/"
        coords = dict(zip(MC.COMPRESSED_AXES, port[head + "coords"]))
        x, spec = MC.scale_leaf(coords["pod"])
        q, s = jax.jit(quantize_int8)(x)
        assert float(port[head + "scale"]) == float(s), (r, coords)
        np.testing.assert_array_equal(
            port[head + "codes"],
            MC.block_of(np.asarray(q), spec, coords, sizes))
        scales.add(float(s))
    assert len(scales) == 2


def test_compressed_step_refuses_an_fsdp_over_pod():
    """``fsdp="pod_data"`` shards the state over pod, where the JAX step
    gathers it at its region's edge: refused by name."""
    from repro_torch.models import steps
    from repro_torch.sharding import make_plan

    class Shape:
        shape = {"pod": 2, "data": 1, "model": 1}

    cfg = MC.compressed_config()
    plan = make_plan(cfg, Shape(), fsdp="pod_data")
    with pytest.raises(ValueError, match="pod_data"):
        steps.make_compressed_train_step(cfg, plan)


# -- sharded train steps ---------------------------------------------------------------

@pytest.mark.parametrize("arch", MC.TRAIN_ARCHS)
def test_sharded_train_steps_match_jax(port, jax_ref, arch):
    ref = jax_ref.get()
    k = f"train/{arch}"
    np.testing.assert_allclose(port[f"{k}/loss"], ref[f"{k}/loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(port[f"{k}/nll"], ref[f"{k}/nll"], rtol=1e-5)
    paths = _paths(ref, f"{k}/grad/")
    assert paths == _paths(port, f"{k}/grad/") and len(paths) > 5
    for p in paths:
        want = ref[f"{k}/grad/{p}"]
        got = port[f"{k}/grad/{p}"]
        assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max(), p
    for t in range(MC.STEPS):
        for m in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(port[f"{k}/{t}/{m}"],
                                       ref[f"{k}/{t}/{m}"], rtol=1e-4,
                                       err_msg=f"{t} {m}")
    for p in _paths(ref, f"{k}/params/"):
        _close(port[f"{k}/params/{p}"], ref[f"{k}/params/{p}"], 0.0,
               2 * LR * MC.STEPS + 1e-6, p)


# -- the CLI ---------------------------------------------------------------------

def test_train_cli_debug_mesh_prints_the_jax_plan_lines(tmp_path, capsys):
    from repro.configs import get_config as jget_config
    from repro.launch.mesh import make_debug_mesh as jmesh
    from repro.sharding import make_plan as jplan
    from repro_torch.launch import train

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(["--arch", "gemma-2b", "--reduced", "--mesh", "debug",
                    "--device", "cpu", "--steps", "2", "--batch", "2",
                    "--seq", "16", "--ckpt-dir", str(tmp_path)])
    finally:
        torch.set_num_threads(before)
    lines = capsys.readouterr().out.splitlines()
    want = [f"[plan] {n}" for n in jplan(jget_config("gemma-2b").reduced(),
                                         jmesh((1, 1))).notes]
    assert want and lines[:len(want)] == want
    assert not any(ln.startswith("[plan]") for ln in lines[len(want):])


def test_reference_inputs_are_the_port_cases():
    """The reference script's constants are ``mesh_cases``'."""
    spec = importlib.util.spec_from_file_location("sharding_make_reference",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("SEED", "EP_CUT", "EP_X", "DECODE", "PIPELINE",
                 "COMPRESSED_CUT", "DATA", "STEPS", "TRAIN_ARCHS"):
        assert getattr(mod, name) == getattr(MC, name), name

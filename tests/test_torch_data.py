"""repro_torch.data and repro_torch.runtime (numpy copies of the JAX
package's) vs the originals, on the CPU: every ``SyntheticLM`` batch
bit-equal for several ``(step, shard, n_shards)``, and the fault-tolerant
runtime through the scenarios of ``tests/test_substrates.py``."""
import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM
from repro.data import make_batch_iterator as jmake_batch_iterator
from repro_torch.data import DataConfig, SyntheticLM, make_batch_iterator
from repro_torch.runtime import (ElasticPolicy, HealthTracker, StepEvent,
                                 TrainLoopRunner)


@pytest.mark.parametrize("cfg", [
    dict(vocab_size=1000, seq_len=64, global_batch=8, seed=7),
    dict(vocab_size=16_384, seq_len=256, global_batch=8, seed=17),
    dict(vocab_size=512, seq_len=64, global_batch=2, seed=3, zipf_a=1.1),
    dict(vocab_size=256_000, seq_len=33, global_batch=4, seed=0),
])
def test_batches_are_bit_equal(cfg):
    src, jsrc = SyntheticLM(DataConfig(**cfg)), JSyntheticLM(JDataConfig(**cfg))
    for step, shard, n_shards in [(0, 0, 1), (5, 1, 2), (123, 3, 4),
                                  (2 ** 31, 0, 2)]:
        if cfg["global_batch"] % n_shards:
            continue
        a, b = src.batch_at(step, shard, n_shards), jsrc.batch_at(
            step, shard, n_shards)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    it, jit = make_batch_iterator(DataConfig(**cfg), start_step=9), \
        jmake_batch_iterator(JDataConfig(**cfg), start_step=9)
    for _ in range(3):
        np.testing.assert_array_equal(next(it)["tokens"], next(jit)["tokens"])


def test_data_deterministic_seekable_and_shifted():
    cfg = DataConfig(vocab_size=1000, seq_len=64, global_batch=8, seed=7)
    src = SyntheticLM(cfg)
    a, b = src.batch_at(123), src.batch_at(123)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(next(make_batch_iterator(
        cfg, start_step=123))["tokens"], a["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    s0 = src.batch_at(5, shard=0, n_shards=4)
    s1 = src.batch_at(5, shard=1, n_shards=4)
    assert s0["tokens"].shape == (2, 64)
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def test_health_tracker_flags_stragglers():
    tr = HealthTracker(n_hosts=4, straggler_factor=2.0, patience=2)
    for step in range(5):
        for h in range(4):
            tr.observe(StepEvent(step, h, 1.0 if h != 3 else 5.0))
        slow = tr.stragglers()
    assert slow == [3]
    tr.observe(StepEvent(5, 1, 0.0, ok=False))
    assert tr.healthy_hosts() == 3


def test_elastic_policy_ladder():
    pol = ElasticPolicy()
    assert pol.remesh(512) == {"multi_pod": True}
    assert pol.remesh(300) == {"multi_pod": False}
    assert pol.remesh(100) is None


def test_runner_restarts_and_resumes():
    """Crash at step 7 -> restart -> resume from the checkpoint at step 5."""
    saves = {}
    crashed = {"done": False}

    def build(mesh_kwargs):
        return 0, lambda state, batch: (state + 1, {"loss": float(state)}), \
            lambda step: step

    def restore_fn(mesh_kwargs):
        return (saves[max(saves)], max(saves)) if saves else None

    def fault(step, tracker):
        if step == 7 and not crashed["done"]:
            crashed["done"] = True
            tracker.observe(StepEvent(step, 0, 0.0, ok=False))
            raise RuntimeError("simulated host failure")

    runner = TrainLoopRunner(build, saves.__setitem__, restore_fn,
                             ckpt_every=5,
                             policy=ElasticPolicy(feasible_meshes=((0, {}),)),
                             tracker=HealthTracker(n_hosts=2))
    out = runner.run(12, fault_hook=fault)
    assert out["steps"] == 12 and runner.restarts == 1
    assert sorted(saves) == [5, 10, 12] and out["state"] == 12 - 5 + 5


def test_runner_remesh_on_pod_loss():
    """Losing hosts below the 512 threshold triggers a mesh downgrade."""
    events, saves, crashed = [], {}, {"done": False}

    def build(mesh_kwargs):
        events.append(dict(mesh_kwargs))
        return 0, lambda state, batch: (state + 1, {}), lambda step: step

    def fault(step, tracker):
        if step == 3 and not crashed["done"]:
            crashed["done"] = True
            tracker.failed.update(range(256))   # a whole pod dies
            raise RuntimeError("pod failure")

    runner = TrainLoopRunner(
        build, saves.__setitem__,
        lambda mk: (max(saves.values()), max(saves)) if saves else None,
        ckpt_every=2, tracker=HealthTracker(n_hosts=512))
    out = runner.run(6, fault_hook=fault, mesh_kwargs={"multi_pod": True})
    assert out["steps"] == 6
    assert runner.remesh_events == [{"healthy": 256,
                                     "mesh": {"multi_pod": False}}]
    assert events[0] == {"multi_pod": True}
    assert events[-1] == {"multi_pod": False}


def test_runner_gives_up_without_a_mesh():
    def build(mesh_kwargs):
        return 0, lambda state, batch: (state, {}), lambda step: step

    def fault(step, tracker):
        tracker.failed.update(range(600))
        raise RuntimeError("everything failed")

    runner = TrainLoopRunner(build, lambda *a: None, lambda mk: None,
                             tracker=HealthTracker(n_hosts=600))
    with pytest.raises(RuntimeError, match="not enough healthy hosts"):
        runner.run(3, fault_hook=fault)


def test_copies_are_verbatim_below_their_headers():
    """The port's copies differ from the JAX package's modules only in the
    docstring lines that say they are copies."""
    import inspect

    import repro.data.pipeline as J1
    import repro.runtime.fault_tolerance as J2
    import repro_torch.data.pipeline as P1
    import repro_torch.runtime.fault_tolerance as P2

    for j, p in ((J1, P1), (J2, P2)):
        js, ps = inspect.getsource(j), inspect.getsource(p)
        body = js.split('"""', 2)[2]
        assert ps.split('"""', 2)[2] == body, p.__name__

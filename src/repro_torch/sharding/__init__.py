"""Sharding: logical-axis rules, partition-spec builders, pipeline parallel.

The port of the JAX package's ``sharding/``, on ``torch.distributed``. XLA
partitions a program from its annotations; the port has no such
partitioner, so it runs SPMD by hand, each rank one process of a
``launch.mesh.Mesh``:

* a ``NamedSharding`` becomes the rank's own block of the tensor
  (`partition.shard_tree`; `partition.gather_tree` rebuilds the whole);
* ``with_sharding_constraint`` changes no values, so it has no
  counterpart (the sharded training forward makes its residual streams
  the rank's block of the sequence where it makes them:
  `partition.seq_axis_for`);
* a ``shard_map`` collective becomes a ``torch.distributed`` collective on
  the subgroup of the named axis (`comm`), differentiable, its backward
  the exact adjoint.

Compute outside the ``shard_map`` regions is partitioned by hand: every
config (dense, MoE, SSM, hybrid, prefix and the encoder-decoder) serves
and trains on the rank's ``model`` blocks, each layer gathering its
leaves over the other axes (FSDP) before use and reducing its partial
sums over ``model``.
"""
from .rules import P, ShardingPlan, make_plan, param_shardings, spec_to_pspec  # noqa: F401
from .partition import (  # noqa: F401
    activation_ctx, batch_shardings, current_plan, decode_input_shardings,
    gather_tree, params_only_shardings, shard_tree,
    train_state_shardings,
)
from .pipeline import bubble_fraction, pipeline_apply  # noqa: F401

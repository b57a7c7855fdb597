"""Deterministic synthetic token pipeline — shard-aware, restart-exact.

A copy of the JAX package's ``data/pipeline.py`` (host numpy, no JAX):
every batch is bit-equal to the JAX package's for every ``(step, shard,
n_shards)``. The train step moves a batch to the state's device.

Production shape: an infinite stream of (tokens, labels) batches, seeded so
that (a) every data-parallel shard produces a disjoint deterministic slice,
and (b) `skip_to(step)` reproduces the stream position after a restart
WITHOUT replaying (counter-based PRNG — the stream is O(1)-seekable, which
is what makes checkpoint/restart and elastic re-sharding exact).

The token distribution is a permuted-Zipf unigram with an induction-head
component (odd positions repeat the previous token), so the loss decreases
visibly and quickly during the example runs: a model first learns the
marginal (Zipf entropy << ln V) and then the copy rule (~half the positions
become near-free).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "make_batch_iterator"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_order: int = 1
    n_states: int = 256


class SyntheticLM:
    """Counter-based deterministic synthetic LM stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        zipf = 1.0 / np.power(ranks, cfg.zipf_a)
        self.emit_cdf = np.cumsum(zipf / zipf.sum())
        # fixed permutation so frequent ids are spread across the vocab
        self.perm = root.permutation(cfg.vocab_size).astype(np.int32)

    def _rng_for(self, step: int, shard: int) -> np.random.Generator:
        # counter-based: O(1) seek to any (step, shard)
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, shard])
        )

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
        """Batch for `step`, shard `shard` of `n_shards` (disjoint slices)."""
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0, (cfg.global_batch, n_shards)
        b = cfg.global_batch // n_shards
        rng = self._rng_for(step, shard)
        s = cfg.seq_len + 1
        u = rng.random((b, s))
        tokens = self.perm[np.searchsorted(self.emit_cdf, u)]
        # induction-head structure: odd positions repeat the previous token
        tokens[:, 1::2] = tokens[:, 0:-1:2]
        tokens = tokens.astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def make_batch_iterator(cfg: DataConfig, start_step: int = 0,
                        shard: int = 0, n_shards: int = 1) -> Iterator[Dict]:
    """Infinite restartable iterator; `start_step` implements skip-ahead."""
    src = SyntheticLM(cfg)
    step = start_step
    while True:
        yield src.batch_at(step, shard, n_shards)
        step += 1

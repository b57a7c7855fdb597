"""Traffic on torch: the unified demand language.

`traffic.spec` defines :class:`TrafficSpec` — the one demand specification
every engine speaks (pattern registry, flag grammar, spec -> pairs / matrix
/ stacked-batch) and the single home of the unreachable-demand contract.
`traffic.patterns` registers the scenario suite (uniform, permutation,
tornado, shift, bitcomp, hotspot, bursty). Both are host numpy, copied from
the JAX package, and seeded the same, so their demand is bit-equal to it.

The batched scenario engines and the traffic x failure grid
(``repro.core.traffic.scenarios`` and ``grid``) wait for ROADMAP Queue 1
item 3.
"""
from . import patterns  # noqa: F401  (registers the pattern suite)
from .spec import (TrafficSpec, as_spec, generate,  # noqa: F401
                   pairs_to_matrix, register, sample_pairs_from_matrix)
from .spec import patterns as pattern_names  # noqa: F401

__all__ = ["TrafficSpec", "as_spec", "register", "generate",
           "pattern_names", "pairs_to_matrix", "sample_pairs_from_matrix"]

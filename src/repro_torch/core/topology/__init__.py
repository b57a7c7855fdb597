"""EvalNet topology generators (router-level graphs, implicit servers)."""
from .base import (by_cost, by_radix, by_servers, families, ladder_params,
                   make, pick_prime, solve, spec)  # noqa: F401
from .spec import LinkClass, TopologySpec  # noqa: F401
from . import (dragonfly, fattree, hammingmesh, hyperx, jellyfish, megafly,
               oft, polarfly, slimfly, torus, xpander)  # noqa: F401

__all__ = ["by_cost", "by_radix", "by_servers", "families", "ladder_params",
           "make", "pick_prime", "solve", "spec", "LinkClass", "TopologySpec"]

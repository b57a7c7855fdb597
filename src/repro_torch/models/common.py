"""Shared model plumbing: parameter specs, norms, RoPE, initialization.

The port of the JAX package's ``models/common.py``. Modules describe
parameters as nested dicts of `Spec` (shape + logical axes + init); one
tree drives `init_params` (real tensors) and the parameter counts of
``configs.base.ModelConfig``. Norms and RoPE compute in float32 and cast
back to the input's dtype, step for step as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Spec", "tree_leaves", "sorted_leaves", "tree_map", "unflatten",
    "host_array",
    "init_params", "rms_norm",
    "layer_norm", "apply_rope", "sinusoidal_positions", "einsum",
    "einsum_f32", "div",
]


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names (None = replicated)
    init: str = "normal"             # normal | zeros | ones
    scale: Optional[float] = None    # stddev; default fan-in

    def stddev(self) -> float:
        if self.scale is not None:
            return self.scale
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return 1.0 / math.sqrt(max(fan_in, 1))


def tree_leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf of a nested dict, in insertion order; a
    path joins the keys with "/" ("layers/l0/attn/wq"). A leaf is anything
    that is not a dict (a `Spec`, a tensor, an array)."""
    if not isinstance(tree, dict):
        yield path, tree
        return
    for key, sub in tree.items():
        yield from tree_leaves(sub, f"{path}/{key}" if path else key)


def sorted_leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf in the JAX package's order: the keys of
    every dict sorted, as ``jax.tree.leaves`` flattens a dict. The
    optimizer and the checkpoints visit leaves in this order."""
    if not isinstance(tree, dict):
        yield path, tree
        return
    for key in sorted(tree):
        yield from sorted_leaves(tree[key], f"{path}/{key}" if path else key)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` in its own dtype, bit for bit; bfloat16 (which
    numpy lacks) as its uint16 view."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tree_map(fn, tree: Any) -> Any:
    """The nested dict ``tree`` with ``fn`` applied to every leaf."""
    if not isinstance(tree, dict):
        return fn(tree)
    return {key: tree_map(fn, sub) for key, sub in tree.items()}


def init_params(specs: Any, generator: torch.Generator,
                dtype=torch.float32, device="cuda", cut=None) -> Dict:
    """Materialize a Spec tree into tensors on ``device``, drawn from
    ``generator`` (which must live on that device) leaf by leaf in path
    order: normal leaves N(0, stddev²) in float32, then cast to ``dtype``.
    The values differ from the JAX package's ``jax.random`` draw; weights
    that both packages share come from ``models.convert.numpy_params``.
    ``cut(path, leaf)``, when given, keeps what it returns of each drawn
    leaf (a rank's block: ``sharding.partition.block``), so the whole tree
    never exists at once; the draws are the same."""
    from ..core.analysis.wavefront import resolve_device

    dev = resolve_device(device)
    leaves = dict(tree_leaves(specs))
    drawn = {}
    for path in sorted(leaves):
        s = leaves[path]
        if s.init == "zeros":
            drawn[path] = torch.zeros(s.shape, dtype=dtype, device=dev)
        elif s.init == "ones":
            drawn[path] = torch.ones(s.shape, dtype=dtype, device=dev)
        else:
            x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                            device=dev)
            drawn[path] = x.mul_(s.stddev()).to(dtype)
            del x
        if cut is not None:
            drawn[path] = cut(path, drawn[path])
    return unflatten(drawn)


def unflatten(flat: Dict[str, Any]) -> Dict:
    """The nested dict whose `tree_leaves` are ``flat``'s items."""
    out: Dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


# -- products -----------------------------------------------------------------

def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` without ``preferred_element_type``: the operands are
    promoted to their common dtype (bf16 with f32 gives f32), and the
    result has that dtype."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


def einsum_f32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=jnp.float32)``: the product
    in float32 on upcast operands (a product of two bf16 values is exact in
    float32, so only the order of the float32 sum can differ)."""
    return torch.einsum(eq, *(t.float() for t in ops))


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` for a constant ``d`` as the JAX package's jitted steps
    compute it: XLA folds a constant divisor into a product by its float32
    reciprocal (``x * f32(1 / f32(d))``); the card's ``x / d`` does the
    same, the CPU's divides, so the product is written out."""
    return x * float(np.float32(1.0) / np.float32(d))


# -- norms -------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


# -- positions ----------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding (rotate-half, float32 angles). x: (..., S, H, D),
    positions: (..., S)."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError("head_dim must be even for RoPE")
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freq = torch.exp(div(-math.log(theta) * ar, float(half)))
    ang = positions[..., :, None].float() * freq  # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, device="cpu") -> torch.Tensor:
    """Whisper-style sinusoidal absolute position table (seq, dim), float32,
    in the JAX package's op order."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=device)
    freq = torch.exp(div(-math.log(10_000.0) * ar, float(max(half - 1, 1))))
    ang = (torch.arange(seq, dtype=torch.float32, device=device)[:, None]
           * freq[None, :])
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

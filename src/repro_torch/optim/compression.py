"""Int8 gradient compression with error feedback.

The port of the JAX package's ``optim/compression.py``: gradients are
quantized to int8 with a per-tensor scale and the quantization residual is
carried into the next step (error feedback; Karimireddy et al., "Error
Feedback Fixes SignSGD", 2019). `compressed_reduce` wraps a reduction
function (the identity by default). ``torch.round`` rounds half to even as
``jnp.round`` does, and the scale's constant divisor is the product by its
float32 reciprocal (``models.common.div``) as in the jitted JAX step, so
``q`` is bit-equal to the JAX package's. The train step that all-gathers
int8 over a ``pod`` mesh axis waits for the sharding slice (ROADMAP
Queue 1 item 3).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..models.common import div, sorted_leaves, tree_map, unflatten

__all__ = ["quantize_int8", "dequantize_int8", "compressed_reduce",
           "init_error_state"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf))
    scale = torch.clamp_min(div(amax, 127.0), 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_reduce(
    grads: Any,
    error: Any,
    reduce_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[Any, Any]:
    """Quantize (grads + carried error), reduce, and return (dequantized
    grads, new error state). ``reduce_fn`` takes the dequantized float32
    tensor."""
    reduce_fn = reduce_fn or (lambda x: x)
    errors = dict(sorted_leaves(error))
    new_g, new_e = {}, {}
    for path, g in sorted_leaves(grads):
        gf = g.float() + errors[path]
        q, scale = quantize_int8(gf)
        deq = dequantize_int8(q, scale)
        new_e[path] = gf - deq  # residual stays local
        new_g[path] = reduce_fn(deq).to(g.dtype)
    return unflatten(new_g), unflatten(new_e)

"""Carry weights and decode caches between the JAX package's trees and
the port.

A JAX parameter tree is a nested dict of arrays in the layout of
``steps.model_param_specs`` (``transformer.param_specs``, or
``encdec.param_specs`` for an encoder-decoder; layers stacked on a leading
axis); `from_jax_params` copies one (as numpy arrays) into the serving
module the config needs (a `Transformer` or an `EncDec`),
`to_numpy_params` copies it back (as float32). `tree_from_jax` /
`tree_to_numpy` carry any other tree both ways with every leaf in its own
dtype: decode caches (attention k/v, int8 codes and scales, SSM states
``{"ssm", "conv"}``, the enc-dec ``{"self", "cross"}``), or a train
state (``{"params", "opt": {"m", "v", "step"}}``, the layout both
packages' ``init_train_state`` build: the
float32 master and moments, bf16 moments or accumulators, the int32
step). bfloat16 arrays (``ml_dtypes``, as ``np.asarray`` of a JAX bf16
array gives them) travel bit for bit through their uint16 view.

`numpy_params` is the seeded weight rule that both packages implement for
``experiments/serve/reference.json``: the spec leaves sorted by path
string, each ``np.random.default_rng(seed).standard_normal(shape,
float32) * stddev`` from one generator in that order, where stddev is the
spec's own for ``normal`` leaves and 0.1 for the zeros/ones-initialized
norm weights and biases (so that a wrong ``(1 + w)`` or a dropped bias
shows).

`conditioned_params` is the rule of ``experiments/layers/reference.json``,
drawn the same way but on weights whose bfloat16 gradients stay within a
few percent of the float32 ones, so that a bfloat16 train step can be held
leaf by leaf: each projection's stddev is 1/sqrt of the size it sums over
(the spec's fan-in takes the heads axis for the attention's q/k/v, which
makes the scores O(10) and the softmax nearly one-hot), the token tables
keep their 0.02, and each zeros/ones leaf is its init value plus the same
0.1 noise, with ``dt_bias`` centred on ``SSM_DT_BIAS``.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict

import numpy as np
import torch

from .common import host_array, tree_leaves, tree_map, unflatten
from .steps import make_model, model_param_specs

__all__ = ["numpy_params", "conditioned_params", "params_sha256", "from_jax_params",
           "to_numpy_params", "tree_from_jax", "tree_to_numpy"]

#: stddev of the zeros/ones-initialized leaves under the reference rule
SMALL_LEAF_STD = 0.1


def numpy_params(cfg, seed: int) -> Dict:
    """The reference weight rule on the port's spec tree (float32)."""
    leaves = dict(tree_leaves(model_param_specs(cfg)))
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(leaves):
        s = leaves[path]
        std = s.stddev() if s.init == "normal" else SMALL_LEAF_STD
        out[path] = rng.standard_normal(s.shape, np.float32) * std
    return unflatten(out)


#: the conditioned rule's centre of ``dt_bias``: softplus(-4) = 0.018, inside
#: Mamba-2's initial step range [0.001, 0.1] (the spec's zero gives 0.69)
SSM_DT_BIAS = -4.0


def _fan_in(s) -> int:
    """The size a projection leaf sums over: its axes but the batch axes
    (``layers``, ``experts``) and the output (the last axis, or
    ``(heads, head_dim)``)."""
    out = 2 if s.axes[-1] == "head_dim" else 1
    return int(np.prod([n for n, ax in zip(s.shape[:-out], s.axes[:-out])
                        if ax not in ("layers", "experts")]))


def _conditioned(path: str, s):
    """(stddev, mean) of a leaf under the conditioned rule."""
    if s.init != "normal":
        mean = SSM_DT_BIAS if path.endswith("dt_bias") else float(
            s.init == "ones")
        return SMALL_LEAF_STD, mean
    if "vocab" in s.axes:
        return s.stddev(), 0.0
    return 1.0 / float(np.sqrt(max(_fan_in(s), 1))), 0.0


def conditioned_params(cfg, seed: int = 0, generator=None,
                       cut=None) -> Dict:
    """The layers reference's weight rule (float32 numpy; see the module
    docstring). ``generator`` (a ``torch.Generator``): the same rule drawn
    leaf by leaf from it with ``torch.randn`` on its device instead of from
    numpy's generator of ``seed`` (other values, as tensors); ``cut(path,
    leaf)`` keeps what it returns of each drawn leaf (a rank's block, as
    ``common.init_params``' ``cut``), so the whole tree never exists at
    once."""
    leaves = dict(tree_leaves(model_param_specs(cfg)))
    rng = np.random.default_rng(seed) if generator is None else None
    out = {}
    for path in sorted(leaves):
        s = leaves[path]
        std, mean = _conditioned(path, s)
        if generator is None:
            x = rng.standard_normal(s.shape, np.float32) * np.float32(
                std) + np.float32(mean)
        else:
            x = torch.randn(s.shape, generator=generator,
                            dtype=torch.float32,
                            device=generator.device).mul_(std).add_(mean)
        out[path] = x if cut is None else cut(path, x)
        del x
    return unflatten(out)


def params_sha256(tree: Dict) -> str:
    """sha256 of the leaves' bytes in sorted path order (the reference's
    check that both packages drew the same weights)."""
    h = hashlib.sha256()
    leaves = dict(tree_leaves(tree))
    for path in sorted(leaves):
        h.update(np.ascontiguousarray(leaves[path]).tobytes())
    return h.hexdigest()


def _tensor(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """float32 numpy for floating tensors (bf16 exactly), else as is."""
    t = t.detach().cpu()
    if t.is_floating_point():
        t = t.float()
    return t.numpy()


def from_jax_params(cfg, tree: Dict, device="cuda"):
    """The serving module (``steps.make_model``) holding copies of
    ``tree``'s arrays on ``device``, in their own dtype (cast with
    ``steps.cast_model``)."""
    from ..core.analysis.wavefront import resolve_device

    dev = resolve_device(device)
    want = {p: s.shape for p, s in tree_leaves(model_param_specs(cfg))}
    got = {p: tuple(np.shape(a)) for p, a in tree_leaves(tree)}
    if got != want:
        raise ValueError(f"parameter tree does not match {cfg.arch}'s "
                         f"specs: {sorted(set(got.items()) ^ set(want.items()))}")
    return make_model(cfg, tree_map(lambda a: _tensor(a, dev), tree))


def to_numpy_params(model) -> Dict:
    """The model's parameters as a JAX-layout tree of numpy arrays."""
    return tree_map(_numpy, model.param_tree())


def tree_from_jax(tree: Dict, device="cuda") -> Dict:
    """A tree of JAX arrays (or numpy copies of them) as tensors on
    ``device``, each leaf in its own dtype, bit for bit."""
    from ..core.analysis.wavefront import resolve_device

    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def tree_to_numpy(tree: Dict) -> Dict:
    """The tree's tensors as numpy arrays in their own dtypes (what
    ``jnp.asarray`` takes back; bf16 as ``ml_dtypes``' bfloat16), bit for
    bit."""
    def leaf(t):
        a = host_array(t)
        if t.dtype != torch.bfloat16:
            return a
        import ml_dtypes

        return a.view(ml_dtypes.bfloat16)

    return tree_map(leaf, tree)

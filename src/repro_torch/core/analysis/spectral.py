"""Spectral analysis: algebraic connectivity (Fiedler value) and bounds.

Power iteration with deflation on B = c*I - L (L = unnormalized Laplacian),
run as dense fp32 matvecs on the chosen device.

Bounds derived:
  * bisection width  >=  n/4 * lambda_2          (Fiedler)
  * edge expansion   >=  lambda_2 / 2            (Cheeger, d-regular normalized)
  * diameter         <=  ceil(cosh^{-1}(n-1) / cosh^{-1}((l_max+l_2)/(l_max-l_2)))

The start vector comes from a ``torch.Generator`` seeded with ``seed`` on
the device, or from the caller (``v0``): the JAX package draws its own from
``jax.random``, so the two agree to the iteration's convergence, and
exactly up to round-off when both are handed the same ``v0``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph import Graph
from .wavefront import resolve_device

__all__ = ["fiedler_value", "lambda_max", "spectral_bounds"]


def _laplacian_dense(g: Graph) -> np.ndarray:
    a = g.adjacency_dense(np.float32)
    d = a.sum(axis=1)
    lap = np.diag(d) - a
    return lap


def _start(n: int, seed: int, v0, dev: torch.device) -> torch.Tensor:
    if v0 is not None:
        return torch.tensor(np.asarray(v0, np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(n, generator=gen, dtype=torch.float32, device=dev)


def fiedler_value(g: Graph, iters: int = 300, seed: int = 0,
                  return_vector: bool = False, v0=None, device="cuda"):
    """lambda_2 of the unnormalized Laplacian via shifted power iteration.

    ``v0`` (n,) is the start vector; without it one is drawn from
    ``seed``.
    """
    dev = resolve_device(device)
    lap = torch.from_numpy(_laplacian_dense(g)).to(dev)
    n = g.n
    deg_max = float(torch.diagonal(lap).max())
    c = 2.0 * deg_max + 1.0
    b = c * torch.eye(n, dtype=torch.float32, device=dev) - lap  # c - lambda_i

    ones = torch.ones(n, dtype=torch.float32, device=dev) / float(np.sqrt(n))
    v = _start(n, seed, v0, dev)
    for _ in range(iters):
        v = v - torch.dot(ones, v) * ones  # deflate trivial eigenvector
        w = b @ v
        w = w - torch.dot(ones, w) * ones
        v = w / (torch.linalg.norm(w) + 1e-30)
    mu = float(v @ (b @ v))  # Rayleigh quotient for B
    lam2 = max(c - mu, 0.0)
    if return_vector:
        return lam2, v.cpu().numpy()
    return lam2


def lambda_max(g: Graph, iters: int = 200, seed: int = 1, v0=None,
               device="cuda") -> float:
    """Largest Laplacian eigenvalue via power iteration from ``v0`` (or a
    start vector drawn from ``seed``)."""
    dev = resolve_device(device)
    lap = torch.from_numpy(_laplacian_dense(g)).to(dev)
    v = _start(g.n, seed, v0, dev)
    for _ in range(iters):
        w = lap @ v
        v = w / (torch.linalg.norm(w) + 1e-30)
    return float(v @ (lap @ v))


def spectral_bounds(g: Graph, iters: int = 300, device="cuda") -> dict:
    lam2 = fiedler_value(g, iters=iters, device=device)
    lmax = lambda_max(g, iters=max(100, iters // 2), device=device)
    n = g.n
    d = g.degrees()
    davg = float(d.mean())
    out = {
        "fiedler_lambda2": lam2,
        "laplacian_lambda_max": lmax,
        "bisection_lower_bound": n / 4.0 * lam2,
        "edge_expansion_lower_bound": lam2 / 2.0,
        "full_bisection_edges": davg * n / 4.0,  # reference: ideal bisection
    }
    if lmax > lam2 > 0:
        x = (lmax + lam2) / (lmax - lam2)
        out["diameter_upper_bound"] = int(
            np.ceil(np.arccosh(max(n - 1, 2)) / np.arccosh(x))
        )
    return out

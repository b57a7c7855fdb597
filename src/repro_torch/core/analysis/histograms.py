"""Distribution summaries (path-length histograms etc.).

The hot path — histogramming a full (n, n) distance matrix — goes through
the value-histogram kernel (`kernels.seghist.value_histogram`) on the
matrix's device; numpy bincount is the oracle with ``use_kernel=False``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...kernels.seghist import value_histogram
from .wavefront import resolve_device

__all__ = ["path_length_histogram"]


def path_length_histogram(dist, max_len: int = 64,
                          use_kernel: bool = True,
                          device="cuda") -> List[int]:
    """Counts of finite off-diagonal path lengths 1..max_len.

    ``dist`` is a tensor (histogrammed on its device) or a numpy array,
    which the kernel path moves to ``device`` (without a card the default
    raises; ``device="cpu"`` runs the plain version) and the
    ``use_kernel=False`` oracle histograms on the host.
    """
    if use_kernel:
        d = (dist.to(torch.float32) if torch.is_tensor(dist) else
             torch.tensor(np.asarray(dist), dtype=torch.float32,
                          device=resolve_device(device)))
        counts = value_histogram(d.contiguous(),
                                 num_bins=max_len + 1).cpu().numpy()
    else:
        dist = dist.cpu().numpy() if torch.is_tensor(dist) else dist
        finite = dist[np.isfinite(dist)].astype(np.int64)
        counts = np.bincount(finite, minlength=max_len + 1)[: max_len + 1]
    counts = counts.tolist()
    counts[0] = 0  # drop the diagonal zeros
    # trim trailing zeros
    while len(counts) > 1 and counts[-1] == 0:
        counts.pop()
    return counts

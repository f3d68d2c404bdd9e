"""Chunked k-nearest-neighbour distances on the tensors' device.

Counterpart of ``pdm_tpu/ops/knn.py``: rows of the (N, N) squared-distance
matrix in chunks (one Gram per chunk), the point itself masked out, and a
smallest-k per row; the (N, N) matrix never exists whole. The JAX package
computes this with XLA, not a Pallas kernel, so the port uses
``torch.matmul`` for the Gram in the precision mode of
``ops/precision.py`` (fp32 by default, never TF32: the expansion
``|a|^2 - 2 a.b + |b|^2`` is cancellation-prone and a reduced-precision
Gram reorders neighbours at CIFAR scale).
"""

from __future__ import annotations

import torch
from torch import Tensor

from .precision import boltzmann_precision_mode, gram


def knn_sqdist(data: Tensor, k: int = 5, chunk_size: int = 1024,
               mxu_precision: str = "fp32") -> Tensor:
    """(N,) squared distance from each point to its k-th nearest neighbour,
    the point itself excluded."""
    mode = boltzmann_precision_mode(mxu_precision)
    x = data.reshape(data.shape[0], -1).to(torch.float32)
    n = x.shape[0]
    if not 0 < k < n:
        raise ValueError(f"k must be in [1, N - 1] = [1, {n - 1}]: {k}")
    chunk = min(chunk_size, n)
    x_sq = torch.sum(x * x, dim=-1)
    x_t = x.T
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    for lo in range(0, n, chunk):
        rows = x[lo:lo + chunk]
        dist = x_sq[lo:lo + chunk, None] - 2.0 * gram(rows, x_t, mode) + x_sq[None, :]
        idx = torch.arange(rows.shape[0], device=x.device)
        dist[idx, lo + idx] = float("inf")  # not its own neighbour
        out[lo:lo + chunk] = torch.topk(dist, k, dim=1, largest=False).values[:, k - 1]
    return torch.clamp(out, min=0.0)

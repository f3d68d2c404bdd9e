"""Pairwise squared-distance primitives (Gram-matrix expansion).

Counterpart of ``pdm_tpu/ops/distance.py``:
``||x - y||^2 = ||x||^2 - 2 x.y + ||y||^2``, one matrix product plus rank-1
corrections, in fp32 with TF32 off (``ops/precision.py``). The streaming
path that never holds a (B x N) matrix is ``ops/boltzmann.py``; this is the
explicit-matrix variant for small problems (MMD) and tests.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from .precision import matmul_fp32


def _flatten(x: Tensor) -> Tensor:
    return x.reshape(x.shape[0], -1)


def norm_sqr(x: Tensor) -> Tensor:
    """Per-row squared norm of a flattened batch."""
    x = _flatten(x)
    return torch.sum(x * x, dim=-1)


def compute_gram_matrix(x: Tensor, y: Tensor) -> Tensor:
    """(B, N) fp32 Gram of the flattened rows."""
    return matmul_fp32(_flatten(x), _flatten(y).T)


def compute_pw_dist_sqr(x: Tensor, y: Optional[Tensor] = None) -> Tensor:
    """(B, N) squared distances between the flattened rows of x and y (x
    itself when y is None), accumulated in fp32 whatever the input type."""
    xf = _flatten(x).to(torch.float32)
    yf = xf if y is None else _flatten(y).to(torch.float32)
    x_sq = torch.sum(xf * xf, dim=-1)
    y_sq = torch.sum(yf * yf, dim=-1)
    return x_sq[:, None] - 2.0 * matmul_fp32(xf, yf.T) + y_sq[None, :]

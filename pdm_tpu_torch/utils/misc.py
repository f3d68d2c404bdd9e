"""Small numeric utilities: per-sample Jacobians and trapezoid CDFs.

Counterpart of ``pdm_tpu/utils/misc.py``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import Tensor


def batch_jacobian(func: Callable[[Tensor], Tensor], x: Tensor) -> Tensor:
    """(B, out_dim, in_dim) Jacobian of a batched function: each sample's
    Jacobian of ``func`` applied to that sample alone (a batch of one),
    through ``torch.func.vmap`` over ``torch.func.jacrev``."""
    return torch.func.vmap(
        torch.func.jacrev(lambda xi: func(xi[None])[0]))(x)


def compute_cdf(x: np.ndarray, non_normalized_p: np.ndarray) -> np.ndarray:
    """Normalized CDF of a tabulated density via the reference's trapezoid
    construction."""
    steps = 0.5 * (non_normalized_p[1:] + non_normalized_p[:-1]) / (x[1:] - x[:-1])
    cdf = np.cumsum(np.concatenate([[0.0], steps]))
    return cdf / cdf[-1]

"""Maximum Mean Discrepancy with RBF kernels.

Counterpart of ``pdm_tpu/ops/mmd.py`` (the reference's
``scripts/sample_gmm.py:compute_mmd`` and the multi-scale form of
``scripts/optimize_schedule.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import Tensor

from .distance import compute_pw_dist_sqr


def mmd_rbf(x: Tensor, y: Tensor, sigmas: Sequence[float] = (1.0,)) -> Tensor:
    """Biased MMD^2 estimate averaged over RBF bandwidths."""
    d_xx = compute_pw_dist_sqr(x)
    d_yy = compute_pw_dist_sqr(y)
    d_xy = compute_pw_dist_sqr(x, y)
    total = 0.0
    for s in sigmas:
        gamma = 1.0 / (2.0 * s * s + 1e-8)
        total = total + (torch.exp(-d_xx * gamma).mean()
                         + torch.exp(-d_yy * gamma).mean()
                         - 2.0 * torch.exp(-d_xy * gamma).mean())
    return total / len(sigmas)

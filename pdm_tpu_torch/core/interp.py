"""Monotone piecewise-linear interpolation with linear edge extrapolation.

Counterpart of ``pdm_tpu/core/interp.py``: the knot-based (interpolated)
schedulers realize both directions of the ``tau <-> log_temp`` map with
it. Unlike ``numpy.interp``, which clamps, queries outside the knots are
extrapolated along the edge segment (the searchsorted index clipped to
[1, n - 1], weights unbounded). Differentiable in all three arguments.
"""

from __future__ import annotations

import torch
from torch import Tensor


def interp1d(x_knots: Tensor, y_knots: Tensor, x) -> Tensor:
    """Piecewise-linear interpolation on monotone-increasing ``x_knots``,
    linear beyond both ends; a zero-width segment weighs its ends 0.5
    each. The result lies on the knots' device, in their dtype."""
    xq = torch.as_tensor(x, dtype=x_knots.dtype, device=x_knots.device)
    idx = torch.clamp(
        torch.searchsorted(x_knots.contiguous(), xq.detach().contiguous(),
                           right=False),
        1, x_knots.shape[0] - 1)
    xl, xr = x_knots[idx - 1], x_knots[idx]
    yl, yr = y_knots[idx - 1], y_knots[idx]
    denom = xr - xl
    tie = denom == 0
    wl = torch.where(tie, 0.5, (xr - xq) / torch.where(tie, 1.0, denom))
    return wl * yl + (1.0 - wl) * yr


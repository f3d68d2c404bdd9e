"""Temperature algebra: the change of variables at the heart of the framework.

The variance-preserving (VP) forward process

    x_t = sqrt(alpha_bar) * x0 + sqrt(1 - alpha_bar) * eps

is reparametrized by a *temperature* ``T = (1 - alpha_bar) / alpha_bar``.
Schedules, estimators and samplers work in ``log_temp = log T``, where
``alpha_bar = sigmoid(-log_temp)``.

Counterpart of ``pdm_tpu/core/temperature.py``: plain functions on tensors.
"""

from __future__ import annotations

import torch
from torch import Tensor


def log_temp_from_alpha_bar(alpha_bar: Tensor) -> Tensor:
    """log T = log(1 - alpha_bar) - log(alpha_bar)  (= logit(1 - alpha_bar))."""
    return torch.log1p(-alpha_bar) - torch.log(alpha_bar)


def alpha_bar_from_log_temp(log_temp: Tensor) -> Tensor:
    """alpha_bar = 1 / (1 + T) = sigmoid(-log T)."""
    return torch.sigmoid(-log_temp)


def one_minus_alpha_bar_from_log_temp(log_temp: Tensor) -> Tensor:
    """1 - alpha_bar = T / (1 + T) = sigmoid(log T), computed stably."""
    return torch.sigmoid(log_temp)


def temp_from_log_temp(log_temp: Tensor) -> Tensor:
    return torch.exp(log_temp)


def log_temp_from_temp(temp: Tensor) -> Tensor:
    return torch.log(temp)


def bcast_right(x: Tensor, target_ndim: int) -> Tensor:
    """Reshape a per-sample vector (B,) to (B, 1, ..., 1) for broadcasting
    against a batch of objects with ``target_ndim`` dims (0-d passes)."""
    x = torch.as_tensor(x)
    if x.ndim == 0:
        return x
    return x.reshape(x.shape[0], *([1] * (target_ndim - 1)))

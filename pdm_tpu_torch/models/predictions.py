"""Parametrization algebra: convert any model head output into all three
standard parametrizations (x0 / eps / score), given alpha_bar.

The three are linearly related through the VP forward process
``xt = sqrt(ab) x0 + sqrt(1-ab) eps`` and ``score = -eps / sqrt(1-ab)``.

Counterpart of ``pdm_tpu/models/predictions.py``. Type promotion follows
JAX's: a bf16 ``pred``/``xt`` against an fp32 ``alpha_bar`` computes in
fp32 (torch would keep bf16 for a 0-d fp32 operand), so the derived
quantities carry the same precision as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..core.temperature import bcast_right

PARAMETRIZATIONS = ("x0", "eps", "score")


class Predictions(NamedTuple):
    pred: Tensor
    x0: Tensor
    eps: Tensor
    score: Tensor


def _promote(*tensors: Tensor) -> torch.dtype:
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def convert_prediction(
    pred: Tensor, xt: Tensor, alpha_bar: Tensor, parametrization: str
) -> Predictions:
    """alpha_bar: per-sample (B,) or scalar; broadcast over object dims."""
    ab = bcast_right(torch.as_tensor(alpha_bar, device=xt.device), xt.ndim)
    dtype = _promote(pred, xt, ab)
    p, x, ab = pred.to(dtype), xt.to(dtype), ab.to(dtype)
    sqrt_ab = torch.sqrt(ab)
    omab = 1.0 - ab
    sqrt_omab = torch.sqrt(omab)

    if parametrization == "x0":
        x0 = pred
        eps = (x - p * sqrt_ab) / sqrt_omab
        score = -eps / sqrt_omab
    elif parametrization == "eps":
        x0 = (x - p * sqrt_omab) / sqrt_ab
        eps = pred
        score = -p / sqrt_omab
    elif parametrization == "score":
        x0 = (x + p * omab) / sqrt_ab
        eps = -p * sqrt_omab
        score = pred
    else:
        raise ValueError(f"unknown parametrization: {parametrization!r}")
    return Predictions(pred=pred, x0=x0, eps=eps, score=score)


def training_target(
    x0: Tensor, eps: Tensor, alpha_bar: Tensor, parametrization: str
) -> Tensor:
    """The regression target for a given parametrization."""
    if parametrization == "x0":
        return x0
    if parametrization == "eps":
        return eps
    if parametrization == "score":
        omab = bcast_right(
            1.0 - torch.as_tensor(alpha_bar, device=x0.device), x0.ndim
        )
        return -eps / torch.sqrt(omab)
    raise ValueError(f"unknown parametrization: {parametrization!r}")

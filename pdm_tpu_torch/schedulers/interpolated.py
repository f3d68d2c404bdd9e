"""Knot-based (interpolated) schedulers.

Counterpart of ``pdm_tpu/schedulers/interpolated.py``.
``InterpolatedScheduler`` realizes the ``tau <-> log_temp`` bijection by
piecewise-linear interpolation of a monotone knot table; the knots are
fp32 tensors, so a knot schedule is differentiable through them.

Constructors derive the knots from measured statistics (host-side numpy
in float64, run once at setup, as in the reference):

* ``entropy_scheduler``  — tau proportional to the normalized entropy
  S(T) of the forward-stats sweep (entropy-uniform schedule), with
  optional low-temperature linear extrapolation in log T.
* ``metric_scheduler``   — tau proportional to the normalized Fisher-Rao
  arc length r(lambda) = int sqrt(G(lambda')) dlambda' (geodesic schedule).
* ``custom_scheduler``   — knots loaded from an .npz artifact.
* ``from_alpha_bars``    — knots from a pretrained model's alphas_cumprod.

Each constructor puts the knots on ``device``: the CUDA card unless
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import Tensor

from ..core.device import DeviceLike, resolve_device
from ..core.interp import interp1d
from ..core.temperature import log_temp_from_alpha_bar
from .base import Scheduler


@dataclasses.dataclass(frozen=True)
class InterpolatedScheduler(Scheduler):
    """Piecewise-linear tau <-> log_temp map from monotone knots:
    ``timestamps`` ascending in [0, 1], ``log_temp`` ascending."""

    timestamps: Tensor
    log_temp: Tensor

    def log_temp_from_tau(self, tau: Tensor) -> Tensor:
        return interp1d(self.timestamps, self.log_temp, tau)

    def tau_from_log_temp(self, log_temp: Tensor) -> Tensor:
        return interp1d(self.log_temp, self.timestamps, log_temp)


def _knots(timestamps, log_temp, device: DeviceLike) -> InterpolatedScheduler:
    dev = resolve_device(device)
    return InterpolatedScheduler(
        timestamps=torch.as_tensor(np.asarray(timestamps), dtype=torch.float32,
                                   device=dev),
        log_temp=torch.as_tensor(np.asarray(log_temp), dtype=torch.float32,
                                 device=dev),
    )


def extrapolate_entropy(
    temp: np.ndarray, entropy: np.ndarray, min_temp: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Extend S(log T) down to ``min_temp`` along the max-slope segment.

    Below the temperature where dS/dlogT is steepest, the measured entropy
    flattens only because the dataset is finite; everything below that
    knot is replaced by the tangent line (reference utils/stats.py:314-322,
    prepending a knot only when extending down).
    """
    temp = np.asarray(temp, dtype=np.float64)
    entropy = np.asarray(entropy, dtype=np.float64)
    if min_temp < temp[0]:
        temp = np.concatenate([[min_temp], temp])
        entropy = np.concatenate([[entropy[0]], entropy])
    log_temp = np.log(temp)
    slope = np.diff(entropy) / np.diff(log_temp)
    idx = int(np.argmax(slope))
    head = (log_temp[:idx] - log_temp[idx]) * slope[idx] + entropy[idx]
    return temp, np.concatenate([head, entropy[idx:]])


def _monotone_knots(
    timestamps: np.ndarray, log_temp: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The strictly increasing (in both coordinates) subsequence of a noisy
    knot table, by a running max, ties dropped."""
    run_max = np.maximum.accumulate(timestamps)
    keep = np.ones(len(timestamps), dtype=bool)
    keep[1:] = timestamps[1:] > run_max[:-1]
    return timestamps[keep], log_temp[keep]


def entropy_scheduler(
    temp: np.ndarray,
    entropy: np.ndarray,
    *,
    extrapolate: bool = True,
    min_temp: float = 1e-4,
    max_temp: float = np.inf,
    device: DeviceLike = None,
) -> InterpolatedScheduler:
    """Entropy-uniform schedule: equal entropy production per unit tau.
    Monte-Carlo noise can make S(T) locally non-monotone, so the knots
    keep their strictly increasing subsequence."""
    temp = np.asarray(temp, dtype=np.float64)
    entropy = np.asarray(entropy, dtype=np.float64)
    if extrapolate:
        temp, entropy = extrapolate_entropy(temp, entropy, min_temp)
        mask = temp <= max_temp
        temp, entropy = temp[mask], entropy[mask]
    timestamps = entropy - entropy.min()
    timestamps = timestamps / timestamps.max()
    timestamps, log_temp = _monotone_knots(timestamps, np.log(temp))
    return _knots(timestamps, log_temp, device)


def fisher_rao_arc_length(
    log_temp: np.ndarray, metric: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulative Fisher-Rao distance along the temperature axis,
    r(lambda) = int sqrt(G) dlambda (trapezoid rule). Returns
    (sorted log_temp, r)."""
    log_temp = np.asarray(log_temp, dtype=np.float64)
    metric = np.asarray(metric, dtype=np.float64)
    order = np.argsort(log_temp)
    log_temp, metric = log_temp[order], metric[order]
    sqrt_g = np.sqrt(np.clip(metric, 0.0, None))
    dr = 0.5 * (sqrt_g[1:] + sqrt_g[:-1]) * np.diff(log_temp)
    return log_temp, np.concatenate([[0.0], np.cumsum(dr)])


def metric_scheduler(log_temp: np.ndarray, metric: np.ndarray, *,
                     device: DeviceLike = None) -> InterpolatedScheduler:
    """Geodesic schedule: tau proportional to the Fisher-Rao arc length,
    normalized to [0, 1] (reference scheduler/metric.py:11-35)."""
    log_temp, r = fisher_rao_arc_length(log_temp, metric)
    return _knots(r / r[-1], log_temp, device)


def entropy_scheduler_from_npz(
    path: str, *, extrapolate: bool, min_temp: float, max_temp: float,
    device: DeviceLike = None,
) -> InterpolatedScheduler:
    """``entropy_scheduler`` of a forward-stats artifact (temp, entropy)."""
    stats = np.load(path)
    return entropy_scheduler(
        stats["temp"], stats["entropy"], extrapolate=extrapolate,
        min_temp=min_temp, max_temp=max_temp, device=device)


def metric_scheduler_from_npz(path: str, *, device: DeviceLike = None
                              ) -> InterpolatedScheduler:
    """``metric_scheduler`` of a metric-stats artifact (log_temp, metric)."""
    stats = np.load(path)
    return metric_scheduler(stats["log_temp"], stats["metric"], device=device)


def custom_scheduler(path: str, *, device: DeviceLike = None
                     ) -> InterpolatedScheduler:
    """Knots from an .npz artifact holding ``log_temp`` (and optionally
    ``timestamps``; evenly spaced otherwise)."""
    stats = np.load(path)
    log_temp = np.asarray(stats["log_temp"], dtype=np.float64)
    if "timestamps" in stats:
        timestamps = np.asarray(stats["timestamps"], dtype=np.float64)
    else:
        timestamps = np.linspace(0.0, 1.0, len(log_temp))
    return _knots(timestamps, log_temp, device)


def from_alpha_bars(alpha_bar, *, device: DeviceLike = None
                    ) -> InterpolatedScheduler:
    """Schedule induced by a pretrained model's alphas_cumprod table
    (reference scheduler/diffusers.py): log T from fp32 alpha_bar, tau
    evenly spaced."""
    dev = resolve_device(device)
    alpha_bar = torch.as_tensor(np.asarray(alpha_bar), dtype=torch.float32,
                                device=dev)
    log_temp = log_temp_from_alpha_bar(alpha_bar)
    timestamps = torch.linspace(0.0, 1.0, log_temp.shape[0], device=dev)
    return InterpolatedScheduler(timestamps=timestamps, log_temp=log_temp)

"""Closed-form noise schedules in log-temperature space.

All three are exact-inverse pairs ``tau <-> log T``:

* ``LinearBetaScheduler`` — continuum limit of the DDPM linearly spaced
  betas: ``1 + T = scale * exp(gamma * tau^2)`` with ``scale = 1 + T_min``
  and ``gamma = log((1 + T_max) / scale)``.
* ``CosineScheduler`` — ``sqrt(T) = tan(pi/2 * tau)`` rescaled so the
  endpoints hit (T_min, T_max).
* ``LogSNRScheduler`` — log T linear in tau (linear log-SNR).

Counterpart of ``pdm_tpu/schedulers/analytic.py``; the ``expm1`` and
``logaddexp`` forms are kept for accuracy at both ends of the range.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import Tensor

from .base import Scheduler


@dataclasses.dataclass(frozen=True)
class LinearBetaScheduler(Scheduler):
    min_temp: float
    max_temp: float

    @property
    def _scale(self) -> float:
        return 1.0 + self.min_temp

    @property
    def _gamma(self) -> float:
        return math.log((1.0 + self.max_temp) / self._scale)

    def log_temp_from_tau(self, tau: Tensor) -> Tensor:
        # T = scale * exp(gamma * tau^2) - 1; expm1 keeps tau ~ 0 accurate
        g = torch.square(tau) * self._gamma + math.log(self._scale)
        return torch.log(torch.expm1(g))

    def tau_from_log_temp(self, log_temp: Tensor) -> Tensor:
        # tau = sqrt(log((T + 1) / scale) / gamma); log(T + 1) via logaddexp
        g = torch.logaddexp(log_temp, torch.zeros_like(log_temp))
        return torch.sqrt(
            torch.clamp(g - math.log(self._scale), min=0.0) / self._gamma
        )


@dataclasses.dataclass(frozen=True)
class CosineScheduler(Scheduler):
    min_temp: float
    max_temp: float

    @property
    def _shift(self) -> float:
        return math.atan(math.sqrt(self.min_temp))

    @property
    def _scale(self) -> float:
        return math.atan(math.sqrt(self.max_temp)) - self._shift

    def log_temp_from_tau(self, tau: Tensor) -> Tensor:
        return 2.0 * torch.log(torch.tan(tau * self._scale + self._shift))

    def tau_from_log_temp(self, log_temp: Tensor) -> Tensor:
        return (torch.arctan(torch.exp(0.5 * log_temp)) - self._shift) / self._scale


@dataclasses.dataclass(frozen=True)
class LogSNRScheduler(Scheduler):
    min_temp: float
    max_temp: float

    @property
    def min_log_temp(self) -> float:
        return math.log(self.min_temp)

    @property
    def max_log_temp(self) -> float:
        return math.log(self.max_temp)

    def log_temp_from_tau(self, tau: Tensor) -> Tensor:
        return self.min_log_temp * (1.0 - tau) + self.max_log_temp * tau

    def tau_from_log_temp(self, log_temp: Tensor) -> Tensor:
        return (log_temp - self.min_log_temp) / (
            self.max_log_temp - self.min_log_temp
        )

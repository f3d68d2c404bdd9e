"""DDPM model abstraction.

A model bundles a scheduler, a parametrization tag and whatever its
``forward(xt, tau) -> pred`` needs. Counterpart of ``pdm_tpu/models/base.py``
(``DDPM`` only; the analytic ``TrueDDPM`` comes with the Boltzmann ops).
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..core.temperature import alpha_bar_from_log_temp
from ..schedulers.base import Scheduler
from .predictions import Predictions, convert_prediction


class DDPM:
    """Base: subclasses define ``forward(xt, tau) -> pred``."""

    scheduler: Scheduler
    parametrization: str

    def forward(self, xt: Tensor, tau: Tensor) -> Tensor:
        raise NotImplementedError

    def __call__(self, xt: Tensor, tau: Tensor) -> Tensor:
        return self.forward(xt, tau)

    def get_predictions(self, xt: Tensor, log_temp: Tensor) -> Predictions:
        """log_temp -> tau (clipped to [0, 1]) -> alpha_bar of the CLIPPED
        tau -> forward -> full parametrization triple."""
        tau = torch.clamp(self.scheduler.tau_from_log_temp(log_temp), 0.0, 1.0)
        alpha_bar = alpha_bar_from_log_temp(self.scheduler.log_temp_from_tau(tau))
        pred = self.forward(xt, tau)
        return convert_prediction(pred, xt, alpha_bar, self.parametrization)

    @property
    def max_log_temp(self) -> float:
        return float(self.scheduler.log_temp_from_tau(torch.ones(())))

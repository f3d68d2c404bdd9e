"""DDPM model abstraction.

A model bundles a scheduler, a parametrization tag and whatever its
``forward(xt, tau) -> pred`` needs. Counterpart of ``pdm_tpu/models/base.py``:
``DDPM`` and the analytic Bayes-optimal denoiser ``TrueDDPM``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import Tensor

from ..core.device import DeviceLike, resolve_device
from ..core.temperature import alpha_bar_from_log_temp
from ..ops.boltzmann import true_posterior_mean_x0
from ..ops.boltzmann_sweep import PreparedY, prepare_y
from ..ops.precision import boltzmann_precision_mode
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


@dataclasses.dataclass(frozen=True)
class TrueDDPM(DDPM):
    """Bayes-optimal analytic denoiser: forward = the exact posterior mean
    E[x0 | xt] over a training set held on ``device`` (the CUDA card
    unless ``device="cpu"``), through the streaming Boltzmann moments op.

    On the card every evaluation is one call of the moments kernel on the
    dataset's kernel pack, which is built once per precision mode (the
    first for the mode in force at construction) and kept, never per step.
    """

    scheduler: Scheduler
    train_data: Tensor
    parametrization: str = "x0"
    device: DeviceLike = None
    _packs: Dict[str, PreparedY] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "train_data", torch.as_tensor(
            self.train_data, dtype=torch.float32, device=dev).contiguous())
        self.pack()

    def pack(self) -> Optional[PreparedY]:
        """The dataset's kernel pack for the mode in force (on the card;
        None on the CPU, whose plain version takes the dataset itself)."""
        if self.device.type != "cuda":
            return None
        mode = boltzmann_precision_mode()
        if mode not in self._packs:
            self._packs[mode] = prepare_y(self.train_data, mode)
        return self._packs[mode]

    def forward(self, xt: Tensor, tau: Tensor) -> Tensor:
        tau = torch.broadcast_to(torch.as_tensor(tau, device=xt.device),
                                 (xt.shape[0],))
        log_temp = self.scheduler.log_temp_from_tau(tau)
        prep = self.pack()
        if prep is None:
            return true_posterior_mean_x0(xt, log_temp, self.train_data)
        return true_posterior_mean_x0(xt, log_temp, prep, values=self.train_data)

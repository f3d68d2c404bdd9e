"""UNet-backed DDPM model (the flagship).

Counterpart of ``pdm_tpu/models/unet_ddpm.py``: bundles a UNet2D, a
scheduler and a parametrization tag. The object layout is NCHW, as the
reference's. The output is cast to ``xt.dtype``, as the JAX package does,
which under ``precision="half"`` sampling is a bf16 rounding point.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..core.device import DeviceLike, resolve_device
from ..schedulers.base import Scheduler
from .base import DDPM
from .unet import UNet2D


class UNetDDPM(DDPM):
    def __init__(
        self,
        scheduler: Scheduler,
        module: UNet2D,
        parametrization: str = "eps",
        tau_scale: float = 1.0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.scheduler = scheduler
        self.module = module.to(self.device).eval()
        self.parametrization = parametrization
        # timestep-input scale: natively-trained UNets take tau in [0, 1];
        # imported diffusers checkpoints were trained on integer timesteps
        # 0..N-1 and take N-1 here
        self.tau_scale = tau_scale

    def forward(self, xt: Tensor, tau: Tensor) -> Tensor:
        tau = torch.as_tensor(tau, dtype=torch.float32, device=xt.device)
        tau = tau.expand(xt.shape[0])
        if self.tau_scale != 1.0:
            tau = tau * self.tau_scale
        return self.module(xt, tau).to(xt.dtype)

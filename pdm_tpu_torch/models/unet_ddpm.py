"""UNet-backed DDPM model (the flagship).

Counterpart of ``pdm_tpu/models/unet_ddpm.py``: bundles a UNet2D, a
scheduler and a parametrization tag. The object layout is NCHW, as the
reference's. The output is cast to ``xt.dtype``, as the JAX package does,
which under ``precision="half"`` sampling is a bf16 rounding point.

The module starts in eval mode (the JAX forward's ``deterministic=True``);
the trainer switches it with :meth:`UNetDDPM.train` and back with
:meth:`UNetDDPM.eval`, and builds the EMA model for its eval hook with
:meth:`UNetDDPM.with_params`.

``params`` is the fp32 state dict the module's weights were made from,
where there is one (JAX's ``UNetDDPM.params``, which flax keeps in fp32
whatever the compute dtype): :func:`init_unet_ddpm`'s draws, a checkpoint's
EMA weights, an imported checkpoint. The trainer starts its fp32 masters
from it, so a bf16 module's masters are not its rounded weights.

:func:`init_unet_ddpm` starts a UNet from flax's initialisation, as the
JAX ``init_unet_ddpm`` does, in place of torch's layer defaults.
"""

from __future__ import annotations

import copy
import math
from typing import Mapping, Optional, Sequence

import torch
from torch import Tensor, nn

from ..core.device import DeviceLike, resolve_device
from ..schedulers.base import Scheduler
from .base import DDPM
from .unet import GroupNormAct, UNet2D

# flax's lecun_normal (variance_scaling(1, "fan_in", "truncated_normal")):
# a normal truncated at +-2 sigma', with sigma' = sqrt(1 / fan_in) divided
# by the std of a unit normal truncated at +-2, so the draws' std is
# sqrt(1 / fan_in)
TRUNCATED_NORMAL_STD = 0.87962566103423978


class UNetDDPM(DDPM):
    def __init__(
        self,
        scheduler: Scheduler,
        module: UNet2D,
        parametrization: str = "eps",
        tau_scale: float = 1.0,
        device: DeviceLike = None,
        params: Optional[Mapping[str, Tensor]] = None,
    ):
        self.device = resolve_device(device)
        self.scheduler = scheduler
        self.module = module.to(self.device).eval()
        self.parametrization = parametrization
        # timestep-input scale: natively-trained UNets take tau in [0, 1];
        # imported diffusers checkpoints were trained on integer timesteps
        # 0..N-1 and take N-1 here
        self.tau_scale = tau_scale
        self.params = params

    def forward(self, xt: Tensor, tau: Tensor) -> Tensor:
        tau = torch.as_tensor(tau, dtype=torch.float32, device=xt.device)
        tau = tau.expand(xt.shape[0])
        if self.tau_scale != 1.0:
            tau = tau * self.tau_scale
        return self.module(xt, tau).to(xt.dtype)

    def train(self, mode: bool = True) -> "UNetDDPM":
        """Dropout on (train) or off (eval) in the module."""
        self.module.train(mode)
        return self

    def eval(self) -> "UNetDDPM":
        return self.train(False)

    def with_params(self, params: Mapping[str, Tensor]) -> "UNetDDPM":
        """A new model, in eval mode, whose module is a copy of this one's
        with ``params`` (a state dict, e.g. the trainer's fp32 EMA) loaded
        and cast to the module's dtype, and kept as its ``params``.
        Counterpart of the JAX ``UNetDDPM.with_params``; this model is left
        as it is. A module on the meta device (the trainer's whole model
        under a model axis, which holds no weights) is first given storage
        on this model's device."""
        module = copy.deepcopy(self.module)
        if any(p.is_meta for p in module.parameters()):
            module.to_empty(device=self.device)
        module.load_state_dict(params)
        return UNetDDPM(self.scheduler, module, self.parametrization,
                        self.tau_scale, device=self.device, params=params)


def lecun_sigma(weight: Tensor) -> float:
    """sigma' of flax's lecun_normal for an ``nn.Linear`` (C_out, C_in) or
    ``nn.Conv2d`` (C_out, C_in, kh, kw) weight: fan_in = C_in kh kw."""
    fan_in = weight[0].numel()
    return math.sqrt(1.0 / fan_in) / TRUNCATED_NORMAL_STD


@torch.no_grad()
def init_unet_ddpm(
    generator: torch.Generator,
    scheduler: Scheduler,
    module: UNet2D,
    obj_size: Sequence[int],
    parametrization: str = "eps",
) -> UNetDDPM:
    """Counterpart of the JAX ``init_unet_ddpm``: re-initialise every
    parameter of ``module`` with flax's defaults, drawn from ``generator``
    in ``named_parameters`` order, and wrap it in a :class:`UNetDDPM` on
    the module's device, with the fp32 draws as its ``params`` (on the
    generator's device).

    Conv and linear weights: lecun-normal (a normal truncated at
    +-2 sigma', sigma' = sqrt(1 / fan_in) / 0.8796...); their biases 0;
    GroupNorm scale 1 and bias 0. The draws are made in fp32 on the
    generator's device and cast to each parameter's dtype and device, so a
    CPU generator gives the same weights to a module on the card.
    ``obj_size`` is (C, H, W) of an object, checked against the module's
    input channels (the JAX version runs a dummy forward at that size).
    """
    if len(obj_size) != 3 or obj_size[0] != module.conv_in.in_channels:
        raise ValueError(f"obj_size {tuple(obj_size)} is not (C, H, W) with "
                         f"C = {module.conv_in.in_channels}")
    kernels, zeros, ones, draws = set(), set(), set(), {}
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            kernels.add(m.weight)
            zeros.add(m.bias)
        elif isinstance(m, GroupNormAct):
            ones.add(m.weight)
            zeros.add(m.bias)
    for name, p in module.named_parameters():
        if p in kernels:
            sigma = lecun_sigma(p)
            w = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
            nn.init.trunc_normal_(w, 0.0, sigma, -2.0 * sigma, 2.0 * sigma,
                                  generator=generator)
        elif p in zeros or p in ones:
            w = torch.full(p.shape, 1.0 if p in ones else 0.0,
                           dtype=torch.float32, device=generator.device)
        else:
            raise ValueError(f"no flax initialiser for parameter {name}")
        p.copy_(w)
        draws[name] = w
    device = next(module.parameters()).device
    return UNetDDPM(scheduler, module, parametrization, device=device,
                    params=draws)

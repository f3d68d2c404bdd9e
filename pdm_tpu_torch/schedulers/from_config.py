"""Scheduler factory: the seven schedule types keyed by config.

Counterpart of ``pdm_tpu/schedulers/from_config.py`` (linear_beta / cosine
/ log_snr / entropy / metric / diffusers / custom). The interpolated
schedules put their knots on ``device`` (the card unless
``device="cpu"``); the closed-form ones hold no tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config.config import Config
from ..core.device import DeviceLike
from .analytic import CosineScheduler, LinearBetaScheduler, LogSNRScheduler
from .base import Scheduler
from .interpolated import (
    custom_scheduler,
    entropy_scheduler_from_npz,
    from_alpha_bars,
    metric_scheduler_from_npz,
)


def scheduler_from_config(
    config: Config,
    *,
    noise_schedule_type: Optional[str] = None,
    noise_schedule_path: Optional[str] = None,
    device: DeviceLike = None,
) -> Scheduler:
    kind = noise_schedule_type or config.ddpm.noise_schedule_type

    if kind == "linear_beta":
        return LinearBetaScheduler(*config.diffusion.temp_range)
    if kind == "cosine":
        return CosineScheduler(*config.diffusion.temp_range)
    if kind == "log_snr":
        return LogSNRScheduler(*config.diffusion.temp_range)
    if kind == "entropy":
        return entropy_scheduler_from_npz(
            config.forward_stats_path,
            extrapolate=config.entropy_schedule.extrapolate,
            min_temp=config.entropy_schedule.min_temp,
            max_temp=config.entropy_schedule.max_temp,
            device=device,
        )
    if kind == "metric":
        return metric_scheduler_from_npz(config.metric_stats_path, device=device)
    if kind == "diffusers":
        # the schedule of a pretrained pipeline's alphas_cumprod table, read
        # from a local .npz beside the model id
        model_id = config.dataset_config.diffusers_model_id
        if model_id is None:
            raise ValueError(
                f"dataset {config.dataset_name} has no diffusers model id"
            )
        table = np.load(f"{model_id}/alphas_cumprod.npz")
        return from_alpha_bars(table["alphas_cumprod"], device=device)
    if kind == "custom":
        if noise_schedule_path is None:
            noise_schedule_path = config.sample.noise_schedule_path
        if noise_schedule_path is None:
            raise ValueError(
                "noise_schedule_path must be provided for custom schedules"
            )
        return custom_scheduler(noise_schedule_path, device=device)
    raise ValueError(f"Unknown schedule type: {kind}")

"""Model factory: build the configured DDPM (unet / true / diffusers) with
optional loading of the trained checkpoint.

Counterpart of ``pdm_tpu/models/from_config.py``:

* ``unet``: ``unet_from_config`` on the config's ``unet_config``, bf16
  when ``ddpm.precision == "bf16"``, initialised as flax does
  (``init_unet_ddpm``) from ``generator`` (a CPU generator seeded 0 when
  None, so the weights do not depend on the device);
* ``true``: the analytic denoiser ``TrueDDPM`` over the configured dataset
  (``get_data_tensor``), on the device;
* ``diffusers``: a pretrained diffusers UNet2DModel read from a local
  directory (``diffusers_ddpm_from_config``).

A data mesh (``parallel.data_axis``, ``parallel/``) changes nothing here:
each rank builds the same model from the same seed. A model axis above 1
(``parallel.model_axis``) raises ``NotImplementedError``: tensor and
spatial parallelism are not ported (ROADMAP.md §1 item 6b). ``fsdp``
without a mesh shards nothing, as in JAX. ``load_pretrained_unet`` reads the port
trainer's own checkpoints (``latest.txt`` and ``step_{n}/state.pt``); a JAX
trainer's orbax checkpoint is turned into one by
``scripts.convert_orbax_checkpoint``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from ..config.config import Config
from ..core.device import DeviceLike, resolve_device
from ..parallel.mesh import ITEM_6B, world_size
from ..schedulers.base import Scheduler
from ..schedulers.from_config import scheduler_from_config
from .base import DDPM, TrueDDPM
from .diffusers_import import load_diffusers_unet
from .unet import unet_from_config
from .unet_ddpm import UNetDDPM, init_unet_ddpm


def _check_no_mesh(config: Config) -> None:
    """Raise when the config asks for a model axis above 1 (tensor or
    spatial parallelism, ROADMAP.md §1 item 6b). A data axis of any size
    is the trainer's, the sampler's and the statistics' business
    (``parallel.mesh_from_config``)."""
    par = config.parallel
    if int(par.model_axis) > 1:
        raise NotImplementedError(
            f"parallel.model_axis={par.model_axis}: {ITEM_6B}; use "
            f"model_axis 1 (a data axis of any size runs)")


def _mesh_requested(config: Config) -> bool:
    """True when the run executes under a mesh of more than one rank: the
    decision ``mesh_from_config`` makes, without building a mesh, with
    the ranks of torch.distributed as JAX's visible devices."""
    par = getattr(config, "parallel", None)
    if par is None:
        return False
    model = max(1, int(par.model_axis))
    if par.data_axis is None:
        return world_size() > 1 or model > 1
    return int(par.data_axis) > 1 or model > 1


def _dtype(config: Config) -> torch.dtype:
    return torch.bfloat16 if config.ddpm.precision == "bf16" else torch.float32


def ddpm_from_config(
    config: Config,
    pretrained: bool = False,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> DDPM:
    _check_no_mesh(config)
    dev = resolve_device(device)
    scheduler = scheduler_from_config(config, device=dev)
    model_name = config.ddpm.model_name
    parametrization = config.ddpm.parametrization

    if model_name == "unet":
        # JAX turns its Pallas kernels off under a mesh (_mesh_requested):
        # GSPMD cannot partition a Mosaic call. Here each rank calls the
        # kernels on its own rows of the batch, so they stay on whether or
        # not _mesh_requested(config) holds.
        module = unet_from_config(
            config.dataset_config.channels, config.ddpm.unet_config,
            dtype=_dtype(config), device=dev,
        )
        ddpm = init_unet_ddpm(
            generator if generator is not None
            else torch.Generator().manual_seed(0),
            scheduler,
            module,
            config.dataset_config.obj_size,
            parametrization=parametrization,
        )
        if pretrained:
            ddpm = load_pretrained_unet(ddpm, config)
        return ddpm

    if model_name == "true":
        from ..utils.data import get_data_tensor

        return TrueDDPM(
            scheduler=scheduler,
            train_data=get_data_tensor(config, device=dev),
            parametrization=parametrization,
            device=dev,
        )

    if model_name == "diffusers":
        return diffusers_ddpm_from_config(config, scheduler, device=dev)

    raise ValueError(f"Unknown model name: {model_name}")


def diffusers_ddpm_from_config(
    config: Config, scheduler: Optional[Scheduler] = None,
    device: DeviceLike = None,
) -> UNetDDPM:
    """A pretrained diffusers UNet2DModel from a local directory
    (``config.json`` and ``diffusion_pytorch_model.safetensors`` or
    ``.bin``; a pipeline snapshot's ``unet/`` subdirectory also works):
    ``ddpm.diffusers_path``, else ``pretrained/<last part of the dataset's
    diffusers model id>``. tau is scaled by ``num_train_timesteps - 1``
    (``scheduler/scheduler_config.json``'s when present) before the
    timestep embedding, as the reference's diffusers model does."""
    dev = resolve_device(device)
    if scheduler is None:
        scheduler = scheduler_from_config(config, device=dev)
    root = config.ddpm.diffusers_path or os.path.join(
        "pretrained",
        (config.dataset_config.diffusers_model_id or "").split("/")[-1],
    )
    base = (os.path.join(root, "unet")
            if os.path.isdir(os.path.join(root, "unet")) else root)
    weights = None
    for fname in ("diffusion_pytorch_model.safetensors",
                  "diffusion_pytorch_model.bin"):
        p = os.path.join(base, fname)
        if os.path.exists(p):
            weights = p
            break
    if weights is None:
        raise FileNotFoundError(
            f"no diffusers UNet checkpoint under {base!r} (looked for "
            f"diffusion_pytorch_model.safetensors/.bin; set "
            f"--ddpm.diffusers_path)"
        )
    with open(os.path.join(base, "config.json")) as f:
        dcfg = json.load(f)
    module = unet_from_config(config.dataset_config.channels, dcfg,
                              dtype=_dtype(config), device=dev)
    state = load_diffusers_unet(weights)
    module.load_state_dict(state, strict=True)
    n_train = int(dcfg.get("num_train_timesteps", 1000) or 1000)
    sched_cfg = os.path.join(root, "scheduler", "scheduler_config.json")
    if os.path.exists(sched_cfg):
        with open(sched_cfg) as f:
            n_train = int(json.load(f).get("num_train_timesteps", n_train))
    return UNetDDPM(
        scheduler,
        module,
        parametrization=config.ddpm.parametrization,
        tau_scale=float(n_train - 1),
        device=dev,
        params={k: v.float() for k, v in state.items()},
    )


def load_pretrained_unet(ddpm: UNetDDPM, config: Config) -> UNetDDPM:
    """The experiment's latest checkpoint (its EMA parameters, cast to the
    module's dtype), as the trainer publishes it: ``latest.txt`` names
    ``step_{n}/state.pt`` under ``config.checkpoint_dir``."""
    latest = os.path.join(config.checkpoint_dir, "latest.txt")
    if not os.path.exists(latest):
        raise FileNotFoundError(
            f"no checkpoint for experiment {config.experiment_name!r} "
            f"({latest} missing)"
        )
    with open(latest) as f:
        step = int(f.read().strip())
    path = os.path.join(config.checkpoint_dir, f"step_{step}", "state.pt")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return ddpm.with_params(payload["ema_params"])

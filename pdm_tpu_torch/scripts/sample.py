"""Sample from a trained model -> samples/{experiment}_{n}_{step}_steps.npz.

Counterpart of ``scripts/sample.py``. :func:`build_sampler` keeps the
sampling schedule (``sample.noise_schedule_type`` / ``_path``) apart from
the training one and passes a custom schedule's knot grid to the sampler.
Over several ranks (``torchrun --nproc_per_node N -m
pdm_tpu_torch.scripts.sample``) it samples over all of them, as JAX's does
over its devices: data-parallel, and with ``parallel.model_axis`` above 1
and ``parallel.model_partition spatial`` the image rows over the model
axis as well (a channel partition samples data-parallel, as JAX's
script does); rank 0 writes the samples.
"""

from __future__ import annotations

import numpy as np

from ..config.config import Config
from ..config.loader import with_config
from ..core.device import DeviceLike, resolve_device
from ..diffusion.sampling import DDPMSampler
from ..models.from_config import ddpm_from_config
from ..parallel.distributed import initialize_multihost, sharded_sampler
from ..parallel.mesh import make_mesh, rank, world_size
from ..schedulers.from_config import scheduler_from_config
from ..schedulers.interpolated import InterpolatedScheduler
from ._common import ensure_dirs


def build_sampler(config: Config, ddpm=None, min_temp=None,
                  device: DeviceLike = None) -> DDPMSampler:
    """The sampler of ``config.sample`` (reference DDPMSampler.from_config,
    ddpm_sampling.py:57-87), over ``ddpm`` or the pretrained model."""
    dev = resolve_device(device)
    if min_temp is not None:
        config.entropy_schedule.min_temp = min_temp
    if ddpm is None:
        ddpm = ddpm_from_config(config, pretrained=True, device=dev)
    scheduler = scheduler_from_config(
        config,
        noise_schedule_type=config.sample.noise_schedule_type,
        noise_schedule_path=config.sample.noise_schedule_path,
        device=dev,
    )
    log_temp = None
    if (config.sample.noise_schedule_type == "custom"
            and isinstance(scheduler, InterpolatedScheduler)):
        log_temp = scheduler.log_temp
    sampler = DDPMSampler(
        ddpm=ddpm,
        scheduler=scheduler,
        n_steps=config.sample.n_steps,
        obj_size=config.dataset_config.obj_size,
        batch_size=config.sample.batch_size,
        n_samples=config.sample.n_samples,
        step_type=config.sample.step_type,
        precision="half" if config.sample.precision == "half" else "full",
        track_states=config.sample.track_states,
        log_temp=log_temp,
        device=dev,
    )
    # data-parallel sampling over all the ranks when there are several
    n = world_size()
    model_ax = max(1, config.parallel.model_axis)
    if n > 1 and n % model_ax == 0:
        partition = ("spatial" if model_ax > 1
                     and config.parallel.model_partition == "spatial"
                     else "data")
        sampler = sharded_sampler(sampler, make_mesh(model=model_ax),
                                  partition=partition)
    return sampler


@with_config(parse_args=(__name__ == "__main__"))
def main(config: Config, device=None) -> None:
    initialize_multihost(device=device)
    ensure_dirs("samples")
    samples = build_sampler(config, device=device).sample()
    if rank() == 0:
        np.savez(config.samples_path, **samples)
        print(f"saved {config.samples_path} x.shape={samples['x'].shape}")


if __name__ == "__main__":
    main()

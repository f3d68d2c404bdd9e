"""Train the configured DDPM.

Counterpart of ``scripts/train_diffusion.py``: ``DDPMTrainer`` from
``ddpm_training`` with a ``CSVLogger`` at ``logs/{experiment}.csv`` and
the eval hook (grid and FID) over the training data as the trainer sees
it, before any flip. The dataset stays NCHW: the port's UNet takes NCHW
in channels_last memory, so ``ddpm_training.data_layout`` has no
counterpart and no layout transpose is applied. Launched by ``torchrun
--nproc_per_node N -m pdm_tpu_torch.scripts.train_diffusion``, it trains
over the ranks' ('data', 'model') mesh (``parallel.data_axis``,
``parallel.model_axis`` with ``parallel.model_partition`` channel or
spatial, ``parallel.fsdp``; the mesh from ``mesh_from_config``); every
rank runs the eval hook on its share of the samples, and rank 0 alone
logs and writes the grid and the checkpoints.
"""

from __future__ import annotations

from ..config.config import Config
from ..config.loader import with_config
from ..core.device import resolve_device
from ..diffusion.trainer import DDPMTrainer
from ..models.from_config import ddpm_from_config
from ..parallel.distributed import initialize_multihost
from ..parallel.mesh import mesh_from_config, rank
from ..utils.data import get_data_tensor
from ..utils.logging import CSVLogger, make_eval_fn
from ._common import ensure_dirs


@with_config(parse_args=(__name__ == "__main__"))
def main(config: Config, device=None):
    initialize_multihost(device=device)
    dev = resolve_device(device)
    ensure_dirs(config.checkpoint_dir, "logs")
    tc = config.ddpm_training
    mesh = mesh_from_config(config.parallel, batch_size=tc.batch_size,
                            grad_accum=tc.grad_accum)
    if mesh is not None:
        print(f"mesh: {dict(mesh.shape)}")
    data = get_data_tensor(config, device=dev)
    lead = rank() == 0
    logger = CSVLogger(
        f"logs/{config.experiment_name}.csv",
        use_wandb=tc.use_wandb,
        run_name=config.experiment_name,
    ) if lead else None
    aug = config.data_augmentation
    # the trainer holds the only reference to the model, so under a model
    # axis the whole model's weights go once it has cut them
    trainer = DDPMTrainer(
        ddpm=ddpm_from_config(config, device=dev),
        learning_rate=tc.learning_rate,
        weight_decay=tc.weight_decay,
        betas=tuple(tc.betas),
        warmup_steps=tc.warmup_steps,
        total_iters=tc.total_iters,
        grad_clip=tc.grad_clip,
        ema_decay=tc.ema_decay,
        eval_steps=tc.eval_steps,
        keep_checkpoints=tc.keep_checkpoints,
        checkpoint_dir=config.checkpoint_dir,
        eval_fn=make_eval_fn(config, data, logger=logger, device=dev,
                             mesh=mesh),
        log_fn=logger,
        horizontal_flip=aug.use_augmentation and aug.horizontal_flip,
        grad_accum=tc.grad_accum,
        model_partition=config.parallel.model_partition,
        fsdp=config.parallel.fsdp,
    )
    return trainer.train(data, batch_size=tc.batch_size,
                         total_iters=tc.total_iters, mesh=mesh)


if __name__ == "__main__":
    main()

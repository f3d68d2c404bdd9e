"""Train the configured DDPM.

Counterpart of ``scripts/train_diffusion.py``: ``DDPMTrainer`` from
``ddpm_training`` with a ``CSVLogger`` at ``logs/{experiment}.csv`` and
the eval hook (grid and FID) over the training data as the trainer sees
it, before any flip. The dataset stays NCHW: the port's UNet takes NCHW
in channels_last memory, so ``ddpm_training.data_layout`` has no
counterpart and no layout transpose is applied. One device (ROADMAP.md
§1 item 6 brings meshes).
"""

from __future__ import annotations

from ..config.config import Config
from ..config.loader import with_config
from ..core.device import resolve_device
from ..diffusion.trainer import DDPMTrainer
from ..models.from_config import ddpm_from_config
from ..utils.data import get_data_tensor
from ..utils.logging import CSVLogger, make_eval_fn
from ._common import ensure_dirs


@with_config(parse_args=(__name__ == "__main__"))
def main(config: Config, device=None):
    dev = resolve_device(device)
    ensure_dirs(config.checkpoint_dir, "logs")
    data = get_data_tensor(config, device=dev)
    ddpm = ddpm_from_config(config, device=dev)
    tc = config.ddpm_training
    logger = CSVLogger(
        f"logs/{config.experiment_name}.csv",
        use_wandb=tc.use_wandb,
        run_name=config.experiment_name,
    )
    aug = config.data_augmentation
    trainer = DDPMTrainer(
        ddpm=ddpm,
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
        eval_fn=make_eval_fn(config, data, logger=logger, device=dev),
        log_fn=logger,
        horizontal_flip=aug.use_augmentation and aug.horizontal_flip,
        grad_accum=tc.grad_accum,
    )
    return trainer.train(data, batch_size=tc.batch_size,
                         total_iters=tc.total_iters)


if __name__ == "__main__":
    main()

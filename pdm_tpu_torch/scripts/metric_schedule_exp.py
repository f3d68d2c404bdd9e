"""FID of the linear-beta, cosine and metric schedules at a low step count
for the config's dataset and pretrained checkpoint.

Counterpart of ``scripts/metric_schedule_exp.py``, with its flags
(``--n_steps``, ``--n_samples``) plus ``--device``; the rest comes from
the config (``load_config``: the default config.yaml, or
``$PDM_CONFIG``): the data (``get_data_tensor``), the FID extractor
(``get_feature_fn``: the LeNet for MNIST, InceptionV3 otherwise) and the
model (``ddpm_from_config(pretrained=True)``). Where the config's metric
statistics are missing they are computed first, over 100 temperatures of
the dataset's range with ``regularize=True`` (row 8; a generator seeded
1, or ``main``'s ``metric_draws``: the sweep's (indices, noise)
batches) and written to ``config.metric_stats_path``. Each schedule samples
with DDIM steps from a generator seeded 0 in batches of 500 (fewer when
``--n_samples`` is smaller) and prints ``{name}: FID@{n} steps = ...``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..config.loader import load_config
from ..core.device import resolve_device
from ..diffusion.sampling import DDPMSampler
from ..models.from_config import ddpm_from_config
from ..schedulers.analytic import CosineScheduler, LinearBetaScheduler
from ..schedulers.interpolated import metric_scheduler_from_npz
from ..stats.sweep import metric_stats
from ..utils.data import get_data_tensor
from ..utils.fid import get_compute_fid, get_feature_fn
from ._common import draws_or_seed, ensure_dirs, sampler_batch, temp_grid


def main(argv: Optional[Sequence[str]] = None, *, metric_draws=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_steps", type=int, default=10)
    parser.add_argument("--n_samples", type=int, default=50_000)
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    config = load_config()
    ensure_dirs("fid")
    data = get_data_tensor(config, device=dev)
    feature_fn, fdim = get_feature_fn(config.dataset_name, device=dev)
    compute_fid = get_compute_fid(data, feature_fn, fdim, device=dev)
    ddpm = ddpm_from_config(config, pretrained=True, device=dev)

    path = config.metric_stats_path
    if not os.path.exists(path):
        print(f"{path} missing; computing metric stats")
        temps = temp_grid(*config.dataset_config.temp_range, 100)
        stats = metric_stats(
            data, temps, n_samples=512, batch_size=512, regularize=True,
            device=dev, **draws_or_seed(metric_draws, 1, dev))
        ensure_dirs(os.path.dirname(path) or ".")
        np.savez(path, **stats)

    schedulers = {
        "linear_beta": LinearBetaScheduler(*config.diffusion.temp_range),
        "cosine": CosineScheduler(*config.diffusion.temp_range),
        "metric": metric_scheduler_from_npz(path, device=dev),
    }
    fids = {}
    for name, sched in schedulers.items():
        sampler = DDPMSampler(
            ddpm=ddpm, scheduler=sched, n_steps=args.n_steps,
            obj_size=config.dataset_config.obj_size,
            batch_size=sampler_batch(args.n_samples),
            n_samples=args.n_samples, step_type="ddim", device=dev)
        samples = sampler.sample(torch.Generator(device=dev).manual_seed(0))["x"]
        fids[name] = compute_fid(samples)
        print(f"{name}: FID@{args.n_steps} steps = {fids[name]:.3f}")
    return {"fid": fids, "metric_stats_path": path}


if __name__ == "__main__":
    main()

"""Fully offline end-to-end pipeline: train a UNet DDPM on synthetic blob
images, sample with several schedules and step counts, and score FID with
a LeNet trained on the same images.

Counterpart of ``scripts/e2e_synthetic.py``, with its flags (``--steps``,
``--n_data``, ``--size``, ``--batch_size``, ``--fid_samples``,
``--sample_steps``) plus ``--device``. Dataset "blobs": each image holds
k in {1..4} Gaussian bumps at random positions, its label k - 1. Steps:
1. the dataset; 2. the LeNet (3 epochs at batch 256) whose 100 features
feed FID; 3. the forward entropy sweep -> an entropy schedule; 4. the bf16
UNet (32, 64) trained with EMA 0.999 on LinearBetaScheduler(1e-3, 1e3);
5. DDPM sampling of the EMA model on the linear-beta, cosine and entropy
schedules at each step count, FID and samples/s; 6. the FID of the
training images themselves. The last line is ``RESULT best_fid=...
floor=...``. Run as ``python -m pdm_tpu_torch.scripts.e2e_synthetic
[--device cpu]``; the seeds are JAX's keys' numbers.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..diffusion.sampling import DDPMSampler
from ..diffusion.trainer import DDPMTrainer
from ..models.lenet import train_lenet
from ..models.unet import UNet2D
from ..models.unet_ddpm import init_unet_ddpm
from ..schedulers.analytic import CosineScheduler, LinearBetaScheduler
from ..schedulers.interpolated import entropy_scheduler
from ..stats.sweep import forward_stats
from ..utils.fid import get_compute_fid
from ..utils.profiling import PhaseTimer

LENET_FEATURES = 100


def make_blob_dataset(n, size=16, seed=0):
    """(images (n, 1, size, size) in [-1, 1], labels k - 1)."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:size, 0:size]
    k = rng.randint(1, 5, n)
    imgs = np.zeros((n, size, size), np.float32)
    for i in range(n):
        for _ in range(k[i]):
            cy, cx = rng.uniform(2, size - 2, 2)
            s = rng.uniform(1.0, 2.0)
            imgs[i] += np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
    imgs = np.clip(imgs, 0, 1) * 2.0 - 1.0
    return imgs[:, None, :, :], (k - 1).astype(np.int32)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3000)
    parser.add_argument("--n_data", type=int, default=20_000)
    parser.add_argument("--size", type=int, default=16)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--fid_samples", type=int, default=5000)
    parser.add_argument("--sample_steps", type=int, nargs="+", default=[10, 50])
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    print("1/6 dataset...")
    imgs, labels = make_blob_dataset(args.n_data, args.size)
    data = torch.as_tensor(imgs, device=dev)

    print("2/6 LeNet feature extractor (blob-count classification)...")
    lenet = train_lenet(torch.Generator().manual_seed(0), imgs, labels,
                        batch_size=256, epochs=3, verbose=True, device=dev)

    def feature_fn(x):
        return lenet(x, features_only=True)

    compute_fid = get_compute_fid(data, feature_fn, LENET_FEATURES, device=dev)

    print("3/6 forward entropy sweep -> entropy schedule...")
    temps = np.logspace(-3, 3, 24)
    stats = forward_stats(data, temps, n_samples=512, batch_size=512,
                          generator=torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    ent_sched = entropy_scheduler(stats["temp"], stats["entropy"],
                                  extrapolate=True, min_temp=1e-3, device=dev)

    print("4/6 train UNet DDPM...")
    train_sched = LinearBetaScheduler(1e-3, 1e3)
    net = UNet2D(
        in_channels=1, out_channels=1, block_out_channels=(32, 64),
        down_block_types=("DownBlock2D", "AttnDownBlock2D"),
        up_block_types=("AttnUpBlock2D", "UpBlock2D"),
        layers_per_block=2, attention_head_dim=32, norm_groups=8,
        dropout=0.1, dtype=torch.bfloat16, device=dev)
    ddpm = init_unet_ddpm(torch.Generator(device=dev).manual_seed(2),
                          train_sched, net, (1, args.size, args.size),
                          parametrization="eps")
    timer = PhaseTimer()
    trainer = DDPMTrainer(
        ddpm=ddpm, learning_rate=3e-4, warmup_steps=200,
        total_iters=args.steps, grad_clip=1.0, ema_decay=0.999,
        eval_steps=10 ** 9, timer=timer,
        log_fn=lambda step, m: print(f"  step {step}: {m}"))
    t0 = time.time()
    state = trainer.train(data, batch_size=args.batch_size,
                          total_iters=args.steps,
                          log_every=max(1, args.steps // 5))
    print(f"  trained {args.steps} steps in {time.time() - t0:.1f}s")
    print(timer.report())
    ema_ddpm = ddpm.with_params(state.ema_params)

    print("5/6 sample + FID across schedules / step counts...")
    results = []
    for sched_name, sched in [("linear_beta", train_sched),
                              ("cosine", CosineScheduler(1e-3, 1e3)),
                              ("entropy", ent_sched)]:
        for n_steps in args.sample_steps:
            sampler = DDPMSampler(
                ddpm=ema_ddpm, scheduler=sched, n_steps=n_steps,
                obj_size=(1, args.size, args.size),
                batch_size=min(2500, args.fid_samples),
                n_samples=args.fid_samples, step_type="ddpm", device=dev)
            t0 = time.time()
            samples = sampler.sample(
                torch.Generator(device=dev).manual_seed(3))["x"]
            dt = time.time() - t0
            fid = compute_fid(samples)
            results.append((sched_name, n_steps, fid, args.fid_samples / dt))
            print(f"  {sched_name:>12} @ {n_steps:3d} steps: FID={fid:8.3f}  "
                  f"({args.fid_samples / dt:,.0f} samples/s)")

    print("6/6 sanity: FID floor (train vs train-half split)")
    floor = compute_fid(data[:args.fid_samples])
    print(f"  train-subset FID floor: {floor:.3f}")
    best = min(r[2] for r in results)
    print(f"RESULT best_fid={best:.3f} floor={floor:.3f}")
    return {"results": results, "floor": floor, "best_fid": best}


if __name__ == "__main__":
    main()

"""Endurance run: the flagship UNet trained on 32x32 RGB blob images with
the production cadence (EMA 0.9999, warmup then linear decay, periodic
DDIM-100 FID against a LeNet trained on the same images, checkpoints and
auto-resume) and a crash-and-resume drill.

Counterpart of ``scripts/longrun_endurance.py``, with its flags and
defaults plus ``--device``. Also the one home of what the four endurance
scripts share (``endurance_schedule_table``, ``endurance_solver_table``
and ``optimize_schedule_flagship`` import it): the dataset
(:func:`make_rgb_blob_dataset`), the flagship's config (:data:`FLAGSHIP_UNET`,
config/groups/ddpm.yaml: 128/256/256/256, 3 layers a block, attention at
16x16, 47.2 M parameters) built in bf16 (:func:`flagship_module`), its
schedule (:func:`flagship_scheduler`), the LeNet FID extractor on the same
seeds (:func:`blob_fid`) and the loader of the latest checkpoint's EMA
model (:func:`load_ema_ddpm`).

Crash drill: ``--crash_at N`` ends the process with ``os._exit(17)``
right after step N. Checkpoints are blocking and ``latest.txt`` names a
step only once its save is complete, so a relaunch without the flag
resumes from the last checkpoint at or before N and trains to
``--steps``:

    python -m pdm_tpu_torch.scripts.longrun_endurance --crash_at 30000
    python -m pdm_tpu_torch.scripts.longrun_endurance

The drill fires from the log hook, so while it is armed the trainer logs
every gcd(200, N) steps (200 otherwise, as the JAX script). Seeds are
JAX's key numbers: the UNet's initial weights from a generator seeded 2,
the eval at step s samples from one seeded s, the LeNet from a CPU
generator seeded 0. A sampler's batch is ``_common.sampler_batch``'s:
500, or the sample count where that is smaller. Writes ``endurance_result.json`` with JAX's keys and
appends the CSV log in JAX's long format (step, metric, value, time).
``main``'s keyword ``unet_config`` replaces the flagship's config (tests
run a tiny UNet).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..diffusion.sampling import DDPMSampler
from ..diffusion.trainer import DDPMTrainer
from ..models.lenet import train_lenet
from ..models.unet import unet_from_config
from ..models.unet_ddpm import UNetDDPM, init_unet_ddpm
from ..schedulers.analytic import LinearBetaScheduler
from ..utils.fid import get_compute_fid
from ..utils.logging import CSVLogger
from ._common import sampler_batch

FLAGSHIP_UNET = {
    "freq_shift": 1, "flip_sin_to_cos": False,
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D", "DownBlock2D",
                         "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "UpBlock2D", "AttnUpBlock2D", "UpBlock2D"],
    "block_out_channels": [128, 256, 256, 256],
    "downsample_padding": 0, "attention_head_dim": 64,
    "dropout": 0.2, "norm_eps": 1e-6, "layers_per_block": 3,
}
MIN_TEMP, MAX_TEMP = 1e-4, 2.478e4
OBJ_SIZE = (3, 32, 32)
LENET_FEATURES = 100
LOG_EVERY = 200
CRASH_CODE = 17


def make_rgb_blob_dataset(n, size=32, seed=0):
    """k in {1..4} colored Gaussian bumps per image; label = k-1."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:size, 0:size]
    k = rng.randint(1, 5, n)
    imgs = np.zeros((n, 3, size, size), np.float32)
    for i in range(n):
        for _ in range(k[i]):
            cy, cx = rng.uniform(3, size - 3, 2)
            s = rng.uniform(1.5, 3.0)
            color = rng.dirichlet(np.ones(3)) * rng.uniform(1.0, 2.0)
            bump = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
            imgs[i] += color[:, None, None] * bump
    imgs = np.clip(imgs, 0, 1) * 2.0 - 1.0
    return imgs, (k - 1).astype(np.int32)


def flagship_scheduler() -> LinearBetaScheduler:
    return LinearBetaScheduler(MIN_TEMP, MAX_TEMP)


def flagship_module(dev, unet_config: Optional[dict] = None):
    """The UNet of ``unet_config`` (the flagship's when None) in bf16."""
    return unet_from_config(OBJ_SIZE[0], unet_config or FLAGSHIP_UNET,
                            dtype=torch.bfloat16, device=dev)


def blob_fid(n_data: int, dev):
    """(data on ``dev``, LeNet, compute_fid): the blob images, a LeNet
    trained on them (3 epochs at batch 256, a CPU generator seeded 0) and
    FID in its 100 features against the whole set. Prints a digest of the
    LeNet's weights: every endurance script trains the same one."""
    imgs, labels = make_rgb_blob_dataset(n_data)
    data = torch.as_tensor(imgs, device=dev)
    lenet = train_lenet(torch.Generator().manual_seed(0), imgs, labels,
                        batch_size=256, epochs=3, verbose=False, device=dev)
    digest = hashlib.sha256()
    for name, t in lenet.state_dict().items():
        digest.update(name.encode())
        digest.update(t.detach().cpu().numpy().tobytes())
    print(f"  LeNet extractor sha256 {digest.hexdigest()[:16]}", flush=True)

    def feature_fn(x):
        return lenet(x, features_only=True)

    compute_fid = get_compute_fid(data, feature_fn, LENET_FEATURES, device=dev)
    return data, lenet, compute_fid


def load_ema_ddpm(ckpt_dir: str, dev, unet_config: Optional[dict] = None):
    """(the EMA model of the latest checkpoint under ``ckpt_dir``, its
    step); SystemExit when there is none."""
    ddpm = UNetDDPM(flagship_scheduler(), flagship_module(dev, unet_config),
                    parametrization="eps", device=dev)
    trainer = DDPMTrainer(ddpm=ddpm, checkpoint_dir=ckpt_dir)
    step = trainer.latest_checkpoint_step()
    if step is None:
        raise SystemExit(f"no checkpoint under {ckpt_dir}")
    state = trainer.load_checkpoint(trainer.init_state(), step)
    print(f"  loaded step {step}", flush=True)
    return ddpm.with_params(state.ema_params), step


def main(argv: Optional[Sequence[str]] = None, *,
         unet_config: Optional[dict] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=60_000)
    parser.add_argument("--n_data", type=int, default=50_000)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--warmup", type=int, default=3_000)
    parser.add_argument("--eval_every", type=int, default=10_000)
    parser.add_argument("--ckpt_every", type=int, default=5_000)
    parser.add_argument("--eval_samples", type=int, default=2_500)
    parser.add_argument("--crash_at", type=int, default=0,
                        help="os._exit right after this step (crash drill)")
    parser.add_argument("--ckpt_dir", default="checkpoints/endurance")
    parser.add_argument("--log_csv", default="logs/endurance.csv")
    parser.add_argument("--out_json", default="endurance_result.json")
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    os.makedirs(os.path.dirname(args.log_csv) or ".", exist_ok=True)
    os.makedirs(args.ckpt_dir, exist_ok=True)

    print(f"1/5 dataset ({args.n_data} 32x32 RGB blob images)...", flush=True)
    print("2/5 LeNet FID extractor...", flush=True)
    data, _, compute_fid = blob_fid(args.n_data, dev)

    print("3/5 flagship UNet (reference ddpm.yaml config, 3ch/32px)...",
          flush=True)
    sched = flagship_scheduler()
    ddpm = init_unet_ddpm(torch.Generator(device=dev).manual_seed(2), sched,
                          flagship_module(dev, unet_config), OBJ_SIZE,
                          parametrization="eps")

    logger = CSVLogger(args.log_csv)
    eval_hist = []

    def eval_fn(ema_ddpm, step):
        sampler = DDPMSampler(
            ddpm=ema_ddpm, scheduler=sched, n_steps=100, obj_size=OBJ_SIZE,
            batch_size=sampler_batch(args.eval_samples),
            n_samples=args.eval_samples, step_type="ddim", precision="half",
            device=dev)
        t0 = time.time()
        samples = sampler.sample(torch.Generator(device=dev).manual_seed(step))["x"]
        fid = compute_fid(samples)
        eval_hist.append({"step": step, "fid": float(fid)})
        print(f"  [eval @ {step}] FID(DDIM-100, {args.eval_samples})="
              f"{fid:.3f}  ({time.time() - t0:.0f}s)", flush=True)
        return {"fid": float(fid)}

    armed = args.crash_at > 0
    log_every = math.gcd(LOG_EVERY, args.crash_at) if armed else LOG_EVERY

    def log_fn(step, metrics):
        logger(step, metrics)
        if step % 1000 == 0:
            print(f"  step {step}: {metrics}", flush=True)
        if armed and step >= args.crash_at:
            print(f"  CRASH DRILL: os._exit at step {step}", flush=True)
            os._exit(CRASH_CODE)

    trainer = DDPMTrainer(
        ddpm=ddpm, learning_rate=2e-4, warmup_steps=args.warmup,
        total_iters=args.steps, grad_clip=1.0, ema_decay=0.9999,
        checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every,
        eval_steps=args.eval_every, eval_fn=eval_fn, log_fn=log_fn)

    resume = trainer.latest_checkpoint_step()
    print(f"4/5 train to {args.steps} (resume from: {resume})...", flush=True)
    t0 = time.time()
    state = trainer.train(data, batch_size=args.batch_size,
                          total_iters=args.steps, log_every=log_every)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.time() - t0

    print("5/5 final quality (EMA params, DDIM-100) + floor...", flush=True)
    if eval_hist and eval_hist[-1]["step"] == args.steps:
        # the in-loop eval already ran at the final step
        final = {"fid": eval_hist[-1]["fid"]}
    else:
        final = eval_fn(ddpm.with_params(state.ema_params), args.steps)
    floor = float(compute_fid(data[: args.eval_samples]))
    steps_run = args.steps - (resume or 0)
    result = {
        "steps": args.steps, "resumed_from": resume,
        "train_seconds": round(train_s, 1),
        "img_per_sec": round(steps_run * args.batch_size / train_s, 1),
        "final_fid": final["fid"], "fid_floor": floor,
        "eval_history": eval_hist,
    }
    with open(args.out_json, "w") as f:
        json.dump(result, f, indent=1)
    print("RESULT " + json.dumps(result), flush=True)
    return {**result, "state": state}


if __name__ == "__main__":
    main()

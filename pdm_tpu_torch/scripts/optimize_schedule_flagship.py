"""Schedule optimization through the flagship UNet's sampler, from the
endurance checkpoint.

Counterpart of ``scripts/optimize_schedule_flagship.py``, with its flags
and defaults plus ``--device``. The gradient of multi-scale RBF MMD
(bandwidths 1, 3, 10, 30) in the features of the endurance run's LeNet
flows through the whole reverse process of the EMA flagship, one
checkpointed step at a time (``remat``), into an ``--n_steps`` knot
vector of log temperatures that starts on the linear-beta grid and is
clipped to [log 1e-4, log 2.478e4] (``diffusion.schedule_opt``; the
generated batches and data batches draw from a generator seeded 0).
Then FID of the initial and the optimized grid through
``sample_with_grid``: the samples come in chunks of min(500,
``--fid_samples``), chunk i drawing from a generator seeded
777 * 10,000 + i (JAX folds i into ``PRNGKey(777)``). Writes
``{out}.json`` with JAX's keys; ``--out`` defaults to
optimized_flagship_schedule, with ``_{step_type}`` appended for a step
type other than ddpm. ``main``'s keyword ``unet_config`` must be the
checkpoint's.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..diffusion.sampling import STEP_TYPES, discretize_schedule
from ..diffusion.schedule_opt import optimize_schedule, sample_with_grid
from ._common import sampler_batch
from .longrun_endurance import (
    MAX_TEMP, MIN_TEMP, OBJ_SIZE, blob_fid, flagship_scheduler, load_ema_ddpm,
)

SIGMAS = (1.0, 3.0, 10.0, 30.0)
FID_SEED = 777


def fid_chunk_seed(i: int) -> int:
    return FID_SEED * 10_000 + i


def main(argv: Optional[Sequence[str]] = None, *,
         unet_config: Optional[dict] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt_dir", default="checkpoints/endurance")
    parser.add_argument("--n_steps", type=int, default=5)
    parser.add_argument("--n_iters", type=int, default=200)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--learning_rate", type=float, default=0.05)
    parser.add_argument("--n_data", type=int, default=50_000)
    parser.add_argument("--fid_samples", type=int, default=5_000)
    parser.add_argument("--step_type", default="ddpm", choices=list(STEP_TYPES))
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if args.out is None:
        suffix = "" if args.step_type == "ddpm" else f"_{args.step_type}"
        args.out = "optimized_flagship_schedule" + suffix

    print("1/4 data + LeNet features (endurance seeds)...", flush=True)
    data, lenet, compute_fid = blob_fid(args.n_data, dev)

    def feature_fn(x):
        return lenet(x, features_only=True)

    print("2/4 endurance checkpoint...", flush=True)
    ema_ddpm, step = load_ema_ddpm(args.ckpt_dir, dev, unet_config)
    # only the knots are differentiated
    ema_ddpm.module.requires_grad_(False)

    print(f"3/4 optimize {args.n_steps}-knot schedule "
          f"({args.n_iters} iters, feature-space MMD)...", flush=True)
    init = discretize_schedule(flagship_scheduler(), args.n_steps, device=dev)
    t0 = time.time()
    out = optimize_schedule(
        ema_ddpm, data, init, n_iters=args.n_iters, batch_size=args.batch_size,
        learning_rate=args.learning_rate, step_type=args.step_type,
        sigmas=SIGMAS, clip_range=(math.log(MIN_TEMP), math.log(MAX_TEMP)),
        feature_fn=feature_fn, log_every=20, remat=True, device=dev)
    print(f"  optimized in {time.time() - t0:.0f}s; "
          f"mmd {out['history'][0]:.5f} -> {out['history'][-1]:.5f}",
          flush=True)

    print("4/4 FID: initial vs optimized grid...", flush=True)

    @torch.no_grad()
    def fid_of_grid(grid):
        bs = sampler_batch(args.fid_samples)
        chunks = []
        for i in range(-(-args.fid_samples // bs)):  # ceil: keep remainder
            chunks.append(sample_with_grid(
                ema_ddpm, torch.as_tensor(grid, dtype=torch.float32, device=dev),
                torch.Generator(device=dev).manual_seed(fid_chunk_seed(i)),
                (bs, *OBJ_SIZE), args.step_type))
        return float(compute_fid(torch.cat(chunks)[: args.fid_samples]))

    init_np = init.cpu().numpy()
    fid_init = fid_of_grid(init_np)
    fid_opt = fid_of_grid(out["log_temp"])
    result = {
        "checkpoint_step": step, "n_steps": args.n_steps,
        "step_type": args.step_type,
        "fid_linear_beta_init": round(fid_init, 3),
        "fid_optimized": round(fid_opt, 3),
        "init_log_temp": [round(float(v), 4) for v in init_np],
        "optimized_log_temp": [round(float(v), 4) for v in out["log_temp"]],
        "mmd_history_first_last": [float(out["history"][0]),
                                   float(out["history"][-1])],
    }
    with open(args.out + ".json", "w") as f:
        json.dump(result, f, indent=1)
    print("RESULT " + json.dumps(result), flush=True)
    return {**result, "history": out["history"], "out": args.out}


if __name__ == "__main__":
    main()

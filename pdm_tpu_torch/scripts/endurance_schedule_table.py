"""Schedule-ordering FID table on the endurance checkpoint.

Counterpart of ``scripts/endurance_schedule_table.py``, with its flags
and defaults plus ``--device``. Loads the EMA weights of the latest
checkpoint of ``longrun_endurance``, derives the data-driven schedules of
the same blob images (entropy-uniform from a forward sweep, geodesic from
the regularized Fisher-Rao metric; both sweeps through row 8) and computes
the FID grid

    {5, 10, 20, 50, 100} steps x {linear_beta, cosine, entropy, metric}

in the features of the LeNet that the endurance run trained (same seeds).
The sweeps draw from generators seeded 1 and 2, the sampler at n steps
from one seeded 100 + n (JAX's keys); ``main``'s keywords
``forward_draws`` and ``metric_draws`` replace the sweeps' draws (their
(indices, noise) batches, as ``stats.sweep`` takes them). Writes ``{out}.json`` and
``{out}.md`` in JAX's layout; ``--out`` defaults to
endurance_schedule_table, with ``_{step_type}`` appended for a step type
other than ddpm. ``main``'s keyword ``unet_config`` must be the one the
checkpoint was trained with (tests run a tiny UNet).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..diffusion.sampling import STEP_TYPES, DDPMSampler
from ..schedulers.analytic import CosineScheduler
from ..schedulers.interpolated import entropy_scheduler, metric_scheduler
from ..stats.sweep import forward_stats, metric_stats
from ._common import draws_or_seed, sampler_batch
from .longrun_endurance import (
    MAX_TEMP, MIN_TEMP, OBJ_SIZE, blob_fid, flagship_scheduler, load_ema_ddpm,
)


def main(argv: Optional[Sequence[str]] = None, *,
         unet_config: Optional[dict] = None, forward_draws=None,
         metric_draws=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt_dir", default="checkpoints/endurance")
    parser.add_argument("--n_data", type=int, default=50_000)
    parser.add_argument("--fid_samples", type=int, default=5_000)
    parser.add_argument("--steps", type=int, nargs="+",
                        default=[5, 10, 20, 50, 100])
    parser.add_argument("--step_type", default="ddpm", choices=list(STEP_TYPES))
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if args.out is None:
        # never silently overwrite the ddpm baseline with another rule's run
        suffix = "" if args.step_type == "ddpm" else f"_{args.step_type}"
        args.out = "endurance_schedule_table" + suffix

    print("1/4 data + LeNet extractor (same seeds as the endurance run)...",
          flush=True)
    data, _, compute_fid = blob_fid(args.n_data, dev)

    print("2/4 data-driven schedules (forward sweep + FR metric)...",
          flush=True)
    temps = np.logspace(-4, 4.5, 32)
    fstats = forward_stats(data, temps, n_samples=512, batch_size=512,
                           device=dev, **draws_or_seed(forward_draws, 1, dev))
    ent_sched = entropy_scheduler(fstats["temp"], fstats["entropy"],
                                  extrapolate=True, min_temp=1e-4, device=dev)
    mstats = metric_stats(data, temps, n_samples=256, batch_size=256,
                          regularize=True, device=dev,
                          **draws_or_seed(metric_draws, 2, dev))
    met_sched = metric_scheduler(mstats["log_temp"], mstats["metric"],
                                 device=dev)

    print("3/4 EMA params from the endurance checkpoint...", flush=True)
    ema_ddpm, step = load_ema_ddpm(args.ckpt_dir, dev, unet_config)

    print("4/4 FID grid...", flush=True)
    schedules = [
        ("linear_beta", flagship_scheduler()),
        ("cosine", CosineScheduler(MIN_TEMP, MAX_TEMP)),
        ("entropy", ent_sched),
        ("metric", met_sched),
    ]
    table = {}
    for name, s in schedules:
        for n in args.steps:
            sampler = DDPMSampler(
                ddpm=ema_ddpm, scheduler=s, n_steps=n, obj_size=OBJ_SIZE,
                batch_size=sampler_batch(args.fid_samples),
                n_samples=args.fid_samples, step_type=args.step_type,
                precision="half", device=dev)
            t0 = time.time()
            samples = sampler.sample(
                torch.Generator(device=dev).manual_seed(100 + n))["x"]
            fid = float(compute_fid(samples))
            table[f"{name}@{n}"] = round(fid, 3)
            print(f"  {name:>12} @ {n:3d}: FID={fid:8.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    floor = float(compute_fid(data[: args.fid_samples]))
    out = {"checkpoint_step": step, "fid_floor": round(floor, 3),
           "table": table}
    with open(args.out + ".json", "w") as f:
        json.dump(out, f, indent=1)

    lines = [
        f"# Endurance-checkpoint schedule-ordering FID (blob-32, "
        f"step {step}, {args.step_type} steps, floor {floor:.3f})", "",
        "| schedule | " + " | ".join(str(n) for n in args.steps) + " |",
        "|---|" + "---|" * len(args.steps),
    ]
    for name, _ in schedules:
        row = [f"{table[f'{name}@{n}']:.2f}" for n in args.steps]
        lines.append(f"| {name} | " + " | ".join(row) + " |")
    with open(args.out + ".md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print("RESULT " + json.dumps(out), flush=True)
    return {**out, "out": args.out, "forward_stats": fstats,
            "metric_stats": mstats, "schedules": dict(schedules)}


if __name__ == "__main__":
    main()

"""Solver-family FID table on the endurance checkpoint.

Counterpart of ``scripts/endurance_solver_table.py``, with its flags and
defaults plus ``--device``. Fixes the linear-beta schedule and sweeps the
solver at few-NFE level counts,

    {3, 5, 10, 20, 50} levels x {ddpm, ddim, heun, dpmpp_2m},

reporting FID in the endurance run's LeNet features beside the model
evaluations a sample costs (NFE: n, heun 2n - 1). Heun clamps this
schedule's 2.478e4 to its validated 4e2 and warns, as JAX's sampler
does. The sampler at n levels draws from a generator seeded 200 + n
(JAX's key). Writes ``{out}.json`` and ``{out}.md`` in JAX's layout.
``main``'s keyword ``unet_config`` must be the checkpoint's.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from ..core.device import resolve_device
from ..diffusion.sampling import DDPMSampler
from ._common import sampler_batch
from .longrun_endurance import OBJ_SIZE, blob_fid, flagship_scheduler, load_ema_ddpm


def nfe(solver: str, n: int) -> int:
    """Model evaluations of one sample at ``n`` levels."""
    return 2 * n - 1 if solver == "heun" else n


def main(argv: Optional[Sequence[str]] = None, *,
         unet_config: Optional[dict] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt_dir", default="checkpoints/endurance")
    parser.add_argument("--n_data", type=int, default=50_000)
    parser.add_argument("--fid_samples", type=int, default=5_000)
    parser.add_argument("--steps", type=int, nargs="+",
                        default=[3, 5, 10, 20, 50])
    parser.add_argument("--solvers", nargs="+",
                        default=["ddpm", "ddim", "heun", "dpmpp_2m"])
    parser.add_argument("--out", default="endurance_solver_table")
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    print("1/3 data + LeNet extractor (same seeds as the endurance run)...",
          flush=True)
    data, _, compute_fid = blob_fid(args.n_data, dev)

    print("2/3 EMA params from the endurance checkpoint...", flush=True)
    ema_ddpm, step = load_ema_ddpm(args.ckpt_dir, dev, unet_config)
    sched = flagship_scheduler()

    print("3/3 FID grid...", flush=True)
    table = {}
    for solver in args.solvers:
        for n in args.steps:
            sampler = DDPMSampler(
                ddpm=ema_ddpm, scheduler=sched, n_steps=n, obj_size=OBJ_SIZE,
                batch_size=sampler_batch(args.fid_samples),
                n_samples=args.fid_samples, step_type=solver,
                precision="half", device=dev)
            t0 = time.time()
            samples = sampler.sample(
                torch.Generator(device=dev).manual_seed(200 + n))["x"]
            fid = float(compute_fid(samples))
            table[f"{solver}@{n}"] = {"fid": round(fid, 3), "nfe": nfe(solver, n)}
            print(f"  {solver:>9} @ {n:3d} levels (NFE {nfe(solver, n):3d}): "
                  f"FID={fid:10.3f} ({time.time() - t0:.0f}s)", flush=True)

    floor = float(compute_fid(data[: args.fid_samples]))
    out = {"checkpoint_step": step, "fid_floor": round(floor, 3),
           "schedule": "linear_beta", "table": table}
    with open(args.out + ".json", "w") as f:
        json.dump(out, f, indent=1)

    lines = [
        f"# Endurance-checkpoint solver-family FID (blob-32, step {step}, "
        f"linear-beta schedule, floor {floor:.3f})", "",
        "FID (NFE) per solver and level count:", "",
        "| solver | " + " | ".join(str(n) for n in args.steps) + " |",
        "|---|" + "---|" * len(args.steps),
    ]
    for solver in args.solvers:
        row = [f"{table[f'{solver}@{n}']['fid']:.2f} "
               f"({table[f'{solver}@{n}']['nfe']})" for n in args.steps]
        lines.append(f"| {solver} | " + " | ".join(row) + " |")
    with open(args.out + ".md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print("RESULT " + json.dumps(out), flush=True)
    return {**out, "out": args.out}


if __name__ == "__main__":
    main()

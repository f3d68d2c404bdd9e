"""The paper's schedule-ordering result on a 64-D anisotropic GMM with the
exact (Bayes-optimal) denoiser: sampling quality at {5, 10, 20, 50} steps
for the linear_beta, cosine, log_snr, entropy and metric schedules.

Counterpart of ``scripts/schedule_ordering_exp.py``, with its flags and
defaults plus ``--device``. One ``thermo_sweep`` (row 8) of the training
points gives the entropy and metric schedules; ``TrueDDPM`` (row 7) under
a fixed log-SNR model schedule samples ``--n_eval`` points with DDPM
steps on each sampling schedule. Each sample set is scored by its exact
mean NLL under the true mixture (scipy, float64) less the held-out
points' and by RBF-MMD against them at median-heuristic bandwidths. The
sweep draws from a generator seeded 0, the sampler at n steps from one
seeded 1000 + n (JAX's keys). Writes schedule_ordering.md and
stats/schedule_ordering.npz (JAX's keys) into the working directory.

``main``'s keywords replace the draws: ``sweep_draws``, the sweep's
(indices, noise) batches; ``sampler_draws``, {n: (x_init, noise)} for the
sampler at n steps (one batch of ``--n_eval``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..diffusion.sampling import DDPMSampler, discretize_schedule
from ..models.base import TrueDDPM
from ..ops.mmd import mmd_rbf
from ..schedulers.analytic import (
    CosineScheduler, LinearBetaScheduler, LogSNRScheduler,
)
from ..schedulers.interpolated import entropy_scheduler, metric_scheduler
from ..stats.sweep import thermo_sweep
from ..utils.synthetic import generate_anisotropic_gmm
from ._common import draws_or_seed, ensure_dirs, temp_grid


def mixture_nll(means, covs):
    """x -> the mean NLL of the rows of x under the equal-weight Gaussian
    mixture (float64, scipy)."""
    from scipy.stats import multivariate_normal

    dim = means.shape[1]
    comps = [multivariate_normal(
        means[k].astype(np.float64),
        covs[k].astype(np.float64) + 1e-10 * np.eye(dim), allow_singular=True)
        for k in range(len(means))]

    def nll(x: np.ndarray) -> float:
        logp = np.stack([c.logpdf(x.astype(np.float64)) for c in comps])
        mix = np.logaddexp.reduce(logp, axis=0) - np.log(len(comps))
        return float(-np.mean(mix))

    return nll


def median_sigmas(flat: np.ndarray):
    """(0.5, 1, 2) x the median distance between the first 512 points and
    the next 512."""
    d2 = np.sum((flat[:512, None, :] - flat[512:1024, None, :]
                 .transpose(1, 0, 2)) ** 2, axis=-1)
    med = float(np.sqrt(np.median(d2)))
    return (0.5 * med, med, 2.0 * med)


def main(argv: Optional[Sequence[str]] = None, *, sweep_draws=None,
         sampler_draws=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--n_data", type=int, default=20_000)
    p.add_argument("--n_eval", type=int, default=4096)
    p.add_argument("--min_temp", type=float, default=1e-6)
    p.add_argument("--max_temp", type=float, default=1e3)
    p.add_argument("--n_temps", type=int, default=64)
    p.add_argument("--steps", type=int, nargs="+", default=[5, 10, 20, 50])
    p.add_argument("--device", default=None,
                   help="the card by default; cpu runs the plain versions")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    samples, means, covs = generate_anisotropic_gmm(
        dim=args.dim, n_samples=args.n_data + args.n_eval, seed=42)
    flat = samples.reshape(len(samples), -1)
    train = torch.as_tensor(flat[: args.n_data], device=dev)
    held_np = flat[args.n_data:][: args.n_eval]
    held = torch.as_tensor(held_np, device=dev)

    # exact per-sample NLL under the TRUE mixture: anisotropic thin
    # directions (std down to ~8e-3) punish any schedule that
    # under-resolves the low-temperature end
    true_nll = mixture_nll(means, covs)
    nll_held = true_nll(held_np)

    # data-driven schedules from one fused thermo sweep
    temps = temp_grid(args.min_temp, args.max_temp, args.n_temps)
    stats = thermo_sweep(train, temps, n_samples=512, batch_size=512,
                         device=dev, **draws_or_seed(sweep_draws, 0, dev))
    schedules = {
        "linear_beta": LinearBetaScheduler(args.min_temp, args.max_temp),
        "cosine": CosineScheduler(args.min_temp, args.max_temp),
        "log_snr": LogSNRScheduler(args.min_temp, args.max_temp),
        "entropy": entropy_scheduler(
            stats["temp"], stats["entropy"], min_temp=args.min_temp,
            max_temp=args.max_temp, device=dev),
        "metric": metric_scheduler(stats["log_temp"], stats["metric"],
                                   device=dev),
    }

    # the model's own (training) schedule is fixed; only the SAMPLING
    # schedule varies
    ddpm = TrueDDPM(scheduler=LogSNRScheduler(args.min_temp, args.max_temp),
                    train_data=train, device=dev)
    sigmas = median_sigmas(flat)

    results, results_mmd, grids = {}, {}, {}
    for name, sched in schedules.items():
        for n in args.steps:
            sampler = DDPMSampler(
                ddpm=ddpm, scheduler=sched, n_steps=n,
                obj_size=(1, args.dim, 1), batch_size=args.n_eval,
                n_samples=args.n_eval, step_type="ddpm", device=dev)
            grids[(name, n)] = discretize_schedule(
                sched, n, max_log_temp=ddpm.max_log_temp,
                device=dev).cpu().numpy()
            if sampler_draws is None:
                x = sampler.sample(
                    torch.Generator(device=dev).manual_seed(1000 + n))["x"]
                x = torch.as_tensor(x, device=dev)
            else:
                x_init, noise = (torch.as_tensor(np.asarray(d), device=dev)
                                 for d in sampler_draws[n])
                x = sampler.batch_sample(x_init=x_init, noise=noise)["x"]
            x = x.reshape(args.n_eval, -1)
            nll = true_nll(x.cpu().numpy())
            mmd = float(mmd_rbf(x, held, sigmas=sigmas))
            results[(name, n)] = nll
            results_mmd[(name, n)] = mmd
            print(f"{name:12s} n_steps={n:3d}  NLL={nll:10.2f}  MMD={mmd:.5f}",
                  flush=True)

    names = list(schedules)

    def table_for(res, fmt):
        header = ("| schedule | "
                  + " | ".join(f"{n} steps" for n in args.steps) + " |")
        lines = [header, "|---" * (len(args.steps) + 1) + "|"]
        for name in names:
            row = " | ".join(fmt.format(res[(name, n)]) for n in args.steps)
            lines.append(f"| {name} | {row} |")
        return "\n".join(lines)

    # NLL - floor: 0 = exact distributional match; NEGATIVE = oversharpened
    # (the analytic denoiser at coarse schedules collapses samples toward
    # training points); positive = too diffuse
    deltas = {k: v - nll_held for k, v in results.items()}
    nll_tab = table_for(deltas, "{:+.2f}")
    mmd_tab = table_for(results_mmd, "{:.5f}")
    print(f"\nheld-out NLL floor: {nll_held:.2f}\n\n{nll_tab}\n\n{mmd_tab}")

    nll = np.asarray([[results[(nm, n)] for n in args.steps] for nm in names])
    mmd = np.asarray([[results_mmd[(nm, n)] for n in args.steps] for nm in names])
    ensure_dirs("stats")
    np.savez("stats/schedule_ordering.npz", steps=np.asarray(args.steps),
             names=np.asarray(names), nll=nll, nll_floor=np.asarray(nll_held),
             mmd=mmd, sigmas=np.asarray(sigmas))
    with open("schedule_ordering.md", "w") as f:
        f.write(
            f"# Schedule ordering (anisotropic GMM, dim={args.dim}, "
            f"true model, ddpm steps)\n\nNLL(samples) - NLL(held-out) under "
            f"the exact mixture (floor {nll_held:.2f}). 0 = exact match; "
            f"negative = oversharpened toward training points; positive = "
            f"too diffuse. |delta| ranks schedules.\n\n{nll_tab}"
            f"\n\nRBF-MMD vs held-out data (coarse-structure check):"
            f"\n\n{mmd_tab}\n")
    print("\nwrote schedule_ordering.md + stats/schedule_ordering.npz")
    return {"names": names, "steps": list(args.steps), "nll": nll,
            "nll_floor": nll_held, "mmd": mmd, "sigmas": sigmas,
            "stats": stats, "grids": grids}


if __name__ == "__main__":
    main()

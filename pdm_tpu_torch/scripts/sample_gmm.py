"""1-D GMM sampling experiment: the analytic Bayes-optimal denoiser on the
log-SNR schedule and, where ``optimized_log_temp.npz`` is present, on the
optimized one; MMD against the data; histograms and trajectories.

Counterpart of ``scripts/sample_gmm.py``: ``TrueDDPM`` over
``generate_gmm_1d(1_000_000)`` on ``LogSNRScheduler(1e-4, 1e1)``, DDPM-10
for 100 samples with the states tracked, MMD (sigma 0.1) against the
first 10,000 points. Run as ``python -m pdm_tpu_torch.scripts.sample_gmm
[--device cpu]``. The sizes are ``main``'s keywords (JAX's values as
defaults); ``draws`` = (x_T, noise) replaces the generator's draws of the
one batch. The figures (gmm_comparison.png, gmm_trajectories.png) need
matplotlib.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..diffusion.sampling import DDPMSampler
from ..models.base import TrueDDPM
from ..ops.mmd import mmd_rbf
from ..schedulers.analytic import LogSNRScheduler
from ..utils.synthetic import generate_gmm_1d
from ._common import pyplot

OPTIMIZED = "optimized_log_temp.npz"


def main(argv: Optional[Sequence[str]] = None, *, n_data: int = 1_000_000,
         n_steps: int = 10, n_samples: int = 100, n_ref: int = 10_000,
         draws=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    dev = resolve_device(parser.parse_args(argv).device)

    print(f"Generating GMM dataset ({n_data:.0e} samples)...")
    train_data = generate_gmm_1d(n_data)
    scheduler = LogSNRScheduler(1e-4, 1e1)
    ddpm = TrueDDPM(scheduler=scheduler, train_data=train_data, device=dev)
    ref = ddpm.train_data[:n_ref].reshape(-1, 1)

    def run(log_temp=None, name="initial"):
        sampler = DDPMSampler(
            ddpm=ddpm, scheduler=scheduler, n_steps=n_steps, obj_size=(1, 1, 1),
            batch_size=n_samples, n_samples=n_samples, step_type="ddpm",
            track_states=True, log_temp=log_temp, device=dev)
        if draws is None:
            out = sampler.sample(torch.Generator(device=dev).manual_seed(0))
        else:
            x_init, noise = (torch.as_tensor(d) for d in draws)
            out = {k: v.cpu().numpy() for k, v in sampler.batch_sample(
                x_init=x_init, noise=noise).items()}
        x = out["x"].reshape(-1)
        mmd = float(mmd_rbf(torch.as_tensor(x[:, None], device=dev), ref,
                            sigmas=(0.1,)))
        print(f"{name} schedule MMD (sigma=0.1): {mmd:.6f}")
        return x, out.get("states"), mmd

    x_init, states, mmd_init = run()
    results = [("Initial", x_init, mmd_init)]
    if os.path.exists(OPTIMIZED):
        lt = torch.as_tensor(np.load(OPTIMIZED)["log_temp"], device=dev)
        x_opt, _, mmd_opt = run(log_temp=lt, name="optimized")
        results.append(("Optimized", x_opt, mmd_opt))

    plt = pyplot("gmm_comparison.png", "gmm_trajectories.png")
    if plt is not None:
        plt.figure(figsize=(12, 8))
        plt.hist(train_data[:n_ref].reshape(-1), bins=500, density=True,
                 alpha=0.3, label="True Distribution (subset)")
        for name, x, mmd in results:
            plt.hist(x, bins=100, density=True, alpha=0.5,
                     label=f"{name} Samples (MMD: {mmd:.4f})")
        plt.legend()
        plt.title("GMM Sampling")
        plt.savefig("gmm_comparison.png")
        print("Saved gmm_comparison.png")
        traj = states.reshape(states.shape[0], -1)
        plt.figure(figsize=(10, 6))
        for i in range(min(5, traj.shape[1])):
            plt.plot(traj[::-1, i], label=f"Sample {i}")
        plt.legend()
        plt.title("Reverse Diffusion Trajectories")
        plt.savefig("gmm_trajectories.png")
        print("Saved gmm_trajectories.png")
    return {name: {"x": x, "mmd": mmd} for name, x, mmd in results} | {
        "states": states}


if __name__ == "__main__":
    main()

"""Optimize the sampling schedule's log-temperature knots against
multi-scale MMD on the 1-D GMM -> optimized_log_temp.npz.

Counterpart of ``scripts/optimize_schedule.py``, with its constants (module
names here, so that a test can lower them): the analytic denoiser
(``TrueDDPM``) over ``generate_gmm_1d(100_000)`` on
``LogSNRScheduler(1e-4, 1e1)``, 10 knots, 1000 iterations at batch 1024,
rate 1e-3, DDIM, the knots clipped to (log 1e-4, log 1e1). Run as

    python -m pdm_tpu_torch.scripts.optimize_schedule [--device cpu]

on the card by default. Besides the knots, the npz holds the MMD history
and the initial grid. The two plots (optimization_history.png,
schedule_comparison.png) need matplotlib; without it they are skipped and
stderr says so.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from ..core.device import resolve_device
from ..diffusion.sampling import discretize_schedule
from ..diffusion.schedule_opt import optimize_schedule
from ..models.base import TrueDDPM
from ..schedulers.analytic import LogSNRScheduler
from ..utils.synthetic import generate_gmm_1d

N_DATA = 100_000
MIN_TEMP, MAX_TEMP = 1e-4, 1e1
N_STEPS = 10
N_ITERS = 1000
BATCH_SIZE = 1024
LEARNING_RATE = 1e-3
STEP_TYPE = "ddim"
OUT = "optimized_log_temp.npz"


def plot(history: np.ndarray, init: np.ndarray, final: np.ndarray) -> None:
    """The JAX script's two figures, or a note on stderr without
    matplotlib."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: skipped optimization_history.png "
              f"and schedule_comparison.png (the history and the initial grid "
              f"are in {OUT})", file=sys.stderr)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 5))
    plt.plot(history)
    plt.title("MMD Optimization History (Multi-scale RBF)")
    plt.xlabel("Iteration")
    plt.ylabel("MMD")
    plt.savefig("optimization_history.png")

    plt.figure(figsize=(10, 5))
    plt.plot(init, label="Initial (Linear Log-SNR)")
    plt.plot(final, label="Optimized")
    plt.legend()
    plt.xlabel("Step index")
    plt.ylabel("log_temp")
    plt.savefig("schedule_comparison.png")
    print("Saved optimization_history.png, schedule_comparison.png")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    train_data = generate_gmm_1d(N_DATA)
    scheduler = LogSNRScheduler(MIN_TEMP, MAX_TEMP)
    ddpm = TrueDDPM(scheduler=scheduler, train_data=train_data, device=dev)
    init = discretize_schedule(scheduler, N_STEPS, device=dev)

    out = optimize_schedule(
        ddpm, ddpm.train_data, init,
        n_iters=N_ITERS, batch_size=BATCH_SIZE, learning_rate=LEARNING_RATE,
        step_type=STEP_TYPE,
        clip_range=(float(np.log(MIN_TEMP)), float(np.log(MAX_TEMP))),
        device=dev,
    )
    init_np = init.cpu().numpy()
    np.savez(OUT, log_temp=out["log_temp"], history=out["history"],
             init_log_temp=init_np)
    print(f"Optimized log_temp: {out['log_temp']}")
    plot(out["history"], init_np, out["log_temp"])
    return out


if __name__ == "__main__":
    main()

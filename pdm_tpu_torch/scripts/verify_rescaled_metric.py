"""MC rescaled-metric estimator against the closed form
G_tilde(sigma^2) = 2 s0^2 / (s0^2 + sigma^2)^2.

Counterpart of ``scripts/verify_rescaled_metric.py``: 20 sigma^2
log-spaced over [1e-2, 1e2], 10,000 N(0, 1) points (from a generator
seeded 42) and 10,000 y-samples a sigma^2 (seeded with its index). Run as
``python -m pdm_tpu_torch.scripts.verify_rescaled_metric [--device cpu]``.
The sizes are ``main``'s keywords (JAX's values as defaults); ``x`` and
``draws`` (one (idx, eps) a sigma^2) replace the draws. The plot,
rescaled_metric_comparison.png, needs matplotlib.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..core.device import resolve_device
from ..stats.mc_metric import rescaled_metric_diag
from ._common import gaussian_points, grid_draws, pyplot

PLOT = "rescaled_metric_comparison.png"


def analytical_rescaled(s2, sigma0_sq=1.0):
    return 2 * sigma0_sq / (sigma0_sq + s2) ** 2


def main(argv: Optional[Sequence[str]] = None, *, n_sigma_sqs: int = 20,
         n_points: int = 10_000, n_y: int = 10_000, x=None,
         draws=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    dev = resolve_device(parser.parse_args(argv).device)
    sigma_sqs = np.logspace(-2, 2, n_sigma_sqs)
    x = gaussian_points(n_points, dev) if x is None else x
    mc, ana = [], []
    for i, s2 in enumerate(sigma_sqs):
        generator, drawn = grid_draws(draws, i, dev)
        mc.append(float(rescaled_metric_diag(
            np.asarray([s2], np.float32), x, n_y, generator=generator,
            draws=drawn, device=dev)[0]))
        ana.append(analytical_rescaled(s2))
        print(f"sigma_sq: {s2:.4f}, Analytical: {ana[-1]:.4f}, MC: {mc[-1]:.4f}")
    plt = pyplot(PLOT)
    if plt is not None:
        plt.figure(figsize=(10, 6))
        plt.loglog(sigma_sqs, ana, "b-", label="Analytical")
        plt.loglog(sigma_sqs, mc, "ro", label="Monte Carlo Estimation")
        plt.xlabel("sigma^2")
        plt.ylabel("Rescaled Metric")
        plt.legend()
        plt.grid(True, which="both", alpha=0.5)
        plt.savefig(PLOT)
        print(f"Plot saved to {PLOT}")
    return {"sigma_sq": sigma_sqs, "mc": np.asarray(mc),
            "analytical": np.asarray(ana)}


if __name__ == "__main__":
    main()

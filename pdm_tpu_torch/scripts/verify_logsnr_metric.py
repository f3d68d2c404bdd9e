"""MC metric estimator against the closed form G(lambda) of a Gaussian
prior, lambda = log sigma^2.

Counterpart of ``scripts/verify_logsnr_metric.py``: 20 lambdas over
[-4, 4], 10,000 N(0, 1) points (from a generator seeded 42) and 10,000
y-samples a lambda (seeded with its index). Run as ``python -m
pdm_tpu_torch.scripts.verify_logsnr_metric [--device cpu]``. The sizes
are ``main``'s keywords (JAX's values as defaults); ``x`` and ``draws``
(one (idx, eps) a lambda) replace the draws. The plot,
metric_comparison_lambda.png, needs matplotlib.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..core.device import resolve_device
from ..stats.mc_metric import metric_scalar
from ._common import gaussian_points, grid_draws, pyplot

PLOT = "metric_comparison_lambda.png"


def analytical_metric_lambda(lam, sigma0=1.0):
    s2 = np.exp(lam)
    return 0.5 * sigma0 ** 2 * (sigma0 ** 2 + 2 * s2) / (sigma0 ** 2 + s2) ** 2


def main(argv: Optional[Sequence[str]] = None, *, n_lambdas: int = 20,
         n_points: int = 10_000, n_y: int = 10_000, x=None,
         draws=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    dev = resolve_device(parser.parse_args(argv).device)
    lambdas = np.linspace(-4, 4, n_lambdas)
    x = gaussian_points(n_points, dev) if x is None else x
    mc, ana = [], []
    for i, lam in enumerate(lambdas):
        generator, drawn = grid_draws(draws, i, dev)
        mc.append(float(metric_scalar(float(lam), x, n_y, generator=generator,
                                      draws=drawn, device=dev)))
        ana.append(analytical_metric_lambda(lam))
        print(f"lambda: {lam:.4f}, Analytical: {ana[-1]:.4f}, MC: {mc[-1]:.4f}")
    plt = pyplot(PLOT)
    if plt is not None:
        plt.figure(figsize=(10, 6))
        plt.plot(lambdas, ana, "b-", label="Analytical")
        plt.plot(lambdas, mc, "ro", label="Monte Carlo Estimation")
        plt.xlabel("lambda = ln sigma^2")
        plt.ylabel("Metric G(lambda)")
        plt.legend()
        plt.grid(True, alpha=0.5)
        plt.savefig(PLOT)
        print(f"Plot saved to {PLOT}")
    return {"lambda": lambdas, "mc": np.asarray(mc), "analytical": np.asarray(ana)}


if __name__ == "__main__":
    main()

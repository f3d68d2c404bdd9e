"""MC metric estimator against the closed-form Gaussian metric
G(sigma) = 2 s0^2 (s0^2 + 2 s^2) / (s^2 (s0^2 + s^2)^2).

Counterpart of ``scripts/verify_mc_metric.py``: 20 sigmas log-spaced over
[0.1, 10], 10,000 N(0, 1) points (from a generator seeded 42) and 10,000
y-samples a sigma (seeded with its index); the MC estimate of G(lambda),
lambda = log sigma^2, is converted with G(sigma) = G(lambda) (2 / sigma)^2.
Run as ``python -m pdm_tpu_torch.scripts.verify_mc_metric [--device
cpu]``. The sizes are ``main``'s keywords (JAX's values as defaults);
``x`` and ``draws`` (one (idx, eps) a sigma) replace the draws. The plot,
metric_comparison.png, needs matplotlib.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..core.device import resolve_device
from ..stats.mc_metric import metric_scalar
from ._common import gaussian_points, grid_draws, pyplot

PLOT = "metric_comparison.png"


def analytical_metric(sigma, sigma0=1.0):
    return (2 * sigma0 ** 2 * (sigma0 ** 2 + 2 * sigma ** 2)
            / (sigma ** 2 * (sigma0 ** 2 + sigma ** 2) ** 2))


def main(argv: Optional[Sequence[str]] = None, *, n_sigmas: int = 20,
         n_points: int = 10_000, n_y: int = 10_000, x=None,
         draws=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    dev = resolve_device(parser.parse_args(argv).device)
    sigma0 = 1.0
    sigmas = np.logspace(-1, 1, n_sigmas)
    x = gaussian_points(n_points, dev) * sigma0 if x is None else x
    mc, ana = [], []
    for i, s in enumerate(sigmas):
        lam = float(np.log(s ** 2))
        generator, drawn = grid_draws(draws, i, dev)
        g_lambda = float(metric_scalar(lam, x, n_y, generator=generator,
                                       draws=drawn, device=dev))
        mc.append(g_lambda * (2.0 / s) ** 2)  # d lambda / d sigma = 2 / sigma
        ana.append(analytical_metric(s, sigma0))
        print(f"sigma: {s:.4f}, Analytical: {ana[-1]:.4f}, MC: {mc[-1]:.4f}")
    plt = pyplot(PLOT)
    if plt is not None:
        plt.figure(figsize=(10, 6))
        plt.loglog(sigmas, ana, "b-", label="Analytical")
        plt.loglog(sigmas, mc, "ro", label="Monte Carlo Estimation")
        plt.xlabel("sigma")
        plt.ylabel("Metric G(sigma)")
        plt.legend()
        plt.grid(True, which="both", alpha=0.5)
        plt.savefig(PLOT)
        print(f"Plot saved to {PLOT}")
    return {"sigma": sigmas, "mc": np.asarray(mc), "analytical": np.asarray(ana)}


if __name__ == "__main__":
    main()

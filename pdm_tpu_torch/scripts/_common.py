"""Helpers shared by the entry points."""

from __future__ import annotations

import os
import sys

import numpy as np

SAMPLER_BATCH = 500


def sampler_batch(n_samples: int) -> int:
    """A sampler's batch: SAMPLER_BATCH (the JAX scripts' 500), or
    ``n_samples`` where that is smaller."""
    return min(SAMPLER_BATCH, n_samples)


def ensure_dirs(*names: str) -> None:
    for name in names:
        os.makedirs(name, exist_ok=True)


def temp_grid(min_temp: float, max_temp: float, n: int) -> np.ndarray:
    """``n`` temperatures log-spaced over [min_temp, max_temp]."""
    return np.logspace(np.log10(min_temp), np.log10(max_temp), n)


def pyplot(*figures: str):
    """matplotlib's pyplot on the Agg backend; None where matplotlib is not
    installed, with a note on stderr naming the ``figures`` skipped."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: skipped {', '.join(figures)}",
              file=sys.stderr)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def gaussian_points(n: int, device, seed: int = 42) -> "torch.Tensor":
    """``n`` N(0, 1) points of one dimension from
    ``torch.Generator(device).manual_seed(seed)`` (the JAX scripts draw
    theirs from ``PRNGKey(42)``)."""
    import torch

    return torch.randn((n, 1), generator=torch.Generator(device=device)
                       .manual_seed(seed), device=device)


def draws_or_seed(draws, seed: int, device) -> dict:
    """A sweep's keywords: ``draws`` where given, else a generator seeded
    ``seed`` (the JAX scripts' ``PRNGKey(seed)``)."""
    import torch

    if draws is not None:
        return {"draws": draws}
    return {"generator": torch.Generator(device=device).manual_seed(seed)}


def grid_draws(draws, i: int, device):
    """(generator, draws) of grid point ``i``: the given draws, else a
    generator seeded with ``i`` (the JAX scripts' ``PRNGKey(i)``)."""
    import torch

    if draws is not None:
        return None, draws[i]
    return torch.Generator(device=device).manual_seed(i), None

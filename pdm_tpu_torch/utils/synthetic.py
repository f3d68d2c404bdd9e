"""Synthetic datasets of the paper's experiments (numpy, from a seed).

A copy of the GMM generators of ``pdm_tpu/utils/synthetic.py`` (the
reference's ``scripts/sample_gmm.py`` and ``scripts/reproduce_high_dim.py``
datasets), draw for draw, so that both packages see the same data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def generate_gmm_1d(
    n_samples: int = 1_000_000,
    means: Tuple[float, ...] = (-1.1, -0.9, 0.9, 1.1),
    std: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """The reference's 4-mode 1-D GMM, shaped (N, 1, 1, 1)."""
    rng = np.random.RandomState(seed)
    means_a = np.asarray(means)
    comp = rng.randint(0, len(means_a), n_samples)
    x = means_a[comp] + std * rng.randn(n_samples)
    return x.astype(np.float32).reshape(n_samples, 1, 1, 1)


def generate_anisotropic_gmm(
    dim: int = 100,
    n_components: int = 5,
    n_samples: int = 100_000,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """High-dimensional anisotropic GMM: N(0, I) means; covariances
    Q diag(0.01 e^{-linspace(0, 5)}) Q^T with Haar-random Q. Returns
    (samples (N, 1, dim, 1), means, covs)."""
    rng = np.random.RandomState(seed)
    means = rng.randn(n_components, dim).astype(np.float64)
    covs = []
    chols = []
    for _ in range(n_components):
        q, _ = np.linalg.qr(rng.randn(dim, dim))
        s = np.exp(-np.linspace(0, 5, dim)) * 0.01
        cov = (q * s[None, :]) @ q.T
        covs.append(cov)
        chols.append(np.linalg.cholesky(cov + 1e-8 * np.eye(dim)))
    comp = rng.randint(0, n_components, n_samples)
    z = rng.randn(n_samples, dim)
    samples = np.empty((n_samples, dim), dtype=np.float64)
    for i in range(n_components):
        mask = comp == i
        samples[mask] = means[i] + z[mask] @ chols[i].T
    return (
        samples.astype(np.float32).reshape(n_samples, 1, dim, 1),
        means.astype(np.float32),
        np.stack(covs).astype(np.float32),
    )

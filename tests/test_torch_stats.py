"""Port parity: the thermodynamic sweeps (pdm_tpu_torch.stats.sweep).

The JAX package's ``thermo_sweep`` draws each batch's trajectory starts
with ``split`` and its shared noise with ``fold_in(key, batch)``; the test
derives those draws (``jax_draws``) and replays them in the port through
``draws=``, so both sweep the same starts and noise. On the CPU the JAX
sweep is its per-temperature XLA path and the port's is the kernel's plain
version (the shared-noise decomposition), both fp32: they differ by the
Grams' summation order, 1e-5 of each curve's scale (1e-4 relative for
the variance-based curves, whose e2 - e1^2 cancels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.stats.sweep import (
    forward_stats as j_forward_stats,
    metric_stats as j_metric_stats,
    thermo_sweep as j_thermo_sweep,
)

from pdm_tpu_torch.stats.sweep import forward_stats, metric_stats, thermo_sweep

from torch_port_fixtures import two_torch_threads  # noqa: F401

CURVES = ("entropy", "free_energy", "heat_capacity", "metric")


def jax_draws(key, n, d, n_samples, batch_size):
    """The JAX sweep's (idx, eps) per batch (stats/sweep.py:233-247)."""
    out, seen, bi = [], 0, 0
    while seen < n_samples:
        bs = min(batch_size, n_samples - seen)
        key, sub = jax.random.split(key)
        idx = jax.random.randint(sub, (bs,), 0, n)
        eps = jax.random.normal(jax.random.fold_in(key, bi), (bs, d))
        out.append((torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(eps))))
        seen += bs
        bi += 1
    return out


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * (1.0 + float(np.abs(want).max())))


def _data(n=130, d=6, seed=3):
    return np.random.RandomState(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("kw", [
    {},
    {"regularize": True},
    {"regularize": True, "global_sigma_reg_sq": 0.05},
    {"regularize": True, "adaptive_knn": True, "knn_k": 3},
    {"regularize": True, "adaptive_knn": True, "knn_k": 2, "sigma_reg_scale": 4.0},
], ids=["plain", "floor", "floor_0.05", "knn3", "knn2_scaled"])
def test_thermo_sweep_matches_jax(kw):
    """Three batches (the last one short), every curve and key."""
    data = _data()
    temp = np.logspace(-2, 1, 9)
    key = jax.random.PRNGKey(0)
    want = j_thermo_sweep(key, jnp.asarray(data), temp, n_samples=64,
                          batch_size=24, **kw)
    got = thermo_sweep(data, temp, 64, 24, draws=jax_draws(key, 130, 6, 64, 24),
                       device="cpu", **kw)
    assert set(got) == set(want)
    for k in CURVES:
        _close(got[k], want[k], rtol=1e-4 if k in ("heat_capacity", "metric") else 1e-5)
    np.testing.assert_array_equal(got["temp"], want["temp"])
    np.testing.assert_allclose(got["log_temp"], want["log_temp"], rtol=1e-12)
    _close(got["dataset_tr_sigma0"], want["dataset_tr_sigma0"])


def test_forward_and_metric_stats_match_jax():
    data = _data(200, 4, seed=5)
    temp = np.logspace(-3, 1, 7)
    key = jax.random.PRNGKey(2)
    draws = jax_draws(key, 200, 4, 48, 48)
    want = j_forward_stats(key, jnp.asarray(data), temp, n_samples=48, batch_size=48)
    got = forward_stats(data, temp, 48, 48, draws=draws, device="cpu")
    assert set(got) == set(want) == {"temp", "entropy", "free_energy", "heat_capacity"}
    for k in ("entropy", "free_energy"):
        _close(got[k], want[k])
    _close(got["heat_capacity"], want["heat_capacity"], rtol=1e-4)
    want = j_metric_stats(key, jnp.asarray(data), temp, n_samples=48, batch_size=48,
                          regularize=True, adaptive_knn=True, knn_k=4)
    got = metric_stats(data, temp, 48, 48, draws=draws, regularize=True,
                       adaptive_knn=True, knn_k=4, device="cpu")
    assert set(got) == set(want) == {"temp", "metric", "log_temp", "dataset_tr_sigma0"}
    _close(got["metric"], want["metric"], rtol=1e-4)
    _close(got["dataset_tr_sigma0"], want["dataset_tr_sigma0"])


def test_streamed_tier_matches_device_resident_and_jax():
    """The host-streaming tier (three uneven chunks, exact merges) against
    the device-resident sweep on the same draws, and against the JAX
    package's streamed tier (tests/test_stats.py:358)."""
    data = _data()
    temp = np.logspace(-2, 1, 9)
    key = jax.random.PRNGKey(0)
    draws = jax_draws(key, 130, 6, 64, 64)
    resident = thermo_sweep(data, temp, 64, 64, draws=draws, device="cpu")
    streamed = thermo_sweep(data, temp, 64, 64, draws=draws, stream_chunk=48,
                            device="cpu")
    j_streamed = j_thermo_sweep(key, data, temp, n_samples=64, batch_size=64,
                                stream_chunk=48)
    for k in CURVES:
        np.testing.assert_allclose(streamed[k], resident[k], rtol=1e-4, atol=1e-5)
        _close(streamed[k], j_streamed[k], rtol=1e-4)
    np.testing.assert_allclose(streamed["dataset_tr_sigma0"],
                               resident["dataset_tr_sigma0"], rtol=1e-5)
    with pytest.raises(ValueError, match="adaptive_knn"):
        thermo_sweep(data, temp, 8, 8, stream_chunk=48, adaptive_knn=True,
                     regularize=True, device="cpu")


def test_generator_draws_are_reproducible():
    data = torch.from_numpy(_data())
    temp = np.logspace(-1, 1, 4)
    a = thermo_sweep(data, temp, 20, 8, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    b = thermo_sweep(data, temp, 20, 8, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    for k in CURVES:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="sizes"):
        thermo_sweep(data, temp, 20, 8, draws=[(torch.zeros(8), torch.zeros(8, 6))],
                     device="cpu")


def test_forward_stats_gaussian_entropy():
    """Gaussian closed form (tests/test_stats.py::
    test_forward_stats_gaussian_entropy): for N(0, 1) data the dataset
    entropy tends to S = 0.5 log(v), v = T / (1 + T), in the mid range of
    T, is non-decreasing, and is ~0 at the largest T."""
    rng = np.random.RandomState(5)
    data = rng.randn(30_000, 1).astype(np.float32)
    temp = np.logspace(-3, 3, 13)
    out = forward_stats(data, temp, 512, 512,
                        generator=torch.Generator().manual_seed(4), device="cpu")
    S = out["entropy"]
    assert np.all(np.diff(S) > -1e-3)
    np.testing.assert_allclose(S[-1], 0.0, atol=0.02)
    v = temp / (1.0 + temp)
    np.testing.assert_allclose(S[3:9], 0.5 * np.log(v)[3:9], atol=0.06)

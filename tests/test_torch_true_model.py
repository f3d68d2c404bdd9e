"""Port parity: the analytic Bayes-optimal denoiser and what is built on it
(pdm_tpu_torch.ops.{boltzmann,distance,mmd}, models.base.TrueDDPM,
schedulers.base, stats.{model_metric,mc_metric}, utils.synthetic).

The same numpy inputs go through the JAX package and the port on the CPU;
where the JAX side draws random numbers, the test derives its draws with
the calls it makes and replays them in the port. Both sides compute the
posterior in fp32 with the same decomposition and differ in the order of
their sums: about 1e-6 relative in a logit at these sizes, which moves a
posterior mean by at most expm1(2 delta) of the payload's range, so 1e-5
on the ops and 1e-4 relative on the estimators (their variances cancel).
The samplers chain 6-10 such steps; the CIFAR-shaped case also checks that
NHWC noise and data transposed together to NCHW give the same samples.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.diffusion import sampling as js
from pdm_tpu.models.base import TrueDDPM as JTrueDDPM
from pdm_tpu.ops import boltzmann as jb
from pdm_tpu.ops.distance import compute_pw_dist_sqr as j_pw
from pdm_tpu.ops.mmd import mmd_rbf as j_mmd
from pdm_tpu.schedulers.analytic import (
    LinearBetaScheduler as JLinear, LogSNRScheduler as JLogSNR,
)
from pdm_tpu.stats import mc_metric as jmc
from pdm_tpu.stats import model_metric as jmm
from pdm_tpu.utils import synthetic as jsyn

from pdm_tpu_torch.diffusion import sampling as ts
from pdm_tpu_torch.models.base import TrueDDPM
from pdm_tpu_torch.ops import boltzmann as tb
from pdm_tpu_torch.ops.distance import compute_pw_dist_sqr, norm_sqr
from pdm_tpu_torch.ops.mmd import mmd_rbf
from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler, LogSNRScheduler
from pdm_tpu_torch.stats import mc_metric as tmc
from pdm_tpu_torch.stats import model_metric as tmm
from pdm_tpu_torch.utils import synthetic as tsyn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_fixtures import (  # noqa: E402
    jax_sampler_draws, two_torch_threads,  # noqa: F401
)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_posterior_mean_and_score_match_jax():
    """The op-level denoiser and its scheduler wrappers, per-row log T."""
    rng = np.random.RandomState(0)
    xt = rng.randn(8, 2, 3).astype(np.float32)
    data = rng.randn(200, 2, 3).astype(np.float32)
    log_temp = np.linspace(-3.0, 2.0, 8).astype(np.float32)
    for name in ("true_posterior_mean_x0", "true_score"):
        want = getattr(jb, name)(jnp.asarray(xt), jnp.asarray(log_temp),
                                 jnp.asarray(data))
        got = getattr(tb, name)(_t(xt), _t(log_temp), _t(data))
        assert got.shape == xt.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    tau = np.linspace(0.1, 0.9, 8).astype(np.float32)
    js_, ts_ = JLogSNR(1e-3, 1e1), LogSNRScheduler(1e-3, 1e1)
    for name in ("true_posterior_mean_x0", "true_score"):
        want = getattr(js_, name)(jnp.asarray(xt), jnp.asarray(tau), jnp.asarray(data))
        got = getattr(ts_, name)(_t(xt), _t(tau), _t(data))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    half = tb.true_posterior_mean_x0(_t(xt).bfloat16(), _t(log_temp), _t(data))
    assert half.dtype == torch.bfloat16  # cast back to xt's dtype, as JAX


@pytest.mark.parametrize("step_type", ["ddpm", "ddim"])
def test_gmm_sampling_matches_jax(step_type):
    """TrueDDPM on the 4-mode 1-D GMM (tests/test_sampler.py:54-89) with
    JAX's noise: the same samples to 1e-4 (the final step returns the
    posterior mean at T = 1e-4, where neighbouring points of a mode lie
    ~1e-5 apart), every sample near a mode."""
    data = tsyn.generate_gmm_1d(2000, seed=0)
    key = jax.random.PRNGKey(1)
    shape = (64, 1, 1, 1)
    want = js.DDPMSampler(
        ddpm=JTrueDDPM(scheduler=JLogSNR(1e-4, 1e1), train_data=jnp.asarray(data)),
        scheduler=JLogSNR(1e-4, 1e1), n_steps=10, obj_size=shape[1:],
        batch_size=64, step_type=step_type).batch_sample(key)["x"]
    x_init, noise = jax_sampler_draws(key, 10, shape)
    sched = LogSNRScheduler(1e-4, 1e1)
    got = ts.DDPMSampler(
        ddpm=TrueDDPM(sched, torch.from_numpy(data), device="cpu"), scheduler=sched,
        n_steps=10, obj_size=shape[1:], batch_size=64, step_type=step_type,
        device="cpu").batch_sample(x_init=_t(x_init), noise=_t(noise))["x"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    modes = np.array([-1.1, -0.9, 0.9, 1.1])
    assert np.abs(got.numpy().reshape(-1, 1) - modes).min(1).max() < 0.1


def test_cifar_shaped_sampling_matches_jax():
    """Images (4, 4, 3) in JAX's NHWC and the port's NCHW: the data and
    JAX's noise transposed together give the same DDIM samples (1e-4 of
    their scale), LinearBetaScheduler over the flagship's range."""
    rng = np.random.RandomState(2)
    data = rng.randn(96, 4, 4, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    shape = (6, 4, 4, 3)
    want = np.asarray(js.DDPMSampler(
        ddpm=JTrueDDPM(scheduler=JLinear(1e-4, 2.478e4), train_data=jnp.asarray(data)),
        scheduler=JLinear(1e-4, 2.478e4), n_steps=6, obj_size=shape[1:],
        batch_size=6, step_type="ddim").batch_sample(key)["x"])
    x_init, noise = jax_sampler_draws(key, 6, shape)
    sched = LinearBetaScheduler(1e-4, 2.478e4)
    got = ts.DDPMSampler(
        ddpm=TrueDDPM(sched, torch.from_numpy(data.transpose(0, 3, 1, 2)),
                      device="cpu"),
        scheduler=sched, n_steps=6, obj_size=(3, 4, 4), batch_size=6,
        step_type="ddim", device="cpu").batch_sample(
            x_init=_t(x_init.transpose(0, 3, 1, 2)),
            noise=_t(noise.transpose(0, 1, 4, 2, 3)))["x"]
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def jax_metric_draws(key, n, obj_shape, n_temps, n_samples, batch_size, noising):
    """model_metric_stats's (idx, eps) per batch (stats/model_metric.py:
    split per batch, fold_in(key, batch) then fold_in(., temperature); VP
    noise through add_noise's second split)."""
    out, seen, bi = [], 0, 0
    while seen < n_samples:
        bs = min(batch_size, n_samples - seen)
        key, sub = jax.random.split(key)
        idx = jax.random.randint(sub, (bs,), 0, n)
        kb = jax.random.fold_in(key, bi)
        eps = []
        for i in range(n_temps):
            k = jax.random.fold_in(kb, i)
            if noising == "vp":
                k = jax.random.split(k)[1]
            eps.append(jax.random.normal(k, (bs, *obj_shape)))
        out.append((_t(idx), _t(jnp.stack(eps))))
        seen += bs
        bi += 1
    return out


@pytest.mark.parametrize("noising", ["ve", "vp"])
def test_model_metric_stats_match_jax(noising):
    rng = np.random.RandomState(8)
    data = rng.randn(2000, 1, 1, 1).astype(np.float32)
    temp = np.logspace(-1, 1, 4)
    key = jax.random.PRNGKey(8)
    jd = JTrueDDPM(scheduler=JLogSNR(1e-3, 1e3), train_data=jnp.asarray(data))
    td = TrueDDPM(LogSNRScheduler(1e-3, 1e3), torch.from_numpy(data), device="cpu")
    want = jmm.model_metric_stats(key, jd, jnp.asarray(data), temp, n_samples=80,
                                  batch_size=48, noising=noising)
    draws = jax_metric_draws(key, 2000, (1, 1, 1), 4, 80, 48, noising)
    got = tmm.model_metric_stats(td, data, temp, 80, 48, noising, draws=draws,
                                 device="cpu")
    assert set(got) == set(want)
    np.testing.assert_allclose(got["metric"], want["metric"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["dataset_tr_sigma0"], want["dataset_tr_sigma0"],
                               rtol=1e-5)
    np.testing.assert_array_equal(got["log_temp"], want["log_temp"])
    if noising == "vp":
        want = jmm.empirical_entropy_stats(key, jd, jnp.asarray(data), temp,
                                           n_samples=80, batch_size=48)
        got = tmm.empirical_entropy_stats(td, data, temp, 80, 48, draws=draws,
                                          device="cpu")
        assert set(got) == set(want)
        for k in ("entropy", "rescaled_entropy", "d_entropy_d_log_temp"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)
        assert got["entropy"][-1] == 0.0 and got["rescaled_entropy"][-1] == 0.0


def test_entropy_integration_golden_alignment():
    """The prepend-zero alignment against the reference's golden artifact
    (tests/test_stats.py::test_empirical_entropy_golden_alignment):
    ours[k + 1] equals the reference's [k]; and equal to the JAX
    package's integration on the same input."""
    fix = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                               "empirical_entropy_golden.npz"))
    temp = fix["temp"].astype(np.float64)
    ds = fix["d_entropy_d_log_temp"].astype(np.float64)
    ours = tmm.integrate_entropy_curves(ds, temp, np.log(temp))
    theirs = jmm.integrate_entropy_curves(ds, temp, np.log(temp))
    for key in ("entropy", "rescaled_entropy"):
        np.testing.assert_allclose(ours[key][1:], fix[key].astype(np.float64)[:-1],
                                   rtol=1e-4, atol=5e-4)
        np.testing.assert_array_equal(ours[key], theirs[key])
        assert ours[key][-1] == 0.0


def _mc_draws(key, k, d, n_y):
    """mc_metric's draws: split, indices from the first key, noise from
    the second."""
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.randint(k1, (n_y,), 0, k)),
            _t(jax.random.normal(k2, (n_y, d))))


def test_mc_metric_estimators_match_jax():
    x = np.array(jax.random.normal(jax.random.PRNGKey(42), (400, 3)))
    key = jax.random.PRNGKey(0)
    draws = _mc_draws(key, 400, 3, 300)
    for lam in (-1.0, 0.5):
        want = float(jmc.metric_scalar(jnp.asarray(lam), jnp.asarray(x), key, n_y=300))
        got = float(tmc.metric_scalar(lam, x, 300, draws=draws, device="cpu"))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    lam = np.array([-1.0, 0.0, 1.0], np.float32)
    want = np.asarray(jmc.metric_matrix_diag(jnp.asarray(lam), jnp.asarray(x), key, n_y=300))
    got = tmc.metric_matrix_diag(lam, x, 300, draws=draws, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    sig = np.array([0.3, 1.0, 3.0], np.float32)
    want = np.asarray(jmc.rescaled_metric_diag(jnp.asarray(sig), jnp.asarray(x), key,
                                               n_y=300))
    got = tmc.rescaled_metric_diag(sig, x, 300, draws=draws, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_distances_and_mmd_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(50, 2, 3).astype(np.float32)
    y = rng.randn(40, 2, 3).astype(np.float32)
    for args in ((x,), (x, y)):
        want = np.asarray(j_pw(*map(jnp.asarray, args)))
        got = compute_pw_dist_sqr(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.max()))
    np.testing.assert_allclose(norm_sqr(torch.from_numpy(x)).numpy(),
                               (x.reshape(50, -1) ** 2).sum(1), rtol=1e-6)
    for sigmas in ((1.0,), (0.1, 1.0, 10.0)):
        want = float(j_mmd(jnp.asarray(x), jnp.asarray(y), sigmas=sigmas))
        got = float(mmd_rbf(torch.from_numpy(x), torch.from_numpy(y), sigmas=sigmas))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_synthetic_generators_are_the_jax_packages():
    np.testing.assert_array_equal(tsyn.generate_gmm_1d(1000, seed=3),
                                  jsyn.generate_gmm_1d(1000, seed=3))
    for a, b in zip(tsyn.generate_anisotropic_gmm(dim=12, n_samples=300),
                    jsyn.generate_anisotropic_gmm(dim=12, n_samples=300)):
        np.testing.assert_array_equal(a, b)

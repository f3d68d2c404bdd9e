"""Port parity: interpolation and the knot-based schedulers
(pdm_tpu_torch.core.interp, pdm_tpu_torch.schedulers.interpolated).

The knot construction is float64 numpy on both sides and the knots fp32,
so knots must agree exactly and maps to fp32 rounding (1e-6 relative).
The .npz artifacts cross between the packages both ways. A 6-step DDIM
sample of the tiny UNet on an entropy schedule runs in both packages from
JAX's own initial noise (tests/test_torch_sampler.py's setup): fp32, 1e-4
of the sample scale, as that file's sampler test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.core.interp import interp1d as j_interp1d
from pdm_tpu.diffusion import sampling as js
from pdm_tpu.schedulers import interpolated as ji
from pdm_tpu.stats.sweep import forward_stats as j_forward_stats

from pdm_tpu_torch.core.interp import interp1d
from pdm_tpu_torch.diffusion import sampling as ts
from pdm_tpu_torch.schedulers import interpolated as ti
from pdm_tpu_torch.stats.sweep import forward_stats

from test_torch_sampler import B, N_STEPS, SIZE, models  # noqa: F401
from torch_port_fixtures import jax_sampler_draws, two_torch_threads  # noqa: F401

XK = np.array([0.0, 1.0, 3.0, 3.0, 7.0], np.float32)  # one zero-width segment
YK = np.array([1.0, 2.0, 0.0, 5.0, 8.0], np.float32)
XQ = np.array([-2.0, 0.0, 0.5, 2.0, 3.0, 5.0, 7.0, 9.5], np.float32)


def _knots_equal(got, want):
    np.testing.assert_array_equal(got.timestamps.numpy(), np.asarray(want.timestamps))
    np.testing.assert_array_equal(got.log_temp.numpy(), np.asarray(want.log_temp))


def _maps_match(got, want):
    tau = np.linspace(-0.1, 1.1, 61, dtype=np.float32)  # extrapolates at both ends
    lt_want = np.array(want.log_temp_from_tau(jnp.asarray(tau)))
    lt_got = got.log_temp_from_tau(torch.from_numpy(tau)).numpy()
    np.testing.assert_allclose(lt_got, lt_want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.tau_from_log_temp(torch.from_numpy(lt_want)).numpy(),
                               np.asarray(want.tau_from_log_temp(jnp.asarray(lt_want))),
                               rtol=1e-6, atol=1e-6)


def test_interp1d_matches_jax_with_extrapolation_and_ties():
    got = interp1d(torch.from_numpy(XK), torch.from_numpy(YK), torch.from_numpy(XQ))
    want = j_interp1d(jnp.asarray(XK), jnp.asarray(YK), jnp.asarray(XQ))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # edges extrapolate linearly (not clamped); the tie weighs 0.5 each
    assert got[0].item() == pytest.approx(-1.0) and got[-1].item() == pytest.approx(9.875)
    assert got[4].item() == pytest.approx(0.0)  # searchsorted left lands on the 1..3 segment
    scalar = interp1d(torch.from_numpy(XK), torch.from_numpy(YK), 0.5)
    assert scalar.shape == () and scalar.item() == pytest.approx(1.5)


def test_interp1d_differentiable_in_all_three_arguments():
    xk, yk, xq = (torch.from_numpy(a).double().requires_grad_() for a in (XK, YK, XQ))
    got = torch.autograd.grad(interp1d(xk, yk, xq).sum(), (xk, yk, xq))
    jax.config.update("jax_enable_x64", True)
    try:
        want = jax.grad(lambda a, b, c: j_interp1d(a, b, c).sum(), argnums=(0, 1, 2))(
            *(jnp.asarray(a, jnp.float64) for a in (XK, YK, XQ)))
    finally:
        jax.config.update("jax_enable_x64", False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


def test_interpolated_scheduler_roundtrip():
    timestamps = np.linspace(0, 1, 17)
    log_temp = np.sort(np.random.RandomState(0).uniform(-8, 8, 17))
    sched = ti.InterpolatedScheduler(torch.tensor(timestamps, dtype=torch.float32),
                                     torch.tensor(log_temp, dtype=torch.float32))
    _maps_match(sched, ji.InterpolatedScheduler(jnp.asarray(timestamps, jnp.float32),
                                                jnp.asarray(log_temp, jnp.float32)))
    tau = torch.linspace(0, 1, 101)
    torch.testing.assert_close(sched.tau_from_log_temp(sched.log_temp_from_tau(tau)),
                               tau, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [
    {"extrapolate": False},
    {"extrapolate": True, "min_temp": 1e-4},
    {"extrapolate": True, "min_temp": 1e-1, "max_temp": 30.0},
])
def test_entropy_scheduler_matches_jax(kw):
    """A noisy, locally non-monotone S(T) (the monotone-knot reduction
    drops knots), with and without the tangent extrapolation."""
    temp = np.logspace(-2, 2, 40)
    entropy = np.tanh(np.log(temp) / 3) + 0.02 * np.random.RandomState(1).randn(40)
    got = ti.entropy_scheduler(temp, entropy, device="cpu", **kw)
    want = ji.entropy_scheduler(temp, entropy, **kw)
    assert got.timestamps.shape[0] < 41  # knots were dropped
    _knots_equal(got, want)
    _maps_match(got, want)
    t2, s2 = ti.extrapolate_entropy(temp, entropy, 1e-4)
    jt2, js2 = ji.extrapolate_entropy(temp, entropy, 1e-4)
    np.testing.assert_array_equal(t2, jt2)
    np.testing.assert_array_equal(s2, js2)


def test_metric_scheduler_and_arc_length_match_jax():
    rng = np.random.RandomState(2)
    log_temp = rng.permutation(np.linspace(-5, 5, 30))  # unsorted on purpose
    metric = np.abs(rng.randn(30)) + 0.1
    lt, r = ti.fisher_rao_arc_length(log_temp, metric)
    jlt, jr = ji.fisher_rao_arc_length(log_temp, metric)
    np.testing.assert_array_equal(lt, jlt)
    np.testing.assert_array_equal(r, jr)
    got = ti.metric_scheduler(log_temp, metric, device="cpu")
    want = ji.metric_scheduler(log_temp, metric)
    _knots_equal(got, want)
    _maps_match(got, want)


def test_from_alpha_bars_and_custom_match_jax(tmp_path):
    betas = np.linspace(1e-4, 2e-2, 1000)
    ab = np.cumprod(1 - betas).astype(np.float32)
    got = ti.from_alpha_bars(ab, device="cpu")
    want = ji.from_alpha_bars(ab)
    np.testing.assert_allclose(got.log_temp.numpy(), np.asarray(want.log_temp),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.timestamps.numpy(), np.asarray(want.timestamps),
                               rtol=1e-6, atol=1e-7)
    log_temp = np.linspace(-6, 9, 12)
    np.savez(tmp_path / "plain.npz", log_temp=log_temp)
    np.savez(tmp_path / "timed.npz", log_temp=log_temp,
             timestamps=np.linspace(0, 1, 12) ** 2)
    for name in ("plain.npz", "timed.npz"):
        path = str(tmp_path / name)
        _knots_equal(ti.custom_scheduler(path, device="cpu"), ji.custom_scheduler(path))


def test_stats_npz_artifacts_cross_between_packages(tmp_path):
    """An .npz written from the port's forward/metric stats is read by the
    JAX package's loaders, and one written from JAX's by the port's: the
    knots agree exactly either way."""
    data = np.random.RandomState(4).standard_normal((400, 3)).astype(np.float32)
    temp = np.logspace(-3, 2, 12)
    port = forward_stats(data, temp, 64, 64, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    jax_out = j_forward_stats(jax.random.PRNGKey(0), jnp.asarray(data), temp,
                              n_samples=64, batch_size=64)
    kw = {"extrapolate": True, "min_temp": 1e-4, "max_temp": 1e2}
    for name, stats in (("port.npz", port), ("jax.npz", jax_out)):
        path = str(tmp_path / name)
        np.savez(path, **{k: np.asarray(v) for k, v in stats.items()})
        _knots_equal(ti.entropy_scheduler_from_npz(path, device="cpu", **kw),
                     ji.entropy_scheduler_from_npz(path, **kw))
    path = str(tmp_path / "metric.npz")
    np.savez(path, log_temp=np.log(temp), metric=np.asarray(port["heat_capacity"]) + 1e-3)
    _knots_equal(ti.metric_scheduler_from_npz(path, device="cpu"),
                 ji.metric_scheduler_from_npz(path))


def test_ddim_sample_on_entropy_schedule_matches_jax(models):
    """The tiny UNet's 6-step DDIM sample on an entropy schedule built from
    the port's own forward stats, in both packages from JAX's draws."""
    jm, tm = models
    data = np.random.RandomState(6).standard_normal((300, 3)).astype(np.float32)
    temp = np.logspace(-4, 2, 16)
    stats = forward_stats(data, temp, 64, 64, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    kw = {"extrapolate": True, "min_temp": 1e-4, "max_temp": 1e2}
    t_sched = ti.entropy_scheduler(stats["temp"], stats["entropy"], device="cpu", **kw)
    j_sched = ji.entropy_scheduler(stats["temp"], stats["entropy"], **kw)
    shape = (B, 3, SIZE, SIZE)
    key = jax.random.PRNGKey(11)
    want = js.DDPMSampler(ddpm=jm, scheduler=j_sched, n_steps=N_STEPS,
                          obj_size=shape[1:], batch_size=B, n_samples=B,
                          step_type="ddim").batch_sample(key)["x"]
    x_init, _ = jax_sampler_draws(key, N_STEPS, shape)
    got = ts.DDPMSampler(ddpm=tm, scheduler=t_sched, n_steps=N_STEPS,
                         obj_size=shape[1:], batch_size=B, n_samples=B,
                         step_type="ddim", device="cpu",
                         ).batch_sample(x_init=torch.from_numpy(x_init))["x"]
    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))

"""Port parity: the reverse-process sampler (pdm_tpu_torch.diffusion).

* ``_step_tables`` on the same log-temperature grid, every key, at 10 and
  1000 steps. The two libraries' fp32 sigmoids differ by up to 1 ulp, and
  ``beta = 1 - ab / ab_prev`` cancels: at 1000 steps adjacent levels are
  ~1e-3 apart, which amplifies that ulp ~1e3-fold in the keys built on
  beta (measured 2.5e-5 relative). So rtol 1e-6 at 10 steps, 5e-5 at 1000.
* The whole sampler on the tiny UNet with the same weights, for all four
  step types at 6 steps. JAX's RNG cannot be reproduced in torch, so the
  test derives the JAX sampler's own draws with the calls it makes
  (``split`` for the initial noise, then ``fold_in(key, i)`` per step)
  and hands them to the port. fp32: 1e-4 of the sample scale.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.diffusion import sampling as js
from pdm_tpu.models.unet import unet_from_config as j_unet_from_config
from pdm_tpu.models.unet_ddpm import UNetDDPM as JUNetDDPM
from pdm_tpu.schedulers.analytic import LinearBetaScheduler as JLinear

from pdm_tpu_torch.diffusion import sampling as ts
from pdm_tpu_torch.models.unet import unet_from_config
from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures.make_golden import TINY  # noqa: E402

TABLE_KEYS = (
    "log_temp", "ab", "ab_prev", "ddpm_x0", "ddpm_xt", "ddpm_noise",
    "ddim_x0", "ddim_eps", "sqrt_ab", "sqrt_ab_prev", "sig", "sig_prev",
    "heun_lt_prev", "dpm_cx", "dpm_cd", "dpm_k",
)
MIN_T, MAX_T = 1e-4, 1e2
N_STEPS, B, SIZE = 6, 2, 16


def _grid(n):
    return np.array(js.discretize_schedule(JLinear(1e-4, 2.478e4), n))


@pytest.mark.parametrize("n", [10, 1000])
@pytest.mark.parametrize("key", TABLE_KEYS)
def test_step_tables_match(n, key):
    grid = _grid(n)
    want = np.asarray(js._step_tables(jnp.asarray(grid))[key])
    got = ts._step_tables(torch.from_numpy(grid))[key].numpy()
    assert got.shape == want.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-6 if n == 10 else 5e-5,
                               atol=1e-7)


@pytest.mark.parametrize("n", [10, 1000])
def test_discretize_schedule_matches(n):
    sched = LinearBetaScheduler(1e-4, 2.478e4)
    got = ts.discretize_schedule(sched, n, max_log_temp=8.0)
    want = js.discretize_schedule(JLinear(1e-4, 2.478e4), n, max_log_temp=8.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_final_step_noise_coefficient_is_exactly_zero():
    tab = ts._step_tables(torch.from_numpy(_grid(1000)))
    assert tab["ab_prev"][-1].item() == 1.0
    assert tab["ddpm_noise"][-1].item() == 0.0
    assert tab["ddim_eps"][-1].item() == 0.0
    assert torch.isfinite(torch.stack(list(tab.values()))).all()


@pytest.fixture(scope="module")
def models():
    jnet = dataclasses.replace(j_unet_from_config(3, TINY), norm_groups=4)
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,)))[
            "params"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
    jm = JUNetDDPM(scheduler=JLinear(MIN_T, MAX_T), params=params, module=jnet)
    net = unet_from_config(3, {**TINY, "norm_groups": 4}, device="cpu")
    net.load_state_dict(from_flax_params(params), strict=True)
    tm = UNetDDPM(LinearBetaScheduler(MIN_T, MAX_T), net, device="cpu")
    return jm, tm


def _jax_draws(key, n_steps, shape):
    """The JAX sampler's own draws (sampling.py: split, then fold_in)."""
    key, init_key = jax.random.split(key)
    x_init = jax.random.normal(init_key, shape, dtype=jnp.float32)
    noise = jnp.stack([
        jax.random.normal(jax.random.fold_in(key, i), shape, dtype=jnp.float32)
        for i in range(n_steps)
    ])
    return np.array(x_init), np.array(noise)


@pytest.mark.parametrize("step_type", ["ddpm", "ddim", "heun", "dpmpp_2m"])
def test_sampler_matches_jax(models, step_type):
    jm, tm = models
    shape = (B, 3, SIZE, SIZE)
    key = jax.random.PRNGKey(7)
    want = js.DDPMSampler(
        ddpm=jm, scheduler=jm.scheduler, n_steps=N_STEPS, obj_size=shape[1:],
        batch_size=B, n_samples=B, step_type=step_type, track_states=True,
    ).batch_sample(key)
    x_init, noise = _jax_draws(key, N_STEPS, shape)
    got = ts.DDPMSampler(
        ddpm=tm, scheduler=tm.scheduler, n_steps=N_STEPS, obj_size=shape[1:],
        batch_size=B, n_samples=B, step_type=step_type, track_states=True,
        device="cpu",
    ).batch_sample(x_init=torch.from_numpy(x_init),
                   noise=torch.from_numpy(noise))
    want_x, want_states = np.asarray(want["x"]), np.asarray(want["states"])
    scale = float(np.abs(want_x).max())
    assert got["states"].shape == want_states.shape == (N_STEPS, *shape)
    np.testing.assert_allclose(got["x"].numpy(), want_x, rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got["states"].numpy(), want_states, rtol=0,
                               atol=1e-4 * float(np.abs(want_states).max()))


def test_half_precision_sampler_matches_jax(models):
    """precision='half': bf16 model input, bf16 UNetDDPM output, fp32 x0
    and step arithmetic, at the JAX package's rounding points. Tolerance
    2e-2 of the sample scale: one bf16 rounding of x_t per step."""
    jm, tm = models
    shape = (B, 3, SIZE, SIZE)
    key = jax.random.PRNGKey(3)
    want = js.DDPMSampler(
        ddpm=jm, scheduler=jm.scheduler, n_steps=4, obj_size=shape[1:],
        batch_size=B, step_type="ddpm", precision="half",
    ).batch_sample(key)["x"]
    x_init, noise = _jax_draws(key, 4, shape)
    got = ts.DDPMSampler(
        ddpm=tm, scheduler=tm.scheduler, n_steps=4, obj_size=shape[1:],
        batch_size=B, step_type="ddpm", precision="half", device="cpu",
    ).batch_sample(x_init=torch.from_numpy(x_init),
                   noise=torch.from_numpy(noise))["x"]
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))


def test_get_samples_generator_reproducible(models):
    _, tm = models
    kw = dict(ddpm=tm, scheduler=tm.scheduler, n_steps=3,
              obj_size=(3, SIZE, SIZE), n_samples=3, batch_size=2,
              step_type="ddpm", device="cpu")
    a = ts.get_samples(generator=torch.Generator().manual_seed(1), **kw)["x"]
    b = ts.get_samples(generator=torch.Generator().manual_seed(1), **kw)["x"]
    assert a.shape == (3, 3, SIZE, SIZE) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_sampler_rejects_bad_arguments(models):
    _, tm = models
    kw = dict(ddpm=tm, scheduler=tm.scheduler, n_steps=3, obj_size=(3, 4, 4),
              device="cpu")
    with pytest.raises(ValueError, match="step_type"):
        ts.DDPMSampler(step_type="euler", **kw)
    sampler = ts.DDPMSampler(step_type="ddpm", batch_size=2, **kw)
    with pytest.raises(ValueError, match="noise"):
        sampler.batch_sample(noise=torch.zeros(2, 2, 3, 4, 4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.DDPMSampler(step_type="ddpm", **{**kw, "device": None})

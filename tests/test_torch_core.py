"""Port parity: temperature algebra, analytic schedulers, add_noise,
parametrization algebra and DDPM.get_predictions (pdm_tpu_torch vs
pdm_tpu on the same numpy inputs, fp32, rtol 1e-6 plus an atol of 1e-6
for values near zero — a few ulp of elementwise-function difference
between the two libraries)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.core import temperature as jt
from pdm_tpu.models.base import DDPM as JDDPM
from pdm_tpu.models.predictions import (
    convert_prediction as j_convert, training_target as j_target,
)
from pdm_tpu.schedulers import analytic as ja

from pdm_tpu_torch.core import temperature as tt
from pdm_tpu_torch.models.base import DDPM as TDDPM
from pdm_tpu_torch.models.predictions import (
    convert_prediction as t_convert, training_target as t_target,
)
from pdm_tpu_torch.schedulers import analytic as ta

RTOL = ATOL = 1e-6
RNG = np.random.RandomState(0)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol,
    )


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


LOG_TEMPS = np.linspace(-9.0, 10.0, 97).astype(np.float32)
ALPHA_BARS = RNG.uniform(1e-4, 1 - 1e-4, 64).astype(np.float32)


@pytest.mark.parametrize("name", [
    "alpha_bar_from_log_temp", "one_minus_alpha_bar_from_log_temp",
    "temp_from_log_temp",
])
def test_temperature_from_log_temp(name):
    close(getattr(tt, name)(t(LOG_TEMPS)), getattr(jt, name)(jnp.asarray(LOG_TEMPS)))


@pytest.mark.parametrize("name,vals", [
    ("log_temp_from_alpha_bar", ALPHA_BARS),
    ("log_temp_from_temp", np.exp(LOG_TEMPS).astype(np.float32)),
])
def test_temperature_to_log_temp(name, vals):
    close(getattr(tt, name)(t(vals)), getattr(jt, name)(jnp.asarray(vals)),
          atol=1e-5)


def test_bcast_right():
    x = np.arange(4, dtype=np.float32)
    assert tuple(tt.bcast_right(t(x), 4).shape) == jt.bcast_right(x, 4).shape
    assert tt.bcast_right(torch.tensor(2.0), 4).ndim == 0


SCHEDULERS = [
    ("LinearBetaScheduler", 1e-4, 2.478e4),
    ("CosineScheduler", 1e-4, 1e4),
    ("LogSNRScheduler", 1e-3, 1e2),
]


@pytest.mark.parametrize("name,lo,hi", SCHEDULERS)
def test_scheduler_tau_to_log_temp(name, lo, hi):
    taus = np.linspace(0.0, 1.0, 101).astype(np.float32)
    js, ts = getattr(ja, name)(lo, hi), getattr(ta, name)(lo, hi)
    want = js.log_temp_from_tau(jnp.asarray(taus))
    got = ts.log_temp_from_tau(t(taus))
    close(got, want, atol=2e-6)
    close(ts.alpha_bar_from_tau(t(taus)), js.alpha_bar_from_tau(jnp.asarray(taus)))


@pytest.mark.parametrize("name,lo,hi", SCHEDULERS)
def test_scheduler_log_temp_to_tau(name, lo, hi):
    js, ts = getattr(ja, name)(lo, hi), getattr(ta, name)(lo, hi)
    lts = np.linspace(np.log(lo), np.log(hi), 101).astype(np.float32)
    close(ts.tau_from_log_temp(t(lts)), js.tau_from_log_temp(jnp.asarray(lts)),
          atol=2e-6)
    # round trip through the port alone stays on the grid
    back = ts.log_temp_from_tau(ts.tau_from_log_temp(t(lts)))
    close(back, lts, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,lo,hi", SCHEDULERS)
def test_add_noise_explicit_eps(name, lo, hi):
    import jax

    js, ts = getattr(ja, name)(lo, hi), getattr(ta, name)(lo, hi)
    x0 = RNG.standard_normal((5, 3, 4, 4)).astype(np.float32)
    tau = RNG.uniform(0, 1, 5).astype(np.float32)
    tau_j, eps_j, xt_j = js.add_noise(jax.random.PRNGKey(0), jnp.asarray(x0),
                                      jnp.asarray(tau))
    tau_t, eps_t, xt_t = ts.add_noise(t(x0), t(tau), eps=t(np.asarray(eps_j)))
    close(tau_t, tau_j)
    close(xt_t, xt_j)
    # generator draws: right shapes, reproducible from the seed
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    a, b = ts.add_noise(t(x0), generator=g1), ts.add_noise(t(x0), generator=g2)
    assert a[0].shape == (5,) and a[1].shape == x0.shape
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("param", ["x0", "eps", "score"])
def test_convert_prediction(param):
    pred = RNG.standard_normal((6, 3, 4, 4)).astype(np.float32)
    xt = RNG.standard_normal((6, 3, 4, 4)).astype(np.float32)
    ab = RNG.uniform(0.05, 0.95, 6).astype(np.float32)
    want = j_convert(jnp.asarray(pred), jnp.asarray(xt), jnp.asarray(ab), param)
    got = t_convert(t(pred), t(xt), t(ab), param)
    for field in ("pred", "x0", "eps", "score"):
        close(getattr(got, field), getattr(want, field), rtol=2e-6, atol=2e-6)
    eps = RNG.standard_normal(xt.shape).astype(np.float32)
    close(t_target(t(pred), t(eps), t(ab), param),
          j_target(jnp.asarray(pred), jnp.asarray(eps), jnp.asarray(ab), param))


def test_convert_prediction_bf16_promotes_like_jax():
    """bf16 pred/xt against an fp32 alpha_bar compute in fp32 in JAX; the
    port must not keep torch's bf16 result for a 0-d fp32 operand."""
    pred = RNG.standard_normal((2, 3, 4, 4)).astype(np.float32)
    xt = RNG.standard_normal((2, 3, 4, 4)).astype(np.float32)
    ab = np.float32(0.3)
    want = j_convert(jnp.asarray(pred, jnp.bfloat16), jnp.asarray(xt, jnp.bfloat16),
                     jnp.asarray(ab), "eps")
    got = t_convert(t(pred).bfloat16(), t(xt).bfloat16(), torch.tensor(ab), "eps")
    assert want.x0.dtype == jnp.float32 and got.x0.dtype == torch.float32
    close(got.x0, np.asarray(want.x0), rtol=2e-6, atol=2e-6)


def test_ddpm_get_predictions_clips_tau():
    """tau is clipped to [0, 1] and alpha_bar recomputed from the CLIPPED
    tau (not from log_temp), on both sides."""
    lo, hi = 1e-3, 1e2

    @dataclasses.dataclass(frozen=True)
    class JModel(JDDPM):
        scheduler: object
        parametrization: str = "eps"

        def forward(self, xt, tau):
            return xt * 0.5 + tau

    class TModel(TDDPM):
        def __init__(self, scheduler):
            self.scheduler, self.parametrization = scheduler, "eps"

        def forward(self, xt, tau):
            return xt * 0.5 + tau

    jm, tm = JModel(ja.LogSNRScheduler(lo, hi)), TModel(ta.LogSNRScheduler(lo, hi))
    xt = RNG.standard_normal((3, 2, 4, 4)).astype(np.float32)
    for lt in (np.log(hi) + 2.0, 0.5, np.log(lo) - 1.0):  # above, inside, below
        lt = np.float32(lt)
        want = jm.get_predictions(jnp.asarray(xt), jnp.asarray(lt))
        got = tm.get_predictions(t(xt), torch.tensor(lt))
        for field in ("pred", "x0", "eps", "score"):
            close(getattr(got, field), getattr(want, field), rtol=2e-6, atol=2e-6)
    assert tm.max_log_temp == pytest.approx(jm.max_log_temp, rel=1e-6)

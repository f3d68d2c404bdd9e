"""Port parity: flax-semantics initialisation (pdm_tpu_torch.models.
unet_ddpm.init_unet_ddpm) against the JAX package's init_unet_ddpm.

At the tiny UNet of tests/fixtures/make_golden.py (norm_groups 4) both
initialise the same parameters: the same names and shapes (JAX's tree
through from_flax_params), biases exactly 0, GroupNorm scales exactly 1,
every conv and linear kernel a lecun normal truncated at +-2 sigma' with
sigma' = sqrt(1 / fan_in) / 0.8796, so no value lies beyond 2 sigma'.

Each kernel's sample std is held within 10% of JAX's sample std for the
same tensor. The two are independent draws of n values: the std of one
sample std is about sqrt((m4 - 1) / (4 n)) of it, m4 = 2.3655 the fourth
moment of the unit-variance normal truncated at +-2 (computed below), so
their relative difference has a std of sqrt((m4 - 1) / (2 n)): 4.0% at
the smallest kernels here (conv_in and conv_out, n = 432; 10% is 2.5 of
those stds), 3.7% or less at every other. A failure names the tensor,
its ratio and that std.
"""

import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from pdm_tpu.models.unet import unet_from_config as j_unet_from_config
from pdm_tpu.models.unet_ddpm import init_unet_ddpm as j_init_unet_ddpm
from pdm_tpu.schedulers.analytic import LinearBetaScheduler as JLinear

from pdm_tpu_torch.models.unet import unet_from_config
from pdm_tpu_torch.models.unet_ddpm import (
    TRUNCATED_NORMAL_STD, UNetDDPM, init_unet_ddpm, lecun_sigma,
)
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures.make_golden import TINY  # noqa: E402
from torch_port_fixtures import two_torch_threads  # noqa: E402,F401

STD_TOL = 0.10


def _truncated_moments():
    """(std, fourth moment of the standardized) of N(0, 1) truncated at
    +-2."""
    d = stats.truncnorm(-2.0, 2.0)
    var = float(d.var())
    return math.sqrt(var), float(d.moment(4)) / var ** 2


def _port_and_jax(seed):
    jnet = dataclasses.replace(j_unet_from_config(3, TINY), norm_groups=4)
    jm = j_init_unet_ddpm(jax.random.PRNGKey(seed), JLinear(1e-4, 1e2), jnet,
                          (3, 16, 16))
    want = from_flax_params(jm.params)
    net = unet_from_config(3, {**TINY, "norm_groups": 4}, device="cpu")
    model = init_unet_ddpm(torch.Generator().manual_seed(seed),
                           LinearBetaScheduler(1e-4, 1e2), net, (3, 16, 16))
    return model, dict(net.named_parameters()), want


def test_truncated_normal_constant_is_flax():
    std, m4 = _truncated_moments()
    assert abs(std - TRUNCATED_NORMAL_STD) < 1e-12
    assert abs(m4 - 2.3655) < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_init_matches_jax_statistics(seed):
    model, got, want = _port_and_jax(seed)
    assert isinstance(model, UNetDDPM) and model.parametrization == "eps"
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    _, m4 = _truncated_moments()
    n_kernels = 0
    for name, p in got.items():
        p, w = p.detach(), want[name]
        if name.endswith("bias"):
            assert torch.equal(p, torch.zeros_like(p)), name
            assert torch.equal(w, torch.zeros_like(w)), name
        elif p.ndim == 1:  # GroupNorm scale
            assert torch.equal(p, torch.ones_like(p)), name
            assert torch.equal(w, torch.ones_like(w)), name
        else:
            n_kernels += 1
            sigma = lecun_sigma(p)
            n = p.numel()
            ratio = float(p.std()) / float(w.std())
            sd_of_ratio = math.sqrt((m4 - 1.0) / (2 * n))
            assert abs(ratio - 1.0) <= STD_TOL, (name, ratio, sd_of_ratio)
            assert float(p.abs().max()) <= 2.0 * sigma * (1 + 1e-6), name
            assert float(w.abs().max()) <= 2.0 * sigma * (1 + 1e-6), name
            # both near the lecun std sqrt(1 / fan_in)
            target = sigma * TRUNCATED_NORMAL_STD
            assert abs(float(p.std()) / target - 1.0) <= STD_TOL, name
    assert n_kernels == sum(1 for k in got if k.endswith("weight")
                            and got[k].ndim > 1)


def test_init_draws_from_the_generator_only():
    """The same seed gives the same weights, in bf16 the fp32 draws
    rounded; another seed gives others; obj_size is checked."""
    def port(seed, dtype=torch.float32):
        net = unet_from_config(3, {**TINY, "norm_groups": 4}, dtype=dtype,
                               device="cpu")
        init_unet_ddpm(torch.Generator().manual_seed(seed),
                       LinearBetaScheduler(1e-4, 1e2), net, (3, 16, 16))
        return dict(net.named_parameters())

    a, b, c, half = port(3), port(3), port(4), port(3, torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_in.weight"], c["conv_in.weight"])
    assert torch.equal(half["conv_in.weight"],
                       a["conv_in.weight"].to(torch.bfloat16))
    net = unet_from_config(3, {**TINY, "norm_groups": 4}, device="cpu")
    with pytest.raises(ValueError, match="obj_size"):
        init_unet_ddpm(torch.Generator(), LinearBetaScheduler(1e-4, 1e2), net,
                       (1, 16, 16))

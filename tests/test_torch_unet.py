"""Port parity: the UNet2D (pdm_tpu_torch.models.unet) and its weights.

* The committed diffusers-layout fixture loads straight into the port's
  tiny UNet with ``load_state_dict`` (no renaming) and reproduces the
  golden output at the fixture's own tolerance (5e-3, as
  tests/test_diffusers_golden.py: the fixture carries the XLA-CPU drift of
  the process that generated it).
* Random JAX parameters carried over by ``from_flax_params`` give the
  JAX UNet2D's output: fp32 to 1e-5 of the output scale; bf16 compute to
  2e-2 of the output scale (bf16 rounds after every conv, norm and
  projection, at slightly different points in the two frameworks).
* Without CUDA, the entry points raise unless given ``device="cpu"``.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.models.unet import unet_from_config as j_unet_from_config

from pdm_tpu_torch.models.unet import (
    AttentionBlock, GroupNormAct, sinusoidal_time_embedding,
    unet_from_config,
)
from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
sys.path.insert(0, HERE)

from fixtures.make_golden import TINY  # noqa: E402
from torch_port_fixtures import two_torch_threads  # noqa: E402,F401

TINY_PORT = {**TINY, "norm_groups": 4}


def _jax_tiny(dtype=jnp.float32):
    return dataclasses.replace(j_unet_from_config(3, TINY, dtype=dtype),
                               norm_groups=4)


def _random_jax_params(net, size, seed=0, std=0.1):
    shapes = jax.eval_shape(
        lambda k: net.init(k, jnp.zeros((1, size, size, 3)), jnp.zeros((1,)))[
            "params"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * std).astype(np.float32), shapes)


def _inputs(B, size, seed=11):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, size, size, 3)).astype(np.float32)
    tau = rng.uniform(0.0, 1.0, B).astype(np.float32)
    return x, tau


def test_diffusers_fixture_loads_and_matches_golden():
    sd = dict(np.load(os.path.join(FIX, "diffusers_tiny_sd.npz")))
    golden = np.load(os.path.join(FIX, "diffusers_tiny_golden.npz"))
    net = unet_from_config(3, TINY_PORT, device="cpu")
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)
    with torch.no_grad():
        out = net(torch.from_numpy(golden["x"]).permute(0, 3, 1, 2),
                  torch.from_numpy(golden["tau"]))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), golden["out"],
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_from_flax_params_matches_jax_unet(dtype, tol):
    jnet = _jax_tiny(getattr(jnp, dtype))
    params = _random_jax_params(jnet, 16)
    x, tau = _inputs(3, 16)
    apply = jax.jit(lambda p, x, t: jnet.apply({"params": p}, x, t,
                                               deterministic=True))
    want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(tau)))
    net = unet_from_config(3, TINY_PORT, dtype=getattr(torch, dtype),
                           device="cpu")
    net.load_state_dict(from_flax_params(params), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(tau))
    got = got.permute(0, 2, 3, 1).numpy()
    scale = float(np.abs(want).max())
    assert scale > 1e-2
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("head_dim,size", [(None, 16), (8, 16), (None, 12),
                                           (8, 12)])
def test_attention_head_dims_match_jax_unet(monkeypatch, head_dim, size):
    """attention_head_dim null (one head of all C channels) and 8, port vs
    JAX on the CPU in fp32 to 1e-5 of the output scale. At 16x16 the
    attention blocks' T = 64 is inside the attention gate, so they call
    fused_spatial_attention (its plain version on CPU tensors); at 12x12
    T = 36 is not a multiple of 8, so they run the model's XLA branch,
    as JAX's blocks do."""
    import pdm_tpu_torch.models.unet as unet_mod

    cfg = {**TINY, "attention_head_dim": head_dim}
    jnet = dataclasses.replace(j_unet_from_config(3, cfg), norm_groups=4)
    params = _random_jax_params(jnet, size, seed=5)
    x, tau = _inputs(2, size, seed=6)
    want = np.asarray(jax.jit(lambda p, x, t: jnet.apply(
        {"params": p}, x, t, deterministic=True))(params, jnp.asarray(x),
                                                  jnp.asarray(tau)))
    net = unet_from_config(3, {**cfg, "norm_groups": 4}, device="cpu")
    net.load_state_dict(from_flax_params(params), strict=True)
    calls = {"kernel": 0, "xla": 0}

    def spy(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(unet_mod, "fused_spatial_attention",
                        spy("kernel", unet_mod.fused_spatial_attention))
    monkeypatch.setattr(unet_mod, "attention_reference",
                        spy("xla", unet_mod.attention_reference))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(tau)).permute(0, 2, 3, 1).numpy()
    assert calls == ({"kernel": 4, "xla": 0} if size == 16
                     else {"kernel": 0, "xla": 4})
    scale = float(np.abs(want).max())
    assert scale > 1e-2
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


def test_unet_ddpm_forward_casts_to_input_dtype():
    """UNetDDPM takes NCHW, broadcasts a scalar tau, and casts the fp32
    network output to xt.dtype (a bf16 rounding point under half
    precision), as the JAX UNetDDPM does."""
    from pdm_tpu.models.unet_ddpm import UNetDDPM as JUNetDDPM
    from pdm_tpu.schedulers.analytic import LinearBetaScheduler as JLinear

    jnet = _jax_tiny()
    params = _random_jax_params(jnet, 16, seed=2)
    x, _ = _inputs(2, 16, seed=4)
    x_nchw = x.transpose(0, 3, 1, 2)
    jm = JUNetDDPM(scheduler=JLinear(1e-4, 1e2), params=params, module=jnet)
    net = unet_from_config(3, TINY_PORT, device="cpu")
    net.load_state_dict(from_flax_params(params))
    tm = UNetDDPM(LinearBetaScheduler(1e-4, 1e2), net, device="cpu")
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jax.jit(jm.forward)(jnp.asarray(x_nchw, dt_j), jnp.asarray(0.4))
        with torch.no_grad():
            got = tm.forward(torch.from_numpy(x_nchw).to(dt_t), torch.tensor(0.4))
        assert got.dtype == dt_t and got.shape == x_nchw.shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-4)


def test_sinusoidal_time_embedding_matches_jax():
    from pdm_tpu.models.unet import sinusoidal_time_embedding as j_emb

    t = np.asarray([0.0, 0.125, 0.5, 1.0, 999.0], np.float32)
    for dim, flip in ((16, False), (15, True)):
        want = j_emb(jnp.asarray(t), dim, flip_sin_to_cos=flip)
        got = sinusoidal_time_embedding(torch.from_numpy(t), dim,
                                        flip_sin_to_cos=flip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_flagship_structure_matches_jax_parameter_tree():
    """The full-width flagship (47.2 M parameters) has the JAX tree's
    every parameter, 69 GroupNorms and 8 attention blocks."""
    cfg = {"block_out_channels": [128, 256, 256, 256], "dropout": 0.2}
    jnet = j_unet_from_config(3, cfg)
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,)))[
            "params"], jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = from_flax_params(zeros)
    net = unet_from_config(3, cfg, device="cpu")
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    n_params = sum(p.numel() for p in net.parameters())
    assert abs(n_params / 1e6 - 47.2) < 0.1
    assert sum(isinstance(m, GroupNormAct) for m in net.modules()) == 69
    assert sum(isinstance(m, AttentionBlock) for m in net.modules()) == 8


def test_built_in_eval_mode_so_dropout_is_off():
    """The JAX module applies deterministic=True by default; the port is
    built in eval mode, so two forwards agree despite dropout 0.5."""
    net = unet_from_config(3, {**TINY_PORT, "dropout": 0.5}, device="cpu")
    x, tau = torch.randn(2, 3, 16, 16), torch.rand(2)
    with torch.no_grad():
        assert torch.equal(net(x, tau), net(x, tau))


def test_channels_last_activations_are_views_for_the_kernels():
    net = unet_from_config(3, TINY_PORT, device="cpu")
    seen = []
    for m in net.modules():
        if isinstance(m, GroupNormAct):
            m.register_forward_pre_hook(
                lambda mod, args: seen.append(
                    args[0].is_contiguous(memory_format=torch.channels_last)))
    with torch.no_grad():
        net(torch.zeros(2, 3, 16, 16), torch.zeros(2))
    assert seen and all(seen)


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        unet_from_config(3, TINY_PORT)
    net = unet_from_config(3, TINY_PORT, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UNetDDPM(LinearBetaScheduler(1e-4, 1e2), net)

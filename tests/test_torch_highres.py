"""Port parity: the single-head UNets (attention_head_dim null) of the
256x256 family (google/ddpm-celebahq-256's architecture) at small size.

* ``models/configs.py``'s CELEBAHQ_UNET, the port's copy of the family's
  config, is JAX's (scripts/highres_probe.py's CELEBAHQ_UNET, read from the script's
  source), and the full-width model built from it on the meta device has
  113.67 M parameters, 71 GroupNorms and six attention blocks of one head
  of 512 channels.
* A tiny six-level model with the family's block types (widths 32 to 128,
  64 x 64 images, one head per block) carried over from random JAX
  parameters by ``from_flax_params``: one forward to 1e-5 of the output
  scale (fp32), and a DDIM-3 sample with JAX's own draws passed in to
  1e-4 of the sample scale, as tests/test_torch_sampler.py holds the
  sampler. Its attention blocks at 4 x 4 (T 16) call the row-1 wrapper,
  the mid block at 2 x 2 (T 4, not a multiple of 8) the plain branch, as
  JAX's gate decides.
* With ``PDM_FUSED_BLOCK=1`` its 4 x 4 blocks take the whole block's
  staged plan (plain version on the CPU): the forward and the eps loss's
  gradient match JAX's standard path.
* The diffusers layout of a single-head config written with
  ``write_safetensors`` and ``config.json`` loads through
  ``diffusers_ddpm_from_config`` into bitwise the module it was written
  from.
* ``attend`` sends one head of 256, 512, 520 or 576 at T 256 to the row-1
  wrapper (on CPU tensors its plain version): the gate has no head-dim
  bound, as JAX's has none.
"""

import ast
import json
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

import pdm_tpu_torch.models.unet as unet_mod
from pdm_tpu_torch.config.loader import load_config
from pdm_tpu_torch.diffusion import sampling as ts
from pdm_tpu_torch.models.configs import CELEBAHQ_UNET, HIGHRES_CALLS, HIGHRES_PARAMS_M
from pdm_tpu_torch.models.diffusers_import import write_safetensors
from pdm_tpu_torch.models.from_config import diffusers_ddpm_from_config
from pdm_tpu_torch.models.unet import AttentionBlock, GroupNormAct, unet_from_config
from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from torch_port_fixtures import jax_sampler_draws, two_torch_threads  # noqa: E402,F401

# the family's block types at the widths of a CPU test
TINY_HIGHRES = {**CELEBAHQ_UNET, "block_out_channels": [32, 32, 64, 64, 128, 128]}
SIZE, B, N_STEPS = 64, 2, 3
MIN_T, MAX_T = 1e-4, 1e2


def _probe_config():
    """CELEBAHQ_UNET as scripts/highres_probe.py writes it (its source
    parsed: importing the script would set JAX up for a TPU)."""
    with open(os.path.join(ROOT, "scripts", "highres_probe.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "CELEBAHQ_UNET" for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError("scripts/highres_probe.py has no CELEBAHQ_UNET")


def test_family_config_is_jax_probes_and_its_model_has_the_family_shape():
    assert CELEBAHQ_UNET == _probe_config()
    net = unet_from_config(3, CELEBAHQ_UNET, device="meta")
    n_params = sum(p.numel() for p in net.parameters())
    assert round(n_params / 1e6, 2) == HIGHRES_PARAMS_M
    gns = [m for m in net.modules() if isinstance(m, GroupNormAct)]
    attn = [m for m in net.modules() if isinstance(m, AttentionBlock)]
    assert len(gns) == HIGHRES_CALLS["group_norm"]
    assert len(attn) == HIGHRES_CALLS["attention"]
    assert all(m.heads == 1 and m.to_q.weight.shape[0] == 512 for m in attn)


@pytest.fixture(scope="module")
def tiny_models():
    jnet = j_unet_from_config(3, TINY_HIGHRES)
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,)))[
            "params"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(np.float32), shapes)
    net = unet_from_config(3, TINY_HIGHRES, device="cpu")
    net.load_state_dict(from_flax_params(params), strict=True)
    return jnet, params, net


def _spy_attention(monkeypatch):
    calls = {"kernel": 0, "plain": 0}

    def spy(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(unet_mod, "fused_spatial_attention",
                        spy("kernel", unet_mod.fused_spatial_attention))
    monkeypatch.setattr(unet_mod, "attention_reference",
                        spy("plain", unet_mod.attention_reference))
    return calls


def test_tiny_single_head_unet_forward_matches_jax(tiny_models, monkeypatch):
    jnet, params, net = tiny_models
    rng = np.random.RandomState(3)
    x = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    tau = rng.uniform(0.0, 1.0, B).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x, t: jnet.apply(
        {"params": p}, x, t, deterministic=True))(params, jnp.asarray(x),
                                                  jnp.asarray(tau)))
    calls = _spy_attention(monkeypatch)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(tau)).permute(0, 2, 3, 1).numpy()
    # five blocks at 4 x 4 inside the gate, the mid block at 2 x 2 outside
    assert calls == {"kernel": 5, "plain": 1}
    scale = float(np.abs(want).max())
    assert scale > 1e-2
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


def test_tiny_single_head_unet_with_the_opt_in_matches_jax(tiny_models, monkeypatch):
    """PDM_FUSED_BLOCK=1: the five single-head blocks at 4 x 4 (one head of
    128: the whole block's staged plan) go to fused_attention_block (its
    plain version on the CPU), the mid block at 2 x 2 (T 4, outside the
    gate) to the plain branch. The forward matches JAX's standard path
    (JAX's gate is closed off the TPU) to 1e-5 of the output scale, and the
    gradient of the eps loss mean((net(x_t, tau) - eps)^2), a train step's
    gradient, matches jax.grad's in every parameter to 1e-4 of that
    parameter's gradient scale plus 1e-6 of the largest (fp32 summation
    order through the backward)."""
    jnet, params, net = tiny_models
    monkeypatch.setenv("PDM_FUSED_BLOCK", "1")
    rng = np.random.RandomState(4)
    x = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    tau = rng.uniform(0.0, 1.0, B).astype(np.float32)
    eps = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)

    def j_loss(p):
        out = jnet.apply({"params": p}, jnp.asarray(x), jnp.asarray(tau),
                         deterministic=True)
        return jnp.mean((out - jnp.asarray(eps)) ** 2), out

    (_, want), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    want_grads = from_flax_params(jax.tree_util.tree_map(np.array, j_grads))
    calls = _spy_attention(monkeypatch)
    blocks = {"n": 0}
    real = unet_mod.fused_attention_block

    def block_spy(*args, **kw):
        blocks["n"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(unet_mod, "fused_attention_block", block_spy)
    net.zero_grad(set_to_none=True)
    out = net(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(tau))
    loss = torch.mean((out - torch.from_numpy(eps).permute(0, 3, 1, 2)) ** 2)
    loss.backward()
    assert blocks["n"] == 5 and calls == {"kernel": 0, "plain": 1}
    got = out.detach().permute(0, 2, 3, 1).numpy()
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(got - np.asarray(want)).max()) <= 1e-5 * scale
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert grads.keys() == want_grads.keys()
    top = max(float(np.abs(np.asarray(g)).max()) for g in want_grads.values())
    for k, g in want_grads.items():
        g = np.asarray(g)
        err = float(np.abs(grads[k].numpy() - g).max())
        assert err <= 1e-4 * float(np.abs(g).max()) + 1e-6 * top, k
    net.zero_grad(set_to_none=True)


def test_tiny_single_head_unet_ddim_sample_matches_jax(tiny_models):
    jnet, params, net = tiny_models
    jm = JUNetDDPM(scheduler=JLinear(MIN_T, MAX_T), params=params, module=jnet)
    tm = UNetDDPM(LinearBetaScheduler(MIN_T, MAX_T), net, device="cpu")
    shape = (B, 3, SIZE, SIZE)
    key = jax.random.PRNGKey(5)
    want = np.asarray(js.DDPMSampler(
        ddpm=jm, scheduler=jm.scheduler, n_steps=N_STEPS, obj_size=shape[1:],
        batch_size=B, n_samples=B, step_type="ddim").batch_sample(key)["x"])
    x_init, noise = jax_sampler_draws(key, N_STEPS, shape)
    got = ts.DDPMSampler(
        ddpm=tm, scheduler=tm.scheduler, n_steps=N_STEPS, obj_size=shape[1:],
        batch_size=B, n_samples=B, step_type="ddim", device="cpu",
    ).batch_sample(x_init=torch.from_numpy(x_init),
                   noise=torch.from_numpy(noise))["x"].numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_single_head_diffusers_layout_round_trip(tmp_path):
    """write_safetensors + config.json (attention_head_dim null) ->
    diffusers_ddpm_from_config gives bitwise the written module."""
    cfg_unet = {**TINY_HIGHRES, "block_out_channels": [32, 32, 32, 32, 64, 64]}
    net = unet_from_config(3, cfg_unet, device="cpu")
    rng = np.random.RandomState(2)
    net.load_state_dict({k: torch.from_numpy(
        (rng.standard_normal(tuple(v.shape)) * 0.05).astype(np.float32))
        for k, v in net.state_dict().items()})
    root = tmp_path / "celebahq"
    root.mkdir()
    with open(root / "config.json", "w") as f:
        json.dump({"_class_name": "UNet2DModel", "sample_size": SIZE,
                   "in_channels": 3, "out_channels": 3, **cfg_unet}, f)
    write_safetensors(str(root / "diffusion_pytorch_model.safetensors"),
                      net.state_dict())
    cfg = load_config()
    cfg.dataset_name = "celeba-hq"
    cfg.ddpm.model_name = "diffusers"
    cfg.ddpm.precision = "f32"
    cfg.ddpm.diffusers_path = str(root)
    ddpm = diffusers_ddpm_from_config(cfg, device="cpu")
    got = ddpm.module.state_dict()
    want = net.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    attn = [m for m in ddpm.module.modules() if isinstance(m, AttentionBlock)]
    assert len(attn) == 6 and all(m.heads == 1 for m in attn)
    x = torch.from_numpy(rng.standard_normal((1, 3, SIZE, SIZE)).astype(np.float32))
    tau = torch.tensor([0.4])
    with torch.no_grad():
        assert torch.equal(ddpm.module(x, tau), net(x, tau))


@pytest.mark.parametrize("hd", [512, 256, 520, 576])
def test_attend_sends_single_wide_heads_to_the_kernel_wrapper(monkeypatch, hd):
    calls = _spy_attention(monkeypatch)
    rng = np.random.RandomState(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 256, hd)).astype(np.float32))
               for _ in range(3))
    out = unet_mod.attend(q, k, v, 1, hd ** -0.5)
    assert calls == {"kernel": 1, "plain": 0}
    # on CPU tensors the wrapper runs the plain version: the same numbers
    want = unet_mod.attention_reference(q, k, v, 1, hd ** -0.5)
    torch.testing.assert_close(out, want, rtol=0, atol=0)

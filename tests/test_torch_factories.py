"""Port parity: the scheduler and model factories (pdm_tpu_torch.
schedulers.from_config, pdm_tpu_torch.models.from_config) against the JAX
package's, on the same config and the same artifact files.

* ``scheduler_from_config`` for all seven types, on .npz files written
  once and read by both: log_temp at 41 tau in [0, 1] within 1e-6
  (absolute plus relative: fp32 arithmetic in another order).
* ``ddpm_from_config`` with a tiny ``unet_config``: the same parameter
  names and shapes as JAX's (through ``from_flax_params``), biases 0,
  GroupNorm scales 1, each kernel within 2 sigma' and its std within 10%
  of JAX's (test_torch_init.py explains the margin); then, with JAX's
  parameters carried over, the forward within 1e-5 of the output's scale.
* ``model_name: true`` on gmm1d (N = 1e6): x0 against JAX's TrueDDPM
  within 1e-4 absolute (the data's scale is 1). At T = 1e-4 the fp32
  expansion of |xt - y|^2 errs by about 2^-24 (|xt|^2 + |y|^2) ~ 2e-7,
  a logit error of ~1e-3 that moves x0 by that times the posterior's
  spread (the modes' std is 0.01, their gaps 0.2).
* A model-axis request raises; a data axis and ``fsdp`` alone build the
  model JAX's builds on the same config; ``load_pretrained_unet`` loads the port
  trainer's EMA weights exactly; without a card and without
  ``device="cpu"`` the factories raise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.config.loader import load_config as j_load_config
from pdm_tpu.models.from_config import ddpm_from_config as j_ddpm_from_config
from pdm_tpu.schedulers.from_config import (
    scheduler_from_config as j_scheduler_from_config,
)

from pdm_tpu_torch.config.loader import load_config
from pdm_tpu_torch.diffusion.trainer import DDPMTrainer
from pdm_tpu_torch.models.base import TrueDDPM
from pdm_tpu_torch.models.from_config import (
    ddpm_from_config, load_pretrained_unet,
)
from pdm_tpu_torch.models.unet import unet_from_config
from pdm_tpu_torch.models.unet_ddpm import (
    TRUNCATED_NORMAL_STD, UNetDDPM, lecun_sigma,
)
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.schedulers.from_config import scheduler_from_config
from torch_port_fixtures import two_torch_threads  # noqa: F401

TINY_UNET = {
    "block_out_channels": [16, 32],
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
    "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
    "layers_per_block": 1,
    "attention_head_dim": 8,
    "norm_groups": 4,
    "dropout": 0.0,
}
SCHED_TOL = 1e-6
STD_TOL = 0.10


def both_configs(**overrides):
    """The default config in both packages, with the same overrides
    ("group.field": value)."""
    out = []
    for cfg in (j_load_config(), load_config()):
        for key, value in overrides.items():
            *heads, leaf = key.split(".")
            sub = cfg
            for h in heads:
                sub = getattr(sub, h)
            setattr(sub, leaf, value)
        out.append(cfg)
    return out


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    """The statistics and table files every schedule type reads, under the
    config's relative paths, in a temporary working directory."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("stats")
    temp = np.logspace(-4, 4.4, 60)
    entropy = 1.5 * np.log1p(temp / 0.05) + 0.01 * np.sin(np.arange(60))
    np.savez("stats/cifar10_forward.npz", temp=temp, entropy=entropy)
    log_temp = np.linspace(np.log(1e-4), np.log(2.478e4), 50)
    np.savez("stats/cifar10_metric.npz", log_temp=log_temp,
             metric=1.0 / (1.0 + np.exp(log_temp)) + 0.1)
    os.makedirs("checkpoints/ddpm_ema_cifar10")
    betas = np.linspace(1e-4, 0.02, 1000)
    np.savez("checkpoints/ddpm_ema_cifar10/alphas_cumprod.npz",
             alphas_cumprod=np.cumprod(1.0 - betas))
    np.savez("custom.npz", log_temp=np.linspace(-6.0, 8.0, 17),
             timestamps=np.linspace(0.0, 1.0, 17) ** 1.5)
    return tmp_path


@pytest.mark.parametrize("kind", ["linear_beta", "cosine", "log_snr", "entropy",
                                  "metric", "diffusers", "custom"])
def test_scheduler_from_config_matches_jax(artifacts, kind):
    jcfg, cfg = both_configs()
    kw = {"noise_schedule_path": "custom.npz"} if kind == "custom" else {}
    want_s = j_scheduler_from_config(jcfg, noise_schedule_type=kind, **kw)
    got_s = scheduler_from_config(cfg, noise_schedule_type=kind, device="cpu",
                                  **kw)
    assert type(got_s).__name__ == type(want_s).__name__
    tau = np.linspace(0.0, 1.0, 41).astype(np.float32)
    want = np.asarray(want_s.log_temp_from_tau(jnp.asarray(tau)))
    got = got_s.log_temp_from_tau(torch.from_numpy(tau)).numpy()
    np.testing.assert_allclose(got, want, rtol=SCHED_TOL, atol=SCHED_TOL)


def test_scheduler_from_config_reads_the_config(artifacts):
    jcfg, cfg = both_configs(**{"ddpm.noise_schedule_type": "cosine",
                                "diffusion.min_temp": 1e-3})
    got = scheduler_from_config(cfg, device="cpu")
    assert type(got).__name__ == "CosineScheduler" and got.min_temp == 1e-3
    cfg.sample.noise_schedule_path = "custom.npz"
    assert type(scheduler_from_config(cfg, noise_schedule_type="custom",
                                      device="cpu")).__name__ == (
        "InterpolatedScheduler")
    cfg.sample.noise_schedule_path = None
    with pytest.raises(ValueError, match="noise_schedule_path"):
        scheduler_from_config(cfg, noise_schedule_type="custom", device="cpu")
    with pytest.raises(ValueError, match="Unknown schedule type"):
        scheduler_from_config(cfg, noise_schedule_type="nope", device="cpu")


def tiny_configs(precision="f32", **overrides):
    return both_configs(**{"ddpm.unet_config": dict(TINY_UNET),
                           "ddpm.precision": precision, **overrides})


def test_unet_from_config_matches_jax_init_and_forward():
    jcfg, cfg = tiny_configs()
    jddpm = j_ddpm_from_config(jcfg, key=jax.random.PRNGKey(0))
    ddpm = ddpm_from_config(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert isinstance(ddpm, UNetDDPM) and ddpm.parametrization == "eps"
    assert not ddpm.module.training
    want = from_flax_params(jddpm.params)
    got = dict(ddpm.module.named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for name, p in got.items():
        p, w = p.detach(), want[name]
        if name.endswith("bias"):
            assert torch.equal(p, torch.zeros_like(p)), name
        elif p.ndim == 1:
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            sigma = lecun_sigma(p)
            assert float(p.abs().max()) <= 2.0 * sigma * (1 + 1e-6), name
            assert abs(float(p.std()) / float(w.std()) - 1.0) <= STD_TOL, name
            assert abs(float(p.std()) / (sigma * TRUNCATED_NORMAL_STD)
                       - 1.0) <= STD_TOL, name
    # the same weights give the same forward
    ddpm.module.load_state_dict(want, strict=True)
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    tau = np.array([0.2, 0.8], np.float32)
    want_out = np.asarray(jax.jit(jddpm.forward)(jnp.asarray(x), jnp.asarray(tau)))
    with torch.no_grad():
        got_out = ddpm(torch.from_numpy(x), torch.from_numpy(tau)).numpy()
    scale = float(np.abs(want_out).max())
    assert scale > 1e-3
    assert float(np.abs(got_out - want_out).max()) <= 1e-5 * scale


def test_unet_precision_and_seed():
    _, cfg = tiny_configs(precision="bf16")
    a = ddpm_from_config(cfg, device="cpu")
    b = ddpm_from_config(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert a.module.dtype == torch.bfloat16
    # the dtypes the bf16 module keeps (the time embedding stays fp32)
    ref = unet_from_config(3, TINY_UNET, dtype=torch.bfloat16, device="cpu")
    assert {k: v.dtype for k, v in a.module.named_parameters()} == {
        k: v.dtype for k, v in ref.named_parameters()}
    assert all(torch.equal(p, q) for p, q in zip(a.module.parameters(),
                                                 b.module.parameters()))


def test_bf16_model_keeps_its_fp32_weights_for_the_masters():
    """JAX keeps a bf16 UNet's parameters in fp32; so the trainer's masters
    start from the fp32 draws, not from the module's rounded weights."""
    _, c32 = tiny_configs(precision="f32")
    _, c16 = tiny_configs(precision="bf16")
    m32, m16 = ddpm_from_config(c32, device="cpu"), ddpm_from_config(c16, device="cpu")
    assert all(v.dtype == torch.float32 for v in m16.params.values())
    for name, p in m32.module.named_parameters():
        assert torch.equal(m16.params[name], p.detach()), name
    state = DDPMTrainer(m16).init_state()
    assert all(torch.equal(state.params[k], m16.params[k]) for k in state.params)
    rounded = m16.module.get_parameter("conv_in.weight")
    assert rounded.dtype == torch.bfloat16
    assert not torch.equal(state.params["conv_in.weight"], rounded.float())
    assert torch.equal(rounded, state.params["conv_in.weight"].to(torch.bfloat16))


def test_true_model_from_config_matches_jax():
    over = {"dataset_name": "gmm1d", "ddpm.model_name": "true",
            "ddpm.parametrization": "x0", "ddpm.noise_schedule_type": "log_snr",
            "diffusion.min_temp": 1e-4, "diffusion.max_temp": 1e1}
    jcfg, cfg = both_configs(**over)
    jddpm = j_ddpm_from_config(jcfg)
    ddpm = ddpm_from_config(cfg, device="cpu")
    assert isinstance(ddpm, TrueDDPM) and ddpm.train_data.shape[0] == 1_000_000
    np.testing.assert_array_equal(ddpm.train_data.numpy(),
                                  np.asarray(jddpm.train_data))
    rng = np.random.RandomState(5)
    xt = rng.uniform(-1.5, 1.5, (8, 1, 1, 1)).astype(np.float32)
    tau = np.linspace(0.05, 0.95, 8).astype(np.float32)
    want = np.asarray(jddpm.forward(jnp.asarray(xt), jnp.asarray(tau)))
    got = ddpm(torch.from_numpy(xt), torch.from_numpy(tau)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("parallel", [{"data_axis": 2}, {"model_axis": 2},
                                      {"fsdp": True}])
def test_mesh_request_raises(parallel):
    """A model axis above 1 raises (ROADMAP §1 item 6b). A data axis
    builds the model every rank holds, as JAX's does on the same config;
    ``fsdp`` alone builds no mesh in JAX either (mesh_from_config returns
    None for one device), so it builds the unsharded model too."""
    jcfg, cfg = tiny_configs(**{f"parallel.{k}": v for k, v in parallel.items()})
    if "model_axis" in parallel:
        with pytest.raises(NotImplementedError, match="item 6b"):
            ddpm_from_config(cfg, device="cpu")
        return
    if "fsdp" in parallel:
        jcfg.parallel.data_axis = 1  # one device, as the port's card
    jddpm = j_ddpm_from_config(jcfg, key=jax.random.PRNGKey(0))
    ddpm = ddpm_from_config(cfg, device="cpu")
    assert isinstance(ddpm, UNetDDPM)
    want = from_flax_params(jddpm.params)
    got = dict(ddpm.module.named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


def test_single_device_parallel_config_builds():
    _, cfg = tiny_configs(**{"parallel.data_axis": 1})
    assert isinstance(ddpm_from_config(cfg, device="cpu"), UNetDDPM)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_load_pretrained_unet_after_a_port_checkpoint(tmp_path, monkeypatch,
                                                      precision):
    monkeypatch.chdir(tmp_path)
    _, cfg = tiny_configs(precision=precision)
    ddpm = ddpm_from_config(cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match="latest.txt"):
        load_pretrained_unet(ddpm, cfg)
    trainer = DDPMTrainer(ddpm, learning_rate=1e-3, warmup_steps=0,
                          total_iters=2, ema_decay=0.5, eval_steps=2,
                          checkpoint_dir=cfg.checkpoint_dir)
    data = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (16, 3, 32, 32)).astype(np.float32))
    state = trainer.train(data, batch_size=4)
    loaded = ddpm_from_config(cfg, pretrained=True, device="cpu")
    params = dict(loaded.module.named_parameters())
    assert set(params) == set(state.ema_params)
    for name, ema in state.ema_params.items():
        p = params[name].detach()
        assert torch.equal(p, ema.to(p.dtype)), name
    assert not torch.equal(state.ema_params["conv_in.weight"],
                           state.params["conv_in.weight"])


def test_unknown_model_name_raises():
    _, cfg = tiny_configs(**{"ddpm.model_name": "nope"})
    with pytest.raises(ValueError, match="Unknown model name"):
        ddpm_from_config(cfg, device="cpu")


def test_entry_points_need_the_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    from pdm_tpu_torch.utils.data import get_data_tensor

    _, cfg = tiny_configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        ddpm_from_config(cfg)
    path = str(tmp_path / "knots.npz")
    np.savez(path, log_temp=np.linspace(-3.0, 3.0, 10))
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler_from_config(cfg, noise_schedule_type="custom",
                              noise_schedule_path=path)
    cfg.dataset_name = "gmm1d"
    with pytest.raises(RuntimeError, match="CUDA"):
        get_data_tensor(cfg)

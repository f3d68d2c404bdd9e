"""The config path of the port on the card: the factories' default device,
the data layer's pinned host-resident path and the trainer fed by it.

Every test is `cuda`-marked and skips without an NVIDIA GPU. The file
imports torch, numpy and the port only (no JAX), so on a GPU machine it
runs from the repository root with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_config.py -q

Checks are exact: a host-resident batch on the card is the same bytes as
the rows gathered on the host, and the tiny UNet's forward on the card is
held against its CPU forward on the same weights at the fp32 forward
tolerance of chip_smoke.py (FORWARD_TOL, of scale).
"""

import os
import sys

import numpy as np
import pytest
import torch

from pdm_tpu_torch import runtime
from pdm_tpu_torch.config.loader import load_config
from pdm_tpu_torch.diffusion.trainer import DDPMTrainer, host_batch_indices
from pdm_tpu_torch.models.from_config import ddpm_from_config
from pdm_tpu_torch.ops import attention as ta
from pdm_tpu_torch.ops import groupnorm as tg
from pdm_tpu_torch.utils import data as tdata
from pdm_tpu_torch.utils.profiling import PhaseTimer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import FORWARD_TOL  # noqa: E402

TINY = {
    "block_out_channels": [32, 64],
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
    "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
    "layers_per_block": 1,
    "attention_head_dim": 16,
    "norm_groups": 8,
    "dropout": 0.0,
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the config path's defaults and the "
                    "pinned host-resident copies run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def tiny_config():
    cfg = load_config()
    cfg.ddpm.unet_config = dict(TINY)
    cfg.ddpm.precision = "f32"
    cfg.ddpm_training.batch_size = 8
    return cfg


@pytest.mark.cuda
def test_host_resident_batches_on_the_card(cuda_device):
    assert runtime.native_available(), runtime.build_error
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (500, 3, 8, 8), dtype=np.uint8)
    host = tdata.HostResidentData(data, batch_size=64)
    assert host.device == cuda_device
    assert all(s.is_pinned() for s in host._staging)
    idxs = [rng.randint(0, 500, 64) for _ in range(6)]
    batches = [host.device_batch(i) for i in idxs]  # no sync in between
    torch.cuda.synchronize()
    for idx, b in zip(idxs, batches):
        assert b.device == cuda_device and b.dtype == torch.float32
        assert torch.equal(b.cpu(), torch.from_numpy(runtime.gather_rows(data, idx)))


@pytest.mark.cuda
def test_factories_default_to_the_card(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setenv("PDM_DATA_CACHE", str(tmp_path))
    cfg = tiny_config()
    u8 = np.random.RandomState(1).randint(0, 256, (40, 32, 32, 3), dtype=np.uint8)
    runtime.write_cache(tdata.pdmc_cache_path("cifar10", True), u8)
    data = tdata.get_data_tensor(cfg)
    assert data.device == cuda_device and data.shape == (40, 3, 32, 32)
    want = (u8.astype(np.float32) * np.float32(2 / 255) - np.float32(1))
    assert torch.equal(data.cpu(), torch.from_numpy(want.transpose(0, 3, 1, 2)))
    ddpm = ddpm_from_config(cfg)
    assert ddpm.device == cuda_device
    assert next(ddpm.module.parameters()).device == cuda_device
    cpu = ddpm_from_config(cfg, device="cpu")
    tau = torch.tensor([0.2, 0.6])
    a0, g0 = ta.fused_spatial_attention.launches, tg.fused_group_norm_act.launches
    with torch.no_grad():
        got = ddpm(data[:2], tau.to(cuda_device)).cpu()
        want_out = cpu(data[:2].cpu(), tau)
    assert ta.fused_spatial_attention.launches > a0
    assert tg.fused_group_norm_act.launches > g0
    scale = float(want_out.abs().max())
    assert float((got - want_out).abs().max()) <= FORWARD_TOL * scale


@pytest.mark.cuda
def test_trainer_on_host_resident_data_on_the_card(cuda_device):
    cfg = tiny_config()
    data = np.random.RandomState(2).uniform(-1, 1, (64, 3, 32, 32)).astype(np.float32)
    host = tdata.HostResidentData(data, batch_size=8)
    seen = []
    orig = host.device_batch
    host.device_batch = lambda idx: (seen.append(np.asarray(idx).copy()),
                                     orig(idx))[1]
    timer = PhaseTimer()
    trainer = DDPMTrainer(ddpm_from_config(cfg), learning_rate=1e-3,
                          warmup_steps=0, total_iters=3, eval_steps=1000,
                          timer=timer)
    state = trainer.train(host, batch_size=8)
    assert state.step == 3
    for it, idx in enumerate(seen, 1):
        np.testing.assert_array_equal(idx, host_batch_indices(it, 64, 8))
    assert timer.summary()["train_step"]["count"] == 3
    assert all(bool(torch.isfinite(p).all()) for p in state.params.values())

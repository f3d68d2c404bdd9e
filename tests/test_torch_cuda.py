"""The port's CUDA kernels on the card (pdm_tpu_torch.ops).

Every `cuda`-marked test needs an NVIDIA GPU with nvcc: each kernel is
built from pdm_tpu_torch/csrc/ and held against its plain PyTorch version
on the same card inputs, at the flagship's shapes (B=64). Without a card
they skip, and the last test checks that chip_smoke.py refuses to run. The file imports torch, numpy and the port only (no JAX), so on a
GPU machine without JAX it runs from the repository root with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: fp32 kernels differ from the plain versions by summation
order only (1e-5); bf16 outputs by at most one rounding step of the
output (2^-7 relative).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pdm_tpu_torch.models.unet import unet_from_config
from pdm_tpu_torch.ops import attention as ta
from pdm_tpu_torch.ops import groupnorm as tg

EPS = 1e-6
TINY = {
    "block_out_channels": [32, 64],
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
    "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
    "layers_per_block": 1,
    "attention_head_dim": 16,
    "norm_groups": 8,
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [256, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain_on_card(cuda_device, T, dtype):
    B, heads, C = 64, 4, 256
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(B, T, 3 * C, generator=g, device=cuda_device).to(dtype)
    q, k, v = qkv.split(C, dim=-1)  # the UNet's layout: token rows 3C apart
    before = ta.fused_spatial_attention.launches
    out, lse = ta.attention_with_lse(q, k, v, heads, 0.125)
    ref, ref_lse = ta._reference_with_lse(q, k, v, heads, 0.125)
    torch.cuda.synchronize()
    assert ta.fused_spatial_attention.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("T,heads,hd", [(100, 2, 16), (1024, 1, 32)])
def test_attention_kernel_ragged_and_long_rows(cuda_device, T, heads, hd):
    """T not a multiple of the 64-row tile, and T = 1024 (16 key tiles)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(3, T, heads * hd, generator=g, device=cuda_device)
               .bfloat16() for _ in range(3))
    out, lse = ta.attention_with_lse(q, k, v, heads, 0.3)
    ref, ref_lse = ta._reference_with_lse(q, k, v, heads, 0.3)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                               atol=2 ** -7)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,act", [
    (1024, 128, "silu"), (1024, 384, "silu"), (256, 512, "silu"),
    (256, 256, "none"), (16, 256, "none"),
])
def test_group_norm_kernel_matches_plain_on_card(cuda_device, S, C, act):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(64, S, C, generator=g, device=cuda_device).bfloat16()
    scale = 1.0 + 0.2 * torch.randn(C, generator=g, device=cuda_device)
    bias = 0.1 * torch.randn(C, generator=g, device=cuda_device)
    before = tg.fused_group_norm_act.launches
    y = tg.fused_group_norm_act(x, scale, bias, 32, EPS, act)
    ref = tg.group_norm_reference(x, scale, bias, 32, EPS, act).bfloat16()
    torch.cuda.synchronize()
    assert tg.fused_group_norm_act.launches == before + 1
    torch.testing.assert_close(y.float(), ref.float(), rtol=2 ** -7, atol=1e-3)


@pytest.mark.cuda
def test_wrappers_refuse_inputs_that_require_grad(cuda_device):
    x = torch.randn(2, 16, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        ta.fused_spatial_attention(x, x, x, 2, 0.25)
    with pytest.raises(NotImplementedError, match="backward"):
        tg.fused_group_norm_act(x, torch.ones(64, device=cuda_device),
                                torch.zeros(64, device=cuda_device), 8, EPS)


@pytest.mark.cuda
def test_tiny_unet_on_card_matches_cpu(cuda_device):
    """A tiny UNet in fp32: the card (kernels) against the CPU (plain
    versions), 1e-4 of the output scale; each forward launches one
    attention kernel per attention block and one GroupNorm per norm."""
    cpu = unet_from_config(3, TINY, device="cpu")
    rng = np.random.RandomState(0)
    cpu.load_state_dict({k: torch.from_numpy(
        (rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32))
        for k, v in cpu.state_dict().items()})
    card = unet_from_config(3, TINY, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    tau = torch.tensor([0.2, 0.9])
    n_attn = sum(1 for n, _ in card.named_modules() if n.endswith("to_q"))
    n_gn = sum(1 for n, _ in card.named_modules()
               if n.endswith(("norm1", "norm2", "group_norm", "conv_norm_out")))
    a0, g0 = ta.fused_spatial_attention.launches, tg.fused_group_norm_act.launches
    with torch.no_grad():
        want = cpu(x, tau)
        got = card(x.to(cuda_device), tau.to(cuda_device)).cpu()
    assert ta.fused_spatial_attention.launches - a0 == n_attn > 0
    assert tg.fused_group_norm_act.launches - g0 == n_gn > 0
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_chip_smoke_refuses_without_a_card():
    """Without a CUDA device the smoke script exits non-zero and prints
    no result on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script runs for real")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""

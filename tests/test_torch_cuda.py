"""The port's CUDA kernels on the card (pdm_tpu_torch.ops).

Every `cuda`-marked test needs an NVIDIA GPU with nvcc: each kernel is
built from pdm_tpu_torch/csrc/ and held against its plain PyTorch version
on the same card inputs, at the flagship's shapes (B=64 for the forward
kernels, as the sampler; B=128 for the backward kernels, as the trainer),
and a tiny UNet's forward and train step run on the card against the
CPU. Without a card they skip, and the last test checks that
chip_smoke.py refuses to run. The file imports torch, numpy and the port
only (no JAX), so on a GPU machine without JAX it runs from the
repository root with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The whole attention block (rows 5 and 6) is held to chip_smoke's
BLOCK_TOL and BLOCK_BWD_TOL. Tolerances: fp32 kernels differ from the plain
versions by summation order only (1e-5; 1e-4 where a backward sums over many more terms); bf16
outputs by at most one rounding step of the output (2^-7 relative), and
bf16 gradients also by the products of a P or ds rounded the other way
(2^-8 of the tensor's scale). The sweep and moments kernels' moments are
held to what their Grams' rounding allows (chip_smoke.sweep_logit_error,
sweep_check; moments_logit_error, moments_check).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pdm_tpu_torch.diffusion import sampling as ts
from pdm_tpu_torch.models.unet import unet_from_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (  # noqa: E402
    BLOCK_BWD_TOL, BLOCK_TOL, adam_first_step_bound, block_inputs,
    compare_to_scale, kernel_gram_steps, moments_check, moments_logit_error,
    sweep_check, sweep_logit_error, top_two_gap, train_step_with_grads,
)
from pdm_tpu_torch.ops import attention as ta
from pdm_tpu_torch.ops import attention_block as tb
from pdm_tpu_torch.ops import boltzmann as bz
from pdm_tpu_torch.ops import boltzmann_sweep as sw
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [16, 64, 256, 512])
@pytest.mark.parametrize("hd", list(range(8, 129, 8)))
def test_attention_kernels_at_every_head_dim(cuda_device, hd, T, dtype):
    """Rows 1 and 2 at every head dim the kernels take (multiples of 8 up to
    128, zero-padded to 16, 32, 64 or 128) on the column thirds of one
    (B, T, 3C) projection: the single-pass bf16 kernels at T 16, 64 and 256,
    the two-pass ones at 512, fp32 at all four. Forward within one rounding
    of the output (2^-7; fp32 1e-5), lse 1e-5, gradients to BWD_TOL."""
    B, heads = 2, 2
    C = heads * hd
    g = torch.Generator(device=cuda_device).manual_seed(hd + T)
    qkv = torch.randn(B, T, 3 * C, generator=g, device=cuda_device).to(dtype)
    q, k, v = qkv.split(C, dim=-1)
    do = torch.randn(B, T, C, generator=g, device=cuda_device).to(dtype)
    scale = 1.0 / np.sqrt(hd)
    f0, b0 = ta.fused_spatial_attention.launches, ta.attention_bwd.launches
    out, lse = ta.attention_with_lse(q, k, v, heads, scale)
    ref, ref_lse = ta._reference_with_lse(q, k, v, heads, scale)
    got = ta.attention_bwd(q, k, v, lse, do, heads, scale)
    want = ta.attention_bwd_reference(q, k, v, lse, do, heads, scale)
    torch.cuda.synchronize()
    assert ta.fused_spatial_attention.launches == f0 + 1
    assert ta.attention_bwd.launches == b0 + 2
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == (B, T, C)
        _assert_close_to_scale(a, b, *BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,act,groups", [
    (1024, 128, "silu", 32), (1024, 384, "silu", 32), (256, 512, "silu", 32),
    (256, 256, "none", 32), (16, 256, "none", 32), (16, 512, "silu", 32),
    (64, 512, "silu", 1),   # one group of 512 channels
    (64, 96, "silu", 32),   # 3 channels a group
])
def test_group_norm_kernel_matches_plain_on_card(cuda_device, S, C, act, groups):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(64, S, C, generator=g, device=cuda_device).bfloat16()
    scale = 1.0 + 0.2 * torch.randn(C, generator=g, device=cuda_device)
    bias = 0.1 * torch.randn(C, generator=g, device=cuda_device)
    before = tg.fused_group_norm_act.launches
    y = tg.fused_group_norm_act(x, scale, bias, groups, EPS, act)
    ref = tg.group_norm_reference(x, scale, bias, groups, EPS, act).bfloat16()
    torch.cuda.synchronize()
    assert tg.fused_group_norm_act.launches == before + 1
    torch.testing.assert_close(y.float(), ref.float(), rtol=2 ** -7, atol=1e-3)


def _assert_close_to_scale(got, want, rtol, atol_of_scale):
    err, ok = compare_to_scale(got, want, rtol, atol_of_scale)
    assert ok, (err, float(want.abs().max()))


# backward kernels vs plain versions on the same card inputs: fp32 by
# summation order; bf16 by one rounding step of an output or of a rounded
# P / ds inside (2^-7 of the value, 2^-8 of the tensor's scale)
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2 ** -7, 2 ** -8)}


@pytest.mark.cuda
@pytest.mark.parametrize("T", [256, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_kernel_matches_plain_on_card(cuda_device, T, dtype):
    """The flagship training shapes (B=128, C=256, 4 heads of 64), q, k, v
    as column thirds of one projection; two kernel launches per call."""
    B, heads, C = 128, 4, 256
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn(B, T, 3 * C, generator=g, device=cuda_device).to(dtype)
    q, k, v = qkv.split(C, dim=-1)
    do = torch.randn(B, T, C, generator=g, device=cuda_device).to(dtype)
    _, lse = ta.attention_with_lse(q, k, v, heads, 0.125)
    before = ta.attention_bwd.launches
    got = ta.attention_bwd(q, k, v, lse, do, heads, 0.125)
    want = ta.attention_bwd_reference(q, k, v, lse, do, heads, 0.125)
    torch.cuda.synchronize()
    assert ta.attention_bwd.launches == before + 2
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == (B, T, C)
        _assert_close_to_scale(a, b, *BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("T,heads,hd", [(100, 2, 16), (1024, 1, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_kernel_ragged_and_long_rows(cuda_device, T, heads,
                                                       hd, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, do = (torch.randn(3, T, heads * hd, generator=g,
                               device=cuda_device).to(dtype) for _ in range(4))
    _, lse = ta.attention_with_lse(q, k, v, heads, 0.3)
    got = ta.attention_bwd(q, k, v, lse, do, heads, 0.3)
    want = ta.attention_bwd_reference(q, k, v, lse, do, heads, 0.3)
    for a, b in zip(got, want):
        _assert_close_to_scale(a, b, *BWD_TOL[dtype])


@pytest.mark.cuda
def test_attention_autograd_on_card_matches_plain(cuda_device):
    """Through the autograd Function: the forward kernel, then the
    backward kernels, against autograd of the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    qkv = torch.randn(4, 64, 3 * 128, generator=g, device=cuda_device)
    t1, t2 = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
    do = torch.randn(4, 64, 128, generator=g, device=cuda_device)
    ta.fused_spatial_attention(*t1.split(128, dim=-1), 2, 0.125).backward(do)
    ta.attention_reference(*t2.split(128, dim=-1), 2, 0.125).backward(do)
    _assert_close_to_scale(t1.grad, t2.grad, 1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,act,dtype,groups", [
    (1024, 128, "silu", torch.bfloat16, 32), (1024, 384, "silu", torch.bfloat16, 32),
    (256, 512, "silu", torch.bfloat16, 32), (256, 256, "none", torch.bfloat16, 32),
    (16, 256, "none", torch.bfloat16, 32), (64, 96, "silu", torch.float32, 32),
    (16, 512, "silu", torch.bfloat16, 32),
    (64, 96, "silu", torch.bfloat16, 32),   # 3 channels a group
    (64, 512, "silu", torch.bfloat16, 1),   # one group of 512 channels
    (64, 512, "silu", torch.float32, 1),
])
def test_group_norm_backward_kernel_matches_plain_on_card(cuda_device, S, C,
                                                          act, dtype, groups):
    """The flagship training shapes at B=128 (and fp32 cases at B=8), 3
    channels a group, and one group of 512 channels (the backward once
    refused more than 256 a group): dx within one rounding of the output,
    dscale/dbias (fp32 sums over B, S) within 1e-4 of scale."""
    B = 128 if dtype == torch.bfloat16 else 8
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(B, S, C, generator=g, device=cuda_device).to(dtype)
    dy = torch.randn(B, S, C, generator=g, device=cuda_device).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(C, generator=g, device=cuda_device)
    bias = 0.1 * torch.randn(C, generator=g, device=cuda_device)
    before = tg.group_norm_bwd.launches
    dx, ds, db = tg.group_norm_bwd(x, scale, bias, dy, groups, EPS, act)
    want = tg.group_norm_bwd_reference(x, scale, bias, dy, groups, EPS, act)
    torch.cuda.synchronize()
    assert tg.group_norm_bwd.launches == before + 1
    assert dx.dtype == dtype and ds.dtype == db.dtype == torch.float32
    _assert_close_to_scale(dx, want[0], *BWD_TOL[dtype])
    _assert_close_to_scale(ds, want[1], 1e-4, 1e-4)
    _assert_close_to_scale(db, want[2], 1e-4, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C,groups,dtype", [
    (8, 1024, 384, 32, torch.bfloat16),  # clusters of 8 blocks, 4 channel slices
    (4, 64, 512, 1, torch.float32),      # one group: a cluster of 4 blocks
    (8, 1024, 512, 1, torch.bfloat16),   # the backward's plan streams
])
def test_group_norm_kernels_are_bitwise_deterministic(cuda_device, B, S, C,
                                                      groups, dtype):
    """Both GroupNorm kernels give bitwise equal results on two calls: the
    cluster adds its blocks' sums in rank order, no atomics."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x, dy = (torch.randn(B, S, C, generator=g, device=cuda_device).to(dtype)
             for _ in range(2))
    scale = 1.0 + 0.2 * torch.randn(C, generator=g, device=cuda_device)
    bias = 0.1 * torch.randn(C, generator=g, device=cuda_device)
    plans = [tg.plan_group_norm(B, S, C, groups, x.element_size(), bwd)
             for bwd in (False, True)]
    assert max(p.kr for p in plans) > 1
    y = [tg.fused_group_norm_act(x, scale, bias, groups, EPS, "silu")
         for _ in range(2)]
    grads = [tg.group_norm_bwd(x, scale, bias, dy, groups, EPS, "silu")
             for _ in range(2)]
    assert torch.equal(y[0], y[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
def test_group_norm_autograd_at_one_group_on_card_matches_cpu(cuda_device):
    """groups 1, C 512 (cpg 512) through the autograd Function: the forward
    kernel, then the backward kernel (one launch each), against the plain
    versions on the CPU; the output to 1e-5, dx to BWD_TOL, dscale/dbias to
    1e-4 of their scale."""
    B, S, C = 4, 64, 512
    rng = np.random.RandomState(11)
    x = torch.from_numpy((rng.standard_normal((B, S, C)) * 2 + 0.5).astype(np.float32))
    scale = torch.from_numpy((1 + 0.2 * rng.standard_normal(C)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((B, S, C)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        tx, ts, tb = (t.detach().clone().to(dev).requires_grad_() for t in (x, scale, bias))
        f0, b0 = tg.fused_group_norm_act.launches, tg.group_norm_bwd.launches
        y = tg.fused_group_norm_act(tx, ts, tb, 1, EPS, "silu")
        y.backward(dy.to(dev))
        out[str(dev)] = (y.detach().cpu(), tx.grad.cpu(), ts.grad.cpu(), tb.grad.cpu(),
                         (tg.fused_group_norm_act.launches - f0,
                          tg.group_norm_bwd.launches - b0))
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert cpu[4] == (0, 0) and card[4] == (1, 1)
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-5, atol=1e-5)
    _assert_close_to_scale(card[1], cpu[1], *BWD_TOL[torch.float32])
    _assert_close_to_scale(card[2], cpu[2], 1e-4, 1e-4)
    _assert_close_to_scale(card[3], cpu[3], 1e-4, 1e-4)


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


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,widths,kernel", [
    (8, [32, 64], True),       # 8 heads of 8
    (None, [32, 64], True),    # one head of 64
    (None, [32, 256], False),  # one head of 256: outside the gate
])
def test_tiny_unet_head_dims_on_card_match_cpu(cuda_device, head_dim, widths,
                                               kernel):
    """attention_head_dim 8 and null in fp32, card against CPU to 1e-4 of
    the output scale: inside the attention gate each attention block
    launches row 1 once; a head dim of 256 runs the model's XLA branch on
    the card, with no row-1 launch."""
    cfg = {**TINY, "attention_head_dim": head_dim, "block_out_channels": widths}
    cpu = unet_from_config(3, cfg, device="cpu")
    rng = np.random.RandomState(5)
    cpu.load_state_dict({k: torch.from_numpy(
        (rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32))
        for k, v in cpu.state_dict().items()})
    card = unet_from_config(3, cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    tau = torch.tensor([0.2, 0.9])
    n_attn = sum(1 for n, _ in card.named_modules() if n.endswith("to_q"))
    a0 = ta.fused_spatial_attention.launches
    with torch.no_grad():
        want = cpu(x, tau)
        got = card(x.to(cuda_device), tau.to(cuda_device)).cpu()
    assert ta.fused_spatial_attention.launches - a0 == (n_attn if kernel else 0)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_tiny_unet_train_step_on_card_matches_cpu(cuda_device):
    """One fp32 train step of a tiny UNet (dropout 0, the same tau and
    eps) on the card (kernels) and on the CPU (plain versions): loss and
    grad_norm to 1e-4 relative, each gradient the step applied to 1e-4 of
    its scale plus 1e-6 of the largest gradient's, and the parameters
    after the Adam step within what those two gradients allow
    (adam_first_step_bound, + 1e-7). Each kernel launches once per call of
    its layer."""
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    cfg = {**TINY, "dropout": 0.0}
    lr = 1e-3
    rng = np.random.RandomState(0)
    cpu_net = unet_from_config(3, cfg, device="cpu")
    params = {k: torch.from_numpy(
        (rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32))
        for k, v in cpu_net.named_parameters()}
    x0 = torch.from_numpy(rng.standard_normal((4, 3, 16, 16)).astype(np.float32))
    tau = torch.from_numpy(rng.uniform(0, 1, 4).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((4, 3, 16, 16)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        net = cpu_net if dev == "cpu" else unet_from_config(3, cfg, device=dev)
        tr = DDPMTrainer(UNetDDPM(LinearBetaScheduler(1e-4, 1e2), net,
                                  device=dev),
                         learning_rate=lr, warmup_steps=0, grad_clip=1e3)
        state = tr.init_state(params)
        counts = (ta.fused_spatial_attention.launches, ta.attention_bwd.launches,
                  tg.fused_group_norm_act.launches, tg.group_norm_bwd.launches)
        state, m, grads = train_step_with_grads(
            tr, state, x0.to(dev), tau=tau.to(dev), eps=eps.to(dev))
        after = (ta.fused_spatial_attention.launches, ta.attention_bwd.launches,
                 tg.fused_group_norm_act.launches, tg.group_norm_bwd.launches)
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]), grads,
                         {k: v.cpu() for k, v in state.params.items()},
                         [a - b for a, b in zip(after, counts)])
    n_attn = sum(1 for n, _ in cpu_net.named_modules() if n.endswith("to_q"))
    n_gn = sum(1 for n, _ in cpu_net.named_modules()
               if n.endswith(("norm1", "norm2", "group_norm", "conv_norm_out")))
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert cpu[4] == [0, 0, 0, 0]
    assert card[4] == [n_attn, 2 * n_attn, n_gn, n_gn]
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-4)
    top = max(float(g.abs().max()) for g in cpu[2].values())
    for k, g in cpu[2].items():
        err = float((card[2][k] - g).abs().max())
        assert err <= 1e-4 * float(g.abs().max()) + 1e-6 * top, k
        step_err = (card[3][k] - cpu[3][k]).abs()
        assert bool((step_err <= adam_first_step_bound(card[2][k], g, lr)
                     + 1e-7).all()), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,heads,hd", [
    (2, 64, 2, 32),     # small; T 64: one image a strip, the packing's edge
    (3, 100, 4, 16),    # ragged: T not a multiple of 16 or 64
    (64, 256, 4, 64),   # the flagship's 16x16 blocks
    (64, 16, 4, 64),    # its 4x4 mid block: four images a 64-row strip
    (5, 16, 8, 16),     # T 16 at head dims 16 and 32, 8 heads
    (5, 16, 8, 32),
    (4, 64, 8, 64),     # T 64, 8 heads
    (5, 40, 4, 32),     # ragged T with packing: one image a strip, 24 rows padding
    (9, 24, 2, 64),     # two images a strip, 8 rows padding each, 9 % 4 images
    (3, 192, 2, 64),    # three key chunks and a padding strip
    (3, 64, 1, 64),     # one head: a cluster of one block
    (2, 48, 3, 16),     # C 48: one contraction chunk, zero-filled past C
    (2, 130, 5, 32),    # C 160: a ragged last chunk; 5 heads, 3 key chunks
    (600, 16, 4, 64),   # 75 packed groups: more clusters than fit at once
    (96, 100, 4, 32),   # 96 groups of one ragged image, likewise
])
def test_attention_block_kernels_match_plain_on_card(cuda_device, B, T, heads,
                                                     hd, dtype):
    """Rows 5 and 6: the forward (and its lse) and every gradient of the
    backward against the plain versions on the same card inputs, to
    chip_smoke's BLOCK_TOL / BLOCK_BWD_TOL (db_qkv as one vector: db_k is
    zero in exact arithmetic); one launch forward, three backward; a second
    call of each bitwise equal to the first. The last two shapes launch
    more clusters than the card holds at once."""
    C = heads * hd
    g = torch.Generator(device=cuda_device).manual_seed(B + T)
    x, h, ws, bs, wo, bo = block_inputs(g, cuda_device, B, T, C, dtype)
    scale = 1.0 / np.sqrt(hd)
    f0, b0 = tb.fused_attention_block.launches, tb.attention_block_bwd.launches
    out, lse = tb._forward(x, h, ws, bs, wo, bo, heads, scale)
    ref, ref_lse = tb._reference_with_lse(x, h, *ws, bs, wo, bo, heads, scale)
    gco = torch.randn(B, T, C, generator=g, device=cuda_device).to(dtype)
    got = tb.attention_block_bwd(h, *ws, bs, wo, lse, gco, heads, scale)
    want = tb.attention_block_bwd_reference(h, *ws, bs, wo, lse, gco, heads, scale)
    torch.cuda.synchronize()
    assert tb.fused_attention_block.launches == f0 + 1
    assert tb.attention_block_bwd.launches == b0 + 3
    out2, lse2 = tb._forward(x, h, ws, bs, wo, bo, heads, scale)
    got2 = tb.attention_block_bwd(h, *ws, bs, wo, lse, gco, heads, scale)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(got, got2))
    dname = str(dtype).split(".")[1]
    _assert_close_to_scale(out, ref, *BLOCK_TOL[dname])
    _assert_close_to_scale(lse, ref_lse, *BLOCK_TOL[dname])
    assert got[0].dtype == dtype and got[0].shape == (B, T, C)
    for a, w in zip(got[1:4] + got[7:], want[1:4] + want[7:]):
        _assert_close_to_scale(a, w, *BLOCK_BWD_TOL[dname])
    _assert_close_to_scale(got[0], want[0], *BLOCK_BWD_TOL[dname])
    _assert_close_to_scale(torch.cat(got[4:7]), torch.cat(want[4:7]),
                           *BLOCK_BWD_TOL[dname])


@pytest.mark.cuda
def test_attention_block_gate_raises_for_shapes_the_kernels_do_not_take(
        cuda_device, monkeypatch):
    """With PDM_FUSED_BLOCK=1 the gate opens for any head dim that is a
    multiple of 8 (as JAX's). The whole-block wrapper still raises on the
    card for a head dim with no instantiation; the UNet's attention block
    sends such a shape down its standard path instead (row 1, no row-5
    launch) and matches the CPU."""
    monkeypatch.setenv("PDM_FUSED_BLOCK", "1")
    for heads, hd in ((1, 128), (8, 8)):
        C = heads * hd
        assert tb.use_fused_attention_block(64, C, heads)
        assert not tb.kernels_take(64, C, heads)
        x, h, ws, bs, wo, bo = block_inputs(
            torch.Generator(device=cuda_device).manual_seed(0), cuda_device, 2,
            64, C, torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            tb.fused_attention_block(x, h, *ws, bs, wo, bo, heads, 0.1)
    cfg = {**TINY, "attention_head_dim": 8}
    cpu = unet_from_config(3, cfg, device="cpu")
    rng = np.random.RandomState(6)
    cpu.load_state_dict({k: torch.from_numpy(
        (rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32))
        for k, v in cpu.state_dict().items()})
    net = unet_from_config(3, cfg, device=cuda_device)
    net.load_state_dict(cpu.state_dict())
    n_attn = sum(1 for n, _ in net.named_modules() if n.endswith("to_q"))
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    tau = torch.tensor([0.3, 0.6])
    a0, f0 = ta.fused_spatial_attention.launches, tb.fused_attention_block.launches
    with torch.no_grad():
        want = cpu(x, tau)
        got = net(x.to(cuda_device), tau.to(cuda_device)).cpu()
    assert ta.fused_spatial_attention.launches - a0 == n_attn
    assert tb.fused_attention_block.launches == f0
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_tiny_unet_with_the_fused_block_on_card_matches_cpu(cuda_device,
                                                            monkeypatch):
    """PDM_FUSED_BLOCK=1, fp32: the tiny UNet's loss and gradients on the
    card (rows 5 and 6) against the CPU (plain versions), as the default
    path's test: 1e-4 relative loss, each gradient 1e-4 of its scale plus
    1e-6 of the largest; one row-5 launch per attention block forward and
    three row-6 launches backward, no row-1 or row-2 launch."""
    monkeypatch.setenv("PDM_FUSED_BLOCK", "1")
    from pdm_tpu_torch.diffusion.trainer import DDPMTrainer
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    cfg = {**TINY, "dropout": 0.0}
    rng = np.random.RandomState(3)
    cpu_net = unet_from_config(3, cfg, device="cpu")
    params = {k: torch.from_numpy(
        (rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32))
        for k, v in cpu_net.named_parameters()}
    x0 = torch.from_numpy(rng.standard_normal((4, 3, 16, 16)).astype(np.float32))
    tau = torch.from_numpy(rng.uniform(0, 1, 4).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((4, 3, 16, 16)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        net = cpu_net if dev == "cpu" else unet_from_config(3, cfg, device=dev)
        tr = DDPMTrainer(UNetDDPM(LinearBetaScheduler(1e-4, 1e2), net, device=dev),
                         learning_rate=1e-3, warmup_steps=0, grad_clip=1e3)
        state = tr.init_state(params)
        counts = (ta.fused_spatial_attention.launches, ta.attention_bwd.launches,
                  tb.fused_attention_block.launches, tb.attention_block_bwd.launches)
        state, m, grads = train_step_with_grads(
            tr, state, x0.to(dev), tau=tau.to(dev), eps=eps.to(dev))
        after = (ta.fused_spatial_attention.launches, ta.attention_bwd.launches,
                 tb.fused_attention_block.launches, tb.attention_block_bwd.launches)
        out[str(dev)] = (float(m["loss"]), grads, [a - b for a, b in zip(after, counts)])
    n_attn = sum(1 for n, _ in cpu_net.named_modules() if n.endswith("to_q"))
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert cpu[2] == [0, 0, 0, 0]
    assert card[2] == [0, 0, n_attn, 3 * n_attn]
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    top = max(float(g.abs().max()) for g in cpu[1].values())
    for k, g in cpu[1].items():
        err = float((card[1][k] - g).abs().max())
        assert err <= 1e-4 * float(g.abs().max()) + 1e-6 * top, k


def _sweep_case(dev, B, N, D, nt, seed, log10_t=(-1.0, 3.0)):
    """Starts that are dataset points (as thermo_sweep draws them), shared
    noise, a positive payload, and the logit tolerance of each mode."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(N, D, generator=g, device=dev)
    x0 = y[:B].clone()
    eps = torch.randn(B, D, generator=g, device=dev)
    temps = torch.logspace(*log10_t, nt, device=dev)
    vals = torch.rand(N, 1, generator=g, device=dev) + 0.1
    sq = [float((0.5 * (t * t).sum(1)).max()) for t in (x0, eps, y)]

    def delta(mode):
        return sweep_logit_error(*sq, D, temps.cpu().numpy(),
                                 kernel_gram_steps(mode, D))
    return x0, eps, y, temps, vals, delta


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16_3x", "bf16"])
@pytest.mark.parametrize("B,N,D,nt", [
    (256, 4096, 768, 16),  # whole tiles
    (77, 5003, 333, 7),  # no tile's multiple
    (1, 2000, 1, 5),  # one start, one feature
    (130, 9000, 100, 200),  # 200 temperatures: partials beyond shared memory
    (129, 3001, 257, 33),  # one row past the fp32 kernel's 128-row tile
    (1, 5003, 333, 7),  # one start, no tile's multiple
])
def test_sweep_kernel_matches_plain_on_card(cuda_device, B, N, D, nt, mode):
    """Both launches (partials, merge) per call, with and without the
    (N, 1) payload, from a raw dataset and from its pack."""
    x0, eps, y, temps, vals, delta = _sweep_case(cuda_device, B, N, D, nt, 5)
    prep = sw.prepare_y(y, mode)
    for v in (None, vals):
        before = sw.boltzmann_sweep.launches
        got = sw.boltzmann_sweep(x0, eps, prep, temps, values=v, mxu_precision=mode)
        raw = sw.boltzmann_sweep(x0, eps, y, temps, values=v, mxu_precision=mode)
        want = sw.boltzmann_sweep_reference(x0, eps, prep, temps, values=v,
                                            mxu_precision=mode)
        torch.cuda.synchronize()
        assert sw.boltzmann_sweep.launches == before + 4
        assert got.log_z.shape == (nt, B)
        for a, b in zip(got, raw):
            if a is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        _, worst = sweep_check(got, want, delta(mode), v_max=float(vals.max()))
        assert worst <= 1.0, worst


@pytest.mark.cuda
def test_sweep_kernel_never_reaches_the_plain_version(cuda_device, monkeypatch):
    """A CUDA input launches the kernels in every mode and never calls the
    plain version (here made to raise)."""
    x0, eps, y, temps, vals, _ = _sweep_case(cuda_device, 64, 1000, 32, 4, 6)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA input")

    monkeypatch.setattr(sw, "boltzmann_sweep_reference", refuse)
    for mode in ("fp32", "bf16_3x", "bf16"):
        before = sw.boltzmann_sweep.launches
        out = sw.boltzmann_sweep(x0, eps, y, temps, values=vals, mxu_precision=mode)
        torch.cuda.synchronize()
        assert sw.boltzmann_sweep.launches == before + 2
        assert all(bool(torch.isfinite(f).all()) for f in out)


@pytest.mark.cuda
def test_thermo_sweep_on_card_matches_cpu(cuda_device):
    """thermo_sweep on the card (the kernels, exactly two launches per
    batch) against the CPU (the plain version) on the same draws. Each
    row's moments move by what the logit error delta allows
    (sweep_check); a row's variance is at most B times the batch mean C,
    so the curves may differ by 2 delta (1 + sqrt(B C)) (entropy), T delta
    (free energy) and 2 delta (2 sqrt(B C) + B C) (heat capacity)."""
    from pdm_tpu_torch.stats.sweep import thermo_sweep

    n, d, bs, n_samples = 3000, 24, 96, 200
    data = torch.randn(n, d, generator=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    sizes = [96, 96, 8]
    draws = [(torch.randint(0, n, (b,), generator=g), torch.randn(b, d, generator=g))
             for b in sizes]
    temp = np.logspace(-2, 2, 9)
    before = sw.boltzmann_sweep.launches
    card = thermo_sweep(data, temp, n_samples, bs, draws=draws, regularize=True,
                        device=cuda_device)
    assert sw.boltzmann_sweep.launches - before == 2 * len(sizes)
    cpu = thermo_sweep(data, temp, n_samples, bs, draws=draws, regularize=True,
                       device="cpu")
    x0 = torch.cat([data[i] for i, _ in draws])
    eps = torch.cat([e for _, e in draws])
    sq = [float((0.5 * (t * t).sum(1)).max()) for t in (x0, eps, data)]
    dl = sweep_logit_error(*sq, d, temp, kernel_gram_steps("fp32", d))
    bc = bs * cpu["heat_capacity"]
    tol = {"entropy": 2 * dl * (1 + np.sqrt(bc)), "free_energy": temp * dl,
           "heat_capacity": 2 * dl * (2 * np.sqrt(bc) + bc)}
    for k, t in tol.items():
        floor = 1e-5 * (1 + np.abs(cpu[k]))
        assert np.all(np.abs(card[k] - cpu[k]) <= t + floor), k
    np.testing.assert_allclose(card["dataset_tr_sigma0"], cpu["dataset_tr_sigma0"],
                               rtol=1e-5)


def _moments_case(dev, B, N, D, K, seed):
    """Noised queries as the denoiser sees them (xt = sqrt(ab) y_j +
    sqrt(1 - ab) eps over T = 1e-4..1e4, one T per row), a payload of K
    columns (the data itself when K = D), and the logit tolerance."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(N, D, generator=g, device=dev)
    temps = torch.logspace(-4.0, 4.0, B, device=dev)
    ab = 1.0 / (1.0 + temps)
    x = (torch.sqrt(ab)[:, None] * y[torch.randint(0, N, (B,), generator=g, device=dev)]
         + torch.sqrt(1.0 - ab)[:, None] * torch.randn(B, D, generator=g, device=dev))
    v = y if K == D else torch.randn(N, K, generator=g, device=dev)
    inv_t, scale = 1.0 / (1.0 - ab), torch.sqrt(ab)
    sq = [float((0.5 * (t * t).sum(1)).max()) for t in (x, y)]

    def check(got, want, mode):
        delta = moments_logit_error(*sq, D, inv_t.cpu().numpy(), scale.cpu().numpy(),
                                    kernel_gram_steps(mode, D))
        return moments_check(got, want, delta, top_two_gap(x, y, inv_t, scale),
                             float(v.max() - v.min()), float(v.abs().max()), N)[1]
    return x, y, inv_t, scale, v, check


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16_3x", "bf16"])
@pytest.mark.parametrize("B,N,D,K", [
    (256, 4096, 768, 768),  # whole tiles, the data as payload
    (77, 5003, 333, 13),  # no tile's multiple; K % 4 != 0 (4-byte copies)
    (1, 300, 1, 1),  # one query, one feature
    (64, 2000, 64, 3072),  # K at the cluster threshold (bf16: the cluster kernel)
    (64, 2000, 64, 3076),  # K above it (bf16: the tiled kernel)
    (5, 5003, 33, 131),  # K 131 (4-byte copies), no tile's multiple
    (129, 3001, 40, 8),  # one row past the tall kernel's 128-row tile
])
def test_moments_kernel_matches_plain_on_card(cuda_device, B, N, D, K, mode):
    """Two launches per call, with and without the payload, from a raw
    dataset and from its pack."""
    x, y, inv_t, scale, v, check = _moments_case(cuda_device, B, N, D, K, 9)
    prep = sw.prepare_y(y, mode)
    for vals in (None, v):
        before = bz.boltzmann_moments.launches
        got = bz.boltzmann_moments(x, prep, inv_t, scale, values=vals,
                                   mxu_precision=mode)
        raw = bz.boltzmann_moments(x, y, inv_t, scale, values=vals,
                                   mxu_precision=mode)
        want = bz.boltzmann_moments_reference(x, y, inv_t, scale, values=vals,
                                              mxu_precision=mode)
        torch.cuda.synchronize()
        assert bz.boltzmann_moments.launches == before + 4
        assert got.log_z.shape == (B,)
        for a, b in zip(got, raw):
            if a is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert check(got, want, mode) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16_3x", "bf16"])
@pytest.mark.parametrize("op", ["moments", "sweep"])
def test_kernels_are_bitwise_deterministic(cuda_device, op, mode):
    """Two calls on the same inputs give the same bits (no atomics, every
    sum in a fixed order): the moments kernels with a payload of K 3072,
    which the bf16 modes' cluster kernel takes in clusters of 8 blocks
    (the cross-block fold through distributed shared memory), and the
    sweep with a payload."""
    if op == "moments":
        x, y, inv_t, scale, v, _ = _moments_case(cuda_device, 64, 2000, 64, 3072, 11)
        prep = sw.prepare_y(y, mode)
        run = lambda: bz.boltzmann_moments(x, prep, inv_t, scale, values=v,  # noqa: E731
                                           mxu_precision=mode)
    else:
        x0, eps, y, temps, vals, _ = _sweep_case(cuda_device, 200, 3000, 96, 9, 12)
        prep = sw.prepare_y(y, mode)
        run = lambda: sw.boltzmann_sweep(x0, eps, prep, temps, values=vals,  # noqa: E731
                                         mxu_precision=mode)
    a, b = run(), run()
    torch.cuda.synchronize()
    for fa, fb in zip(a, b):
        assert (fa is None) == (fb is None)
        if fa is not None:
            assert torch.equal(fa, fb)


@pytest.mark.cuda
def test_moments_kernel_never_reaches_the_plain_version(cuda_device, monkeypatch):
    """A CUDA input launches the kernels in every mode, never the plain
    version (here made to raise), and refuses an input that requires grad
    (the kernel has no backward)."""
    x, y, inv_t, scale, v, _ = _moments_case(cuda_device, 64, 1000, 32, 32, 10)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA input")

    monkeypatch.setattr(bz, "boltzmann_moments_reference", refuse)
    for mode in ("fp32", "bf16_3x", "bf16"):
        before = bz.boltzmann_moments.launches
        out = bz.boltzmann_moments(x, y, inv_t, scale, compute_mean=True,
                                   mxu_precision=mode)
        torch.cuda.synchronize()
        assert bz.boltzmann_moments.launches == before + 2
        assert all(bool(torch.isfinite(f).all()) for f in out)
    for kw in ({"x": x.clone().requires_grad_()}, {"y": y.clone().requires_grad_()},
               {"inv_t": inv_t.clone().requires_grad_()}):
        args = {"x": x, "y": y, "inv_t": inv_t, **kw}
        with pytest.raises(ValueError, match="requires grad"):
            bz.boltzmann_moments(args["x"], args["y"], args["inv_t"], scale,
                                 compute_mean=True)


@pytest.mark.cuda
def test_true_ddpm_sample_on_card_matches_cpu(cuda_device):
    """A 3-step DDIM sample of TrueDDPM: one moments call (two launches)
    per step on the card, the dataset packed once; the same samples as the
    CPU's plain version from the same start, to 1e-4 of their scale."""
    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler

    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.standard_normal((500, 3, 4, 4)).astype(np.float32))
    x_init = torch.from_numpy(rng.standard_normal((16, 3, 4, 4)).astype(np.float32))
    sched = LinearBetaScheduler(1e-4, 2.478e4)
    out = {}
    for dev in ("cpu", cuda_device):
        ddpm = TrueDDPM(sched, data, device=dev)
        sampler = ts.DDPMSampler(ddpm=ddpm, scheduler=sched, n_steps=3,
                                 obj_size=(3, 4, 4), batch_size=16,
                                 step_type="ddim", device=dev)
        before = bz.boltzmann_moments.launches
        out[str(dev)] = sampler.batch_sample(x_init=x_init)["x"].cpu()
        out[str(dev) + "_launches"] = bz.boltzmann_moments.launches - before
    assert out["cpu_launches"] == 0 and out[str(cuda_device) + "_launches"] == 6
    want = out["cpu"]
    assert float((out[str(cuda_device)] - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def _serve_counts():
    return {"attention": ta.fused_spatial_attention.launches,
            "group_norm": tg.fused_group_norm_act.launches,
            "block": tb.fused_attention_block.launches,
            "moments": bz.boltzmann_moments.launches}


def _counted(fn):
    before = _serve_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in _serve_counts().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["tiny_unet", "gmm"])
def test_exported_sampler_replays_on_card(cuda_device, tmp_path, model,
                                          monkeypatch):
    """An exported step replays batch_sample on the card bitwise, through
    the pdm:: custom ops' CUDA implementations, with exact launch counts:
    the tiny bf16 UNet's DDIM-4 (rows 1 and 3) and TrueDDPM on the 1-D GMM
    with DDPM-6 (row 7, two launches a step; the loader draws the
    noise). Export traces no launch."""
    from pdm_tpu_torch.models.base import TrueDDPM
    from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
    from pdm_tpu_torch.schedulers.analytic import LogSNRScheduler
    from pdm_tpu_torch.utils.serving import export_sampler, load_exported
    from pdm_tpu_torch.utils.synthetic import generate_gmm_1d

    monkeypatch.delenv("PDM_FUSED_BLOCK", raising=False)
    sched = LogSNRScheduler(1e-4, 1e1)
    if model == "tiny_unet":
        net = unet_from_config(3, TINY, dtype=torch.bfloat16, device=cuda_device)
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        ddpm = UNetDDPM(sched, net, device=cuda_device)
        kw = dict(n_steps=4, obj_size=(3, 16, 16), batch_size=8,
                  step_type="ddim", precision="half")
        # TINY's attention blocks: one down, one mid, two up (8 x 8)
        per_step = {"attention": 4, "group_norm": None, "block": 0,
                    "moments": 0}
    else:
        ddpm = TrueDDPM(sched, generate_gmm_1d(20_000), device=cuda_device)
        kw = dict(n_steps=6, obj_size=(1, 1, 1), batch_size=32,
                  step_type="ddpm")
        per_step = {"attention": 0, "group_norm": 0, "block": 0, "moments": 2}
    sampler = ts.DDPMSampler(ddpm=ddpm, scheduler=sched, n_samples=kw[
        "batch_size"], device=cuda_device, **kw)
    path = str(tmp_path / "sampler.pt2")
    _, traced = _counted(lambda: export_sampler(sampler, path))
    assert traced == dict.fromkeys(traced, 0)
    fn, manifest = load_exported(path)
    assert manifest["platforms"] == ["cuda"]
    want, eager_n = _counted(lambda: sampler.batch_sample(
        torch.Generator(device=cuda_device).manual_seed(3))["x"])
    got, replay_n = _counted(lambda: fn(3))
    assert torch.equal(got, want)
    assert replay_n == eager_n
    n = kw["n_steps"]
    for key, per in per_step.items():
        if per is not None:
            assert replay_n[key] == per * n, (key, replay_n)
    assert replay_n["group_norm"] % n == 0


@pytest.mark.cuda
def test_custom_ops_opcheck_on_card(cuda_device):
    """torch.library.opcheck on the four pdm:: ops' CUDA implementations
    (schema, fake against real, autograd registration, AOT dispatch)."""
    from pdm_tpu_torch.ops.boltzmann_sweep import prepare_y

    g = torch.Generator(device=cuda_device).manual_seed(0)

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = t(2, 256, 384, dtype=dt).chunk(3, dim=-1)
        cases.append(("attention_fwd", (q, k, v, 2, 0.125)))
        cases.append(("group_norm_act", (t(2, 256, 128, dtype=dt), t(128), t(128),
                                         32, 1e-6, "silu")))
        cases.append(("attention_block_fwd", (
            t(2, 64, 128, dtype=dt), t(2, 64, 128, dtype=dt),
            *(t(128, 128, dtype=dt) * 0.05 for _ in range(3)), t(128), t(128),
            t(128), t(128, 128, dtype=dt) * 0.05, t(128), 2, 0.125)))
    y = t(3000, 64)
    for mode, values in (("fp32", y), ("bf16_3x", None), ("bf16", t(3000, 8))):
        prep = prepare_y(y, mode)
        cases.append(("boltzmann_moments", (
            t(100, 64), prep.yt_hi, prep.yt_lo, prep.ysq, prep.n, mode,
            torch.rand(100, generator=g, device=cuda_device) + 0.5,
            torch.rand(100, generator=g, device=cuda_device) + 0.5, values)))
    for name, args in cases:
        torch.library.opcheck(getattr(torch.ops.pdm, name).default, args)


def test_chip_smoke_refuses_without_a_card():
    """Without a CUDA device the smoke script exits non-zero and prints
    no result on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script runs for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""

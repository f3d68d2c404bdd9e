"""Rows 3s and 4s (split-statistics GroupNorm) on the card.

Every `cuda`-marked test needs an NVIDIA GPU with nvcc: the kernels build
from pdm_tpu_torch/csrc/ and each is held against its plain PyTorch
version on the same card inputs; the split pair (statistics of R row
pieces, their sums added in piece order as the model group's all-reduce
adds them, then the normalise; the same for the backward) is held against
rows 3 and 4 on the whole image. Without a card they skip. The file
imports torch, numpy and the port only (no JAX); on a GPU machine it runs
from the repository root with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_parallel_model.py -q

Tolerances are chip_smoke.py's: statistics and parameter gradients are
fp32 sums in another order (PARAM_GRAD_TOL, 1e-4 relative plus 1e-4 of
the scale); the normalised output one rounding step of its dtype (TOL);
dx BWD_TOL.
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (  # noqa: E402
    BWD_TOL, PARAM_GRAD_TOL, compare, compare_to_scale, split_gn_pieces,
)
from pdm_tpu_torch.ops import groupnorm as tg  # noqa: E402

EPS = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the card")
    return torch.device("cuda")


def _inputs(dev, B, S, C, dtype):
    g = torch.Generator(device=dev).manual_seed(S + C)
    x = (torch.randn(B, S, C, generator=g, device=dev) * 2 + 0.5).to(dtype)
    dy = torch.randn(B, S, C, generator=g, device=dev).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
    bias = 0.1 * torch.randn(C, generator=g, device=dev)
    return x, dy, scale, bias


# (B, S, C, groups): the flagship's 32x32 level split in 2, its 16x16 level
# split in 4, C 64 in 16 groups (a channel-parallel rank's slice of 128),
# 3 channels a group, one group of 512 channels, the headline shape at C
# 256 (B 64, S 512 of 1024) and the first level of a 256 x 256 image split
# in two (B 8, S 32768: 64 slabs an image)
SHAPES = [(8, 512, 128, 32), (8, 64, 256, 32), (4, 256, 64, 16),
          (4, 16, 96, 32), (2, 128, 512, 1), (64, 512, 256, 32),
          (8, 32768, 128, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,C,G", SHAPES)
def test_split_kernels_match_plain_on_card(cuda_device, B, S, C, G, dtype, act):
    x, dy, scale, bias = _inputs(cuda_device, B, S, C, dtype)
    n = float(2 * S) * float(C // G)  # as if the image had another S rows
    before = [f.launches for f in (tg.group_norm_stats, tg.group_norm_apply,
                                   tg.group_norm_bwd_stats,
                                   tg.group_norm_bwd_apply)]
    sums = tg.group_norm_stats(x, G)
    want = tg.group_norm_stats_reference(x, G)
    assert compare_to_scale(sums, want, *PARAM_GRAD_TOL)[1]
    sums = sums * 2  # the other rank's rows: the same sums again
    y = tg.group_norm_apply(x, scale, bias, sums, G, n, EPS, act)
    ref = tg.group_norm_apply_reference(x, scale, bias, sums, G, n, EPS, act)
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    assert y.dtype == dtype and compare(y, ref, dname)[1]
    gs, dsc, dbi = tg.group_norm_bwd_stats(x, dy, scale, bias, sums, G, n, EPS, act)
    gs_r, dsc_r, dbi_r = tg.group_norm_bwd_stats_reference(x, dy, scale, bias,
                                                           sums, G, n, EPS, act)
    for a, b in ((gs, gs_r), (dsc, dsc_r), (dbi, dbi_r)):
        assert compare_to_scale(a, b, *PARAM_GRAD_TOL)[1]
    gs = gs * 2
    dx = tg.group_norm_bwd_apply(x, dy, scale, bias, sums, gs, G, n, EPS, act)
    dx_r = tg.group_norm_bwd_apply_reference(x, dy, scale, bias, sums, gs, G, n,
                                             EPS, act)
    assert dx.dtype == dtype and compare_to_scale(dx, dx_r, *BWD_TOL[dname])[1]
    after = [f.launches for f in (tg.group_norm_stats, tg.group_norm_apply,
                                  tg.group_norm_bwd_stats, tg.group_norm_bwd_apply)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,C,G", SHAPES)
def test_split_kernels_are_bitwise_repeatable(cuda_device, B, S, C, G, dtype):
    """Two calls of each launch give bitwise the same outputs: the slabs'
    partials (and 4s's images' totals) are added in a fixed order, the
    counters only pick the block that adds them."""
    x, dy, scale, bias = _inputs(cuda_device, B, S, C, dtype)
    n = float(2 * S) * float(C // G)
    calls = [
        lambda: (tg.group_norm_stats(x, G),),
        lambda: (tg.group_norm_apply(x, scale, bias, sums, G, n, EPS, "silu"),),
        lambda: tg.group_norm_bwd_stats(x, dy, scale, bias, sums, G, n, EPS, "silu"),
        lambda: (tg.group_norm_bwd_apply(x, dy, scale, bias, sums, gs, G, n, EPS,
                                         "silu"),)]
    sums = tg.group_norm_stats(x, G) * 2
    gs = tg.group_norm_bwd_stats(x, dy, scale, bias, sums, G, n, EPS, "silu")[0] * 2
    for call in calls:
        first, second = call(), call()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [128, 256])
def test_split_pair_matches_rows_3_and_4_on_the_whole_image(cuda_device, C, dtype, R):
    """At the flagship's 32x32 level (B 64, S 1024, G 32) cut into R row
    pieces (R = 1: the pair on the whole image)."""
    B, S, G = 64, 1024, 32
    x, dy, scale, bias = _inputs(cuda_device, B, S, C, dtype)
    y, dx, dsc, dbi, _, _ = split_gn_pieces(x, dy, scale, bias, G, R, EPS, "silu")
    y3 = tg.fused_group_norm_act(x, scale, bias, G, EPS, "silu")
    dx4, dsc4, dbi4 = tg.group_norm_bwd(x, scale, bias, dy, G, EPS, "silu")
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    assert compare(y, y3, dname)[1]
    assert compare_to_scale(dx, dx4, *BWD_TOL[dname])[1]
    for a, b in ((dsc, dsc4), (dbi, dbi4)):
        assert compare_to_scale(a, b, *PARAM_GRAD_TOL)[1]


@pytest.mark.cuda
def test_split_autograd_on_card_matches_cpu(cuda_device):
    """split_group_norm_act with no group (one piece) under autograd on
    the card against the CPU's plain versions."""
    x, dy, scale, bias = _inputs(cuda_device, 4, 256, 64, torch.float32)
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        xs = x.detach().to(dev).requires_grad_(True)
        sc = scale.detach().to(dev).requires_grad_(True)
        bi = bias.detach().to(dev).requires_grad_(True)
        y = tg.split_group_norm_act(xs, sc, bi, 16, EPS, "silu")
        y.backward(dy.to(dev))
        outs[dev.type] = [t.detach().cpu() for t in (y, xs.grad, sc.grad, bi.grad)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert compare_to_scale(a, b, *PARAM_GRAD_TOL)[1]

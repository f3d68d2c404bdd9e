"""Port parity: GroupNorm(+SiLU) (pdm_tpu_torch.ops.groupnorm).

On CPU tensors the port's wrapper runs its plain PyTorch version; it is
held against the JAX package's Pallas kernel in interpret mode and against
its ``group_norm_reference`` at fp32, tolerance 1e-5 (sum-order
differences of fp32 group statistics). The flagship's concat widths
C = 384 and 512 (12 and 16 channels per group) are covered. The CUDA
kernel is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.ops.groupnorm import (
    fused_group_norm_act as j_fgn, group_norm_reference as j_ref,
)

from pdm_tpu_torch.ops import groupnorm as tg
from torch_port_fixtures import two_torch_threads  # noqa: F401

TOL = 1e-5
EPS = 1e-6


def _inputs(B, S, C, seed):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((B, S, C)) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(C) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("B,S,C,groups,act", [
    (2, 64, 128, 32, "silu"),
    (2, 64, 128, 32, "none"),
    (1, 16, 384, 32, "silu"),   # up-path concat, 12 channels per group
    (1, 16, 512, 32, "silu"),   # up-path concat, 16 channels per group
    (3, 32, 256, 8, "none"),
])
def test_group_norm_matches_jax(B, S, C, groups, act):
    x, scale, bias = _inputs(B, S, C, seed=C + S)
    jx, js, jb = jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)
    want_kernel = j_fgn(jx, js, jb, groups, EPS, act, True)
    want_ref = j_ref(jx, js, jb, groups, EPS, act)
    before = tg.fused_group_norm_act.launches
    got = tg.fused_group_norm_act(torch.from_numpy(x), torch.from_numpy(scale),
                                  torch.from_numpy(bias), groups, EPS, act)
    assert got.dtype == torch.float32 and got.shape == (B, S, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref),
                               rtol=TOL, atol=TOL)
    assert tg.fused_group_norm_act.launches == before


def test_group_norm_bf16_output_dtype_and_rounding():
    """bf16 input: fp32 statistics, one rounding of the result to bf16 (the
    JAX UNet casts the fp32 reference output to its compute dtype)."""
    x, scale, bias = _inputs(2, 64, 384, seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = j_ref(xb, jnp.asarray(scale), jnp.asarray(bias), 32, EPS, "silu")
    got = tg.fused_group_norm_act(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(scale),
                                  torch.from_numpy(bias), 32, EPS, "silu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.bfloat16)
                                        .astype(jnp.float32)),
        rtol=2 ** -7, atol=1e-6)


def test_group_norm_variance_is_the_reference_formula():
    """var = max(E[x^2] - E[x]^2, 0): a constant group has variance 0
    exactly, so the output is the bias (not NaN, not F.group_norm's
    two-pass value)."""
    x = torch.full((1, 8, 4), 3.0)
    y = tg.fused_group_norm_act(x, torch.ones(4), torch.arange(4.0), 2, EPS)
    torch.testing.assert_close(y, torch.arange(4.0).expand(1, 8, 4))


def test_group_norm_kernel_checks_are_enforced():
    x = torch.zeros(2, 16, 64)
    ones, zeros = torch.ones(64), torch.zeros(64)
    tg._check(x, ones, zeros, 32)
    with pytest.raises(ValueError, match="groups"):
        tg._check(x, ones, zeros, 5)
    with pytest.raises(ValueError, match="scale"):
        tg._check(x, ones.double(), zeros, 32)
    with pytest.raises(ValueError, match="contiguous"):
        tg._check(x.transpose(1, 2).contiguous().transpose(1, 2), ones, zeros, 32)
    with pytest.raises(ValueError, match="act"):
        tg.fused_group_norm_act(x, ones, zeros, 32, EPS, "gelu")


# backward vs the JAX kernel's VJP: dscale/dbias are fp32 sums (1e-5 of
# their scale); dx in fp32 by summation order (1e-5), in bf16 by one
# rounding step of the output (2^-7 of the value, 2^-9 of the scale)
BWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 2 ** -9)}


def _assert_close_to_scale(got, want, rtol, atol_of_scale):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_scale * np.abs(want).max())



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("B,S,C", [(2, 64, 128), (1, 16, 384)])
def test_group_norm_backward_matches_jax_vjp(dtype, act, B, S, C):
    """Gradients of x, scale and bias through the port's autograd Function
    (plain backward on the CPU) against jax.vjp of the JAX kernel
    (interpret mode). The cotangent keeps x's dtype, as autograd gives it."""
    x, scale, bias = _inputs(B, S, C, seed=S + C)
    g = np.random.RandomState(2).standard_normal((B, S, C)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda x, s, b: j_fgn(x, s, b, 32, EPS, act, True),
                     jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    want_dx, want_ds, want_db = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ts, tb = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    before = tg.group_norm_bwd.launches
    tg.fused_group_norm_act(tx, ts, tb, 32, EPS, act).backward(
        torch.from_numpy(g).to(tdt))
    assert tg.group_norm_bwd.launches == before  # CPU: plain version
    assert tx.grad.dtype == tdt and ts.grad.dtype == tb.grad.dtype == torch.float32
    _assert_close_to_scale(tx.grad.float().numpy(),
                    np.asarray(want_dx.astype(jnp.float32)), *BWD_TOL[dtype])
    _assert_close_to_scale(ts.grad.numpy(), np.asarray(want_ds), 1e-5, 1e-5)
    _assert_close_to_scale(tb.grad.numpy(), np.asarray(want_db), 1e-5, 1e-5)


# The launch plan (tg.plan_group_norm, a pure function; the kernels take it
# as given): the flagship's (S, C) at the sampler's and the trainer's batch,
# and edge shapes (B, S, C, groups, itemsize): one group of 512 channels,
# which the backward streams at S 1024; 3 channels a group; fp32 at the
# largest tile; ragged S and C.
FLAGSHIP_SC = [(1024, 128), (1024, 256), (1024, 384), (256, 512), (256, 384),
               (256, 256), (256, 128), (64, 512), (64, 256), (16, 512),
               (16, 256)]
PLAN_CASES = (
    [(64, S, C, 32, 2, False) for S, C in FLAGSHIP_SC]
    + [(128, S, C, 32, 2, bwd) for S, C in FLAGSHIP_SC for bwd in (False, True)]
    + [(B, S, C, G, isz, bwd) for B, S, C, G, isz in (
        (128, 64, 512, 1, 2), (8, 64, 512, 1, 4), (128, 1024, 512, 1, 2),
        (64, 64, 96, 32, 2), (2, 1024, 384, 32, 4), (8, 64, 96, 32, 4),
        (3, 17, 100, 10, 2), (3, 17, 100, 10, 4)) for bwd in (False, True)])


def _coverage(plan, S, C):
    """How often the plan's blocks and threads visit each (row, channel)."""
    count = np.zeros((S, C), np.int32)
    vpr = plan.cb // plan.vec
    for i in range(plan.kr):
        r0 = i * plan.rows
        r1 = min(S, r0 + plan.rows)
        for j in range(plan.kc):
            for t in range(plan.lanes_v * plan.lanes_p):
                lane = t // plan.lanes_v
                for cv in range(t % plan.lanes_v, vpr, plan.lanes_v):
                    c = j * plan.cb + cv * plan.vec
                    count[r0 + lane:r1:plan.lanes_p, c:c + plan.vec] += 1
    return count


@pytest.mark.parametrize("B,S,C,groups,itemsize,backward", PLAN_CASES)
def test_plan_covers_every_row_and_channel_once(B, S, C, groups, itemsize,
                                                backward):
    plan = tg.plan_group_norm(B, S, C, groups, itemsize, backward)
    assert plan == tg.plan_group_norm(B, S, C, groups, itemsize, backward)
    assert 1 <= plan.kr <= tg.MAX_CLUSTER_BLOCKS and plan.rows * plan.kr >= S
    assert groups % plan.kc == 0 and plan.cb == C // plan.kc  # whole groups
    assert plan.cb % plan.vec == 0 and plan.vec <= 4
    assert plan.lanes_v * plan.lanes_p <= plan.threads <= tg.TARGET_THREADS
    assert plan.threads % 32 == 0 and plan.smem <= tg.MAX_SMEM_BYTES
    assert (_coverage(plan, S, C) == 1).all()


@pytest.mark.parametrize("B,S,C,groups,itemsize,backward", PLAN_CASES)
def test_plan_picks_the_documented_variant(B, S, C, groups, itemsize,
                                           backward):
    """The tile stays on chip wherever it fits; a block's share is at most
    the tile budget unless the splits run out; row segments of at least
    MIN_SEGMENT_BYTES (or whole rows); the streaming variant reads whole
    rows; vectors of 4 elements wherever the widths allow."""
    plan = tg.plan_group_norm(B, S, C, groups, itemsize, backward)
    share = plan.rows * plan.cb * (itemsize + 4 if backward else itemsize)
    if plan.hold:
        assert plan.smem >= share
        assert plan.kc == 1 or plan.cb * itemsize >= tg.MIN_SEGMENT_BYTES
        assert (share <= tg.TILE_BYTES[backward] or plan.kr == tg.MAX_CLUSTER_BLOCKS
                or -(-S // (2 * plan.kr)) < tg.MIN_ROWS)
    else:
        assert plan.kc == 1 and plan.smem < share  # whole rows, re-read
    if (C // plan.kc) % 4 == 0:
        assert plan.vec == 4
    flagship = groups == 32 and (S, C) in FLAGSHIP_SC and itemsize == 2
    if flagship:
        assert plan.hold == 1
    if (B, S, C, groups, backward) == (128, 1024, 512, 1, True):
        assert plan.hold == 0  # 2 MB an image: 256 KB a block at 8 blocks


def test_plan_respects_alignment_and_refuses_bad_groups():
    assert tg.plan_group_norm(64, 1024, 384, 32, 2, False, align=8).vec == 4
    assert tg.plan_group_norm(64, 1024, 384, 32, 4, True, align=4).vec == 1
    with pytest.raises(ValueError, match="groups"):
        tg.plan_group_norm(2, 16, 100, 3, 2, False)
    assert tg._alignment(torch.zeros(8)[1:]) == 4


@pytest.mark.parametrize("act", ["silu", "none"])
def test_plain_versions_at_one_group_of_512_match_jax(act):
    """groups 1, C 512 (cpg 512, which the backward kernel used to refuse):
    the port's plain forward against JAX's group_norm_reference, and its
    autograd through the plain backward against jax.vjp of it."""
    B, S, C = 2, 64, 512
    x, scale, bias = _inputs(B, S, C, seed=512)
    g = np.random.RandomState(9).standard_normal((B, S, C)).astype(np.float32)
    jx, js, jb = jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)
    want, vjp = jax.vjp(lambda x, s, b: j_ref(x, s, b, 1, EPS, act), jx, js, jb)
    want_dx, want_ds, want_db = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    ts, tb = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    got = tg.fused_group_norm_act(tx, ts, tb, 1, EPS, act)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    got.backward(torch.from_numpy(g))
    _assert_close_to_scale(tx.grad.numpy(), np.asarray(want_dx),
                           *BWD_TOL["float32"])
    _assert_close_to_scale(ts.grad.numpy(), np.asarray(want_ds), 1e-5, 1e-5)
    _assert_close_to_scale(tb.grad.numpy(), np.asarray(want_db), 1e-5, 1e-5)

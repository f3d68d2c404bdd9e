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

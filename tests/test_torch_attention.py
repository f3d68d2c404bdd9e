"""Port parity: spatial attention (pdm_tpu_torch.ops.attention).

On CPU tensors the port's wrapper runs its plain PyTorch version; it is
held against the JAX package's Pallas kernel in interpret mode (output and
the per-row logsumexp) at fp32, tolerance 2e-5 — the kernels' own
interpret-mode tolerance in tests/test_attention.py. The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.ops.attention import _fsa_call, fused_spatial_attention as j_fsa

from pdm_tpu_torch.ops import attention as ta

TOL = 2e-5


def _qkv(B, T, C, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, T, C)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("B,T,heads,hd", [
    (2, 256, 4, 64),   # flagship 16x16 blocks
    (2, 16, 4, 64),    # flagship 4x4 mid block
    (3, 64, 1, 32),
])
def test_attention_matches_jax_kernel(B, T, heads, hd):
    C = heads * hd
    q, k, v = _qkv(B, T, C, seed=T + heads)
    scale = 1.0 / np.sqrt(hd)
    want = j_fsa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                 scale, True)
    _, want_lse = _fsa_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            heads, scale, True)
    before = ta.fused_spatial_attention.launches
    got, got_lse = ta.attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads,
        scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=TOL, atol=TOL)
    assert got.shape == (B, T, C) and got_lse.shape == (B, heads, T)
    # CPU tensors run the plain version: no kernel launch is counted
    assert ta.fused_spatial_attention.launches == before


def test_attention_strided_qkv_views_match_contiguous():
    """q, k, v as column thirds of one (B, T, 3C) projection (the UNet's
    layout) give the same result as contiguous copies."""
    B, T, heads, hd = 2, 64, 2, 32
    C = heads * hd
    qkv = torch.from_numpy(
        np.random.RandomState(1).standard_normal((B, T, 3 * C)).astype(np.float32))
    q, k, v = qkv.split(C, dim=-1)
    got = ta.fused_spatial_attention(q, k, v, heads, 0.2)
    want = j_fsa(*(jnp.asarray(t.contiguous().numpy()) for t in (q, k, v)),
                 heads, 0.2, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_attention_bf16_rounds_probabilities_like_reference():
    """bf16: the plain version casts P to bf16 before PV, as the JAX
    kernel does; agreement within bf16 output rounding (2^-7 relative)."""
    B, T, heads, hd = 2, 16, 4, 64
    q, k, v = _qkv(B, T, heads * hd, seed=5)
    want = j_fsa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), heads,
                 0.125, True)
    got = ta.fused_spatial_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), heads, 0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -8)


def test_attention_kernel_checks_are_enforced():
    q = torch.zeros(2, 16, 64)
    wide = torch.zeros(2, 16, 128)
    with pytest.raises(ValueError, match="head dim"):
        ta._check(wide, wide, wide, heads=1)  # hd 128 has no instantiation
    ta._check(q, q, q, heads=2)  # hd 32 is supported
    with pytest.raises(ValueError, match="shape"):
        ta._check(q, q, torch.zeros(2, 8, 64), heads=2)
    with pytest.raises(TypeError):
        ta._check(q.double(), q.double(), q.double(), heads=2)
    with pytest.raises(ValueError, match="head dim"):
        ta._check(q, q, q, heads=8)  # hd 8: the tensor-core kernel needs 16
    with pytest.raises(ValueError, match="stride"):
        ta._check(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1), 2)
    # bf16 is read in 16-byte vectors: storage off by one element raises
    odd = torch.zeros(2 * 16 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 64)
    with pytest.raises(ValueError, match="aligned"):
        ta._check(odd, odd, odd, heads=2)
    ta._check(q.bfloat16(), q.bfloat16(), q.bfloat16(), heads=2)

"""Port parity: spatial attention (pdm_tpu_torch.ops.attention).

On CPU tensors the port's wrapper runs its plain PyTorch version; it is
held against the JAX package's Pallas kernel in interpret mode (output and
the per-row logsumexp) at fp32, tolerance 2e-5 — the kernels' own
interpret-mode tolerance in tests/test_attention.py. The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_cuda.py. The gate (use_fused_attention) is held against
the JAX gate's geometry over a grid of shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.ops import attention as j_attention
from pdm_tpu.ops.attention import _fsa_call, fused_spatial_attention as j_fsa

from pdm_tpu_torch.ops import attention as ta
from torch_port_fixtures import two_torch_threads  # noqa: F401

TOL = 2e-5


def _qkv(B, T, C, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, T, C)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("B,T,heads,hd", [
    (2, 256, 4, 64),   # flagship 16x16 blocks
    (2, 16, 4, 64),    # flagship 4x4 mid block
    (3, 64, 1, 32),
    (2, 256, 1, 256),  # single-head 32x32 DDPM, 16x16 blocks
    (2, 256, 1, 512),  # 256x256 family, 16x16 blocks
    (2, 64, 1, 512),   # 256x256 family, 8x8 mid block
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
    ta._check(wide, wide, wide, heads=1)  # hd 128: the widest instantiation
    ta._check(q, q, q, heads=2)  # hd 32 is supported
    ta._check(q, q, q, heads=8)  # hd 8: zero-padded to 16 in the kernels
    with pytest.raises(ValueError, match="head dim"):
        ta._check(q, q, q, heads=16)  # hd 4 is not a multiple of 8
    for hd in (136, 512, 520, 1024):  # the wide kernels: no upper bound
        w = torch.zeros(2, 16, hd)
        ta._check(w, w, w, heads=1)
    with pytest.raises(ValueError, match="head dim"):
        ta._check(torch.zeros(2, 16, 516), torch.zeros(2, 16, 516),
                  torch.zeros(2, 16, 516), heads=1)  # hd 516: not a multiple of 8
    with pytest.raises(ValueError, match="shape"):
        ta._check(q, q, torch.zeros(2, 8, 64), heads=2)
    with pytest.raises(TypeError):
        ta._check(q.double(), q.double(), q.double(), heads=2)
    with pytest.raises(ValueError, match="stride"):
        ta._check(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1), 2)
    # bf16 is read in 16-byte vectors: storage off by one element raises
    odd = torch.zeros(2 * 16 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 64)
    with pytest.raises(ValueError, match="aligned"):
        ta._check(odd, odd, odd, heads=2)
    ta._check(q.bfloat16(), q.bfloat16(), q.bfloat16(), heads=2)



@pytest.mark.parametrize("hd", [8, 24, 64, 128, 256, 512, 520, 576])
@pytest.mark.parametrize("T", [8, 16, 256, 1024, 1032])
def test_gate_agrees_with_jax_geometry(monkeypatch, T, hd):
    """use_fused_attention is exactly the JAX gate's geometry on a TPU
    backend (T <= 1024, heads T^2 <= 2^21, head dim and T multiples of 8),
    with no head-dim bound of its own: 520 and 576 are past the widest
    head of any UNet config in the repository (512). The head counts put
    heads T^2 on both sides of 2^21 at T 256 (32 heads: exactly 2^21; 33:
    above) and T 1024 (2: exactly; 4: above)."""
    monkeypatch.delenv("PDM_FUSED_ATTN", raising=False)
    monkeypatch.setattr(j_attention.jax, "default_backend", lambda: "tpu")
    for heads in (1, 2, 4, 32, 33):
        C = heads * hd
        want = j_attention.use_fused_attention(T, C, heads)
        assert ta.use_fused_attention(T, C, heads) == want, (T, hd, heads)
    # a channel count that heads do not divide is outside both
    assert not ta.use_fused_attention(T, 3 * hd + 1, 3)
    assert not j_attention.use_fused_attention(T, 3 * hd + 1, 3)


# backward vs the JAX kernel's VJP: fp32 by summation order (1e-5); bf16
# by one rounding step of an output or of a rounded P / ds (2^-7 of the
# value, plus 2^-9 of the tensor's scale for the products of those)
BWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 2 ** -9)}


def _assert_close_to_scale(got, want, rtol, atol_of_scale):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_scale * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,heads,hd", [
    (2, 16, 4, 64),   # 4 heads of 64: two of the JAX kernel's head groups
    (2, 64, 2, 32),   # 2 heads of 32: one head group
    (2, 256, 1, 512),  # the 256x256 family's 16x16 blocks
    (2, 64, 1, 256),   # one head of 256 (the wide kernels' range)
])
def test_attention_backward_matches_jax_vjp(dtype, B, T, heads, hd):
    """Gradients through the port's autograd Function (plain backward on
    the CPU) against jax.vjp of the JAX kernel (interpret mode)."""
    C = heads * hd
    q, k, v = _qkv(B, T, C, seed=T + hd)
    g = np.random.RandomState(9).standard_normal((B, T, C)).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda q, k, v: j_fsa(q, k, v, heads, scale, True),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    before = ta.attention_bwd.launches
    out = ta.fused_spatial_attention(tq, tk, tv, heads, scale)
    out.backward(torch.from_numpy(g).to(tdt))
    assert ta.attention_bwd.launches == before  # CPU: plain version
    rtol, atol = BWD_TOL[dtype]
    for w, t in zip(want, (tq, tk, tv)):
        assert t.grad.dtype == tdt and t.grad.shape == (B, T, C)
        _assert_close_to_scale(t.grad.float().numpy(),
                        np.asarray(w.astype(jnp.float32)), rtol, atol)


def test_entries_split_at_head_dim_128():
    """The launcher's C entry, forward and backward: attention.cu's and
    attention_bwd.cu's up to head dim 128, attention_wide.cu's above it,
    at any width."""
    assert ta.NARROW_MAX_HEAD_DIM == 128
    for hd in (8, 64, 128):
        for what in ("fwd", "bwd_dq", "bwd_dkdv"):
            assert ta._entry(what, hd) == f"pdm_attention_{what}"
    for hd in (136, 512, 576, 2048):
        for what in ("fwd", "bwd_dq", "bwd_dkdv"):
            assert ta._entry(what, hd) == f"pdm_attention_wide_{what}"


def test_attention_backward_of_strided_qkv_views():
    """q, k, v as column thirds of one (B, T, 3C) tensor: the gradient of
    that tensor is the three gradients side by side (the JAX kernel's VJP
    on contiguous copies)."""
    B, T, heads, hd = 2, 16, 2, 16
    C = heads * hd
    qkv = np.random.RandomState(3).standard_normal((B, T, 3 * C)).astype(np.float32)
    g = np.random.RandomState(4).standard_normal((B, T, C)).astype(np.float32)
    t = torch.from_numpy(qkv).requires_grad_()
    ta.fused_spatial_attention(*t.split(C, dim=-1), heads, 0.3).backward(
        torch.from_numpy(g))
    _, vjp = jax.vjp(lambda q, k, v: j_fsa(q, k, v, heads, 0.3, True),
                     *(jnp.asarray(a) for a in np.split(qkv, 3, axis=-1)))
    want = np.concatenate([np.asarray(w) for w in vjp(jnp.asarray(g))], axis=-1)
    _assert_close_to_scale(t.grad.numpy(), want, *BWD_TOL["float32"])


def test_wide_backward_plan_fits_every_geometry_the_gate_admits():
    """Row 2's backward plan above head dim 128 (ops/attention.py::
    plan_wide_bwd, which csrc/attention_wide.cu's Plan refuses unless it
    is the shape's) over head dims 136 to 576 and T up to 1024 inside the
    JAX gate: bf16 at T <= 256 takes the one-pass wgmma design, the rest
    the two-pass kernels; a block's shared memory (the plan's dynamic
    bytes, the staging rows and barriers) within the H100's opt-in; TMA
    boxes of at most 256 rows; grids within CUDA's limits and covering
    every (image, head, strip) and, for dk/dv, every 128-column tile of
    both gradients; the scratch holds P and ds of every (image, head)."""
    limit_x, limit_yz = 2 ** 31 - 1, 65535
    for hd in range(136, 577, 8):
        for T in range(8, 1025, 8):
            for heads in (1, 2, 8):
                if heads * T * T > ta.MAX_FUSED_SCORE_CELLS:
                    continue
                for B in (1, 128):
                    for bf16 in (True, False):
                        p = ta.plan_wide_bwd(B, T, heads, hd, bf16, 132)
                        nc = -(-T // 64)
                        assert p.nc == nc
                        assert p.one_pass == int(bf16 and T <= ta.ONE_PASS_MAX_TOKENS)
                        if not p.one_pass:
                            n_oc = -(-hd // (128 if bf16 else 64))
                            assert (p.dq_x, p.dq_y, p.dq_z) == (nc, heads * n_oc, B)
                            assert (p.kv_x, p.kv_y, p.kv_z) == (nc, 2 * heads * n_oc, B)
                            assert p.dq_y <= limit_yz and p.kv_y <= limit_yz
                            assert p.scratch == 0
                            continue
                        assert 64 * nc <= 256  # the k and v boxes' rows
                        assert p.wg in (1, 2) and (p.wg == 1 or nc >= 2)
                        static = 4 * p.wg * ta.WIDE_STAGING_BYTES + ta.WIDE_BARRIER_BYTES
                        assert p.dq_smem + static <= ta.MAX_SMEM_BYTES
                        assert p.kv_smem + 4 * ta.WIDE_STAGING_BYTES + \
                            ta.WIDE_BARRIER_BYTES <= ta.MAX_SMEM_BYTES
                        assert p.dq_x * p.wg >= B * heads * nc > (p.dq_x - B * heads) * p.wg
                        assert p.kv_x == B * heads * nc * -(-hd // ta.WIDE_KV_COLS) * 2
                        assert p.dq_x <= limit_x and p.kv_x <= limit_x
                        assert (p.dq_y, p.dq_z, p.kv_y, p.kv_z) == (1, 1, 1, 1)
                        assert p.scratch == 2 * B * heads * (64 * nc) ** 2


def test_wide_backward_plan_takes_two_strips_a_block_only_where_the_card_fills():
    """Two query strips a dq block share k and v, but halve the grid: the
    plan takes them only where the grid still covers the card's SMs. The
    family's micro-batch (B 8, T 256, one head of 512) runs 32 one-strip
    blocks, the single-head 32x32's train step (B 128, T 256, one head of
    256) 256 two-strip blocks; T <= 64 is one strip an image."""
    fam = ta.plan_wide_bwd(8, 256, 1, 512, True, 132)
    assert (fam.wg, fam.dq_x, fam.kv_x) == (1, 32, 8 * 4 * 4 * 2)
    single = ta.plan_wide_bwd(128, 256, 1, 256, True, 132)
    assert (single.wg, single.dq_x, single.kv_x) == (2, 256, 128 * 4 * 2 * 2)
    assert ta.plan_wide_bwd(8, 64, 1, 512, True, 132).wg == 1
    assert ta.plan_wide_bwd(66, 256, 1, 512, True, 132).wg == 2
    assert ta.plan_wide_bwd(65, 256, 1, 512, True, 132).wg == 1
    assert ta.plan_wide_bwd(8, 256, 1, 512, True, 132) == fam  # a pure function

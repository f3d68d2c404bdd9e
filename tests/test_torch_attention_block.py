"""Port parity: the whole attention block (pdm_tpu_torch.ops.attention_block).

On CPU tensors the port's wrappers run their plain PyTorch versions; they
are held against the JAX package's Pallas kernel in interpret mode
(``fused_attention_block(..., interpret=True)``) on the same numpy inputs:

* fp32 forward (and the per-head logsumexp the forward saves) at the JAX
  tests' shapes (tests/test_attention.py) and the flagship's 4x4 mid
  block, to the JAX tests' own tolerance 2e-4;
* all six gradients (x, h, the qkv weight and bias, the out weight and
  bias) through the port's autograd Function against ``jax.grad`` of the
  kernel's custom VJP, fp32, to 3e-4 (tests/test_attention.py);
* one bf16 case with bf16-representable biases: the two sides round at
  the same points and differ only in fp32 summation order, which can
  flip a rounding: the output within one bf16 step of the value (2^-7)
  plus 2^-8 of its scale, each gradient within 2^-6 of the value plus
  2^-6 of its scale (a flipped rounding of P, ds or dqkv moves a product
  by one step of the operand).

The wide geometries of the staged launch plan (one head of 512 at T 256
and 64, one head of 256 at T 16, 16 heads of 8, T 1024) are held to JAX
the same way, forward, lse and gradients. Row 2's plain backward fed the
block's own q, k, v, datt and lse gives the block's plain dqkv bitwise:
the premise of running row 2's kernels inside the staged backward.

The tiny UNet with ``PDM_FUSED_BLOCK=1`` on the port's CPU path against
the JAX UNet's standard XLA path (JAX's gate stays closed off the TPU)
agrees in fp32 to 1e-5 of the output scale, and a single-head tiny UNet
also in its train step's gradients. The gate is JAX's geometry exactly,
the route (``block_route``, pure) gives every admitted geometry a plan,
and the cluster kernels' launch plan (``plan_block``, pure) is checked
over every geometry the cluster route takes: shared memory under the
H100's opt-in, strips and packing, every token of every image in exactly
one group's tiles. The three-step trainer run
with the opt-in is in tests/test_torch_trainer.py (it shares that file's
compiled JAX train step). The CUDA kernels are held against the plain
versions on the card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.models.unet import unet_from_config as j_unet_from_config
from pdm_tpu.ops.attention_block import (
    _fab_fwd, fused_attention_block as j_block,
)

from pdm_tpu_torch.models.unet import unet_from_config
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.ops import attention_block as tb
from torch_port_fixtures import two_torch_threads  # noqa: F401

FWD_TOL = 2e-4
GRAD_TOL = 3e-4


def _inputs(B, T, heads, hd, seed=0):
    """x, h, w_qkv (C, 3C), b_qkv, w_out (C, C), b_out, g in the JAX
    layout, as tests/test_attention.py scales them."""
    C = heads * hd
    rng = np.random.RandomState(seed)

    def r(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return (r(B, T, C), r(B, T, C), r(C, 3 * C, s=0.1), r(3 * C, s=0.1),
            r(C, C, s=0.1), r(C, s=0.1), r(B, T, C))


def _port_args(x, h, w_qkv, b_qkv, w_out, b_out, dtype=torch.float32,
               bias_dtype=torch.float32):
    """The same values in the port's layout: nn.Linear weights (C_out,
    C_in), three separate projection weights and biases."""
    C = h.shape[-1]

    def t(a, dt=dtype):
        return torch.from_numpy(np.array(a)).to(dt)

    ws = [t(w_qkv[:, i * C:(i + 1) * C].T) for i in range(3)]
    bs = [t(b_qkv[i * C:(i + 1) * C], bias_dtype) for i in range(3)]
    return t(x), t(h), ws, bs, t(w_out.T), t(b_out, bias_dtype)


@pytest.mark.parametrize("B,T,heads,hd", [
    (2, 256, 4, 64),   # flagship 16x16 blocks
    (2, 128, 2, 64),
    (2, 64, 1, 32),
    (2, 16, 4, 64),    # flagship 4x4 mid block
    (2, 256, 1, 512),  # the 256x256 family's blocks (staged plan)
    (2, 64, 1, 512),   # its 8x8 block
    (2, 16, 1, 256),   # the single-head 32x32 DDPM's mid block
    (2, 64, 16, 8),    # 16 heads of 8
    (1, 1024, 1, 32),  # the gate's longest rows
])
def test_block_forward_matches_jax_kernel(B, T, heads, hd):
    x, h, w_qkv, b_qkv, w_out, b_out, _ = _inputs(B, T, heads, hd, seed=T + hd)
    scale = 1.0 / np.sqrt(hd)
    want, res = _fab_fwd(*(jnp.asarray(a) for a in (x, h, w_qkv, b_qkv, w_out,
                                                     b_out)),
                         heads, scale, True)
    tx, th, ws, bs, two, tbo = _port_args(x, h, w_qkv, b_qkv, w_out, b_out)
    before = tb.fused_attention_block.launches
    got, lse = tb._forward(tx, th, ws, bs, two, tbo, heads, scale)
    assert tb.fused_attention_block.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[-1]), rtol=FWD_TOL,
                               atol=FWD_TOL)
    one = tb.fused_attention_block(tx, th, *ws, bs, two, tbo, heads, scale)
    assert torch.equal(one, got) and one.shape == (B, T, heads * hd)


def _grads(dtype, bias_dtype, B, T, heads, hd, seed):
    """(JAX's six gradients, the port's six in JAX's layout) as fp32 numpy."""
    x, h, w_qkv, b_qkv, w_out, b_out, g = _inputs(B, T, heads, hd, seed)
    if dtype == torch.bfloat16:  # bf16-representable biases on both sides
        b_qkv, b_out = (np.asarray(jnp.asarray(b, jnp.bfloat16)
                                   .astype(jnp.float32)) for b in (b_qkv, b_out))
    scale = 1.0 / np.sqrt(hd)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jh, jw, jwo, jg = (jnp.asarray(a, jdt) for a in (x, h, w_qkv, w_out, g))

    def loss(x_, h_, w_, bq_, wo_, bo_):
        out = j_block(x_, h_, w_, bq_, wo_, bo_, heads, scale, True)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(loss, argnums=tuple(range(6)))(
        jx, jh, jw, jnp.asarray(b_qkv), jwo, jnp.asarray(b_out))
    want = [np.asarray(w.astype(jnp.float32)) for w in want]

    tx, th, ws, bs, two, tbo = _port_args(x, h, w_qkv, b_qkv, w_out, b_out,
                                          dtype, bias_dtype)
    leaves = [tx, th, *ws, *bs, two, tbo]
    for t_ in leaves:
        t_.requires_grad_()
    before = tb.attention_block_bwd.launches
    out = tb.fused_attention_block(tx, th, *ws, bs, two, tbo, heads, scale)
    assert out.dtype == dtype
    out.backward(torch.from_numpy(g).to(dtype))
    assert tb.attention_block_bwd.launches == before  # CPU: plain version
    for t_ in leaves:
        assert t_.grad.dtype == t_.dtype and t_.grad.shape == t_.shape
    f = [t_.grad.float().numpy() for t_ in leaves]
    got = [f[0], f[1], np.concatenate([f[2].T, f[3].T, f[4].T], axis=1),
           np.concatenate(f[5:8]), f[8].T, f[9]]
    return want, got


def test_block_gradients_match_jax_vjp():
    want, got = _grads(torch.float32, torch.float32, 2, 128, 4, 64, seed=7)
    for name, w, g_ in zip(["dx", "dh", "dw_qkv", "db_qkv", "dw_out",
                            "db_out"], want, got):
        np.testing.assert_allclose(g_, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("dtype,B,T,heads,hd", [
    (torch.float32, 2, 256, 1, 512),
    (torch.bfloat16, 2, 256, 1, 512),
    (torch.float32, 2, 64, 16, 8),
    (torch.bfloat16, 2, 64, 16, 8),
    (torch.float32, 1, 1024, 1, 32),
])
def test_block_gradients_match_jax_vjp_at_wide_geometries(dtype, B, T, heads,
                                                          hd):
    """The staged plan's geometries: all six gradients against jax.grad of
    the kernel's custom VJP. fp32 to GRAD_TOL of the value plus GRAD_TOL
    of the gradient's scale (at C 512 and T 1024 the sums run over 4 to 8
    times the terms of the flagship's shape, and gradients reach ~100, so
    an absolute GRAD_TOL is below fp32's summation-order noise); bf16
    (bf16-representable biases) each gradient within 2^-6 of the value
    plus 2^-6 of its scale, as test_block_bf16_matches_jax_kernel."""
    want, got = _grads(dtype, dtype, B, T, heads, hd, seed=T + heads)
    for name, w, g_ in zip(["dx", "dh", "dw_qkv", "db_qkv", "dw_out",
                            "db_out"], want, got):
        if dtype == torch.float32:
            np.testing.assert_allclose(g_, w, rtol=GRAD_TOL,
                                       atol=GRAD_TOL * np.abs(w).max(),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g_, w, rtol=2 ** -6,
                                       atol=2 ** -6 * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,hd", [(1, 256), (4, 64)])
def test_row2_backward_gives_the_blocks_dqkv(dtype, heads, hd):
    """The staged backward runs row 2's kernels on the block's q, k, v,
    datt and lse. Their plain version (attention_bwd_reference) must give
    the block's plain dqkv exactly: both round ds, scale dq and dk after
    the product and round each of dq, dk, dv once. The block's dqkv is read
    from its weight gradients at h = the identity (B T = C rows), where
    dW_{q,k,v} = dqkv^T exactly."""
    from pdm_tpu_torch.ops import attention as ta

    C = heads * hd
    B, T = 2, C // 2
    rng = np.random.RandomState(heads)

    def r(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32)).to(dtype)

    h = torch.eye(C, dtype=dtype).reshape(B, T, C)
    ws = [r(C, C, s=0.3) for _ in range(3)]
    bs = [r(C, s=0.1) for _ in range(3)]
    w_out, g = r(C, C, s=0.1), r(B, T, C)
    scale = 1.0 / np.sqrt(hd)
    _, lse = tb._reference_with_lse(h, h, *ws, bs, w_out, bs[0], heads, scale)
    block = tb.attention_block_bwd_reference(h, *ws, bs, w_out, lse, g, heads,
                                             scale)
    q, k, v = (tb._project(h, w, b) for w, b in zip(ws, bs))
    datt = torch.matmul(g.float(), w_out.float()).to(dtype)
    row2 = ta.attention_bwd_reference(q, k, v, lse, datt, heads, scale)
    for name, got, dw in zip("qkv", row2, block[1:4]):
        assert torch.equal(got.reshape(C, C), dw.t()), name


def test_block_bf16_matches_jax_kernel():
    B, T, heads, hd = 2, 64, 4, 16
    x, h, w_qkv, b_qkv, w_out, b_out, _ = _inputs(B, T, heads, hd, seed=3)
    b_qkv, b_out = (np.asarray(jnp.asarray(b, jnp.bfloat16).astype(jnp.float32))
                    for b in (b_qkv, b_out))
    scale = 1.0 / np.sqrt(hd)
    want = j_block(*(jnp.asarray(a, jnp.bfloat16) for a in (x, h, w_qkv)),
                   jnp.asarray(b_qkv), jnp.asarray(w_out, jnp.bfloat16),
                   jnp.asarray(b_out), heads, scale, True)
    want = np.asarray(want.astype(jnp.float32))
    tx, th, ws, bs, two, tbo = _port_args(x, h, w_qkv, b_qkv, w_out, b_out,
                                          torch.bfloat16, torch.bfloat16)
    got = tb.fused_attention_block(tx, th, *ws, bs, two, tbo, heads, scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max())

    want_g, got_g = _grads(torch.bfloat16, torch.bfloat16, B, T, heads, hd,
                           seed=3)
    for name, w, g_ in zip(["dx", "dh", "dw_qkv", "db_qkv", "dw_out",
                            "db_out"], want_g, got_g):
        np.testing.assert_allclose(g_, w, rtol=2 ** -6,
                                   atol=2 ** -6 * np.abs(w).max(),
                                   err_msg=name)


def test_gate_reads_the_variable_per_call(monkeypatch):
    monkeypatch.delenv("PDM_FUSED_BLOCK", raising=False)
    assert not tb.use_fused_attention_block(256, 256, 4)
    monkeypatch.setenv("PDM_FUSED_BLOCK", "1")
    assert tb.use_fused_attention_block(256, 256, 4)
    assert tb.use_fused_attention_block(16, 256, 4)
    # the JAX gate's geometry: T % 8, hd % 8, C <= 512, T <= 1024
    assert not tb.use_fused_attention_block(100, 256, 4)
    assert not tb.use_fused_attention_block(256, 256, 64)
    assert not tb.use_fused_attention_block(256, 1024, 4)
    assert not tb.use_fused_attention_block(2048, 256, 4)
    monkeypatch.setenv("PDM_FUSED_BLOCK", "0")
    assert not tb.use_fused_attention_block(256, 256, 4)


@pytest.mark.parametrize("T", [8, 16, 64, 176, 256, 512, 1024])
def test_block_gate_agrees_with_jax_geometry(monkeypatch, T):
    """use_fused_attention_block is exactly the JAX gate's geometry
    (pdm_tpu/ops/attention_block.py:316-336; its own function needs a TPU
    backend, so the expressions are restated here) over heads {1, ..., 64}
    and head dims {8, ..., 512}; and every geometry it admits has a route
    (the kernels take it)."""
    monkeypatch.setenv("PDM_FUSED_BLOCK", "1")
    for heads in (1, 2, 4, 8, 16, 64):
        for hd in (8, 16, 24, 64, 128, 256, 512):
            C = heads * hd
            want = (T <= 1024 and heads * T * T <= 2 ** 21 and C % heads == 0
                    and (C // heads) % 8 == 0 and T % 8 == 0 and C <= 512)
            assert tb.use_fused_attention_block(T, C, heads) == want, (T, heads, hd)
            if want:
                assert tb.block_route(T, C, heads) in ("cluster", "staged")


def test_kernel_checks_are_enforced():
    """The kernels take every geometry the JAX gate admits; what it
    refuses raises (the card path never falls back to the standard
    attention), as do a wrong weight dtype and a dtype the kernels lack."""
    def call(B, T, heads, hd, dtype=torch.float32, wdtype=None):
        C = heads * hd
        x = torch.zeros(B, T, C, dtype=dtype)
        w = torch.zeros(C, C, dtype=wdtype or dtype)
        b = torch.zeros(C)
        return tb._check(x, (w, w, w, w), (b, b, b, b), heads)

    assert call(2, 256, 4, 64) == "cluster"
    assert call(2, 16, 4, 64, torch.bfloat16) == "cluster"
    assert call(2, 64, 1, 128) == "staged"   # hd 128: no cluster instantiation
    assert call(2, 64, 4, 8) == "staged"     # hd 8
    assert call(1, 512, 4, 64) == "staged"   # 512 tokens
    assert call(1, 64, 16, 16) == "staged"   # 16 heads
    with pytest.raises(ValueError, match="head dim"):
        call(2, 64, 2, 12)   # a head dim that is not a multiple of 8
    with pytest.raises(ValueError, match="tokens"):
        call(1, 2048, 1, 64)
    with pytest.raises(ValueError, match="tokens"):
        call(1, 260, 1, 64)  # past the cluster kernels' 256, not a multiple of 8
    with pytest.raises(ValueError, match="heads"):
        call(1, 256, 64, 8)  # heads T^2 = 2^22
    with pytest.raises(ValueError, match="channels"):
        call(1, 64, 4, 256)  # C 1024
    with pytest.raises(ValueError, match="weights"):
        call(1, 64, 4, 16, torch.bfloat16, torch.float32)
    with pytest.raises(TypeError):
        call(1, 64, 4, 16, torch.float64)


@pytest.mark.parametrize("T,heads,hd,checked", [
    (256, 4, 64, "cluster"),  # the flagship's blocks
    (16, 4, 64, "cluster"),   # and its mid block
    (256, 1, 512, "staged"),  # the 256x256 family's
])
def test_forced_route_takes_only_the_staged_plan_inside_the_gate(T, heads, hd,
                                                                 checked):
    """A call's plan (``_route``): the checked route when none is asked;
    "staged" where asked, at a cluster shape too (chip_smoke.py times the
    two plans there side by side); no other plan, and nothing outside the
    JAX gate's geometry (T 100 is a cluster shape the gate refuses)."""
    h = torch.zeros(1, T, heads * hd)
    assert tb._route(checked, None, h, heads) == checked
    assert tb._route(checked, "staged", h, heads) == "staged"
    with pytest.raises(ValueError, match="route"):
        tb._route(checked, "cluster", h, heads)
    with pytest.raises(ValueError, match="route"):
        tb._route("cluster", "staged", torch.zeros(1, 100, 64), 1)


TINY = {
    "block_out_channels": [16, 32],
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
    "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
    "layers_per_block": 1,
    "attention_head_dim": 16,
    "norm_groups": 4,
}


def test_tiny_unet_with_the_opt_in_matches_jax(monkeypatch):
    """PDM_FUSED_BLOCK=1: the port's attention blocks take the whole-block
    path (its plain version on the CPU) and give the JAX UNet's output
    (standard XLA path, the same weights) in fp32."""
    monkeypatch.setenv("PDM_FUSED_BLOCK", "1")
    jnet = dataclasses.replace(j_unet_from_config(3, TINY), norm_groups=4)
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)))[
            "params"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
        shapes)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    tau = rng.uniform(0.0, 1.0, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x, t: jnet.apply(
        {"params": p}, x, t, deterministic=True))(params, x, tau))
    net = unet_from_config(3, TINY, device="cpu")
    net.load_state_dict(from_flax_params(params), strict=True)
    calls = []
    real = tb.fused_attention_block

    def spy(*args, **kw):
        calls.append(args[1].shape)
        return real(*args, **kw)

    monkeypatch.setattr("pdm_tpu_torch.models.unet.fused_attention_block", spy)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(tau)).permute(0, 2, 3, 1).numpy()
    # every attention block takes the path: the down block's, the mid
    # block's and the up block's two
    assert len(calls) == 4
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("head_dim", [8, None])
def test_unet_sends_shapes_the_kernels_refuse_down_the_standard_path(
        monkeypatch, head_dim):
    """PDM_FUSED_BLOCK=1 and geometries the JAX gate admits (8 heads of 8
    at C 64: the staged plan; one head of 64: the cluster plan): the UNet
    sends every attention block to fused_attention_block (no standard-path
    attention call), and its output agrees with PDM_FUSED_BLOCK=0's (fp32:
    the two paths differ in summation order only, 1e-5 of the scale)."""
    import pdm_tpu_torch.models.unet as unet_mod

    cfg = {**TINY, "attention_head_dim": head_dim, "block_out_channels": [16, 64]}
    net = unet_from_config(3, cfg, device="cpu")
    rng = np.random.RandomState(2)
    net.load_state_dict({k: torch.from_numpy(
        (rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32))
        for k, v in net.state_dict().items()})
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
    tau = torch.tensor([0.25, 0.75])
    heads = 8 if head_dim == 8 else 1
    assert tb.block_route(64, 64, heads) == ("staged" if head_dim == 8 else "cluster")
    calls = {"block": 0, "attention": 0}

    def spy(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(unet_mod, "fused_attention_block",
                        spy("block", unet_mod.fused_attention_block))
    monkeypatch.setattr(unet_mod, "fused_spatial_attention",
                        spy("attention", unet_mod.fused_spatial_attention))
    monkeypatch.setenv("PDM_FUSED_BLOCK", "0")
    with torch.no_grad():
        standard = net(x, tau)
    monkeypatch.setenv("PDM_FUSED_BLOCK", "1")
    with torch.no_grad():
        got = net(x, tau)
    assert calls == {"block": 4, "attention": 4}  # the 4 of PDM_FUSED_BLOCK=0
    scale = float(standard.abs().max())
    assert float((got - standard).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# the bf16 kernels' launch plan (ops/attention_block.py::plan_block, checked
# by BlockPlan in csrc/attention_block_common.cuh)

@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("hd", tb.CLUSTER_HEAD_DIMS)
def test_plan_fits_every_geometry_the_kernels_take(hd, backward):
    """The route over the whole of JAX's geometry at this head dim (T up
    to 1024, heads up to 64): every admitted geometry has a route; the
    cluster route takes every (T <= 256, heads <= 8) it took before the
    staged plan, and there its plan fits: shared memory under the H100's
    227 KB opt-in, a three-stage ring, an even number of strips covering
    the keys, packing only at T <= 64 with Tr >= T and P Tr = 64, one
    cluster of `heads` blocks (at most 8)."""
    for heads in range(1, 65):
        for T in range(8, 1025, 8):
            admitted = heads * T * T <= 2 ** 21 and heads * hd <= 512
            route = tb.block_route(T, heads * hd, heads)
            assert (route is not None) == (admitted or (T <= 256 and heads <= 8))
            if route == "staged":
                assert T > 256 or heads > 8
    for heads in range(1, tb.CLUSTER_MAX_HEADS + 1):
        for T in range(1, tb.CLUSTER_MAX_TOKENS + 1):
            assert tb.block_route(T, heads * hd, heads) == "cluster"
            for B in (1, 3, 64, 128):
                p = tb.plan_block(B, T, hd, backward)
                assert p.smem + 1024 <= tb.MAX_SMEM_BYTES  # static memory beside it
                assert p.stages == tb.KERNEL_STAGES == 3
                assert p.strips % 2 == 0 and p.strips * 64 >= T
                assert p.groups * p.imgs >= B > (p.groups - 1) * p.imgs
                if T > 64:
                    assert (p.nc, p.per_strip, p.imgs, p.trs) == (-(-T // 64), 1, 1, 6)
                    assert p.strips - p.nc in (0, 1)
                else:
                    tr = 1 << p.trs
                    assert p.nc == 1 and p.strips == 2
                    assert T <= tr < 2 * T and p.per_strip * tr == 64
                    assert p.imgs == 2 * p.per_strip


@pytest.mark.parametrize("T", [1, 3, 8, 9, 16, 17, 24, 32, 33, 40, 63, 64, 65,
                               100, 128, 129, 192, 193, 255, 256])
def test_plan_covers_every_token_of_every_image_once(T):
    """Each (image, token) row lies in exactly one group's tiles; a packed
    strip holds whole images (a query's keys are its image's rows of its
    own strip), and its mid block at T 16 fills a strip with four images."""
    for B in (1, 5, 64):
        p = tb.plan_block(B, T, 64, False)
        seen = {}
        for group in range(p.groups):
            rows = tb.tile_rows(p, B, T, group)
            for r, it in enumerate(rows):
                if it is None:
                    continue
                assert it not in seen
                seen[it] = (group, r // 64)
        assert set(seen) == {(b, t) for b in range(B) for t in range(T)}
        if p.nc == 1:  # every image inside one strip
            for b in range(B):
                assert len({seen[(b, t)] for t in range(T)}) == 1
    if T == 16:
        assert tb.plan_block(64, 16, 64, False).per_strip == 4


def test_plan_is_a_pure_function_of_the_shape():
    assert tb.plan_block(64, 256, 64, False) == tb.plan_block(64, 256, 64, False)
    assert tb.plan_block(64, 256, 64, False).groups == 64
    assert tb.plan_block(64, 16, 64, True).groups == 8  # 8 images a cluster
    # the backward's ring stages carry two head dims of weight rows, the
    # forward's three; its tiles hold datt as well
    f, b = tb.plan_block(2, 256, 64, False), tb.plan_block(2, 256, 64, True)
    assert f.smem - 1024 == 3 * (16384 + 3 * 64 * 128) + 3 * 256 * 128
    assert b.smem - 1024 == 3 * (16384 + 2 * 64 * 128) + 4 * 256 * 128


@pytest.mark.parametrize("bf16", [True, False])
def test_weight_grad_chunks_fill_the_card_without_short_chunks(bf16):
    """Split-K chunks of the weight-gradient kernel: at least 256 rows each
    and at most 64; in bf16 the 128 x 256 output tiles times the chunks
    never exceed the card's SMs (132 on an H100 SXM, 114 on a PCIe card)."""
    for C in (16, 64, 256, 512):
        for rows in (16, 2048, 128 * 256, 128 * 1024):
            n = tb._weight_grad_chunks(rows, C, bf16, 132)
            assert 1 <= n <= 64 and (n == 1 or rows // n >= 256)
            if bf16:
                tiles = (-(-3 * C // 128) + -(-C // 128)) * -(-C // 256)
                assert n * tiles <= 132 or n == 1
    assert tb._weight_grad_chunks(128 * 256, 256, True, 132) == 16
    assert tb._weight_grad_chunks(128 * 256, 256, True, 114) == 14


@pytest.mark.parametrize("sms", [132, 114])
def test_project_plan_fits_every_staged_geometry(sms):
    """The staged plan's projection kernel (ops/attention_block.py::
    plan_project, which csrc/attention_block_wide.cu's ProjPlan refuses
    unless it is the shape's) at every width the JAX gate admits (C a
    multiple of 8 up to 512) and row counts from one ragged row tile to
    B 128 x T 256, for qkv (three N segments) and the C-wide projections:
    its 128 x 128 tiles cover every row and column, the persistent grid
    is one block an SM (at most one a tile), the ring is four stages
    deep, and shared memory (the plan's dynamic bytes beside the static
    mbarriers and bias tiles) fits the H100's opt-in."""
    for C in range(8, tb.MAX_BLOCK_CHANNELS + 1, 8):
        for R in (8, 400, 2048, 16384, 32768):
            for nn_seg in (1, 3):
                p = tb.plan_project(R, nn_seg, C, sms)
                per_seg = -(-C // tb.PROJECT_TILE)
                assert p.tiles == -(-R // tb.PROJECT_TILE) * nn_seg * per_seg
                assert per_seg * tb.PROJECT_TILE >= C > (per_seg - 1) * tb.PROJECT_TILE
                assert p.blocks == min(p.tiles, sms) >= 1
                assert p.stages == tb.PROJECT_STAGES == 4
                assert p.smem + tb.PROJECT_STATIC_BYTES <= tb.MAX_SMEM_BYTES
    assert tb.plan_project(2048, 3, 512, 132) == (192, 132, 4, 164864)
    assert tb.plan_project(16384, 1, 256, 132) == (256, 132, 4, 164864)
    assert tb.plan_project(400, 1, 136, 132) == (8, 8, 4, 164864)

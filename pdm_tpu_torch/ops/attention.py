"""Fused spatial self-attention for the UNet's 16x16 (and 4x4 mid) blocks.

Counterpart of ``pdm_tpu/ops/attention.py::fused_spatial_attention`` and
its VJP. On CUDA tensors the wrappers launch hand-written Hopper kernels:
``csrc/attention.cu`` for the forward (it replaces the TPU kernel
``_fwd_kernel``) and ``csrc/attention_bwd.cu`` for the backward (it
replaces ``_bwd_kernel``). On CPU tensors they run
:func:`attention_reference` and :func:`attention_bwd_reference`, the plain
PyTorch versions with the reference's op order and rounding points. They
never fall back from one to the other.

Layout is the JAX package's: q, k, v are (B, T, C) with C = heads * hd,
read as per-head column stripes. They may be the column thirds of one
fused (B, T, 3C) qkv projection (token rows 3C apart); the kernels read
them in place. The kernels take every head dim that is a multiple of 8 up
to ``KERNEL_MAX_HEAD_DIM`` (128); in bf16 at T <= 256 (every flagship
shape) the launcher picks the single-pass wgmma kernels, at longer rows
the two-pass ones.

:func:`use_fused_attention` is the JAX package's geometry gate; the UNet's
attention block calls the kernel inside it and runs the plain computation
(:func:`attention_reference`, JAX's XLA branch) outside it.

When grad is enabled and an input requires it, the call goes through an
``autograd.Function`` whose forward saves q, k, v and the per-row
logsumexp and whose backward is :func:`attention_bwd`, as the JAX
package's ``custom_vjp`` does. Launch counters:
``fused_spatial_attention.launches`` (forward kernels) and
``attention_bwd.launches`` (backward kernels, two per call).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import Tensor
from torch.autograd.function import once_differentiable

from . import _build

# pdm_tpu/ops/attention.py:45-46, the geometry the JAX gate admits
MAX_FUSED_TOKENS = 1024
MAX_FUSED_SCORE_CELLS = 1 << 21  # heads * T * T

# the kernels take any head dim that is a multiple of 8 up to this bound:
# they zero-pad it to the instantiated width of 16, 32, 64 or 128 (the
# fragments and accumulators live in registers, so the width is a template
# parameter)
KERNEL_MAX_HEAD_DIM = 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(
    q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float
) -> Tensor:
    """Plain PyTorch version (the reference's ``attention_reference`` op
    order): fp32 logits and softmax, probabilities cast to q.dtype, then a
    P V product in q.dtype."""
    return _reference_with_lse(q, k, v, heads, scale)[0]


def _reference_with_lse(q, k, v, heads, scale) -> Tuple[Tensor, Tensor]:
    B, T, C = q.shape
    hd = C // heads

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, dim=-1)  # (B, heads, T)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(w, vh)
    return out.transpose(1, 2).reshape(B, T, C), lse


def use_fused_attention(T: int, C: int, heads: int) -> bool:
    """The JAX gate's geometry (``pdm_tpu/ops/attention.py:309-323``) and
    the kernels' head-dim bound: T <= 1024, heads * T^2 <= 2^21, the head
    dim a multiple of 8 up to 128, T a multiple of 8. The JAX gate's
    ``PDM_FUSED_ATTN`` opt-out and its TPU-backend condition have no
    counterpart: the tensors' device chooses between kernel and plain
    version."""
    return (
        T <= MAX_FUSED_TOKENS
        and heads * T * T <= MAX_FUSED_SCORE_CELLS
        and C % heads == 0
        and (C // heads) % 8 == 0
        and C // heads <= KERNEL_MAX_HEAD_DIM
        and T % 8 == 0
    )


def _check(q: Tensor, k: Tensor, v: Tensor, heads: int) -> int:
    """Validate a kernel call; returns the shared token-row stride."""
    if not (q.shape == k.shape == v.shape) or q.ndim != 3:
        raise ValueError(f"q, k, v must share one (B, T, C) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q, k, v must all be float32 or bfloat16: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    B, T, C = q.shape
    if C % heads or (C // heads) % 8 or not 0 < C // heads <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"head dim C/heads = {C}/{heads}: the kernels take "
                         f"multiples of 8 up to {KERNEL_MAX_HEAD_DIM}")
    ld = q.stride(1)
    for t in (q, k, v):
        if t.stride(2) != 1 or t.stride(1) != ld or t.stride(0) != T * ld:
            raise ValueError(
                "q, k, v need unit channel stride and one shared token-row "
                f"stride: strides {q.stride()}, {k.stride()}, {v.stride()}")
    if ld < C:
        raise ValueError(f"token-row stride {ld} < C = {C}")
    if q.dtype == torch.bfloat16 and (
            ld % 8 or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("bf16 q, k, v are read in 16-byte vectors and TMA "
                         "boxes: they need 16-byte aligned storage and a "
                         "token-row stride that is a multiple of 8 (stride "
                         f"{ld})")
    return ld


def attention_with_lse(
    q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float
) -> Tuple[Tensor, Tensor]:
    """(out (B, T, C) in q.dtype, lse (B, heads, T) fp32). While
    ``torch.export`` traces (``torch.compiler.is_exporting()``) the call is
    the custom op ``pdm::attention_fwd`` on every device; eagerly the
    kernel launches directly."""
    if torch.compiler.is_exporting():
        return torch.ops.pdm.attention_fwd(q, k, v, heads, float(scale))
    if q.device.type == "cpu":
        if not (q.device == k.device == v.device):
            raise ValueError("q, k, v must be on one device")
        return _reference_with_lse(q, k, v, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return launch_fwd(q, k, v, heads, scale)


def launch_fwd(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float
               ) -> Tuple[Tensor, Tensor]:
    """The forward kernel's launch on CUDA tensors, counted on
    ``fused_spatial_attention.launches``: the eager wrapper and the custom
    op's CUDA implementation (``ops/library.py``) both end here."""
    ld = _check(q, k, v, heads)
    B, T, C = q.shape
    out = torch.empty((B, T, C), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, heads, T), dtype=torch.float32, device=q.device)
    fn = _build.entry("pdm_attention_fwd", _FWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, T, heads, C // heads, ld, float(scale),
                 _DTYPE_CODES[q.dtype], stream)
    _build.check(err, "pdm_attention_fwd")
    fused_spatial_attention.launches += 1
    return out, lse


def attention_bwd_reference(
    q: Tensor, k: Tensor, v: Tensor, lse: Tensor, do: Tensor, heads: int,
    scale: float,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the TPU kernel ``_bwd_kernel``: (dq, dk, dv)
    in q.dtype, rounding where it rounds. The cotangent is cast to q.dtype;
    P = exp(s - lse) and ds = P * (dp - sum_k P * dp) are rounded to q.dtype
    before their products; products of rounded operands accumulate in fp32
    and the scale is applied after the product."""
    B, T, C = q.shape
    hd = C // heads
    dtype = q.dtype

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2).float()

    def merge(t):
        return t.transpose(1, 2).reshape(B, T, C).to(dtype)

    qh, kh, vh, doh = split(q), split(k), split(v), split(do.to(dtype))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None]).to(dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), doh)
    pdp = p * torch.matmul(doh, vh.transpose(-1, -2))
    ds = (pdp - p * pdp.sum(dim=-1, keepdim=True)).to(dtype).float()
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    return merge(dq), merge(dk), merge(dv)


def attention_bwd(
    q: Tensor, k: Tensor, v: Tensor, lse: Tensor, do: Tensor, heads: int,
    scale: float,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of :func:`fused_spatial_attention` for the cotangent
    ``do``, from the forward's lse. Two kernels on CUDA tensors (dq with
    the row sums D, then dk and dv), the plain version on CPU tensors."""
    if not (q.device == k.device == v.device == lse.device == do.device):
        raise ValueError("q, k, v, lse, do must be on one device")
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, lse, do, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    ld = _check(q, k, v, heads)
    B, T, C = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do must be {tuple(q.shape)}: {tuple(do.shape)}")
    if (lse.shape != (B, heads, T) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 {(B, heads, T)}: "
                         f"{lse.dtype} {tuple(lse.shape)}")
    do = do.to(q.dtype).contiguous()
    if do.data_ptr() % 16:  # the bf16 kernels read 16-byte vectors
        do = do.clone()
    dq, dk, dv = (torch.empty((B, T, C), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    dsum = torch.empty((B, heads, T), dtype=torch.float32, device=q.device)
    code, hd = _DTYPE_CODES[q.dtype], C // heads
    fn_dq = _build.entry("pdm_attention_bwd_dq", _BWD_DQ_ARGS)
    fn_dkdv = _build.entry("pdm_attention_bwd_dkdv", _BWD_DKDV_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dq.data_ptr(), dsum.data_ptr(), B, T,
                    heads, hd, ld, float(scale), code, stream)
        _build.check(err, "pdm_attention_bwd_dq")
        attention_bwd.launches += 1
        err = fn_dkdv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                      lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), B, T, heads, hd, ld, float(scale), code,
                      stream)
        _build.check(err, "pdm_attention_bwd_dkdv")
        attention_bwd.launches += 1
    return dq, dk, dv


class _AttentionFn(torch.autograd.Function):
    """The forward's kernel (or plain version) with :func:`attention_bwd`
    as its VJP, as the JAX package's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        out, lse = attention_with_lse(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, lse, do, ctx.heads, ctx.scale)
        return dq, dk, dv, None, None


def fused_spatial_attention(
    q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float
) -> Tensor:
    """Multi-head softmax attention over (B, T, C); returns (B, T, C) in
    q.dtype. Kernel on CUDA tensors, plain version on CPU tensors;
    differentiable through :func:`attention_bwd`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _AttentionFn.apply(q, k, v, heads, scale)
    return attention_with_lse(q, k, v, heads, scale)[0]


# kernel launches since the last reset (set to 0 to reset)
fused_spatial_attention.launches = 0
attention_bwd.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong,
             ctypes.c_float, _I, _P]
_BWD_DQ_ARGS = [_P] * 7 + [_I] * 4 + [ctypes.c_longlong, ctypes.c_float, _I, _P]
_BWD_DKDV_ARGS = [_P] * 8 + [_I] * 4 + [ctypes.c_longlong, ctypes.c_float, _I,
                                        _P]

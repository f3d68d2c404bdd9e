"""Fused spatial self-attention for the UNet's 16x16 (and 4x4 mid) blocks.

Counterpart of ``pdm_tpu/ops/attention.py::fused_spatial_attention``.
On a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/attention.cu`` (which replaces the TPU kernel ``_fwd_kernel``); on
a CPU tensor it runs :func:`attention_reference`, the plain PyTorch
version with the reference's op order. It never falls back from one to
the other.

Layout is the JAX package's: q, k, v are (B, T, C) with C = heads * hd,
read as per-head column stripes. They may be the column thirds of one
fused (B, T, 3C) qkv projection (token rows 3C apart); the kernel reads
them in place.

Forward only: a CUDA input that requires grad raises, since the backward
kernel (``_bwd_kernel`` on the TPU) comes with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import Tensor

from . import _build

# head dims the kernels are instantiated for (q fragments and the output
# accumulator live in registers, so hd is a template parameter; the bf16
# tensor-core kernel works in 16-wide slices of hd)
KERNEL_HEAD_DIMS = (16, 32, 64)

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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "fused_spatial_attention has no backward kernel yet; call it "
            "under torch.no_grad() or on tensors that do not require grad")
    B, T, C = q.shape
    if C % heads or C // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim C/heads = {C}/{heads} not in "
                         f"{KERNEL_HEAD_DIMS}")
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
        raise ValueError("bf16 q, k, v are read in 16-byte vectors: they need "
                         "16-byte aligned storage and a token-row stride that "
                         f"is a multiple of 8 (stride {ld})")
    return ld


def attention_with_lse(
    q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float
) -> Tuple[Tensor, Tensor]:
    """(out (B, T, C) in q.dtype, lse (B, heads, T) fp32)."""
    if q.device.type == "cpu":
        if not (q.device == k.device == v.device):
            raise ValueError("q, k, v must be on one device")
        return _reference_with_lse(q, k, v, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    ld = _check(q, k, v, heads)
    B, T, C = q.shape
    out = torch.empty((B, T, C), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, heads, T), dtype=torch.float32, device=q.device)
    fn = _kernel_entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, T, heads, C // heads, ld, float(scale),
                 _DTYPE_CODES[q.dtype], stream)
    _build.check(err, "pdm_attention_fwd")
    fused_spatial_attention.launches += 1
    return out, lse


def fused_spatial_attention(
    q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float
) -> Tensor:
    """Multi-head softmax attention over (B, T, C); returns (B, T, C) in
    q.dtype. Kernel on CUDA tensors, plain version on CPU tensors."""
    return attention_with_lse(q, k, v, heads, scale)[0]


# kernel launches since the last reset (set to 0 to reset)
fused_spatial_attention.launches = 0


def _kernel_entry():
    lib = _build.load_kernels()
    fn = lib.pdm_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_longlong,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn

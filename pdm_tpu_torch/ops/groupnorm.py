"""GroupNorm with an optional fused SiLU, over (B, S, C) activations.

Counterpart of ``pdm_tpu/ops/groupnorm.py::fused_group_norm_act``. On a
CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/groupnorm.cu`` (which replaces the TPU kernel ``_fwd_kernel``); on
a CPU tensor it runs :func:`group_norm_reference`, the plain PyTorch
version with the reference's op order. It never falls back from one to
the other.

Statistics follow the reference, not ``torch.nn.functional.group_norm``:
fp32 sum and sum of squares, ``var = max(E[x^2] - E[x]^2, 0)``, then
``(x - mean) * (rsqrt(var + eps) * scale) + bias``. The result has x's
dtype.

Forward only: a CUDA input that requires grad raises, since the backward
kernel (``_bwd_kernel`` on the TPU) comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import Tensor

from . import _build

ACTS = ("none", "silu")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def group_norm_reference(
    x: Tensor, scale: Tensor, bias: Tensor, groups: int, eps: float,
    act: str = "none", norm_dtype: torch.dtype = torch.float32,
) -> Tensor:
    """Plain PyTorch version in the reference's op order; returns
    ``norm_dtype`` like the reference (the wrapper casts to x.dtype)."""
    B, S, C = x.shape
    cpg = C // groups
    xg = x.to(norm_dtype).reshape(B, S, groups, cpg)
    mean = torch.mean(xg, dim=(1, 3))  # (B, G)
    var = torch.clamp(torch.mean(xg * xg, dim=(1, 3)) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps)[:, None, :, None] * scale.to(
        norm_dtype).reshape(1, 1, groups, cpg)
    y = (xg - mean[:, None, :, None]) * mul + bias.to(norm_dtype).reshape(
        1, 1, groups, cpg)
    y = y.reshape(B, S, C)
    if act == "silu":
        y = F.silu(y)
    return y


def _check(x: Tensor, scale: Tensor, bias: Tensor, groups: int) -> None:
    if x.ndim != 3:
        raise ValueError(f"x must be (B, S, C): {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16: {x.dtype}")
    C = x.shape[2]
    if groups <= 0 or C % groups:
        raise ValueError(f"C={C} not divisible into {groups} groups")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (C,) or p.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({C},): "
                             f"{p.dtype} {tuple(p.shape)}")
        if p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (B, S, C)")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        raise NotImplementedError(
            "fused_group_norm_act has no backward kernel yet; call it under "
            "torch.no_grad() or on tensors that do not require grad")


def fused_group_norm_act(
    x: Tensor, scale: Tensor, bias: Tensor, groups: int, eps: float,
    act: str = "none",
) -> Tensor:
    """GroupNorm(+SiLU) over (B, S, C); returns x.dtype. Kernel on CUDA
    tensors, plain version on CPU tensors."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}: {act!r}")
    if x.device.type == "cpu":
        return group_norm_reference(x, scale, bias, groups, eps, act).to(
            x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, scale, bias, groups)
    B, S, C = x.shape
    out = torch.empty_like(x)
    fn = _kernel_entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), B, S, C, groups, float(eps),
                 int(act == "silu"), _DTYPE_CODES[x.dtype], stream)
    _build.check(err, "pdm_group_norm_fwd")
    fused_group_norm_act.launches += 1
    return out


# kernel launches since the last reset (set to 0 to reset)
fused_group_norm_act.launches = 0


def _kernel_entry():
    lib = _build.load_kernels()
    fn = lib.pdm_group_norm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn

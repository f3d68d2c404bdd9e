"""GroupNorm with an optional fused SiLU, over (B, S, C) activations.

Counterpart of ``pdm_tpu/ops/groupnorm.py::fused_group_norm_act`` and its
VJP. On CUDA tensors the wrappers launch hand-written Hopper kernels:
``csrc/groupnorm.cu`` for the forward (it replaces the TPU kernel
``_fwd_kernel``) and ``csrc/groupnorm_bwd.cu`` for the backward (it
replaces ``_bwd_kernel``). On CPU tensors they run
:func:`group_norm_reference` and :func:`group_norm_bwd_reference`, the
plain PyTorch versions with the reference's op order. They never fall
back from one to the other.

Statistics follow the reference, not ``torch.nn.functional.group_norm``:
fp32 sum and sum of squares, ``var = max(E[x^2] - E[x]^2, 0)``, then
``(x - mean) * (rsqrt(var + eps) * scale) + bias``. The result has x's
dtype.

When grad is enabled and an input requires it, the call goes through an
``autograd.Function`` that saves x, scale and bias and whose backward is
:func:`group_norm_bwd`, as the JAX package's ``custom_vjp`` does. Launch
counters: ``fused_group_norm_act.launches`` (forward) and
``group_norm_bwd.launches`` (backward), one launch a call each.

Both kernels take every ``C % groups == 0`` and run one launch plan
(:func:`plan_group_norm`, a pure function of the shape): the kr blocks of a
thread-block cluster split an image's rows, kc clusters its channels in
whole groups, and each block holds its rows x C / kc share in shared
memory (``hold``) or, where it does not fit, re-reads whole rows from
device memory in each pass.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.autograd.function import once_differentiable

from . import _build

ACTS = ("none", "silu")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launch plan (csrc/groupnorm_common.cuh). A block's share of an image, in
# bytes (x for the forward; x and an fp32 slot an element, dy then dn, for
# the backward), is cut to about TILE_BYTES by splitting the rows across a
# cluster of up to MAX_CLUSTER_BLOCKS blocks (each keeping at least
# MIN_ROWS rows), then the channels in whole groups, while a block's row
# segment stays at least MIN_SEGMENT_BYTES wide (two 32-byte sectors);
# channels are split further while the grid has fewer than FILL_BLOCKS
# blocks. A block takes TARGET_THREADS threads (half as many for images of
# at most MIN_ROWS rows). A share that does not fit in MAX_SMEM_BYTES
# streams instead (whole rows, re-read in each pass). The values were
# measured best among those tried on the flagship's shapes (PERF.md §6).
TILE_BYTES = {False: 32 << 10, True: 64 << 10}  # forward, backward
MAX_CLUSTER_BLOCKS = 8
MIN_ROWS = 16
MIN_SEGMENT_BYTES = 64
FILL_BLOCKS = 2 * 132  # two blocks for each of the H100's SMs
TARGET_THREADS = 256
MAX_SMEM_BYTES = 232448


class GroupNormPlan(NamedTuple):
    """One launch of a GroupNorm kernel; mirrors ``GnPlan`` in
    csrc/groupnorm_common.cuh. Block (i, j, b) of the grid (kr, kc, B)
    owns rows [i rows, (i + 1) rows) (clipped to S) and channels
    [j cb, (j + 1) cb) of image b; the kr blocks of a column are a
    cluster. Its threads t < lanes_v * lanes_p take column vectors
    t % lanes_v + k lanes_v and rows t // lanes_v + k lanes_p."""
    kr: int
    kc: int
    rows: int
    cb: int
    vec: int
    lanes_v: int
    lanes_p: int
    threads: int
    hold: int
    smem: int


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _smem_bytes(lanes_v, lanes_p, vec, cb, gb, rows, itemsize, nq, hold):
    """Shared memory of a plan (csrc/groupnorm_common.cuh::smem_bytes):
    the sums' arrays, then the tile: x and, for the backward, an fp32 slot
    an element (dy, then dn)."""
    floats = (_round4(2 * lanes_v * lanes_p * vec) + (1 + nq) * _round4(2 * cb)
              + (1 + nq) * _round4(2 * gb))
    tile = -(-rows * cb * itemsize // 16) * 16 + (4 * rows * cb if nq == 2 else 0)
    return 4 * floats + (tile if hold else 0)


def _geometry(S, C, groups, itemsize, nq, kr, kc, align, hold):
    rows = -(-S // kr)
    cb = C // kc
    vec = next(v for v in (4, 2, 1)
               if cb % v == 0 and align % (v * itemsize) == 0)
    vpr = cb // vec
    target = TARGET_THREADS if S > MIN_ROWS else TARGET_THREADS // 2
    lanes_v = min(vpr, target)
    lanes_p = max(1, min(target // lanes_v, rows))
    threads = -(-lanes_v * lanes_p // 32) * 32
    smem = _smem_bytes(lanes_v, lanes_p, vec, cb, cb // (C // groups), rows,
                       itemsize, nq, hold)
    return GroupNormPlan(kr, kc, rows, cb, vec, lanes_v, lanes_p, threads,
                         int(hold), smem)


def plan_group_norm(B: int, S: int, C: int, groups: int, itemsize: int,
                    backward: bool, align: int = 16) -> GroupNormPlan:
    """The launch plan of the forward (``backward`` False) or backward
    kernel for x of shape (B, S, C) with ``itemsize``-byte elements whose
    pointers share ``align``-byte alignment (16 or less). Pure: the
    same arguments give the same plan, so a call is bitwise repeatable."""
    if groups <= 0 or C % groups:
        raise ValueError(f"C={C} not divisible into {groups} groups")
    nq = 2 if backward else 1
    budget = TILE_BYTES[backward]
    image = S * C * (itemsize + 4 if backward else itemsize)
    kr = 1
    while (kr < MAX_CLUSTER_BLOCKS and image > budget * kr
           and -(-S // (2 * kr)) >= MIN_ROWS):
        kr *= 2
    splits = [d for d in range(1, groups + 1) if groups % d == 0
              and (d == 1 or (C // d) * itemsize >= MIN_SEGMENT_BYTES)]
    i = next((i for i, d in enumerate(splits) if image <= budget * kr * d),
             len(splits) - 1)
    while i + 1 < len(splits) and B * kr * splits[i] < FILL_BLOCKS:
        i += 1
    plan = _geometry(S, C, groups, itemsize, nq, kr, splits[i], align, True)
    if plan.smem <= MAX_SMEM_BYTES:
        return plan
    # stream: whole rows (the fewest channel blocks whose arrays fit)
    for kc in (d for d in range(1, groups + 1) if groups % d == 0):
        plan = _geometry(S, C, groups, itemsize, nq, kr, kc, align, False)
        if plan.smem <= MAX_SMEM_BYTES:
            return plan
    raise ValueError(f"no GroupNorm plan for C={C} in {groups} groups")


def _alignment(*tensors: Tensor) -> int:
    """The largest power of two up to 16 dividing every data pointer."""
    addr = 16
    for t in tensors:
        addr = math.gcd(addr, t.data_ptr())
    return addr


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


def _forward(x: Tensor, scale: Tensor, bias: Tensor, groups: int, eps: float,
             act: str) -> Tensor:
    if x.device.type == "cpu":
        return group_norm_reference(x, scale, bias, groups, eps, act).to(
            x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, scale, bias, groups)
    B, S, C = x.shape
    out = torch.empty_like(x)
    plan = _GnPlan(*plan_group_norm(B, S, C, groups, x.element_size(),
                                        False, _alignment(x, out)))
    fn = _build.entry("pdm_group_norm_fwd", _FWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), ctypes.byref(plan), B, S, C, groups,
                 float(eps), int(act == "silu"), _DTYPE_CODES[x.dtype],
                 stream)
    _build.check(err, "pdm_group_norm_fwd")
    fused_group_norm_act.launches += 1
    return out


def group_norm_bwd_reference(
    x: Tensor, scale: Tensor, bias: Tensor, dy: Tensor, groups: int,
    eps: float, act: str = "none",
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the TPU kernel ``_bwd_kernel``: (dx in
    x.dtype, dscale, dbias in fp32), in its op order. Statistics are
    recomputed from x in fp32; the cotangent keeps its own dtype up to the
    fp32 arithmetic; dscale/dbias are per-image partials summed over B."""
    B, S, C = x.shape
    cpg = C // groups
    n = S * cpg
    xf = x.float()
    dz = dy.float()
    cs = xf.sum(dim=1).reshape(B, groups, cpg).sum(dim=2)  # (B, G)
    sq = (xf * xf).sum(dim=1).reshape(B, groups, cpg).sum(dim=2)
    mu = cs / n
    var = torch.clamp(sq / n - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    mu_c = mu.repeat_interleave(cpg, dim=1)[:, None, :]  # (B, 1, C)
    inv_c = inv.repeat_interleave(cpg, dim=1)[:, None, :]
    n_hat = (xf - mu_c) * inv_c
    gamma = scale.float()
    if act == "silu":
        z = n_hat * gamma + bias.float()
        s = torch.sigmoid(z)
        dz = dz * (s * (1.0 + z * (1.0 - s)))
    dg_parts = (dz * n_hat).sum(dim=1)  # (B, C)
    db_parts = dz.sum(dim=1)
    dn = dz * gamma

    def group_mean(t):  # (B, S, C) -> per-group mean broadcast to (B, 1, C)
        g = t.sum(dim=1).reshape(B, groups, cpg).sum(dim=2) / n
        return g.repeat_interleave(cpg, dim=1)[:, None, :]

    dx = inv_c * (dn - group_mean(dn) - n_hat * group_mean(dn * n_hat))
    return dx.to(x.dtype), dg_parts.sum(dim=0), db_parts.sum(dim=0)


def group_norm_bwd(
    x: Tensor, scale: Tensor, bias: Tensor, dy: Tensor, groups: int,
    eps: float, act: str = "none",
) -> Tuple[Tensor, Tensor, Tensor]:
    """(dx, dscale, dbias) of :func:`fused_group_norm_act` for the cotangent
    ``dy``. The kernel on CUDA tensors (its per-image fp32 partials summed
    over B here), the plain version on CPU tensors."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}: {act!r}")
    if x.device.type == "cpu":
        return group_norm_bwd_reference(x, scale, bias, dy, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, scale, bias, groups)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x ({x.dtype} {tuple(x.shape)}): "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    B, S, C = x.shape
    dy = dy.contiguous()
    dx = torch.empty_like(x)
    parts = torch.empty((2, B, C), dtype=torch.float32, device=x.device)
    plan = _GnPlan(*plan_group_norm(B, S, C, groups, x.element_size(),
                                        True, _alignment(x, dy, dx)))
    fn = _build.entry("pdm_group_norm_bwd", _BWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
                 parts[1].data_ptr(), ctypes.byref(plan), B, S, C, groups,
                 float(eps), int(act == "silu"), _DTYPE_CODES[x.dtype],
                 stream)
    _build.check(err, "pdm_group_norm_bwd")
    group_norm_bwd.launches += 1
    dscale, dbias = parts.sum(dim=1)
    return dx, dscale, dbias


class _GroupNormFn(torch.autograd.Function):
    """The forward's kernel (or plain version) with :func:`group_norm_bwd`
    as its VJP, as the JAX package's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps, ctx.act = groups, eps, act
        return _forward(x, scale, bias, groups, eps, act)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = group_norm_bwd(x, scale, bias, dy, ctx.groups,
                                           ctx.eps, ctx.act)
        return dx, dscale, dbias, None, None, None


def fused_group_norm_act(
    x: Tensor, scale: Tensor, bias: Tensor, groups: int, eps: float,
    act: str = "none",
) -> Tensor:
    """GroupNorm(+SiLU) over (B, S, C); returns x.dtype. Kernel on CUDA
    tensors, plain version on CPU tensors; differentiable through
    :func:`group_norm_bwd`."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}: {act!r}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        return _GroupNormFn.apply(x, scale, bias, groups, eps, act)
    return _forward(x, scale, bias, groups, eps, act)


# kernel launches since the last reset (set to 0 to reset)
fused_group_norm_act.launches = 0
group_norm_bwd.launches = 0



class _GnPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in GroupNormPlan._fields]


_P, _I = ctypes.c_void_p, ctypes.c_int
_PLAN = ctypes.POINTER(_GnPlan)
_FWD_ARGS = [_P, _P, _P, _P, _PLAN, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P]
_BWD_ARGS = [_P] * 7 + [_PLAN] + [_I] * 4 + [ctypes.c_float, _I, _I, _P]

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

Rows 3s and 4s: GroupNorm of an image whose rows are split across the
ranks of a model group (spatial parallelism, ``parallel/model_parallel.py``),
where JAX's GSPMD psums the TPU kernel's statistics over the model axis.
:func:`split_group_norm_act` runs a statistics launch
(:func:`group_norm_stats`: the fp32 sum and sum of squares of each image's
groups over the rank's rows), an fp32 all-reduce of the
(B, G, 2) sums over the group, and a normalise launch
(:func:`group_norm_apply`); its backward runs :func:`group_norm_bwd_stats`
(each group's partial sum of dn and of dn * n_hat, each channel's partial
dgamma and dbeta over the rank's rows of every image), an all-reduce of
the group sums, and :func:`group_norm_bwd_apply` (dx). dgamma and dbeta
stay partial: the trainer sums every gradient over the mesh. The four
kernels are in ``csrc/groupnorm_split.cu`` and share one launch plan
(:func:`plan_split`); each has its plain version here, for CPU tensors,
and its launch counter.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

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


def _check_x(x: Tensor, groups: int) -> None:
    if x.ndim != 3:
        raise ValueError(f"x must be (B, S, C): {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16: {x.dtype}")
    C = x.shape[2]
    if groups <= 0 or C % groups:
        raise ValueError(f"C={C} not divisible into {groups} groups")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (B, S, C)")


def _check(x: Tensor, scale: Tensor, bias: Tensor, groups: int) -> None:
    _check_x(x, groups)
    C = x.shape[2]
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (C,) or p.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({C},): "
                             f"{p.dtype} {tuple(p.shape)}")
        if p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")


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



# ---------------------------------------------------------------------
# rows 3s and 4s: split statistics for a row-sharded image
# ---------------------------------------------------------------------

# Rows 3s and 4s' launch plan (csrc/groupnorm_split.cu): each image's rows
# are cut into slabs, one block a slab, grid (slabs, B). A block has up to
# SPLIT_THREADS threads; thread t takes column vector t % V and rows
# t // V, t // V + P, ... (vectors of 16 bytes where C and the alignment
# allow), and loads SPLIT_UNROLL rows before it adds or writes any. A slab
# is at least as many rows as keep each thread's SPLIT_UNROLL loads busy,
# and the slabs are cut so that the grid has about SPLIT_WAVE blocks: four
# blocks on each of the H100's 132 SMs, one full wave.
SPLIT_THREADS = 256
SPLIT_UNROLL = 4
SPLIT_WAVE = 4 * 132


class SplitPlan(NamedTuple):
    """One launch of a row 3s or 4s kernel; mirrors ``SplitPlan`` in
    csrc/groupnorm_split.cu. Block (k, b) of the grid (slabs, B) owns rows
    [k rows, (k + 1) rows) (clipped to S) of image b and all C channels;
    its threads t < lanes_v * lanes_p take column vectors t % lanes_v +
    j lanes_v and rows t // lanes_v + i lanes_p."""
    vec: int
    lanes_v: int
    lanes_p: int
    threads: int
    rows: int
    slabs: int


def plan_split(B: int, S: int, C: int, itemsize: int, align: int = 16
               ) -> SplitPlan:
    """The launch plan of rows 3s and 4s (all four launches) for x of shape
    (B, S, C) with ``itemsize``-byte elements whose pointers share
    ``align``-byte alignment. Pure: the same arguments give the same plan,
    so a call is bitwise repeatable."""
    vec = next(v for v in (8, 4, 2, 1)
               if v * itemsize <= 16 and C % v == 0 and align % (v * itemsize) == 0)
    vpr = C // vec
    lanes_v = min(vpr, SPLIT_THREADS)
    lanes_p = max(1, SPLIT_THREADS // lanes_v)
    threads = -(-lanes_v * lanes_p // 32) * 32
    passes = -(-vpr // lanes_v)
    least = lanes_p * -(-SPLIT_UNROLL // passes)
    rows = max(least, -(-S // -(-SPLIT_WAVE // B)))
    rows = min(S, -(-rows // lanes_p) * lanes_p)
    return SplitPlan(vec, lanes_v, lanes_p, threads, rows, -(-S // rows))


def _stats_of(sums: Tensor, n: float, eps: float):
    """(mean, rstd), each (B, G), of the (B, G, 2) sums over n elements a
    group: the kernels' arithmetic."""
    mean = sums[..., 0] / n
    var = torch.clamp(sums[..., 1] / n - mean * mean, min=0.0)
    return mean, 1.0 / torch.sqrt(var + eps)


def group_norm_stats_reference(x: Tensor, groups: int) -> Tensor:
    """Plain version of :func:`group_norm_stats`: (B, G, 2) fp32 sums of
    x and x^2 over each group's channels and x's rows."""
    B, S, C = x.shape
    xg = x.float().reshape(B, S, groups, C // groups)
    return torch.stack([xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))], -1)


def group_norm_apply_reference(x: Tensor, scale: Tensor, bias: Tensor,
                               sums: Tensor, groups: int, n: float, eps: float,
                               act: str = "none") -> Tensor:
    """Plain version of :func:`group_norm_apply`, in x.dtype."""
    B, S, C = x.shape
    cpg = C // groups
    mean, inv = _stats_of(sums.float(), n, eps)
    mul = (inv[:, :, None] * scale.float().reshape(groups, cpg)).reshape(B, 1, C)
    y = (x.float() - mean.repeat_interleave(cpg, dim=1)[:, None, :]) * mul \
        + bias.float()
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def _bwd_terms(x, dy, scale, bias, sums, groups, n, eps, act):
    """n_hat, dz, inv per channel, of the plain backward versions."""
    B, S, C = x.shape
    cpg = C // groups
    mean, inv = _stats_of(sums.float(), n, eps)
    inv_c = inv.repeat_interleave(cpg, dim=1)[:, None, :]
    n_hat = (x.float() - mean.repeat_interleave(cpg, dim=1)[:, None, :]) * inv_c
    dz = dy.float()
    if act == "silu":
        z = n_hat * scale.float() + bias.float()
        sg = torch.sigmoid(z)
        dz = dz * (sg * (1.0 + z * (1.0 - sg)))
    return n_hat, dz, inv_c


def group_norm_bwd_stats_reference(
    x: Tensor, dy: Tensor, scale: Tensor, bias: Tensor, sums: Tensor,
    groups: int, n: float, eps: float, act: str = "none",
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`group_norm_bwd_stats`: the (B, G, 2) sums
    of dn and dn * n_hat over the rows, and the partial dscale, dbias
    (summed over B)."""
    B, S, C = x.shape
    n_hat, dz, _ = _bwd_terms(x, dy, scale, bias, sums, groups, n, eps, act)
    dg = (dz * n_hat).sum(dim=1)  # (B, C)
    db = dz.sum(dim=1)
    gam = scale.float()
    gsums = torch.stack([(db * gam).reshape(B, groups, -1).sum(-1),
                         (dg * gam).reshape(B, groups, -1).sum(-1)], -1)
    return gsums, dg.sum(dim=0), db.sum(dim=0)


def group_norm_bwd_apply_reference(
    x: Tensor, dy: Tensor, scale: Tensor, bias: Tensor, sums: Tensor,
    gsums: Tensor, groups: int, n: float, eps: float, act: str = "none",
) -> Tensor:
    """Plain version of :func:`group_norm_bwd_apply`: dx in x.dtype."""
    cpg = x.shape[2] // groups
    n_hat, dz, inv_c = _bwd_terms(x, dy, scale, bias, sums, groups, n, eps, act)
    dn = dz * scale.float()
    m1 = (gsums[..., 0] / n).repeat_interleave(cpg, dim=1)[:, None, :]
    m2 = (gsums[..., 1] / n).repeat_interleave(cpg, dim=1)[:, None, :]
    return (inv_c * (dn - m1 - n_hat * m2)).to(x.dtype)


def _check_sums(sums: Tensor, x: Tensor, groups: int, name: str) -> None:
    want = (x.shape[0], groups, 2)
    if (tuple(sums.shape) != want or sums.dtype != torch.float32
            or sums.device != x.device or not sums.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 {want} on "
                         f"{x.device}: {sums.dtype} {tuple(sums.shape)}")


def _cuda(x: Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


_COUNTERS: Dict[Tuple[int, int], Tensor] = {}


def _counters(x: Tensor, n: int) -> Tensor:
    """At least ``n`` zeroed int32 counters for the statistics kernels'
    last-block folds, one buffer per device and stream (a kernel leaves
    its counters zero, and launches on one stream do not overlap)."""
    key = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 256), dtype=torch.int32, device=x.device)
        _COUNTERS[key] = c
    return c


def _split_plan(x: Tensor, *others: Tensor) -> _SplitPlan:
    B, S, C = x.shape
    return _SplitPlan(*plan_split(B, S, C, x.element_size(),
                                  _alignment(x, *others)))


def group_norm_stats(x: Tensor, groups: int) -> Tensor:
    """Row 3s's statistics: (B, G, 2) fp32 sums of x and x^2 of each
    image's groups over x's rows (on the card: each slab's sums added in
    slab order, bitwise repeatable)."""
    if not _cuda(x):
        return group_norm_stats_reference(x, groups)
    _check_x(x, groups)
    B, S, C = x.shape
    sums = torch.empty((B, groups, 2), dtype=torch.float32, device=x.device)
    plan = _split_plan(x)
    part = torch.empty((B, plan.slabs, groups, 2), dtype=torch.float32,
                       device=x.device)
    fn = _build.entry("pdm_group_norm_stats", _STATS_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), sums.data_ptr(), part.data_ptr(),
                 _counters(x, B).data_ptr(), ctypes.byref(plan), B, S, C,
                 groups, _DTYPE_CODES[x.dtype], stream)
    _build.check(err, "pdm_group_norm_stats")
    group_norm_stats.launches += 1
    return sums


def group_norm_apply(x: Tensor, scale: Tensor, bias: Tensor, sums: Tensor,
                     groups: int, n: float, eps: float, act: str = "none"
                     ) -> Tensor:
    """Row 3s's normalise: GroupNorm(+SiLU) of x with the statistics of the
    (all-reduced) ``sums`` over ``n`` elements a group; x.dtype."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}: {act!r}")
    if not _cuda(x):
        return group_norm_apply_reference(x, scale, bias, sums, groups, n,
                                          eps, act)
    _check(x, scale, bias, groups)
    _check_sums(sums, x, groups, "sums")
    B, S, C = x.shape
    out = torch.empty_like(x)
    plan = _split_plan(x, out)
    fn = _build.entry("pdm_group_norm_apply", _APPLY_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 sums.data_ptr(), out.data_ptr(), ctypes.byref(plan), B, S, C,
                 groups, float(n), float(eps), int(act == "silu"),
                 _DTYPE_CODES[x.dtype], stream)
    _build.check(err, "pdm_group_norm_apply")
    group_norm_apply.launches += 1
    return out


def group_norm_bwd_stats(
    x: Tensor, dy: Tensor, scale: Tensor, bias: Tensor, sums: Tensor,
    groups: int, n: float, eps: float, act: str = "none",
) -> Tuple[Tensor, Tensor, Tensor]:
    """Row 4s's statistics: the (B, G, 2) sums of dn and dn * n_hat over
    x's rows, and the partial dscale and dbias (fp32, over x's rows of
    every image), from the forward's (all-reduced) ``sums``. On the card
    one launch: each slab's channel sums added in slab order, each image's
    totals in image order (bitwise repeatable)."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}: {act!r}")
    if not _cuda(x):
        return group_norm_bwd_stats_reference(x, dy, scale, bias, sums, groups,
                                              n, eps, act)
    _check(x, scale, bias, groups)
    _check_sums(sums, x, groups, "sums")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x ({x.dtype} {tuple(x.shape)}): "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    dy = dy.contiguous()
    B, S, C = x.shape
    gsums = torch.empty((B, groups, 2), dtype=torch.float32, device=x.device)
    dparams = torch.empty((2, C), dtype=torch.float32, device=x.device)
    plan = _split_plan(x, dy)
    part = torch.empty((B, plan.slabs, 2, C), dtype=torch.float32,
                       device=x.device)
    totals = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
    fn = _build.entry("pdm_group_norm_bwd_stats", _BWD_STATS_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 sums.data_ptr(), gsums.data_ptr(), dparams.data_ptr(),
                 part.data_ptr(), totals.data_ptr(),
                 _counters(x, B + 1).data_ptr(), ctypes.byref(plan), B, S, C,
                 groups, float(n), float(eps), int(act == "silu"),
                 _DTYPE_CODES[x.dtype], stream)
    _build.check(err, "pdm_group_norm_bwd_stats")
    group_norm_bwd_stats.launches += 1
    return gsums, dparams[0], dparams[1]


def group_norm_bwd_apply(
    x: Tensor, dy: Tensor, scale: Tensor, bias: Tensor, sums: Tensor,
    gsums: Tensor, groups: int, n: float, eps: float, act: str = "none",
) -> Tensor:
    """Row 4s's dx from the forward's and the backward's (all-reduced)
    group sums."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}: {act!r}")
    if not _cuda(x):
        return group_norm_bwd_apply_reference(x, dy, scale, bias, sums, gsums,
                                              groups, n, eps, act)
    _check(x, scale, bias, groups)
    _check_sums(sums, x, groups, "sums")
    _check_sums(gsums, x, groups, "gsums")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x ({x.dtype} {tuple(x.shape)}): "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")
    dy = dy.contiguous()
    B, S, C = x.shape
    dx = torch.empty_like(x)
    plan = _split_plan(x, dy, dx)
    fn = _build.entry("pdm_group_norm_bwd_apply", _BWD_APPLY_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 sums.data_ptr(), gsums.data_ptr(), dx.data_ptr(),
                 ctypes.byref(plan), B, S, C, groups, float(n), float(eps),
                 int(act == "silu"), _DTYPE_CODES[x.dtype], stream)
    _build.check(err, "pdm_group_norm_bwd_apply")
    group_norm_bwd_apply.launches += 1
    return dx


group_norm_stats.launches = 0
group_norm_apply.launches = 0
group_norm_bwd_stats.launches = 0
group_norm_bwd_apply.launches = 0


def _reduce(t: Tensor, group, stats) -> Tensor:
    from ..parallel.collectives import all_reduce

    return all_reduce(t, group, stats)


class _SplitGroupNormFn(torch.autograd.Function):
    """Rows 3s and 4s with the model group's all-reduce between the two
    launches of each direction."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, act, n, group, stats):
        sums = _reduce(group_norm_stats(x, groups), group, stats)
        ctx.save_for_backward(x, scale, bias, sums)
        ctx.args = (groups, n, eps, act, group, stats)
        return group_norm_apply(x, scale, bias, sums, groups, n, eps, act)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, bias, sums = ctx.saved_tensors
        groups, n, eps, act, group, stats = ctx.args
        gsums, dscale, dbias = group_norm_bwd_stats(x, dy, scale, bias, sums,
                                                    groups, n, eps, act)
        gsums = _reduce(gsums, group, stats)
        dx = group_norm_bwd_apply(x, dy, scale, bias, sums, gsums, groups, n,
                                  eps, act)
        return dx, dscale, dbias, None, None, None, None, None, None


def split_group_norm_act(
    x: Tensor, scale: Tensor, bias: Tensor, groups: int, eps: float,
    act: str = "none", group=None, size: int = 1, stats=None,
) -> Tensor:
    """GroupNorm(+SiLU) over (B, S, C) where x holds this rank's S rows of
    images whose rows are split evenly over the ``size`` ranks of the
    process ``group``: statistics, their all-reduce over the group
    (counted in ``stats``), normalise; differentiable through rows 4s
    (dscale and dbias are this rank's part). With no group it is the
    whole image's GroupNorm through the two launches. A group's element
    count is S * size * C / groups, right for an even split only: the
    spatial layout runs a level whose height the model axis does not
    divide whole, through rows 3 and 4, and never reaches this."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}: {act!r}")
    n = float(x.shape[1] * size) * float(x.shape[2] // groups)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        return _SplitGroupNormFn.apply(x, scale, bias, groups, eps, act, n,
                                       group, stats)
    sums = _reduce(group_norm_stats(x, groups), group, stats)
    return group_norm_apply(x, scale, bias, sums, groups, n, eps, act)


class _GnPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in GroupNormPlan._fields]


class _SplitPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in SplitPlan._fields]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PLAN = ctypes.POINTER(_GnPlan)
_SPLIT = ctypes.POINTER(_SplitPlan)
_FWD_ARGS = [_P, _P, _P, _P, _PLAN, _I, _I, _I, _I, _F, _I, _I, _P]
_BWD_ARGS = [_P] * 7 + [_PLAN] + [_I] * 4 + [_F, _I, _I, _P]
_STATS_ARGS = [_P] * 4 + [_SPLIT] + [_I] * 5 + [_P]
_APPLY_ARGS = [_P] * 5 + [_SPLIT] + [_I] * 4 + [_F, _F, _I, _I, _P]
_BWD_STATS_ARGS = [_P] * 10 + [_SPLIT] + [_I] * 4 + [_F, _F, _I, _I, _P]
_BWD_APPLY_ARGS = [_P] * 7 + [_SPLIT] + [_I] * 4 + [_F, _F, _I, _I, _P]

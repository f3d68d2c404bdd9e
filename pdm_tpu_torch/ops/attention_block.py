"""The whole attention block, x + out_proj(attention(qkv_proj(h))), fused.

Counterpart of ``pdm_tpu/ops/attention_block.py``. On CUDA tensors the
wrappers launch hand-written Hopper kernels that replace the TPU kernels
``_fwd_kernel`` (launched by ``_fab_fwd``) and ``_bwd_kernel`` (launched by
``_fab_bwd``), by one of two launch plans that :func:`block_route`, a pure
function of the geometry, picks:

* ``"cluster"``: head dims 16, 32 and 64, at most 8 heads, at most 256
  tokens. ``csrc/attention_block.cu`` (one launch) and
  ``csrc/attention_block_bwd.cu`` (three) keep one head's q, k and v tiles
  of a whole image in a block's shared memory, a cluster per image group.
* ``"staged"``: every other geometry the JAX gate admits (one head of 512
  in the 256x256 family, one head of 256, 16 or 64 heads of 8, 512 or 1024
  tokens). The block goes through device-memory scratch: the forward is
  ``csrc/attention_block_wide.cu``'s qkv projection, row 1's attention
  kernel on its column thirds, and the out projection with b_out and the
  residual (three launches); the backward recomputes qkv and att, projects
  datt = do W_out, runs row 2's two kernels into the column thirds of one
  (B, T, 3C) dqkv, projects dh = dqkv W_qkv, and ends with
  ``attention_block_bwd.cu``'s split-K weight gradients and their merge
  (eight launches). Rows 1 and 2 round where the block rounds (P
  normalized then rounded, att rounded; ds rounded, dq and dk scaled and
  then rounded once), so their kernels run unchanged inside it.

On CPU tensors the wrappers run :func:`attention_block_reference` and
:func:`attention_block_bwd_reference`, the plain PyTorch versions with the
TPU kernel's rounding points. They never fall back from one to the other.

Layout: x (the residual input) and h (the post-GroupNorm activations) are
(B, T, C); the projection weights are ``nn.Linear``'s (C_out, C_in), read
in place (``to_q/to_k/to_v.weight``, no concatenation); the biases may be
in the weights' dtype or fp32 (the JAX call site passes fp32 ones). The
output is (B, T, C) in x.dtype.

When grad is enabled and an input requires it, the call goes through an
``autograd.Function`` whose forward saves h, the weights, the biases and
the per-head row logsumexp (B, heads, T) fp32, as ``_fab_fwd`` does; its
backward returns dx = g exactly, db_out as the fp32 sum of the unrounded
g over (B, T) (``_fab_bwd``'s fix of the bf16-rounded sum), and the other
gradients from :func:`attention_block_bwd`. Launch counters:
``fused_attention_block.launches`` (forward kernels: one a call on the
cluster plan, three on the staged) and ``attention_block_bwd.launches``
(backward kernels: three, or eight), each raised by one where its kernel
is launched. The staged plan's row-1 and row-2 kernels count there, as the
block's, and not on ``fused_spatial_attention.launches`` or
``attention_bwd.launches``.

The bf16 cluster kernels run one launch plan (:func:`plan_block`, a pure
function of the shape; ``BlockPlan`` in ``csrc/attention_block_common.cuh``
takes it as it comes and refuses one the kernels cannot run): one
thread-block cluster per group of images, one block per head, two
warpgroups on 64-row strips. Above 64 tokens a group is one image (T / 64
strips, rounded up to an even count); at T <= 64 it is two strips of P = 64
/ Tr images each, Tr the power of two >= T, so that the mid block's T = 16
fills a 64-row ``wgmma`` tile with four images (:func:`tile_rows` maps a
group's tile rows to tokens). The bf16 wrappers also allocate the
device-memory scratches the kernels pass every head's att (forward) and the
row sums D (backward) through.

The path is opt-in, as in the JAX package:
:func:`use_fused_attention_block` opens only with ``PDM_FUSED_BLOCK=1``,
read at every call.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Sequence, Tuple

import torch
from torch import Tensor
from torch.autograd.function import once_differentiable

from . import _build
from . import attention as _attention
from .attention import MAX_FUSED_SCORE_CELLS, MAX_FUSED_TOKENS, MAX_SMEM_BYTES

# what the cluster kernels take: head dims they are instantiated for, at
# most 8 heads (one thread-block cluster per image, one block per head),
# and at most 256 tokens (one head's q, k, v and attention output stay in a
# block's shared memory); the staged plan takes the rest of the JAX gate's
# geometry
CLUSTER_HEAD_DIMS = (16, 32, 64)
CLUSTER_MAX_HEADS = 8
CLUSTER_MAX_TOKENS = 256
MAX_BLOCK_CHANNELS = 512  # the JAX gate's C <= 512

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# bf16 launch plan (csrc/attention_block_common.cuh): a three-stage TMA
# ring of 64-deep stages, a block's shared memory at most sm_90's opt-in
# (the kernels also check the device's)
KERNEL_STAGES = 3


# the staged plan's projection kernel (csrc/attention_block_wide.cu, bf16):
# 128 x 128 output tiles, a four-stage ring of 64-deep chunks (A's 128 x 64
# box and W's 128 x 64, 16 KB each), two 64 x 128 output staging tiles;
# statically the mbarriers and two tiles of fp32 bias
PROJECT_TILE = 128
PROJECT_STAGES = 4
PROJECT_STATIC_BYTES = 64 + 2 * 128 * 4


class ProjectPlan(NamedTuple):
    """One bf16 launch of the projection kernel; ``ProjPlan`` in
    csrc/attention_block_wide.cu has the same fields and refuses a plan
    that is not the shape's."""
    tiles: int      # 128 x 128 output tiles
    blocks: int     # the persistent grid: one block an SM, or a tile
    stages: int     # TMA ring depth
    smem: int       # dynamic shared memory bytes


def plan_project(R: int, nn_seg: int, n_seg: int, sms: int) -> ProjectPlan:
    """The bf16 projection's plan for R output rows and ``nn_seg`` N
    segments of ``n_seg`` columns on a card of ``sms`` SMs: a block an SM
    (at most one a tile) walks the 128 x 128 tiles, an output row tile's
    column tiles side by side, its two consumer warpgroups on a tile's
    64-row halves. Shared memory: the ring (32 KB a stage), the two
    warpgroups' 16 KB staging tiles, 1 KB of alignment."""
    tiles = -(-R // PROJECT_TILE) * nn_seg * -(-n_seg // PROJECT_TILE)
    smem = PROJECT_STAGES * 2 * PROJECT_TILE * 64 * 2 + 2 * 64 * PROJECT_TILE * 2 + 1024
    return ProjectPlan(tiles, min(tiles, sms), PROJECT_STAGES, smem)


class BlockPlan(NamedTuple):
    """One bf16 launch of the whole-block kernels; ``BlockPlan`` in
    csrc/attention_block_common.cuh has the same fields."""
    nc: int         # 64-key chunks of a query strip (1: packed images)
    strips: int     # 64-row strips of a block's tiles (even)
    trs: int        # log2 of a packed image's rows Tr (6 above 64 tokens)
    per_strip: int  # P: images per strip
    imgs: int       # images per group
    groups: int     # groups of images: the grid's clusters
    stages: int     # TMA ring depth
    smem: int       # dynamic shared memory bytes


def plan_block(B: int, T: int, hd: int, backward: bool) -> BlockPlan:
    """The bf16 launch plan of the forward (``backward`` False) or of the
    backward's first kernel at batch B, T tokens, head dim hd. Above 64
    tokens one image a cluster; at T <= 64 each 64-row strip packs P = 64 /
    Tr images Tr rows apart (Tr the power of two >= T) and a block takes two
    strips. Shared memory: the ring (a stage holds two 64 x 64 boxes of the
    activations and 3 hd weight rows of 64 columns, 2 hd backward), the
    head's q, k, v (and datt) tiles beside it, and 1 KB of alignment."""
    if T > 64:
        nc = -(-T // 64)
        strips, trs, per_strip, imgs = nc + (nc & 1), 6, 1, 1
    else:
        nc, strips, trs = 1, 2, (T - 1).bit_length()
        per_strip = 64 >> trs
        imgs = 2 * per_strip
    stage = 2 * 64 * 64 * 2 + (2 if backward else 3) * hd * 128
    tiles = (4 if backward else 3) * strips * 64 * hd * 2
    smem = KERNEL_STAGES * stage + tiles + 1024
    return BlockPlan(nc, strips, trs, per_strip, imgs, -(-B // imgs),
                     KERNEL_STAGES, smem)


def tile_rows(plan: BlockPlan, B: int, T: int, group: int) -> list:
    """(image, token) of every row of group ``group``'s tiles, None for
    padding: image ``group`` with token t at row t above 64 tokens; packed,
    image ``group * imgs + row // Tr`` with token ``row % Tr``. The kernels'
    ``PlainRows`` and ``PackedRows`` (csrc/attention_hopper.cuh) map rows
    so, and TMA reads the boxes of ``fwd_maps`` and ``bwd_maps`` so."""
    rows = []
    for r in range(plan.strips * 64):
        if plan.nc == 1:
            img, t = group * plan.imgs + (r >> plan.trs), r & ((1 << plan.trs) - 1)
        else:
            img, t = group, r
        rows.append((img, t) if t < T and img < B else None)
    return rows


def _project(h: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """h W^T + b in fp32, rounded once to h.dtype (``_qkv``)."""
    return (torch.matmul(h.float(), w.float().t()) + b.float()).to(h.dtype)


def _heads(t: Tensor, heads: int) -> Tensor:
    B, T, C = t.shape
    return t.reshape(B, T, heads, C // heads).transpose(1, 2).float()


def _merge(t: Tensor, dtype: torch.dtype) -> Tensor:
    B, heads, T, hd = t.shape
    return t.transpose(1, 2).reshape(B, T, heads * hd).to(dtype)


def _attend(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float
            ) -> Tuple[Tensor, Tensor]:
    """Per-head fp32 softmax attention; the normalized probabilities are
    rounded to q.dtype before P V, and the output is rounded to q.dtype
    (``_grouped_attention_fwd``). Returns (att, lse (B, heads, T))."""
    logits = torch.matmul(_heads(q, heads), _heads(k, heads).transpose(-1, -2))
    logits = logits * scale
    p = torch.softmax(logits, dim=-1).to(q.dtype).float()
    return (_merge(torch.matmul(p, _heads(v, heads)), q.dtype),
            torch.logsumexp(logits, dim=-1))


def _reference_with_lse(x, h, w_q, w_k, w_v, b_qkv, w_out, b_out, heads,
                        scale) -> Tuple[Tensor, Tensor]:
    q, k, v = (_project(h, w, b) for w, b in zip((w_q, w_k, w_v), b_qkv))
    att, lse = _attend(q, k, v, heads, scale)
    out = torch.matmul(att.float(), w_out.float().t()) + b_out.float()
    return (x.float() + out).to(x.dtype), lse


def attention_block_reference(
    x: Tensor, h: Tensor, w_q: Tensor, w_k: Tensor, w_v: Tensor,
    b_qkv: Sequence[Tensor], w_out: Tensor, b_out: Tensor, heads: int,
    scale: float,
) -> Tensor:
    """Plain PyTorch version of the TPU kernel ``_fwd_kernel``: qkv = h W
    + b in fp32 rounded to h.dtype; per-head fp32 softmax with the
    normalized P rounded before P V; the attention output rounded to
    h.dtype; x + (att W_out + b_out) in fp32, rounded once to x.dtype."""
    return _reference_with_lse(x, h, w_q, w_k, w_v, b_qkv, w_out, b_out,
                               heads, scale)[0]


def attention_block_bwd_reference(
    h: Tensor, w_q: Tensor, w_k: Tensor, w_v: Tensor,
    b_qkv: Sequence[Tensor], w_out: Tensor, lse: Tensor, g: Tensor,
    heads: int, scale: float,
) -> Tuple[Tensor, ...]:
    """Plain PyTorch version of the TPU kernel ``_bwd_kernel``: (dh, dw_q,
    dw_k, dw_v, db_q, db_k, db_v, dw_out), rounding where it rounds. The
    cotangent is rounded to h.dtype for every product; datt and the
    recomputed attention output are rounded; P = exp(s - lse) and ds are
    rounded; dq and dk are taken in fp32 times ``scale`` and the whole
    dqkv is rounded to h.dtype before dh, the weight and the bias
    gradients. Products accumulate in fp32. Weight and bias gradients come
    back in their parameters' dtypes, dh in h's; db_out is not here (the
    caller sums the unrounded g)."""
    dt = h.dtype
    ws, bs = (w_q, w_k, w_v), tuple(b_qkv)
    q, k, v = (_project(h, w, b) for w, b in zip(ws, bs))
    do = g.to(dt).float()
    datt = torch.matmul(do, w_out.float()).to(dt)
    att, _ = _attend(q, k, v, heads, scale)
    dw_out = torch.einsum("bto,bti->oi", do, att.float())

    qh, kh, vh, dah = (_heads(t, heads) for t in (q, k, v, datt))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None]).to(dt).float()
    dv = torch.matmul(p.transpose(-1, -2), dah)
    pdp = p * torch.matmul(dah, vh.transpose(-1, -2))
    ds = (pdp - p * pdp.sum(dim=-1, keepdim=True)).to(dt).float()
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dqkv = [_merge(t, dt).float() for t in (dq, dk, dv)]

    hf = h.float()
    dh = sum(torch.matmul(d, w.float()) for d, w in zip(dqkv, ws)).to(dt)
    dws = [torch.einsum("bto,bti->oi", d, hf).to(w.dtype)
           for d, w in zip(dqkv, ws)]
    dbs = [d.sum(dim=(0, 1)).to(b.dtype) for d, b in zip(dqkv, bs)]
    return (dh, *dws, *dbs, dw_out.to(w_out.dtype))


def block_route(T: int, C: int, heads: int):
    """The launch plan of a block of T tokens, C channels and ``heads``
    heads, in either dtype and direction: ``"cluster"`` where the cluster
    kernels take it (head dim 16, 32 or 64, at most 8 heads, at most 256
    tokens, as before the staged plan existed), ``"staged"`` for the rest
    of the JAX gate's geometry (:func:`use_fused_attention_block` without
    the opt-in), None for what that gate refuses."""
    if heads < 1 or C % heads or (C // heads) % 8 or C // heads < 8:
        return None
    if (C // heads in CLUSTER_HEAD_DIMS and heads <= CLUSTER_MAX_HEADS
            and 1 <= T <= CLUSTER_MAX_TOKENS):
        return "cluster"
    if _gate_geometry(T, C, heads):
        return "staged"
    return None


def _gate_geometry(T: int, C: int, heads: int) -> bool:
    """The JAX gate's geometry (``pdm_tpu/ops/attention_block.py:316-336``)."""
    return (
        T <= MAX_FUSED_TOKENS
        and heads * T * T <= MAX_FUSED_SCORE_CELLS
        and C % heads == 0
        and (C // heads) % 8 == 0
        and T % 8 == 0
        and C <= MAX_BLOCK_CHANNELS
    )


def _check(h, ws, bs, heads) -> str:
    """Validate a kernel call (CUDA tensors): h (B, T, C), the four
    weights ``ws`` (C, C) in h's dtype, the biases ``bs`` (C,) in one dtype
    of their own; returns the call's :func:`block_route`. Raises for a
    geometry the JAX gate refuses (and the cluster kernels do not take)."""
    if h.ndim != 3:
        raise ValueError(f"h must be (B, T, C): {tuple(h.shape)}")
    B, T, C = h.shape
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"activations must be float32 or bfloat16: {h.dtype}")
    if any(t.device != h.device for t in (*ws, *bs)):
        raise ValueError("the block's tensors must be on one device")
    route = block_route(T, C, heads)
    if route is None:
        if C % heads or (C // heads) % 8 or C // heads < 8:
            raise ValueError(f"head dim C/heads = {C}/{heads}: the kernels "
                             f"take multiples of 8")
        if T > MAX_FUSED_TOKENS or T % 8:
            raise ValueError(f"T = {T} tokens: the JAX gate admits multiples "
                             f"of 8 up to {MAX_FUSED_TOKENS}")
        if heads * T * T > MAX_FUSED_SCORE_CELLS:
            raise ValueError(f"{heads} heads at T = {T}: heads * T^2 above "
                             f"the JAX gate's {MAX_FUSED_SCORE_CELLS}")
        raise ValueError(f"C = {C} channels: the JAX gate admits at most "
                         f"{MAX_BLOCK_CHANNELS}")
    for w in ws:
        if w.shape != (C, C) or w.dtype != h.dtype:
            raise ValueError(f"weights must be ({C}, {C}) {h.dtype}: "
                             f"{tuple(w.shape)} {w.dtype}")
    for b in bs:
        if b.shape != (C,) or b.dtype not in _DTYPE_CODES:
            raise ValueError(f"biases must be ({C},) float32 or bfloat16: "
                             f"{tuple(b.shape)} {b.dtype}")
    if len({b.dtype for b in bs}) != 1:
        raise TypeError("the biases must share one dtype")
    return route


def _route(checked: str, route, h: Tensor, heads: int) -> str:
    """The plan a call on h runs: ``checked`` (:func:`_check`'s) unless
    ``route`` is "staged", which takes every geometry the gate admits."""
    if route is None:
        return checked
    if route != "staged" or not _gate_geometry(*h.shape[1:], heads):
        raise ValueError(f"route {route!r} at (T, C) {tuple(h.shape[1:])}, "
                         f"{heads} heads: only 'staged', inside the JAX gate")
    return route


def _ready(t: Tensor) -> Tensor:
    """Contiguous, 16-byte aligned storage (the kernels read 16-byte
    vectors); a copy only when the tensor is not already so."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(x, h, ws, bs, w_out, b_out, heads, scale
             ) -> Tuple[Tensor, Tensor]:
    """(out (B, T, C) in x.dtype, lse (B, heads, T) fp32); while
    ``torch.export`` traces, the custom op ``pdm::attention_block_fwd`` on
    every device."""
    if torch.compiler.is_exporting():
        return torch.ops.pdm.attention_block_fwd(
            x, h, *ws, *bs, w_out, b_out, heads, float(scale))
    if h.device.type == "cpu":
        tensors = (x, *ws, *bs, w_out, b_out)
        if any(t.device != h.device for t in tensors):
            raise ValueError("the block's tensors must be on one device")
        return _reference_with_lse(x, h, *ws, bs, w_out, b_out, heads, scale)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    return launch_fwd(x, h, ws, bs, w_out, b_out, heads, scale)


def launch_fwd(x, h, ws, bs, w_out, b_out, heads, scale, route=None
               ) -> Tuple[Tensor, Tensor]:
    """The forward kernel's launch on CUDA tensors, counted on
    ``fused_attention_block.launches``: the eager wrapper and the custom
    op's CUDA implementation (``ops/library.py``) both end here. ``route``
    None takes :func:`block_route`'s plan; "staged" forces the staged plan,
    which takes every geometry the JAX gate admits (chip_smoke.py times it
    beside the cluster plan at the cluster plan's shapes)."""
    if x.shape != h.shape or x.dtype != h.dtype or x.device != h.device:
        raise ValueError(f"x must match h: {tuple(x.shape)} {x.dtype} "
                         f"{x.device}, h {tuple(h.shape)} {h.dtype} {h.device}")
    route = _route(_check(h, (*ws, w_out), (*bs, b_out), heads), route, h,
                   heads)
    B, T, C = h.shape
    x, h, w_q, w_k, w_v, w_out = (_ready(t) for t in (x, h, *ws, w_out))
    b_q, b_k, b_v, b_out = (t.contiguous() for t in (*bs, b_out))
    dev = h.device
    out = torch.empty((B, T, C), dtype=x.dtype, device=dev)
    lse = torch.empty((B, heads, T), dtype=torch.float32, device=dev)
    if route == "staged":
        _staged_fwd(x, h, (w_q, w_k, w_v), (b_q, b_k, b_v), w_out, b_out,
                    heads, scale, out, lse)
        return out, lse
    plan, att = None, None
    if h.dtype == torch.bfloat16:  # every head's att passes through it
        plan = _CPlan(*plan_block(B, T, C // heads, backward=False))
        att = torch.empty((B, T, C), dtype=h.dtype, device=dev)
    fn = _build.entry("pdm_attention_block_fwd", _FWD_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), h.data_ptr(), w_q.data_ptr(), w_k.data_ptr(),
                 w_v.data_ptr(), b_q.data_ptr(), b_k.data_ptr(),
                 b_v.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), _ptr(att),
                 _plan_ref(plan), B, T, heads, C // heads, float(scale),
                 _DTYPE_CODES[h.dtype], _DTYPE_CODES[b_out.dtype], stream)
    _build.check(err, "pdm_attention_block_fwd")
    fused_attention_block.launches += 1
    return out, lse


def attention_block_bwd(
    h: Tensor, w_q: Tensor, w_k: Tensor, w_v: Tensor,
    b_qkv: Sequence[Tensor], w_out: Tensor, lse: Tensor, g: Tensor,
    heads: int, scale: float, route: str = None,
) -> Tuple[Tensor, ...]:
    """(dh, dw_q, dw_k, dw_v, db_q, db_k, db_v, dw_out) of the block for
    the cotangent ``g`` of its output, from the forward's lse. On CUDA
    tensors the cluster plan's three kernels (per group of images:
    recompute, the attention VJP and dh; then the weight and bias
    gradients as split-K partials over the B T rows; then their exact
    merge), or the staged plan's eight (:func:`_staged_bwd_attention`'s
    six, then the same two); the plain version on CPU tensors. ``route``
    as :func:`launch_fwd`'s."""
    B, T, C = h.shape
    ws, bs = (w_q, w_k, w_v), tuple(b_qkv)
    if h.device.type == "cpu":
        return attention_block_bwd_reference(h, *ws, bs, w_out, lse, g,
                                             heads, scale)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    route = _route(_check(h, (*ws, w_out), bs, heads), route, h, heads)
    if g.shape != h.shape or g.device != h.device:
        raise ValueError(f"g must be {tuple(h.shape)} on {h.device}: "
                         f"{tuple(g.shape)} on {g.device}")
    if (lse.shape != (B, heads, T) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != h.device):
        raise ValueError(f"lse must be contiguous float32 {(B, heads, T)}: "
                         f"{lse.dtype} {tuple(lse.shape)}")
    dt, dev = h.dtype, h.device
    h, w_q, w_k, w_v, w_out = (_ready(t) for t in (h, *ws, w_out))
    b_q, b_k, b_v = (t.contiguous() for t in bs)
    do = _ready(g.to(dt))
    # the block's per-image results: dqkv (the whole rounded (B, T, 3C)
    # gradient of the projection) and the recomputed attention output,
    # both read again by the weight-gradient kernel
    dqkv = torch.empty((B, T, 3 * C), dtype=dt, device=dev)
    att = torch.empty((B, T, C), dtype=dt, device=dev)
    dh = torch.empty((B, T, C), dtype=dt, device=dev)
    # fp32: q and datt parked for the dk/dv sweep; bf16: the row sums D
    scratch, plan, dsum = None, None, None
    if route == "staged":
        _staged_bwd_attention(h, (w_q, w_k, w_v), (b_q, b_k, b_v), w_out, lse,
                              do, heads, scale, dqkv, att, dh)
    elif dt == torch.float32:
        scratch = torch.empty((B, T, 2 * C), dtype=torch.float32, device=dev)
    else:
        plan = _CPlan(*plan_block(B, T, C // heads, backward=True))
        dsum = torch.empty((B, heads, T), dtype=torch.float32, device=dev)
    n_chunks = _weight_grad_chunks(
        B * T, C, dt == torch.bfloat16,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    partials = torch.empty((n_chunks, 4 * C * C + 3 * C), dtype=torch.float32,
                           device=dev)
    dws = [torch.empty((C, C), dtype=w.dtype, device=dev) for w in ws]
    dbs = [torch.empty((C,), dtype=b.dtype, device=dev) for b in bs]
    dw_out = torch.empty((C, C), dtype=w_out.dtype, device=dev)
    code, bcode = _DTYPE_CODES[dt], _DTYPE_CODES[b_q.dtype]
    fn_s1 = _build.entry("pdm_attention_block_bwd", _BWD_ARGS)
    fn_wg = _build.entry("pdm_attention_block_wgrad", _WGRAD_ARGS)
    fn_mg = _build.entry("pdm_attention_block_wgrad_merge", _MERGE_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "cluster":
            err = fn_s1(h.data_ptr(), w_q.data_ptr(), w_k.data_ptr(),
                        w_v.data_ptr(), b_q.data_ptr(), b_k.data_ptr(),
                        b_v.data_ptr(), w_out.data_ptr(), lse.data_ptr(),
                        do.data_ptr(), dqkv.data_ptr(), att.data_ptr(),
                        dh.data_ptr(), _ptr(scratch), _ptr(dsum),
                        _plan_ref(plan), B, T, heads, C // heads,
                        float(scale), code, bcode, stream)
            _build.check(err, "pdm_attention_block_bwd")
            attention_block_bwd.launches += 1
        err = fn_wg(h.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                    att.data_ptr(), partials.data_ptr(), B * T, C, n_chunks,
                    code, stream)
        _build.check(err, "pdm_attention_block_wgrad")
        attention_block_bwd.launches += 1
        err = fn_mg(partials.data_ptr(), dws[0].data_ptr(),
                    dws[1].data_ptr(), dws[2].data_ptr(), dw_out.data_ptr(),
                    dbs[0].data_ptr(), dbs[1].data_ptr(), dbs[2].data_ptr(),
                    C, n_chunks, _DTYPE_CODES[w_q.dtype], bcode, stream)
        _build.check(err, "pdm_attention_block_wgrad_merge")
        attention_block_bwd.launches += 1
    return (dh, *dws, *dbs, dw_out)


def _launch_project(counter, a: Sequence[Tensor], ws: Sequence[Tensor],
                    k_major: bool, out: Tensor, n_seg: int,
                    biases: Sequence[Tensor] = (), res: Tensor = None) -> None:
    """One launch of ``csrc/attention_block_wide.cu``'s projection: out
    (R rows, token-row stride ``out.stride(1)``) = sum over the K segments
    ``a`` (each (B, T, k_seg) with one shared row stride) of a W, W one of
    ``ws`` ((n_seg, k_seg) nn.Linear weights when ``k_major``, else read as
    (k_seg, n_seg)), one weight a K segment or an N segment of n_seg
    columns; plus the N segments' ``biases`` and the residual ``res``
    (out's layout), in fp32, rounded once to out's dtype. The launch counts
    on ``counter.launches``, the block's forward or backward counter."""
    B, T, k_seg = a[0].shape
    lda, ldo = a[0].stride(1), out.stride(1)
    nk, nn_ = len(a), len(ws) if len(a) == 1 else 1
    pa = [t.data_ptr() for t in a] + [None] * (3 - nk)
    pw = [w.data_ptr() for w in ws] + [None] * (3 - len(ws))
    pb = [b.data_ptr() for b in biases] + [None] * (3 - len(biases))
    bias_bf16 = int(bool(biases) and biases[0].dtype == torch.bfloat16)
    plan = None
    if out.dtype == torch.bfloat16:
        plan = _CProjectPlan(*plan_project(
            B * T, nn_, n_seg,
            torch.cuda.get_device_properties(out.device).multi_processor_count))
    fn = _build.entry("pdm_block_project", _PROJECT_ARGS)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(*pa, lda, nk, k_seg, *pw, int(k_major), *pb, bias_bf16,
                 _ptr(res), out.data_ptr(), ldo, B * T, nn_, n_seg,
                 _DTYPE_CODES[out.dtype], stream, _plan_ref(plan))
    _build.check(err, "pdm_block_project")
    counter.launches += 1


def _staged_fwd(x, h, ws, bs, w_out, b_out, heads, scale, out, lse) -> None:
    """The staged forward into ``out`` and ``lse``: qkv = h W^T + b into
    one (B, T, 3C) scratch, row 1's kernel on its column thirds (att into a
    (B, T, C) scratch), out = x + (att W_out^T + b_out)."""
    B, T, C = h.shape
    qkv = torch.empty((B, T, 3 * C), dtype=h.dtype, device=h.device)
    att = torch.empty((B, T, C), dtype=h.dtype, device=h.device)
    fwd = fused_attention_block
    _launch_project(fwd, (h,), ws, True, qkv, C, bs)
    q, k, v = qkv.split(C, dim=-1)
    _attention.launch_fwd_into(q, k, v, att, lse, heads, scale, fwd)
    _launch_project(fwd, (att,), (w_out,), True, out, C, (b_out,), res=x)


def _staged_bwd_attention(h, ws, bs, w_out, lse, do, heads, scale, dqkv, att,
                          dh) -> None:
    """The staged backward up to the weight gradients: qkv and att
    recomputed as the forward does (its lse rewritten into a scratch),
    datt = do W_out, row 2's kernels from the saved ``lse`` into the column
    thirds of ``dqkv``, dh = dqkv W_qkv."""
    B, T, C = h.shape
    qkv = torch.empty((B, T, 3 * C), dtype=h.dtype, device=h.device)
    datt = torch.empty((B, T, C), dtype=h.dtype, device=h.device)
    lse_again = torch.empty_like(lse)
    bwd = attention_block_bwd
    _launch_project(bwd, (h,), ws, True, qkv, C, bs)
    q, k, v = qkv.split(C, dim=-1)
    _attention.launch_fwd_into(q, k, v, att, lse_again, heads, scale, bwd)
    _launch_project(bwd, (do,), (w_out,), False, datt, C)
    dq, dk, dv = dqkv.split(C, dim=-1)
    _attention.launch_bwd_into(q, k, v, lse, datt, dq, dk, dv, heads, scale,
                               bwd)
    _launch_project(bwd, (dq, dk, dv), ws, False, dh, C)


def _weight_grad_chunks(rows: int, C: int, bf16: bool, sms: int) -> int:
    """Row chunks of the split-K weight-gradient kernel, each at least 256
    rows, on a card of ``sms`` SMs. bf16: one block an SM over its 128 x
    256 output tiles (3C/128 + C/128 rows of tiles, C/256 columns, each
    rounded up), the chunks no more than fill the SMs; fp32: about four
    blocks an SM over its (4C/64) x (C/64) tiles."""
    if bf16:
        tiles = (-(-3 * C // 128) + -(-C // 128)) * -(-C // 256)
        return max(1, min(sms // tiles, rows // 256, 64))
    tiles = -(-4 * C // 64) * -(-C // 64)
    return max(1, min(-(-4 * sms // tiles), rows // 256, 64))


class _BlockFn(torch.autograd.Function):
    """The forward's kernel (or plain version) with :func:`attention_block_bwd`
    as its VJP, as the JAX package's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, h, w_q, w_k, w_v, b_q, b_k, b_v, w_out, b_out, heads,
                scale):
        out, lse = _forward(x, h, (w_q, w_k, w_v), (b_q, b_k, b_v), w_out,
                            b_out, heads, scale)
        ctx.save_for_backward(h, w_q, w_k, w_v, b_q, b_k, b_v, w_out, lse)
        ctx.heads, ctx.scale, ctx.b_out_dtype = heads, scale, b_out.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h, w_q, w_k, w_v, b_q, b_k, b_v, w_out, lse = ctx.saved_tensors
        dh, dw_q, dw_k, dw_v, db_q, db_k, db_v, dw_out = attention_block_bwd(
            h, w_q, w_k, w_v, (b_q, b_k, b_v), w_out, lse, g, ctx.heads,
            ctx.scale)
        # db_out: the fp32 sum of the unrounded cotangent (_fab_bwd)
        db_out = g.float().sum(dim=(0, 1)).to(ctx.b_out_dtype)
        return (g, dh, dw_q, dw_k, dw_v, db_q, db_k, db_v, dw_out, db_out,
                None, None)


def fused_attention_block(
    x: Tensor, h: Tensor, w_q: Tensor, w_k: Tensor, w_v: Tensor,
    b_qkv: Sequence[Tensor], w_out: Tensor, b_out: Tensor, heads: int,
    scale: float,
) -> Tensor:
    """x + out_proj(attention(qkv_proj(h))) over (B, T, C); returns
    (B, T, C) in x.dtype. ``b_qkv`` holds the three (C,) projection
    biases. Kernel on CUDA tensors, plain version on CPU tensors;
    differentiable through :func:`attention_block_bwd`."""
    b_q, b_k, b_v = b_qkv
    args = (x, h, w_q, w_k, w_v, b_q, b_k, b_v, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _BlockFn.apply(*args, heads, scale)
    return _forward(x, h, (w_q, w_k, w_v), (b_q, b_k, b_v), w_out, b_out,
                    heads, scale)[0]


def use_fused_attention_block(T: int, C: int, heads: int) -> bool:
    """The JAX gate (``use_fused_attention_block``): opt-in through
    ``PDM_FUSED_BLOCK=1``, read at every call, and the geometry the TPU
    kernel admits. The JAX gate's "TPU backend" condition has no
    counterpart: the tensors' device chooses between kernel and plain
    version. The kernels take every geometry it admits
    (:func:`block_route`)."""
    if os.environ.get("PDM_FUSED_BLOCK", "0") != "1":
        return False
    return _gate_geometry(T, C, heads)


# kernel launches since the last reset (set to 0 to reset)
fused_attention_block.launches = 0
attention_block_bwd.launches = 0

class _CPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in BlockPlan._fields]


class _CProjectPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in ProjectPlan._fields]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _plan_ref(plan):
    return None if plan is None else ctypes.byref(plan)


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 14 + [_I] * 4 + [ctypes.c_float, _I, _I, _P]
_BWD_ARGS = [_P] * 16 + [_I] * 4 + [ctypes.c_float, _I, _I, _P]
_WGRAD_ARGS = [_P] * 5 + [_I] * 4 + [_P]
_MERGE_ARGS = [_P] * 8 + [_I] * 4 + [_P]
_PROJECT_ARGS = [_P] * 3 + [_I] * 3 + [_P] * 3 + [_I] + [_P] * 3 + [_I] + [_P] * 2 + [
    _I] * 4 + [_I, _P, _P]

"""The single-temperature Boltzmann moments kernel's wrapper.

Counterpart of ``pdm_tpu/ops/boltzmann_pallas.py``: it launches the
hand-written kernels of ``csrc/boltzmann_moments.cu`` (they replace the TPU
kernel ``_pallas_moments``) for :func:`ops.boltzmann.boltzmann_moments` on
CUDA tensors, in every precision mode: a partials kernel and a merge kernel
that joins the dataset's chunks exactly. Two launches per call, counted on
``boltzmann_moments.launches``.

The partials kernel is one of three, chosen by shape (:func:`plan_moments`,
a pure function of the call's mode, payload and sizes and of how many
blocks the card holds):

* fp32: the tall kernel, a block per 128 query rows and dataset chunk,
  whose Gram and payload products run the tall fp32 engine (8 x 8
  patches, its operands through TMA rings); the payload sums are added
  into device memory once per 128-column sub-tile and 128-column K-tile;
* bf16 and bf16_3x with a payload of K % 4 == 0 columns up to
  ``CLUSTER_MAX_K`` (3072: 8 blocks of 384 columns): the cluster kernel.
  A cluster of blocks shares a 64-row query tile and a chunk; each block
  computes the logits of its own 256-column tiles, and keeps its share of
  the payload sums in registers for the whole chunk;
* the bf16 modes' other calls (no payload, K % 4 != 0, or K above the
  threshold): the tiled kernel, a block per 64-row tile and chunk.

It also launches the posterior mean's VJP (``csrc/boltzmann_moments_vjp.cu``,
the backward of :class:`ops.boltzmann.PosteriorMean`) on one of two paths
(:func:`plan_vjp`, pure): fp32 calls with D <= ``VJP_SMALL_MAX_D`` run one
fused kernel, a thread a query row over a chunk of the dataset, then the
merge (2 launches); the others run, per segment of the dataset, a Grams
kernel (128 rows a block in fp32 on the tall engine, 64 in the bf16 modes
on the mma.sync tiles) that writes the weights w^T into a workspace of at
most ``VJP_WORKSPACE`` floats and a split-K product kernel w.Y, then the
merge (3 launches at one segment). Every launch counts on
``posterior_mean_vjp.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from . import _build
from . import boltzmann as _boltzmann
from .boltzmann import BoltzmannMoments
from .boltzmann_sweep import (
    MODE_CODES, TALL_TILE_ROWS, TILE_COLS, TILE_ROWS, PreparedY,
    _resident_blocks, check_pack, pack, round_up, split_chunks,
)
from .precision import split

# the payload's form, as the kernel takes it: none, K % 4 == 0 on 16-byte
# aligned rows (16-byte copies), any K (4-byte copies)
PAYLOAD_NONE, PAYLOAD_VEC4, PAYLOAD_SCALAR = 0, 1, 2

CLUSTER_TILE_COLS = 256  # dataset columns of a cluster kernel's tile
CLUSTER_WIDTHS = (128, 384)  # payload columns a cluster kernel's block holds
CLUSTER_MAX = 8  # blocks per cluster (the portable limit)
# the largest payload the cluster kernel holds on chip: the threshold above
# which the bf16 modes run the tiled kernel
CLUSTER_MAX_K = CLUSTER_MAX * CLUSTER_WIDTHS[-1]


class MomentsPlan(NamedTuple):
    """How one call runs: the partials kernel and the dataset's split."""

    kernel: str  # "tall", "cluster" or "tiled"
    cluster: int  # blocks per cluster (1 but for the cluster kernel)
    width: int  # payload columns per block (cluster kernel; else 0)
    tile_rows: int  # query rows per block
    tile_cols: int  # dataset columns per tile of a chunk
    n_chunks: int
    per_chunk: int  # tiles per chunk


def kernel_choice(mode: str, payload: int, K: int) -> Tuple[str, int, int]:
    """(kernel, blocks per cluster, payload columns per block) for a call's
    precision mode, payload form (PAYLOAD_*) and payload width K."""
    if mode == "fp32":
        return "tall", 1, 0
    if payload == PAYLOAD_VEC4 and K <= CLUSTER_MAX_K:
        width = CLUSTER_WIDTHS[0] if K <= CLUSTER_MAX * CLUSTER_WIDTHS[0] \
            else CLUSTER_WIDTHS[1]
        return "cluster", -(-K // width), width
    return "tiled", 1, 0


def _tile_rows(kernel: str) -> int:
    return TALL_TILE_ROWS if kernel == "tall" else TILE_ROWS


def plan_moments(mode: str, payload: int, K: int, n_rows: int, n_pad: int,
                 slots: int) -> MomentsPlan:
    """The launch plan of a call with ``n_rows`` queries over a dataset
    padded to ``n_pad`` columns, where the card holds ``slots`` blocks
    (tall, tiled) or clusters of the chosen kernel."""
    kernel, cluster, width = kernel_choice(mode, payload, K)
    rows = _tile_rows(kernel)
    tile = CLUSTER_TILE_COLS if kernel == "cluster" else TILE_COLS
    n_chunks, per_chunk = split_chunks(slots, -(-n_rows // rows), -(-n_pad // tile))
    return MomentsPlan(kernel, cluster, width, rows, tile, n_chunks, per_chunk)


def _refuse_grad(**tensors) -> None:
    for name, t in tensors.items():
        if isinstance(t, Tensor) and t.requires_grad:
            raise ValueError(
                f"boltzmann_moments: {name} requires grad, but the moments "
                f"kernel has no backward; the dataset's posterior mean is "
                f"differentiable through ops.boltzmann.PosteriorMean "
                f"(true_posterior_mean_x0 under grad); detach it otherwise")


def _payload(values: Optional[Tensor], prep: PreparedY,
             dev: torch.device) -> Optional[Tensor]:
    if values is None:
        return None
    v = values.reshape(values.shape[0], -1)
    if v.shape[0] != prep.n or v.device != dev:
        raise ValueError(f"values must be (N, K) with N = {prep.n}, on {dev}: "
                         f"{tuple(values.shape)} on {values.device}")
    return v.to(torch.float32).contiguous()


class MomentsOperands(NamedTuple):
    """What one launch pair reads, in the kernel's layouts."""

    x_hi: Tensor  # (D, Bp) fp32 or bf16: the queries transposed, 0-padded
    x_lo: Optional[Tensor]  # (D, Bp) bf16, "bf16_3x" only
    prep: PreparedY  # the dataset
    row: Tensor  # (3, Bp) fp32: 0.5|x|^2, inv_temp, y_scale per row
    values: Optional[Tensor]  # (N, K) fp32 row-major payload
    payload: int  # PAYLOAD_*
    n_rows: int  # B


def operands(x: Tensor, y, inv_temp, y_scale=1.0, *,
             values: Optional[Tensor] = None, compute_mean: bool = False,
             mode: str) -> MomentsOperands:
    """Check and lay out a call's inputs for the kernels (``y`` a raw
    dataset (N, ...) or its :class:`PreparedY` for ``mode``)."""
    _refuse_grad(x=x, y=y.yt_hi if isinstance(y, PreparedY) else y,
                 values=values, inv_temp=inv_temp, y_scale=y_scale)
    if isinstance(y, PreparedY):
        if compute_mean and values is None:
            raise ValueError("compute_mean with a PreparedY needs explicit "
                             "values (the pack holds the transposed dataset)")
    elif compute_mean and values is None:
        values = y
    dev = x.device
    prep = pack(y, mode)
    check_pack(prep, dev)
    B = x.shape[0]
    xf = x.reshape(B, -1).to(torch.float32)
    D = xf.shape[1]
    if prep.d != D:
        raise ValueError(f"x is (B, D) = {tuple(xf.shape)}; the dataset's D "
                         f"is {prep.d}")
    v = _payload(values, prep, dev)
    if v is None:
        payload = PAYLOAD_NONE
    elif v.shape[1] % 4 == 0 and v.data_ptr() % 16 == 0:
        payload = PAYLOAD_VEC4
    else:
        payload = PAYLOAD_SCALAR
    K = 0 if v is None else v.shape[1]
    b_pad = round_up(B, _tile_rows(kernel_choice(prep.mode, payload, K)[0]))
    xt = torch.zeros((D, b_pad), dtype=torch.float32, device=dev)
    xt[:, :B] = xf.T
    x_hi, x_lo = split(xt, prep.mode)
    # per-row terms; padded rows get 0.5|0|^2, inv_temp 0 and scale 1
    # (the TPU kernel's padding), harmless and never read
    row = torch.zeros((3, b_pad), dtype=torch.float32, device=dev)
    row[2] = 1.0
    row[0, :B] = 0.5 * torch.sum(xf * xf, dim=1)
    row[1, :B] = torch.as_tensor(inv_temp, dtype=torch.float32, device=dev)
    row[2, :B] = torch.as_tensor(y_scale, dtype=torch.float32, device=dev)
    return MomentsOperands(x_hi, x_lo, prep, row, v, payload, B)


@functools.lru_cache(maxsize=None)
def _cluster_slots(device_index: int, mode_code: int, width: int,
                   cluster: int) -> int:
    """Clusters of the cluster kernel the card holds at once."""
    n = ctypes.c_int(0)
    name = "pdm_boltzmann_moments_cluster_slots"
    fn = _build.entry(name, [_I, _I, _I, ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(device_index):
        _build.check(fn(mode_code, width, cluster, ctypes.byref(n)), name)
    if n.value < 1:
        raise RuntimeError(f"{name}: the card holds no cluster of {cluster} "
                           f"blocks (mode {mode_code}, width {width})")
    return n.value


def device_plan(ops: MomentsOperands) -> MomentsPlan:
    """plan_moments for laid-out operands on their card."""
    dev = ops.x_hi.device
    K = 0 if ops.values is None else ops.values.shape[1]
    kernel, cluster, width = kernel_choice(ops.prep.mode, ops.payload, K)
    idx, code = dev.index or 0, MODE_CODES[ops.prep.mode]
    if kernel == "cluster":
        slots = _cluster_slots(idx, code, width, cluster)
    else:
        slots = _resident_blocks("moments_tall" if kernel == "tall" else "moments",
                                 idx, code, ops.payload)
    return plan_moments(ops.prep.mode, ops.payload, K, ops.n_rows,
                        ops.prep.yt_hi.shape[1], slots)


def launch(ops: MomentsOperands) -> BoltzmannMoments:
    """The partials and merge launches on laid-out operands."""
    prep, v, B = ops.prep, ops.values, ops.n_rows
    dev = ops.x_hi.device
    D, b_pad = ops.x_hi.shape
    n_pad = prep.yt_hi.shape[1]
    K = 0 if v is None else v.shape[1]
    plan = device_plan(ops)
    n_chunks, per_chunk = plan.n_chunks, plan.per_chunk
    partials = torch.empty((n_chunks, 4, b_pad), dtype=torch.float32, device=dev)
    out = torch.empty((4, B), dtype=torch.float32, device=dev)
    sy = mean = None
    if v is not None:
        sy = torch.empty((n_chunks, b_pad, K), dtype=torch.float32, device=dev)
        mean = torch.empty((B, K), dtype=torch.float32, device=dev)

    def ptr(t: Optional[Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (ptr(ops.x_hi), ptr(ops.x_lo), ptr(prep.yt_hi), ptr(prep.yt_lo),
                ptr(prep.ysq), ptr(ops.row[0]), ptr(ops.row[1]), ptr(ops.row[2]),
                ptr(v), ptr(partials), ptr(sy), b_pad, D, n_pad, prep.n, K,
                n_chunks, per_chunk, MODE_CODES[prep.mode])
        if plan.kernel == "cluster":
            name = "pdm_boltzmann_moments_cluster"
            err = _build.entry(name, _CLUSTER_ARGS)(
                *args, plan.width, plan.cluster, stream)
        else:
            name = ("pdm_boltzmann_moments_tall" if plan.kernel == "tall"
                    else "pdm_boltzmann_moments_partials")
            err = _build.entry(name, _PARTIALS_ARGS)(*args, ops.payload, stream)
        _build.check(err, name)
        _boltzmann.boltzmann_moments.launches += 1
        fn = _build.entry("pdm_boltzmann_moments_merge", _MERGE_ARGS)
        err = fn(ptr(partials), ptr(sy), ptr(out), ptr(mean), B, b_pad,
                 n_chunks, K, stream)
        _build.check(err, "pdm_boltzmann_moments_merge")
        _boltzmann.boltzmann_moments.launches += 1
    return BoltzmannMoments(log_z=out[0], shift=out[1], e1_hat=out[2],
                            e2_hat=out[3], mean=mean)


def boltzmann_moments_cuda(x: Tensor, y, inv_temp, y_scale=1.0, *,
                           values: Optional[Tensor] = None,
                           compute_mean: bool = False,
                           mode: str) -> BoltzmannMoments:
    """The kernel on CUDA tensors (see ``ops.boltzmann.boltzmann_moments``)."""
    return launch(operands(x, y, inv_temp, y_scale, values=values,
                           compute_mean=compute_mean, mode=mode))


# ---------------------------------------------------------------------------
# the posterior mean's VJP

# fp32 calls with D <= VJP_SMALL_MAX_D take the small-D kernel: per pair a
# few FFMAs and the epilogue, with no 128-wide tiles of zeros (the schedule
# CLI's D = 1); the bf16 modes keep their mma.sync Grams at every D
VJP_SMALL_MAX_D = 4
# floats of w^T one pass of the large-D path holds; a larger call runs the
# Grams and the product once per segment of the dataset (a pass holds at
# least one 128-column sub-tile)
VJP_WORKSPACE = 1 << 26
VJP_KERNEL_GRAMS, VJP_KERNEL_PRODUCT = 0, 1  # the large-D kernels' codes


def vjp_path(mode: str, D: int) -> str:
    """"small" (one fused kernel) or "large" (the Grams, then the product)."""
    return "small" if mode == "fp32" and D <= VJP_SMALL_MAX_D else "large"


class VjpPlan(NamedTuple):
    """How one VJP call runs."""

    path: str  # "small" or "large"
    tile_rows: int  # query rows per block of the first kernel
    b_pad: int  # rows padded to a multiple of 128 (the product's tile)
    segments: Tuple[Tuple[int, int], ...]  # (first sub-tile, sub-tiles) a pass
    per_chunk: int  # 128-column sub-tiles per chunk of the first kernel
    n_chunks: int  # its chunks over all passes
    # the chunks of the sums of w y: the product's split over K (on the
    # small path the small kernel's own chunks)
    product_per_chunk: int
    product_chunks: int  # over all passes
    workspace: int  # floats of w^T a pass holds (0 on the small path)
    launches: int


def _pass_chunks(segments, per_chunk: int) -> int:
    return sum(-(-n // per_chunk) for _, n in segments)


def plan_vjp(mode: str, n_rows: int, D: int, n_pad: int, slots: int,
             product_slots: int = 1) -> VjpPlan:
    """The launch plan of a VJP over ``n_rows`` queries of ``D`` dimensions
    and a dataset padded to ``n_pad`` columns, where the card holds
    ``slots`` blocks of the path's first kernel and ``product_slots`` of
    the product's. The small-D path: one kernel over the dataset in chunks,
    then the merge (2 launches). The large-D path: per segment of at most
    VJP_WORKSPACE / b_pad columns (whole sub-tiles, the segments as even as
    whole sub-tiles allow), the Grams kernel and the product, then the
    merge (2 per segment + 1); each kernel's chunks are split_chunks' for
    the largest segment."""
    path = vjp_path(mode, D)
    # query rows per block of the first kernel: one a thread on the small-D
    # path, the tall fp32 engine's 128, the mma.sync tiles' 64 (bf16 modes)
    rows = TALL_TILE_ROWS if mode == "fp32" else TILE_ROWS
    b_pad = round_up(n_rows, TALL_TILE_ROWS)
    n_tiles = -(-n_pad // TILE_COLS)
    if path == "small":
        segments = ((0, n_tiles),)
        _, per = split_chunks(slots, b_pad // rows, n_tiles)
        n = _pass_chunks(segments, per)
        return VjpPlan(path, rows, b_pad, segments, per, n, per, n, 0, 2)
    most = max(1, VJP_WORKSPACE // (b_pad * TILE_COLS))
    n_seg = -(-n_tiles // most)
    seg = -(-n_tiles // n_seg)
    segments = tuple((k * seg, min(seg, n_tiles - k * seg)) for k in range(n_seg))
    _, per = split_chunks(slots, b_pad // rows, seg)
    out_tiles = (b_pad // TALL_TILE_ROWS) * -(-D // TILE_COLS)
    _, p_per = split_chunks(product_slots, out_tiles, seg)
    return VjpPlan(path, rows, b_pad, segments, per, _pass_chunks(segments, per),
                   p_per, _pass_chunks(segments, p_per), seg * TILE_COLS * b_pad,
                   2 * n_seg + 1)


class VjpOperands(NamedTuple):
    """What one VJP call reads, in the kernels' layouts."""

    x_hi: Tensor  # (D, Bp): the queries transposed, 0-padded, the forward's split
    x_lo: Optional[Tensor]
    c_hi: Tensor  # (D, Bp): the cotangent, likewise
    c_lo: Optional[Tensor]
    prep: PreparedY  # the dataset's pack
    rows: Tensor  # (5, Bp) fp32: 0.5|x|^2, inv_temp, y_scale, log_z, c.mean
    y: Optional[Tensor]  # (N, ldy) fp32 row-major (the product's; None on the small path)
    xf: Tensor  # (B, D) fp32: the queries


def vjp_operands(x: Tensor, y, inv_temp, y_scale, log_z: Tensor,
                 mean: Tensor, cot: Tensor, *, values: Optional[Tensor] = None,
                 mode: str) -> VjpOperands:
    """Check and lay out a VJP call's inputs (``y`` the dataset or its
    :class:`PreparedY` for ``mode`` with the dataset as ``values``). The
    product reads the dataset row-major through TMA, whose rows must be 16
    bytes apart and aligned: a dataset of D % 4 != 0 (or misaligned) is
    copied once per call into rows padded to a multiple of 4."""
    if isinstance(y, PreparedY):
        if values is None:
            raise ValueError("the VJP with a PreparedY needs the dataset "
                             "itself as values")
        rows_y = values
    else:
        rows_y = y if values is None else values
    dev = x.device
    prep = pack(y, mode)
    check_pack(prep, dev)
    B = x.shape[0]
    xf = x.reshape(B, -1).to(torch.float32).contiguous()
    cf = cot.reshape(B, -1).to(torch.float32)
    D = xf.shape[1]
    yv = _payload(rows_y, prep, dev)
    if prep.d != D or yv.shape[1] != D or cf.shape[1] != D:
        raise ValueError(f"x, the cotangent and the dataset must share D = "
                         f"{prep.d}: {tuple(xf.shape)}, {tuple(cf.shape)}, "
                         f"{tuple(yv.shape)}")
    b_pad = round_up(B, TALL_TILE_ROWS)

    def transposed(t: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
        if b_pad == B:
            tt = t.T.contiguous()
        else:
            tt = torch.zeros((D, b_pad), dtype=torch.float32, device=dev)
            tt[:, :B] = t.T
        return split(tt, prep.mode)

    x_hi, x_lo = transposed(xf)
    c_hi, c_lo = transposed(cf)

    def per_row(v) -> Tensor:
        return torch.as_tensor(v, dtype=torch.float32, device=dev).expand(B)

    # 0.5|x|^2 as the forward's operands() sums it (the logits are its own)
    terms = torch.stack([
        0.5 * torch.sum(xf * xf, dim=1), per_row(inv_temp), per_row(y_scale),
        log_z.to(torch.float32),
        torch.sum(cf * mean.reshape(B, -1).to(torch.float32), dim=1)])
    if b_pad == B:
        rows = terms
    else:  # padded rows: inv_temp 0, scale 1, a zero cotangent; never read
        rows = torch.zeros((5, b_pad), dtype=torch.float32, device=dev)
        rows[2] = 1.0
        rows[:, :B] = terms
    y_rows = None
    if vjp_path(prep.mode, D) == "large":
        y_rows = yv
        if D % 4 != 0 or yv.data_ptr() % 16 != 0:
            y_rows = torch.zeros((prep.n, round_up(D, 4)), dtype=torch.float32,
                                 device=dev)
            y_rows[:, :D] = yv
    return VjpOperands(x_hi, x_lo, c_hi, c_lo, prep, rows, y_rows, xf)


def vjp_device_plan(ops: VjpOperands) -> VjpPlan:
    """plan_vjp for laid-out operands on their card."""
    dev, mode, D = ops.x_hi.device, ops.prep.mode, ops.xf.shape[1]
    idx, code = dev.index or 0, MODE_CODES[mode]
    if vjp_path(mode, D) == "small":
        slots = _resident_blocks("moments_vjp", idx, code, 2 + D)
        product_slots = 1
    else:
        slots = _resident_blocks("moments_vjp", idx, code, VJP_KERNEL_GRAMS)
        product_slots = _resident_blocks("moments_vjp", idx, code,
                                         VJP_KERNEL_PRODUCT)
    return plan_vjp(mode, ops.xf.shape[0], D, ops.prep.yt_hi.shape[1], slots,
                    product_slots)


def vjp_launch(ops: VjpOperands) -> _boltzmann.MeanVJP:
    """The VJP's launches on laid-out operands (:func:`plan_vjp`)."""
    prep = ops.prep
    dev = ops.x_hi.device
    D, b_pad = ops.x_hi.shape
    B = ops.xf.shape[0]
    n_pad = prep.yt_hi.shape[1]
    plan = vjp_device_plan(ops)
    small = plan.path == "small"
    partials = torch.empty((plan.n_chunks, 3, b_pad), dtype=torch.float32,
                           device=dev)
    sy = torch.empty((plan.product_chunks, b_pad, D), dtype=torch.float32,
                     device=dev)
    dx = torch.empty((B, D), dtype=torch.float32, device=dev)
    dpar = torch.empty((2, B), dtype=torch.float32, device=dev)
    w = None if small else torch.empty((plan.workspace // b_pad, b_pad),
                                       dtype=torch.float32, device=dev)

    def ptr(t: Optional[Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    def run(name: str, args, err_args) -> None:
        _build.check(_build.entry(name, args)(*err_args), name)
        _boltzmann.posterior_mean_vjp.launches += 1

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        chunk0 = p_chunk0 = 0
        for sub0, n_sub in plan.segments:
            if small:
                run("pdm_boltzmann_moments_vjp_small", _VJP_SMALL_ARGS, (
                    ptr(ops.x_hi), ptr(ops.c_hi), ptr(prep.yt_hi), ptr(prep.ysq),
                    ptr(ops.rows), ptr(partials), ptr(sy), b_pad, D, n_pad, prep.n,
                    sub0, n_sub, plan.per_chunk, chunk0, stream))
            else:
                run("pdm_boltzmann_moments_vjp_grams", _VJP_GRAMS_ARGS, (
                    ptr(ops.x_hi), ptr(ops.x_lo), ptr(ops.c_hi), ptr(ops.c_lo),
                    ptr(prep.yt_hi), ptr(prep.yt_lo), ptr(prep.ysq), ptr(ops.rows),
                    ptr(partials), ptr(w), b_pad, D, n_pad, prep.n, sub0, n_sub,
                    plan.per_chunk, chunk0, MODE_CODES[prep.mode], stream))
                run("pdm_boltzmann_moments_vjp_product", _VJP_PRODUCT_ARGS, (
                    ptr(w), ptr(ops.y), ptr(sy), b_pad, D, ops.y.shape[1], prep.n,
                    sub0, n_sub, plan.product_per_chunk, p_chunk0, stream))
            chunk0 += -(-n_sub // plan.per_chunk)
            p_chunk0 += -(-n_sub // plan.product_per_chunk)
        run("pdm_boltzmann_moments_vjp_merge", _VJP_MERGE_ARGS, (
            ptr(partials), ptr(sy), ptr(ops.rows), ptr(ops.xf), ptr(dx), ptr(dpar),
            B, b_pad, D, plan.n_chunks, plan.product_chunks, stream))
    return _boltzmann.MeanVJP(x=dx, inv_temp=dpar[0], y_scale=dpar[1])


def posterior_mean_vjp_cuda(x: Tensor, y, inv_temp, y_scale, log_z: Tensor,
                            mean: Tensor, cot: Tensor, *,
                            values: Optional[Tensor] = None,
                            mode: str) -> _boltzmann.MeanVJP:
    """The VJP kernels on CUDA tensors (see
    ``ops.boltzmann.posterior_mean_vjp``)."""
    return vjp_launch(vjp_operands(x, y, inv_temp, y_scale, log_z, mean, cot,
                                   values=values, mode=mode))


_P, _I = ctypes.c_void_p, ctypes.c_int
_PARTIALS_ARGS = [_P] * 11 + [_I] * 9 + [_P]
_CLUSTER_ARGS = [_P] * 11 + [_I] * 10 + [_P]
_MERGE_ARGS = [_P] * 4 + [_I] * 4 + [_P]
_VJP_SMALL_ARGS = [_P] * 7 + [_I] * 8 + [_P]
_VJP_GRAMS_ARGS = [_P] * 10 + [_I] * 9 + [_P]
_VJP_PRODUCT_ARGS = [_P] * 3 + [_I] * 8 + [_P]
_VJP_MERGE_ARGS = [_P] * 6 + [_I] * 5 + [_P]

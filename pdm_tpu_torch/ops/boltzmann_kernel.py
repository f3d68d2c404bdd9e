"""The single-temperature Boltzmann moments kernel's wrapper.

Counterpart of ``pdm_tpu/ops/boltzmann_pallas.py``: it launches the
hand-written kernels of ``csrc/boltzmann_moments.cu`` (they replace the TPU
kernel ``_pallas_moments``) for :func:`ops.boltzmann.boltzmann_moments` on
CUDA tensors, in every precision mode: a partials kernel, where each block
owns one 64-row query tile and one chunk of the dataset, and a merge kernel
that joins the chunks exactly. Two launches per call, counted on
``boltzmann_moments.launches``.

The dataset goes in as the sweep's pack (``ops/boltzmann_sweep.prepare_y``:
transposed to (D, Np), padded to 128-column tiles, bf16 hi/lo for the bf16
modes, half squared norms); a raw dataset is packed per call, so a caller
that reuses one dataset (``models/base.py::TrueDDPM``) passes its pack. The
payload is read as it is, (N, K) fp32 row-major: with ``compute_mean`` on a
raw dataset it is the dataset itself, never a copy. The kernel has no
backward (nor has the TPU kernel), so an input that requires grad raises
rather than being detached.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from . import _build
from . import boltzmann as _boltzmann
from .boltzmann import BoltzmannMoments
from .boltzmann_sweep import (
    MODE_CODES, TILE_COLS, TILE_ROWS, PreparedY, check_pack, chunks, pack,
    round_up,
)
from .precision import split

# the payload's form, as the kernel takes it: none, K % 4 == 0 on 16-byte
# aligned rows (16-byte copies), any K (4-byte copies)
PAYLOAD_NONE, PAYLOAD_VEC4, PAYLOAD_SCALAR = 0, 1, 2


def _refuse_grad(**tensors) -> None:
    for name, t in tensors.items():
        if isinstance(t, Tensor) and t.requires_grad:
            raise ValueError(
                f"boltzmann_moments: {name} requires grad, but the moments "
                f"kernel has no backward; detach it or run the plain "
                f"version (boltzmann_moments_reference) on the CPU")


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
    b_pad = round_up(B, TILE_ROWS)
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


def launch(ops: MomentsOperands) -> BoltzmannMoments:
    """The partials and merge launches on laid-out operands."""
    prep, v, B = ops.prep, ops.values, ops.n_rows
    dev = ops.x_hi.device
    D, b_pad = ops.x_hi.shape
    n_pad = prep.yt_hi.shape[1]
    K = 0 if v is None else v.shape[1]
    n_chunks, per_chunk = chunks("moments", dev, prep.mode, ops.payload,
                                 b_pad // TILE_ROWS, n_pad // TILE_COLS)
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
        fn = _build.entry("pdm_boltzmann_moments_partials", _PARTIALS_ARGS)
        err = fn(ptr(ops.x_hi), ptr(ops.x_lo), ptr(prep.yt_hi), ptr(prep.yt_lo),
                 ptr(prep.ysq), ptr(ops.row[0]), ptr(ops.row[1]), ptr(ops.row[2]),
                 ptr(v), ptr(partials), ptr(sy), b_pad, D, n_pad, prep.n, K,
                 n_chunks, per_chunk, MODE_CODES[prep.mode], ops.payload, stream)
        _build.check(err, "pdm_boltzmann_moments_partials")
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


_P, _I = ctypes.c_void_p, ctypes.c_int
_PARTIALS_ARGS = [_P] * 11 + [_I] * 9 + [_P]
_MERGE_ARGS = [_P] * 4 + [_I] * 4 + [_P]

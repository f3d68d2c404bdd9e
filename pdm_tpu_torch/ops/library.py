"""The sampler's forward kernels as ``torch.library`` custom ops.

``torch.export`` cannot trace a ``ctypes`` call, so an exported sampler
step (``utils/serving.py``) reaches the kernels through four custom ops,
registered when this module is imported (``import pdm_tpu_torch.ops``
imports it):

* ``pdm::attention_fwd`` (row 1): multi-head attention, (out, lse);
* ``pdm::group_norm_act`` (row 3): GroupNorm with an optional SiLU;
* ``pdm::attention_block_fwd`` (row 5): the whole attention block,
  (out, lse);
* ``pdm::boltzmann_moments`` (row 7): one temperature's Boltzmann moments
  over a dataset's kernel pack, (log_z, shift, e1_hat, e2_hat) as one
  (4, B) tensor and the payload's mean (B, K), (B, 0) without a payload.

Each has three implementations: on CUDA tensors the kernel's launch
function (``launch_fwd`` / ``launch_raw`` in the wrapper's module, which
holds every check that reads a pointer and counts the launch), on CPU
tensors the plain version, unchanged, and a fake one that gives shapes and
dtypes alone. None gives way to another.

The public wrappers (``fused_spatial_attention``, ``fused_group_norm_act``,
``fused_attention_block``, ``boltzmann_moments``) call an op only while
``torch.export`` traces (``torch.compiler.is_exporting()``), so that the
exported graph holds the op's node; eagerly they launch directly, off the
dispatcher, as before. Both routes end in the same launch function: a
trace counts nothing, and a replay counts every launch.

Row 7's op takes tensors and scalars only: the queries (B, D), the pack's
``yt_hi`` (D, Np), ``yt_lo`` (bf16_3x only), ``ysq`` (Np,) and true N, the
precision mode, the per-row ``inv_temp`` and ``y_scale`` (B,) and the
optional payload (N, K). Its CUDA implementation lays them out for the
kernel (``ops/boltzmann_kernel.py::operands``, the payload's 16-byte
vector form among them). Its CPU implementation reads the dataset back
from the pack, exactly from an fp32 pack (``traced_moments`` gives the CPU an
fp32 pack in every mode; a bf16 pack reads back as hi + lo), and runs the
plain version in the given mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from . import attention as _attention
from . import attention_block as _block
from . import groupnorm as _groupnorm
from .boltzmann import BoltzmannMoments, _per_row, boltzmann_moments_reference
from .boltzmann_sweep import PreparedY, pack, prepare_y

# ---- row 1 -----------------------------------------------------------------

@torch.library.custom_op("pdm::attention_fwd", mutates_args=(),
                         device_types="cpu")
def attention_op(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float
                 ) -> Tuple[Tensor, Tensor]:
    """(out (B, T, C) in q.dtype, lse (B, heads, T) fp32)."""
    return _attention._reference_with_lse(q, k, v, heads, scale)


@attention_op.register_kernel("cuda")
def _(q, k, v, heads, scale):
    return _attention.launch_fwd(q, k, v, heads, scale)


@attention_op.register_fake
def _(q, k, v, heads, scale):
    B, T, C = q.shape
    return (q.new_empty((B, T, C)),
            q.new_empty((B, heads, T), dtype=torch.float32))


# ---- row 3 -----------------------------------------------------------------

@torch.library.custom_op("pdm::group_norm_act", mutates_args=(),
                         device_types="cpu")
def group_norm_op(x: Tensor, scale: Tensor, bias: Tensor, groups: int,
                  eps: float, act: str) -> Tensor:
    """GroupNorm(+SiLU) of (B, S, C) ``x``, in x.dtype."""
    return _groupnorm.group_norm_reference(x, scale, bias, groups, eps,
                                           act).to(x.dtype)


@group_norm_op.register_kernel("cuda")
def _(x, scale, bias, groups, eps, act):
    return _groupnorm.launch_fwd(x, scale, bias, groups, eps, act)


@group_norm_op.register_fake
def _(x, scale, bias, groups, eps, act):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# ---- row 5 -----------------------------------------------------------------

@torch.library.custom_op("pdm::attention_block_fwd", mutates_args=(),
                         device_types="cpu")
def block_op(x: Tensor, h: Tensor, w_q: Tensor, w_k: Tensor, w_v: Tensor,
             b_q: Tensor, b_k: Tensor, b_v: Tensor, w_out: Tensor,
             b_out: Tensor, heads: int, scale: float) -> Tuple[Tensor, Tensor]:
    """(x + out_proj(attention(qkv_proj(h))) (B, T, C) in x.dtype, lse
    (B, heads, T) fp32)."""
    return _block._reference_with_lse(x, h, w_q, w_k, w_v, (b_q, b_k, b_v),
                                      w_out, b_out, heads, scale)


@block_op.register_kernel("cuda")
def _(x, h, w_q, w_k, w_v, b_q, b_k, b_v, w_out, b_out, heads, scale):
    return _block.launch_fwd(x, h, (w_q, w_k, w_v), (b_q, b_k, b_v), w_out,
                             b_out, heads, scale)


@block_op.register_fake
def _(x, h, w_q, w_k, w_v, b_q, b_k, b_v, w_out, b_out, heads, scale):
    B, T, C = h.shape
    return (x.new_empty((B, T, C)),
            x.new_empty((B, heads, T), dtype=torch.float32))


# ---- row 7 -----------------------------------------------------------------

@torch.library.custom_op("pdm::boltzmann_moments", mutates_args=(),
                         device_types="cpu")
def moments_op(x: Tensor, yt_hi: Tensor, yt_lo: Optional[Tensor],
               ysq: Tensor, n: int, mode: str, inv_temp: Tensor,
               y_scale: Tensor, values: Optional[Tensor]
               ) -> Tuple[Tensor, Tensor]:
    """((4, B) fp32: log_z, shift, e1_hat, e2_hat; the mean (B, K), or
    (B, 0) without ``values``)."""
    y = yt_hi[:, :n].float()
    if yt_lo is not None:
        y = y + yt_lo[:, :n].float()
    mom = boltzmann_moments_reference(x, y.T.contiguous(), inv_temp, y_scale,
                                      values=values, mxu_precision=mode)
    stats = torch.stack([mom.log_z, mom.shift, mom.e1_hat, mom.e2_hat])
    if mom.mean is None:
        return stats, x.new_empty((x.shape[0], 0), dtype=torch.float32)
    return stats, mom.mean


@moments_op.register_kernel("cuda")
def _(x, yt_hi, yt_lo, ysq, n, mode, inv_temp, y_scale, values):
    from .boltzmann_kernel import launch_raw, operands

    prep = PreparedY(yt_hi, yt_lo, ysq, n, yt_hi.shape[0], mode)
    out, mean = launch_raw(operands(x, prep, inv_temp, y_scale,
                                    values=values, mode=mode))
    return out, mean if mean is not None else x.new_empty(
        (x.shape[0], 0), dtype=torch.float32)


@moments_op.register_fake
def _(x, yt_hi, yt_lo, ysq, n, mode, inv_temp, y_scale, values):
    B = x.shape[0]
    K = 0 if values is None else values.shape[1]
    return (x.new_empty((4, B), dtype=torch.float32),
            x.new_empty((B, K), dtype=torch.float32))


def traced_moments(x: Tensor, y, inv_temp, y_scale=1.0, *,
                   values: Optional[Tensor] = None,
                   compute_mean: bool = False, mode: str) -> BoltzmannMoments:
    """``ops.boltzmann.boltzmann_moments`` through ``pdm::boltzmann_moments``
    (what an exported program calls). ``y`` is the dataset (N, ...) or its
    kernel pack for ``mode``; a raw dataset is packed here (on the CPU in
    fp32, which reads back exactly)."""
    B = x.shape[0]
    xf = x.reshape(B, -1)
    if isinstance(y, PreparedY):
        prep = pack(y, mode)
        if compute_mean and values is None:
            raise ValueError("compute_mean with a PreparedY needs explicit "
                             "values (the pack holds the transposed dataset)")
    else:
        yf = y.reshape(y.shape[0], -1)
        if compute_mean and values is None:
            values = yf
        prep = prepare_y(yf, mode if x.device.type == "cuda" else "fp32")
    if values is not None:
        values = values.reshape(values.shape[0], -1)
    stats, mean = torch.ops.pdm.boltzmann_moments(
        xf, prep.yt_hi, prep.yt_lo, prep.ysq, prep.n, mode,
        _per_row(inv_temp, B, x.device), _per_row(y_scale, B, x.device),
        values)
    return BoltzmannMoments(log_z=stats[0], shift=stats[1], e1_hat=stats[2],
                            e2_hat=stats[3],
                            mean=None if values is None else mean)

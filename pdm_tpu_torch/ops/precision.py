"""One precision policy for every Gram-expansion op.

Counterpart of ``pdm_tpu/ops/precision.py``. The squared-distance
expansion ``||x||^2 - 2 x.y + ||y||^2`` is cancellation-prone: a Gram
computed at reduced precision carries an absolute error of the order of
the rows' squared norms (~3e3 at CIFAR scale), enough to corrupt Boltzmann
posteriors at low temperature and to flip k-NN neighbour order. Three
modes, the same as the JAX package's:

- ``fp32``:    full fp32 products and sums. The default.
- ``bf16_3x``: each fp32 operand split into a bf16 pair ``hi + lo``; the
               Gram is hi*hi + hi*lo + lo*hi, products exact in fp32 and
               summed in fp32 (~2^-16 relative Gram error).
- ``bf16``:    hi*hi alone.

Resolution, read at call time so tests and scripts can flip it per case:
explicit argument, then ``PDM_SWEEP_PRECISION`` (the sweep only), then
``PDM_BOLTZMANN_PRECISION``, then ``fp32``.

On an NVIDIA card a float32 matmul may run as TF32 (10-bit mantissa
products), which is the bf16 hazard again. Every plain-PyTorch Gram of the
port goes through :func:`matmul_fp32`, which turns TF32 off for the call.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Tuple

import torch
from torch import Tensor

MODES = ("fp32", "bf16_3x", "bf16")


def boltzmann_precision_mode(override: Optional[str] = None) -> str:
    """Resolve the Gram precision mode: explicit override > env > fp32."""
    mode = override or os.environ.get("PDM_BOLTZMANN_PRECISION", "fp32")
    if mode not in MODES:
        raise ValueError(f"PDM_BOLTZMANN_PRECISION={mode!r}; expected one of "
                         f"{MODES}")
    return mode


def sweep_precision_mode(override: Optional[str] = None) -> str:
    """The sweep's mode: override > PDM_SWEEP_PRECISION > the unified knob."""
    return boltzmann_precision_mode(
        override or os.environ.get("PDM_SWEEP_PRECISION"))


@contextlib.contextmanager
def full_fp32_matmul() -> Iterator[None]:
    """float32 matmuls in full float32 inside the block: TF32 off for
    cuBLAS, whatever the process-wide setting; restored on exit."""
    prev = torch.get_float32_matmul_precision()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        torch.set_float32_matmul_precision(prev)


def matmul_fp32(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` of two tensors cast to float32, never as TF32."""
    with full_fp32_matmul():
        return torch.matmul(a.float(), b.float())


def split(a: Tensor, mode: str) -> Tuple[Tensor, Optional[Tensor]]:
    """The operand(s) of ``mode``: (fp32 a, None), (bf16 hi, None) or the
    bf16 pair (hi, lo) with hi + lo ~ a, as the JAX kernels split."""
    if mode == "fp32":
        return a, None
    hi = a.to(torch.bfloat16)
    if mode == "bf16":
        return hi, None
    return hi, (a - hi.float()).to(torch.bfloat16)


def split_matmul(a_hi: Tensor, a_lo: Optional[Tensor], b_hi: Tensor,
                 b_lo: Optional[Tensor]) -> Tensor:
    """The Gram of split operands in fp32: hi*hi, plus hi*lo + lo*hi when
    both lo parts are given (products of bf16 values are exact in fp32)."""
    out = matmul_fp32(a_hi, b_hi)
    if a_lo is not None and b_lo is not None:
        out = out + (matmul_fp32(a_hi, b_lo) + matmul_fp32(a_lo, b_hi))
    return out


def gram(a: Tensor, b_t: Tensor, mode: str) -> Tensor:
    """``a @ b_t`` for fp32 ``a`` (M, D) and ``b_t`` (D, N) in ``mode``'s
    arithmetic."""
    return split_matmul(*split(a, mode), *split(b_t, mode))
